"""Rank workers for continuous DB-search serving over a device mesh
(``tests/test_torch_continuous_mesh.py``).

It imports only ``torch`` and ``repro_torch``: a rank is started with the
``spawn`` method (``_torch_mesh_ranks.spawn``) and imports this module
afresh. Each
rank joins a gloo group through a ``file://`` store, runs one intra-op
thread, and on each ``(data, model)`` mesh of its world size serves the
same deterministic traffic through ``DBSearchServer(continuous=True)``
over a ``BankRegistry(mesh=)`` on every route, with and without an
append halfway and once with compaction, recording every dispatched
batch (its request ids and the registry's append and compaction counts
at dispatch) and every request's result. Then the disagreement cases:
one rank submits an extra request, or rank 0 alone cancels a pending
one, and the error each rank raised; and clustering requests beside
search requests on the same plan. Results go to
``<out>/rank<r>.pkl`` (a failure writes its traceback to
``<out>/rank<r>.err`` first).
"""

from __future__ import annotations

import pickle
import traceback
from pathlib import Path

import torch

from repro_torch.convert import encoder_from_numpy
from repro_torch.serve import (
    BankRegistry,
    DBSearchServer,
    OMSConfig,
    SearchExecutor,
)

MESHES = {2: ((1, 2),), 4: ((1, 4), (2, 2))}
NAMES = ("data", "model")
K, MAX_BATCH = 4, 4
CFG = dict(tol=15.0, open_tol=150.0)
SERVER = dict(k=K, fdr=0.5, max_batch_size=MAX_BATCH, flush_timeout_s=0.0,
              buckets=2, num_slots=2)
# route -> (bank through the fused kernel, fused encode->search, OMS)
ROUTES = {"fused": (True, False, False), "fused_e2e": (False, True, False),
          "oms_fused": (True, False, True),
          "oms_fused_e2e": (False, True, True)}
# (route, ingest): no append, an append halfway, an append halfway that
# the next step compacts
CASES = tuple((r, a) for r in ROUTES for a in ("none", "append")) + (
    ("fused", "compact"), ("oms_fused_e2e", "compact"))
BURSTS = (3, 1, 5, 2, 4, 6, 2, 1)   # 24 requests
APPEND_AFTER = 4                    # bursts before the append
COMPACT_THRESHOLD = 0.04


def case_id(route: str, ingest: str) -> str:
    return f"{route}-{ingest}"


def recording_executor():
    """A fresh ``SearchExecutor`` subclass recording every dispatched
    batch as (request ids, the registry's appends, its compactions) and
    every finalized request's result by id."""

    class Recording(SearchExecutor):
        batches: list = []
        results: dict = {}

        def dispatch(self, reqs):
            banks = self.server.banks
            Recording.batches.append(([r.rid for r in reqs], banks.appends,
                                      banks.compactions))
            return super().dispatch(reqs)

        def finalize(self, handle):
            live = super().finalize(handle)
            for r in live:
                res = r.result
                Recording.results[r.rid] = (
                    (res.cluster_id, res.spawned, res.distance)
                    if r.kind == "cluster" else (
                        res.indices.copy(), res.scores.copy(),
                        bool(res.is_target), bool(res.accept),
                        int(res.match), bool(res.has_candidate)))
            return live

    return Recording


def make_server(mesh, lib: dict, route: str, ingest: str, recorder,
                **extra):
    """A continuous server over ``mesh`` with tenant ``a``'s bank
    (``extra``: more server arguments)."""
    fused, e2e, oms = ROUTES[route]
    reg = BankRegistry(mesh=mesh, fused=fused)
    reg.register("a", torch.from_numpy(lib["refs"]),
                 decoys=torch.from_numpy(lib["decoys"]),
                 precursor=lib["prec"] if oms else None)
    enc = (encoder_from_numpy(lib["idh"], lib["lvh"], "cpu") if e2e
           else None)
    return DBSearchServer(
        reg, continuous=True, oms=OMSConfig(**CFG) if oms else None,
        encoder=enc, fused_e2e=e2e, executor_cls=recorder,
        compact_threshold=COMPACT_THRESHOLD if ingest == "compact" else None,
        **SERVER, **extra)


def submit(srv, lib: dict, route: str, i: int) -> int:
    """Request ``i`` of the traffic: the library's query ``i % 12``."""
    _, e2e, oms = ROUTES[route]
    q = i % len(lib["q_hv"])
    return srv.submit(lib["q_lev"][q] if e2e else lib["q_hv"][q],
                      tenant="a",
                      precursor=float(lib["qprec"][q]) if oms else None)


def append(srv, lib: dict, route: str) -> None:
    oms = ROUTES[route][2]
    srv.append("a", lib["refs1"], lib["dec1"],
               precursor=lib["prec1"] if oms else None,
               decoy_precursor=lib["prec1"][:len(lib["dec1"])]
               if oms else None)


def serve(mesh, lib: dict, route: str, ingest: str) -> dict:
    """The traffic served continuously over ``mesh``: bursts, a step after
    each, blocking steps while a batch's worth waits, the append after
    APPEND_AFTER bursts, then a drain."""
    rec = recording_executor()
    srv = make_server(mesh, lib, route, ingest, rec)
    sent = 0
    for b, burst in enumerate(BURSTS):
        if b == APPEND_AFTER and ingest != "none":
            append(srv, lib, route)
        for _ in range(burst):
            submit(srv, lib, route, sent)
            sent += 1
        srv.step()
        while len(srv.queue) >= MAX_BATCH:
            srv.step(force=True)
    srv.run_until_drained()
    s = srv.summary()
    return {"batches": rec.batches, "results": rec.results,
            "scheduler": s["scheduler"], "count": s["count"],
            "ingest": (s["ingest"]["appends"], s["ingest"]["compactions"]),
            "kind": type(srv.scheduler).__name__}


CLUSTERING = dict(dim=64, threshold=20.0, consolidate_every=8)


def cluster(mesh, lib: dict) -> dict:
    """Clustering requests beside search requests on a continuous server
    over ``mesh``: the cluster batches ride the same plan (their state is
    each rank's own). Every library target is submitted for clustering,
    and every query for search, in bursts."""
    from repro_torch.serve import ClusteringConfig

    rec = recording_executor()
    srv = make_server(mesh, lib, "fused", "none", rec, cluster_device="cpu",
                      clustering=ClusteringConfig(**CLUSTERING))
    for i, row in enumerate(lib["refs"][:40]):
        srv.submit_cluster(row, tenant="c")
        if i % 3 == 0:
            submit(srv, lib, "fused", i)
        if i % 5 == 4:
            srv.step()
    srv.run_until_drained()
    return {"batches": rec.batches, "results": rec.results,
            "cluster_requests": srv.summary()["clustering"]["requests"]}


def disagree(mesh, lib: dict, world: int, how: str) -> dict:
    """Serving where the ranks disagree: ``extra``, the last rank submits
    one request more after the first two steps; ``cancel``, rank 0 alone
    cancels a pending request. Returns the error raised here (kind and
    message), the batches dispatched and the results served."""
    rank = torch.distributed.get_rank()
    rec = recording_executor()
    srv = make_server(mesh, lib, "fused", "none", rec)
    err = None
    try:
        for i in range(6):
            submit(srv, lib, "fused", i)
        srv.step()
        srv.step(force=True)
        if how == "extra" and rank == world - 1:
            submit(srv, lib, "fused", 11)
        for i in range(6, 10):
            submit(srv, lib, "fused", i)
        if how == "cancel" and rank == 0:
            srv.cancel(srv.queue.next_rid - 2)
        srv.run_until_drained()
    except RuntimeError as e:
        err = (type(e).__name__, str(e))
    return {"error": err, "batches": rec.batches, "results": rec.results,
            "in_flight": srv.scheduler.in_flight}


def launcher(argv: list) -> dict:
    """``serve_db.main`` on this rank with a recording executor."""
    from repro_torch.launch import serve_db

    rec = recording_executor()
    s = serve_db.main(argv, executor_cls=rec)
    return {"identified": s["identified"], "correct": s["correct"],
            "count": s["count"], "results": rec.results,
            "batches": rec.batches, "scheduler": s["scheduler"]}


def worker(rank: int, world: int, store: str, out: str, inputs: dict
           ) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    out_dir = Path(out)
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=world)
        try:
            lib = inputs["lib"]
            res = {}
            for shape in MESHES[world]:
                mesh = init_device_mesh("cpu", shape, mesh_dim_names=NAMES)
                res[shape] = {case_id(r, a): serve(mesh, lib, r, a)
                              for r, a in CASES}
                res[shape]["cluster"] = cluster(mesh, lib)
                if shape == MESHES[world][0]:
                    res["disagree"] = {how: disagree(mesh, lib, world, how)
                                       for how in ("extra", "cancel")}
            for name, argv in inputs["launchers"].items():
                res[name] = launcher(argv)
        finally:
            dist.destroy_process_group()
        (out_dir / f"rank{rank}.pkl").write_bytes(pickle.dumps(res))
    except BaseException:
        (out_dir / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
