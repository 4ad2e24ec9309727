"""Rank workers for the mesh tests of the port's DB-search routes,
placements and collective matmuls (``tests/test_torch_mesh.py``).

It imports only ``torch``, numpy and ``repro_torch``: the tests start each
rank with the ``spawn`` method, and a child imports this module afresh,
so it must not pull in JAX. Each rank joins a gloo group through a
``file://`` store, runs one intra-op thread, builds each
``(data, model)`` mesh of its world size over the group, runs every case
on it, and writes what it computed (numpy arrays) to
``<out>/rank<r>.pkl``; a failure writes its traceback to
``<out>/rank<r>.err`` first. The inputs (the reference's codebooks and
the HVs encoded with them) come from the test process.
"""

from __future__ import annotations

import multiprocessing
import pickle
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from repro_torch.convert import encoder_from_numpy
from repro_torch.dist import sharding as SH
from repro_torch.dist.collective_matmul import (
    ag_matmul_pipelined,
    ring_matmul_reduce,
)
from repro_torch.serve import (
    BankRegistry,
    DBSearchServer,
    OMSConfig,
    SearchExecutor,
    encode_queries,
    oms_plan,
    oms_search_encoded,
    oms_search_levels,
    oms_search_with_fdr,
    search_database,
    search_database_levels,
    search_with_fdr,
    shard_database,
    sharded_topk_search,
)

MESHES = {2: ((1, 2), (2, 1)), 4: ((2, 2), (1, 4))}
NAMES = ("data", "model")
K = 4
CFG = dict(tol=15.0, open_tol=150.0)
SERVER = dict(k=K, fdr=0.5, max_batch_size=4, flush_timeout_s=0.0)
# (case, logical axes, shape, rule overrides) of the placement cases; the
# last puts two mesh axes on one dim against the mesh's order
PLACEMENTS = (
    ("batch_heads", ("batch", "heads"), (8, 4), {}),
    ("fsdp_ff", ("fsdp", "ff"), (4, 8), {}),
    ("vocab_rows", ("vocab", None), (12, 6), {}),
    ("indivisible", ("batch", "heads"), (3, 5), {}),
    ("tuple_in_order", ("batch", None), (8, 3), {"batch": ("data", "model")}),
    ("tuple_out_of_order", ("batch", None), (8, 3),
     {"batch": ("model", "data")}),
)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(pair) -> tuple:
    return tuple(x.numpy() for x in pair)


def _fdr(res) -> dict:
    return {name: getattr(res, name) for name in (
        "indices", "scores", "is_target", "accept", "match", "valid")}


def _results(reqs) -> list:
    return [(r.result.indices, r.result.scores, r.result.is_target,
             r.result.accept, r.result.match, r.result.has_candidate)
            for r in sorted(reqs, key=lambda r: r.rid)]


def _drain(server, queries, prec=None) -> list:
    for i, q in enumerate(queries):
        server.submit(q, tenant="a",
                      precursor=None if prec is None else float(prec[i]))
    return _results(server.run_until_drained())


def _raises(fn) -> str:
    try:
        fn()
    except Exception as e:  # the kind is what the test checks
        return type(e).__name__
    return "none"


def routes(mesh, lib: dict) -> dict:
    """Every DB-search route of the port on ``mesh`` for one library."""
    refs, decoys = _t(lib["refs"]), _t(lib["decoys"])
    q_hv, q_lev = _t(lib["q_hv"]), _t(lib["q_lev"])
    prec, qprec = lib["prec"], lib["qprec"]
    enc = encoder_from_numpy(lib["idh"], lib["lvh"], "cpu")
    cfg = OMSConfig(**CFG)
    out = {}
    for fused in (False, True):
        db = shard_database(refs, decoys=decoys, mesh=mesh, fused=fused)
        out[f"exact_fused{fused}"] = _np(search_database(db, q_hv, K))
        out[f"exact_ragged_fused{fused}"] = _np(
            search_database(db, q_hv[:5], K))
        out[f"fdr_fused{fused}"] = _fdr(search_with_fdr(db, q_hv, K, 0.5))
        out[f"topk_fused{fused}"] = _np(sharded_topk_search(
            q_hv, refs, K, mesh=mesh, fused=fused))
        for e2e in (False, True):
            out[f"levels_fused{fused}_e2e{e2e}"] = _np(search_database_levels(
                db, enc, q_lev, K, fused_e2e=e2e))
        if fused:
            out["rows_held"] = int(db.data.shape[0])
            out["num_shards"] = db.num_shards
            out["on_mesh"] = db.mesh is not None
        odb = shard_database(refs, decoys=decoys, mesh=mesh, fused=fused,
                             precursor=prec)
        plan = oms_plan(odb, qprec, cfg)
        out[f"oms_plan_fused{fused}"] = (plan.starts, plan.lens,
                                         plan.num_tiles)
        out[f"oms_fused{fused}"] = _np(oms_search_encoded(
            odb, encode_queries(odb, q_hv), plan, K))
        for e2e in (False, True):
            out[f"oms_levels_fused{fused}_e2e{e2e}"] = _np(oms_search_levels(
                odb, enc, q_lev, plan, K, fused_e2e=e2e))
        out[f"oms_fdr_fused{fused}"] = _fdr(oms_search_with_fdr(
            odb, q_hv, qprec, K, 0.5, cfg))
        rplan = oms_plan(odb, qprec[:5], cfg)
        out[f"oms_ragged_fused{fused}"] = _np(oms_search_encoded(
            odb, encode_queries(odb, q_hv[:5]), rplan, K))
    # the registry and the server, flush-sync, before and after an append
    # (the merged base + delta routes)
    for oms in (False, True):
        reg = BankRegistry(mesh=mesh, fused=True)
        reg.register("a", refs, decoys=decoys,
                     precursor=prec if oms else None)
        srv = DBSearchServer(reg, oms=cfg if oms else None, **SERVER)
        queries = list(lib["q_hv"])
        qp = qprec if oms else None
        before = _drain(srv, queries, qp)
        srv.append("a", lib["refs1"], lib["dec1"],
                   precursor=lib["prec1"] if oms else None,
                   decoy_precursor=lib["prec1"][:len(lib["dec1"])]
                   if oms else None)
        out[f"server_oms{oms}"] = (before, _drain(srv, queries, qp))
        out[f"delta_device_oms{oms}"] = str(reg.delta("a").device)
        # continuous over the mesh: the drain takes the flush-sync
        # drain's batches, so every result (FDR too) is the same
        out[f"continuous_oms{oms}"] = _drain(DBSearchServer(
            reg, continuous=True, oms=cfg if oms else None, **SERVER),
            queries, qp)
    db = shard_database(refs, decoys=decoys, mesh=mesh)
    out["k_over_shard_rows"] = (db.shard_rows, _raises(
        lambda: search_database(db, q_hv, db.shard_rows + 1)))
    out["emulate_with_mesh"] = _raises(lambda: shard_database(
        refs, mesh=mesh, emulate_shards=2))
    out["not_a_mesh"] = _raises(lambda: sharded_topk_search(
        q_hv, refs, K, mesh="model"))
    return out


def placements(mesh, full: np.ndarray) -> dict:
    """Each placement case's local block (or the error's kind)."""
    from torch.distributed.tensor import distribute_tensor

    out = {}
    for name, axes, shape, rules in PLACEMENTS:
        x = _t(full[:shape[0], :shape[1]])
        try:
            pl = SH.logical_to_sharding(axes, shape, mesh,
                                        SH.DEFAULT_RULES.replace(**rules))
        except ValueError as e:
            out[name] = ("ValueError", str(e))
            continue
        local = distribute_tensor(x, mesh, pl).to_local()
        out[name] = ([repr(p) for p in pl], local.numpy().copy())
    # constrain: a DTensor redistributes, a plain tensor passes
    from torch.distributed.tensor import Replicate

    x = _t(full[:8, :4])
    dt = distribute_tensor(x, mesh, [Replicate()] * 2)
    SH.set_mesh(mesh)
    try:
        c = SH.constrain(dt, "batch", "heads")
        out["constrain"] = ([repr(p) for p in c.placements],
                            c.to_local().numpy().copy(),
                            c.full_tensor().numpy().copy(),
                            SH.constrain(x, "batch", "heads") is x)
    finally:
        SH.set_mesh(None)
    return out


def matmuls(mesh, x: np.ndarray, w: np.ndarray, x_odd: np.ndarray) -> dict:
    """Both collective matmuls, this rank's own partial products for the
    replay of their order, and the indivisible fallbacks beside
    ``x @ w``."""
    xt, wt = _t(x), _t(w)
    n = SH.mesh_shape(mesh)["model"]
    c = SH.axis_ranks(mesh, "model").index(torch.distributed.get_rank())
    kl, ml, nl = x.shape[1] // n, x.shape[0] // n, w.shape[1] // n
    wl = wt[:, c * nl:(c + 1) * nl]
    xo, wo = _t(x_odd), wt[:x_odd.shape[1]]
    return {
        "ring": ring_matmul_reduce(xt, wt, mesh).numpy(),
        "ag": ag_matmul_pipelined(xt, wt, mesh).numpy(),
        "coord": c,
        "ring_partial": (xt[:, c * kl:(c + 1) * kl]
                         @ wt[c * kl:(c + 1) * kl]).numpy(),
        "ag_blocks": [(xt[s * ml:(s + 1) * ml] @ wl).numpy()
                      for s in range(n)],
        "ring_odd": ring_matmul_reduce(xo, wo, mesh).numpy(),
        "ring_odd_want": (xo @ wo).numpy(),
        "ag_odd": ag_matmul_pipelined(xo[:5], wo, mesh).numpy(),
        "ag_odd_want": (xo[:5] @ wo).numpy(),
    }


class _Recording(SearchExecutor):
    """Keeps every finalized request's result."""

    done: list = []

    def finalize(self, handle):
        live = super().finalize(handle)
        _Recording.done.extend(live)
        return live


def launcher(argv: list) -> dict:
    """``serve_db.main`` on this rank: the identifications and every
    request's result, flush-sync and with ``--continuous`` on top."""
    from repro_torch.launch import serve_db

    out = {}
    for mode, extra in (("flush", []), ("continuous", ["--continuous"])):
        _Recording.done = []
        s = serve_db.main(argv + extra, executor_cls=_Recording)
        out[mode] = {"identified": s["identified"], "correct": s["correct"],
                     "count": s["count"], "results": _results(_Recording.done)}
    return out


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
            from repro_torch.launch.mesh import make_debug_mesh
            res = {"debug_mesh": SH.mesh_shape(make_debug_mesh(
                device_type="cpu"))}
            for shape in MESHES[world]:
                mesh = init_device_mesh("cpu", shape, mesh_dim_names=NAMES)
                res[shape] = {
                    "coords": dict(zip(NAMES, mesh.get_coordinate())),
                    "routes": {name: routes(mesh, lib)
                               for name, lib in inputs["libs"].items()},
                    "placements": placements(mesh, inputs["full"]),
                    "matmuls": matmuls(mesh, *inputs["matmul"]),
                }
            if inputs.get("launcher"):
                res["launcher"] = launcher(inputs["launcher"])
        finally:
            dist.destroy_process_group()
        (out_dir / f"rank{rank}.pkl").write_bytes(pickle.dumps(res))
    except BaseException:
        (out_dir / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def card_worker(rank: int, world: int, store: str, out: str, inputs: dict
                ) -> None:
    """One rank on the card: the fused exact and OMS routes over a (1, n)
    ``cuda`` mesh in a gloo group, with the kernels' launches."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.kernels.topk_hamming import (
        topk_hamming,
        topk_hamming_banded,
    )

    out_dir = Path(out)
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=world)
        try:
            mesh = init_device_mesh("cuda", (1, world), mesh_dim_names=NAMES)
            refs, decoys, q = (_t(inputs[n]).cuda() for n in (
                "refs", "decoys", "q"))
            topk_hamming.launches = topk_hamming_banded.launches = 0
            db = shard_database(refs, decoys=decoys, mesh=mesh, fused=True)
            odb = shard_database(refs, decoys=decoys, mesh=mesh, fused=True,
                                 precursor=inputs["prec"])
            plan = oms_plan(odb, inputs["qprec"], OMSConfig(**CFG))
            res = {"exact": _cpu(search_database(db, q, K)),
                   "oms": _cpu(oms_search_encoded(
                       odb, encode_queries(odb, q), plan, K)),
                   "rows_held": int(db.data.shape[0]),
                   "launches": (topk_hamming.launches,
                                topk_hamming_banded.launches)}
        finally:
            dist.destroy_process_group()
        (out_dir / f"rank{rank}.pkl").write_bytes(pickle.dumps(res))
    except BaseException:
        (out_dir / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def _cpu(pair) -> tuple:
    return tuple(x.cpu().numpy() for x in pair)


def spawn(target, world: int, out: Path, inputs: dict,
          timeout_s: float) -> list:
    """``world`` ranks of ``target`` (spawned), joined within
    ``timeout_s`` or killed, and the test fails; returns each rank's
    results."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target,
                         args=(r, world, str(out / "store"), str(out),
                               inputs))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
        alive = sum(p.is_alive() for p in procs)
        assert alive == 0, (f"{alive} of {world} ranks still running after "
                            f"{timeout_s} s")
        errs = [f.read_text() for f in sorted(out.glob("rank*.err"))]
        assert all(p.exitcode == 0 for p in procs) and not errs, (
            [p.exitcode for p in procs], errs)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    return [pickle.loads((out / f"rank{r}.pkl").read_bytes())
            for r in range(world)]
