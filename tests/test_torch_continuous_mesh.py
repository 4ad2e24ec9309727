"""Continuous DB-search serving over a device mesh, against the JAX
package's one-device server, on gloo CPU ranks.

The ranks are processes started with ``spawn`` from
``tests/_torch_continuous_mesh_ranks.py`` (no JAX there), once a world
size (2 and 4) through a ``file://`` store under the test's temporary
directory; a run joins within ``JOIN_TIMEOUT_S`` or its children are
killed and the test fails. On each ``(data, model)`` mesh ((1, 2) at 2
ranks, (1, 4) and (2, 2) at 4) every rank serves the same 24 requests in
bursts through ``DBSearchServer(continuous=True)``, whose
``CoordinatedScheduler`` has rank 0 plan each step, on every route
(``fused``, ``fused_e2e``, ``oms_fused``, ``oms_fused_e2e``), each without
an append, with one halfway, and (two routes) with a compaction after it.

A mesh run's results depend on its batches (FDR routes each batch as a
whole), so each request is held two ways, bit for bit: its top-k indices
and scores and ``has_candidate`` against the reference's one-device
server, and its ``is_target``, ``accept`` and ``match`` against the
reference's FDR routing of the batches the mesh run recorded (both come
from one replay of those batches, the reference's append and compaction
made before the same batches). ``match`` is the accepted target row, so
it follows ``accept``. The same batches replayed through a one-process
continuous port server give the same results. Every rank serves what
rank 0 serves, and every rank compacts before the same batch.

Disagreements: when the last rank submits one request more, or rank 0
alone cancels a pending one, every rank raises ``RuntimeError`` naming
the first differing rank and request id, within the join timeout, after
serving only correct results. Clustering requests beside the search
requests ride the same plan: every rank clusters in rank 0's batches, as
a one-process replay of them does. The launcher: ``serve_db --continuous``
over 2 ranks (with ``--append`` and ``--compact-threshold``, exact and
OMS) serves the batches and results of one process, whose CPU route
polls every slot done, as rank 0's does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_continuous_mesh_ranks as R
from _torch_mesh_ranks import spawn
from repro.dist import sharding as JSH
from repro.serve import BankRegistry as JRegistry
from repro.serve import DBSearchServer as JServer
from repro.serve import QueryEncoder as JEncoder
from repro.serve import oms as joms
from repro.serve.queue import Request as JRequest
from repro_torch.convert import encoder_from_numpy
from repro_torch.launch import serve_db
from repro_torch.serve import BankRegistry, DBSearchServer, OMSConfig
from repro_torch.serve.queue import Request
from test_torch_mesh import _library

torch.set_num_threads(1)

JOIN_TIMEOUT_S = 180
WORLDS = (2, 4)
MESHES = [(w, s) for w in WORLDS for s in R.MESHES[w]]
MESH_IDS = [f"{w}ranks-{s[0]}x{s[1]}" for w, s in MESHES]
CASE_IDS = [R.case_id(r, a) for r, a in R.CASES]
FIELDS = ("indices", "scores", "is_target", "accept", "match",
          "has_candidate")
TOPK, FDR = (0, 1, 5), (2, 3, 4)
REQUESTS = sum(R.BURSTS)
LAUNCHERS = {
    "launcher_fused": ["--reduced", "--device", "cpu", "--fused",
                       "--queries", "48", "--continuous", "--append", "0.25",
                       "--compact-threshold", "0.1"],
    "launcher_oms_e2e": ["--reduced", "--device", "cpu", "--oms",
                         "--fused-e2e", "--queries", "32", "--continuous",
                         "--append", "0.25"],
}


@pytest.fixture(autouse=True)
def no_global_mesh():
    JSH.set_mesh(None)
    yield


@pytest.fixture(scope="module")
def lib():
    return _library(10 + 64, 64)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, lib):
    """``ranks(world)``: the spawned ranks' results (run once a world)."""
    runs = {}

    def get(world):
        if world not in runs:
            runs[world] = spawn(
                R.worker, world, tmp_path_factory.mktemp(f"cmesh{world}"),
                {"lib": lib,
                 "launchers": LAUNCHERS if world == 2 else {}},
                JOIN_TIMEOUT_S)
        return runs[world]
    return get


def _query(lib, route, rid):
    _, e2e, oms = R.ROUTES[route]
    q = rid % len(lib["q_hv"])
    return (lib["q_lev"][q] if e2e else lib["q_hv"][q],
            float(lib["qprec"][q]) if oms else None)


def _replay(server, registry, lib, route, batches, request) -> dict:
    """Every request's result when ``batches`` (request ids, appends and
    compactions at dispatch) are dispatched in order through ``server``'s
    executor, the append and compaction made before the batches that
    saw them; ``request(rid, query, precursor)`` builds a request."""
    appends = compactions = 0
    out = {}
    for rids, a, c in batches:
        if a > appends:
            R.append(server, lib, route)
            appends = a
        if c > compactions:
            assert registry.compact("a")
            compactions = c
        reqs = [request(rid, *_query(lib, route, rid)) for rid in rids]
        for r in server.executor.finalize(server.executor.dispatch(reqs)):
            res = r.result
            out[r.rid] = tuple(np.asarray(getattr(res, f)) for f in FIELDS)
    return out


def _reference(lib, route, batches) -> dict:
    """The reference's one-device server on the recorded batches (its
    unfused routes, staged encode: bit-identical to its fused ones)."""
    _, e2e, oms = R.ROUTES[route]
    reg = JRegistry()
    reg.register("a", jnp.asarray(lib["refs"]),
                 decoys=jnp.asarray(lib["decoys"]),
                 precursor=lib["prec"] if oms else None)
    enc = (JEncoder(id_hvs=jnp.asarray(lib["idh"]),
                    level_hvs=jnp.asarray(lib["lvh"])) if e2e else None)
    srv = JServer(reg, oms=joms.OMSConfig(**R.CFG) if oms else None,
                  encoder=enc, k=R.K, fdr=0.5, max_batch_size=R.MAX_BATCH,
                  flush_timeout_s=0.0, buckets=2)
    return _replay(srv, reg, lib, route, batches,
                   lambda rid, q, p: JRequest(rid=rid, query=q, t_submit=0.0,
                                              tenant="a", precursor=p))


def _one_process(lib, route, batches) -> dict:
    """The same batches through a one-process continuous port server."""
    fused, e2e, oms = R.ROUTES[route]
    reg = BankRegistry(fused=fused)
    reg.register("a", torch.from_numpy(lib["refs"]),
                 decoys=torch.from_numpy(lib["decoys"]),
                 precursor=lib["prec"] if oms else None)
    srv = DBSearchServer(
        reg, continuous=True, oms=OMSConfig(**R.CFG) if oms else None,
        encoder=encoder_from_numpy(lib["idh"], lib["lvh"], "cpu")
        if e2e else None, fused_e2e=e2e, **R.SERVER)
    return _replay(srv, reg, lib, route, batches,
                   lambda rid, q, p: Request(rid=rid, query=q, t_submit=0.0,
                                             tenant="a", precursor=p))


@pytest.fixture(scope="module")
def replays(lib):
    """``replays(kind, route, batches)``, memoized on the batches (on the
    CPU every slot polls done, so meshes batch alike)."""
    fns = {"reference": _reference, "one_process": _one_process}
    memo = {}

    def get(kind, route, batches):
        key = (kind, route, repr(batches))
        if key not in memo:
            memo[key] = fns[kind](lib, route, batches)
        return memo[key]
    return get


def _served(ranks, world, shape, case):
    return [res[shape][case] for res in ranks(world)]


def _rows(results, picks):
    return {rid: tuple(res[i] for i in picks) for rid, res in results.items()}


def _equal(got: dict, want: dict, what: str) -> None:
    assert sorted(got) == sorted(want), what
    for rid in want:
        for g, w in zip(got[rid], want[rid]):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                          err_msg=f"{what} request {rid}")


@pytest.mark.parametrize("case", CASE_IDS)
@pytest.mark.parametrize("world,shape", MESHES, ids=MESH_IDS)
def test_topk_and_candidates_equal_the_reference_one_device(
        ranks, replays, world, shape, case):
    route = case.split("-")[0]
    for r, got in enumerate(_served(ranks, world, shape, case)):
        want = replays("reference", route, got["batches"])
        _equal(_rows(got["results"], TOPK), _rows(want, (0, 1, 5)),
               f"rank {r} {shape} {case}")


@pytest.mark.parametrize("case", CASE_IDS)
@pytest.mark.parametrize("world,shape", MESHES, ids=MESH_IDS)
def test_fdr_equals_the_reference_on_the_recorded_batches(
        ranks, replays, world, shape, case):
    route = case.split("-")[0]
    for r, got in enumerate(_served(ranks, world, shape, case)):
        want = replays("reference", route, got["batches"])
        _equal(_rows(got["results"], FDR), _rows(want, (2, 3, 4)),
               f"rank {r} {shape} {case}")


@pytest.mark.parametrize("case", CASE_IDS)
@pytest.mark.parametrize("world,shape", MESHES, ids=MESH_IDS)
def test_one_process_replay_is_bit_identical(ranks, replays, world, shape,
                                             case):
    route = case.split("-")[0]
    got = _served(ranks, world, shape, case)[0]
    _equal(got["results"], replays("one_process", route, got["batches"]),
           f"{shape} {case}")


@pytest.mark.parametrize("case", CASE_IDS)
@pytest.mark.parametrize("world,shape", MESHES, ids=MESH_IDS)
def test_every_rank_serves_rank_0s_batches_and_results(ranks, world, shape,
                                                       case):
    got = _served(ranks, world, shape, case)
    for r, res in enumerate(got[1:], 1):
        # the batches hold the compactions each rank had made: equal
        # lists mean every rank compacted before the same batch
        assert res["batches"] == got[0]["batches"], (r, case)
        _equal(res["results"], got[0]["results"], f"rank {r} {case}")


@pytest.mark.parametrize("case", CASE_IDS)
@pytest.mark.parametrize("world,shape", MESHES, ids=MESH_IDS)
def test_every_request_is_served_once_on_the_coordinated_scheduler(
        ranks, world, shape, case):
    ingest = case.split("-")[1]
    for res in _served(ranks, world, shape, case):
        assert res["kind"] == "CoordinatedScheduler"
        assert res["count"] == REQUESTS
        assert sorted(res["results"]) == list(range(REQUESTS))
        served = sorted(rid for rids, _, _ in res["batches"] for rid in rids)
        assert served == list(range(REQUESTS))
        s = res["scheduler"]
        assert s["dispatched_batches"] == s["retired_batches"] == len(
            res["batches"])
        assert s["exchanges"] >= len(R.BURSTS)
        assert s["in_flight"] == 0
        assert res["ingest"] == {"none": (0, 0), "append": (1, 0),
                                 "compact": (1, 1)}[ingest]


@pytest.mark.parametrize("case", [c for c in CASE_IDS if "none" not in c])
@pytest.mark.parametrize("world,shape", MESHES, ids=MESH_IDS)
def test_batches_before_and_after_the_append_are_both_served(
        ranks, world, shape, case):
    batches = _served(ranks, world, shape, case)[0]["batches"]
    states = {(a, c) for _, a, c in batches}
    assert (0, 0) in states and any(a == 1 for a, _ in states)
    if case.endswith("compact"):
        assert (1, 1) in states


@pytest.mark.parametrize("world,shape", MESHES, ids=MESH_IDS)
def test_cluster_batches_ride_the_same_plan(ranks, lib, world, shape):
    """Clustering and search requests share the queue and the slots: every
    rank clusters in rank 0's batches, and the assignments equal the same
    batches replayed through a one-process continuous server."""
    from repro_torch.serve import ClusteringConfig

    got = [res[shape]["cluster"] for res in ranks(world)]

    def assignments(res):
        return {rid: v for rid, v in res["results"].items() if len(v) == 3}

    for r, res in enumerate(got[1:], 1):
        assert res["batches"] == got[0]["batches"], r
        assert assignments(res) == assignments(got[0]), r
        _equal({k: v for k, v in res["results"].items() if len(v) == 6},
               {k: v for k, v in got[0]["results"].items() if len(v) == 6},
               f"rank {r} search beside clustering")
    assert got[0]["cluster_requests"] == 40
    reg = BankRegistry(fused=True)
    reg.register("a", torch.from_numpy(lib["refs"]),
                 decoys=torch.from_numpy(lib["decoys"]))
    srv = DBSearchServer(reg, continuous=True, cluster_device="cpu",
                         clustering=ClusteringConfig(**R.CLUSTERING),
                         **R.SERVER)
    cluster_rids = sorted(assignments(got[0]))
    # requests were submitted in order: cluster i, then search i when
    # i % 3 == 0; map each cluster request back to its library row
    rows, rid = {}, 0
    for i in range(40):
        rows[rid] = i
        rid += 1 + (i % 3 == 0)
    assert sorted(rows) == cluster_rids
    for rids, _, _ in got[0]["batches"]:
        if rids[0] not in rows:
            continue
        reqs = [Request(rid=q, query=lib["refs"][rows[q]], t_submit=0.0,
                        tenant="c", kind="cluster") for q in rids]
        for req in srv.executor.finalize(srv.executor.dispatch(reqs)):
            a = req.result
            assert (a.cluster_id, a.spawned, a.distance) == got[0][
                "results"][req.rid], req.rid


# ---------------------------------------------------------- disagreements --

DISAGREE = {"extra": lambda world: (world - 1, 6),
            "cancel": lambda world: (1, 8)}


@pytest.mark.parametrize("how", list(DISAGREE))
@pytest.mark.parametrize("world", WORLDS)
def test_a_disagreement_raises_on_every_rank(ranks, world, how):
    rank, rid = DISAGREE[how](world)
    for res in ranks(world):
        got = res["disagree"][how]
        assert got["error"] is not None
        kind, msg = got["error"]
        assert kind == "RuntimeError"
        assert f"rank {rank} differs from rank 0's plan" in msg, msg
        assert f"first differing request id {rid} " in msg, msg
        assert "nothing was dispatched" in msg


@pytest.mark.parametrize("how", list(DISAGREE))
@pytest.mark.parametrize("world", WORLDS)
def test_a_disagreement_serves_no_wrong_result(ranks, replays, world, how):
    got = [res["disagree"][how] for res in ranks(world)]
    for r, res in enumerate(got):
        assert res["batches"] == got[0]["batches"], r
        # only the first steps' batches, all before the disagreement
        assert sorted(rid for rids, _, _ in res["batches"]
                      for rid in rids) == list(range(6))
        want = replays("reference", "fused", res["batches"])
        _equal(res["results"], want, f"rank {r} {how}")
        assert res["in_flight"] == 0


# --------------------------------------------------------------- launcher --

@pytest.fixture(scope="module")
def one_process_launcher():
    runs = {}

    def get(name):
        if name not in runs:
            rec = R.recording_executor()
            s = serve_db.main(LAUNCHERS[name], executor_cls=rec)
            runs[name] = {"identified": s["identified"], "count": s["count"],
                          "results": rec.results, "batches": rec.batches}
        return runs[name]
    return get


@pytest.mark.parametrize("name", list(LAUNCHERS))
def test_continuous_launcher_on_two_ranks_matches_one_process(
        ranks, one_process_launcher, name):
    want = one_process_launcher(name)
    for r, res in enumerate(ranks(2)):
        got = res[name]
        assert got["batches"] == want["batches"], r
        assert (got["identified"], got["count"]) == (want["identified"],
                                                     want["count"])
        _equal(got["results"], want["results"], f"rank {r} {name}")
        assert got["scheduler"]["exchanges"] > 0


def test_the_disagreement_requests_differ_in_content(lib):
    """The extra request takes request id 6 on the last rank with another
    query than rank 0's request 6: the plan compares contents too."""
    assert not np.array_equal(_query(lib, "fused", 11)[0],
                              _query(lib, "fused", 6)[0])
