"""The serving path's span recorder (``repro_torch.serve.trace``), on the
CPU: the spans a server records on each route, in flush-sync and
continuous mode, against the server's own counters and results.

Routes: the fused exact and fused OMS (banded) routes, the staged encode
through the query-HV cache, and the merged base + delta OMS route.
Checked: one ``dispatch`` and one ``finalize`` a batch, sharing its
``bid``; every child inside its parent; ``dispatch.plan`` on the OMS
routes alone; the spans' ``n`` and cache counts against ``summary()``;
span times on ``time.perf_counter``; results bit-identical with and
without a recorder.
"""

import time

import numpy as np
import pytest
import torch

from repro_torch.core.hd.encoding import encode_levels_batch
from repro_torch.serve import (
    BankRegistry,
    ClusteringConfig,
    DBSearchServer,
    OMSConfig,
    QueryEncoder,
    SearchExecutor,
    SpanRecorder,
)

# small tensors: one intra-op thread leaves the cores to the other test
# workers
torch.set_num_threads(1)

F, M, D = 24, 6, 64
ROUTES = ["exact_fused", "oms_fused", "staged", "merged_delta"]
PARTS = {"dispatch": {"dispatch.assemble", "dispatch.plan", "dispatch.encode",
                      "dispatch.search", "dispatch.copy_out"},
         "finalize": {"finalize.wait", "finalize.cache", "finalize.fdr",
                      "finalize.results"}}


def _library(seed):
    rng = np.random.default_rng(seed)
    enc = QueryEncoder.from_config(dim=D, num_features=F, num_levels=M,
                                   seed=seed, device="cpu")
    lev = rng.integers(0, M, size=(90, F)).astype(np.int32)
    lev[rng.random(lev.shape) < 0.5] = 0
    hv = encode_levels_batch(torch.from_numpy(lev), enc.id_hvs,
                             enc.level_hvs)
    prec = rng.uniform(400, 1600, 60).astype(np.float32)
    q = np.concatenate([lev[rng.integers(0, 60, 12)],
                        rng.integers(0, M, size=(10, F))]).astype(np.int32)
    q = np.concatenate([q, q[:8]])             # repeats hit the cache
    qprec = rng.uniform(420, 1650, len(q)).astype(np.float32)
    return enc, hv, prec, q, qprec


def _server(route, continuous, tracer, seed=5):
    enc, hv, prec, q, qprec = _library(seed)
    oms = route in ("oms_fused", "merged_delta")
    keep = 48 if route == "merged_delta" else 60
    reg = BankRegistry(emulate_shards=2, fused=True)
    reg.register("a", hv[:keep], decoys=hv[60:60 + keep // 2],
                 precursor=prec[:keep] if oms else None,
                 decoy_precursor=prec[:keep // 2] if oms else None)
    srv = DBSearchServer(
        reg, k=4, fdr=0.5, max_batch_size=8, buckets=(4, 8),
        flush_timeout_s=0.0, cache_bytes=1 << 20,
        oms=OMSConfig(tol=15.0, open_tol=150.0) if oms else None,
        encoder=enc, fused_e2e=route in ("exact_fused", "oms_fused"),
        continuous=continuous, tracer=tracer)
    if route == "merged_delta":
        srv.append("a", hv[keep:60], hv[60 + keep // 2:90],
                   precursor=prec[keep:],
                   decoy_precursor=prec[keep:keep + 90 - 60 - keep // 2])
    return srv, q, qprec if oms else None


def _serve(srv, q, qprec):
    """Bursts of 5 with a step after each, then a drain: the results by
    request id."""
    done = []
    for i in range(len(q)):
        srv.submit(q[i], "a",
                   precursor=None if qprec is None else float(qprec[i]))
        if i % 5 == 4:
            done.extend(srv.step())
    done.extend(srv.run_until_drained())
    return {r.rid: r.result for r in done}


@pytest.mark.parametrize("continuous", [False, True],
                         ids=["flush_sync", "continuous"])
@pytest.mark.parametrize("route", ROUTES)
def test_spans_of_each_route(route, continuous):
    tr = SpanRecorder()
    srv, q, qprec = _server(route, continuous, tr)
    t0 = time.perf_counter()
    got = _serve(srv, q, qprec)
    t1 = time.perf_counter()
    s = srv.summary()
    spans = tr.export()
    assert spans and all(s_.end is not None for s_ in spans)
    by_id = {s_.id: s_ for s_ in spans}
    assert len(by_id) == len(spans)

    # the clock: between two perf_counter reads around the serving
    assert all(t0 <= s_.start <= s_.end <= t1 for s_ in spans)

    # one dispatch and one finalize a batch, sharing its bid
    disp = [s_ for s_ in spans if s_.name == "dispatch"]
    fin = [s_ for s_ in spans if s_.name == "finalize"]
    assert len(disp) == len(fin) == sum(s["buckets"].values())
    assert sorted(d.bid for d in disp) == sorted(f.bid for f in fin)
    assert all(d.bid == d.id for d in disp)

    # children inside their parents, with their id and bid
    for c in spans:
        if c.parent is None:
            assert "." not in c.name
            continue
        p = by_id[c.parent]
        assert c.name in PARTS[p.name]
        assert c.bid == p.bid
        assert p.start <= c.start <= c.end <= p.end
    names = {s_.name for s_ in spans}
    oms = route in ("oms_fused", "merged_delta")
    assert ("dispatch.plan" in names) == oms
    assert {"dispatch", "finalize", "dispatch.assemble",
            "dispatch.search", "dispatch.copy_out", "finalize.wait",
            "finalize.fdr", "finalize.results"} <= names
    assert ("dispatch.encode" in names) == (route in ("staged",
                                                      "merged_delta"))
    assert ("finalize.cache" in names) == (route in ("staged",
                                                     "merged_delta"))
    want_route = {"exact_fused": "exact", "oms_fused": "banded",
                  "staged": "exact", "merged_delta": "merged"}[route]
    assert {d.counts["route"] for d in disp} == {want_route}
    for p in (s_ for s_ in spans if s_.name == "dispatch.plan"):
        assert 0.0 < p.counts["scanned_fraction"] <= 1.0

    # the spans' counts against the server's counters
    ten = s["tenants"]["a"]
    assert sum(d.counts["n"] for d in disp) == s["count"] == len(q)
    assert sum(d.counts["cache_hits"] for d in disp) == ten["cache_hits"]
    assert sum(d.counts["cache_misses"] for d in disp) == ten["cache_misses"]
    if route in ("staged", "merged_delta"):
        assert ten["cache_hits"] > 0
    for d in disp:
        assert 1 <= d.counts["n"] <= 8

    # bit-identical results without a recorder
    plain, q2, qprec2 = _server(route, continuous, None)
    want = _serve(plain, q2, qprec2)
    assert sorted(got) == sorted(want)
    for rid, w in want.items():
        g = got[rid]
        np.testing.assert_array_equal(g.indices, w.indices)
        np.testing.assert_array_equal(g.scores, w.scores)
        assert (g.is_target, g.accept, g.match, g.has_candidate) == (
            w.is_target, w.accept, w.match, w.has_candidate)
    assert plain.summary()["trace"] is None


@pytest.mark.parametrize("continuous", [False, True],
                         ids=["flush_sync", "continuous"])
def test_summary_sums_the_spans_and_polls_record_nothing(continuous):
    tr = SpanRecorder()
    srv, q, qprec = _server("staged", continuous, None)
    assert srv.summary()["trace"] is None
    srv.tracer = tr                               # attached while serving
    _serve(srv, q, qprec)
    n = len(tr)
    assert srv.step() == [] and srv.step() == []  # nothing to do
    assert len(tr) == n
    t = srv.summary()["trace"]
    assert t["dispatch"]["count"] == t["finalize"]["count"]
    for name, d in t.items():
        assert 0.0 <= d["self_ms"] <= d["total_ms"] + 1e-9, name
    s = srv.summary()
    assert t["dispatch"]["counts"]["n"] == s["count"]
    assert t["dispatch"]["counts"]["cache_misses"] == \
        s["tenants"]["a"]["cache_misses"]
    parts = sum(t[c]["total_ms"] for c in PARTS["dispatch"] if c in t)
    assert t["dispatch"]["self_ms"] == pytest.approx(
        t["dispatch"]["total_ms"] - parts)
    srv.tracer = None                             # detached: records stay
    srv.submit(q[0], "a")
    srv.run_until_drained()
    assert len(tr) == n


def test_compaction_and_clustering_spans():
    rng = np.random.default_rng(3)
    hv = np.where(rng.random((40, D)) < 0.5, 1, -1).astype(np.int8)
    tr = SpanRecorder()
    reg = BankRegistry()
    reg.register("a", torch.from_numpy(hv[:24]),
                 decoys=torch.from_numpy(hv[24:30]))
    srv = DBSearchServer(reg, k=2, max_batch_size=4, flush_timeout_s=0.0,
                         compact_threshold=0.2, tracer=tr,
                         clustering=ClusteringConfig(dim=D, threshold=0.3),
                         cluster_device="cpu")
    srv.append("a", torch.from_numpy(hv[30:40]))
    srv.submit(hv[0], "a")
    srv.submit_cluster(hv[1], "c")
    srv.run_until_drained()
    spans = tr.export()
    comp = [s for s in spans if s.name == "compact"]
    assert len(comp) == 1 and comp[0].counts["rows"] == 10
    assert reg.compactions == 1
    routes = sorted(s.counts["route"] for s in spans if s.name == "dispatch")
    assert routes == ["cluster", "exact"]
    assert len(tr) == 0 and tr.summary() == {}


@pytest.mark.parametrize("continuous", [False, True],
                         ids=["flush_sync", "continuous"])
def test_executor_subclass_with_the_one_argument_cluster_hook(continuous):
    """An executor subclass that overrides ``_finalize_cluster(self,
    handle)`` and calls up, as recording executors do, serves clustering
    batches with a recorder attached and without one."""
    seen = []

    class Recording(SearchExecutor):
        def _finalize_cluster(self, handle):
            live = super()._finalize_cluster(handle)
            seen.append([r.result for r in handle.reqs])
            return live

    rng = np.random.default_rng(4)
    hv = np.where(rng.random((12, D)) < 0.5, 1, -1).astype(np.int8)
    got = {}
    for tracer in (SpanRecorder(), None):
        seen.clear()
        srv = DBSearchServer(
            BankRegistry(), max_batch_size=4, flush_timeout_s=0.0,
            clustering=ClusteringConfig(dim=D, threshold=0.3),
            cluster_device="cpu", executor_cls=Recording,
            continuous=continuous, tracer=tracer)
        for i in range(len(hv)):
            srv.submit_cluster(hv[i], "c")
        done = srv.run_until_drained()
        assert len(done) == len(hv)
        assert sum(len(b) for b in seen) == len(hv)
        got[tracer is None] = sorted((r.rid, r.result) for r in done)
        if tracer is not None:
            spans = tracer.export()
            fin = {s.id for s in spans if s.name == "finalize"}
            waits = [s for s in spans if s.name == "finalize.wait"]
            assert len(fin) == len(seen) == len(waits)
            assert {w.parent for w in waits} == fin
            assert {s.counts["route"] for s in spans
                    if s.name == "dispatch"} == {"cluster"}
    assert got[True] == got[False]


def test_recorder_nesting_self_time_and_export():
    t = [0.0]
    tr = SpanRecorder(clock=lambda: t[0])
    root = tr.begin("dispatch", bid=tr.next_id, n=1)
    t[0] = 1.0
    t_a = tr.clock()
    t[0] = 3.0
    tr.span("dispatch.plan", t_a, scanned_fraction=0.5)
    t_b = tr.clock()
    tr.add(cache_hits=2)
    tr.add(cache_hits=1)
    t[0] = 4.0
    tr.span("dispatch.search", t_b)
    t[0] = 10.0
    tr.end(root)
    s = tr.summary()
    assert s["dispatch"] == {"count": 1, "total_ms": 10000.0,
                             "self_ms": 7000.0,
                             "counts": {"n": 1, "cache_hits": 3}}
    assert s["dispatch.plan"] == {"count": 1, "total_ms": 2000.0,
                                  "self_ms": 2000.0,
                                  "counts": {"scanned_fraction": 0.5}}
    # a span an exception left open counts nowhere, and the next root span
    # does not nest in it
    fin = tr.begin("finalize", bid=root)
    tr.begin("finalize.fdr")
    t[0] = 11.0
    tr.span("compact", tr.clock(), rows=7)
    assert "finalize" not in tr.summary()
    assert tr.summary()["compact"]["count"] == 1
    out = tr.export()
    assert len(tr) == 0
    assert [x.name for x in out] == ["dispatch", "dispatch.plan",
                                     "dispatch.search", "finalize",
                                     "finalize.fdr", "compact"]
    d, plan, search, f, fdr, comp = out
    assert d.id == d.bid == root and (d.start, d.end) == (0.0, 10.0)
    assert (plan.parent, plan.bid, plan.start, plan.end) == (root, root, 1.0,
                                                             3.0)
    assert (search.parent, search.bid) == (root, root)
    assert (f.id, f.bid, f.end) == (fin, root, None)
    assert (fdr.parent, fdr.bid, fdr.end) == (fin, root, None)
    assert (comp.parent, comp.bid, comp.counts) == (None, None, {"rows": 7})
    assert d.counts == {"n": 1, "cache_hits": 3} and search.counts == {}
    # ids go on after an export; ending a span handed over is a no-op
    tr.end(fin)
    assert f.end is None
    assert tr.begin("compact") == len(out)
