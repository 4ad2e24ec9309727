"""Streaming ingestion in the PyTorch port, on the CPU: append-only delta
banks, the exact merged base + delta search (exact and OMS), compaction
and the server's delta path, against the JAX package.

Every case of the reference's ``tests/test_ingest.py`` that runs in one
process, on the port. Each merged search is held against two oracles on
the same numpy inputs: the port's own rebuild (a bank built from the
concatenated arrays) and the reference's merged route. Emulated shards
1 / 2 / 4 / 8, packed and int8 banks, the port's unfused and fused
(kernel-wrapper) routes, ties injected across every block pair, and
deltas of 1 row and of ``k`` rows. Tolerance: exact (indices, scores,
tie order, overflow slots, FDR masks).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.dist.sharding import set_mesh
from repro.serve import DeltaBank as JDeltaBank
from repro.serve import OMSConfig as JOMSConfig
from repro.serve import encode_queries as jencode_queries
from repro.serve import merged_oms_plan as jmerged_oms_plan
from repro.serve import merged_oms_search_encoded as jmerged_oms_search
from repro.serve import merged_search_encoded as jmerged_search
from repro.serve import shard_database as jshard
from repro_torch.launch import serve_cluster, serve_db
from repro_torch.serve import (
    BankRegistry,
    DBSearchServer,
    DeltaBank,
    OMSConfig,
    encode_queries,
    merged_oms_plan,
    merged_oms_search_encoded,
    merged_search_encoded,
    oms_search,
    search_database,
    shard_database,
)

torch.set_num_threads(1)

D = 64
K = 5
CPU = "cpu"


@pytest.fixture(autouse=True)
def _no_global_mesh():
    set_mesh(None)


def _bip(rng, shape):
    return rng.choice([-1, 1], size=shape).astype(np.int8)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _fixture(seed):
    """Fixed shapes, random content, ties injected across every block
    pair (the reference's fixture)."""
    rng = np.random.default_rng(seed)
    refs0, dec0 = _bip(rng, (41, D)), _bip(rng, (23, D))
    refs1, dec1 = _bip(rng, (7, D)), _bip(rng, (5, D))
    refs1[0] = refs0[3]     # delta target == base target: exact score tie
    dec1[1] = dec0[2]       # delta decoy == base decoy
    refs1[2] = dec0[4]      # delta target == base decoy: decoy must win ties
    q = _bip(rng, (12, D))
    q[5] = refs1[0]         # a query sitting exactly on the tied rows
    return refs0, dec0, refs1, dec1, q


def _rebuilt(refs0, dec0, refs1, dec1, **kw):
    return shard_database(_t(np.concatenate([refs0, refs1])),
                          decoys=_t(np.concatenate([dec0, dec1])), **kw)


def _same(got, *wants):
    gi, gv = (np.asarray(a) for a in got)
    for wi, wv in wants:
        assert (gi == np.asarray(wi)).all()
        assert (gv == np.asarray(wv)).all()


# --------------------------------------------------------------------------
# library level: merged search == rebuild == the reference's merged route
# --------------------------------------------------------------------------

def _check_merged_exact(seed, shards, pack, fused, split=True):
    refs0, dec0, refs1, dec1, q = _fixture(seed)
    qt = _t(q)
    base = shard_database(_t(refs0), decoys=_t(dec0), pack=pack,
                          emulate_shards=shards, fused=fused)
    delta = DeltaBank(D, oms=False, device=CPU)
    if split:
        delta.append(refs1[:3], dec1[:2])
        delta.append(refs1[3:], dec1[2:])  # accumulation across appends
    else:
        delta.append(refs1, dec1)
    got = merged_search_encoded(base, delta, encode_queries(base, qt), qt, K)
    rebuilt = search_database(_rebuilt(refs0, dec0, refs1, dec1, pack=pack,
                                       emulate_shards=shards), qt, K)
    jbase = jshard(jnp.asarray(refs0), decoys=jnp.asarray(dec0), pack=pack,
                   emulate_shards=shards)
    jdelta = JDeltaBank(D, oms=False)
    jdelta.append(refs1, dec1)
    qj = jnp.asarray(q)
    ref = jmerged_search(jbase, jdelta, jencode_queries(jbase, qj), qj, K)
    _same(got, rebuilt, ref)


def _check_merged_oms(seed, shards, pack, fused):
    refs0, dec0, refs1, dec1, q = _fixture(seed)
    rng = np.random.default_rng(seed + 1)
    prec0 = rng.uniform(400, 1600, refs0.shape[0]).astype(np.float32)
    prec1 = rng.uniform(400, 1600, refs1.shape[0]).astype(np.float32)
    prec1[0] = prec0[3]  # tied rows share a mass: both inside any window
    qprec = np.sort(rng.uniform(420, 1650, q.shape[0]).astype(np.float32))
    cfg = OMSConfig(tol=15.0, open_tol=150.0)
    qt = _t(q)
    base = shard_database(_t(refs0), decoys=_t(dec0), pack=pack,
                          emulate_shards=shards, fused=fused,
                          precursor=prec0,
                          decoy_precursor=prec0[:dec0.shape[0]])
    delta = DeltaBank(D, oms=True, device=CPU)
    delta.append(refs1, dec1, precursor=prec1,
                 decoy_precursor=prec1[:dec1.shape[0]])
    mplan = merged_oms_plan(base, delta, qprec, cfg)
    rebuilt = _rebuilt(refs0, dec0, refs1, dec1, pack=pack,
                       emulate_shards=shards,
                       precursor=np.concatenate([prec0, prec1]),
                       decoy_precursor=np.concatenate(
                           [prec0[:dec0.shape[0]], prec1[:dec1.shape[0]]]))
    oi, ov, oplan = oms_search(rebuilt, qt, qprec, K, cfg)
    # the merged index reproduces the rebuilt bank's candidate plan
    assert (mplan.starts == oplan.starts).all()
    assert (mplan.lens == oplan.lens).all()
    assert (mplan.has_candidate == oplan.has_candidate).all()
    got = merged_oms_search_encoded(base, delta, encode_queries(base, qt),
                                    qt, mplan, K)
    jbase = jshard(jnp.asarray(refs0), decoys=jnp.asarray(dec0), pack=pack,
                   emulate_shards=shards, precursor=prec0,
                   decoy_precursor=prec0[:dec0.shape[0]])
    jdelta = JDeltaBank(D, oms=True)
    jdelta.append(refs1, dec1, precursor=prec1,
                  decoy_precursor=prec1[:dec1.shape[0]])
    jcfg = JOMSConfig(tol=15.0, open_tol=150.0)
    jplan = jmerged_oms_plan(jbase, jdelta, qprec, jcfg)
    assert (jplan.starts == mplan.starts).all()
    assert (jplan.lens == mplan.lens).all()
    assert jplan.candidate_fraction == mplan.candidate_fraction
    assert jplan.scanned_fraction == mplan.scanned_fraction
    qj = jnp.asarray(q)
    ref = jmerged_oms_search(jbase, jdelta, jencode_queries(jbase, qj), qj,
                             jplan, K)
    _same(got, (oi, ov), ref)


@settings(max_examples=6, deadline=None)
@given(st.integers(0, 10_000), st.sampled_from([1, 2, 4, 8]))
def test_merged_search_bit_identical_to_rebuild(seed, shards):
    for pack in (True, False):
        _check_merged_exact(seed, shards, pack, fused=seed % 2 == 0)


@settings(max_examples=4, deadline=None)
@given(st.integers(0, 10_000), st.sampled_from([1, 2, 4, 8]))
def test_merged_oms_bit_identical_to_rebuild(seed, shards):
    for pack in (True, False):
        _check_merged_oms(seed, shards, pack, fused=seed % 2 == 0)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("pack", [True, False], ids=["packed", "int8"])
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_merged_exact_matches_rebuild_and_reference(shards, pack, fused):
    _check_merged_exact(1234 + shards, shards, pack, fused, split=False)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("pack", [True, False], ids=["packed", "int8"])
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_merged_oms_matches_rebuild_and_reference(shards, pack, fused):
    _check_merged_oms(4321 + shards, shards, pack, fused)


@pytest.mark.parametrize("oms", [False, True], ids=["exact", "oms"])
@pytest.mark.parametrize("pack", [True, False], ids=["packed", "int8"])
@pytest.mark.parametrize("rows", [1, K], ids=["one_row", "k_rows"])
def test_merged_search_tiny_deltas(rows, pack, oms):
    """A delta of 1 row (kd = 1) and of exactly k rows (kd = rows), targets
    only, against the rebuild and the reference."""
    rng = np.random.default_rng(rows * 7 + pack + 2 * oms)
    refs0, dec0 = _bip(rng, (29, D)), _bip(rng, (13, D))
    refs1 = _bip(rng, (rows, D))
    refs1[0] = refs0[1]  # a tie across the append boundary
    q = _bip(rng, (9, D))
    q[0] = refs1[0]
    qt, qj = _t(q), jnp.asarray(q)
    kw, jkw, prec0, prec1, qprec = {}, {}, None, None, None
    if oms:
        prec0 = rng.uniform(400, 1600, 29).astype(np.float32)
        prec1 = rng.uniform(400, 1600, rows).astype(np.float32)
        qprec = np.sort(rng.uniform(420, 1650, 9).astype(np.float32))
        kw = dict(precursor=prec0, decoy_precursor=prec0[:13])
        jkw = kw
    base = shard_database(_t(refs0), decoys=_t(dec0), pack=pack,
                          emulate_shards=2, **kw)
    delta = DeltaBank(D, oms=oms, device=CPU)
    delta.append(refs1, precursor=prec1)
    jbase = jshard(jnp.asarray(refs0), decoys=jnp.asarray(dec0), pack=pack,
                   emulate_shards=2, **jkw)
    jdelta = JDeltaBank(D, oms=oms)
    jdelta.append(refs1, precursor=prec1)
    rebuilt = shard_database(_t(np.concatenate([refs0, refs1])),
                             decoys=_t(dec0), pack=pack, emulate_shards=2,
                             **({} if not oms else dict(
                                 precursor=np.concatenate([prec0, prec1]),
                                 decoy_precursor=prec0[:13])))
    if not oms:
        got = merged_search_encoded(base, delta, encode_queries(base, qt),
                                    qt, K)
        ref = jmerged_search(jbase, jdelta, jencode_queries(jbase, qj), qj,
                             K)
        _same(got, search_database(rebuilt, qt, K), ref)
    else:
        cfg, jcfg = OMSConfig(tol=15.0, open_tol=150.0), JOMSConfig(
            tol=15.0, open_tol=150.0)
        mplan = merged_oms_plan(base, delta, qprec, cfg)
        got = merged_oms_search_encoded(base, delta, encode_queries(base, qt),
                                        qt, mplan, K)
        jplan = jmerged_oms_plan(jbase, jdelta, qprec, jcfg)
        ref = jmerged_oms_search(jbase, jdelta, jencode_queries(jbase, qj),
                                 qj, jplan, K)
        oi, ov, _ = oms_search(rebuilt, qt, qprec, K, cfg)
        _same(got, (oi, ov), ref)


def test_merged_search_degenerate_block_shapes():
    """Tiny deltas (rows < k), decoy-less deltas, and decoy-less bases
    all merge bit-identically."""
    rng = np.random.default_rng(7)
    refs0, dec0 = _bip(rng, (19, D)), _bip(rng, (11, D))
    q = _t(_bip(rng, (6, D)))
    one = _bip(rng, (1, D))
    base = shard_database(_t(refs0), decoys=_t(dec0), emulate_shards=2)
    delta = DeltaBank(D, oms=False, device=CPU)
    delta.append(one)
    got = merged_search_encoded(base, delta, encode_queries(base, q), q, K)
    oracle = shard_database(_t(np.concatenate([refs0, one])),
                            decoys=_t(dec0), emulate_shards=2)
    _same(got, search_database(oracle, q, K))
    base2 = shard_database(_t(refs0), emulate_shards=2)
    delta2 = DeltaBank(D, oms=False, device=CPU)
    refs1, dec1 = _bip(rng, (4, D)), _bip(rng, (3, D))
    delta2.append(refs1, dec1)
    got2 = merged_search_encoded(base2, delta2, encode_queries(base2, q), q,
                                 K)
    oracle2 = shard_database(_t(np.concatenate([refs0, refs1])),
                             decoys=_t(dec1), emulate_shards=2)
    _same(got2, search_database(oracle2, q, K))


def test_merge_by_row_orders_score_then_row_with_sentinels_last():
    """The int64-key merge: score descending, rebuilt row ascending on
    ties, ``INT32_MIN`` slots behind every real candidate (rows
    ascending among them), values kept."""
    from repro_torch.serve.delta import _merge_by_row
    m = np.iinfo(np.int32).min
    vals = torch.tensor([[3, m, 7, 3, -64, m, 64]], dtype=torch.int32)
    rows = torch.tensor([[9, 4, 2, 1, 0, 3, 2**31 - 1]], dtype=torch.int32)
    r, v = _merge_by_row(vals, rows, 7)
    assert r.tolist() == [[2**31 - 1, 2, 1, 9, 0, 3, 4]]
    assert v.tolist() == [[64, 7, 3, 3, -64, m, m]]
    assert r.dtype == v.dtype == torch.int32


# --------------------------------------------------------------------------
# DeltaBank / BankRegistry validation + counters
# --------------------------------------------------------------------------

def test_delta_bank_validation():
    d = DeltaBank(D, oms=False, device=CPU)
    with pytest.raises(ValueError, match="refs shape"):
        d.append(np.zeros((3, D + 1), np.int8))
    with pytest.raises(ValueError, match="decoys shape"):
        d.append(np.zeros((3, D), np.int8), np.zeros((3, D - 1), np.int8))
    with pytest.raises(ValueError, match="at least one"):
        d.append(np.zeros((0, D), np.int8))
    with pytest.raises(ValueError, match="no precursor"):
        d.append(np.zeros((2, D), np.int8), precursor=np.ones(2))
    assert d.num_rows == 0 and d.version == 0  # failed appends land nothing

    o = DeltaBank(D, oms=True, device=CPU)
    with pytest.raises(ValueError, match="requires precursor"):
        o.append(np.ones((2, D), np.int8))
    with pytest.raises(ValueError, match="precursor has 3"):
        o.append(np.ones((2, D), np.int8), precursor=np.ones(3))
    with pytest.raises(ValueError, match="decoy_precursor has 1"):
        o.append(np.ones((2, D), np.int8), np.ones((2, D), np.int8),
                 precursor=np.ones(2), decoy_precursor=np.ones(1))
    assert o.append(np.ones((2, D), np.int8), precursor=np.ones(2)) == 2
    # tensors append as arrays do, onto the delta's device
    assert o.append(torch.ones((1, D), dtype=torch.int8),
                    precursor=np.ones(1)) == 3
    assert o.refs.device.type == "cpu" and o.db.num_rows == 3


def test_registry_append_counters_and_guards():
    rng = np.random.default_rng(3)
    reg = BankRegistry(emulate_shards=2)
    refs, dec = _bip(rng, (20, D)), _bip(rng, (10, D))
    reg.register("a", _t(refs), decoys=_t(dec))
    with pytest.raises(KeyError):
        reg.append("nope", _bip(rng, (1, D)))
    reg.adopt("pre", shard_database(_t(refs)))
    with pytest.raises(ValueError, match="adopted"):
        reg.append("pre", _bip(rng, (1, D)))

    assert reg.delta("a") is None and reg.delta_fraction("a") == 0.0
    assert reg.append("a", _bip(rng, (4, D)), _bip(rng, (2, D))) == 6
    assert reg.append("a", _bip(rng, (2, D))) == 8
    assert reg.appends == 2 and reg.tenants_with_delta() == ["a"]
    assert reg.delta_fraction("a") == pytest.approx(8 / 38)
    s = reg.summary()
    assert s["appends"] == 2 and s["compactions"] == 0
    assert s["delta_rows"] == 8 and s["tenants_with_delta"] == 1
    # the delta lives on the spec's device
    assert reg.delta("a").device == _t(refs).device
    # re-registering drops the pending delta with the stale spec
    reg.register("a", _t(refs), decoys=_t(dec))
    assert reg.delta("a") is None and reg.tenants_with_delta() == []
    reg.pin("a")
    reg.unpin("a")
    assert reg.summary()["pinned"] == 1  # "pre" was adopted pinned


def test_compaction_folds_delta_and_is_idempotent():
    rng = np.random.default_rng(11)
    reg = BankRegistry(emulate_shards=2)
    refs, dec = _bip(rng, (24, D)), _bip(rng, (12, D))
    refs1, dec1 = _bip(rng, (6, D)), _bip(rng, (3, D))
    reg.register("a", _t(refs), decoys=_t(dec))
    assert reg.compact("a") is False
    reg.append("a", refs1, dec1)
    q = _t(_bip(rng, (8, D)))
    db, delta = reg.get_with_delta("a")
    before = merged_search_encoded(db, delta, encode_queries(db, q), q, K)
    assert reg.compact("a") is True
    db2, delta2 = reg.get_with_delta("a")
    assert delta2 is None and reg.compactions == 1
    assert db2.num_rows == 45 and db2.num_decoys == 15
    _same(search_database(db2, q, K), before)
    assert reg.compact("a") is False and reg.compactions == 1


def test_compaction_atomic_under_build_failure(monkeypatch):
    """A failing merged build leaves the registry exactly as it was: old
    bank still served, delta still pending, counters untouched."""
    rng = np.random.default_rng(13)
    reg = BankRegistry(emulate_shards=2)
    refs, dec = _bip(rng, (16, D)), _bip(rng, (8, D))
    reg.register("a", _t(refs), decoys=_t(dec))
    reg.register("b", _t(refs[:9]), decoys=_t(dec[:4]))
    reg.append("a", _bip(rng, (4, D)))
    old_db, other = reg.get("a"), reg.get("b")
    builds = reg.builds
    import repro_torch.serve.db_search as db_search_mod

    def boom(*a, **kw):
        raise RuntimeError("injected build failure")

    monkeypatch.setattr(db_search_mod, "shard_database", boom)
    with pytest.raises(RuntimeError, match="injected"):
        reg.compact("a")
    monkeypatch.undo()
    assert reg.get("a") is old_db and reg.get("b") is other
    assert reg.delta("a") is not None and reg.delta("a").num_rows == 4
    assert reg.compactions == 0 and reg.tenants_with_delta() == ["a"]
    assert reg.builds == builds
    # the OMS spec keeps its precursors through a successful compaction
    prec = np.linspace(400, 1600, 16).astype(np.float32)
    reg.register("o", _t(refs), decoys=_t(dec), precursor=prec)
    reg.append("o", _bip(rng, (2, D)), _bip(rng, (1, D)),
               precursor=np.asarray([500.0, 900.0], np.float32),
               decoy_precursor=np.asarray([500.0], np.float32))
    assert reg.compact("o") and reg.get("o").oms.num_rows == 27
    assert reg.get("b") is other  # other tenants untouched


# --------------------------------------------------------------------------
# server level: delta path through FDR, compaction between batches
# --------------------------------------------------------------------------

def _drain_results(server, queries, tenant, prec=None):
    rids = [server.submit(q, tenant=tenant,
                          precursor=None if prec is None else float(prec[i]))
            for i, q in enumerate(queries)]
    done = {r.rid: r for r in server.run_until_drained()}
    return [done[rid].result for rid in rids]


def _assert_results_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (np.asarray(g.indices) == np.asarray(w.indices)).all()
        assert (np.asarray(g.scores) == np.asarray(w.scores)).all()
        assert bool(g.is_target) == bool(w.is_target)
        assert bool(g.accept) == bool(w.accept)
        assert int(g.match) == int(w.match)
        assert bool(g.has_candidate) == bool(w.has_candidate)


def _jserver(refs0, dec0, refs1, dec1, **kw):
    """The reference's server with the same append."""
    from repro.serve import BankRegistry as JRegistry
    from repro.serve import DBSearchServer as JServer
    prec0, prec1 = kw.pop("prec0", None), kw.pop("prec1", None)
    oms = kw.get("oms")
    reg = JRegistry(emulate_shards=2)
    reg.register("a", jnp.asarray(refs0), decoys=jnp.asarray(dec0),
                 precursor=prec0,
                 decoy_precursor=None if prec0 is None else prec0[:15])
    srv = JServer(reg, k=4, fdr=0.5, max_batch_size=4, flush_timeout_s=0.0,
                  **kw)
    srv.append("a", refs1, dec1, precursor=prec1,
               decoy_precursor=None if oms is None else prec1[:3])
    return srv


@pytest.mark.parametrize("continuous", [False, True],
                         ids=["flush_sync", "continuous"])
def test_server_delta_path_matches_rebuilt_through_fdr(continuous):
    rng = np.random.default_rng(17)
    refs0, dec0 = _bip(rng, (30, D)), _bip(rng, (15, D))
    refs1, dec1 = _bip(rng, (6, D)), _bip(rng, (3, D))
    refs1[1] = refs0[0]  # tie across the append boundary
    queries = list(_bip(rng, (10, D)))
    queries[2] = refs1[1].copy()

    live_reg = BankRegistry(emulate_shards=2)
    live_reg.register("a", _t(refs0), decoys=_t(dec0))
    live = DBSearchServer(live_reg, k=4, fdr=0.5, max_batch_size=4,
                          flush_timeout_s=0.0, continuous=continuous)
    live.append("a", refs1, dec1)

    oracle_reg = BankRegistry(emulate_shards=2)
    oracle_reg.register("a", _t(np.concatenate([refs0, refs1])),
                        decoys=_t(np.concatenate([dec0, dec1])))
    oracle = DBSearchServer(oracle_reg, k=4, fdr=0.5, max_batch_size=4,
                            flush_timeout_s=0.0)
    got = _drain_results(live, queries, "a")
    _assert_results_equal(got, _drain_results(oracle, queries, "a"))
    _assert_results_equal(got, _drain_results(
        _jserver(refs0, dec0, refs1, dec1), queries, "a"))
    ing = live.summary()["ingest"]
    assert ing["appends"] == 1 and ing["tenants_with_delta"] == ["a"]


@pytest.mark.parametrize("continuous", [False, True],
                         ids=["flush_sync", "continuous"])
def test_server_oms_delta_path_matches_rebuilt_through_fdr(continuous):
    rng = np.random.default_rng(19)
    refs0, dec0 = _bip(rng, (30, D)), _bip(rng, (15, D))
    refs1, dec1 = _bip(rng, (6, D)), _bip(rng, (3, D))
    prec0 = rng.uniform(400, 1600, 30).astype(np.float32)
    prec1 = rng.uniform(400, 1600, 6).astype(np.float32)
    queries = list(_bip(rng, (10, D)))
    qprec = rng.uniform(420, 1650, 10).astype(np.float32)  # unsorted
    cfg = OMSConfig(tol=15.0, open_tol=150.0)

    live_reg = BankRegistry(emulate_shards=2)
    live_reg.register("a", _t(refs0), decoys=_t(dec0), precursor=prec0,
                      decoy_precursor=prec0[:15])
    live = DBSearchServer(live_reg, k=4, fdr=0.5, max_batch_size=4,
                          flush_timeout_s=0.0, oms=cfg,
                          continuous=continuous)
    live.append("a", refs1, dec1, precursor=prec1, decoy_precursor=prec1[:3])

    oracle_reg = BankRegistry(emulate_shards=2)
    oracle_reg.register(
        "a", _t(np.concatenate([refs0, refs1])),
        decoys=_t(np.concatenate([dec0, dec1])),
        precursor=np.concatenate([prec0, prec1]),
        decoy_precursor=np.concatenate([prec0[:15], prec1[:3]]))
    oracle = DBSearchServer(oracle_reg, k=4, fdr=0.5, max_batch_size=4,
                            flush_timeout_s=0.0, oms=cfg)
    got = _drain_results(live, queries, "a", qprec)
    _assert_results_equal(got, _drain_results(oracle, queries, "a", qprec))
    _assert_results_equal(got, _drain_results(
        _jserver(refs0, dec0, refs1, dec1, prec0=prec0, prec1=prec1,
                 oms=JOMSConfig(tol=15.0, open_tol=150.0)),
        queries, "a", qprec))


@pytest.mark.parametrize("oms", [False, True], ids=["exact", "oms"])
def test_server_encoder_delta_path_takes_the_staged_encode(oms):
    """A fused-e2e server's delta batches take the staged encode (cached)
    and the merged search: equal to a rebuilt bank's fused-e2e server."""
    from repro_torch.core.hd.encoding import (
        HDEncoderConfig,
        encode_levels_batch,
        make_codebooks,
    )
    from repro_torch.serve import QueryEncoder
    rng = np.random.default_rng(29)
    idh, lvh = make_codebooks(HDEncoderConfig(dim=D, num_features=24,
                                              num_levels=6, seed=3),
                              device=CPU)
    enc = QueryEncoder(id_hvs=idh, level_hvs=lvh)
    lev = rng.integers(0, 6, size=(60, 24)).astype(np.int32)
    lev[rng.random(lev.shape) < 0.5] = 0
    hv = encode_levels_batch(_t(lev), idh, lvh).numpy()
    refs0, dec0, refs1, dec1 = hv[:30], hv[30:45], hv[45:51], hv[51:54]
    prec = rng.uniform(400, 1600, 36).astype(np.float32)
    q_lev = np.concatenate([lev[[2, 46, 47, 31]],
                            rng.integers(0, 6, size=(5, 24))]).astype(
        np.int32)
    qprec = rng.uniform(420, 1650, 9).astype(np.float32)
    cfg = OMSConfig(tol=15.0, open_tol=150.0) if oms else None

    def server(refs, dec, p, dp):
        reg = BankRegistry(emulate_shards=2)
        reg.register("a", _t(refs), decoys=_t(dec),
                     precursor=p if oms else None,
                     decoy_precursor=dp if oms else None)
        return reg, DBSearchServer(reg, k=4, fdr=0.5, max_batch_size=4,
                                   flush_timeout_s=0.0, oms=cfg,
                                   encoder=enc, fused_e2e=True,
                                   continuous=True)

    _, live = server(refs0, dec0, prec[:30], prec[:15])
    live.append("a", refs1, dec1, precursor=prec[30:] if oms else None,
                decoy_precursor=prec[30:33] if oms else None)
    _, oracle = server(np.concatenate([refs0, refs1]),
                       np.concatenate([dec0, dec1]), prec,
                       np.concatenate([prec[:15], prec[30:33]]))
    got = _drain_results(live, list(q_lev), "a", qprec if oms else None)
    _assert_results_equal(got, _drain_results(oracle, list(q_lev), "a",
                                              qprec if oms else None))
    # the staged encode went through the cache; the fused route skips it
    assert live.query_cache.misses == len(q_lev)
    assert oracle.query_cache.misses == oracle.query_cache.hits == 0


@pytest.mark.parametrize("continuous", [False, True],
                         ids=["flush_sync", "continuous"])
def test_server_compacts_between_batches_without_dropping_requests(
        continuous):
    """Queries queued before a threshold-crossing append survive the
    compaction (it runs between batches) and return the rebuilt bank's
    exact results."""
    rng = np.random.default_rng(23)
    refs0, dec0 = _bip(rng, (20, D)), _bip(rng, (10, D))
    refs1, dec1 = _bip(rng, (8, D)), _bip(rng, (4, D))
    queries = list(_bip(rng, (8, D)))

    reg = BankRegistry(emulate_shards=2)
    reg.register("a", _t(refs0), decoys=_t(dec0))
    srv = DBSearchServer(reg, k=4, fdr=0.5, max_batch_size=4,
                         flush_timeout_s=0.0, compact_threshold=0.25,
                         continuous=continuous)
    srv.append("a", refs1[:1])
    srv.submit(queries[0], tenant="a")
    srv.run_until_drained()
    assert reg.tenants_with_delta() == ["a"] and reg.compactions == 0
    rids = [srv.submit(q, tenant="a") for q in queries]
    srv.append("a", refs1[1:], dec1)
    # the next step compacts before it admits (continuous mode drains
    # without compacting, as the reference's does)
    done = {r.rid: r for r in srv.step() + srv.run_until_drained()}
    assert sorted(done) == sorted(rids)
    assert reg.compactions == 1 and reg.tenants_with_delta() == []

    oracle_reg = BankRegistry(emulate_shards=2)
    oracle_reg.register("a", _t(np.concatenate([refs0, refs1])),
                        decoys=_t(np.concatenate([dec0, dec1])))
    oracle = DBSearchServer(oracle_reg, k=4, fdr=0.5, max_batch_size=4,
                            flush_timeout_s=0.0)
    _assert_results_equal([done[r].result for r in rids],
                          _drain_results(oracle, queries, "a"))
    ing = srv.summary()["ingest"]
    assert ing["compactions"] == 1 and ing["compact_threshold"] == 0.25


def test_compaction_with_a_slot_in_flight_keeps_its_bank():
    """A batch dispatched on base + delta, then a compaction, then its
    finalize: the handle keeps the bank, delta and decoy count it was
    dispatched with, and its results equal the rebuilt bank's."""
    rng = np.random.default_rng(31)
    refs0, dec0 = _bip(rng, (20, D)), _bip(rng, (10, D))
    refs1, dec1 = _bip(rng, (5, D)), _bip(rng, (2, D))
    queries = list(_bip(rng, (4, D)))
    queries[1] = dec1[0].copy()  # the top hit is a delta decoy
    reg = BankRegistry()
    reg.register("a", _t(refs0), decoys=_t(dec0))
    srv = DBSearchServer(reg, k=3, fdr=0.5, max_batch_size=4,
                         flush_timeout_s=0.0, continuous=True)
    srv.append("a", refs1, dec1)
    for q in queries:
        srv.submit(q, tenant="a")
    h = srv.executor.dispatch(srv.queue.take_batch())
    old_db = reg.get("a")
    assert reg.compact("a")
    assert h.db is old_db and h.delta is not None and h.num_decoys == 12
    got = [r.result for r in srv.executor.finalize(h)]
    oracle_reg = BankRegistry()
    oracle_reg.register("a", _t(np.concatenate([refs0, refs1])),
                        decoys=_t(np.concatenate([dec0, dec1])))
    oracle = DBSearchServer(oracle_reg, k=3, fdr=0.5, max_batch_size=4,
                            flush_timeout_s=0.0)
    want = _drain_results(oracle, queries, "a")
    _assert_results_equal(got, want)
    assert got[1].indices[0] == 10 and not got[1].is_target


def test_server_compact_threshold_validation():
    reg = BankRegistry()
    with pytest.raises(ValueError, match="compact_threshold"):
        DBSearchServer(reg, compact_threshold=0.0)
    with pytest.raises(ValueError, match="compact_threshold"):
        DBSearchServer(reg, compact_threshold=1.5)


# --------------------------------------------------------------------------
# the launchers, continuous and with streaming ingestion, on the CPU
# --------------------------------------------------------------------------

_SMALL = ["--reduced", "--device", "cpu", "--identities", "24",
          "--queries", "48", "--hd-dim", "256"]


@pytest.mark.parametrize("route", [[], ["--fused"], ["--fused-e2e"],
                                   ["--oms", "--fused"],
                                   ["--oms", "--fused-e2e"]],
                         ids=["staged", "fused", "fused_e2e", "oms_fused",
                              "oms_fused_e2e"])
def test_serve_db_continuous_append_and_compaction(route, capsys):
    """``--continuous --append 0.25 --compact-threshold 0.1``: the held-out
    quarter streams back in halfway, is compacted between batches, and the
    run identifies what the flush-sync run without an append does."""
    s = serve_db.main(_SMALL + route + [
        "--continuous", "--num-slots", "2", "--append", "0.25",
        "--compact-threshold", "0.1"])
    out = capsys.readouterr().out
    assert s["mode"] == "continuous" and s["count"] == s["total"]
    assert s["scheduler"]["dispatched_batches"] == s["batches"]
    assert s["banks"]["appends"] == 1 and s["banks"]["compactions"] == 1
    assert s["banks"]["delta_rows"] == 0
    assert "scheduler: 2 slots" in out and "ingest: 1 appends" in out
    assert "device search not timed" in out
    # a quarter of the targets is missing for the first half of the
    # traffic only: most queries are still identified, as in the same
    # run with no append
    base = serve_db.main(_SMALL + route)
    assert base["mode"] == "flush-sync" and base["banks"]["appends"] == 0
    for run in (s, base):
        assert run["total"] // 2 <= run["correct"] <= run["identified"]


def test_serve_db_append_without_compaction_serves_merged(capsys):
    """``--append 0.25`` with no threshold: the delta stays pending to the
    end and every later batch takes the merged route."""
    s = serve_db.main(_SMALL + ["--fused", "--continuous", "--append",
                                "0.25"])
    out = capsys.readouterr().out
    assert s["banks"]["delta_rows"] > 0 and s["banks"]["compactions"] == 0
    assert s["ingest"]["tenants_with_delta"] == ["tenant0"]
    assert "appended" in out and "0 compactions" in out


def test_serve_cluster_continuous_matches_flush_sync_quality(capsys):
    s = serve_cluster.main(["--reduced", "--device", "cpu", "--tenants", "2",
                            "--consolidate-every", "64", "--continuous",
                            "--num-slots", "2"])
    out = capsys.readouterr().out
    assert s["mode"] == "continuous" and s["count"] == s["total"]
    assert "mode=continuous" in out and "scheduler: 2 slots" in out
    for q in s["cluster_quality"].values():
        assert 0.0 <= q["incorrect_ratio"] <= 1.0
        assert q["clustered_ratio"] > 0.5
