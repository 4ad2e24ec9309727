"""Open-modification search (OMS) of the PyTorch port against the JAX
package, on the CPU: the precursor index and plan, preprocessing, the OMS
routes over emulated shards (encoded, staged and fused end-to-end), FDR
with ``valid=``, the OMS server and the launcher.

Banks and codebooks are the reference's own arrays carried across with
``repro_torch.convert``; the reference runs its emulated-shard routes
(its shard_map routes are not the yardstick, see ROADMAP "Test tiers").
Tolerance: exact (row ranges, tile budgets, indices, scores, tie order,
overflow slots, valid, accept and match masks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core.hd.encoding import HDEncoderConfig, make_codebooks
from repro.core.hd.encoding import encode_levels_batch as jencode
from repro.serve import DBSearchServer as JServer
from repro.serve import QueryEncoder as JEncoder
from repro.serve import oms as joms
from repro.serve import shard_database as jshard
from repro.serve.db_search import encode_queries as jencode_queries
from repro.serve.db_search import fdr_route as jfdr_route
from repro.serve.db_search import oms_plan as joms_plan
from repro.serve.db_search import oms_search_encoded as joms_encoded
from repro.serve.db_search import oms_search_levels as joms_levels
from repro.serve.db_search import oms_search_with_fdr as joms_fdr
from repro.spectra import preprocess as jpre
from repro_torch.convert import bank_rows_from_numpy, encoder_from_numpy
from repro_torch.launch import serve_db
from repro_torch.serve import (
    BankRegistry,
    DBSearchServer,
    OMSConfig,
    fdr_route,
    oms_plan,
    oms_search_encoded,
    oms_search_levels,
    oms_search_with_fdr,
    shard_database,
)
from repro_torch.serve import oms
from repro_torch.spectra import preprocess

# small tensors: one intra-op thread leaves the cores to the other test
# workers
torch.set_num_threads(1)

CPU = "cpu"
F, M = 48, 8
CFG = OMSConfig(tol=15.0, open_tol=150.0)
JCFG = joms.OMSConfig(tol=15.0, open_tol=150.0)
SENTINEL = np.iinfo(np.int32).min


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------------
# precursor index, plan, preprocessing
# --------------------------------------------------------------------------

def _assert_index_equal(got, want):
    np.testing.assert_array_equal(got.prec_sorted, want.prec_sorted)
    np.testing.assert_array_equal(got.perm, want.perm)
    assert got.block_bounds == want.block_bounds


@settings(max_examples=10, deadline=None)
@given(st.integers(1, 400), st.integers(1, 40), st.integers(0, 1),
       st.integers(0, 1))
def test_index_plan_and_translation_match_reference(r, q, open_s, decoys):
    rng = np.random.default_rng(r * 71 + q * 3 + open_s)
    prec = rng.uniform(400, 1600, r).astype(np.float32)
    dprec = rng.uniform(400, 1600, r).astype(np.float32) if decoys else None
    qprec = rng.uniform(350, 1800, q).astype(np.float32)
    qprec[: q // 4] = 1e6                    # empty windows
    cfg = OMSConfig(tol=25.0, open_tol=180.0, open_search=bool(open_s))
    jcfg = joms.OMSConfig(tol=25.0, open_tol=180.0, open_search=bool(open_s))
    index = oms.build_precursor_index(prec, dprec)
    jindex = joms.build_precursor_index(prec, dprec)
    _assert_index_equal(index, jindex)
    for got, want in zip(index.candidate_ranges(qprec, cfg),
                         jindex.candidate_ranges(qprec, jcfg)):
        np.testing.assert_array_equal(got, want)
    padded = index.num_rows + int(rng.integers(0, 300))
    for bq in (8, 128):
        got = oms.plan_candidates(index, qprec, cfg, num_rows_padded=padded,
                                  block_q=bq)
        want = joms.plan_candidates(jindex, qprec, jcfg,
                                    num_rows_padded=padded, block_q=bq)
        np.testing.assert_array_equal(got.starts, want.starts)
        np.testing.assert_array_equal(got.lens, want.lens)
        np.testing.assert_array_equal(got.has_candidate, want.has_candidate)
        assert (got.num_tiles, got.scanned_fraction,
                got.candidate_fraction) == (want.num_tiles,
                                            want.scanned_fraction,
                                            want.candidate_fraction)
    rows = rng.integers(-3, index.num_rows + 5, (q, 4))
    np.testing.assert_array_equal(oms.translate_indices(index, rows),
                                  joms.translate_indices(jindex, rows))


@settings(max_examples=10, deadline=None)
@given(st.integers(1, 60), st.integers(1, 40), st.integers(0, 1))
def test_ranges_select_exactly_the_window_mask(r, q, open_s):
    """The sorted rows inside each query's range are exactly the rows the
    port's ``candidate_window_mask`` keeps, and that mask is the
    reference's."""
    rng = np.random.default_rng(r * 13 + q + open_s)
    ref_prec = rng.uniform(400, 1600, r).astype(np.float32)
    query_prec = rng.uniform(350, 1800, q).astype(np.float32)
    cfg = OMSConfig(tol=25.0, open_tol=180.0, open_search=bool(open_s))
    index = oms.build_precursor_index(ref_prec)
    starts, lens = index.candidate_ranges(query_prec, cfg)
    mask = preprocess.candidate_window_mask(
        _t(query_prec), _t(ref_prec), tol=cfg.tol,
        open_search=cfg.open_search, open_tol=cfg.open_tol).numpy()
    want = jpre.candidate_window_mask(
        jnp.asarray(query_prec), jnp.asarray(ref_prec), tol=cfg.tol,
        open_search=cfg.open_search, open_tol=cfg.open_tol)
    np.testing.assert_array_equal(mask, np.asarray(want))
    for i in range(q):
        rows = index.perm[starts[0, i]:starts[0, i] + lens[0, i]]
        assert set(rows.tolist()) == set(np.flatnonzero(mask[i]).tolist())


def test_preprocess_matches_reference():
    rng = np.random.default_rng(7)
    mz = rng.uniform(150, 2100, (6, 40)).astype(np.float32)
    inten = rng.uniform(0, 1, (6, 40)).astype(np.float32)
    inten[:, 30:] = 0.0                          # padded peaks
    inten[5] = 0.0                               # an empty spectrum
    got = preprocess.bin_spectra(_t(mz), _t(inten), 128)
    want = jpre.bin_spectra(jnp.asarray(mz), jnp.asarray(inten), 128)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        preprocess.sqrt_normalize(got).numpy(),
        np.asarray(jpre.sqrt_normalize(want)))
    prec = rng.uniform(400, 1600, 50).astype(np.float32)
    for p in (prec, prec[:0]):
        got_b = preprocess.bucket_by_precursor(p, 40.0)
        want_b = jpre.bucket_by_precursor(p, 40.0)
        assert len(got_b) == len(want_b)
        for g, w in zip(got_b, want_b):
            np.testing.assert_array_equal(g, w)


# --------------------------------------------------------------------------
# OMS routes
# --------------------------------------------------------------------------

def _library(seed, n_refs, n_q, d):
    """Reference codebooks, bank HVs (targets; decoys tie some targets),
    precursors, and query levels and precursors. Half the queries copy a
    bank row's levels at its precursor; some precursors have no window."""
    rng = np.random.default_rng(seed)
    idh, lvh = (np.asarray(a) for a in make_codebooks(HDEncoderConfig(
        dim=d, num_features=F, num_levels=M, seed=seed)))
    lev = rng.integers(0, M, size=(n_refs, F)).astype(np.int32)
    lev[rng.random(lev.shape) < 0.6] = 0
    lev[n_refs // 2:] = lev[: n_refs - n_refs // 2]   # duplicate rows: ties
    hv = np.asarray(jencode(jnp.asarray(lev), jnp.asarray(idh),
                            jnp.asarray(lvh)))
    decoys = -hv
    decoys[:10] = hv[:10]                             # target/decoy ties
    prec = rng.uniform(400, 1600, n_refs).astype(np.float32)
    prec[n_refs // 2:] = prec[: n_refs - n_refs // 2]
    q_lev = rng.integers(0, M, size=(n_q, F)).astype(np.int32)
    q_lev[rng.random(q_lev.shape) < 0.6] = 0
    qprec = rng.uniform(420, 1650, n_q).astype(np.float32)
    pick = rng.integers(0, n_refs, size=n_q // 2)
    q_lev[: n_q // 2] = lev[pick]
    qprec[: n_q // 2] = prec[pick] + 40.0
    qprec[-2:] = 1e6                                  # empty windows
    return idh, lvh, hv, decoys, prec, q_lev, qprec


def _jax_masked_oracle(jdb, q_hv, refs, decoys, jplan, k):
    """Mask the full score matrix over the sorted bank outside the plan's
    bands, top-k, translate through the permutation (the reference's
    ``tests/test_serve.py`` definition)."""
    bank = jnp.concatenate([decoys, refs])[jnp.asarray(jdb.oms.perm)]
    scores = jnp.asarray(q_hv, jnp.int32) @ bank.T.astype(jnp.int32)
    col = jnp.arange(bank.shape[0], dtype=jnp.int32)[None, :]
    starts = jnp.asarray(jplan.starts)
    ends = starts + jnp.asarray(jplan.lens)
    band = jnp.zeros(scores.shape, bool)
    for b in range(starts.shape[0]):
        band = band | ((col >= starts[b][:, None]) & (col < ends[b][:, None]))
    vals, idx = jax.lax.top_k(jnp.where(band, scores, SENTINEL), k)
    return jnp.take(jnp.asarray(jdb.oms.perm), idx, axis=0), vals


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("packed", [True, False])
def test_oms_routes_match_reference(shards, packed):
    """Encoded (fused and unfused), staged and fused end-to-end OMS routes
    of the port equal the reference's routes and its masked oracle, with
    ragged last shards (300 rows over 128-row-aligned shards)."""
    d = 64 if packed else 72
    idh, lvh, refs, decoys, prec, q_lev, qprec = _library(
        shards * 10 + d, 150, 13, d)
    k = 7
    emu = shards if shards > 1 else None
    jdb = jshard(jnp.asarray(refs), decoys=jnp.asarray(decoys),
                 emulate_shards=emu, precursor=prec, fused=shards == 2)
    jplan = joms_plan(jdb, qprec, JCFG)
    jenc = JEncoder(id_hvs=jnp.asarray(idh), level_hvs=jnp.asarray(lvh))
    q_hv = jencode(jnp.asarray(q_lev), jnp.asarray(idh), jnp.asarray(lvh))
    q_enc_j = jencode_queries(jdb, q_hv)
    wants = [joms_encoded(jdb, q_enc_j, jplan, k),
             _jax_masked_oracle(jdb, q_hv, jnp.asarray(refs),
                                jnp.asarray(decoys), jplan, k),
             joms_levels(jdb, jenc, jnp.asarray(q_lev), jplan, k,
                         fused_e2e=True)]
    enc = encoder_from_numpy(idh, lvh, device=CPU)
    q_enc = bank_rows_from_numpy(q_enc_j, device=CPU)
    for fused in (False, True):
        db = shard_database(_t(refs), decoys=_t(decoys), emulate_shards=emu,
                            precursor=prec, fused=fused)
        np.testing.assert_array_equal(
            db.data.numpy(), bank_rows_from_numpy(jdb.data, CPU).numpy())
        assert (db.shard_rows, db.num_rows, db.packed) == (
            jdb.shard_rows, jdb.num_rows, jdb.packed)
        plan = oms_plan(db, qprec, CFG)
        assert plan.num_tiles == jplan.num_tiles
        routes = [oms_search_encoded(db, q_enc, plan, k)]
        for fused_e2e in (False, True):
            routes.append(oms_search_levels(db, enc, _t(q_lev), plan, k,
                                            fused_e2e=fused_e2e))
        for idx, vals in routes:
            for want_i, want_v in wants:
                np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
                np.testing.assert_array_equal(vals.numpy(),
                                              np.asarray(want_v))
    assert (np.asarray(wants[0][1]) == SENTINEL).any()  # overflow slots hit


def test_oms_with_fdr_matches_reference():
    idh, lvh, refs, decoys, prec, q_lev, qprec = _library(41, 90, 16, 64)
    q_hv = np.asarray(jencode(jnp.asarray(q_lev), jnp.asarray(idh),
                              jnp.asarray(lvh)))
    jdb = jshard(jnp.asarray(refs), decoys=jnp.asarray(decoys),
                 emulate_shards=4, precursor=prec)
    want = joms_fdr(jdb, jnp.asarray(q_hv), qprec, k=4, fdr=0.5, cfg=JCFG)
    for fused in (False, True):
        db = shard_database(_t(refs), decoys=_t(decoys), emulate_shards=4,
                            precursor=prec, fused=fused)
        got = oms_search_with_fdr(db, _t(q_hv), qprec, k=4, fdr=0.5, cfg=CFG)
        for name in ("indices", "scores", "is_target", "accept", "match",
                     "valid"):
            np.testing.assert_array_equal(getattr(got, name),
                                          np.asarray(getattr(want, name)),
                                          err_msg=name)
    assert not got.valid[-2:].any() and got.accept.any()
    assert (got.match[-2:] == -1).all() and not got.is_target[-2:].any()


def test_fdr_route_num_decoys_override_matches_reference():
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 40, (12, 3)).astype(np.int32)
    vals = rng.integers(-20, 20, (12, 3)).astype(np.int32)
    valid = rng.random(12) < 0.8
    db = shard_database(_t(rng.choice([-1, 1], (20, 32)).astype(np.int8)),
                        decoys=_t(rng.choice([-1, 1], (10, 32)).astype(
                            np.int8)))
    jdb = jshard(jnp.asarray(rng.choice([-1, 1], (20, 32)).astype(np.int8)),
                 decoys=jnp.asarray(rng.choice([-1, 1], (10, 32)).astype(
                     np.int8)))
    got = fdr_route(db, _t(idx), _t(vals), fdr=0.3, valid=_t(valid),
                    num_decoys=17)
    want = jfdr_route(jdb, jnp.asarray(idx), jnp.asarray(vals), fdr=0.3,
                      valid=jnp.asarray(valid), num_decoys=17)
    for name in ("is_target", "accept", "match", "valid"):
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


def test_oms_requires_a_precursor_bank():
    db = shard_database(_t(np.ones((20, 32), np.int8)))
    with pytest.raises(ValueError, match="precursor"):
        oms_plan(db, np.asarray([500.0], np.float32))


# --------------------------------------------------------------------------
# the OMS server and launcher
# --------------------------------------------------------------------------

def _drive(server, queries, qprec, clock):
    """One fixed submission schedule: bursts, timeouts, a forced drain."""
    done = []
    for i, (q, p) in enumerate(zip(queries, qprec)):
        server.submit(q, precursor=float(p))
        if i % 5 == 4:
            clock[0] += 0.02                   # past the flush timeout
        done.extend(server.step())
    done.extend(server.run_until_drained())
    return {r.rid: r.result for r in done}


@pytest.mark.parametrize("mode", ["encoded", "fused_e2e"])
def test_oms_server_matches_reference_and_direct_route(mode):
    """The port's OMS server equals the reference's server request by
    request (ragged flushes padded to buckets, sorted and unsorted), and
    equals the direct route in submit order."""
    idh, lvh, refs, decoys, prec, q_lev, qprec = _library(53, 120, 18, 64)
    queries = q_lev if mode == "fused_e2e" else np.asarray(
        jencode(jnp.asarray(q_lev), jnp.asarray(idh), jnp.asarray(lvh)))
    kw = dict(k=3, fdr=0.5, max_batch_size=8, flush_timeout_s=0.01,
              cache_bytes=1 << 20, buckets=3)
    e2e = mode == "fused_e2e"
    jclock, tclock = [0.0], [0.0]
    jsrv = JServer(jshard(jnp.asarray(refs), decoys=jnp.asarray(decoys),
                          emulate_shards=2, precursor=prec),
                   clock=lambda: jclock[0], oms=JCFG, fused_e2e=e2e,
                   encoder=JEncoder(id_hvs=jnp.asarray(idh),
                                    level_hvs=jnp.asarray(lvh))
                   if e2e else None, **kw)
    db = shard_database(_t(refs), decoys=_t(decoys), emulate_shards=2,
                        precursor=prec, fused=True)
    tsrv = DBSearchServer(db, clock=lambda: tclock[0], oms=CFG,
                          fused_e2e=e2e,
                          encoder=encoder_from_numpy(idh, lvh, CPU)
                          if e2e else None, **kw)
    want = _drive(jsrv, queries, qprec, jclock)
    got = _drive(tsrv, queries, qprec, tclock)
    assert sorted(got) == sorted(want) == list(range(len(queries)))
    for rid, w in want.items():
        g = got[rid]
        np.testing.assert_array_equal(g.indices, np.asarray(w.indices))
        np.testing.assert_array_equal(g.scores, np.asarray(w.scores))
        assert (g.is_target, g.accept, g.match, g.has_candidate) == (
            w.is_target, w.accept, w.match, w.has_candidate)
    assert not got[len(queries) - 1].has_candidate
    js, ts = jsrv.summary(), tsrv.summary()
    for key in ("count", "batches", "buckets", "oms"):
        assert ts[key] == js[key], key
    # one flush of everything == the direct route, in submit order
    srv = DBSearchServer(db, k=3, fdr=0.5, max_batch_size=32,
                         flush_timeout_s=0.0, oms=CFG)
    q_hv = np.asarray(jencode(jnp.asarray(q_lev), jnp.asarray(idh),
                              jnp.asarray(lvh)))
    for q, p in zip(q_hv, qprec):
        srv.submit(q, precursor=float(p))
    done = srv.run_until_drained()
    direct = oms_search_with_fdr(db, _t(q_hv), qprec, k=3, fdr=0.5, cfg=CFG)
    assert [r.rid for r in done] == list(range(len(qprec)))
    for i, r in enumerate(done):
        np.testing.assert_array_equal(r.result.indices, direct.indices[i])
        np.testing.assert_array_equal(r.result.scores, direct.scores[i])
        assert (r.result.accept, r.result.match, r.result.has_candidate) == (
            bool(direct.accept[i]), int(direct.match[i]),
            bool(direct.valid[i]))


def test_oms_submit_without_precursor_raises():
    prec = np.linspace(400, 1600, 20).astype(np.float32)
    db = shard_database(_t(np.ones((20, 32), np.int8)), precursor=prec)
    srv = DBSearchServer(db, k=2, max_batch_size=4, oms=OMSConfig())
    with pytest.raises(ValueError, match="precursor"):
        srv.submit(np.ones(32, np.int8))


def test_registry_builds_an_oms_bank():
    rng = np.random.default_rng(1)
    refs = _t(rng.choice([-1, 1], (30, 64)).astype(np.int8))
    prec = rng.uniform(400, 1600, 30).astype(np.float32)
    reg = BankRegistry()
    reg.register("t", refs, decoys=-refs, precursor=prec,
                 decoy_precursor=prec[::-1].copy())
    db = reg.get("t")
    want = oms.build_precursor_index(prec, prec[::-1])
    _assert_index_equal(db.oms, want)
    assert torch.equal(db.perm, torch.from_numpy(want.perm))


@pytest.mark.parametrize("flag", ["--fused", "--fused-e2e"])
def test_launcher_serves_oms_on_cpu(flag, capsys):
    s = serve_db.main(["--reduced", "--oms", "--device", "cpu", "--queries",
                       "24", flag])
    out = capsys.readouterr().out
    assert s["count"] == s["total"] == 24
    assert s["correct"] <= s["identified"] <= s["total"]
    assert "oms: window (-20, +200), candidate fraction" in out
    assert 0.0 < s["oms"]["candidate_fraction"] < 1.0
    assert s["oms"]["batches"] == s["batches"]
    assert set(s["launches"].values()) == {0}
