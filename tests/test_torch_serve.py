"""Exact DB-search serving of the PyTorch port against the JAX package,
on the CPU: banks, search routes over emulated shards, FDR routing, the
flush-sync server, and the launcher.

Banks and codebooks are the reference's own arrays carried across with
``repro_torch.convert``. The reference runs its emulated-shard routes.
Tolerance: exact (packed words, indices, scores, tie order, accept and
match masks, cache counters).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.hd.encoding import HDEncoderConfig, make_codebooks
from repro.core.hd.encoding import encode_levels_batch as jencode
from repro.serve import DBSearchServer as JServer
from repro.serve import QueryEncoder as JEncoder
from repro.serve import search_database_encoded as jsearch_encoded
from repro.serve import search_database_levels as jsearch_levels
from repro.serve import shard_database as jshard
from repro.serve.db_search import encode_queries as jencode_queries
from repro.serve.db_search import fdr_route as jfdr_route
from repro_torch.convert import bank_rows_from_numpy, encoder_from_numpy
from repro_torch.launch import serve_db
from repro_torch.serve import (
    BankRegistry,
    DBSearchServer,
    SearchExecutor,
    encode_queries,
    fdr_route,
    search_database_encoded,
    search_database_levels,
    shard_database,
)

# small tensors: one intra-op thread leaves the cores to the other test
# workers
torch.set_num_threads(1)

CPU = "cpu"
F, M = 48, 8


def _t(a):
    return torch.from_numpy(np.array(a))


def _library(seed, n_refs, n_dec, n_q, d):
    """Reference codebooks, bank HVs (targets + decoys) and query levels;
    half the queries are near-copies of bank rows so FDR accepts some."""
    rng = np.random.default_rng(seed)
    idh, lvh = (np.asarray(a) for a in make_codebooks(HDEncoderConfig(
        dim=d, num_features=F, num_levels=M, seed=seed)))
    lev = rng.integers(0, M, size=(n_refs + n_dec, F)).astype(np.int32)
    lev[rng.random(lev.shape) < 0.6] = 0
    hv = np.asarray(jencode(jnp.asarray(lev), jnp.asarray(idh),
                            jnp.asarray(lvh)))
    q_lev = rng.integers(0, M, size=(n_q, F)).astype(np.int32)
    q_lev[rng.random(q_lev.shape) < 0.6] = 0
    pick = rng.integers(n_dec, n_refs + n_dec, size=n_q // 2)
    q_lev[: n_q // 2] = lev[pick]
    q_lev[1] = q_lev[0]                        # a repeated query
    return idh, lvh, hv[n_dec:], hv[:n_dec], q_lev


def _assert_routed(got, want):
    for name in ("indices", "scores", "is_target", "accept", "match"):
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
@pytest.mark.parametrize("packed", [True, False])
def test_routes_match_reference(shards, packed):
    d = 64 if packed else 72
    idh, lvh, refs, decoys, q_lev = _library(shards + d, 230, 170, 12, d)
    k = 5
    jdb = jshard(jnp.asarray(refs), decoys=jnp.asarray(decoys),
                 emulate_shards=shards, pack="auto")
    jenc = JEncoder(id_hvs=jnp.asarray(idh), level_hvs=jnp.asarray(lvh))
    want_idx, want_val = jsearch_levels(jdb, jenc, jnp.asarray(q_lev), k)
    want = jfdr_route(jdb, want_idx, want_val, fdr=0.1)

    enc = encoder_from_numpy(idh, lvh, device=CPU)
    q_hv = jencode(jnp.asarray(q_lev), jnp.asarray(idh), jnp.asarray(lvh))
    q_enc = bank_rows_from_numpy(jencode_queries(jdb, q_hv), device=CPU)
    for fused in (False, True):
        db = shard_database(_t(refs), decoys=_t(decoys), emulate_shards=shards,
                            fused=fused)
        np.testing.assert_array_equal(
            db.data.numpy(), bank_rows_from_numpy(jdb.data, CPU).numpy())
        assert (db.shard_rows, db.num_rows, db.packed) == (
            jdb.shard_rows, jdb.num_rows, jdb.packed)
        assert torch.equal(encode_queries(db, _t(q_hv)), q_enc)
        routes = [search_database_encoded(db, q_enc, k)]
        for fused_e2e in (False, True):
            routes.append(search_database_levels(db, enc, _t(q_lev), k,
                                                 fused_e2e=fused_e2e))
        for idx, vals in routes:
            _assert_routed(fdr_route(db, idx, vals, fdr=0.1), want)
    je_idx, je_val = jsearch_encoded(jdb, jencode_queries(jdb, q_hv), k)
    np.testing.assert_array_equal(np.asarray(je_idx), np.asarray(want_idx))


def _drive(server, queries, clock):
    """One fixed submission schedule: bursts, timeouts, a forced drain."""
    done = []
    for i, q in enumerate(queries):
        server.submit(q)
        if i % 5 == 4:
            clock[0] += 0.02                   # past the flush timeout
        done.extend(server.step())
    done.extend(server.run_until_drained())
    return {r.rid: r.result for r in done}


@pytest.mark.parametrize("mode", ["encoded", "staged", "fused_e2e"])
def test_server_matches_reference(mode):
    d = 64
    idh, lvh, refs, decoys, q_lev = _library(7, 300, 300, 16, d)
    queries = np.concatenate([q_lev, q_lev[:5]])     # repeats hit the cache
    if mode == "encoded":
        queries = np.asarray(jencode(jnp.asarray(queries), jnp.asarray(idh),
                                     jnp.asarray(lvh)))
    kw = dict(k=3, fdr=0.2, max_batch_size=8, flush_timeout_s=0.01,
              cache_bytes=1 << 20, buckets=3)
    jclock, tclock = [0.0], [0.0]
    jenc = None if mode == "encoded" else JEncoder(
        id_hvs=jnp.asarray(idh), level_hvs=jnp.asarray(lvh))
    tenc = None if mode == "encoded" else encoder_from_numpy(idh, lvh, CPU)
    fused_e2e = mode == "fused_e2e"
    jsrv = JServer(jshard(jnp.asarray(refs), decoys=jnp.asarray(decoys),
                          emulate_shards=2),
                   clock=lambda: jclock[0], encoder=jenc,
                   fused_e2e=fused_e2e, **kw)
    tsrv = DBSearchServer(shard_database(_t(refs), decoys=_t(decoys),
                                         emulate_shards=2, fused=True),
                          clock=lambda: tclock[0], encoder=tenc,
                          fused_e2e=fused_e2e, **kw)
    want = _drive(jsrv, queries, jclock)
    got = _drive(tsrv, queries, tclock)
    assert sorted(got) == sorted(want) == list(range(len(queries)))
    assert any(r.accept for r in got.values())
    for rid, w in want.items():
        g = got[rid]
        np.testing.assert_array_equal(g.indices, np.asarray(w.indices))
        np.testing.assert_array_equal(g.scores, np.asarray(w.scores))
        assert (g.is_target, g.accept, g.match) == (w.is_target, w.accept,
                                                    w.match)
    js, ts = jsrv.summary(), tsrv.summary()
    for key in ("count", "batches", "buckets"):
        assert ts[key] == js[key], key
    if js["query_cache"] is not None:
        for key in ("hits", "misses", "entries", "bytes"):
            assert ts["query_cache"][key] == js["query_cache"][key], key
    for key in ("cache_hits", "cache_misses"):
        assert (ts["tenants"]["default"][key]
                == js["tenants"]["default"][key]), key


def test_registry_builds_lazily_and_evicts_cold_banks():
    rng = np.random.default_rng(0)
    reg = BankRegistry(max_banks=1)
    for t in range(3):
        reg.register(f"t{t}", _t(rng.choice([-1, 1], size=(20, 64)).astype(
            np.int8)), pin=t == 0)
    assert not reg.is_built("t0")
    reg.get("t1")
    reg.get("t0")
    reg.get("t2")       # over the limit: the LRU unpinned bank goes
    assert reg.is_built("t0")
    assert not reg.is_built("t1") and not reg.is_built("t2")
    s = reg.summary()
    assert (s["builds"], s["evictions"], s["pinned"]) == (3, 2, 1)


@pytest.mark.parametrize("flags", [["--fused"], ["--fused-e2e"],
                                   ["--no-pack", "--tenants", "2",
                                    "--max-banks", "1", "--buckets", "1"]])
def test_launcher_serves_on_cpu(flags, capsys):
    s = serve_db.main(["--reduced", "--device", "cpu", "--queries", "24",
                       *flags])
    out = capsys.readouterr().out
    assert s["count"] == s["total"] == 24 * (2 if "--tenants" in flags else 1)
    assert s["correct"] <= s["identified"] <= s["total"]
    assert "throughput:" in out and "kernel launches:" in out
    assert s["launches"] == {"topk_hamming": 0, "encode_search": 0,
                             "topk_hamming_banded": 0,
                             "encode_search_banded": 0}
    # no CUDA device: the split of the serving span names no device time
    assert "device search not timed" in out
    assert s["device_busy_s"] is None and 0 <= s["sleep_s"] <= s["span_s"]


@pytest.mark.parametrize("flags,width", [(["--fused"], 16),
                                         (["--fused-e2e"], 256)])
def test_launcher_hands_executor_cls_to_the_server(flags, width):
    """A ``SearchExecutor`` subclass sees every served batch, padded to
    its bucket: packed rows (D = 512, 16 words) on the fused route, raw levels (256 bins) on the fused-e2e route."""
    seen = []

    class Recording(SearchExecutor):
        def dispatch(self, reqs):
            h = super().dispatch(reqs)
            seen.append((h.n, tuple(h.batch.shape)))
            return h

    s = serve_db.main(["--reduced", "--device", "cpu", "--queries", "24",
                       *flags], executor_cls=Recording)
    assert len(seen) == s["batches"] and sum(n for n, _ in seen) == 24
    for n, (rows, cols) in seen:
        assert rows in s["buckets"] and rows >= n and cols == width
