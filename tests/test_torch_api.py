"""The port's public names against the JAX package's, on the CPU.

* ``repro_torch.core``, ``.core.hd``, ``.core.imc``, ``.spectra``,
  ``.serve`` and ``.train`` export every name of the matching reference
  ``__all__``;
* the query-HV cache's ``__contains__`` / ``current_bytes`` /
  ``get_or_encode`` and the bank registry's ``__len__`` / ``tenants``
  behave as the reference's (the cases of ``tests/test_serve_cache.py``);
* ``sharded_topk_search`` gives the reference's indices and scores,
  exactly and in the same tie order, on its emulated-shard, single-bank
  and fused routes (the cases of ``tests/test_serve.py`` and
  ``tests/test_topk_fused.py``), and raises ``TypeError`` for a ``mesh``
  that is not one;
* the HD core's leftover names (``hamming_similarity``, ``top1_search``,
  ``encode_batch_reference``, ``packed_levels``) and
  ``MSDataset.num_spectra`` equal the reference's on the same inputs.

Tolerance: exact everywhere (integers and int8 HVs).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.hd.encoding as ref_encoding
import repro.core.hd.packing as ref_packing
import repro.core.hd.similarity as ref_similarity
import repro.serve as ref_serve
from repro.dist import sharding
from repro_torch.core.hd.encoding import encode_batch, encode_batch_reference
from repro_torch.core.hd.packing import packed_levels
from repro_torch.core.hd.similarity import hamming_similarity, top1_search
from repro_torch.serve import BankRegistry, QueryHVCache, sharded_topk_search
from repro_torch.spectra import SyntheticMSConfig, generate_dataset

# small tensors: one intra-op thread leaves the cores to the other test
# workers
torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _no_global_mesh():
    sharding.set_mesh(None)


@pytest.mark.parametrize("module", ["core", "core.hd", "core.imc", "spectra",
                                    "serve", "train"])
def test_port_exports_every_reference_name(module):
    ref = importlib.import_module(f"repro.{module}")
    port = importlib.import_module(f"repro_torch.{module}")
    missing = set(ref.__all__) - set(port.__all__)
    assert not missing, missing
    for name in ref.__all__:
        assert hasattr(port, name), name


# --------------------------------------------------------------------------
# QueryHVCache and BankRegistry (tests/test_serve_cache.py:44-101)
# --------------------------------------------------------------------------

def _row(i, n=16):
    return np.full(n, i, dtype=np.int8)


def test_query_cache_lru_eviction_order():
    # each int8 row is 16 bytes; budget fits exactly two entries
    c = QueryHVCache(capacity_bytes=32)
    ka = c.content_key(_row(1))
    c.insert(ka, _row(1))
    kb = c.content_key(_row(2))
    c.insert(kb, _row(2))
    assert ka in c and kb in c and c.current_bytes == 32
    # touch A so B becomes the LRU entry, then insert C: B must go
    assert c.lookup(ka) is not None
    kc = c.content_key(_row(3))
    c.insert(kc, _row(3))
    assert ka in c and kc in c and kb not in c
    assert c.evictions == 1 and len(c) == 2


def test_query_cache_membership_touches_nothing():
    c = QueryHVCache(capacity_bytes=32)
    ka = c.content_key(_row(1))
    c.insert(ka, _row(1))
    kb = c.content_key(_row(2))
    c.insert(kb, _row(2))
    # `in` must not refresh A: B stays the most recent, so A is evicted
    assert ka in c and c.hits == 0 and c.misses == 0
    c.insert(c.content_key(_row(3)), _row(3))
    assert ka not in c and kb in c


def test_query_cache_byte_budget_enforced():
    c = QueryHVCache(capacity_bytes=100)
    for i in range(20):
        c.insert(c.content_key(_row(i)), _row(i))  # 16 bytes each
        assert c.current_bytes <= 100
    assert len(c) == 6 and c.current_bytes == 96  # floor(100 / 16)
    assert c.evictions == 14


def test_query_cache_oversized_value_rejected():
    c = QueryHVCache(capacity_bytes=8)
    key = c.content_key(_row(1))
    assert not c.insert(key, _row(1))   # 16 bytes > 8-byte budget
    assert key not in c and len(c) == 0 and c.current_bytes == 0


def test_query_cache_counters_and_get_or_encode():
    c = QueryHVCache(capacity_bytes=1 << 10)
    raw = _row(7)
    calls = []

    def encode(x):
        calls.append(1)
        return x.astype(np.int32) * 2

    v1, hit1 = c.get_or_encode(raw, encode)
    v2, hit2 = c.get_or_encode(raw, encode)
    assert not hit1 and hit2 and len(calls) == 1
    np.testing.assert_array_equal(v1, v2)
    assert c.hits == 1 and c.misses == 1 and c.hit_rate == 0.5
    # the same bytes under a different encoding variant is a distinct entry
    _, hit3 = c.get_or_encode(raw, encode, variant="other")
    assert not hit3 and len(calls) == 2


def test_query_cache_get_or_encode_matches_the_reference():
    """The same trace of get_or_encode calls leaves both caches with the
    same rows, hits, misses, evictions and bytes."""
    port, ref = QueryHVCache(capacity_bytes=96), ref_serve.QueryHVCache(
        capacity_bytes=96)
    rng = np.random.default_rng(0)
    trace = rng.integers(0, 9, size=60)

    def encode(x):
        return np.repeat(x.astype(np.int16), 2)

    for i in trace:
        got, hit = port.get_or_encode(_row(int(i)), encode, variant="v")
        want, ref_hit = ref.get_or_encode(_row(int(i)), encode, variant="v")
        np.testing.assert_array_equal(got, want)
        assert hit == ref_hit
        assert port.current_bytes == ref.current_bytes
    assert port.summary() == ref.summary()


def test_query_cache_content_key_distinguishes_dtype_and_shape():
    a = np.zeros(8, np.int8)
    assert QueryHVCache.content_key(a) != QueryHVCache.content_key(
        a.astype(np.int16)[:4])
    assert QueryHVCache.content_key(a) != QueryHVCache.content_key(
        a.reshape(2, 4))
    assert QueryHVCache.content_key(a) == ref_serve.QueryHVCache.content_key(a)


def test_bank_registry_len_and_tenants():
    rng = np.random.default_rng(1)
    refs = torch.from_numpy(rng.choice([-1, 1], size=(8, 64)).astype(np.int8))
    port, ref = BankRegistry(), ref_serve.BankRegistry()
    assert len(port) == len(ref) == 0 and port.tenants() == ref.tenants() == []
    for name in ("b", "a", "c", "a"):
        port.register(name, refs)
        ref.register(name, jnp.asarray(refs.numpy()))
    assert len(port) == len(ref) == 3
    assert port.tenants() == ref.tenants() == ["b", "a", "c"]
    port.get("b")  # building a bank adds no tenant
    assert len(port) == 3


# --------------------------------------------------------------------------
# sharded_topk_search (tests/test_serve.py:57-116, test_topk_fused.py:170)
# --------------------------------------------------------------------------

def _bipolar(rng, shape):
    return rng.choice([-1, 1], size=shape).astype(np.int8)


def _same(got, want):
    gi, gv = got
    wi, wv = want
    np.testing.assert_array_equal(gi.numpy().astype(np.int64),
                                  np.asarray(wi).astype(np.int64))
    np.testing.assert_array_equal(gv.numpy().astype(np.int64),
                                  np.asarray(wv).astype(np.int64))


def _both(queries, refs, k, **kw):
    got = sharded_topk_search(torch.from_numpy(queries),
                              torch.from_numpy(refs), k, **kw)
    want = ref_serve.sharded_topk_search(jnp.asarray(queries),
                                         jnp.asarray(refs), k, **kw)
    return got, want


@pytest.mark.parametrize("num_shards", [2, 4, 8])
@pytest.mark.parametrize("num_refs,dim", [(61, 32), (64, 64), (37, 48)])
@pytest.mark.parametrize("pack", ["auto", False])
def test_sharded_topk_matches_the_reference(num_shards, num_refs, dim, pack):
    rng = np.random.default_rng(num_refs * 100 + dim)
    refs = _bipolar(rng, (num_refs, dim))
    queries = _bipolar(rng, (16, dim))
    got, want = _both(queries, refs, 5, num_shards=num_shards, pack=pack)
    _same(got, want)
    # and the reference's oracle, the unsharded top-k
    _same(got, ref_similarity.topk_search(jnp.asarray(queries),
                                          jnp.asarray(refs), 5))


@pytest.mark.parametrize("num_shards", [None, 1, 2, 4, 8])
@pytest.mark.parametrize("num_refs,dim", [(61, 32), (64, 64), (37, 48)])
def test_fused_sharded_topk_matches_the_reference(num_shards, num_refs, dim):
    """The fused route (on CPU tensors: the kernel's plain version)
    against the reference's unfused route; the reference's own tests hold
    its fused route equal to that one."""
    rng = np.random.default_rng(num_refs * 100 + dim)
    refs = _bipolar(rng, (num_refs, dim))
    queries = _bipolar(rng, (16, dim))
    for pack in ("auto", False):
        got = sharded_topk_search(torch.from_numpy(queries),
                                  torch.from_numpy(refs), 5,
                                  num_shards=num_shards, pack=pack,
                                  fused=True)
        want = ref_serve.sharded_topk_search(
            jnp.asarray(queries), jnp.asarray(refs), 5,
            num_shards=num_shards, pack=pack)
        _same(got, want)


def test_fused_sharded_topk_matches_the_reference_fused_route():
    """One case against the reference's fused route itself (its Pallas
    kernel in interpret mode)."""
    rng = np.random.default_rng(6148)
    refs = _bipolar(rng, (61, 32))
    queries = _bipolar(rng, (16, 32))
    got, want = _both(queries, refs, 5, num_shards=4, fused=True)
    _same(got, want)


def test_sharded_topk_duplicate_rows_tiebreak():
    rng = np.random.default_rng(7)
    base = _bipolar(rng, (12, 32))
    refs = np.concatenate([base, base, base])  # 36 rows, all tied
    queries = base[:6]
    for ns in (2, 4, 8):
        for fused in (False, True):
            got = sharded_topk_search(torch.from_numpy(queries),
                                      torch.from_numpy(refs), 4,
                                      num_shards=ns, fused=fused)
            want = ref_serve.sharded_topk_search(
                jnp.asarray(queries), jnp.asarray(refs), 4, num_shards=ns)
            _same(got, want)


def test_sharded_topk_no_shards_route():
    rng = np.random.default_rng(5)
    refs = _bipolar(rng, (20, 32))
    queries = _bipolar(rng, (4, 32))
    for kw in ({}, {"num_shards": 1}):
        got, want = _both(queries, refs, 3, **kw)
        _same(got, want)


def test_sharded_topk_k_exceeding_shard_rows_raises():
    rng = np.random.default_rng(13)
    refs = torch.from_numpy(_bipolar(rng, (8, 32)))
    queries = torch.from_numpy(_bipolar(rng, (2, 32)))
    with pytest.raises(ValueError, match="shard_rows"):
        sharded_topk_search(queries, refs, 5, num_shards=4)


def test_sharded_topk_with_a_mesh_raises():
    """``mesh=`` takes a DeviceMesh or a ``{name: size}`` mapping (the mesh
    routes themselves are held in ``tests/test_torch_mesh.py``); anything
    else is a TypeError."""
    refs = torch.ones((8, 32), dtype=torch.int8)
    with pytest.raises(TypeError, match="DeviceMesh"):
        sharded_topk_search(refs[:2], refs, 2, mesh=object())


# --------------------------------------------------------------------------
# the HD core's leftover names
# --------------------------------------------------------------------------

@pytest.mark.parametrize("Q,R,D", [(5, 9, 64), (1, 1, 3), (7, 30, 127)])
def test_hamming_similarity_and_top1_match_the_reference(Q, R, D):
    rng = np.random.default_rng(Q * R * D)
    q = _bipolar(rng, (Q, D))
    r = _bipolar(rng, (R, D))
    r[R // 2] = r[0]  # a tie: the first index wins in both
    q[0] = r[0]
    want = np.asarray(ref_similarity.hamming_similarity(jnp.asarray(q),
                                                        jnp.asarray(r)))
    got = hamming_similarity(torch.from_numpy(q), torch.from_numpy(r))
    np.testing.assert_array_equal(got.numpy(), want)
    wi, wv = ref_similarity.top1_search(jnp.asarray(q), jnp.asarray(r))
    gi, gv = top1_search(torch.from_numpy(q), torch.from_numpy(r))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


@pytest.mark.parametrize("B,F,D,m", [(6, 40, 128, 8), (3, 17, 61, 4)])
def test_encode_batch_reference_matches_the_reference(B, F, D, m):
    rng = np.random.default_rng(B * F)
    feats = rng.uniform(0, 1, (B, F)).astype(np.float32)
    feats[feats < 0.5] = 0.0
    idh = _bipolar(rng, (F, D))
    lvh = _bipolar(rng, (m, D))
    want = np.asarray(ref_encoding.encode_batch_reference(
        jnp.asarray(feats), jnp.asarray(idh), jnp.asarray(lvh)))
    args = (torch.from_numpy(feats), torch.from_numpy(idh),
            torch.from_numpy(lvh))
    np.testing.assert_array_equal(encode_batch_reference(*args).numpy(), want)
    np.testing.assert_array_equal(encode_batch(*args).numpy(), want)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_packed_levels_matches_the_reference(n):
    assert packed_levels(n) == ref_packing.packed_levels(n) == 2 * n + 1


def test_dataset_num_spectra():
    ds = generate_dataset(SyntheticMSConfig(num_identities=5,
                                            spectra_per_identity=3,
                                            num_bins=32), device="cpu")
    assert ds.num_spectra == 15 == ds.spectra.shape[0]
