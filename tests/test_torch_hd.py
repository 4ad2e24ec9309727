"""HD core of the PyTorch port against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through ``repro.core.hd``
and ``repro_torch.core.hd``. Tolerance: exact everywhere (integer HVs,
packed words as int32 bit-views, indices, scores, tie order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.hd import encoding as jenc
from repro.core.hd import packing as jpack
from repro.core.hd import similarity as jsim
from repro_torch.core.hd import encoding as tenc
from repro_torch.core.hd import packing as tpack
from repro_torch.core.hd import similarity as tsim
from repro_torch.spectra import SyntheticMSConfig, generate_dataset
from repro_torch.spectra.synthetic import identity_precursor

# small tensors: one intra-op thread leaves the cores to the other test
# workers
torch.set_num_threads(1)

CPU = "cpu"


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(port, ref):
    np.testing.assert_array_equal(port.cpu().numpy(), np.asarray(ref))


def _unpack(words, dim):
    """int32 words -> bipolar int8, bit j of word w = dim 32w + j."""
    bits = np.unpackbits(np.asarray(words).view(np.uint8), axis=-1,
                         bitorder="little")
    return np.where(bits > 0, 1, -1).astype(np.int8)[..., :dim]


def _ref_codebooks(f, d, m, seed=0):
    idh, lvh = jenc.make_codebooks(jenc.HDEncoderConfig(
        dim=d, num_features=f, num_levels=m, seed=seed))
    return np.asarray(idh), np.asarray(lvh)


@pytest.mark.parametrize("m", [2, 5, 16, 32])
def test_quantize_levels(m):
    rng = np.random.default_rng(m)
    v = rng.random((9, 70)).astype(np.float32)
    v[:, :10] = 0.0
    v[:, 10] = 1e-6
    v[:, 11] = np.nextafter(np.float32(1e-6), np.float32(1))
    v[:, 12] = 1.0
    v[:, 13] = 1.5
    v[:, 14] = -0.3
    v[:, 15] = (np.arange(9) % m / (m - 1)).astype(np.float32)  # on a step
    _eq(tenc.quantize_levels(_t(v), m), jenc.quantize_levels(jnp.asarray(v),
                                                             m))


@pytest.mark.parametrize("b,f,d,m", [(5, 40, 64, 4), (16, 256, 96, 16),
                                     (3, 7, 33, 2)])
def test_encode_levels_batch(b, f, d, m):
    rng = np.random.default_rng(b * f + d)
    idh, lvh = _ref_codebooks(f, d, m)
    levels = rng.integers(0, m, size=(b, f)).astype(np.int32)
    levels[0] = 0                       # no present peak: every sign -> -1
    want = jenc.encode_levels_batch(jnp.asarray(levels), jnp.asarray(idh),
                                    jnp.asarray(lvh))
    got = tenc.encode_levels_batch(_t(levels), _t(idh), _t(lvh))
    _eq(got, want)
    assert (got[0] == -1).all()


@pytest.mark.parametrize("chunk_elems", [1, 500, 1 << 26])
def test_encode_batch_chunked(chunk_elems):
    rng = np.random.default_rng(3)
    b, f, d, m = 13, 200, 128, 16
    idh, lvh = _ref_codebooks(f, d, m, seed=5)
    feats = rng.random((b, f)).astype(np.float32)
    feats[rng.random((b, f)) < 0.8] = 0.0
    want = jenc.encode_batch(jnp.asarray(feats), jnp.asarray(idh),
                             jnp.asarray(lvh))
    got = tenc.encode_batch(_t(feats), _t(idh), _t(lvh),
                            chunk_elems=chunk_elems)
    _eq(got, want)


def test_bitpack_bipolar_bit31_and_roundtrip():
    rng = np.random.default_rng(4)
    hv = rng.choice([-1, 1], size=(6, 3, 96)).astype(np.int8)
    hv[..., 31] = 1                      # bit 31 of word 0 set everywhere
    hv[0, 0, :] = 1                      # all-ones words: 0xFFFFFFFF
    want = np.asarray(jsim.bitpack_bipolar(jnp.asarray(hv))).view(np.int32)
    got = tsim.bitpack_bipolar(_t(hv))
    _eq(got, want)
    assert (got[..., 0] < 0).all()
    np.testing.assert_array_equal(_unpack(got.numpy(), 96), hv)


def test_popcount32_matches_numpy():
    rng = np.random.default_rng(5)
    x = rng.integers(-2**31, 2**31, size=4000, dtype=np.int64).astype(
        np.int32)
    x[:4] = [0, -1, -2**31, 2**31 - 1]
    want = np.unpackbits(x.view(np.uint8)).reshape(-1, 32).sum(1)
    _eq(tsim.popcount32(_t(x)), want)


@pytest.mark.parametrize("q,r,d", [(4, 50, 32), (7, 300, 256)])
def test_hamming_similarity_packed(q, r, d):
    rng = np.random.default_rng(q + r)
    qw = rng.integers(0, 2**32, (q, d // 32), dtype=np.uint32)
    rw = rng.integers(0, 2**32, (r, d // 32), dtype=np.uint32)
    want = jsim.hamming_similarity_packed(jnp.asarray(qw), jnp.asarray(rw), d)
    got = tsim.hamming_similarity_packed(_t(qw.view(np.int32)),
                                         _t(rw.view(np.int32)), d)
    _eq(got, want)


@pytest.mark.parametrize("k", [1, 4, 12])
def test_topk_search_duplicate_rows_tie_order(k):
    rng = np.random.default_rng(k)
    base = rng.choice([-1, 1], size=(5, 64)).astype(np.int8)
    refs = np.concatenate([base, base, base[::-1], base])
    q = np.concatenate([base[:3], -base[3:4]])
    wi, wv = jsim.topk_search(jnp.asarray(q), jnp.asarray(refs), k)
    gi, gv = tsim.topk_search(_t(q), _t(refs), k)
    _eq(gi, wi)
    _eq(gv, wv)
    pq = tsim.bitpack_bipolar(_t(q))
    pr = tsim.bitpack_bipolar(_t(refs))
    pi, pv = tsim.topk_search_packed(pq, pr, 64, k)
    _eq(pi, wi)
    _eq(pv, wv)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_pack_dimensions(n):
    rng = np.random.default_rng(n)
    hv = rng.choice([-1, 1], size=(4, 24)).astype(np.int8)
    want = jpack.pack_dimensions(jnp.asarray(hv), n)
    got = tpack.pack_dimensions(_t(hv), n)
    _eq(got, want)
    _eq(tpack.unpack_dimensions(got, n, 24),
        jpack.unpack_dimensions(want, n, 24))


@pytest.mark.parametrize("d,m", [(64, 2), (256, 16), (100, 7)])
def test_make_codebooks_invariants(d, m):
    cfg = tenc.HDEncoderConfig(dim=d, num_features=30, num_levels=m, seed=3)
    idh, lvh = tenc.make_codebooks(cfg, device=CPU)
    assert idh.shape == (30, d) and lvh.shape == (m, d)
    assert idh.dtype == lvh.dtype == torch.int8
    assert set(idh.unique().tolist()) == {-1, 1}
    assert set(lvh.unique().tolist()) <= {-1, 1}
    flips = (lvh != lvh[0]).sum(dim=1).tolist()
    assert flips == [k * (d // 2) // (m - 1) for k in range(m)]
    assert flips[-1] == d // 2
    again = tenc.make_codebooks(cfg, device=CPU)
    assert torch.equal(again[0], idh) and torch.equal(again[1], lvh)


def test_generate_dataset_invariants():
    cfg = SyntheticMSConfig(num_identities=12, spectra_per_identity=3,
                            num_bins=128, modification_rate=0.5,
                            modification_mass_range=(60.0, 90.0))
    ds = generate_dataset(cfg, device=CPU)
    assert ds.spectra.shape == (36, 128)
    assert ds.spectra.min() >= 0 and ds.spectra.max() <= 1
    assert torch.allclose(ds.spectra.amax(dim=1), torch.ones(36))
    assert ds.identity.tolist() == [i for i in range(12) for _ in range(3)]
    # the golden-ratio precursor of each identity, as the reference defines
    lo, hi = cfg.precursor_range
    ids = np.arange(12, dtype=np.float32)
    golden = (lo + (hi - lo) * ((ids * np.float32(0.6180339887498949))
                                % np.float32(1.0))).astype(np.float32)
    _eq(identity_precursor(torch.arange(12), cfg), golden)
    off = ds.precursor - identity_precursor(ds.identity, cfg)
    plain = ~ds.is_modified
    assert off[plain].abs().max() < 0.2
    assert ((off[~plain] > 59.0) & (off[~plain] < 90.2)).all()
