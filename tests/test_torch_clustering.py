"""Clustering core of the PyTorch port against the JAX package, on the CPU:
the ``hamming_pop`` kernel's plain version, the pairwise and cross
distances (bit-packed and int8 routes), complete linkage and both
quality ratios.

The same numpy inputs, made from a seed, go through ``repro`` and
``repro_torch``. The reference's ``hamming_pop_pallas`` runs in Pallas
interpret mode, as the JAX package's own tests run it on the CPU.
Tolerance: exact everywhere (integer similarities, distances that are
integers or halves, labels, merge counts, float32 ratios).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.hd import clustering as jclust
from repro.core.hd.similarity import bitpack_bipolar as jbitpack
from repro.kernels.hamming_pop import hamming_pop_pallas
from repro.kernels.hamming_pop.ref import hamming_pop_ref
from repro_torch.core.hd import clustering as tclust
from repro_torch.core.hd.similarity import bitpack_bipolar
from repro_torch.kernels.hamming_pop import hamming_pop, hamming_pop_plain

# small tensors: one intra-op thread leaves the cores to the other test
# workers
torch.set_num_threads(1)


def _words(rng, rows, w, fill=None):
    """(rows, w) uint32 words: random, or all ``fill``."""
    if fill is not None:
        return np.full((rows, w), fill, np.uint32)
    return rng.integers(0, 2 ** 32, size=(rows, w), dtype=np.uint64).astype(
        np.uint32)


def _t(words):
    """uint32 words -> the port's int32 bit-view tensor."""
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32).copy())


# (Q, R, W, query fill, bank fill): ragged Q, R and W against the
# reference's 128 x 128 x 32 padding, W = 1, 3 and 64, all-zero and
# all-ones words
HAMMING_SHAPES = [
    (1, 1, 1, None, None),
    (5, 7, 3, None, None),
    (130, 129, 64, None, None),
    (33, 200, 2, None, None),
    (64, 64, 33, None, None),
    (3, 140, 5, 0, 0xFFFFFFFF),      # all-zero queries, all-ones bank
    (9, 9, 64, 0xFFFFFFFF, None),
]


@pytest.mark.parametrize("Q,R,W,qfill,rfill", HAMMING_SHAPES)
def test_hamming_pop_plain_matches_reference(Q, R, W, qfill, rfill):
    rng = np.random.default_rng(Q * 1000 + R + W)
    q, r = _words(rng, Q, W, qfill), _words(rng, R, W, rfill)
    dim = 32 * W
    want = np.asarray(hamming_pop_pallas(jnp.asarray(q), jnp.asarray(r),
                                         dim=dim))
    np.testing.assert_array_equal(
        want, np.asarray(hamming_pop_ref(jnp.asarray(q), jnp.asarray(r),
                                         dim)))
    before = hamming_pop.launches
    got = hamming_pop_plain(_t(q), _t(r), dim=dim)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # CPU tensors take the plain version through the wrapper, unlaunched
    np.testing.assert_array_equal(hamming_pop(_t(q), _t(r), dim=dim).numpy(),
                                  want)
    assert hamming_pop.launches == before


@pytest.mark.parametrize("q,r,match", [
    (torch.zeros((2, 3), dtype=torch.int32),
     torch.zeros((2, 4), dtype=torch.int32), "shapes"),
    (torch.zeros((2, 3), dtype=torch.int32),
     torch.zeros((2, 3), dtype=torch.int8), "int32"),
    (torch.zeros(3, dtype=torch.int32),
     torch.zeros((2, 3), dtype=torch.int32), "shapes"),
])
def test_hamming_pop_rejects_bad_operands(q, r, match):
    with pytest.raises(ValueError, match=match):
        hamming_pop(q, r, dim=96)


def _hvs(seed, n, d, dup=True):
    """Bipolar (n, d) int8 rows; with ``dup`` some rows repeat, so
    distances tie."""
    rng = np.random.default_rng(seed)
    hv = rng.choice([-1, 1], size=(n, d)).astype(np.int8)
    if dup:
        hv[n // 2:] = hv[rng.integers(0, n // 2, n - n // 2)]
        hv[-1, :3] = -hv[-1, :3]
    return hv


@pytest.mark.parametrize("kind", ["pairwise", "cross"])
@pytest.mark.parametrize("route,d", [("packed", 96), ("packed", 2048),
                                     ("int8", 96), ("int8", 100)])
def test_distances_match_reference(kind, route, d):
    a, b = _hvs(d, 40, d), _hvs(d + 1, 23, d)
    if route == "packed":
        ja, jb = jbitpack(jnp.asarray(a)), jbitpack(jnp.asarray(b))
        ta, tb = bitpack_bipolar(torch.from_numpy(a)), bitpack_bipolar(
            torch.from_numpy(b))
    else:
        ja, jb = jnp.asarray(a), jnp.asarray(b)
        ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    if kind == "pairwise":
        want = jclust.pairwise_distances(ja, dim=d)
        got = tclust.pairwise_distances(ta, dim=d)
    else:
        want = jclust.cross_distances(ja, jb, dim=d)
        got = tclust.cross_distances(ta, tb, dim=d)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _tie_heavy(seed, n, kind):
    """(n, n) float32 distances of few distinct values: small integers,
    their halves (symmetric), or asymmetric integers."""
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 6, (n, n)).astype(np.float32)
    if kind == "halves":
        d = (d + d.T) / 2
    elif kind == "symmetric":
        d = np.triu(d) + np.triu(d, 1).T
    np.fill_diagonal(d, 0)
    return d


@pytest.mark.parametrize("kind", ["symmetric", "halves", "asymmetric"])
@pytest.mark.parametrize("threshold", [0.0, 2.5, 1e6])
@pytest.mark.parametrize("n", [8, 23, 64])
def test_complete_linkage_matches_reference(n, threshold, kind):
    d = _tie_heavy(n * 10 + len(kind), n, kind)
    want = jclust.complete_linkage(jnp.asarray(d), threshold)
    got = tclust.complete_linkage(torch.from_numpy(d), threshold)
    assert got.labels.dtype == torch.int32
    np.testing.assert_array_equal(got.labels.numpy(),
                                  np.asarray(want.labels))
    assert got.num_merges == int(want.num_merges)
    assert got.num_clusters == int(want.num_clusters)


def test_complete_linkage_of_packed_hvs_matches_reference():
    hv = _hvs(5, 48, 256)
    want = jclust.complete_linkage(
        jclust.pairwise_distances(jbitpack(jnp.asarray(hv)), dim=256), 110.0)
    got = tclust.complete_linkage(
        tclust.pairwise_distances(bitpack_bipolar(torch.from_numpy(hv)),
                                  dim=256), 110.0)
    np.testing.assert_array_equal(got.labels.numpy(),
                                  np.asarray(want.labels))
    assert 0 < got.num_merges == int(want.num_merges) < 47


def test_min_argmin_argmax_take_the_first_index_on_ties():
    """complete_linkage and incorrect_clustering_ratio rely on torch's
    documented first-index rule, as the reference relies on XLA's."""
    x = torch.tensor([3.0, 1.0, 2.0, 1.0, 1.0])
    assert int(torch.argmin(x)) == 1
    m = torch.tensor([[2.0, 0.5, 0.5, 7.0], [4.0, 4.0, 4.0, 4.0]])
    vals, idx = m.min(dim=1)
    assert idx.tolist() == [1, 0] and vals.tolist() == [0.5, 4.0]
    v = torch.tensor([[0, 3, 1, 3], [2, 2, 2, 2]], dtype=torch.int32)
    assert torch.argmax(v, dim=-1).tolist() == [1, 0]
    big = torch.full((300,), 5.0)
    big[[17, 200, 299]] = 1.0
    assert int(torch.argmin(big)) == 17


@pytest.mark.parametrize("dist,threshold,match", [
    (np.zeros((3, 4), np.float32), 1.0, "square"),
    (np.zeros((3, 3), np.float32), float("inf"), "float32 max"),
])
def test_complete_linkage_rejects_bad_input(dist, threshold, match):
    with pytest.raises(ValueError, match=match):
        tclust.complete_linkage(torch.from_numpy(dist), threshold)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quality_ratios_match_reference(seed):
    rng = np.random.default_rng(seed)
    n = 60
    truth = rng.integers(0, 12, n)
    labels = rng.integers(0, 25, n)           # singletons and ties
    labels[:4] = 59                           # a label at the top of [0, n)
    jl, jt = jnp.asarray(labels, jnp.int32), jnp.asarray(truth, jnp.int32)
    tl, tt = torch.from_numpy(labels), torch.from_numpy(truth)
    for got, want in [
            (tclust.clustered_spectra_ratio(tl),
             jclust.clustered_spectra_ratio(jl)),
            (tclust.incorrect_clustering_ratio(tl, tt),
             jclust.incorrect_clustering_ratio(jl, jt))]:
        assert got.dtype == torch.float32
        assert got.item() == float(want)


def _pm1_slots(words: np.ndarray, staged: int) -> np.ndarray:
    """The tensor-core kernel's expansion (``csrc/hamming_pop.cu``): each
    of ``staged`` words (zero past the real ones) to 32 int8 values, k-slot
    s (4 bytes) holding bits s, s + 8, s + 16, s + 24 as +-1."""
    rows, w = words.shape
    padded = np.zeros((rows, staged), np.uint32)
    padded[:, :w] = words
    bits = (padded[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
    order = np.array([s + 8 * b for s in range(8) for b in range(4)])
    return (2 * bits[:, :, order].astype(np.int64) - 1).reshape(rows, -1)


@pytest.mark.parametrize("Q,R,W,short", [(5, 7, 1, 0), (9, 33, 3, 13),
                                         (17, 20, 65, 13), (3, 4, 8, 31),
                                         (16, 8, 130, 5)])
def test_plus_minus_one_dot_identity_matches_reference(Q, R, W, short):
    """dim - (32 x staged - <+-1 q, +-1 r>) / 2 equals the reference's
    ``hamming_pop_ref`` with dim < 32 W and random padding bits, whatever
    the words staged past W (the kernel stages whole 8-word chunks)."""
    rng = np.random.default_rng(Q * 100 + R + W + short)
    q, r = _words(rng, Q, W), _words(rng, R, W)
    dim = 32 * W - short
    staged = -(-W // 8) * 8
    dot = _pm1_slots(q, staged) @ _pm1_slots(r, staged).T
    got = dim - (32 * staged - dot) // 2
    want = np.asarray(hamming_pop_ref(jnp.asarray(q), jnp.asarray(r), dim))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        hamming_pop(_t(q), _t(r), dim=dim).numpy(), want)
