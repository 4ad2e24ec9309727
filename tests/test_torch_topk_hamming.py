"""The port's ``topk_hamming`` (CPU path) against the JAX package's
``topk_hamming_pallas`` (interpret mode on the CPU) and its ``ref.py``.

Tolerance: exact (indices, scores, tie order, sentinel-masked slots).
The CUDA kernel itself is held against the plain version on the card by
``tests/test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels.topk_hamming import topk_hamming_pallas
from repro.kernels.topk_hamming.ref import topk_hamming_ref as jref
from repro_torch.kernels.topk_hamming import topk_hamming, topk_hamming_plain
from repro_torch.kernels.topk_hamming.ops import BLOCK_Q_CHOICES, pick_block_q

# small tensors: one intra-op thread leaves the cores to the other test
# workers
torch.set_num_threads(1)


def _operands(rng, q, r, d, packed, dup=False):
    if packed:
        rows = rng.integers(0, 2**32, (r, d // 32), dtype=np.uint32)
        qs = rng.integers(0, 2**32, (q, d // 32), dtype=np.uint32)
    else:
        rows = rng.choice([-1, 1], size=(r, d)).astype(np.int8)
        qs = rng.choice([-1, 1], size=(q, d)).astype(np.int8)
    if dup:
        rows = np.concatenate([rows, rows, rows])
        qs[: min(q, r)] = rows[: min(q, r)]
    return qs, rows


def _port(a):
    a = np.asarray(a)
    return torch.from_numpy((a.view(np.int32) if a.dtype == np.uint32
                             else a).copy())


def _check(q, rows, d, k, nv):
    want_i, want_v = topk_hamming_pallas(jnp.asarray(q), jnp.asarray(rows),
                                         dim=d, k=k, num_valid=nv)
    oracle = jref(jnp.asarray(q), jnp.asarray(rows), d, k, num_valid=nv)
    got = topk_hamming(_port(q), _port(rows), dim=d, k=k, num_valid=nv)
    for want in ((want_i, want_v), oracle):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


# (Q, R, D, packed, k, num_valid, duplicate rows)
CASES = [
    (3, 130, 64, True, 4, None, False),      # ragged R (not a tile multiple)
    (5, 200, 32, True, 6, 150, False),       # num_valid < R
    (4, 60, 64, True, 9, 5, False),          # k > num_valid: masked slots
    (2, 23, 32, True, 23, None, False),      # k = R
    (6, 40, 64, True, 8, None, True),        # duplicate rows: ties
    (4, 90, 40, False, 5, None, False),      # int8, D % 32 != 0
    (3, 51, 100, False, 51, 31, True),       # int8, k = R, ties, masked
]


@pytest.mark.parametrize("Q,R,D,packed,k,nv,dup", CASES)
def test_topk_hamming_matches_reference(Q, R, D, packed, k, nv, dup):
    rng = np.random.default_rng(Q * 100 + R + D)
    q, rows = _operands(rng, Q, R // 3 if dup else R, D, packed, dup)
    _check(q, rows, D, k, nv)


@settings(max_examples=8, deadline=None)
@given(st.integers(1, 12), st.integers(1, 300), st.sampled_from([32, 96]),
       st.integers(1, 8), st.integers(0, 320))
def test_topk_hamming_random_shapes(q, r, d, k, nv):
    k = min(k, r)
    rng = np.random.default_rng(q * 7919 + r * 131 + d + k)
    qs, rows = _operands(rng, q, r, d, True)
    _check(qs, rows, d, k, nv)


def test_plain_is_the_cpu_path_and_counts_no_launch():
    rng = np.random.default_rng(1)
    q, rows = _operands(rng, 3, 40, 64, True)
    before = topk_hamming.launches
    a = topk_hamming(_port(q), _port(rows), dim=64, k=3)
    b = topk_hamming_plain(_port(q), _port(rows), dim=64, k=3)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert topk_hamming.launches == before


H100_SMEM = 232448  # bytes of shared memory a block may opt into


@pytest.mark.parametrize("Q,want", [(1, 8), (8, 8), (9, 16), (16, 16),
                                    (17, 32), (32, 32), (100, 32)])
def test_block_q_is_the_smallest_that_covers_the_batch(Q, want):
    assert pick_block_q(Q, 256, 4, 0, H100_SMEM) == want


def test_block_q_shrinks_to_fit_shared_memory():
    # 32 queries of 2048 words do not fit; 16 do
    assert pick_block_q(32, 2048, 4, 0, H100_SMEM) == 16
    assert pick_block_q(32, 256, 4, 0, 4 * 128 * 36 + 4 * 8 * 264) == 8
    with pytest.raises(ValueError):
        pick_block_q(8, 256, 4, 0, 4 * 128 * 36)
    assert BLOCK_Q_CHOICES == (8, 16, 32)


@pytest.mark.parametrize("bad", ["k0", "kR", "dtype", "width"])
def test_wrapper_rejects_bad_operands(bad):
    q = torch.zeros((2, 2), dtype=torch.int32)
    r = torch.zeros((5, 2), dtype=torch.int32)
    k = {"k0": 0, "kR": 6}.get(bad, 2)
    if bad == "dtype":
        q = q.to(torch.int64)
        r = r.to(torch.int64)
    if bad == "width":
        r = torch.zeros((5, 3), dtype=torch.int32)
    with pytest.raises(ValueError):
        topk_hamming(q, r, dim=64, k=k)
