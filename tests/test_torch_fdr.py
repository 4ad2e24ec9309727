"""Target-decoy FDR of the PyTorch port against the JAX package, on the CPU.

Tolerance: exact (boolean accept masks).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.spectra import fdr as jfdr
from repro_torch.spectra import fdr as tfdr

# small tensors: one intra-op thread leaves the cores to the other test
# workers
torch.set_num_threads(1)

INT32_MIN = np.iinfo(np.int32).min


def _both(scores, is_target, fdr=0.01, valid=None):
    want = jfdr.fdr_filter(jnp.asarray(scores), jnp.asarray(is_target), fdr,
                           valid=None if valid is None
                           else jnp.asarray(valid))
    got = tfdr.fdr_filter(torch.from_numpy(scores),
                          torch.from_numpy(is_target), fdr,
                          valid=None if valid is None
                          else torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    return got.numpy()


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("fdr", [0.01, 0.05, 0.3])
def test_fdr_filter_random_with_ties_and_valid(seed, fdr):
    rng = np.random.default_rng(seed)
    n = 200
    scores = rng.integers(-8, 8, size=n).astype(np.int32)   # many ties
    is_target = rng.random(n) < 0.8
    valid = rng.random(n) < 0.9 if seed % 2 else None
    _both(scores, is_target, fdr, valid)
    _both(scores.astype(np.float32), is_target, fdr, valid)


def test_fdr_filter_int32_min_top_score():
    """-INT32_MIN wraps to itself in both frameworks, so that query sorts
    first in both."""
    scores = np.array([5, INT32_MIN, 3, 5, INT32_MIN, 1], np.int32)
    is_target = np.array([True, False, True, True, True, False])
    for fdr in (0.0, 0.01, 0.5):
        _both(scores, is_target, fdr)


def test_fdr_filter_ratio_exactly_at_threshold():
    """100 targets, then one decoy: 1/100 == 0.01 in float32, accepted."""
    scores = np.arange(101, 0, -1).astype(np.int32)
    is_target = np.ones(101, bool)
    is_target[100] = False
    scores[100] = 1
    scores = np.concatenate([scores, np.array([0], np.int32)])
    is_target = np.concatenate([is_target, [True]])
    acc = _both(scores, is_target, 0.01)
    assert acc[:100].all() and not acc[100] and acc[101]


def test_decoys_and_competition():
    rng = np.random.default_rng(0)
    refs = rng.random((4, 9)).astype(np.float32)
    np.testing.assert_array_equal(
        tfdr.make_decoys(torch.from_numpy(refs)).numpy(),
        np.asarray(jfdr.make_decoys(jnp.asarray(refs))))
    st = rng.integers(0, 5, 20).astype(np.int32)
    sd = rng.integers(0, 5, 20).astype(np.int32)
    w = jfdr.decoy_competition(jnp.asarray(st), jnp.asarray(sd))
    g = tfdr.decoy_competition(torch.from_numpy(st), torch.from_numpy(sd))
    for a, b in zip(g, w):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
