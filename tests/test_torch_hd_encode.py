"""``repro_torch.kernels.hd_encode`` against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through ``hd_encode_ref`` (the
reference's oracle), ``hd_encode_pallas`` (its TPU kernel, run in
interpret mode as the reference's own tests run it on the CPU) and the
port's ``hd_encode`` (on CPU tensors: its plain version). Tolerance:
exact (bipolar int8 HVs). Levels past ``m - 1`` read ``LV[m - 1]`` in the
port and in ``hd_encode_ref``; the reference's kernel gives 0 there, so
that case is pinned against the oracle only.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.hd_encode import hd_encode_pallas
from repro.kernels.hd_encode.ref import hd_encode_ref
from repro_torch.core.hd.encoding import encode_levels_batch
from repro_torch.kernels.hd_encode import hd_encode, hd_encode_plain

# small tensors: one intra-op thread leaves the cores to the other test
# workers
torch.set_num_threads(1)


def _operands(seed, B, F, D, m, layout="uniform"):
    """(levels, id_hvs, level_hvs) as numpy: levels uniform over [0, m),
    or sparse (90% of bins absent), with all-absent rows, with levels
    past m - 1, or with exactly two present bins (sign ties)."""
    rng = np.random.default_rng(seed)
    idh = rng.choice([-1, 1], size=(F, D)).astype(np.int8)
    lvh = rng.choice([-1, 1], size=(m, D)).astype(np.int8)
    lev = rng.integers(0, m, size=(B, F))
    if layout == "sparse":
        lev[:, rng.random(F) < 0.9] = 0
    elif layout == "absent":
        lev[::2] = 0
    elif layout == "past_m":
        lev[:, : min(5, F)] = m + rng.integers(0, 3, size=(B, min(5, F)))
    elif layout == "ties":
        lev = rng.integers(1, m, size=(B, F))
    return lev.astype(np.int32), idh, lvh


def _port(lev, idh, lvh, **kw):
    return hd_encode(torch.from_numpy(lev), torch.from_numpy(idh),
                     torch.from_numpy(lvh), **kw).numpy()


def _ref(lev, idh, lvh):
    return np.asarray(hd_encode_ref(jnp.asarray(lev), jnp.asarray(idh),
                                    jnp.asarray(lvh)))


# (B, F, D, m): ragged B, F and D (D not a multiple of 32 or 8), one
# query, one feature, the served shape's F and m
SHAPES = [(1, 1, 32, 2), (3, 5, 7, 4), (8, 16, 64, 4), (13, 37, 100, 8),
          (17, 129, 1000, 16), (32, 1024, 256, 16), (9, 64, 33, 3),
          (40, 300, 96, 32)]


@pytest.mark.parametrize("B,F,D,m", SHAPES)
@pytest.mark.parametrize("layout", ["uniform", "sparse", "absent"])
def test_hd_encode_matches_the_reference_oracle(B, F, D, m, layout):
    lev, idh, lvh = _operands(B * 100 + F + D, B, F, D, m, layout)
    np.testing.assert_array_equal(_port(lev, idh, lvh), _ref(lev, idh, lvh))


@pytest.mark.parametrize("B,F,D,m", [(3, 5, 7, 4), (13, 37, 100, 8),
                                     (17, 129, 1000, 16), (9, 64, 33, 3)])
def test_hd_encode_matches_the_reference_kernel(B, F, D, m):
    lev, idh, lvh = _operands(B + F + D, B, F, D, m, "sparse")
    want = np.asarray(hd_encode_pallas(jnp.asarray(lev), jnp.asarray(idh),
                                       jnp.asarray(lvh)))
    np.testing.assert_array_equal(_port(lev, idh, lvh), want)


@pytest.mark.parametrize("B,F,D,m", [(4, 16, 64, 4), (7, 40, 100, 8)])
def test_levels_past_m_read_the_last_level_hv(B, F, D, m):
    lev, idh, lvh = _operands(B * 7 + F, B, F, D, m, "past_m")
    assert (lev >= m).any()
    got = _port(lev, idh, lvh)
    np.testing.assert_array_equal(got, _ref(lev, idh, lvh))
    np.testing.assert_array_equal(got, _ref(np.minimum(lev, m - 1), idh,
                                            lvh))


def test_all_absent_rows_are_all_minus_one():
    lev, idh, lvh = _operands(1, 6, 20, 70, 4, "absent")
    got = _port(lev, idh, lvh)
    assert (got[::2] == -1).all()
    np.testing.assert_array_equal(got, _ref(lev, idh, lvh))


def test_sign_ties_resolve_to_minus_one():
    # two present bins: acc = LV[l0]ID[0] + LV[l1]ID[1] is 0 wherever the
    # two products disagree
    lev, idh, lvh = _operands(2, 9, 2, 256, 4, "ties")
    lv64 = lev.astype(np.int64)
    acc = (lvh[lv64[:, 0]] * idh[0]).astype(np.int32) + (
        lvh[lv64[:, 1]] * idh[1])
    got = _port(lev, idh, lvh)
    assert (acc == 0).any()
    assert (got[acc == 0] == -1).all()
    np.testing.assert_array_equal(got, np.where(acc > 0, 1, -1))


def test_no_features_give_all_minus_one():
    got = hd_encode(torch.zeros((3, 0), dtype=torch.int32),
                    torch.zeros((0, 40), dtype=torch.int8),
                    torch.ones((4, 40), dtype=torch.int8))
    assert got.shape == (3, 40) and bool((got == -1).all())


@pytest.mark.parametrize("B,F,D,m", [(13, 37, 100, 8), (32, 1024, 256, 16)])
def test_plain_version_equals_the_port_encoder(B, F, D, m):
    lev, idh, lvh = (torch.from_numpy(a) for a in _operands(
        B + 3, B, F, D, m, "sparse"))
    assert torch.equal(hd_encode_plain(lev, idh, lvh),
                       encode_levels_batch(lev, idh, lvh))


def test_plain_version_is_the_same_in_row_chunks():
    lev, idh, lvh = (torch.from_numpy(a) for a in _operands(
        5, 11, 30, 64, 8, "uniform"))
    assert torch.equal(hd_encode_plain(lev, idh, lvh),
                       encode_levels_batch(lev, idh, lvh, chunk_elems=1))


@pytest.mark.parametrize("knobs", [{"block_b": 4, "block_d": 256},
                                   {"block_b": 1, "block_d": 32},
                                   {"block_d": 8192}])
def test_knobs_leave_the_cpu_result_unchanged(knobs):
    lev, idh, lvh = _operands(3, 5, 20, 64, 4)
    np.testing.assert_array_equal(_port(lev, idh, lvh, **knobs),
                                  _port(lev, idh, lvh))


@pytest.mark.parametrize("bad", ["rank", "features", "dims", "empty_m"])
def test_hd_encode_rejects_bad_operands(bad):
    lev = torch.zeros((2, 4), dtype=torch.int32)
    idh = torch.ones((4, 8), dtype=torch.int8)
    lvh = torch.ones((3, 8), dtype=torch.int8)
    if bad == "rank":
        lev = lev[0]
    elif bad == "features":
        idh = idh[:3]
    elif bad == "dims":
        lvh = lvh[:, :7]
    else:
        lvh = lvh[:0]
    with pytest.raises(ValueError):
        hd_encode(lev, idh, lvh)


def test_plain_is_the_cpu_path_and_counts_no_launch():
    lev, idh, lvh = _operands(4, 3, 8, 32, 4)
    before = hd_encode.launches
    _port(lev, idh, lvh)
    assert hd_encode.launches == before
