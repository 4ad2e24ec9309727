"""``repro_torch.kernels.imc_mvm`` against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through the reference's TPU
kernel ``imc_mvm_pallas`` (in interpret mode, as its own tests run it on
the CPU), its oracle ``imc_mvm_ref``, its array model
``core.imc.array.imc_mvm_reference`` and the port's ``imc_mvm`` (on CPU
tensors: its plain version).

Tolerances. Integer-valued weights make every tile's partial sum exact,
so the port equals the reference's kernel bit for bit (both accumulate
the tiles in order, each step ``code * lsb + acc`` rounded once). With
float weights the partial sums are added in different orders, and the
reference's oracles round ``code * lsb`` before summing, so those
comparisons use the reference's own tolerance, rtol 1e-5 and atol 1e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.imc.array import (
    ArrayConfig,
    IMCArrayState,
    default_full_scale,
    imc_mvm_reference,
)
from repro.core.imc.device import DeviceConfig
from repro.kernels.imc_mvm import imc_mvm_pallas
from repro.kernels.imc_mvm.ref import imc_mvm_ref
from repro_torch.convert import imc_weights_from_numpy
from repro_torch.kernels.imc_mvm import imc_mvm, imc_mvm_plain
from repro_torch.kernels.imc_mvm import ops as imc_ops
from repro_torch.kernels.imc_mvm.ops import lsb_of

# small tensors: one intra-op thread leaves the cores to the other test
# workers
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-3
FS = default_full_scale(ArrayConfig())


def _port(q, w, **kw):
    return imc_mvm(torch.from_numpy(q), torch.from_numpy(w), **kw).numpy()


def _kernel(q, w, **kw):
    return np.asarray(imc_mvm_pallas(jnp.asarray(q), jnp.asarray(w), **kw))


def _integer(seed, Q, R, Dp):
    rng = np.random.default_rng(seed)
    return (rng.integers(-4, 5, size=(Q, Dp)).astype(np.float32),
            rng.integers(-3, 4, size=(R, Dp)).astype(np.float32))


def _noisy(seed, Q, R, Dp):
    """Packed levels (three bipolar dims summed) and noisy programmed
    weights, as the array model holds them."""
    rng = np.random.default_rng(seed)
    q = (2 * rng.binomial(3, 0.5, size=(Q, Dp)) - 3).astype(np.float32)
    w = (2 * rng.binomial(3, 0.5, size=(R, Dp)) - 3) * (
        1 + 0.1716 * rng.standard_normal((R, Dp)))
    return q, w.astype(np.float32)


# (Q, R, Dp, full_scale): ragged Q, R and Dp, one tile and several, the
# default full scale, a coarse one (saturation) and lsb = 2 (.5 points)
INT_CASES = [(9, 70, 300, FS), (1, 1, 128, FS), (16, 33, 129, 62.0),
             (5, 130, 257, 30.0), (40, 64, 512, 200.0), (3, 17, 5, 10.0)]


@pytest.mark.parametrize("Q,R,Dp,fs", INT_CASES)
def test_integer_weights_equal_the_reference_kernel(Q, R, Dp, fs):
    q, w = _integer(Q * 1000 + R + Dp, Q, R, Dp)
    np.testing.assert_array_equal(_port(q, w, full_scale=fs),
                                  _kernel(q, w, full_scale=fs))


@pytest.mark.parametrize("Q,R,Dp,fs", INT_CASES)
def test_integer_weights_match_the_reference_oracle(Q, R, Dp, fs):
    q, w = _integer(Q + R + Dp, Q, R, Dp)
    want = np.asarray(imc_mvm_ref(jnp.asarray(q), jnp.asarray(w),
                                  full_scale=fs))
    np.testing.assert_allclose(_port(q, w, full_scale=fs), want, rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("Q,R,Dp", [(8, 100, 2731), (17, 50, 300),
                                    (32, 64, 128)])
def test_float_weights_match_the_reference_kernel_and_oracle(Q, R, Dp):
    q, w = _noisy(Q * 7 + R + Dp, Q, R, Dp)
    got = _port(q, w, full_scale=FS)
    np.testing.assert_allclose(got, _kernel(q, w, full_scale=FS), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(
        got, np.asarray(imc_mvm_ref(jnp.asarray(q), jnp.asarray(w),
                                    full_scale=FS)), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("Q,R,Dp", [(8, 100, 2731), (5, 33, 300)])
def test_matches_the_array_model_with_the_paper_config(Q, R, Dp):
    """``core/imc/array.py:imc_mvm_reference`` with ``ArrayConfig()``:
    3-bit DAC, 6-bit ADC, 128-column arrays, the default full scale."""
    q, w = _noisy(Q + 2 * R + Dp, Q, R, Dp)
    cfg = ArrayConfig()
    want = np.asarray(imc_mvm_reference(jnp.asarray(q), jnp.asarray(w), cfg))
    got = _port(q, w, full_scale=default_full_scale(cfg),
                tile_cols=cfg.cols, dac_limit=cfg.dac_levels,
                adc_levels=cfg.adc_levels)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_standard_normal_operands_match_the_reference_kernel():
    rng = np.random.default_rng(12)
    q = rng.standard_normal((32, 128)).astype(np.float32) * 2
    w = rng.standard_normal((64, 128)).astype(np.float32)
    np.testing.assert_allclose(_port(q, w, full_scale=128.0),
                               _kernel(q, w, full_scale=128.0), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("Dp", [1, 5, 127, 129, 300])
def test_ragged_dp_pads_with_inert_zero_columns(Dp):
    q, w = _integer(Dp, 4, 9, Dp)
    got = _port(q, w, full_scale=FS)
    np.testing.assert_array_equal(got, _kernel(q, w, full_scale=FS))
    pad = (-Dp) % 128
    padded = _port(np.pad(q, ((0, 0), (0, pad))),
                   np.pad(w, ((0, 0), (0, pad))), full_scale=FS)
    np.testing.assert_array_equal(got, padded)


def test_exact_half_points_round_to_even():
    """lsb = 62 / 31 = 2 exactly; one-column tiles give partials q * w, so
    part / lsb = k + 0.5 for odd partials."""
    q = np.array([[1, 1, 1, 1, 1, 1]], np.float32)
    w = np.diag(np.array([1, 3, 5, -1, -3, -5], np.float32))
    # row r has one nonzero column r: partial = w[r, r] in tile r
    got = _port(q, w, full_scale=62.0, tile_cols=1)
    codes = np.array([0, 2, 2, 0, -2, -2], np.float32)  # half to even
    np.testing.assert_array_equal(got[0], codes * 2.0)
    np.testing.assert_array_equal(got[0], np.round(np.diag(w) / 2.0) * 2.0)
    np.testing.assert_array_equal(
        got, np.asarray(imc_mvm_ref(jnp.asarray(q), jnp.asarray(w),
                                    full_scale=62.0, tile_cols=1)))


def test_half_points_at_full_tiles_equal_the_reference_kernel():
    q, w = _integer(62, 17, 300, 257)
    qd = np.clip(np.round(q), -3, 3)
    assert (np.abs(qd[:, :128] @ w[:, :128].T) % 2 == 1).any()  # odd
    np.testing.assert_array_equal(_port(q, w, full_scale=62.0),
                                  _kernel(q, w, full_scale=62.0))


def test_codes_saturate_at_adc_levels():
    q = np.full((2, 256), 3.0, np.float32)
    q[1] = -3.0
    w = np.full((3, 256), 3.0, np.float32)   # partial +-1152 per tile
    lsb = lsb_of(FS, 31)
    got = _port(q, w, full_scale=FS)
    np.testing.assert_allclose(got[0], 2 * 31 * lsb, rtol=1e-6)  # 2 tiles
    np.testing.assert_array_equal(got[1], -got[0])
    np.testing.assert_array_equal(got, _kernel(q, w, full_scale=FS))


def test_dac_rounds_half_to_even_and_clamps():
    q = np.array([[0.5, 1.5, 2.5, -0.5, -2.5, 7.0, -9.0, 2.49]], np.float32)
    w = np.eye(8, dtype=np.float32)
    got = _port(q, w, full_scale=31.0, tile_cols=1)   # lsb = 1
    np.testing.assert_array_equal(got[0], [0, 2, 2, 0, -2, 3, -3, 2])


@pytest.mark.parametrize("tc", [1, 64, 256])
def test_other_array_widths_follow_the_reference_oracle(tc):
    q, w = _integer(tc, 6, 20, 300)
    want = np.asarray(imc_mvm_ref(jnp.asarray(q), jnp.asarray(w),
                                  full_scale=FS, tile_cols=tc))
    np.testing.assert_allclose(_port(q, w, full_scale=FS, tile_cols=tc),
                               want, rtol=RTOL, atol=ATOL)


def test_lsb_is_rounded_once_from_double():
    assert lsb_of(FS, 31) == float(np.float32(FS / 31))
    assert lsb_of(62.0, 31) == 2.0


def test_plain_version_is_the_same_in_row_chunks(monkeypatch):
    q, w = _noisy(3, 7, 50, 300)
    b = imc_mvm_plain(torch.from_numpy(q), torch.from_numpy(w),
                      full_scale=FS)
    monkeypatch.setattr(imc_ops, "CHUNK_ROWS", 7)
    a = imc_mvm_plain(torch.from_numpy(q), torch.from_numpy(w),
                      full_scale=FS)
    assert torch.equal(a, b)


@pytest.mark.parametrize("knobs", [{"block_q": 8, "block_r": 32},
                                   {"block_q": 64, "block_r": 256},
                                   {"block_r": 64}])
def test_knobs_leave_the_cpu_result_unchanged(knobs):
    q, w = _noisy(4, 9, 40, 200)
    np.testing.assert_array_equal(_port(q, w, full_scale=FS, **knobs),
                                  _port(q, w, full_scale=FS))


@pytest.mark.parametrize("bad", ["width", "rank", "empty", "tile_cols",
                                 "adc"])
def test_imc_mvm_rejects_bad_operands(bad):
    q = torch.zeros((2, 8))
    w = torch.zeros((3, 8))
    kw = {"full_scale": 10.0}
    if bad == "width":
        w = w[:, :7]
    elif bad == "rank":
        q = q[0]
    elif bad == "empty":
        q, w = q[:, :0], w[:, :0]
    elif bad == "tile_cols":
        kw["tile_cols"] = 64.0
    else:
        kw["adc_levels"] = 0
    with pytest.raises(ValueError):
        imc_mvm(q, w, **kw)


def test_programmed_weights_cross_as_float32():
    rng = np.random.default_rng(0)
    state = IMCArrayState(
        weights=jnp.asarray(rng.standard_normal((5, 300)).astype(np.float32)),
        cfg=ArrayConfig(), device=DeviceConfig())
    w = imc_weights_from_numpy(np.asarray(state.weights), device="cpu")
    assert w.dtype == torch.float32 and w.is_contiguous()
    np.testing.assert_array_equal(w.numpy(), np.asarray(state.weights))
    with pytest.raises(ValueError):
        imc_weights_from_numpy(np.zeros((3, 4), np.int8), device="cpu")


def test_plain_is_the_cpu_path_and_counts_no_launch():
    q, w = _integer(1, 2, 3, 10)
    before = imc_mvm.launches
    _port(q, w, full_scale=FS)
    assert imc_mvm.launches == before
