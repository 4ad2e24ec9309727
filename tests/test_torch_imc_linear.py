"""The IMC-routed FFN down-projection (``_imc_linear``) of the port against
the JAX package's, on the CPU.

The same numpy inputs go through ``repro.models.layers._imc_linear`` and
``repro_torch.models.layers._imc_linear`` (which runs ``imc_mvm``'s plain
version on CPU tensors): d_ff a multiple of 128 and d_ff 200 / 333, so
that the padding to whole 128-column tiles runs, at several ADC and MLC
widths; ``apply_ffn`` with ``imc_linear`` for each activation; and the
straight-through gradients, which must be the exact matmul's.

Tolerances: values rtol 1e-5 / atol 1e-5. The DAC / MLC codes and the
tiles' partials are integers (exact in float32 in any order), so the ADC
codes are equal; the two sides differ in the order they sum the codes
times lsb and the exact product ``x @ w`` (XLA's order against an FMA
chain and torch's matmul). Gradients: equal bit for bit to the port's own
exact matmul's, and rtol 1e-5 / atol 1e-6 to the reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.dist.sharding import set_mesh
from repro.models import layers as JL
from repro_torch.configs import get_config
from repro_torch.kernels.imc_mvm import imc_mvm_plain
from repro_torch.models import layers as L

torch.set_num_threads(1)

RTOL = ATOL = 1e-5


@pytest.fixture(autouse=True)
def no_global_mesh():
    set_mesh(None)
    yield


def _cfgs(**kw):
    jc = dataclasses.replace(jax_get_config("qwen2_7b").reduced(),
                             imc_linear=True, **kw)
    tc = dataclasses.replace(get_config("qwen2_7b").reduced(),
                             imc_linear=True, **kw)
    return jc, tc


def _inputs(f, lead, d=64, seed=0):
    rng = np.random.default_rng(seed + f)
    x = rng.normal(size=lead + (f,)).astype(np.float32)
    w = (rng.normal(size=(f, d)) * f ** -0.5).astype(np.float32)
    return x, w


@pytest.mark.parametrize("f,lead,adc,mlc", [
    (128, (2, 5), 6, 3),
    (200, (1, 33), 6, 3),     # padded to two tiles
    (256, (3, 4), 6, 3),
    (333, (2, 7), 8, 3),      # padded to three tiles
    (384, (3, 4), 4, 2),
    (200, (4, 1), 6, 1),
])
def test_imc_linear_matches_the_reference(f, lead, adc, mlc):
    jc, tc = _cfgs(d_ff=f, imc_adc_bits=adc, imc_mlc_bits=mlc)
    x, w = _inputs(f, lead)
    want = np.asarray(JL._imc_linear(jnp.asarray(x), jnp.asarray(w), jc))
    calls = imc_mvm_plain.calls
    got = L._imc_linear(torch.from_numpy(x), torch.from_numpy(w), tc)
    assert imc_mvm_plain.calls == calls + 1   # one tile product a call
    assert got.shape == lead + (w.shape[1],) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_imc_linear_differs_from_the_exact_product():
    """The analog chain is not the identity: at 6-bit ADCs its value moves
    away from ``x @ w`` by the reference's own amount."""
    jc, tc = _cfgs()
    x, w = _inputs(128, (4, 8))
    got = L._imc_linear(torch.from_numpy(x), torch.from_numpy(w), tc).numpy()
    want = np.asarray(JL._imc_linear(jnp.asarray(x), jnp.asarray(w), jc))
    exact = x @ w
    assert np.abs(got - exact).max() > 1e-2
    np.testing.assert_allclose(np.abs(got - exact).max(),
                               np.abs(want - exact).max(), rtol=1e-4)


def test_imc_linear_keeps_the_input_dtype():
    _, tc = _cfgs()
    x, w = _inputs(128, (2, 3))
    got = L._imc_linear(torch.from_numpy(x).to(torch.bfloat16),
                        torch.from_numpy(w), tc)
    assert got.dtype == torch.bfloat16


@pytest.mark.parametrize("f", [128, 200])
def test_imc_linear_gradient_is_the_exact_matmuls(f):
    """Straight-through: the gradient with respect to x and w is the exact
    product's, bit for bit, and the reference's within tolerance."""
    jc, tc = _cfgs(d_ff=f)
    x, w = _inputs(f, (2, 6))
    cot = np.random.default_rng(1).normal(
        size=(2, 6, w.shape[1])).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    (L._imc_linear(xt, wt, tc) * torch.from_numpy(cot)).sum().backward()
    xe = torch.from_numpy(x).requires_grad_()
    we = torch.from_numpy(w).requires_grad_()
    ((xe @ we) * torch.from_numpy(cot)).sum().backward()
    assert torch.equal(xt.grad, xe.grad) and torch.equal(wt.grad, we.grad)
    gx, gw = jax.grad(lambda a, b: jnp.sum(
        JL._imc_linear(a, b, jc) * cot), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("activation", ["swiglu", "geglu", "gelu"])
def test_apply_ffn_with_imc_linear_matches_the_reference(activation):
    jc, tc = _cfgs(activation=activation)
    rng = np.random.default_rng(7)
    d, f = jc.d_model, jc.d_ff
    p = {"w_up": rng.normal(size=(d, f)) * d ** -0.5,
         "w_down": rng.normal(size=(f, d)) * f ** -0.5}
    if activation == "gelu":
        p["b_up"] = rng.normal(size=f) * 0.1
        p["b_down"] = rng.normal(size=d) * 0.1
    else:
        p["w_gate"] = rng.normal(size=(d, f)) * d ** -0.5
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.normal(size=(2, 9, d)).astype(np.float32)
    want = JL.apply_ffn({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), jc)
    tp = torch.nn.ParameterDict({k: L._param(torch.from_numpy(v))
                                 for k, v in p.items()})
    got = L.apply_ffn(tp, torch.from_numpy(x), tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    # without autograd the port takes its in-place route: the same values
    with torch.no_grad():
        again = L.apply_ffn(tp, torch.from_numpy(x), tc)
    assert torch.equal(again, got.detach())
