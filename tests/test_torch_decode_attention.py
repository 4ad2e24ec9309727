"""The port's decode-attention module against the JAX package, on the CPU.

``decode_attention`` takes its plain version for CPU tensors; that
version is held against the reference's oracle ``decode_attention_ref``
(rtol 1e-5 / atol 1e-6: the same float32 einsums and softmax, summed in
another order) and against the reference's Pallas kernel in interpret
mode (rtol / atol 2e-4, the reference's own kernel-vs-oracle tolerance,
``tests/test_kernels.py``), at ``tests/test_kernels.py``'s shapes and at
G = 1 / hd = 256. The CUDA kernel itself is held against the plain
version on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import decode_attention_pallas
from repro.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.decode_attention import (
    decode_attention,
    decode_attention_plain,
)

torch.set_num_threads(1)


def _inputs(b, s, kv, g, hd, seed=0):
    """tests/test_kernels.py's inputs."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, kv, g, hd)).astype(np.float32)
    k8 = rng.integers(-127, 128, (b, s, kv, hd), dtype=np.int8)
    v8 = rng.integers(-127, 128, (b, s, kv, hd), dtype=np.int8)
    ks = rng.uniform(0.005, 0.02, (b, s, kv)).astype(np.float32)
    vs = rng.uniform(0.005, 0.02, (b, s, kv)).astype(np.float32)
    return q, k8, v8, ks, vs


def _port(args, valid_len):
    return decode_attention(*map(torch.from_numpy, args), valid_len).numpy()


SHAPES = [(1, 128, 1, 4, 32), (2, 256, 2, 8, 64), (2, 96, 4, 7, 16),
          (1, 200, 2, 1, 256)]


@pytest.mark.parametrize("b,s,kv,g,hd", SHAPES)
@pytest.mark.parametrize("frac", [1.0, 0.55, "one"])
def test_plain_matches_the_references_oracle(b, s, kv, g, hd, frac):
    args = _inputs(b, s, kv, g, hd)
    valid = 1 if frac == "one" else int(s * frac)
    want = decode_attention_ref(*map(jnp.asarray, args),
                                jnp.asarray(valid, jnp.int32))
    np.testing.assert_allclose(_port(args, valid), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("b,s,kv,g,hd", SHAPES)
def test_plain_matches_the_interpret_mode_kernel(b, s, kv, g, hd):
    args = _inputs(b, s, kv, g, hd, seed=1)
    for valid in (s, s // 2 + 3):
        want = decode_attention_pallas(*map(jnp.asarray, args),
                                       jnp.asarray(valid, jnp.int32),
                                       chunk=64)
        np.testing.assert_allclose(_port(args, valid), np.asarray(want),
                                   rtol=2e-4, atol=2e-4)


def test_valid_len_masks_the_tail():
    """Rows at or past valid_len set to 127 leave the output bit-identical
    (their weight is exactly 0)."""
    q, k8, v8, ks, vs = _inputs(1, 128, 2, 4, 32, seed=1)
    out = _port((q, k8, v8, ks, vs), 70)
    k8b, v8b = k8.copy(), v8.copy()
    k8b[:, 70:] = 127
    v8b[:, 70:] = 127
    np.testing.assert_array_equal(_port((q, k8b, v8b, ks, vs), 70), out)
    assert not np.array_equal(_port((q, k8b, v8b, ks, vs), 71), out)


def test_valid_len_zero_is_the_uniform_average():
    """valid_len = 0 masks every position; the softmax of S equal logits is
    uniform, as the reference's oracle gives it. (The reference's kernel
    pads S = 100 to its 64-chunk multiple and averages over the 128 padded
    rows, the zero rows included: its output is the oracle's times
    100 / 128. The port masks the ragged tail instead of padding.)"""
    args = _inputs(2, 100, 2, 3, 16, seed=2)
    q, k8, v8, ks, vs = args
    got = _port(args, 0)
    uniform = np.einsum("bsn,bsnk->bnk", vs, v8.astype(np.float32)) / 100
    np.testing.assert_allclose(got, np.broadcast_to(
        uniform[:, :, None, :], got.shape), rtol=1e-5, atol=1e-6)
    want = decode_attention_ref(*map(jnp.asarray, args),
                                jnp.asarray(0, jnp.int32))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)
    padded = decode_attention_pallas(*map(jnp.asarray, args),
                                     jnp.asarray(0, jnp.int32), chunk=64)
    np.testing.assert_allclose(np.asarray(padded), got * 100 / 128,
                               rtol=1e-5, atol=1e-6)


def test_valid_len_past_s_attends_everything():
    args = _inputs(1, 50, 1, 2, 16, seed=3)
    np.testing.assert_array_equal(_port(args, 500), _port(args, 50))


def test_plain_counts_its_calls_and_cpu_never_launches():
    args = tuple(map(torch.from_numpy, _inputs(1, 16, 1, 2, 16)))
    calls, launches = decode_attention_plain.calls, decode_attention.launches
    decode_attention(*args, 8)
    assert decode_attention_plain.calls == calls + 1
    assert decode_attention.launches == launches


@pytest.mark.parametrize("bad", ["q_dtype", "k_dtype", "scale_shape",
                                 "v_shape", "q_rank"])
def test_bad_operands_raise(bad):
    q, k8, v8, ks, vs = map(torch.from_numpy, _inputs(2, 16, 2, 3, 16))
    if bad == "q_dtype":
        q = q.double()
    elif bad == "k_dtype":
        k8 = k8.to(torch.int16)
    elif bad == "scale_shape":
        ks = ks[:, :8]
    elif bad == "v_shape":
        v8 = v8[:, :, :1]
    else:
        q = q[0]
    with pytest.raises(ValueError):
        decode_attention(q, k8, v8, ks, vs, 4)
