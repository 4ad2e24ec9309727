"""The port's decode-attention module against the JAX package, on the CPU.

``decode_attention`` takes its plain version for CPU tensors; that
version is held against the reference's oracle ``decode_attention_ref``
(rtol 1e-5 / atol 1e-6: the same float32 einsums and softmax, summed in
another order) and against the reference's Pallas kernel in interpret
mode (rtol / atol 2e-4, the reference's own kernel-vs-oracle tolerance,
``tests/test_kernels.py``), at ``tests/test_kernels.py``'s shapes and at
G = 1 / hd = 256. The CUDA kernel itself is held against the plain
version on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).

The kernel splits S across blocks and merges the splits' partials
(``csrc/decode_attention.cu``). :func:`_split_merge` below mirrors that
arithmetic in torch (per split: a walk in 64-position chunks with the
online max, denominator and accumulator; then the merge) and is held
against the plain version, the reference's oracle and its interpret-mode
kernel at rtol / atol 2e-4, over split counts, ``valid_len`` at and
around a split boundary, splits wholly past ``valid_len``, S = 1 and S
off every chunk multiple. The split rule itself is pinned at the served
shape and at the edges.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels.decode_attention.ops import decode_attention_pallas
from repro.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.decode_attention import (
    decode_attention,
    decode_attention_plain,
)
from repro_torch.kernels.decode_attention.ops import (
    CHUNK,
    decode_splits,
    split_plan,
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


def _split_merge(q, k8, v8, ks, vs, valid_len, splits):
    """The kernel's arithmetic in torch: (out, m (n, B, KV, G), l (n, B,
    KV, G), acc (n, B, KV, G, hd)) for the split plan of ``splits``."""
    B, KV, G, hd = q.shape
    S = k8.shape[1]
    n, per = split_plan(S, splits)
    valid = max(0, min(int(valid_len), S))
    limit = valid if valid > 0 else S
    kf, vf = k8.float(), v8.float()
    ms, ls, accs = [], [], []
    for j in range(n):
        begin = j * per
        walk_end = min(begin + per, S, limit)
        m = torch.full((B, KV, G), -torch.inf)
        l = torch.zeros((B, KV, G))
        acc = torch.zeros((B, KV, G, hd))
        for s0 in range(begin, walk_end, CHUNK):
            s1 = min(s0 + CHUNK, walk_end)
            logits = torch.einsum("bngk,bsnk->bngs", q, kf[:, s0:s1])
            logits = logits * ks[:, s0:s1].transpose(1, 2)[:, :, None, :]
            logits = torch.where(torch.arange(s0, s1) < valid, logits, -1e30)
            m_new = torch.maximum(m, logits.amax(-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            w = p * vs[:, s0:s1].transpose(1, 2)[:, :, None, :]
            acc = (acc * corr[..., None]
                   + torch.einsum("bngs,bsnk->bngk", w, vf[:, s0:s1]))
            m = m_new
        ms.append(m)
        ls.append(l)
        accs.append(acc)
    M, L, A = torch.stack(ms), torch.stack(ls), torch.stack(accs)
    f = torch.exp(M - M.amax(0))
    den = (L * f).sum(0).clamp_min(1e-30)
    out = (A * f[..., None]).sum(0) / den[..., None]
    return out, M, L, A


MIRROR_SHAPE = (2, 300, 2, 3, 32)   # S = 300: off every 64-chunk multiple


@functools.cache
def _mirror_inputs():
    return _inputs(*MIRROR_SHAPE, seed=4)


@functools.cache
def _reference_outputs(valid):
    args = tuple(map(jnp.asarray, _mirror_inputs()))
    vl = jnp.asarray(valid, jnp.int32)
    return (np.asarray(decode_attention_ref(*args, vl)),
            np.asarray(decode_attention_pallas(*args, vl, chunk=64)))


def _valid_len(where, per, S):
    return {"zero": 0, "one": 1, "boundary-1": per - 1, "boundary": per,
            "boundary+1": per + 1, "S": S}[where]


@pytest.mark.parametrize("splits", [1, 2, 7, 17])
@pytest.mark.parametrize("where", ["zero", "one", "boundary-1", "boundary",
                                   "boundary+1", "S"])
def test_split_merge_matches_plain_oracle_and_interpret_kernel(splits, where):
    args = _mirror_inputs()
    S = MIRROR_SHAPE[1]
    n, per = split_plan(S, splits)
    assert n == splits                  # S = 300 takes every count asked
    valid = min(_valid_len(where, per, S), S)
    got, M, L, A = _split_merge(*map(torch.from_numpy, args), valid, splits)
    plain = _port(args, valid)
    np.testing.assert_allclose(got.numpy(), plain, rtol=2e-4, atol=2e-4)
    ref, pallas = _reference_outputs(valid)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-4, atol=2e-4)
    if valid == 0:   # the reference's kernel averages over its padded rows
        pallas = pallas * (-(-S // 64) * 64) / S
    np.testing.assert_allclose(got.numpy(), pallas, rtol=2e-4, atol=2e-4)
    # splits wholly past valid_len leave -inf / 0 / 0, merged as exact 0
    empty = [j for j in range(n) if valid > 0 and j * per >= valid]
    if where in ("one", "boundary-1", "boundary") and splits > 1:
        assert empty
    for j in empty:
        assert bool(torch.isneginf(M[j]).all())
        assert not bool(L[j].any()) and not bool(A[j].any())
        assert not bool(torch.exp(M[j] - M.amax(0)).any())


@pytest.mark.parametrize("splits", [1, 2, 7, 17])
@pytest.mark.parametrize("valid", [0, 1])
def test_split_merge_with_one_position(splits, valid):
    args = _inputs(2, 1, 2, 3, 16, seed=5)
    assert split_plan(1, splits) == (1, 1)
    got = _split_merge(*map(torch.from_numpy, args), valid, splits)[0]
    np.testing.assert_allclose(got.numpy(), _port(args, valid), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("S", [63, 65, 129, 200])
def test_split_merge_off_chunk_multiples(S):
    """Splits longer than a chunk walk several chunks, the last partial."""
    args = _inputs(1, S, 1, 4, 16, seed=S)
    for splits in (1, 2, 3):
        for valid in (S, S // 2 + 1):
            got = _split_merge(*map(torch.from_numpy, args), valid, splits)[0]
            np.testing.assert_allclose(got.numpy(), _port(args, valid),
                                       rtol=2e-4, atol=2e-4)


@settings(deadline=None, max_examples=25)
@given(S=st.integers(1, 400), splits=st.integers(1, 40),
       valid=st.integers(0, 420))
def test_split_merge_matches_plain_on_random_plans(S, splits, valid):
    args = _inputs(1, S, 1, 2, 16, seed=S)
    got = _split_merge(*map(torch.from_numpy, args), valid, splits)[0]
    np.testing.assert_allclose(got.numpy(), _port(args, valid), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("B,KV,S,sms,want", [
    (32, 4, 1088, 132, 3),      # the served shape: 3 splits of 363
    (32, 4, 1025, 132, 3),      # the same grid whatever valid_len
    (1, 1, 1, 132, 1),          # one position
    (1, 1, 128, 132, 1),        # S up to two chunks: one split
    (1, 1, 129, 132, 2),
    (1, 1, 32768, 132, 256),    # long cache, one pair: splits of 128
    (2, 2, 1000, 132, 8),       # 8 splits of 125 (the card tests' edges)
    (128, 8, 4096, 132, 1),     # many pairs fill the card already
    (2000, 1, 1088, 132, 1),
])
def test_split_rule_is_pinned(B, KV, S, sms, want):
    assert decode_splits(B, KV, S, sms) == want


def test_split_plan_cuts_s_into_contiguous_ranges():
    assert split_plan(1088, 3) == (3, 363)
    assert split_plan(1088, 9) == (9, 121)
    assert split_plan(1088, 17) == (17, 64)
    assert split_plan(300, 7) == (7, 43)
    assert split_plan(10, 7) == (5, 2)       # fewer ranges than asked
    assert split_plan(5, 40) == (5, 1)       # at most one split a position
    for S in (1, 63, 64, 65, 1088):
        for splits in (1, 2, 7, 17, 100):
            n, per = split_plan(S, splits)
            assert 1 <= n <= splits and (n - 1) * per < S <= n * per
