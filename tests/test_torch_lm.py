"""Parity of the port's LM serving slice with the JAX package, on the CPU.

The same inputs, made with numpy from a seed (and the reference's own
parameters, carried across as numpy), go through ``repro`` and
``repro_torch``: the token pipeline, the layers, attention with both
cache kinds, the assembled model's prefill and decode steps, and the
launcher. Both sides run ``qwen2_7b.reduced()`` in float32.

Tolerances: token ids, ``_kv_quant``'s codes and scales, and greedy
tokens are exact; float32 activations agree to rtol 1e-5 / atol 1e-5
(1e-4 through a whole model), because the two libraries sum products in
different orders. The int8 decode route scales q by ``hd**-0.5`` before
the dot (as ``tests/test_kernels.py`` feeds the reference's kernel)
where the reference divides the logits by ``sqrt(hd)`` after it: another
float32 rounding, inside the same tolerance.

Every test that runs JAX model code first clears ``repro.dist.sharding``'s
global mesh (a reference launcher test on the same worker may have left
one set); none calls a JAX launcher.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data.tokens import TokenPipeline as JaxTokenPipeline
from repro.data.tokens import synthetic_batch as jax_synthetic_batch
from repro.dist.sharding import set_mesh
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.model_zoo import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.data.tokens import TokenPipeline, synthetic_batch
from repro_torch.kernels.decode_attention import (
    decode_attention,
    decode_attention_plain,
)
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.model_zoo import build_model

torch.set_num_threads(1)

RTOL = ATOL = 1e-5


@pytest.fixture(autouse=True)
def no_global_mesh():
    set_mesh(None)
    yield


def _cfgs(kv_quant=False, window=0):
    jc = jax_get_config("qwen2_7b").reduced()
    tc = get_config("qwen2_7b").reduced()
    jc = dataclasses.replace(jc, kv_quant_int8=kv_quant,
                             sliding_window=window)
    tc = dataclasses.replace(tc, kv_quant_int8=kv_quant,
                             sliding_window=window)
    return jc, tc


def _np(x):
    return np.asarray(x)


def _t(a):
    return torch.from_numpy(np.array(a))


def _attn_params(jp):
    return torch.nn.ParameterDict({k: L._param(_t(v)) for k, v in jp.items()})


# ---------------------------------------------------------------- configs --

def test_config_is_the_references():
    jc, tc = _cfgs()
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    full_j = jax_get_config("qwen2_7b")
    full_t = get_config("qwen2_7b")
    assert dataclasses.asdict(full_j) == dataclasses.asdict(full_t)
    assert full_t.padded_vocab == 152_064 and full_t.resolved_head_dim == 128


@pytest.mark.parametrize("arch", ["whisper_medium", "internvl2_76b"])
def test_encdec_and_vlm_archs_build_and_decode(arch):
    """Every config is registered and builds: the encoder-decoder with
    ``dec_cross`` layers (a KV cache and empty cross K/V a layer until a
    prefill stores the memory's) and an encoder, the VLM with
    ``attn_ffn`` layers; a prefill and a decode step from the token
    pipeline's batch give finite logits."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg, "cpu")
    params = model.init(0)
    caches = T.init_cache(cfg, 2, 24)
    batch = TokenPipeline(2, 16, cfg.vocab_size).get_for(cfg, 0, "cpu")
    if cfg.is_encoder_decoder:
        assert set(params.layers[0]) == {"norm1", "attn", "norm_x", "xattn",
                                         "norm2", "ffn"}
        assert len(params.enc_layers) == cfg.num_encoder_layers
        assert all(xkv.k.shape[1] == 0 for _, xkv in caches)
        start = batch["tokens"].shape[1]
    else:
        assert set(params.layers[0]) == {"norm1", "attn", "norm2", "ffn"}
        assert all(isinstance(c, L.KVCache) for c in caches)
        start = 16
    logits, caches = model.prefill(params, batch, caches, last_only=True)
    if cfg.is_encoder_decoder:
        assert all(xkv.k.shape[1] == 8 for _, xkv in caches)
    logits, _ = model.decode_step(params, logits.argmax(-1).to(torch.int32),
                                  caches, start)
    assert logits.shape == (2, 1, cfg.padded_vocab)
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("arch", ["xlstm_125m", "hymba_1_5b"])
def test_recurrent_arch_builds_with_state_caches(arch):
    """The ssm and hybrid families build: ``init_cache`` gives each layer
    its state (an mLSTM / sLSTM state, or a KV cache and a Mamba state),
    the reference's layout, and one decode step keeps every entry's
    type and shape."""
    jc, tc = (dataclasses.replace(c.reduced(), num_layers=4)
              for c in (jax_get_config(arch), get_config(arch)))
    model = build_model(tc, "cpu")
    caches = T.init_cache(tc, 2, 20)
    want = JT.init_cache(jc, 2, 20)
    if arch == "xlstm_125m":
        assert [type(c).__name__ for c in caches] == [
            type(c).__name__ for c in want] == [
            "MLSTMState", "MLSTMState", "MLSTMState", "SLSTMState"]
        for c, w in zip(caches, want):
            for f in dataclasses.fields(w):
                assert tuple(getattr(c, f.name).shape) == getattr(
                    w, f.name).shape
    else:
        kv, st = want
        for c in caches:
            assert isinstance(c[0], L.KVCache) and c[0].k.shape == (
                2, 16, 2, 16) == kv.k.shape[1:]
            assert c[1].h.shape == (2, 64, 8) == st.h.shape[1:]
    params = model.init(0)
    tok = torch.zeros((2, 1), dtype=torch.int32)
    logits, after = model.decode_step(params, tok, caches, 0)
    assert logits.shape == (2, 1, tc.padded_vocab)
    assert [type(c) for c in after] == [type(c) for c in T.init_cache(
        tc, 2, 20)]


def test_family_decides_the_stack():
    """On Qwen's widths the ``ssm`` family builds mLSTM blocks, an
    encoder-decoder ``dec_cross`` layers and an encoder, and the vlm
    family ``attn_ffn`` layers; each cache follows its layers."""
    base = get_config("qwen2_7b").reduced()
    cfg = dataclasses.replace(base, family="ssm", ssm_state=8)
    assert build_model(cfg, "cpu").init(0).stack == "blocks"
    assert all(type(c).__name__ == "MLSTMState"
               for c in T.init_cache(cfg, 1, 8))
    audio = dataclasses.replace(base, family="audio",
                                is_encoder_decoder=True,
                                num_encoder_layers=3)
    lm = build_model(audio, "cpu").init(0)
    assert len(lm.enc_layers) == 3 and "xattn" in lm.layers[1]
    assert all(isinstance(c[1], T.CrossKV) for c in T.init_cache(audio, 1, 8))
    vlm = dataclasses.replace(base, family="vlm")
    lm = build_model(vlm, "cpu").init(0)
    assert lm.enc_layers is None and "xattn" not in lm.layers[0]
    assert all(isinstance(c, L.KVCache) for c in T.init_cache(vlm, 1, 8))


# ----------------------------------------------------------------- tokens --

@pytest.mark.parametrize("step,batch,seq,vocab,seed", [
    (0, 32, 1024, 152_064, 0),
    (3, 4, 77, 256, 5),
    (2**31 - 1, 3, 700, 152_064, 123_456),
    (17, 2, 2048, 1000, 2**20),
])
def test_synthetic_batch_is_bit_exact(step, batch, seq, vocab, seed):
    want = _np(jax_synthetic_batch(jnp.asarray(step, jnp.int32), batch, seq,
                                   vocab, seed)["tokens"])
    got = synthetic_batch(step, batch, seq, vocab, seed, "cpu")["tokens"]
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_token_pipeline_get_for_matches():
    cfg = get_config("qwen2_7b")
    want = _np(JaxTokenPipeline(4, 300, cfg.vocab_size).get_for(
        jax_get_config("qwen2_7b"), 2)["tokens"])
    got = TokenPipeline(4, 300, cfg.vocab_size).get_for(cfg, 2, "cpu")
    np.testing.assert_array_equal(got["tokens"].numpy(), want)
    # the vlm family on Qwen's widths: patches before the text, bit-exact
    jvlm = dataclasses.replace(jax_get_config("qwen2_7b"), family="vlm")
    want = JaxTokenPipeline(2, 64, cfg.vocab_size).get_for(jvlm, 1)
    got = TokenPipeline(2, 64, cfg.vocab_size).get_for(
        dataclasses.replace(cfg, family="vlm"), 1, "cpu")
    assert got["patches"].shape == (2, 8, cfg.d_model)
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  _np(want["tokens"]))
    np.testing.assert_array_equal(
        got["patches"].float().numpy(),
        _np(want["patches"].astype(jnp.float32)))


# ----------------------------------------------------------------- layers --

@pytest.mark.parametrize("shape", [(2, 5, 3, 16), (1, 300, 2, 128),
                                   (4, 1, 7, 64)])
def test_kv_quant_is_exact(shape):
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(size=shape).astype(np.float32) * rng.uniform(0.01, 50)
    x[..., 0, :] = 0.0          # an all-zero row takes the 1e-6 floor
    q_j, s_j = JL._kv_quant(jnp.asarray(x))
    q_t, s_t = L._kv_quant(_t(x))
    np.testing.assert_array_equal(q_t.numpy(), _np(q_j))
    np.testing.assert_array_equal(s_t.numpy(), _np(s_j))


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_apply_norm(norm):
    jc, tc = _cfgs()
    jc = dataclasses.replace(jc, norm=norm)
    tc = dataclasses.replace(tc, norm=norm)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 7, 64)).astype(np.float32) * 3
    p = {"scale": rng.normal(size=64).astype(np.float32)}
    if norm == "layernorm":
        p["bias"] = rng.normal(size=64).astype(np.float32)
    want = JL.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x), jc)
    got = L.apply_norm(_attn_params(p), _t(x), tc)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("theta,hd,per_batch", [(10_000.0, 16, False),
                                                (1_000_000.0, 128, True)])
def test_apply_rope(theta, hd, per_batch):
    rng = np.random.default_rng(hd)
    x = rng.normal(size=(2, 9, 3, hd)).astype(np.float32)
    pos = (rng.integers(0, 40_000, size=(2, 9)) if per_batch
           else np.arange(9)).astype(np.int32)
    np.testing.assert_allclose(
        L.rope_freqs(hd, theta).numpy(), _np(JL.rope_freqs(hd, theta)),
        rtol=1e-6)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = L.apply_rope(_t(x), _t(pos), theta)
    # angles up to 4e4 rad: sin/cos of the same float32 angle differ by
    # the libraries' argument reduction, a few ulps of the result
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-4, atol=1e-4)


def _qkv_inputs(b, sq, skv, seed=0):
    jc, _ = _cfgs()
    rng = np.random.default_rng(seed)
    h, kv, hd = jc.num_heads, jc.num_kv_heads, jc.resolved_head_dim
    q = rng.normal(size=(b, sq, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, skv, kv, hd)).astype(np.float32)
    v = rng.normal(size=(b, skv, kv, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_full(window, causal):
    jc, tc = _cfgs(window=window)
    q, k, v = _qkv_inputs(2, 24, 24, seed=window)
    want = JL.attention_full(*map(jnp.asarray, (q, k, v)), jc, causal=causal)
    got = L.attention_full(*map(_t, (q, k, v)), tc, causal=causal)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("chunk", [4, 16])
def test_attention_chunked(window, chunk):
    jc, tc = _cfgs(window=window)
    q, k, v = _qkv_inputs(2, 32, 32, seed=chunk)
    want = JL.attention_chunked(*map(jnp.asarray, (q, k, v)), jc, chunk=chunk)
    got = L.attention_chunked(*map(_t, (q, k, v)), tc, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL, atol=ATOL)
    full = L.attention_full(*map(_t, (q, k, v)), tc)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("activation", ["swiglu", "geglu", "gelu"])
def test_apply_ffn(activation):
    jc, tc = _cfgs()
    jc = dataclasses.replace(jc, activation=activation)
    tc = dataclasses.replace(tc, activation=activation)
    jp, _ = JL.init_ffn(jax.random.PRNGKey(3), jc)
    jp = {k: _np(v) for k, v in jp.items()}
    if "b_up" in jp:   # non-zero biases exercise the adds
        rng = np.random.default_rng(0)
        jp["b_up"] = rng.normal(size=jp["b_up"].shape).astype(np.float32)
        jp["b_down"] = rng.normal(size=jp["b_down"].shape).astype(np.float32)
    x = np.random.default_rng(4).normal(size=(2, 5, 64)).astype(np.float32)
    want = JL.apply_ffn({k: jnp.asarray(v) for k, v in jp.items()},
                        jnp.asarray(x), jc)
    got = L.apply_ffn(_attn_params(jp), _t(x), tc)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL, atol=ATOL)


def _windowed_params(jc, seed=7):
    jp, _ = JL.init_attention(jax.random.PRNGKey(0), jc)
    jp = {k: _np(v) for k, v in jp.items()}
    rng = np.random.default_rng(seed)
    jp["bq"] = rng.normal(size=jp["bq"].shape).astype(np.float32) * 0.1
    jp["bk"] = rng.normal(size=jp["bk"].shape).astype(np.float32) * 0.1
    return jp, rng


def _train_oracle(monkeypatch, jpa, x, jc, quant):
    """The reference's ``attention_train`` over the whole sequence ``x``
    (causal, with the config's window), at its last position. With
    ``quant`` its K/V pass through the reference's ``_kv_quant`` and back,
    as the int8 cache holds them."""
    qkv = JL._qkv

    def quantized_qkv(p, xs, cfg, positions):
        q, k, v = qkv(p, xs, cfg, positions)
        deq = [c.astype(jnp.float32) * sc[..., None]
               for c, sc in (JL._kv_quant(k), JL._kv_quant(v))]
        return q, deq[0].astype(k.dtype), deq[1].astype(v.dtype)

    if quant:
        monkeypatch.setattr(JL, "_qkv", quantized_qkv)
    try:
        return _np(JL.attention_train(jpa, jnp.asarray(x), jc))[:, -1:]
    finally:
        monkeypatch.setattr(JL, "_qkv", qkv)


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("window,max_len", [(0, 20), (8, 20)])
def test_attention_prefill_then_decode(kv_quant, window, max_len,
                                       monkeypatch):
    """Prefill 10 positions, then decode to position 19 (past the
    8-position ring when the window is on): outputs and caches agree.
    Without a window the oracle is the reference's decode; with one it is
    the reference's ``attention_train`` over the whole sequence, since the
    reference's prefill misaligns the ring when the prompt is longer than
    the window (ROADMAP Queue 3, F1)."""
    jc, tc = _cfgs(kv_quant, window)
    jp, rng = _windowed_params(jc)
    tp = _attn_params(jp)
    jpa = {k: jnp.asarray(v) for k, v in jp.items()}
    x = rng.normal(size=(2, max_len, 64)).astype(np.float32) * 0.5
    s0 = 10
    jcache = JL.init_kv_cache(jc, 2, max_len, dtype=jnp.float32)
    tcache = L.init_kv_cache(tc, 2, max_len, dtype=torch.float32)
    y_j, jcache = JL.attention_prefill(jpa, jnp.asarray(x[:, :s0]), jc,
                                       jcache)
    y_t, tcache = L.attention_prefill(tp, _t(x[:, :s0]), tc, tcache)
    np.testing.assert_allclose(y_t.numpy(), _np(y_j), rtol=RTOL, atol=ATOL)
    for pos in range(s0, max_len):
        y_j, jcache = JL.attention_decode(jpa, jnp.asarray(x[:, pos:pos + 1]),
                                          jc, jcache,
                                          jnp.asarray(pos, jnp.int32))
        y_t, tcache = L.attention_decode(tp, _t(x[:, pos:pos + 1]), tc,
                                         tcache, pos)
        want = (_train_oracle(monkeypatch, jpa, x[:, :pos + 1], jc, kv_quant)
                if window else _np(y_j))
        np.testing.assert_allclose(y_t.numpy(), want, rtol=RTOL, atol=ATOL)
    # every ring slot was rewritten by decode, at slot pos % size on both
    # sides, so the caches agree again
    if kv_quant:
        np.testing.assert_array_equal(tcache.k.numpy(), _np(jcache.k))
        np.testing.assert_array_equal(tcache.v_scale.numpy(),
                                      _np(jcache.v_scale))
    else:
        np.testing.assert_allclose(tcache.k.numpy(), _np(jcache.k),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("s0", [8, 9, 10, 11, 16])
def test_windowed_decode_after_a_long_prefill_matches_full_attention(
        kv_quant, s0, monkeypatch):
    """F1: prefill ``s0`` positions into an 8-slot window, then decode 10
    more. Each step equals the reference's ``attention_train`` over the
    whole sequence. Where the prompt fits the window or fills it a whole
    number of times (8, 16), the ring also equals the reference's own."""
    jc, tc = _cfgs(kv_quant, window=8)
    jp, rng = _windowed_params(jc, seed=s0)
    tp = _attn_params(jp)
    jpa = {k: jnp.asarray(v) for k, v in jp.items()}
    max_len = s0 + 10
    x = rng.normal(size=(2, max_len, 64)).astype(np.float32) * 0.5
    tcache = L.init_kv_cache(tc, 2, max_len, dtype=torch.float32)
    jcache = JL.init_kv_cache(jc, 2, max_len, dtype=jnp.float32)
    _, tcache = L.attention_prefill(tp, _t(x[:, :s0]), tc, tcache)
    _, jcache = JL.attention_prefill(jpa, jnp.asarray(x[:, :s0]), jc, jcache)
    if s0 % 8 == 0:
        np.testing.assert_allclose(tcache.k.numpy().astype(np.float32),
                                   _np(jcache.k).astype(np.float32),
                                   rtol=RTOL, atol=ATOL)
    for pos in range(s0, max_len):
        y_t, tcache = L.attention_decode(tp, _t(x[:, pos:pos + 1]), tc,
                                         tcache, pos)
        want = _train_oracle(monkeypatch, jpa, x[:, :pos + 1], jc, kv_quant)
        np.testing.assert_allclose(y_t.numpy(), want, rtol=RTOL, atol=ATOL)
        if s0 % 8 == 0:
            y_j, jcache = JL.attention_decode(
                jpa, jnp.asarray(x[:, pos:pos + 1]), jc, jcache,
                jnp.asarray(pos, jnp.int32))
            np.testing.assert_allclose(y_t.numpy(), _np(y_j), rtol=RTOL,
                                       atol=ATOL)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_decode_past_a_cache_without_window_raises(kv_quant):
    """F2: a no-window cache of 6 positions takes decode at positions 4
    and 5, and raises at 6 (the reference's clamped write would overwrite
    the last slot), leaving the cache as it was."""
    _, tc = _cfgs(kv_quant)
    tp = L.init_attention(tc, generator=torch.Generator().manual_seed(0))
    cache = L.init_kv_cache(tc, 2, 6, dtype=torch.float32)
    g = torch.Generator().manual_seed(1)
    _, cache = L.attention_prefill(tp, torch.randn(2, 4, 64, generator=g),
                                   tc, cache)
    for pos in (4, 5):
        _, cache = L.attention_decode(tp, torch.randn(2, 1, 64, generator=g),
                                      tc, cache, pos)
    before = [t.clone() for t in dataclasses.astuple(cache)]
    with pytest.raises(ValueError, match=r"position 6 .* 6 positions"):
        L.attention_decode(tp, torch.randn(2, 1, 64, generator=g), tc, cache,
                           6)
    assert all(torch.equal(a, b)
               for a, b in zip(before, dataclasses.astuple(cache)))


def test_int8_decode_goes_through_the_attend_seam():
    """The int8 branch hands decode_attention exactly what
    tests/test_kernels.py feeds the reference's kernel: q grouped to
    (B, KV, G, hd), float32, times hd**-0.5, and valid_len = pos + 1."""
    _, tc = _cfgs(kv_quant=True)
    tp = L.init_attention(tc, generator=torch.Generator().manual_seed(0))
    cache = L.init_kv_cache(tc, 2, 12)
    seen = []

    def attend(q, k8, v8, ks, vs, valid_len):
        seen.append((tuple(q.shape), q.dtype, valid_len))
        return decode_attention_plain(q, k8, v8, ks, vs, valid_len)

    x = torch.randn(2, 1, 64, generator=torch.Generator().manual_seed(1))
    y_seam, _ = L.attention_decode(tp, x, tc, cache, 5, attend)
    y_def, _ = L.attention_decode(tp, x, tc, cache, 5)
    assert seen == [((2, 2, 2, 16), torch.float32, 6)]
    torch.testing.assert_close(y_seam, y_def, rtol=0, atol=0)


# ------------------------------------------------------------------ model --

def _jax_and_port_models(kv_quant):
    jc, tc = _cfgs(kv_quant)
    jm = jax_build_model(jc)
    jparams, _ = jm.init(jax.random.PRNGKey(0))
    tparams = lm_params_from_numpy(jax.tree.map(np.asarray, jparams), tc,
                                   "cpu")
    return jc, tc, jm, jparams, build_model(tc, "cpu"), tparams


def test_lm_params_from_numpy_shapes_and_values():
    jc, tc, _, jparams, _, tp = _jax_and_port_models(False)
    assert tp["embed"].shape == (256, 64) and tp["lm_head"].shape == (64, 256)
    assert len(tp.layers) == 2
    for i, lp in enumerate(tp.layers):
        for group in ("norm1", "attn", "norm2", "ffn"):
            for name, a in jparams["layers"][group].items():
                t = lp[group][name]
                assert tuple(t.shape) == a.shape[1:]
                assert t.dtype == torch.float32 and not t.requires_grad
                np.testing.assert_array_equal(t.numpy(), _np(a[i]))
    np.testing.assert_array_equal(tp["embed"].numpy(), _np(jparams["embed"]))
    # full width keeps matrices in bfloat16 and norm scales in float32
    bf = dataclasses.replace(tc, dtype="bfloat16")
    tb = lm_params_from_numpy(jax.tree.map(np.asarray, jparams), bf, "cpu")
    assert tb["embed"].dtype == torch.bfloat16
    assert tb.layers[0]["attn"]["wq"].dtype == torch.bfloat16
    assert tb.layers[0]["norm1"]["scale"].dtype == torch.float32
    np.testing.assert_array_equal(
        tb.layers[1]["ffn"]["w_up"].float().numpy(),
        _np(jparams["layers"]["ffn"]["w_up"][1].astype(jnp.bfloat16)
            .astype(jnp.float32)))


@pytest.mark.parametrize("kv_quant", [False, True])
def test_prefill_and_decode_match_the_reference(kv_quant):
    """Model.prefill + 8 decode steps, teacher-forced on the reference's
    greedy tokens: logits within 1e-4, greedy tokens equal."""
    jc, tc, jm, jparams, tm, tparams = _jax_and_port_models(kv_quant)
    B, S, gen = 2, 12, 9
    batch = JaxTokenPipeline(B, S, jc.vocab_size).get_for(jc, 0)
    tbatch = TokenPipeline(B, S, tc.vocab_size).get_for(tc, 0, "cpu")
    np.testing.assert_array_equal(tbatch["tokens"].numpy(),
                                  _np(batch["tokens"]))
    jcache = jm.init_cache(B, S + gen)
    tcache = tm.init_cache(B, S + gen)
    lj, jcache = jm.prefill(jparams, batch, jcache)
    lt, tcache = tm.prefill(tparams, tbatch, tcache)
    np.testing.assert_allclose(lt.numpy(), _np(lj), rtol=1e-4, atol=1e-4)
    last, _ = tm.prefill(tparams, tbatch, tm.init_cache(B, S + gen),
                         last_only=True)
    np.testing.assert_allclose(last.numpy(), lt[:, -1:].numpy(), rtol=1e-5,
                               atol=1e-5)
    tok = jnp.argmax(lj[:, -1:], axis=-1).astype(jnp.int32)
    launches = decode_attention.launches
    for i in range(gen - 1):
        lj, jcache = jm.decode_step(jparams, tok, jcache,
                                    jnp.asarray(S + i, jnp.int32))
        lt, tcache = tm.decode_step(tparams, _t(tok), tcache, S + i)
        np.testing.assert_allclose(lt.numpy(), _np(lj), rtol=1e-4,
                                   atol=1e-4)
        tok = jnp.argmax(lj, axis=-1).astype(jnp.int32)
        np.testing.assert_array_equal(
            torch.argmax(lt, -1).numpy(), _np(tok))
    assert decode_attention.launches == launches  # CPU: the plain version


@pytest.mark.parametrize("kv_quant", [False, True])
def test_launcher_runs_on_the_cpu(kv_quant, capsys):
    args = ["--arch", "qwen2_7b", "--reduced", "--device", "cpu", "--batch",
            "2", "--prompt-len", "16", "--gen", "4"]
    run = serve.main(args + (["--kv-quant"] if kv_quant else []))
    out = capsys.readouterr().out
    for line in ("prefill:", "decode:", "ms per step", "tokens/s",
                 "peak memory: not measured on the cpu",
                 "decode_attention launches: 0", "generated token ids"):
        assert line in out, out
    assert run.tokens.shape == (2, 4) and run.tokens.dtype == torch.int32
    assert len(run.step_ms) == 3 and run.clock == "host"
    assert run.model.cfg.kv_quant_int8 is kv_quant
    # deterministic: the same seeds give the same tokens
    again = serve.main(args + (["--kv-quant"] if kv_quant else []))
    torch.testing.assert_close(again.tokens, run.tokens, rtol=0, atol=0)


def test_launcher_greedy_tokens_match_the_references_flow():
    """The launcher's greedy loop (prefill, argmax, gen - 1 decode steps)
    on the reference's parameters reproduces the reference's tokens."""
    jc, tc, jm, jparams, tm, tparams = _jax_and_port_models(True)
    B, S, gen = 2, 16, 6
    batch = JaxTokenPipeline(B, S, jc.vocab_size).get_for(jc, 0)
    cache = jm.init_cache(B, S + gen)
    logits, cache = jm.prefill(jparams, batch, cache)
    tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    want = [tok]
    for i in range(gen - 1):
        logits, cache = jm.decode_step(jparams, tok, cache,
                                       jnp.asarray(S + i, jnp.int32))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        want.append(tok)
    run = serve.generate(tm, tparams, TokenPipeline(
        B, S, tc.vocab_size).get_for(tc, 0, "cpu"), gen)
    np.testing.assert_array_equal(run.tokens.numpy(),
                                  _np(jnp.concatenate(want, axis=1)))


def test_sampling_is_seeded_and_in_range():
    _, tc = _cfgs(True)
    tm = build_model(tc, "cpu")
    params = tm.init(seed=0)
    batch = TokenPipeline(3, 8, tc.vocab_size).get(0, "cpu")
    a = serve.generate(tm, params, batch, 6, temperature=0.7)
    b = serve.generate(tm, params, batch, 6, temperature=0.7)
    torch.testing.assert_close(a.tokens, b.tokens, rtol=0, atol=0)
    assert int(a.tokens.min()) >= 0
    assert int(a.tokens.max()) < tc.padded_vocab


# ------------------------------------------------------------------- init --

def test_init_meets_the_references_distributions():
    """The port's own draw: shapes and dtypes of the reference's tree, zero
    biases, unit norms, and each matrix's mean and std within 5% of the
    reference's scale (a matrix of n normals: the std's standard error is
    about std / sqrt(2n))."""
    cfg = dataclasses.replace(get_config("qwen2_7b").reduced(), d_model=256,
                              d_ff=512, num_heads=8, num_kv_heads=2,
                              head_dim=32, vocab_size=1024)
    lm = build_model(cfg, "cpu").init(seed=3)
    jax_shapes = jax.eval_shape(
        lambda: JT.init_lm(jax.random.PRNGKey(0), cfg)[0])
    d, h, hd, f = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim, cfg.d_ff
    scales = {"wq": d ** -0.5, "wk": d ** -0.5, "wv": d ** -0.5,
              "wo": (h * hd) ** -0.5, "w_gate": d ** -0.5,
              "w_up": d ** -0.5, "w_down": f ** -0.5}
    for lp in lm.layers:
        for group in ("norm1", "attn", "norm2", "ffn"):
            for name, t in lp[group].items():
                want = jax_shapes["layers"][group][name]
                assert tuple(t.shape) == want.shape[1:], (group, name)
                assert t.dtype == torch.float32
                if name in scales:
                    assert abs(float(t.mean())) < 0.05 * scales[name]
                    assert abs(float(t.std()) / scales[name] - 1) < 0.05
                elif name == "scale":
                    assert bool((t == 1).all())
                else:
                    assert bool((t == 0).all()), name
    for name in ("embed", "lm_head"):
        t = lm[name]
        assert tuple(t.shape) == jax_shapes[name].shape
        assert abs(float(t.std()) * d ** 0.5 - 1) < 0.05
    assert bool((lm["final_norm"]["scale"] == 1).all())
    # bfloat16 storage at the configured dtype; the same seed, same draw
    lb = build_model(dataclasses.replace(cfg, dtype="bfloat16"), "cpu").init(
        seed=3)
    assert lb.layers[0]["attn"]["wq"].dtype == torch.bfloat16
    assert lb.layers[0]["norm1"]["scale"].dtype == torch.float32
    torch.testing.assert_close(lb.layers[0]["attn"]["wq"].float(),
                               lm.layers[0]["attn"]["wq"].bfloat16().float(),
                               rtol=0, atol=0)


def test_cache_kinds_and_ring_size():
    _, tc = _cfgs(True, window=8)
    caches = T.init_cache(tc, 3, 20)
    assert len(caches) == tc.num_layers
    c = caches[0]
    assert isinstance(c, L.QuantKVCache) and c.k.shape == (3, 8, 2, 16)
    assert c.k.dtype == torch.int8 and c.k_scale.dtype == torch.float32
    # separate buffers: writing K leaves V alone
    assert c.k.data_ptr() != c.v.data_ptr()
    assert c.k_scale.data_ptr() != c.v_scale.data_ptr()
    _, plain = _cfgs(False)
    kc = T.init_cache(plain, 1, 5)[1]
    assert isinstance(kc, L.KVCache) and kc.k.shape == (1, 5, 2, 16)
