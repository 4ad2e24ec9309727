"""Parity of the port's encoder-decoder (``whisper_medium``) and VLM
(``internvl2_76b``) families with the JAX package, on the CPU.

The same inputs (numpy from a seed, the token pipeline's batches, which
are bit-identical, and the reference's own parameters carried across with
``convert.lm_params_from_numpy`` / ``train_state_from_numpy``) go through
``repro`` and ``repro_torch``: the stub frontends' frames and patches,
``encode`` and its ``enc`` block, the ``dec_cross`` block (train, prefill,
decode), ``Model.loss`` and its gradients, one ``make_train_step`` step,
prefill then decode, the conversion of both trees, ``_cast_bf16``, and
both launchers. Both sides run the reduced configs in float32.

The reference's decode keeps a ``dec_cross`` layer's cross K/V in a
``max_len``-row buffer of zeros whose head prefill fills, and attends every
row (F4, ROADMAP.md Queue 3); the port keeps the memory's own rows. So the
reference's decode is run here on its cache with the cross K/V cut to the
memory's length (a correct cache), and the port's decode is also held
against the teacher-forced ``forward_train``; one test pins the smallest
case where the reference's own decode differs.

Tolerances (the two libraries sum in different orders): tokens, frames
and patches exact; a block's activations rtol / atol 1e-5; logits through
a model rtol / atol 1e-4, losses rtol 1e-6; gradients rtol 1e-4 / atol
1e-6; a train step's parameters as ``tests/test_torch_train.py`` holds
them (tight where the reference's gradient exceeds 1e-5, within 2 lr
elsewhere); the port against itself (remat policies, checkpoint resume)
exact.

Every test that runs JAX model code first clears ``repro.dist.sharding``'s
global mesh; none calls a JAX launcher.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data.tokens import TokenPipeline as JaxTokenPipeline
from repro.dist.sharding import set_mesh
from repro.models import transformer as JT
from repro.models.model_zoo import build_model as jax_build_model
from repro.train import optimizer as JO
from repro.train import train_step as JS
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy, train_state_from_numpy
from repro_torch.data import tokens as tokens_mod
from repro_torch.data.tokens import TokenPipeline
from repro_torch.dist.checkpoint import CheckpointManager
from repro_torch.kernels.decode_attention import (
    decode_attention,
    decode_attention_plain,
)
from repro_torch.kernels.imc_mvm import imc_mvm_plain
from repro_torch.launch import serve
from repro_torch.launch import train as train_cli
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.model_zoo import build_model
from repro_torch.train import optimizer as O
from repro_torch.train.train_step import (
    TrainConfig,
    init_train_state,
    make_train_step,
)
from repro_torch.train.train_step import _cast_bf16

torch.set_num_threads(1)

ARCHS = ("whisper_medium", "internvl2_76b")
WHISPER, VLM = ARCHS
B, S = 4, 32
RTOL = ATOL = 1e-5
MODEL_TOL = 1e-4


@pytest.fixture(autouse=True)
def no_global_mesh():
    set_mesh(None)
    yield


def _cfgs(arch, **kw):
    jc = dataclasses.replace(jax_get_config(arch).reduced(), **kw)
    tc = dataclasses.replace(get_config(arch).reduced(), **kw)
    return jc, tc


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.cache
def _ref_init(arch):
    """The reference's initial TrainState (PRNGKey(0)) of the reduced
    config, as numpy; made once per architecture."""
    set_mesh(None)
    jc, _ = _cfgs(arch)
    state, _ = JS.init_train_state(jax_build_model(jc), jax.random.PRNGKey(0))
    return (_np(state.params), _np(state.opt["mu"]), _np(state.opt["nu"]))


def _models(arch, **kw):
    """(reference config, port config, reference model, its parameters
    (jnp), port model, the same parameters in the port's serving store)."""
    jc, tc = _cfgs(arch, **kw)
    params = _ref_init(arch)[0]
    return (jc, tc, jax_build_model(jc), jax.tree.map(jnp.asarray, params),
            build_model(tc, "cpu"), lm_params_from_numpy(params, tc, "cpu"))


def _ref_leaf(tree, name):
    """The reference leaf behind a port parameter name:
    ``layers.1.xattn.wq`` -> ``tree["layers"]["xattn"]["wq"][1]``,
    ``enc_layers.0.ffn.b_up`` -> ``tree["enc_layers"]["ffn"]["b_up"][0]``."""
    parts = name.split(".")
    if parts[0] in ("layers", "enc_layers"):
        node = tree[parts[0]]
        for p in parts[2:]:
            node = node[p]
        return node[int(parts[1])]
    node = tree
    for p in parts:
        node = node[p]
    return node


def _batch(arch, step=0, batch=B, seq=S):
    """The reference's and the port's batches, checked bit for bit."""
    jc, tc = _cfgs(arch)
    j = JaxTokenPipeline(batch, seq, jc.vocab_size).get_for(jc, step)
    t = TokenPipeline(batch, seq, tc.vocab_size).get_for(tc, step, "cpu")
    assert set(t) == set(j)
    for k in j:
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))
    return j, t


def _close(got, want, tol=RTOL, err_msg=""):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol,
                               err_msg=err_msg)


def _layer(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


# --------------------------------------------------------------- pipeline --

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("step,seed", [(0, 0), (3, 5), (2**31 - 1, 123_456)])
def test_embedding_batches_are_bit_exact(arch, dtype, step, seed):
    """``get_for`` at full d_model (1,024 and 8,192): the VLM's patches and
    tokens, the encoder-decoder's frames and tokens, bit for bit."""
    jc = dataclasses.replace(jax_get_config(arch), dtype=dtype)
    tc = dataclasses.replace(get_config(arch), dtype=dtype)
    want = JaxTokenPipeline(2, 48, jc.vocab_size, seed).get_for(jc, step)
    got = TokenPipeline(2, 48, tc.vocab_size, seed).get_for(tc, step, "cpu")
    emb = "patches" if arch == VLM else "frames"
    n = 48 // 8 if arch == VLM else 24
    assert got[emb].shape == (2, n, tc.d_model)
    assert got[emb].dtype == getattr(torch, dtype)
    assert got["tokens"].dtype == torch.int32
    for k in (emb, "tokens"):
        np.testing.assert_array_equal(
            got[k].float().numpy() if k == emb else got[k].numpy(),
            np.asarray(jnp.asarray(want[k]).astype(jnp.float32))
            if k == emb else np.asarray(want[k]))


@pytest.mark.parametrize("steps", [(0, 1, 2), (7, 8)])
def test_pipeline_steps_differ_and_repeat(steps):
    """Each step draws new embeddings; the same step draws the same."""
    pipe = TokenPipeline(2, 16, 256)
    for get in (lambda s: pipe.vlm_get(s, 64, 8, torch.bfloat16, "cpu"),
                lambda s: pipe.encdec_get(s, 64, torch.bfloat16, "cpu")):
        out = [get(s) for s in steps]
        key = "patches" if "patches" in out[0] else "frames"
        for a, b in zip(out, out[1:]):
            assert not torch.equal(a[key], b[key])
        assert torch.equal(get(steps[0])[key], out[0][key])


def test_bfloat16_scale_is_the_rounded_constant():
    """The reference rounds the weak 0.02 to bfloat16 before the product;
    a bfloat16 tensor times the Python float 0.02 rounds other elements
    (about 18% of them), so the port multiplies by the rounded
    constant."""
    got = TokenPipeline(2, 64, 256).encdec_get(1, 1024, torch.bfloat16,
                                               "cpu")["frames"]
    want = np.asarray(JaxTokenPipeline(2, 64, 256).encdec_get(
        1, 1024, jnp.bfloat16)["frames"].astype(jnp.float32))
    np.testing.assert_array_equal(got.float().numpy(), want)
    idx = torch.arange(2 * 32 * 1024)
    h = tokens_mod._hash2(idx, torch.full((1,), 1 + 7))
    unit = (h.double().float() / 2.0**31 - 1.0).bfloat16()
    naive = (unit * 0.02).float().numpy().reshape(want.shape)
    assert (naive != want).mean() > 0.05


def test_embedding_index_past_uint32_raises():
    with pytest.raises(ValueError, match="2\\*\\*32"):
        TokenPipeline(2**16, 16, 256).vlm_get(0, 2**16, 2, torch.float32,
                                              "cpu")


# ---------------------------------------------------------------- encoder --

@pytest.mark.parametrize("remat", ["full", "dots", "none"])
@pytest.mark.parametrize("frames", [8, 13])
def test_encode_matches(remat, frames):
    """Sinusoids, the ``enc`` stack and ``enc_norm`` over random frames."""
    jc, tc, _, jp, _, tp = _models(WHISPER)
    x = np.random.default_rng(frames).normal(
        size=(2, frames, 64)).astype(np.float32)
    want = JT.encode(jp, jnp.asarray(x), jc, remat=remat)
    got = T.encode(tp, _t(x), tc, remat=remat)
    assert got.shape == (2, frames, 64) and got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("imc", [False, True])
@pytest.mark.parametrize("layer", [0, 1])
def test_enc_block_train_matches(imc, layer):
    """One non-causal ``enc`` block (RoPE on its self-attention)."""
    jc, tc, _, jp, _, _ = _models(WHISPER, imc_linear=imc)
    tp = lm_params_from_numpy(_ref_init(WHISPER)[0], tc, "cpu")
    x = np.random.default_rng(4).normal(size=(2, 12, 64)).astype(np.float32)
    want = JT.apply_block_train(_layer(jp["enc_layers"], layer),
                                jnp.asarray(x), jc, "enc")
    got = T.apply_block_train(tp.enc_layers[layer], _t(x), tc, "enc")
    _close(got, want)
    # non-causal: the first position sees the last
    y = x.copy()
    y[:, -1] = np.random.default_rng(5).normal(size=(2, 64))
    moved = T.apply_block_train(tp.enc_layers[layer], _t(y), tc, "enc")
    assert not torch.allclose(moved[:, 0], got[:, 0])


# -------------------------------------------------------------- dec_cross --

def _dec_inputs(seed=0, s_dec=10, s_enc=7):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, s_dec, 64)).astype(np.float32)
    mem = rng.normal(size=(2, s_enc, 64)).astype(np.float32)
    return x, mem


@pytest.mark.parametrize("imc", [False, True])
@pytest.mark.parametrize("layer", [0, 1])
def test_dec_cross_block_train_matches(imc, layer):
    jc, tc = _cfgs(WHISPER, imc_linear=imc)
    jp = jax.tree.map(jnp.asarray, _ref_init(WHISPER)[0])
    tp = lm_params_from_numpy(_ref_init(WHISPER)[0], tc, "cpu")
    x, mem = _dec_inputs(layer)
    want = JT.apply_block_train(_layer(jp["layers"], layer), jnp.asarray(x),
                                jc, "dec_cross", memory=jnp.asarray(mem))
    got = T.apply_block_train(tp.layers[layer], _t(x), tc, "dec_cross",
                              memory=_t(mem))
    _close(got, want)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_dec_cross_block_prefill_then_decode_matches(kv_quant):
    """Prefill 10 positions against 7 memory rows, then 6 decode steps: the
    outputs equal the reference's ``apply_block_prefill`` and
    ``apply_block_decode``, the latter fed the reference's cache with its
    cross K/V cut to the memory's 7 rows (a correct cache); the port's
    cross K/V equal the reference's rows and keep the memory's length."""
    jc, tc = _cfgs(WHISPER, kv_quant_int8=kv_quant)
    jp = _layer(jax.tree.map(jnp.asarray, _ref_init(WHISPER)[0])["layers"], 1)
    tp = lm_params_from_numpy(_ref_init(WHISPER)[0], tc, "cpu").layers[1]
    x, mem = _dec_inputs(3, s_dec=16)
    s0, max_len = 10, 16
    jcache = JT.init_block_cache(jc, "dec_cross", 2, max_len)
    tcache = T.init_block_cache(tc, "dec_cross", 2, max_len)
    assert tcache[1].k.shape == (2, 0, 2, 16)
    yj, jcache = JT.apply_block_prefill(jp, jnp.asarray(x[:, :s0]), jc,
                                        "dec_cross", jcache,
                                        memory=jnp.asarray(mem))
    yt, tcache = T.apply_block_prefill(tp, _t(x[:, :s0]), tc, "dec_cross",
                                       tcache, memory=_t(mem))
    _close(yt, yj)
    kvc, xkv = tcache
    assert isinstance(xkv, T.CrossKV) and xkv.k.shape == (2, 7, 2, 16)
    assert xkv.k.dtype == torch.float32
    _close(xkv.k, jcache[1][0])
    _close(xkv.v, jcache[1][1])
    jcache = (jcache[0], tuple(a[:, :7] for a in jcache[1]))
    for pos in range(s0, max_len):
        yj, jcache = JT.apply_block_decode(jp, jnp.asarray(x[:, pos:pos + 1]),
                                           jc, "dec_cross", jcache,
                                           jnp.asarray(pos, jnp.int32))
        yt, tcache = T.apply_block_decode(tp, _t(x[:, pos:pos + 1]), tc,
                                          "dec_cross", tcache, pos)
        _close(yt, yj, err_msg=str(pos))
    assert tcache[1] is xkv


def test_dec_cross_decode_before_a_prefill_raises():
    _, tc = _cfgs(WHISPER)
    tp = T.init_block(tc, "dec_cross")
    cache = T.init_block_cache(tc, "dec_cross", 1, 8)
    with pytest.raises(ValueError, match="prefill"):
        T.apply_block_decode(tp, torch.zeros(1, 1, 64), tc, "dec_cross",
                             cache, 0)
    for fn in (T.apply_block_prefill, T.apply_block_decode):
        with pytest.raises(ValueError, match="enc"):
            fn(tp, torch.zeros(1, 1, 64), tc, "enc", cache, 0)


# ------------------------------------------------------------ whole models --

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("imc", [False, True])
def test_model_loss_and_grads_match(arch, imc):
    """``Model.loss`` (the VLM's text positions; the encoder-decoder's
    decoder over the encoded frames) and its gradients against
    ``jax.grad`` of the reference's loss, encoder leaves and ``enc_norm``
    included."""
    jc, tc = _cfgs(arch, imc_linear=imc)
    jb, tb = _batch(arch, 2)
    params = _ref_init(arch)[0]
    want, jgrads = jax.value_and_grad(
        lambda p: jax_build_model(jc).loss(p, jb))(
            jax.tree.map(jnp.asarray, params))
    lm = train_state_from_numpy(*_ref_init(arch), 0, tc, "cpu").params
    loss = build_model(tc, "cpu").loss(lm, tb)
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-6)
    names = [n for n, _ in lm.named_parameters()]
    assert any(n.startswith("enc_") for n in names) == (arch == WHISPER)
    grads = torch.autograd.grad(loss, list(lm.parameters()))
    jgrads = _np(jgrads)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), _ref_leaf(jgrads, name),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_matches(arch):
    """The decoder's (or the VLM's embedded) full-sequence logits."""
    jc, tc, _, jp, _, tp = _models(arch)
    jb, tb = _batch(arch, 1)
    if arch == WHISPER:
        want = JT.forward_train(jp, jb["tokens"], jc,
                                memory=JT.encode(jp, jb["frames"], jc))
        got = T.forward_train(tp, tb["tokens"], tc,
                              memory=T.encode(tp, tb["frames"], tc))
    else:
        x = np.random.default_rng(2).normal(size=(B, 12, 64)).astype(
            np.float32)
        want = JT.forward_train(jp, jnp.asarray(x), jc, is_embedded=True)
        got = T.forward_train(tp, _t(x), tc, is_embedded=True)
    _close(got, want, MODEL_TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cast_bf16", [False, True])
def test_train_step_matches_the_reference(arch, cast_bf16):
    """One ``make_train_step`` step, with and without ``cast_params_bf16``
    (the stacked encoder's norm scales and FFN biases cast too): loss,
    grad_norm and the parameters after the update."""
    jc, tc = _cfgs(arch)
    params, mu, nu = _ref_init(arch)
    opt = dict(lr=1e-3, warmup_steps=1)
    jb, tb = _batch(arch, 0)
    jmodel = jax_build_model(jc)
    jstate = JS.TrainState(
        params=jax.tree.map(jnp.asarray, params),
        opt={"mu": jax.tree.map(jnp.asarray, mu),
             "nu": jax.tree.map(jnp.asarray, nu),
             "step": jnp.zeros((), jnp.int32)},
        step=jnp.zeros((), jnp.int32))

    def jloss(p):
        if cast_bf16:
            p = jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                             if (a.dtype == jnp.float32 and a.ndim > 1)
                             else a, p)
        return jmodel.loss(p, jb)

    jgrads = _np(jax.grad(jloss)(jstate.params))
    jstate, jm = jax.jit(JS.make_train_step(jmodel, JS.TrainConfig(
        optimizer=JO.AdamWConfig(**opt), cast_params_bf16=cast_bf16)))(
            jstate, jb)
    step = make_train_step(build_model(tc, "cpu"), TrainConfig(
        optimizer=O.AdamWConfig(**opt), cast_params_bf16=cast_bf16))
    state, m = step(train_state_from_numpy(params, mu, nu, 0, tc, "cpu"), tb)
    assert state.step == 1 and set(m) == set(jm)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-5)
    assert m["dcn_raw_bytes"] == float(jm["dcn_raw_bytes"])
    ref = _np(jstate.params)
    for name, p in state.params.named_parameters():
        want = _ref_leaf(ref, name)
        g = np.abs(_ref_leaf(jgrads, name))
        d = np.abs(p.detach().numpy() - want)
        firm = g > 1e-5
        assert (d[firm] <= 1e-6 + 1e-5 * np.abs(want[firm])).all(), name
        assert (d <= 2 * opt["lr"] + 1e-6).all(), name


@pytest.mark.parametrize("arch", ARCHS)
def test_microbatches_split_every_input(arch):
    """Two microbatches slice the frames or patches with the tokens: the
    loss is the mean of the halves' (the reference's own tolerance)."""
    _, tc = _cfgs(arch)
    model = build_model(tc, "cpu")
    _, tb = _batch(arch, 0)
    out = {}
    for mb in (1, 2):
        step = make_train_step(model, TrainConfig(microbatches=mb))
        _, m = step(init_train_state(model, 0), tb)
        out[mb] = float(m["loss"])
    lm = model.init(0, trainable=True)
    halves = [float(model.loss(lm, {k: v[i:i + B // 2]
                                    for k, v in tb.items()}).detach())
              for i in (0, B // 2)]
    np.testing.assert_allclose(out[2], np.mean(halves), rtol=1e-6)
    np.testing.assert_allclose(out[2], out[1], rtol=2e-3, atol=2e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_policies_give_equal_loss_and_grads(arch):
    _, tc = _cfgs(arch)
    model = build_model(tc, "cpu")
    lm = model.init(0, trainable=True)
    _, tb = _batch(arch, 0, batch=2)
    out = {}
    for remat in ("full", "dots", "none"):
        loss = model.loss(lm, tb, remat=remat)
        out[remat] = (float(loss.detach()), torch.autograd.grad(
            loss, list(lm.parameters())))
    for remat in ("full", "dots"):
        assert out[remat][0] == out["none"][0]
        for a, b in zip(out[remat][1], out["none"][1]):
            assert torch.equal(a, b)


# --------------------------------------------------------- prefill, decode --

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kv_quant", [False, True])
def test_prefill_matches_the_reference(arch, kv_quant):
    jc, tc, jm, jp, tm, tp = _models(arch, kv_quant_int8=kv_quant)
    jb, tb = _batch(arch, 0, batch=2, seq=16)
    lj, _ = jm.prefill(jp, jb, jm.init_cache(2, 22))
    lt, cache = tm.prefill(tp, tb, tm.init_cache(2, 22))
    assert lt.shape == lj.shape
    _close(lt, lj, MODEL_TOL)
    last, _ = tm.prefill(tp, tb, tm.init_cache(2, 22), last_only=True)
    _close(last, lt[:, -1:])
    if arch == WHISPER:
        for kvc, xkv in cache:
            assert xkv.k.shape == (2, 8, 2, 16) and kvc.k.shape[1] == 22


def _ref_decode(jm, jp, jb, gen, start, max_len, cut=True):
    """The reference's prefill and ``gen - 1`` greedy decode steps (cross
    K/V cut to the memory's rows with ``cut``): the tokens and each
    step's logits."""
    cache = jm.init_cache(jb["tokens"].shape[0], max_len)
    logits, cache = jm.prefill(jp, jb, cache)
    if cut and "frames" in jb:
        n = jb["frames"].shape[1]
        cache = (cache[0], tuple(a[:, :, :n] for a in cache[1]))
    tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    toks, steps = [tok], []
    for i in range(gen - 1):
        logits, cache = jm.decode_step(jp, tok, cache,
                                       jnp.asarray(start + i, jnp.int32))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        toks.append(tok)
        steps.append(np.asarray(logits))
    return np.asarray(jnp.concatenate(toks, axis=1)), steps


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kv_quant", [False, True])
def test_served_decode_matches_the_reference(arch, kv_quant):
    """``serve.generate`` on the reference's parameters and batch: the
    decode starts at P + St (VLM) or St (the decoder's tokens), the cache
    holds the prompt (patches and tokens, or frames and tokens) and gen
    more; every step's logits equal the reference's ``decode_step`` (for
    Whisper on its correct cache) and the greedy tokens equal."""
    jc, tc, jm, jp, tm, tp = _models(arch, kv_quant_int8=kv_quant)
    jb, tb = _batch(arch, 0, batch=2, seq=16)
    gen = 6
    start = 16 if arch == VLM else 8
    want_tok, want = _ref_decode(jm, jp, jb, gen, start, 16 + gen)
    launches = decode_attention.launches
    run = serve.generate(tm, tp, tb, gen, keep_logits=True)
    assert decode_attention.launches == launches      # CPU: plain version
    assert run.start == start and run.cache_len == 16 + gen
    for got, w in zip(run.logits, want):
        _close(got, w, MODEL_TOL)
    np.testing.assert_array_equal(run.tokens.numpy(), want_tok)


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("frames,tokens", [(8, 8), (5, 12)])
def test_encdec_decode_equals_teacher_forced_forward_train(kv_quant, frames,
                                                           tokens):
    """F4: each decode step of the port's Whisper equals the reference's
    ``forward_train`` over the prompt and the generated tokens, with the
    memory of ``encode(frames)``, at that position (int8 store: rtol /
    atol 2e-2 of the largest logit, the K/V's quantization)."""
    jc, tc, jm, jp, tm, tp = _models(WHISPER, kv_quant_int8=kv_quant)
    rng = np.random.default_rng(frames)
    batch = {"frames": rng.normal(size=(2, frames, 64)).astype(np.float32)
             * 0.1,
             "tokens": rng.integers(0, 256, (2, tokens)).astype(np.int32)}
    gen = 6
    run = serve.generate(tm, tp, {k: _t(v) for k, v in batch.items()}, gen,
                         keep_logits=True)
    assert run.cache_len == frames + tokens + gen
    seq = np.concatenate([batch["tokens"], run.tokens.numpy()], axis=1)
    memory = JT.encode(jp, jnp.asarray(batch["frames"]), jc)
    full = np.asarray(JT.forward_train(jp, jnp.asarray(seq), jc,
                                       memory=memory))
    tol = 2e-2 if kv_quant else MODEL_TOL
    for i, got in enumerate(run.logits):
        want = full[:, tokens + i:tokens + i + 1]
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got.numpy(), want, rtol=tol,
                                   atol=tol * scale, err_msg=str(i))


def test_f4_reference_decode_attends_the_zero_rows():
    """The smallest F4 case: 8 memory rows in a 12-row cache. The
    reference's own decode at position 8 (its cross K/V zero-padded to 12
    rows) differs from its teacher-forced ``forward_train``; the port's
    equals it."""
    jc, tc, jm, jp, tm, tp = _models(WHISPER)
    jb, tb = _batch(WHISPER, 0, batch=2, seq=16)
    want_full = None
    for cut in (False, True):
        toks, steps = _ref_decode(jm, jp, jb, 2, 8, 12, cut=cut)
        seq = np.concatenate([np.asarray(jb["tokens"]), toks[:, :1]], axis=1)
        if want_full is None:
            want_full = np.asarray(JT.forward_train(
                jp, jnp.asarray(seq), jc,
                memory=JT.encode(jp, jb["frames"], jc)))[:, 8:9]
        diff = float(np.abs(steps[0] - want_full).max())
        top = float(np.abs(want_full).max())
        if cut:
            assert diff < MODEL_TOL * top
        else:
            # a third of the largest |logit| (0.99 of 2.90)
            assert diff > 0.25 * top, (diff, top)
    cache = tm.init_cache(2, 12)
    logits, cache = tm.prefill(tp, tb, cache, last_only=True)
    tok = logits.argmax(-1).to(torch.int32)
    assert all(xkv.k.shape[1] == 8 for _, xkv in cache)
    got, _ = tm.decode_step(tp, tok, cache, 8)
    _close(got, want_full, MODEL_TOL)


# ------------------------------------------------------------- conversion --

@pytest.mark.parametrize("arch", ARCHS)
def test_lm_params_from_numpy_round_trips(arch):
    """Every reference leaf lands under its name, values equal; the
    decoder's ``dec_cross`` groups and the encoder's ``enc`` groups; in
    bfloat16 storage the norms stay float32."""
    jc, tc = _cfgs(arch)
    params = _ref_init(arch)[0]
    lm = lm_params_from_numpy(params, tc, "cpu")
    flat = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    assert sum(p.numel() for p in lm.parameters()) == sum(
        a.size for a in flat.values())
    for name, p in lm.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      _ref_leaf(params, name), err_msg=name)
    groups = set(lm.layers[0])
    if arch == WHISPER:
        assert groups == {"norm1", "attn", "norm_x", "xattn", "norm2", "ffn"}
        assert len(lm.enc_layers) == tc.num_encoder_layers == 2
        assert set(lm.enc_layers[0]) == {"norm1", "attn", "norm2", "ffn"}
        assert set(lm.enc_norm) == {"scale", "bias"}
    else:
        assert groups == {"norm1", "attn", "norm2", "ffn"}
        assert lm.enc_layers is None and lm.enc_norm is None
    bf = lm_params_from_numpy(params, dataclasses.replace(
        tc, dtype="bfloat16"), "cpu")
    for name, p in bf.named_parameters():
        norm = ".norm" in name or name.startswith(("final_norm", "enc_norm"))
        assert p.dtype == (torch.float32 if norm else torch.bfloat16), name


@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_from_numpy_carries_the_moments(arch):
    params, mu, nu = _ref_init(arch)
    _, tc = _cfgs(arch)
    mu = jax.tree.map(lambda a: a + 0.25, mu)
    nu = jax.tree.map(lambda a: a + 0.5, nu)
    st = train_state_from_numpy(params, mu, nu, 3, tc, "cpu")
    assert st.step == 3 and st.opt["step"] == 3
    names = [n for n, _ in st.params.named_parameters()]
    assert len(names) == len(st.opt["mu"]) == len(st.opt["nu"])
    for name, m, v, p in zip(names, st.opt["mu"], st.opt["nu"],
                             st.params.parameters()):
        assert p.requires_grad and p.dtype == torch.float32
        np.testing.assert_array_equal(m.numpy(), _ref_leaf(mu, name))
        np.testing.assert_array_equal(v.numpy(), _ref_leaf(nu, name))


def test_cast_bf16_casts_the_stacked_encoder_vectors():
    """The reference's ``enc_layers`` leaves carry the layer axis, so the
    encoder's norm scales and biases and FFN biases are cast to bfloat16;
    ``enc_norm`` (D,) and ``final_norm`` stay float32."""
    _, tc = _cfgs(WHISPER)
    lm = train_state_from_numpy(*_ref_init(WHISPER), 0, tc, "cpu").params
    tree = _cast_bf16(lm)
    enc = tree["enc_layers"][1]
    for group, name in (("norm1", "scale"), ("norm2", "bias"),
                        ("ffn", "b_up"), ("ffn", "b_down"),
                        ("attn", "wq")):
        assert enc[group][name].dtype == torch.bfloat16, (group, name)
    assert tree["layers"][0]["norm_x"]["scale"].dtype == torch.bfloat16
    assert all(t.dtype == torch.float32 for t in tree["enc_norm"].values())
    assert all(t.dtype == torch.float32
               for t in tree["final_norm"].values())
    # gradients reach the float32 encoder leaves through the cast
    _, tb = _batch(WHISPER, 0, batch=2, seq=16)
    loss = build_model(tc, "cpu").loss(tree, tb)
    (g,) = torch.autograd.grad(loss, [lm.enc_layers[0]["ffn"]["w_up"]])
    assert g.dtype == torch.float32 and bool((g != 0).any())


# ------------------------------------------------------------ layouts ------

@pytest.mark.parametrize("arch", ARCHS)
def test_builds_with_the_references_block_kinds(arch):
    """``block_kind`` is the reference's (``attn_ffn`` for both families);
    the encoder-decoder's decoder stack is ``dec_cross`` and its cache
    pairs a KV cache with empty cross K/V; the VLM's is a plain KV
    cache."""
    cfg = get_config(arch)
    jc = jax_get_config(arch)
    assert [T.block_kind(cfg, i) for i in range(cfg.num_layers)] == [
        JT.block_kind(jc, i) for i in range(jc.num_layers)]
    tc = dataclasses.replace(cfg.reduced(), kv_quant_int8=True)
    lm = build_model(tc, "cpu").init(0)
    caches = T.init_cache(tc, 2, 20)
    if arch == WHISPER:
        assert [T.decoder_kind(tc, i) for i in range(2)] == ["dec_cross"] * 2
        for kvc, xkv in caches:
            assert isinstance(kvc, L.QuantKVCache) and kvc.k.shape[1] == 20
            assert xkv.k.shape == (2, 0, 2, 16) and xkv.k.dtype == torch.float32
        assert len(lm.enc_layers) == 2
    else:
        assert all(isinstance(c, L.QuantKVCache) for c in caches)
        assert lm.enc_layers is None


# -------------------------------------------------------------- launchers --

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kv_quant", [False, True])
def test_serve_launcher_runs_on_the_cpu(arch, kv_quant, capsys):
    """With ``--kv-quant`` the decode runs the plain ``decode_attention``
    (one call a layer a step, no launch)."""
    args = ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
            "--prompt-len", "16", "--gen", "4"]
    calls, launches = decode_attention_plain.calls, decode_attention.launches
    run = serve.main(args + (["--kv-quant"] if kv_quant else []))
    out = capsys.readouterr().out
    for line in ("prefill:", "decode:", "tokens/s",
                 "decode_attention launches: 0", "generated token ids"):
        assert line in out, out
    assert ("(+ 2 encoder)" in out) == (arch == WHISPER)
    assert run.tokens.shape == (2, 4) and run.tokens.dtype == torch.int32
    assert set(run.batch) == ({"frames", "tokens"} if arch == WHISPER
                              else {"patches", "tokens"})
    assert decode_attention.launches == launches
    assert (decode_attention_plain.calls - calls
            == (2 * 3 if kv_quant else 0))
    again = serve.main(args + (["--kv-quant"] if kv_quant else []))
    torch.testing.assert_close(again.tokens, run.tokens, rtol=0, atol=0)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("imc", [False, True])
def test_train_launcher_runs_on_the_cpu(arch, imc, capsys):
    """With ``--imc-linear`` every FFN down-projection runs the plain
    ``imc_mvm`` on the CPU: Whisper's 2 encoder and 2 decoder layers, the
    VLM's 2, once a step each (remat recomputes no analog chain)."""
    calls = imc_mvm_plain.calls
    state = train_cli.main(["--arch", arch, "--reduced", "--steps", "2",
                            "--device", "cpu", "--batch", "2", "--seq",
                            "16", "--log-every", "1"]
                           + (["--imc-linear"] if imc else []))
    out = capsys.readouterr().out
    assert "step 2: loss=" in out and "done: 2 steps" in out
    assert state.step == 2
    per_step = (4 if arch == WHISPER else 2) if imc else 0
    assert imc_mvm_plain.calls - calls == 2 * per_step


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_resume_exact(arch, tmp_path):
    """2 steps + save + restore (into a state of another draw) + 1 equals
    3 steps straight, encoder leaves included."""
    _, tc = _cfgs(arch)
    model = build_model(tc, "cpu")
    step_fn = make_train_step(model, TrainConfig(
        optimizer=O.AdamWConfig(lr=1e-3)))
    pipe = TokenPipeline(2, 16, tc.vocab_size)

    def run(state, start, stop):
        for s in range(start, stop):
            state, _ = step_fn(state, pipe.get_for(tc, s, "cpu"))
        return state

    state_a = run(init_train_state(model, 0), 0, 3)
    mgr = CheckpointManager(tmp_path)
    mgr.save(2, run(init_train_state(model, 0), 0, 2))
    step, state_c = mgr.restore_latest(init_train_state(model, seed=1))
    assert step == 2
    state_c = run(state_c, 2, 3)
    leaves = [(list(s.params.parameters()) + s.opt["mu"] + s.opt["nu"])
              for s in (state_a, state_c)]
    assert len(leaves[0]) == len(leaves[1])
    for a, b in zip(*leaves):
        assert torch.equal(a, b)
