"""Parity of the port's training slice with the JAX package, on the CPU.

The same inputs (numpy from a seed, the reference's own initial
``TrainState`` carried across with ``convert.train_state_from_numpy``, and
the token pipeline's batches, which are bit-identical) go through
``repro`` and ``repro_torch``: ``attention_train``, a block,
``forward_train`` under each remat policy, ``Model.loss`` and its
gradients, the schedule, ``adamw_update`` on identical gradients, and one
``make_train_step`` step (exact and with ``imc_linear``, one microbatch
and two). Both sides run ``qwen2_7b.reduced()`` in float32. Then the
port's own behaviour the reference's trainer tests pin: microbatching,
remat, the bfloat16 parameter cast, training with ``imc_linear``, exact
checkpoint resume, the checkpoint manager, the straggler monitor, the
branches that raise, and the launcher on the CPU.

Tolerances, float32 (the two libraries sum in different orders, and XLA
fuses multiply-adds on the CPU):
- activations, logits and losses: rtol / atol 1e-5 (1e-4 through a model);
- gradients of the loss: rtol 1e-4, atol 1e-6 (their largest is ~0.2);
- schedule, and ``adamw_update`` on identical gradients: rtol 2e-6;
  moments atol 1e-8, parameters atol 1e-7 (one ulp of the clip scale or
  of a bias correction moves every element by an ulp);
- one train step: loss and grad_norm rtol 1e-6; parameters rtol 1e-5 /
  atol 1e-6 where the reference's gradient is larger than 1e-5 in
  magnitude, and within 2 lr elsewhere: AdamW's first update is
  ``lr * g / (|g| + eps)``, so a gradient near ``eps`` (or near 0, whose
  sign is rounding noise) moves its weight by up to a whole ``lr`` on
  either side;
- the port against itself: remat policies, checkpoint resume and the
  in-place / out-of-place FFN are exact; microbatches 2 against 1 rtol
  2e-3 / atol 2e-5 (the reference's own test).

Every test that runs JAX model code first clears ``repro.dist.sharding``'s
global mesh; none calls a JAX launcher.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data.tokens import TokenPipeline as JaxTokenPipeline
from repro.dist.sharding import set_mesh
from repro.dist.straggler import StragglerMonitor as JaxStragglerMonitor
from repro.models import layers as JL
from repro.models import model_zoo as JZ
from repro.models import transformer as JT
from repro.models.model_zoo import build_model as jax_build_model
from repro.train import optimizer as JO
from repro.train import train_step as JS
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy, train_state_from_numpy
from repro_torch.data.tokens import TokenPipeline
from repro_torch.dist.checkpoint import CheckpointManager
from repro_torch.dist.straggler import Action, StragglerMonitor
from repro_torch.kernels.imc_mvm import imc_mvm_plain
from repro_torch.launch import train as train_cli
from repro_torch.models import layers as L
from repro_torch.models import model_zoo as Z
from repro_torch.models import transformer as T
from repro_torch.models.model_zoo import Model, build_model
from repro_torch.train import optimizer as O
from repro_torch.train.train_step import (
    TrainConfig,
    TrainState,
    init_train_state,
    make_train_step,
    resolve_pods,
)
from repro_torch.train.train_step import _cast_bf16 as Z_cast

torch.set_num_threads(1)

RTOL = ATOL = 1e-5
B, S = 8, 64


@pytest.fixture(autouse=True)
def no_global_mesh():
    set_mesh(None)
    yield


def _cfgs(**kw):
    jc = dataclasses.replace(jax_get_config("qwen2_7b").reduced(), **kw)
    tc = dataclasses.replace(get_config("qwen2_7b").reduced(), **kw)
    return jc, tc


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def ref_init():
    """The reference's initial TrainState (PRNGKey(0)) as numpy."""
    set_mesh(None)
    jc, _ = _cfgs()
    state, _ = JS.init_train_state(jax_build_model(jc), jax.random.PRNGKey(0))
    return _np(state.params), _np(state.opt["mu"]), _np(state.opt["nu"])


def _port_state(ref_init, tc):
    params, mu, nu = ref_init
    return train_state_from_numpy(params, mu, nu, 0, tc, "cpu")


def _ref_leaf(tree, name):
    """The reference leaf behind a port parameter name
    (``layers.1.attn.wq`` -> ``tree["layers"]["attn"]["wq"][1]``)."""
    parts = name.split(".")
    if parts[0] == "layers":
        return tree["layers"][parts[2]][parts[3]][int(parts[1])]
    node = tree
    for p in parts:
        node = node[p]
    return node


def _batch(step=0, seq=S):
    jc, tc = _cfgs()
    j = JaxTokenPipeline(B, seq, jc.vocab_size).get_for(jc, step)
    t = TokenPipeline(B, seq, tc.vocab_size).get_for(tc, step, "cpu")
    np.testing.assert_array_equal(t["tokens"].numpy(), np.asarray(j["tokens"]))
    return j, t


# ---------------------------------------------------------------- layers --

@pytest.mark.parametrize("causal,window,threshold", [
    (True, 0, 8192), (False, 0, 8192), (True, 8, 8192),
    (True, 0, 16),      # past the threshold: the chunked route
    (True, 8, 16),
])
def test_attention_train_matches(ref_init, causal, window, threshold):
    jc, tc = _cfgs(sliding_window=window)
    p = {k: v[0] for k, v in ref_init[0]["layers"]["attn"].items()}
    x = np.random.default_rng(3).normal(size=(2, 32, 64)).astype(np.float32)
    want = JL.attention_train({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x), jc, causal=causal,
                              chunk_threshold=threshold)
    tp = torch.nn.ParameterDict({k: L._param(torch.from_numpy(np.array(v)))
                                 for k, v in p.items()})
    got = L.attention_train(tp, torch.from_numpy(x), tc, causal=causal,
                            chunk_threshold=threshold)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("imc", [False, True])
def test_apply_block_train_matches(ref_init, imc):
    jc, tc = _cfgs(imc_linear=imc)
    lp = jax.tree.map(lambda a: a[1], ref_init[0]["layers"])
    x = np.random.default_rng(4).normal(size=(2, 24, 64)).astype(np.float32)
    want = JT.apply_block_train(jax.tree.map(jnp.asarray, lp),
                                jnp.asarray(x), jc, "attn_ffn")
    lm = _port_state(ref_init, tc).params
    got = T.apply_block_train(lm.layers[1], torch.from_numpy(x), tc,
                              "attn_ffn")
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("remat", ["full", "dots", "none"])
def test_forward_train_matches(ref_init, remat):
    jc, tc = _cfgs()
    jb, tb = _batch(1)
    want = JT.forward_train(jax.tree.map(jnp.asarray, ref_init[0]),
                            jb["tokens"], jc, remat=remat)
    got = T.forward_train(_port_state(ref_init, tc).params, tb["tokens"], tc,
                          remat=remat)
    assert got.dtype == torch.float32 and got.shape == (B, S, 256)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


def test_forward_train_reads_a_bf16_view_like_the_lm(ref_init):
    """The train step's bfloat16 view (a plain mapping) runs the same
    forward as an LM holding those bfloat16-rounded values."""
    from repro_torch.train.train_step import _cast_bf16

    _, tc = _cfgs()
    lm = _port_state(ref_init, tc).params
    tokens = _batch(0)[1]["tokens"]
    got = T.forward_train(_cast_bf16(lm), tokens, tc, remat="none")
    rounded = lm_params_from_numpy(jax.tree.map(
        lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16)
                             .astype(jnp.float32)) if a.ndim > 1 else a,
        ref_init[0]), tc, "cpu")
    want = T.forward_train(rounded, tokens, tc, remat="none")
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_xent_matches(seed):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(3, 7, 50)) * 4).astype(np.float32)
    targets = rng.integers(0, 50, size=(3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) > 0.3 * seed).astype(np.float32)
    want = JZ._xent(jnp.asarray(logits), jnp.asarray(targets),
                    jnp.asarray(mask))
    got = Z._xent(torch.from_numpy(logits), torch.from_numpy(targets),
                  torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_xent_of_an_empty_mask_is_zero():
    z = Z._xent(torch.zeros(1, 2, 5), torch.zeros(1, 2, dtype=torch.int32),
                torch.zeros(1, 2))
    assert float(z) == 0.0


@pytest.mark.parametrize("imc", [False, True])
def test_model_loss_and_grads_match(ref_init, imc):
    jc, tc = _cfgs(imc_linear=imc)
    jb, tb = _batch(2)
    jparams = jax.tree.map(jnp.asarray, ref_init[0])
    want, jgrads = jax.value_and_grad(
        lambda p: jax_build_model(jc).loss(p, jb))(jparams)
    lm = _port_state(ref_init, tc).params
    loss = build_model(tc, "cpu").loss(lm, tb)
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-6)
    names = [n for n, _ in lm.named_parameters()]
    grads = torch.autograd.grad(loss, list(lm.parameters()))
    jgrads = _np(jgrads)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), _ref_leaf(jgrads, name),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_encdec_and_vlm_losses_on_qwen_widths():
    """The vlm family and an encoder-decoder on Qwen's reduced widths take
    their ``get_for`` batches: finite losses with gradients for every
    leaf, the encoder's included."""
    for kw in ({"family": "vlm"},
               {"family": "audio", "is_encoder_decoder": True,
                "num_encoder_layers": 2}):
        cfg = dataclasses.replace(get_config("qwen2_7b").reduced(), **kw)
        model = build_model(cfg, "cpu")
        lm = model.init(0, trainable=True)
        batch = TokenPipeline(2, 16, cfg.vocab_size).get_for(cfg, 0, "cpu")
        loss = model.loss(lm, batch)
        assert bool(torch.isfinite(loss)) and float(loss) > 0
        grads = torch.autograd.grad(loss, list(lm.parameters()),
                                    materialize_grads=True)
        assert all(bool(torch.isfinite(g).all()) for g in grads)
        if cfg.is_encoder_decoder:
            names = [n for n, _ in lm.named_parameters()]
            g = grads[names.index("enc_layers.0.attn.wq")]
            assert bool((g != 0).any())
            # the cross-attention takes no QKV biases, as the reference's
            assert not grads[names.index("layers.0.xattn.bq")].any()


# ------------------------------------------------------------- optimizer --

@pytest.mark.parametrize("warmup,total", [(100, 10_000), (10, 200), (0, 50),
                                          (1, 1)])
def test_schedule_matches(warmup, total):
    jcfg = JO.AdamWConfig(lr=1e-3, warmup_steps=warmup, total_steps=total)
    tcfg = O.AdamWConfig(lr=1e-3, warmup_steps=warmup, total_steps=total)
    steps = list(range(0, 2 * max(total, warmup) + 3,
                       max(1, total // 40)))
    want = np.array([float(JO.schedule(jcfg, jnp.asarray(s, jnp.int32)))
                     for s in steps])
    got = np.array([O.schedule(tcfg, s) for s in steps])
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=0)


def test_adamw_init_matches():
    params = [torch.ones(3, 4), torch.ones(5)]
    st = O.adamw_init(params)
    assert st["step"] == 0
    for p, mu, nu in zip(params, st["mu"], st["nu"]):
        assert mu.shape == p.shape and mu.dtype == torch.float32
        assert not mu.any() and not nu.any()


SHAPES = [(64,), (8, 16), (3, 5, 7), (256, 64)]


@pytest.mark.parametrize("step0,gscale,wd", [
    (0, 1.0, 0.1),      # first step, clipped
    (0, 1e-3, 0.1),     # first step, under the clip norm
    (4, 0.01, 0.0),     # no weight decay
    (99, 1.0, 0.1),     # the last warmup step
    (150, 3.0, 0.1),    # cosine decay
])
def test_adamw_update_matches_on_identical_grads(step0, gscale, wd):
    rng = np.random.default_rng(step0)
    cfg = dict(lr=1e-3, warmup_steps=100, total_steps=300, weight_decay=wd)
    p = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    g = [(rng.normal(size=s) * gscale).astype(np.float32) for s in SHAPES]
    if step0:
        mu = [(rng.normal(size=s) * 0.01).astype(np.float32) for s in SHAPES]
        nu = [np.abs(rng.normal(size=s) * 1e-3).astype(np.float32)
              for s in SHAPES]
    else:
        mu = [np.zeros(s, np.float32) for s in SHAPES]
        nu = [np.zeros(s, np.float32) for s in SHAPES]
    key = [f"l{i}" for i in range(len(SHAPES))]  # sorted = list order
    tree = lambda xs: {k: jnp.asarray(x) for k, x in zip(key, xs)}  # noqa
    jp, js, jm = jax.jit(
        lambda a, b, c: JO.adamw_update(JO.AdamWConfig(**cfg), a, b, c))(
        tree(p), tree(g), {"mu": tree(mu), "nu": tree(nu),
                           "step": jnp.asarray(step0, jnp.int32)})
    tp = [torch.from_numpy(a.copy()) for a in p]
    st = {"mu": [torch.from_numpy(a.copy()) for a in mu],
          "nu": [torch.from_numpy(a.copy()) for a in nu], "step": step0}
    tp2, st2, tm = O.adamw_update(O.AdamWConfig(**cfg), tp,
                                  [torch.from_numpy(a) for a in g], st)
    assert tp2 is tp and st2["step"] == step0 + 1
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=2e-6)
    np.testing.assert_allclose(tm["lr"], float(jm["lr"]), rtol=2e-6)
    for i, k in enumerate(key):
        np.testing.assert_allclose(tp[i].numpy(), np.asarray(jp[k]),
                                   rtol=2e-6, atol=1e-7)
        np.testing.assert_allclose(st2["mu"][i].numpy(),
                                   np.asarray(js["mu"][k]), rtol=2e-6,
                                   atol=1e-8)
        np.testing.assert_allclose(st2["nu"][i].numpy(),
                                   np.asarray(js["nu"][k]), rtol=2e-6,
                                   atol=1e-8)


def test_global_norm_matches():
    rng = np.random.default_rng(5)
    xs = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    want = JO.global_norm({f"l{i}": jnp.asarray(x) for i, x in enumerate(xs)})
    got = O.global_norm([torch.from_numpy(x) for x in xs])
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ------------------------------------------------------------ train step --

def _assert_step_params(got: TrainState, ref_params, ref_grads, lr):
    for name, p in got.params.named_parameters():
        want = _ref_leaf(ref_params, name)
        g = np.abs(_ref_leaf(ref_grads, name))
        d = np.abs(p.detach().numpy() - want)
        firm = g > 1e-5
        assert (d[firm] <= 1e-6 + 1e-5 * np.abs(want[firm])).all(), name
        assert (d <= 2 * lr + 1e-6).all(), name


@pytest.mark.parametrize("imc,mb", [(False, 1), (True, 1), (False, 2),
                                    (True, 2)])
def test_train_step_matches_the_reference(ref_init, imc, mb):
    jc, tc = _cfgs(imc_linear=imc)
    opt = dict(lr=1e-3, warmup_steps=1)
    jb, tb = _batch(0)
    jmodel = jax_build_model(jc)
    jstate = JS.TrainState(
        params=jax.tree.map(jnp.asarray, ref_init[0]),
        opt={"mu": jax.tree.map(jnp.asarray, ref_init[1]),
             "nu": jax.tree.map(jnp.asarray, ref_init[2]),
             "step": jnp.zeros((), jnp.int32)},
        step=jnp.zeros((), jnp.int32))
    jgrads = _np(jax.grad(lambda p: jmodel.loss(p, jb))(jstate.params))
    jstate, jm = jax.jit(JS.make_train_step(
        jmodel, JS.TrainConfig(optimizer=JO.AdamWConfig(**opt),
                               microbatches=mb)))(jstate, jb)
    step = make_train_step(build_model(tc, "cpu"), TrainConfig(
        optimizer=O.AdamWConfig(**opt), microbatches=mb))
    state, m = step(_port_state(ref_init, tc), tb)
    assert state.step == 1 and state.opt["step"] == 1
    assert set(m) == set(jm)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-6)
    assert m["dcn_bytes"] == float(jm["dcn_bytes"]) == 0.0
    assert m["dcn_raw_bytes"] == float(jm["dcn_raw_bytes"])
    _assert_step_params(state, _np(jstate.params), jgrads, opt["lr"])


def test_train_step_attributes_and_pods():
    step = make_train_step(build_model(_cfgs()[1], "cpu"), TrainConfig())
    assert step.dcn_route == "global" and step.dcn_pods == 1
    assert resolve_pods(TrainConfig()) == 1
    assert resolve_pods(TrainConfig(dcn_pods=1)) == 1
    assert resolve_pods(TrainConfig(dcn_pods=4)) == 4


@pytest.mark.parametrize("kw", [
    {"dcn_compression": "int8"}, {"dcn_compression": "topk"},
    {"dcn_compression": "topk_ef"}, {"dcn_pods": 2},
    {"grad_compression": "int8"}, {"grad_compression": "topk"},
])
def test_dcn_and_compression_routes_raise(kw):
    with pytest.raises(NotImplementedError, match="item 5.6"):
        make_train_step(build_model(_cfgs()[1], "cpu"), TrainConfig(**kw))


def test_unknown_dcn_method_is_a_value_error():
    with pytest.raises(ValueError, match="unknown dcn_compression"):
        make_train_step(build_model(_cfgs()[1], "cpu"),
                        TrainConfig(dcn_compression="fp4"))


def _run(tc, tcfg, steps, state=None, start=0, seed=0):
    model = build_model(tc, "cpu")
    state = state or init_train_state(model, seed)
    step_fn = make_train_step(model, tcfg)
    pipe = TokenPipeline(B, S, tc.vocab_size)
    losses = []
    for s in range(start, steps):
        state, m = step_fn(state, pipe.get_for(tc, s, "cpu"))
        losses.append(float(m["loss"]))
    return state, losses


def _leaves(state):
    return (list(state.params.parameters()) + state.opt["mu"]
            + state.opt["nu"])


def test_microbatches_2_match_1():
    _, tc = _cfgs()
    opt = O.AdamWConfig(lr=1e-3)
    s1, _ = _run(tc, TrainConfig(optimizer=opt), 2)
    s2, _ = _run(tc, TrainConfig(optimizer=opt, microbatches=2), 2)
    for a, b in zip(s1.params.parameters(), s2.params.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=2e-3, atol=2e-5)


def test_microbatches_must_divide_the_batch():
    _, tc = _cfgs()
    with pytest.raises(ValueError, match="microbatches"):
        _run(tc, TrainConfig(microbatches=3), 1)


@pytest.mark.parametrize("imc", [False, True])
def test_remat_policies_give_equal_grads(imc):
    _, tc = _cfgs(imc_linear=imc)
    model = build_model(tc, "cpu")
    lm = model.init(0, trainable=True)
    batch = TokenPipeline(B, S, tc.vocab_size).get_for(tc, 0, "cpu")
    grads = {}
    calls = {}
    for remat in ("full", "dots", "none"):
        c0 = imc_mvm_plain.calls
        loss = model.loss(lm, batch, remat=remat)
        grads[remat] = (float(loss), torch.autograd.grad(
            loss, list(lm.parameters())))
        calls[remat] = imc_mvm_plain.calls - c0
    for remat in ("dots", "none"):
        assert grads[remat][0] == grads["full"][0]
        for a, b in zip(grads[remat][1], grads["full"][1]):
            assert torch.equal(a, b)
    # the kernel's wrapper runs once a layer: a recompute stops after the
    # exact product, the last tensor the block saves
    n = tc.num_layers if imc else 0
    assert calls == {"full": n, "dots": n, "none": n}


def test_unknown_remat_policy_raises():
    _, tc = _cfgs()
    with pytest.raises(ValueError, match="remat"):
        _run(tc, TrainConfig(remat="everything"), 1)


def test_cast_params_bf16_close_to_fp32():
    _, tc = _cfgs()
    opt = O.AdamWConfig(lr=1e-3)
    _, l_fp = _run(tc, TrainConfig(optimizer=opt), 5)
    s_bf, l_bf = _run(tc, TrainConfig(optimizer=opt, cast_params_bf16=True),
                      5)
    assert abs(l_fp[-1] - l_bf[-1]) < 0.1
    assert l_fp[0] != l_bf[0]     # the cast did change the forward
    assert all(p.dtype == torch.float32 for p in s_bf.params.parameters())


def test_cast_params_bf16_loss_matches_the_reference(ref_init):
    jc, tc = _cfgs()
    jb, tb = _batch(0)
    jstate = JS.TrainState(
        params=jax.tree.map(jnp.asarray, ref_init[0]),
        opt={"mu": jax.tree.map(jnp.asarray, ref_init[1]),
             "nu": jax.tree.map(jnp.asarray, ref_init[2]),
             "step": jnp.zeros((), jnp.int32)},
        step=jnp.zeros((), jnp.int32))
    _, jm = jax.jit(JS.make_train_step(jax_build_model(jc), JS.TrainConfig(
        cast_params_bf16=True)))(jstate, jb)
    _, m = make_train_step(build_model(tc, "cpu"), TrainConfig(
        cast_params_bf16=True))(_port_state(ref_init, tc), tb)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)


def test_cast_params_bf16_casts_the_stacked_layer_vectors(ref_init):
    """The reference casts every float32 leaf of ndim > 1, and a leaf of
    its stacked ``layers`` carries the layer axis: norm scales and QKV
    biases are cast to bfloat16 too (``final_norm`` is not). With scales
    and biases that bfloat16 does not hold exactly, the port's loss
    equals the reference's."""
    jc, tc = _cfgs()
    params, mu, nu = (jax.tree.map(np.copy, t) for t in ref_init)
    rng = np.random.default_rng(11)
    layers = params["layers"]
    for group, names in (("norm1", ("scale",)), ("norm2", ("scale",)),
                         ("attn", ("bq", "bk", "bv"))):
        for name in names:
            a = layers[group][name]
            layers[group][name] = (a + rng.normal(size=a.shape).astype(
                np.float32) * 0.1)
    params["final_norm"]["scale"] = params["final_norm"]["scale"] + 0.01
    jb, tb = _batch(0)

    def cast(p):
        return jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                            if (a.dtype == jnp.float32 and a.ndim > 1)
                            else a, p)

    want = float(jax_build_model(jc).loss(
        cast(jax.tree.map(jnp.asarray, params)), jb))
    state = train_state_from_numpy(params, mu, nu, 0, tc, "cpu")
    view = Z_cast(state.params)
    assert view["layers"][0]["norm1"]["scale"].dtype == torch.bfloat16
    assert view["layers"][0]["attn"]["bq"].dtype == torch.bfloat16
    assert view["final_norm"]["scale"].dtype == torch.float32
    got = float(build_model(tc, "cpu").loss(view, tb))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_loss_decreases():
    _, tc = _cfgs()
    tcfg = TrainConfig(optimizer=O.AdamWConfig(lr=1e-3, warmup_steps=2,
                                               total_steps=30))
    _, losses = _run(tc, tcfg, 30)
    assert losses[-1] < losses[0] - 0.3, (losses[0], losses[-1])


def test_imc_linear_trains():
    """The paper's IMC-routed FFN down-projection trains stably (the
    reference's ``test_imc_linear_trains``)."""
    _, tc = _cfgs(imc_linear=True)
    tcfg = TrainConfig(optimizer=O.AdamWConfig(lr=1e-3, warmup_steps=2,
                                               total_steps=20))
    _, losses = _run(tc, tcfg, 20)
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] - 0.2


# ------------------------------------------------------------- init / io --

def test_init_train_state_is_float32_and_trainable():
    _, tc = _cfgs(dtype="bfloat16")
    model = build_model(tc, "cpu")
    state = init_train_state(model, 0)
    assert state.step == 0 and state.opt["step"] == 0
    for p in state.params.parameters():
        assert p.dtype == torch.float32 and p.requires_grad
    assert len(state.opt["mu"]) == len(list(state.params.parameters()))
    # serving keeps its frozen cfg.dtype matrices
    served = model.init(0)
    assert served.embed.dtype == torch.bfloat16
    assert not any(p.requires_grad for p in served.parameters())
    assert served.final_norm["scale"].dtype == torch.float32


def test_train_state_from_numpy_carries_the_reference_state(ref_init):
    _, tc = _cfgs(dtype="bfloat16")
    params, mu, nu = ref_init
    mu = jax.tree.map(lambda a: a + 1.0, mu)
    state = train_state_from_numpy(params, mu, nu, 7, tc, "cpu")
    assert state.step == 7 and state.opt["step"] == 7
    for (name, p), m in zip(state.params.named_parameters(),
                            state.opt["mu"]):
        assert p.dtype == torch.float32 and p.requires_grad
        np.testing.assert_array_equal(p.detach().numpy(),
                                      _ref_leaf(params, name))
        np.testing.assert_array_equal(m.numpy(), _ref_leaf(mu, name))
    # the serving default is unchanged: cfg.dtype, frozen
    lm = lm_params_from_numpy(params, tc, "cpu")
    assert lm.embed.dtype == torch.bfloat16 and not lm.embed.requires_grad


def test_checkpoint_resume_exact(tmp_path):
    """6 steps straight against 3 + save + restore (into a state of
    another draw) + 3: identical parameters and moments."""
    _, tc = _cfgs()
    tcfg = TrainConfig(optimizer=O.AdamWConfig(lr=1e-3))
    state_a, _ = _run(tc, tcfg, 6)
    state_b, _ = _run(tc, tcfg, 3)
    mgr = CheckpointManager(tmp_path)
    mgr.save(3, state_b)
    target = init_train_state(build_model(tc, "cpu"), seed=1)
    step, state_c = mgr.restore_latest(target)
    assert step == 3 and state_c.step == 3 and state_c.opt["step"] == 3
    state_c, _ = _run(tc, tcfg, 6, state=state_c, start=3)
    for a, b in zip(_leaves(state_a), _leaves(state_c)):
        assert torch.equal(a, b)


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(16, 8, generator=g),
            "nested": {"b": torch.randn(4, generator=g),
                       "i": torch.arange(5, dtype=torch.int32) + seed,
                       "h": torch.randn(3, 2, generator=g).to(
                           torch.bfloat16),
                       "step": seed},
            "list": [torch.full((2,), float(seed)), 0.5]}


def _empty(seed=99):
    return _tree(seed)


def _equal(a, b):
    from repro_torch.dist.checkpoint import _flatten
    fa, fb = list(_flatten(a)), list(_flatten(b))
    return [p for p, _ in fa] == [p for p, _ in fb] and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for (_, x), (_, y) in zip(fa, fb))


class TestCheckpoint:
    def test_save_restore_roundtrip(self, tmp_path):
        mgr = CheckpointManager(tmp_path, keep=2)
        mgr.save(10, _tree(3))
        out = mgr.restore(10, _empty())
        assert _equal(out, _tree(3))
        assert out["nested"]["h"].dtype == torch.bfloat16

    def test_keep_n_gc(self, tmp_path):
        mgr = CheckpointManager(tmp_path, keep=2)
        for s in (1, 2, 3, 4):
            mgr.save(s, _tree(s))
        assert mgr.list_steps() == [3, 4]

    def test_async_save_snapshots_the_caller_state(self, tmp_path):
        mgr = CheckpointManager(tmp_path, keep=3)
        tree = _tree(5)
        mgr.save_async(5, tree)
        tree["w"].add_(1.0)            # the next step updates in place
        mgr.wait()
        assert mgr.list_steps() == [5] and mgr.validate(5)
        assert _equal(mgr.restore(5, _empty()), _tree(5))

    def test_restore_latest_skips_corrupt(self, tmp_path):
        mgr = CheckpointManager(tmp_path, keep=5)
        mgr.save(1, _tree(1))
        mgr.save(2, _tree(2))
        leaf = tmp_path / "step_00000002" / "leaf_00000.bin"
        raw = bytearray(leaf.read_bytes())
        raw[0] ^= 0xFF
        leaf.write_bytes(bytes(raw))
        assert not mgr.validate(2) and mgr.validate(1)
        step, tree = mgr.restore_latest(_empty())
        assert step == 1 and _equal(tree, _tree(1))

    def test_truncated_leaf_is_invalid(self, tmp_path):
        mgr = CheckpointManager(tmp_path)
        mgr.save(1, _tree(1))
        leaf = tmp_path / "step_00000001" / "leaf_00001.bin"
        leaf.write_bytes(leaf.read_bytes()[:-1])
        assert not mgr.validate(1)
        assert mgr.restore_latest(_empty()) is None

    def test_torn_write_invisible(self, tmp_path):
        mgr = CheckpointManager(tmp_path, keep=5)
        (tmp_path / "step_00000009.tmp").mkdir()
        assert mgr.list_steps() == []

    @pytest.mark.parametrize("target", [
        {"different": torch.zeros(3)},
        {**_tree(), "w": torch.zeros(16, 9)},                 # shape
        {**_tree(), "w": torch.zeros(16, 8, dtype=torch.float64)},
        {**_tree(), "list": [torch.zeros(2), 0.5, 1]},        # one more leaf
    ])
    def test_structure_mismatch_raises(self, tmp_path, target):
        mgr = CheckpointManager(tmp_path)
        mgr.save(1, _tree())
        with pytest.raises(ValueError):
            mgr.restore(1, target)

    def test_concurrent_save_async_all_valid(self, tmp_path):
        import threading

        mgr = CheckpointManager(tmp_path, keep=4)
        threads = [threading.Thread(target=mgr.save_async,
                                    args=(s, _tree(s)))
                   for s in range(1, 9)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        mgr.wait()
        steps = mgr.list_steps()
        assert len(steps) == 4
        for s in steps:
            assert mgr.validate(s)
            assert _equal(mgr.restore(s, _empty()), _tree(s))
        assert not list(tmp_path.glob("*.tmp*"))

    def test_async_then_sync_same_step_overwrites(self, tmp_path):
        mgr = CheckpointManager(tmp_path)
        mgr.save_async(7, _tree(1))
        mgr.wait()
        mgr.save(7, _tree(2))
        assert _equal(mgr.restore(7, _empty()), _tree(2))

    def test_restore_latest_empty_dir_is_none(self, tmp_path):
        assert CheckpointManager(tmp_path).restore_latest(_tree()) is None

    def test_meta_records_every_leaf(self, tmp_path):
        mgr = CheckpointManager(tmp_path)
        mgr.save(1, _tree(1))
        meta = json.loads((tmp_path / "step_00000001" / "meta.json")
                          .read_text())
        assert [m["path"] for m in meta["leaves"]] == [
            "/w", "/nested/b", "/nested/i", "/nested/h", "/list/0"]
        assert meta["scalars"] == {"/nested/step": 1, "/list/1": 0.5}

    def test_unsupported_leaf_raises(self, tmp_path):
        with pytest.raises(TypeError, match="cannot checkpoint"):
            CheckpointManager(tmp_path).save(1, {"x": object()})


# ------------------------------------------------------------- straggler --

SEQUENCES = [
    [1.0 + 0.01 * i for i in range(20)],
    [1.0] * 10 + [5.0, 1.0],
    [1.0] * 10 + [5.0, 5.0, 5.0, 1.0, 9.0, 9.0, 9.0, 9.0],
    [1.0] * 10 + [50.0] + [1.0] * 3,
    [0.2, 3.0, 0.2, 0.2, 0.2, 0.2, 0.9, 0.2, 0.5, 0.5, 0.5, 0.5],
]


@pytest.mark.parametrize("seq", SEQUENCES)
@pytest.mark.parametrize("warmup,limit", [(3, 2), (2, 3)])
def test_straggler_monitor_matches_the_reference(seq, warmup, limit):
    evict_ref, evict = [], []
    ref = JaxStragglerMonitor(warmup_steps=warmup, consecutive_limit=limit,
                              on_evict=lambda s, dt: evict_ref.append(s))
    mon = StragglerMonitor(warmup_steps=warmup, consecutive_limit=limit,
                           on_evict=lambda s, dt: evict.append(s))
    for dt in seq:
        assert mon.observe(dt).value == ref.observe(dt).value
        assert mon.mean == ref.mean and mon.consecutive == ref.consecutive
    assert evict == evict_ref


def test_straggler_evict_resets_streak():
    m = StragglerMonitor(warmup_steps=2, consecutive_limit=2)
    for _ in range(5):
        m.observe(1.0)
    assert m.observe(9.0) == Action.WARN
    assert m.observe(9.0) == Action.EVICT
    assert m.observe(9.0) == Action.WARN


def test_straggler_wall_clock_interface():
    m = StragglerMonitor(warmup_steps=1)
    assert m.step_end() == Action.OK         # no step started
    m.step_start()
    assert m.step_end() == Action.OK and m.count == 1


# -------------------------------------------------------------- launcher --

@pytest.mark.parametrize("imc", [False, True])
def test_launcher_runs_on_the_cpu(capsys, imc):
    calls = imc_mvm_plain.calls
    state = train_cli.main(["--arch", "qwen2_7b", "--reduced", "--steps",
                            "3", "--batch", "4", "--seq", "32",
                            "--log-every", "1", "--device", "cpu"]
                           + (["--imc-linear"] if imc else []))
    out = capsys.readouterr().out
    assert state.step == 3
    lines = [ln for ln in out.splitlines() if ln.startswith("step ")]
    assert len(lines) == 3 and "grad_norm=" in lines[0] and "s/step" in \
        lines[0]
    assert "done: 3 steps" in out
    # one wrapper call a layer a step (remat "full" does not recompute it)
    assert imc_mvm_plain.calls - calls == (2 * 3 if imc else 0)


def test_launcher_resumes_from_its_checkpoint(tmp_path, capsys):
    argv = ["--arch", "qwen2_7b", "--reduced", "--batch", "2", "--seq",
            "16", "--device", "cpu", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "1"]
    train_cli.main(argv + ["--steps", "2"])
    state = train_cli.main(argv + ["--steps", "3"])
    assert "resumed from checkpoint step 2" in capsys.readouterr().out
    assert state.step == 3
    assert CheckpointManager(tmp_path).list_steps() == [1, 2, 3]


@pytest.mark.parametrize("argv", [["--mesh", "single"],
                                  ["--dcn-compression", "int8"],
                                  ["--dcn-pods", "2"]])
def test_launcher_multi_device_flags_raise(argv):
    with pytest.raises(NotImplementedError, match="item 5.6"):
        train_cli.main(["--arch", "qwen2_7b", "--reduced", "--steps", "1",
                        "--device", "cpu"] + argv)
