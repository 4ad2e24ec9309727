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
branches that raise, and the launcher on the CPU. The hierarchical DCN
reduction mirrors the reference's ``tests/test_train_loop.py``
(``TestHierarchicalDCN``, ``TestSeedDeterminism``) on the port, and
holds the emulated step, the routes, the wire counts, the abstract
state's shapes and axes and a ``topk_ef`` send with the reference's
residuals (carried by ``convert.py``) against the reference.

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
  2e-3 / atol 2e-5 (the reference's own test);
- the DCN hierarchy: ``none`` on P pods against ``microbatches=P``, the
  residuals, sends, wire counts, seeds and resumes exact; pods 2 x
  microbatches 2 against microbatches 4 rtol 2e-3 / atol 2e-5, and the
  compressed losses within 0.25 of the uncompressed (the reference's
  tests); the emulated step against the reference's as one train step
  above.

Every test that runs JAX model code first clears ``repro.dist.sharding``'s
global mesh; none calls a JAX launcher.
"""

import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data.tokens import TokenPipeline as JaxTokenPipeline
from repro.dist import compression as JC
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
from repro_torch.dist import compression as C
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
    abstract_train_state,
    init_ef_state,
    init_train_state,
    make_train_step,
    resolve_pods,
    state_axes,
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


def test_unknown_dcn_method_is_a_value_error():
    with pytest.raises(ValueError, match="unknown dcn_compression"):
        make_train_step(build_model(_cfgs()[1], "cpu"),
                        TrainConfig(dcn_compression="fp4"))


def _run(tc, tcfg, steps, state=None, start=0, seed=0, metrics=False):
    """``steps`` steps from ``start`` (a fresh state from ``seed``, with
    the residuals ``tcfg`` needs, unless ``state``): the state and the
    losses, or with ``metrics`` each step's metrics as floats."""
    model = build_model(tc, "cpu")
    state = state or init_train_state(model, seed, tcfg)
    step_fn = make_train_step(model, tcfg)
    pipe = TokenPipeline(B, S, tc.vocab_size)
    out = []
    for s in range(start, steps):
        state, m = step_fn(state, pipe.get_for(tc, s, "cpu"))
        out.append({k: float(v) for k, v in m.items()} if metrics
                   else float(m["loss"]))
    return state, out


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


# ------------------------------------------------ hierarchical DCN routes --
# the reference's tests/test_train_loop.py TestHierarchicalDCN and
# TestSeedDeterminism, on the port

def _assert_states_equal(a, b):
    for x, y in zip(_leaves(a) + list(a.ef or []),
                    _leaves(b) + list(b.ef or [])):
        assert torch.equal(x, y)
    assert a.step == b.step and a.opt["step"] == b.opt["step"]


@pytest.mark.parametrize("pods", [2, 4, 8])
def test_dcn_none_bit_identical_to_microbatches(pods):
    """The emulated route with ``none`` on ``pods`` slices reproduces the
    global route with ``microbatches=pods`` bit for bit (parameters,
    moments, loss, grad_norm) over 3 steps."""
    _, tc = _cfgs()
    opt = O.AdamWConfig(lr=1e-3)
    s_mb, m_mb = _run(tc, TrainConfig(optimizer=opt, microbatches=pods), 3,
                      metrics=True)
    s_h, m_h = _run(tc, TrainConfig(optimizer=opt, dcn_pods=pods), 3,
                    metrics=True)
    _assert_states_equal(s_mb, s_h)
    for a, b in zip(m_mb, m_h):
        assert a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
        assert a["dcn_bytes"] == 0.0 and b["dcn_bytes"] == b["dcn_raw_bytes"]


def test_dcn_pods1_none_is_the_global_step():
    _, tc = _cfgs()
    opt = O.AdamWConfig(lr=1e-3)
    s_old, l_old = _run(tc, TrainConfig(optimizer=opt), 3)
    s_new, l_new = _run(tc, TrainConfig(optimizer=opt, dcn_pods=1,
                                        dcn_compression="none"), 3)
    _assert_states_equal(s_old, s_new)
    assert l_old == l_new


def test_dcn_hierarchy_composes_with_microbatches():
    """pods 2 x microbatches 2 see the slices of microbatches 4 in the same
    order; only where 1/P scales differs (the reference's tolerance)."""
    _, tc = _cfgs()
    opt = O.AdamWConfig(lr=1e-3)
    s_flat, _ = _run(tc, TrainConfig(optimizer=opt, microbatches=4), 2)
    s_h, _ = _run(tc, TrainConfig(optimizer=opt, dcn_pods=2,
                                  microbatches=2), 2)
    for a, b in zip(s_flat.params.parameters(), s_h.params.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=2e-3, atol=2e-5)


@pytest.mark.parametrize("method", ["int8", "topk_ef"])
def test_dcn_compressed_tracks_uncompressed(method):
    """int8 and EF top-k on 8 emulated pods at frac 0.25 track the
    uncompressed losses within 0.25 over 22 steps."""
    _, tc = _cfgs()
    opt = O.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=25)
    _, l_ref = _run(tc, TrainConfig(optimizer=opt, dcn_pods=8), 22)
    _, l_c = _run(tc, TrainConfig(optimizer=opt, dcn_pods=8,
                                  dcn_compression=method,
                                  dcn_topk_frac=0.25), 22)
    assert np.isfinite(l_c).all()
    assert l_c[-1] < l_c[0] - 0.3, (l_c[0], l_c[-1])
    dev = np.abs(np.asarray(l_c) - np.asarray(l_ref)).max()
    assert dev < 0.25, (dev, method)


def test_dcn_ef_state_carried_and_conserved():
    """TrainState.ef is per pod, zero at first and nonzero after a step,
    and each pod's new residual is what ``topk_ef_compress`` keeps of its
    gradients plus its old residual, bit for bit."""
    _, tc = _cfgs()
    model = build_model(tc, "cpu")
    tcfg = TrainConfig(optimizer=O.AdamWConfig(lr=1e-3), dcn_pods=2,
                       dcn_compression="topk_ef", dcn_topk_frac=0.1)
    state = init_train_state(model, 0, tcfg)
    leaves = list(state.params.parameters())
    assert [e.shape for e in state.ef] == [(2, *p.shape) for p in leaves]
    assert all(e.dtype == torch.float32 and not e.any() for e in state.ef)
    step_fn = make_train_step(model, tcfg)
    pipe = TokenPipeline(B, S, tc.vocab_size)
    state, _ = step_fn(state, pipe.get_for(tc, 0, "cpu"))
    assert sum(float(e.abs().sum()) for e in state.ef) > 0.0
    # the next step, pod by pod, against the compressor on the same inputs
    # (the reference's leaves: a stacked layer leaf whole)
    groups = T.tree_leaf_groups(state.params)

    def stack(ts, idx):
        return torch.stack([ts[j] for j in idx])

    batch = pipe.get_for(tc, 1, "cpu")
    old = [e.clone() for e in state.ef]
    want = []
    for p in range(2):
        part = {k: v[p * B // 2:(p + 1) * B // 2] for k, v in batch.items()}
        grads = torch.autograd.grad(model.loss(state.params, part), leaves)
        g = [stack(grads, idx) for idx in groups]
        e = [stack([o[p] for o in old], idx) for idx in groups]
        want.append((g, e, *C.topk_ef_compress(g, e, 0.1)))
    state, _ = step_fn(state, batch)
    for p in range(2):
        for idx, g, e, sent, kept in zip(groups, *want[p]):
            got = stack([r[p] for r in state.ef], idx)
            assert torch.equal(got, kept)
            assert torch.equal(sent + got, g + e)


def test_dcn_bytes_metric():
    """The step reports its wire footprint: none == raw float32 bytes,
    int8 ~4x smaller, EF top-k >= 4x smaller (the reference's bar)."""
    _, tc = _cfgs()
    opt = O.AdamWConfig(lr=1e-3)
    byt = {}
    for method in ("none", "int8", "topk_ef"):
        _, ms = _run(tc, TrainConfig(optimizer=opt, dcn_pods=2,
                                     dcn_compression=method), 1,
                     metrics=True)
        byt[method] = ms[0]["dcn_bytes"]
        assert ms[0]["dcn_raw_bytes"] == byt["none"]
    n = sum(p.numel() for p in init_train_state(
        build_model(tc, "cpu"), 0).params.parameters())
    assert byt["none"] == 4 * n
    assert byt["none"] / byt["int8"] > 3.9
    assert byt["none"] / byt["topk_ef"] >= 4.0


@pytest.mark.parametrize("kw", [
    dict(),
    dict(microbatches=4, remat="none"),
    dict(dcn_pods=4, dcn_compression="int8"),
    dict(dcn_pods=2, dcn_compression="topk_ef", microbatches=2,
         remat="dots"),
], ids=["plain", "microbatch-noremat", "hier-int8", "hier-ef-mb-dots"])
def test_same_seed_same_metrics(kw):
    _, tc = _cfgs()
    tcfg = TrainConfig(optimizer=O.AdamWConfig(lr=1e-3), **kw)
    _, m1 = _run(tc, tcfg, 3, metrics=True)
    _, m2 = _run(tc, tcfg, 3, metrics=True)
    assert m1 == m2


def test_different_seed_different_rounding():
    _, tc = _cfgs()
    base = dict(optimizer=O.AdamWConfig(lr=1e-3), dcn_pods=2,
                dcn_compression="int8")
    _, l0 = _run(tc, TrainConfig(**base, seed=0), 2)
    _, l1 = _run(tc, TrainConfig(**base, seed=1), 2)
    assert l0[1] != l1[1]  # step 1's loss sees step 0's rounding noise


def test_dcn_checkpoint_roundtrip_with_ef(tmp_path):
    """The residuals are part of TrainState: saved and restored mid-run
    (into a state of another draw), the continued run equals an
    uninterrupted one bit for bit."""
    _, tc = _cfgs()
    tcfg = TrainConfig(optimizer=O.AdamWConfig(lr=1e-3), dcn_pods=2,
                       dcn_compression="topk_ef")
    s_a, _ = _run(tc, tcfg, 4)
    s_b, _ = _run(tc, tcfg, 2)
    mgr = CheckpointManager(tmp_path)
    mgr.save(2, s_b)
    meta = json.loads((tmp_path / "step_00000002" / "meta.json").read_text())
    assert sum(m["path"].startswith("/ef/") for m in meta["leaves"]) == \
        len(s_b.ef)
    target = init_train_state(build_model(tc, "cpu"), 1, tcfg)
    _, s_c = mgr.restore_latest(target)
    s_c, _ = _run(tc, tcfg, 4, state=s_c, start=2)
    _assert_states_equal(s_a, s_c)


def test_checkpoint_without_ef_restores_with_empty_ef(tmp_path):
    _, tc = _cfgs()
    tcfg = TrainConfig(optimizer=O.AdamWConfig(lr=1e-3))
    s_a, _ = _run(tc, tcfg, 2)
    assert s_a.ef == {}
    CheckpointManager(tmp_path).save(2, s_a)
    target = init_train_state(build_model(tc, "cpu"), 1, tcfg)
    step, got = CheckpointManager(tmp_path).restore_latest(target)
    assert step == 2 and got.ef == {}
    _assert_states_equal(s_a, got)
    # a state that carries residuals does not take it
    ef_target = init_train_state(build_model(tc, "cpu"), 1, TrainConfig(
        dcn_pods=2, dcn_compression="topk_ef"))
    assert CheckpointManager(tmp_path).restore_latest(ef_target) is None


@pytest.mark.parametrize("dcn,mesh", [
    (dict(), None), (dict(), {"pod": 2, "data": 2}),
    (dict(dcn_pods=1), None), (dict(dcn_pods=2), None),
    (dict(dcn_compression="int8"), None),
    (dict(dcn_compression="int8"), {"data": 4}),
    (dict(dcn_compression="topk_ef"), {"pod": 4, "data": 2}),
    (dict(dcn_compression="topk", dcn_pods=2), {"pod": 2}),
    (dict(dcn_compression="topk", dcn_pods=4), {"pod": 2}),
    (dict(dcn_pods=2), {"pod": 2}),
])
def test_dcn_route_and_pods_match_the_reference(dcn, mesh):
    jc, tc = _cfgs()
    ref = JS.make_train_step(jax_build_model(jc), JS.TrainConfig(**dcn),
                             None if mesh is None
                             else types.SimpleNamespace(shape=mesh))
    got = make_train_step(build_model(tc, "cpu"), TrainConfig(**dcn), mesh)
    assert (got.dcn_route, got.dcn_pods) == (ref.dcn_route, ref.dcn_pods)
    assert resolve_pods(TrainConfig(**dcn), mesh) == JS.resolve_pods(
        JS.TrainConfig(**dcn), None if mesh is None
        else types.SimpleNamespace(shape=mesh))
    ef = init_ef_state(build_model(tc, "cpu").init(0), TrainConfig(**dcn),
                       mesh)
    if dcn.get("dcn_compression") == "topk_ef":
        rows = 1 if got.dcn_route == "shard_map" else got.dcn_pods
        assert ef and all(e.shape[0] == rows for e in ef)
    else:
        assert ef == {}


def test_process_group_route_needs_a_device_mesh():
    _, tc = _cfgs()
    model = build_model(tc, "cpu")
    tcfg = TrainConfig(dcn_pods=2)
    step = make_train_step(model, tcfg, {"pod": 2})
    assert step.dcn_route == "shard_map"
    state = init_train_state(model, 0, tcfg, {"pod": 2})
    with pytest.raises(ValueError, match="needs a DeviceMesh"):
        step(state, _batch(0)[1])


def test_residual_rows_must_match_the_route():
    _, tc = _cfgs()
    model = build_model(tc, "cpu")
    ef4 = TrainConfig(dcn_pods=4, dcn_compression="topk_ef")
    state = init_train_state(model, 0, ef4)
    with pytest.raises(ValueError, match="keeps 2"):
        make_train_step(model, TrainConfig(
            dcn_pods=2, dcn_compression="topk_ef"))(state, _batch(0)[1])
    with pytest.raises(ValueError, match="dcn_pods 3"):
        make_train_step(model, TrainConfig(dcn_pods=3))(
            init_train_state(model, 0), _batch(0)[1])


def _ref_axes(tree, name):
    """The reference's axes (or shape) behind a port parameter name; a
    stacked layer's without its leading layer entry."""
    parts = name.split(".")
    if parts[0] in ("layers", "enc_layers"):
        node = tree[parts[0]]
        for p in parts[2:]:
            node = node[p]
        return tuple(node)[1:]
    if parts[0] == "blocks":
        node = tree["blocks"][int(parts[1])]
        for p in parts[2:]:
            node = node[p]
        return tuple(node)
    node = tree
    for p in parts:
        node = node[p]
    return tuple(node)


@pytest.mark.parametrize("arch", ["qwen2_7b", "deepseek_moe_16b",
                                  "hymba_1_5b", "xlstm_125m",
                                  "whisper_medium", "internvl2_76b"])
def test_abstract_train_state_and_axes_match_the_reference(arch):
    jc = jax_get_config(arch).reduced()
    if arch == "xlstm_125m":     # both block kinds
        jc = dataclasses.replace(jc, num_layers=4)
    tc = get_config(arch).reduced()
    tc = dataclasses.replace(tc, num_layers=jc.num_layers)
    kw = dict(dcn_pods=2, dcn_compression="topk_ef")
    jstate, jaxes = JS.abstract_train_state(jax_build_model(jc),
                                            JS.TrainConfig(**kw))
    jst_axes = JS.state_axes(jaxes, JS.TrainConfig(**kw))
    state, axes = abstract_train_state(build_model(tc, "cpu"),
                                       TrainConfig(**kw))
    st_axes = state_axes(axes, TrainConfig(**kw))
    named = list(state.params.named_parameters())
    assert len(named) == len(axes) == len(state.ef) == len(st_axes.ef)
    jshape = jax.tree.map(lambda x: tuple(x.shape), jstate.params)
    # the reference's residuals: (P, *param shape), a stacked layer's too
    assert all(jax.tree.leaves(jax.tree.map(
        lambda e, p: e.shape == (2, *p.shape), jstate.ef, jstate.params)))
    for (name, p), a, mu, e, ea in zip(named, axes, state.opt["mu"],
                                       state.ef, st_axes.ef):
        assert p.device.type == "meta" and e.device.type == "meta"
        assert a == _ref_axes(jaxes, name), name
        assert tuple(p.shape) == tuple(mu.shape) == _ref_axes(jshape, name)
        assert tuple(e.shape) == (2, *p.shape)
        # the reference's residual axes are ("dcn_pod", ["layer",] *the
        # parameter's); the port keeps each row whole within a pod
        # (compression takes a leaf whole), so "dcn_pod" alone places it
        ref = _ref_axes(jst_axes.ef, name)
        if name.startswith(("layers", "enc_layers")):
            # a stacked leaf's, less its leading "dcn_pod"
            assert ref == ("layer", *a)
        else:
            assert ref == ("dcn_pod", *a)
        assert ea == ("dcn_pod",) + (None,) * len(a)
    # the reference's leaves, in its order, as groups of the parameters
    groups = T.tree_leaf_groups(state.params)
    jleaves = jax.tree.leaves(jstate.params)
    assert len(groups) == len(jleaves)
    params = list(state.params.parameters())
    for idx, jl in zip(groups, jleaves):
        shapes = {tuple(params[j].shape) for j in idx}
        assert len(shapes) == 1
        shape = shapes.pop()
        assert tuple(jl.shape) in ((len(idx), *shape), shape)
    assert st_axes.opt["mu"] is axes and st_axes.step == ()
    assert state_axes(axes).ef == {} and state_axes(axes).opt["step"] == ()
    none_state, _ = abstract_train_state(build_model(tc, "cpu"))
    assert none_state.ef == {}


@pytest.mark.parametrize("method", ["int8", "topk"])
def test_grad_compression_applies_to_the_reduced_grads(method):
    """The legacy grad_compression compresses the reduced gradients (int8
    with its own stream) before AdamW: the step equals that by hand."""
    _, tc = _cfgs()
    model = build_model(tc, "cpu")
    opt = O.AdamWConfig(lr=1e-3)
    tcfg = TrainConfig(optimizer=opt, grad_compression=method, seed=3)
    state = init_train_state(model, 0, tcfg)
    manual = init_train_state(model, 0)
    batch = _batch(0)[1]
    leaves = list(manual.params.parameters())
    grads = torch.autograd.grad(model.loss(manual.params, batch), leaves)
    # one reference leaf a group: a stacked layer leaf is compressed whole
    groups = T.tree_leaf_groups(manual.params)
    sent = C.compress_tree(
        [torch.stack([grads[j] for j in idx]) for idx in groups], method,
        key=C.fold_in(C.per_step_key(3, 0), C.LEGACY_STREAM))
    flat = [None] * len(leaves)
    for idx, t in zip(groups, sent):
        for j, tj in zip(idx, t.unbind(0)):
            flat[j] = tj
    O.adamw_update(opt, leaves, flat, manual.opt)
    state, m = make_train_step(model, tcfg)(state, batch)
    for a, b in zip(state.params.parameters(), leaves):
        assert torch.equal(a, b)
    assert m["dcn_bytes"] == 0.0


@pytest.mark.parametrize("method", ["int8", "topk"])
def test_grad_compression_trains(method):
    _, tc = _cfgs()
    tcfg = TrainConfig(optimizer=O.AdamWConfig(lr=1e-3, warmup_steps=2,
                                               total_steps=15),
                       grad_compression=method)
    _, losses = _run(tc, tcfg, 15)
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] - 0.1


@pytest.mark.parametrize("pods", [2, 4])
def test_emulated_step_matches_the_reference(ref_init, pods):
    """The reference's emulated ``none`` route and the port's from the
    same state, within the global route's tolerances."""
    jc, tc = _cfgs()
    opt = dict(lr=1e-3, warmup_steps=1)
    jb, tb = _batch(0)
    jmodel = jax_build_model(jc)
    jstate, _ = JS.init_train_state(jmodel, jax.random.PRNGKey(0))
    jgrads = _np(jax.grad(lambda p: jmodel.loss(p, jb))(jstate.params))
    jstep = JS.make_train_step(jmodel, JS.TrainConfig(
        optimizer=JO.AdamWConfig(**opt), dcn_pods=pods))
    assert jstep.dcn_route == "emulated"
    jstate, jm = jax.jit(jstep)(jstate, jb)
    step = make_train_step(build_model(tc, "cpu"), TrainConfig(
        optimizer=O.AdamWConfig(**opt), dcn_pods=pods))
    state, m = step(_port_state(ref_init, tc), tb)
    assert set(m) == set(jm)
    np.testing.assert_allclose(m["loss"], float(jm["loss"]), rtol=1e-6)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-6)
    assert m["dcn_bytes"] == float(jm["dcn_bytes"]) > 0
    assert m["dcn_raw_bytes"] == float(jm["dcn_raw_bytes"])
    _assert_step_params(state, _np(jstate.params), jgrads, opt["lr"])


@pytest.mark.parametrize("frac", [0.01, 0.25])
def test_topk_ef_send_matches_the_reference_with_converted_ef(ref_init,
                                                              frac):
    """The reference's residuals carried across by ``convert.py``: on the
    same gradients (the reference's, of each pod's slice), ``dcn_send``
    gives the reference's ``sent`` and new residual bit for bit."""
    jc, tc = _cfgs()
    params, mu, nu = ref_init
    rng = np.random.default_rng(4)
    ef = jax.tree.map(lambda a: rng.normal(size=(2, *a.shape)).astype(
        np.float32) * 1e-3, params)
    state = train_state_from_numpy(params, mu, nu, 0, tc, "cpu", ef=ef)
    names = [n for n, _ in state.params.named_parameters()]
    assert [e.shape for e in state.ef] == [
        (2, *p.shape) for p in state.params.parameters()]
    for name, e in zip(names, state.ef):
        for p in range(2):
            np.testing.assert_array_equal(
                e[p].numpy(), _ref_leaf(jax.tree.map(lambda a: a[p], ef),
                                        name))
    jmodel = jax_build_model(jc)
    jb, _ = _batch(0)
    groups = T.tree_leaf_groups(state.params)
    for p in range(2):
        jpart = jax.tree.map(lambda x: x[p * B // 2:(p + 1) * B // 2], jb)
        jg = jax.grad(lambda q: jmodel.loss(q, jpart))(
            jax.tree.map(jnp.asarray, params))
        jef = jax.tree.map(lambda a: jnp.asarray(a[p]), ef)
        jsent, jnew = JC.dcn_send(jg, jef, "topk_ef", frac)
        # the port's grads are the reference's, mapped by name; the
        # compressor sees the reference's leaves (stacked layers whole)
        g = [torch.from_numpy(np.array(_ref_leaf(_np(jg), n))) for n in names]
        sent, new = C.dcn_send(
            [torch.stack([g[j] for j in idx]) if len(idx) > 1 else g[idx[0]]
             for idx in groups],
            [torch.stack([state.ef[j][p] for j in idx]) if len(idx) > 1
             else state.ef[idx[0]][p] for idx in groups], "topk_ef", frac)
        want_s, want_n = jax.tree.leaves(jsent), jax.tree.leaves(jnew)
        assert len(sent) == len(want_s) == len(groups)
        for a, b, wa, wb in zip(sent, new, want_s, want_n):
            np.testing.assert_array_equal(a.numpy(), _np(wa))
            np.testing.assert_array_equal(b.numpy(), _np(wb))


@pytest.mark.parametrize("method", ["int8", "topk", "topk_ef"])
def test_dcn_bytes_match_the_reference(method):
    """The wire count of a compressed send, one stacked layer leaf counted
    whole as in the reference, equals the reference's step's."""
    jc, tc = _cfgs()
    kw = dict(dcn_pods=2, dcn_compression=method, dcn_topk_frac=0.05)
    jmodel = jax_build_model(jc)
    jstate, _ = JS.init_train_state(jmodel, jax.random.PRNGKey(0),
                                    JS.TrainConfig(**kw))
    _, jm = JS.make_train_step(jmodel, JS.TrainConfig(**kw))(
        jstate, _batch(0)[0])
    _, ms = _run(tc, TrainConfig(**kw), 1, metrics=True)
    assert ms[0]["dcn_bytes"] == float(jm["dcn_bytes"])
    assert ms[0]["dcn_raw_bytes"] == float(jm["dcn_raw_bytes"])



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


@pytest.mark.parametrize("argv,pods,factor", [
    (["--dcn-pods", "2", "--dcn-compression", "topk_ef"], 2, "49.9x"),
    (["--dcn-pods", "2", "--dcn-compression", "int8"], 2, "4.0x"),
    (["--dcn-compression", "topk"], 1, "49.9x"),
    (["--dcn-pods", "2"], 2, "1.0x"),
])
def test_launcher_runs_the_dcn_hierarchy(capsys, argv, pods, factor):
    state = train_cli.main(["--arch", "qwen2_7b", "--reduced", "--steps",
                            "2", "--batch", "4", "--seq", "16",
                            "--log-every", "1", "--device", "cpu"] + argv)
    out = capsys.readouterr().out
    method = argv[-1] if "--dcn-compression" in argv else "none"
    assert (f"grad sync: emulated hierarchy over {pods} pod(s), "
            f"dcn_compression={method}") in out
    lines = [ln for ln in out.splitlines() if ln.startswith("step ")]
    assert len(lines) == 2
    assert all(" dcn=" in ln and f"MiB/pod ({factor} smaller)" in ln
               for ln in lines), lines
    assert state.step == 2
    n = len(list(state.params.parameters()))
    assert len(state.ef or []) == (n if method == "topk_ef" else 0)


def test_launcher_grad_compression_runs(capsys):
    state = train_cli.main(["--arch", "qwen2_7b", "--reduced", "--steps",
                            "2", "--batch", "2", "--seq", "16",
                            "--device", "cpu", "--grad-compression", "int8"])
    out = capsys.readouterr().out
    assert "grad sync:" not in out and " dcn=" not in out
    assert state.step == 2


def test_launcher_resumes_the_dcn_residuals(tmp_path, capsys):
    """Resumed from its checkpoint, the ``topk_ef`` run continues with the
    saved residuals: 2 + 2 steps equal 4 straight."""
    argv = ["--arch", "qwen2_7b", "--reduced", "--batch", "4", "--seq",
            "16", "--device", "cpu", "--dcn-pods", "2", "--dcn-compression",
            "topk_ef", "--log-every", "1"]
    ckpt = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "1"]
    train_cli.main(argv + ckpt + ["--steps", "2"])
    resumed = train_cli.main(argv + ckpt + ["--steps", "4"])
    out = capsys.readouterr().out
    assert "resumed from checkpoint step 2" in out
    assert out.count("grad sync: emulated hierarchy over 2 pod(s)") == 2
    straight = train_cli.main(argv + ["--steps", "4"])
    assert resumed.step == straight.step == 4
    for a, b in zip(_leaves(resumed) + resumed.ef,
                    _leaves(straight) + straight.ef):
        assert torch.equal(a, b)


@pytest.mark.parametrize("argv", [["--mesh", "single"],
                                  ["--mesh", "multi"]])
def test_launcher_multi_device_flags_raise(argv):
    """The production meshes need 256 / 512 ranks
    (``make_production_mesh``); one process has none."""
    ranks = 512 if argv[1] == "multi" else 256
    with pytest.raises(ValueError, match=f"needs {ranks} ranks"):
        train_cli.main(["--arch", "qwen2_7b", "--reduced", "--steps", "1",
                        "--device", "cpu"] + argv)
