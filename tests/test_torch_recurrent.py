"""Parity of the port's recurrent families with the JAX package, on the
CPU: the associative scan, the Mamba, mLSTM and sLSTM layers
(``repro_torch.models.recurrent``), the states after a prompt, and the
two configs built on them, ``xlstm_125m`` (mLSTM blocks with an sLSTM
every fourth layer, so its reduced config is run with 4 layers) and
``hymba_1_5b`` (attention and Mamba heads side by side, a 16-position
sliding window when reduced): ``forward_train``, ``Model.loss`` and its
gradients, prefill then decode, one ``make_train_step`` step, checkpoint
resume and both launchers.

The same inputs (numpy from a seed, and the reference's own parameters
carried across as numpy) go through ``repro`` and ``repro_torch``. The
reduced configs run in float32; one bfloat16 case a layer and a config
exercises the storage rule (the leaves the reference computes with in
float32 stay float32 in the port's serving store).

Tolerances (what was measured on these cases in brackets):
- ``associative_scan`` against ``lax.associative_scan``: bit for bit (the
  same tree of the same elementwise products and sums) [0]; against a
  sequential loop, another rounding: rtol 1e-5 / atol 1e-6;
- float32 layer outputs and states rtol 1e-5 / atol 1e-6 in units of
  the tensor's largest magnitude where that exceeds 1 (mLSTM states
  reach ~35, where 1e-6 is below one float32 step) [up to 2.5e-6 of the
  scale, on entries rtol covers];
- logits rtol / atol 1e-4 (atol in units of the largest |logit|) and
  losses rtol 1e-6 through a model [logits 3e-5, losses 2e-7];
- gradients: Hymba's rtol 1e-4 / atol 1e-6; xLSTM's within 5e-4 of
  each leaf's norm [1.2e-4], since its exponential gates amplify float32
  rounding in either package past 1e-4 on small entries; a train step's
  parameters as ``tests/test_torch_train.py`` holds them (tight where
  the reference's gradient exceeds 1e-5, and for xLSTM 1e-2 of the
  leaf's largest, within 2 lr elsewhere);
- bfloat16: a layer's float32 states rtol 1e-5 / atol 1e-6 [4e-7
  relative; with every leaf stored in bfloat16 they fail it, which the
  test checks], its bfloat16 outputs within 2^-6 of their largest
  magnitude [2^-7: one or two bfloat16 steps; XLA may keep a fused chain
  of bfloat16 operations in float32 where PyTorch rounds each]; a
  model's logits within 2^-3 of the step's largest |logit| [2^-4.4 for
  xLSTM, 2^-6 for Hymba];
- the port against itself (remat policies, checkpoint resume) exact; a
  decode loop against the chunked training forward rtol / atol 1e-4.

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
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import get_config as jax_get_config
from repro.data.tokens import TokenPipeline as JaxTokenPipeline
from repro.dist.sharding import set_mesh
from repro.models import recurrent as JR
from repro.models import transformer as JT
from repro.models.model_zoo import build_model as jax_build_model
from repro.train import optimizer as JO
from repro.train import train_step as JS
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy, train_state_from_numpy
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
from repro_torch.models import recurrent as R
from repro_torch.models import transformer as T
from repro_torch.models.model_zoo import build_model
from repro_torch.train import optimizer as O
from repro_torch.train.train_step import (
    TrainConfig,
    init_train_state,
    make_train_step,
)

torch.set_num_threads(1)

ARCHS = ("xlstm_125m", "hymba_1_5b")
# the reduced xLSTM has 2 layers and ssm_ratio 4, so no sLSTM block: 4
LAYERS = {"xlstm_125m": 4, "hymba_1_5b": 2}
B, S = 4, 32
RTOL, ATOL = 1e-5, 1e-6
# xLSTM: a leaf's gradient within this share of its norm; a train step's
# update is held tight where |grad| exceeds FIRM of the leaf's largest
XLSTM_GRAD_SHARE = 5e-4
FIRM = {"xlstm_125m": 1e-2, "hymba_1_5b": 0.0}


@pytest.fixture(autouse=True)
def no_global_mesh():
    set_mesh(None)
    yield


def _cfgs(arch, **kw):
    kw = {"num_layers": LAYERS[arch], **kw}
    jc = dataclasses.replace(jax_get_config(arch).reduced(), **kw)
    tc = dataclasses.replace(get_config(arch).reduced(), **kw)
    return jc, tc


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _f64(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(a).astype(jnp.float32), np.float64)


@functools.cache
def _ref_init(arch):
    """The reference's initial TrainState (PRNGKey(0)) of the reduced
    config, as numpy; made once per architecture."""
    set_mesh(None)
    jc, _ = _cfgs(arch)
    state, _ = JS.init_train_state(jax_build_model(jc), jax.random.PRNGKey(0))
    return (_np(state.params), _np(state.opt["mu"]), _np(state.opt["nu"]))


def _ref_leaf(tree, name):
    """The reference leaf behind a port parameter name:
    ``layers.1.mamba.a_log`` -> ``tree["layers"]["mamba"]["a_log"][1]``,
    ``layers.0.alpha`` -> ``tree["layers"]["alpha"][0]``,
    ``blocks.3.mix.w_z`` -> ``tree["blocks"][3]["mix"]["w_z"]``."""
    parts = name.split(".")
    if parts[0] == "layers":
        node = tree["layers"]
        for p in parts[2:]:
            node = node[p]
        return node[int(parts[1])]
    if parts[0] == "blocks":
        node = tree["blocks"][int(parts[1])]
        for p in parts[2:]:
            node = node[p]
        return node
    node = tree
    for p in parts:
        node = node[p]
    return node


def _batch(arch, step=0, batch=B, seq=S):
    jc, tc = _cfgs(arch)
    j = JaxTokenPipeline(batch, seq, jc.vocab_size).get_for(jc, step)
    t = TokenPipeline(batch, seq, tc.vocab_size).get_for(tc, step, "cpu")
    np.testing.assert_array_equal(t["tokens"].numpy(), np.asarray(j["tokens"]))
    return j, t


# ------------------------------------------------------- associative scan --

def _affine_jax(l, r):
    return l[0] * r[0], l[1] * r[0] + r[1]


def _loop(a, b, dim):
    """The affine recurrence h_t = a_t h_{t-1} + b_t from h = 0, step by
    step."""
    a, b = a.movedim(dim, 0), b.movedim(dim, 0)
    h = torch.zeros_like(b[0])
    out = []
    for t in range(a.shape[0]):
        h = a[t] * h + b[t]
        out.append(h)
    return torch.stack(out).movedim(0, dim)


@settings(max_examples=20, deadline=None, derandomize=True)
@given(n=st.integers(1, 70), lead=st.integers(1, 3), trail=st.integers(1, 5),
       dim=st.integers(0, 2), seed=st.integers(0, 2**16))
def test_associative_scan_matches_lax_and_a_loop(n, lead, trail, dim, seed):
    rng = np.random.default_rng(seed)
    shape = [lead, trail, 2]
    shape.insert(dim, n)
    a = rng.uniform(0.3, 1.0, size=shape).astype(np.float32)
    b = rng.normal(size=shape).astype(np.float32)
    ja, jb = jax.lax.associative_scan(
        _affine_jax, (jnp.asarray(a), jnp.asarray(b)), axis=dim)
    ta, tb = R.associative_scan(R._affine, (_t(a), _t(b)), dim=dim)
    assert ta.shape == tuple(shape) and tb.dtype == torch.float32
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_allclose(tb.numpy(), _loop(_t(a), _t(b), dim).numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 7, 64, 65])
def test_associative_scan_of_a_sum_is_lax_cumsum_order(n):
    """Any associative ``fn`` over a tuple: a sum, combined in the
    reference's tree order, equals ``lax.associative_scan(add)`` bit for
    bit."""
    x = np.random.default_rng(n).normal(size=(n, 3)).astype(np.float32)
    want = jax.lax.associative_scan(lambda l, r: (l[0] + r[0],),
                                    (jnp.asarray(x),))[0]
    got = R.associative_scan(lambda l, r: (l[0] + r[0],), (_t(x),))[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ----------------------------------------------------------------- layers --

LAYER_KINDS = {
    # name: (arch, reference init, reference train, reference decode,
    #        reference state)
    "mamba": ("hymba_1_5b", JR.init_mamba, JR.mamba_train, JR.mamba_decode,
              JR.init_mamba_state),
    "mlstm": ("xlstm_125m", JR.init_mlstm, JR.mlstm_train, JR.mlstm_decode,
              JR.init_mlstm_state),
    "slstm": ("xlstm_125m", JR.init_slstm, JR.slstm_train, JR.slstm_decode,
              JR.init_slstm_state),
}


def _layer(name, dtype="float32", seed=1):
    """The reference's parameters of one layer, and the same values in the
    port's store: each leaf in the dtype ``init_*`` gives it."""
    arch, init = LAYER_KINDS[name][:2]
    jc, tc = _cfgs(arch, dtype=dtype)
    jp, _ = init(jax.random.PRNGKey(seed), jc)
    store = getattr(R, f"init_{name}")(tc)
    tp = torch.nn.ParameterDict({
        k: L._param(_t(v).to(store[k].dtype)) for k, v in jp.items()})
    assert set(tp) == set(store)
    return jc, tc, jp, tp


def _x(shape, dtype="float32", seed=0):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    if dtype == "bfloat16":
        return jnp.asarray(x).astype(jnp.bfloat16), _t(x).bfloat16()
    return jnp.asarray(x), _t(x)


def _train(name, tp, x, tc, chunk=None):
    fn = getattr(R, f"{name}_train")
    return fn(tp, x, tc) if chunk is None else fn(tp, x, tc, chunk=chunk)


def _ref_train(name, jp, x, jc, chunk=None):
    fn = LAYER_KINDS[name][2]
    return fn(jp, x, jc) if chunk is None else fn(jp, x, jc, chunk=chunk)


def _close(got, want, rtol=RTOL, atol=ATOL, err_msg=""):
    """allclose with ``atol`` in units of the reference tensor's largest
    magnitude where that exceeds 1."""
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale,
                               err_msg=err_msg)


def _assert_state(got, want, rtol=RTOL, atol=ATOL):
    assert type(got).__name__ == type(want).__name__
    for f in dataclasses.fields(want):
        g = getattr(got, f.name)
        assert g.dtype == torch.float32, f.name
        _close(g, getattr(want, f.name), rtol, atol, f.name)


@pytest.mark.parametrize("name,chunk,seq", [
    ("mamba", None, 16), ("mamba", 8, 32), ("mamba", 4, 12),
    ("mlstm", None, 16), ("mlstm", 8, 32), ("mlstm", 4, 12),
    ("slstm", None, 16), ("slstm", None, 37)])
def test_layer_train_matches(name, chunk, seq):
    """Full-sequence forward of one layer, over one chunk and several."""
    jc, tc, jp, tp = _layer(name)
    xj, xt = _x((2, seq, jc.d_model), seed=seq)
    want = _ref_train(name, jp, xj, jc, chunk)
    got = _train(name, tp, xt, tc, chunk)
    assert got.dtype == torch.float32 and got.shape == (2, seq, jc.d_model)
    _close(got, want, err_msg="out")


def _decode_steps(name, jc, tc, jp, tp, xj, xt, steps, jstate=None,
                  tstate=None):
    ref_dec = LAYER_KINDS[name][3]
    dec = getattr(R, f"{name}_decode")
    b = xt.shape[0]
    jstate = jstate or LAYER_KINDS[name][4](jc, b)
    tstate = tstate or getattr(R, f"init_{name}_state")(tc, b)
    outs = []
    for t in range(steps):
        yj, jstate = ref_dec(jp, xj[:, t:t + 1], jc, jstate)
        yt, tstate = dec(tp, xt[:, t:t + 1], tc, tstate)
        outs.append((yt, yj))
    return outs, tstate, jstate


@pytest.mark.parametrize("name", list(LAYER_KINDS))
def test_layer_decode_steps_match(name):
    """Eight decode steps from the zero state: each output and the final
    state."""
    jc, tc, jp, tp = _layer(name)
    xj, xt = _x((3, 8, jc.d_model), seed=2)
    outs, tstate, jstate = _decode_steps(name, jc, tc, jp, tp, xj, xt, 8)
    for yt, yj in outs:
        assert yt.shape == (3, 1, jc.d_model)
        _close(yt, yj, err_msg="out")
    _assert_state(tstate, jstate)


@pytest.mark.parametrize("name", list(LAYER_KINDS))
def test_state_after_matches_and_decode_continues(name):
    """``_*_state_after`` over a 24-position prompt equals the reference's,
    and 4 decode steps from it agree."""
    jc, tc, jp, tp = _layer(name)
    xj, xt = _x((2, 28, jc.d_model), seed=3)
    want = getattr(JT, f"_{name}_state_after")(jp, xj[:, :24], jc)
    got = getattr(T, f"_{name}_state_after")(tp, xt[:, :24], tc)
    _assert_state(got, want)
    outs, tstate, jstate = _decode_steps(name, jc, tc, jp, tp, xj[:, 24:],
                                         xt[:, 24:], 4, want, got)
    for yt, yj in outs:
        _close(yt, yj, err_msg="out")
    _assert_state(tstate, jstate)


@pytest.mark.parametrize("name", list(LAYER_KINDS))
def test_decode_loop_equals_the_chunked_forward(name):
    """The port against itself: decoding a sequence token by token from
    the zero state gives the chunked forward's outputs, and the state
    after equals ``_*_state_after`` (another rounding: 1e-4)."""
    _, tc, _, tp = _layer(name)
    x = torch.randn(2, 16, tc.d_model, generator=torch.Generator()
                    .manual_seed(4))
    dec = getattr(R, f"{name}_decode")
    state = getattr(R, f"init_{name}_state")(tc, 2)
    ys = []
    for t in range(16):
        y, state = dec(tp, x[:, t:t + 1], tc, state)
        ys.append(y)
    full = _train(name, tp, x, tc, chunk=None if name == "slstm" else 4)
    _close(torch.cat(ys, 1), full.detach().numpy(), 1e-4, 1e-4)
    after = getattr(T, f"_{name}_state_after")(tp, x, tc)
    for f in dataclasses.fields(state):
        _close(getattr(state, f.name), getattr(after, f.name).numpy(),
               1e-4, 1e-4, f.name)


@pytest.mark.parametrize("name", list(LAYER_KINDS))
def test_bfloat16_layer_keeps_its_float32_leaves(name):
    """bfloat16 activations: the float32 states of 8 decode steps and of
    ``_*_state_after`` hold at the float32 tolerance (they are computed
    from float32 leaves, which a bfloat16 store would move by ~2e-3);
    the bfloat16 outputs within 2^-6 of their largest magnitude."""
    jc, tc, jp, tp = _layer(name, "bfloat16")
    xj, xt = _x((2, 8, jc.d_model), "bfloat16", seed=5)
    outs, tstate, jstate = _decode_steps(name, jc, tc, jp, tp, xj, xt, 8)
    _assert_state(tstate, jstate)
    # the check is sensitive to the storage: every leaf in bfloat16
    # moves the states past the tolerance
    every = torch.nn.ParameterDict({
        k: L._param(v.detach().to(torch.bfloat16)) for k, v in tp.items()})
    _, bstate, _ = _decode_steps(name, jc, tc, jp, every, xj, xt, 8)
    with pytest.raises(AssertionError):
        _assert_state(bstate, jstate)
    _assert_state(getattr(T, f"_{name}_state_after")(tp, xt, tc),
                  getattr(JT, f"_{name}_state_after")(jp, xj, jc))
    pairs = outs + [(_train(name, tp, xt, tc), _ref_train(name, jp, xj, jc))]
    for yt, yj in pairs:
        assert yt.dtype == torch.bfloat16
        want = _f64(yj)
        assert np.abs(_f64(yt) - want).max() <= 2.0 ** -6 * np.abs(want).max()


@pytest.mark.parametrize("name,seq,chunk", [
    ("mamba", 72, 64), ("mamba", 96, 64), ("mamba", 20, 8),
    ("mlstm", 260, 256), ("mlstm", 12, 8)])
def test_chunk_shapes_off_the_chunk_raise(name, seq, chunk):
    """A sequence longer than the chunk must be a multiple of it: the
    reference asserts, the port raises a ValueError. Shorter ones take a
    single chunk on both sides."""
    jc, tc, jp, tp = _layer(name)
    xj, xt = _x((1, seq, jc.d_model))
    with pytest.raises(AssertionError):
        _ref_train(name, jp, xj, jc, chunk)
    with pytest.raises(ValueError, match=f"{seq} is not a multiple of the "
                                         f"chunk {chunk}"):
        _train(name, tp, xt, tc, chunk)
    short = seq % chunk
    _close(_train(name, tp, xt[:, :short], tc, chunk),
           _ref_train(name, jp, xj[:, :short], jc, chunk))


@pytest.mark.parametrize("arch,seq", [("xlstm_125m", 264),
                                      ("hymba_1_5b", 80)])
def test_model_chunk_shapes_raise(arch, seq):
    _, tc = _cfgs(arch)
    model = build_model(tc, "cpu")
    tokens = torch.zeros((1, seq), dtype=torch.int32)
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        T.forward_train(model.init(0), tokens, tc)
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        model.prefill(model.init(0), {"tokens": tokens},
                      model.init_cache(1, seq + 1))


# ------------------------------------------------- registry and storage --

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_block_kinds_follow_the_reference(arch, reduced):
    cfg, jc = get_config(arch), jax_get_config(arch)
    if reduced:
        cfg, jc = _cfgs(arch)[1], _cfgs(arch)[0]
    kinds = [T.block_kind(cfg, i) for i in range(cfg.num_layers)]
    assert kinds == [JT.block_kind(jc, i) for i in range(jc.num_layers)]
    if arch == "xlstm_125m":
        assert kinds.count("slstm") == cfg.num_layers // cfg.ssm_ratio
        assert T.stack_name(cfg) == "blocks"
    else:
        assert set(kinds) == {"hybrid"} and T.stack_name(cfg) == "layers"
    assert build_model(cfg.reduced(), "cpu").cfg == cfg.reduced()


# the leaves the serving store keeps in float32, by block kind and group
FLOAT32_LEAVES = {
    ("hybrid", "mamba"): {"a_log", "d_skip", "dt_bias"},
    ("mlstm", "mix"): {"w_q", "w_k", "w_v", "w_i", "w_f", "f_bias"},
    ("slstm", "mix"): {"w_z", "w_i", "w_f", "w_o", "f_bias", "w_down"},
}


def _assert_store(lm, cfg):
    """Every leaf in the dtype the storage rule gives it."""
    for i, lp in enumerate(lm[T.stack_name(cfg)]):
        kind = T.block_kind(cfg, i)
        for name, t in lp.named_parameters():
            parts = name.split(".")
            f32 = (parts[0].startswith("norm") or parts == ["alpha"]
                   or parts[1] in FLOAT32_LEAVES.get((kind, parts[0]), ()))
            want = torch.float32 if f32 else torch.bfloat16
            assert t.dtype == want, (i, kind, name, t.dtype)
    assert lm.embed.dtype == torch.bfloat16
    assert lm.final_norm["scale"].dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_store_keeps_the_float32_leaves(arch):
    """bfloat16 configs: ``lm_params_from_numpy`` and ``init`` keep the
    leaves the reference computes with in float32 in float32 (with their
    exact values), and the rest in bfloat16; a trainable tree is all
    float32."""
    params = _ref_init(arch)[0]
    _, tc = _cfgs(arch, dtype="bfloat16")
    lm = lm_params_from_numpy(params, tc, "cpu")
    _assert_store(lm, tc)
    _assert_store(build_model(tc, "cpu").init(0), tc)
    for name, t in lm.named_parameters():
        if t.dtype == torch.float32:
            np.testing.assert_array_equal(t.numpy(), _ref_leaf(params, name))
    trained = lm_params_from_numpy(params, tc, "cpu", trainable=True)
    assert all(t.dtype == torch.float32 and t.requires_grad
               for t in trained.parameters())


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_params_from_numpy_carries_the_tree(arch):
    params = _ref_init(arch)[0]
    _, tc = _cfgs(arch)
    lm = lm_params_from_numpy(params, tc, "cpu")
    names = [n for n, _ in lm.named_parameters()]
    per_layer = len(jax.tree_util.tree_leaves(params.get("layers", {})))
    assert len(names) == (len(jax.tree_util.tree_leaves(params))
                          + (tc.num_layers - 1) * per_layer)
    for name, t in lm.named_parameters():
        np.testing.assert_array_equal(t.numpy(), _ref_leaf(params, name))
    stack = T.stack_name(tc)
    assert lm.stack == stack and len(lm[stack]) == tc.num_layers
    other = "hymba_1_5b" if arch == "xlstm_125m" else "xlstm_125m"
    with pytest.raises(ValueError, match="expected"):
        lm_params_from_numpy(params, _cfgs(other)[1], "cpu")


def _scale(name, cfg, kind):
    """The reference's std of a normal matrix leaf of a ``kind`` block."""
    d = cfg.d_model
    group, leaf = (["", ""] + name.split("."))[-2:]
    if kind == "mlstm" and group == "mix" and leaf != "w_up":
        return (2 * d) ** -0.5            # d_inner ** -0.5
    if leaf == "wo":
        return (cfg.num_heads * cfg.resolved_head_dim) ** -0.5
    if (group, leaf) == ("ffn", "w_down"):
        return cfg.d_ff ** -0.5
    return d ** -0.5


@pytest.mark.parametrize("arch", ARCHS)
def test_init_meets_the_references_shapes_and_distributions(arch):
    """The port's own draw: the reference's tree, shapes and float32
    leaves when trainable; each matrix's std within five standard errors
    of the reference's scale; ``a_log``, ``d_skip``, ``f_bias``,
    ``alpha`` and the norms the reference's constants; ``dt_bias`` in
    [-4, -2]."""
    jc, tc = _cfgs(arch, d_model=128)
    lm = build_model(tc, "cpu").init(seed=3, trainable=True)
    ref = JT.init_lm(jax.random.PRNGKey(0), jc)[0]
    assert len(list(lm.parameters())) == len(jax.tree_util.tree_leaves(
        ref)) + (tc.num_layers - 1) * len(jax.tree_util.tree_leaves(
            ref.get("layers", {})))
    kinds = [T.block_kind(tc, i) for i in range(tc.num_layers)]
    for name, t in lm.named_parameters():
        w = np.asarray(_ref_leaf(ref, name))
        assert tuple(t.shape) == w.shape, name
        assert t.dtype == torch.float32 and t.requires_grad, name
        leaf = name.split(".")[-1]
        if leaf in ("a_log", "d_skip", "f_bias", "alpha", "scale"):
            # log(k) of the two libraries may differ in the last bit
            np.testing.assert_allclose(t.detach().numpy(), w, rtol=1e-6,
                                       atol=0, err_msg=name)
        elif leaf == "dt_bias":
            assert float(t.min()) >= -4 and float(t.max()) <= -2
        else:
            assert t.ndim >= 2, name
            parts = name.split(".")
            kind = kinds[int(parts[1])] if len(parts) > 2 else None
            want = _scale(name, tc, kind)
            tol = 5 / (2 * t.numel()) ** 0.5
            assert abs(float(t.detach().std()) / want - 1) < tol, name
            assert abs(float(w.std()) / want - 1) < tol, name


# ------------------------------------------------------- the whole model --

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("remat", ["full", "none"])
def test_forward_train_matches(arch, remat):
    jc, tc = _cfgs(arch)
    params, mu, nu = _ref_init(arch)
    jb, tb = _batch(arch, 1)
    want = JT.forward_train(jax.tree.map(jnp.asarray, params), jb["tokens"],
                            jc, remat=remat)
    lm = train_state_from_numpy(params, mu, nu, 0, tc, "cpu").params
    got = T.forward_train(lm, tb["tokens"], tc, remat=remat)
    assert got.dtype == torch.float32
    assert got.shape == (B, S, tc.padded_vocab)
    _close(got, want, 1e-4, 1e-4)


def _assert_grad(arch, g, want, name):
    """Hymba's gradients elementwise; xLSTM's within a norm-wise share of
    each leaf (its exponential gates amplify either package's float32
    rounding)."""
    if arch == "hymba_1_5b":
        np.testing.assert_allclose(g, want, rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    else:
        err = np.linalg.norm(g - want) / max(np.linalg.norm(want), 1e-30)
        assert err <= XLSTM_GRAD_SHARE, (name, err)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_loss_and_grads_match(arch):
    jc, tc = _cfgs(arch)
    params, mu, nu = _ref_init(arch)
    jb, tb = _batch(arch, 2)
    want, jgrads = jax.value_and_grad(
        lambda p: jax_build_model(jc).loss(p, jb))(
        jax.tree.map(jnp.asarray, params))
    lm = train_state_from_numpy(params, mu, nu, 0, tc, "cpu").params
    loss = build_model(tc, "cpu").loss(lm, tb)
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-6)
    names = [n for n, _ in lm.named_parameters()]
    grads = torch.autograd.grad(loss, list(lm.parameters()))
    jgrads = _np(jgrads)
    for name, g in zip(names, grads):
        _assert_grad(arch, g.numpy(), _ref_leaf(jgrads, name), name)


def _serve_pair(arch, batch, seq, gen, **kw):
    jc, tc = _cfgs(arch, **kw)
    params = _ref_init(arch)[0]
    jm, tm = jax_build_model(jc), build_model(tc, "cpu")
    jbatch = JaxTokenPipeline(batch, seq, jc.vocab_size).get_for(jc, 3)
    tbatch = TokenPipeline(batch, seq, tc.vocab_size).get_for(tc, 3, "cpu")
    return (jc, tc, jm, tm, jax.tree.map(jnp.asarray, params),
            lm_params_from_numpy(params, tc, "cpu"), jbatch, tbatch)


def _within_share(got, want, share):
    want = _f64(want)
    return np.abs(_f64(got) - want).max() <= share * np.abs(want).max()


@pytest.mark.parametrize("arch,batch,seq,kw", [
    ("xlstm_125m", 2, 16, {}), ("xlstm_125m", 5, 32, {}),
    ("xlstm_125m", 2, 16, {"dtype": "bfloat16"}),
    ("hymba_1_5b", 2, 16, {}), ("hymba_1_5b", 5, 32, {}),
    ("hymba_1_5b", 3, 16, {"kv_quant_int8": True}),
    ("hymba_1_5b", 2, 16, {"dtype": "bfloat16"})])
def test_prefill_and_decode_match_the_reference(arch, batch, seq, kw):
    """Model.prefill, then 6 decode steps teacher-forced on the reference's
    greedy tokens (Hymba's prompts fit its 16-position window or fill it
    whole times; decode wraps the ring): logits within 1e-4 (2e-3 with
    the int8 cache, as ``tests/test_torch_moe.py`` explains; bfloat16
    within 2^-3 of the largest |logit|), greedy tokens equal in float32,
    and the recurrent states after the last step at the layer
    tolerance in float32."""
    jc, tc, jm, tm, jparams, tparams, jbatch, tbatch = _serve_pair(
        arch, batch, seq, 7, **kw)
    bf16 = kw.get("dtype") == "bfloat16"
    tol = 2e-3 if kw.get("kv_quant_int8") else 1e-4
    gen = 7
    jcache = jm.init_cache(batch, seq + gen)
    tcache = tm.init_cache(batch, seq + gen)
    lj, jcache = jm.prefill(jparams, jbatch, jcache)
    lt, tcache = tm.prefill(tparams, tbatch, tcache)

    def check(lt, lj):
        if bf16:
            assert _within_share(lt, lj, 2.0 ** -3)
        else:
            _close(lt, lj, tol, tol)

    check(lt, lj)
    tok = jnp.argmax(lj[:, -1:], axis=-1).astype(jnp.int32)
    launches = decode_attention.launches
    for i in range(gen - 1):
        lj, jcache = jm.decode_step(jparams, tok, jcache,
                                    jnp.asarray(seq + i, jnp.int32))
        lt, tcache = tm.decode_step(tparams, _t(tok), tcache, seq + i)
        check(lt, lj)
        tok = jnp.argmax(lj, axis=-1).astype(jnp.int32)
        if not bf16:
            np.testing.assert_array_equal(torch.argmax(lt, -1).numpy(),
                                          np.asarray(tok))
    assert decode_attention.launches == launches   # CPU: the plain version
    if bf16:
        return
    for i, kind in enumerate(T.block_kind(tc, j) for j in
                             range(tc.num_layers)):
        if kind == "hybrid":
            got, want = tcache[i][1], R.MambaState(
                h=jcache[1].h[i])
        else:
            got, want = tcache[i], jcache[i]
        _assert_state(got, want, rtol=1e-4, atol=1e-4)


def _ref_logits_at(jc, jparams, tokens):
    return np.asarray(JT.forward_train(jparams, tokens, jc))


@pytest.mark.parametrize("s0", [20, 24])
def test_hybrid_prefill_past_the_window_matches_forward_train(s0):
    """F1 on Hymba: a 16-position window, a prompt of 20 or 24 positions
    (longer than the window and not a multiple of it), then 6 decode
    steps. Each step's logits equal the reference's ``forward_train``
    over the whole sequence at that position (the reference's own ring
    would be misaligned; ROADMAP Queue 3, F1)."""
    jc, tc, _, tm, jparams, tparams, _, _ = _serve_pair("hymba_1_5b", 2, s0,
                                                        7)
    gen = 7
    tokens = np.random.default_rng(s0).integers(
        0, tc.vocab_size, size=(2, s0 + gen)).astype(np.int32)
    want = _ref_logits_at(jc, jparams, jnp.asarray(tokens))
    cache = tm.init_cache(2, s0 + gen)
    lt, cache = tm.prefill(tparams, {"tokens": _t(tokens[:, :s0])}, cache)
    _close(lt, want[:, :s0], 1e-4, 1e-4)
    for i in range(gen):
        pos = s0 + i
        lt, cache = tm.decode_step(tparams, _t(tokens[:, pos:pos + 1]),
                                   cache, pos)
        _close(lt, want[:, pos:pos + 1], 1e-4, 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_last_only_prefill_is_the_last_position(arch):
    _, tc = _cfgs(arch)
    model = build_model(tc, "cpu")
    params = model.init(0)
    batch = TokenPipeline(2, 16, tc.vocab_size).get(0, "cpu")
    full, cache_a = model.prefill(params, batch, model.init_cache(2, 20))
    last, cache_b = model.prefill(params, batch, model.init_cache(2, 20),
                                  last_only=True)
    assert last.shape == (2, 1, tc.padded_vocab)
    torch.testing.assert_close(last, full[:, -1:], rtol=1e-5, atol=1e-5)
    tok = last.argmax(-1).to(torch.int32)
    ya, _ = model.decode_step(params, tok, cache_a, 16)
    yb, _ = model.decode_step(params, tok, cache_b, 16)
    assert torch.equal(ya, yb)


def test_hybrid_int8_decode_goes_through_the_attend_seam():
    """Hymba's attention heads hand ``decode_attention`` q grouped to
    (B, KV, G, hd) in float32 and ``valid_len = min(pos + 1, window)``:
    the whole ring once the decode has wrapped it."""
    _, tc = _cfgs("hymba_1_5b", kv_quant_int8=True)
    model = build_model(tc, "cpu")
    params = model.init(0)
    seen = []

    def attend(q, k8, v8, ks, vs, valid_len):
        seen.append((tuple(q.shape), q.dtype, tuple(k8.shape), valid_len))
        return decode_attention_plain(q, k8, v8, ks, vs, valid_len)

    batch = TokenPipeline(2, 16, tc.vocab_size).get(0, "cpu")
    cache = model.init_cache(2, 24)
    logits, cache = model.prefill(params, batch, cache, last_only=True)
    tok = logits.argmax(-1).to(torch.int32)
    for pos in (16, 17):
        logits, cache = model.decode_step(params, tok, cache, pos, attend)
    kv, g = tc.num_kv_heads, tc.num_heads // tc.num_kv_heads
    want = ((2, kv, g, tc.resolved_head_dim), torch.float32,
            (2, 16, kv, tc.resolved_head_dim), 16)
    assert seen == [want] * (2 * tc.num_layers)


def _assert_step_params(got, ref_params, ref_grads, lr, firm_share):
    for name, p in got.params.named_parameters():
        want = _ref_leaf(ref_params, name)
        g = np.abs(_ref_leaf(ref_grads, name))
        d = np.abs(p.detach().numpy() - want)
        firm = g > max(1e-5, firm_share * g.max())
        assert (d[firm] <= 1e-6 + 1e-5 * np.abs(want[firm])).all(), name
        assert (d <= 2 * lr + 1e-6).all(), name


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cast_bf16", [False, True])
def test_train_step_matches_the_reference(arch, cast_bf16):
    """One ``make_train_step`` step, with and without ``cast_params_bf16``
    (every float32 leaf of ndim > 1 cast to bfloat16, the recurrent
    gates and ``a_log`` included): loss, grad_norm and the parameters
    after the update."""
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
    jtcfg = JS.TrainConfig(optimizer=JO.AdamWConfig(**opt),
                           cast_params_bf16=cast_bf16)

    def jloss(p):
        if cast_bf16:
            p = jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                             if (a.dtype == jnp.float32 and a.ndim > 1)
                             else a, p)
        return jmodel.loss(p, jb)

    jgrads = _np(jax.grad(jloss)(jstate.params))
    jstate, jm = jax.jit(JS.make_train_step(jmodel, jtcfg))(jstate, jb)
    step = make_train_step(build_model(tc, "cpu"), TrainConfig(
        optimizer=O.AdamWConfig(**opt), cast_params_bf16=cast_bf16))
    state, m = step(train_state_from_numpy(params, mu, nu, 0, tc, "cpu"), tb)
    assert state.step == 1 and set(m) == set(jm)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    assert m["dcn_raw_bytes"] == float(jm["dcn_raw_bytes"])
    _assert_step_params(state, _np(jstate.params), jgrads, opt["lr"],
                        FIRM[arch])


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_policies_give_equal_loss_and_grads(arch):
    _, tc = _cfgs(arch)
    model = build_model(tc, "cpu")
    lm = model.init(0, trainable=True)
    batch = TokenPipeline(2, S, tc.vocab_size).get_for(tc, 0, "cpu")
    out = {}
    for remat in ("full", "dots", "none"):
        loss = model.loss(lm, batch, remat=remat)
        out[remat] = (float(loss.detach()), torch.autograd.grad(
            loss, list(lm.parameters())))
    for remat in ("full", "dots"):
        assert out[remat][0] == out["none"][0]
        for a, b in zip(out[remat][1], out["none"][1]):
            assert torch.equal(a, b)


def _run(tc, tcfg, steps, state=None, start=0):
    model = build_model(tc, "cpu")
    state = state or init_train_state(model, 0)
    step_fn = make_train_step(model, tcfg)
    pipe = TokenPipeline(2, S, tc.vocab_size)
    for s in range(start, steps):
        state, _ = step_fn(state, pipe.get_for(tc, s, "cpu"))
    return state


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_resume_exact(arch, tmp_path):
    """4 steps straight against 2 + save + restore (into a state of
    another draw) + 2: identical parameters and moments."""
    _, tc = _cfgs(arch)
    tcfg = TrainConfig(optimizer=O.AdamWConfig(lr=1e-3))
    state_a = _run(tc, tcfg, 4)
    state_b = _run(tc, tcfg, 2)
    mgr = CheckpointManager(tmp_path)
    mgr.save(2, state_b)
    target = init_train_state(build_model(tc, "cpu"), seed=1)
    step, state_c = mgr.restore_latest(target)
    assert step == 2 and state_c.step == 2 and state_c.opt["step"] == 2
    state_c = _run(tc, tcfg, 4, state=state_c, start=2)
    leaves = [(list(s.params.parameters()) + s.opt["mu"] + s.opt["nu"])
              for s in (state_a, state_c)]
    assert len(leaves[0]) == len(leaves[1])
    for a, b in zip(*leaves):
        assert torch.equal(a, b)


# --------------------------------------------------------------- launchers --

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kv_quant", [False, True])
def test_serve_launcher_runs_on_the_cpu(arch, kv_quant, capsys):
    """Both archs serve; ``--kv-quant`` gives Hymba's attention heads the
    int8 store, and changes nothing for xLSTM, which has no attention."""
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
            "--prompt-len", "16", "--gen", "4"]
    run = serve.main(argv + (["--kv-quant"] if kv_quant else []))
    out = capsys.readouterr().out
    assert f"model: {arch}_reduced" in out
    assert "decode_attention launches: 0" in out
    assert run.tokens.shape == (2, 4) and run.tokens.dtype == torch.int32
    assert int(run.tokens.max()) < run.model.cfg.padded_vocab
    if arch == "xlstm_125m" and kv_quant:
        plain = serve.main(argv)
        torch.testing.assert_close(plain.tokens, run.tokens, rtol=0, atol=0)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("imc", [False, True])
def test_train_launcher_runs_on_the_cpu(arch, imc, capsys):
    """Both archs train; ``--imc-linear`` reaches Hymba's FFN
    down-projection (one plain ``imc_mvm`` call a layer a step on the
    CPU) and never an mLSTM or sLSTM projection."""
    calls = imc_mvm_plain.calls
    state = train_cli.main(["--arch", arch, "--reduced", "--device", "cpu",
                            "--steps", "2", "--batch", "2", "--seq", "32",
                            "--log-every", "1"]
                           + (["--imc-linear"] if imc else []))
    out = capsys.readouterr().out
    assert "step 2: loss=" in out and "done: 2 steps" in out
    assert state.step == 2
    per_step = get_config(arch).reduced().num_layers if (
        imc and arch == "hymba_1_5b") else 0
    assert imc_mvm_plain.calls - calls == 2 * per_step


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_resumes_from_its_checkpoint(arch, tmp_path, capsys):
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
            "--seq", "16", "--ckpt-dir", str(tmp_path), "--ckpt-every", "1"]
    train_cli.main(argv + ["--steps", "2"])
    capsys.readouterr()
    state = train_cli.main(argv + ["--steps", "3"])
    assert "resumed from checkpoint step 2" in capsys.readouterr().out
    assert state.step == 3
    assert CheckpointManager(tmp_path).list_steps()[-1] == 3
