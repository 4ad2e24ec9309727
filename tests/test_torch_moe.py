"""Parity of the port's MoE layer and of the four decoder-only configs
beside Qwen2-7B (``deepseek_moe_16b``, ``llama4_scout_17b_a16e``,
``gemma_7b``, ``granite_20b``, ``granite_34b``) with the JAX package, on
the CPU.

The same inputs (numpy from a seed, and the reference's own parameters
carried across as numpy) go through ``repro`` and ``repro_torch``: the
configuration registry, ``apply_moe`` with its routing, and for every
new reduced config ``forward_train``, ``Model.loss`` and its gradients,
prefill followed by decode, and one ``make_train_step`` step. Both sides
run the reduced configs in float32.

The reference's routing is read from its own ``apply_moe``: the chosen
experts from its ``lax.top_k`` call and the dense dispatch (which token
and slot lands in which expert's capacity slot) and combine tensors from
its ``constrain`` calls, which are the identity with no mesh set.

Tolerances (the two libraries sum in different orders):
- routing (top-k experts, arrival positions, the kept mask, so the
  dispatch tensor) exact; the normalised gates rtol 1e-6 / atol 1e-7;
- ``apply_moe`` outputs rtol 1e-5 / atol 1e-6;
- logits and losses through a model rtol / atol 1e-4 (losses rtol 1e-6);
- gradients rtol 1e-4 / atol 1e-6, and a train step's parameters as
  ``tests/test_torch_train.py`` holds them (tight where the reference's
  gradient exceeds 1e-5, within 2 lr elsewhere);
- the port against itself (remat policies) exact.

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

import repro.configs as jax_configs
from repro.configs import get_config as jax_get_config
from repro.data.tokens import TokenPipeline as JaxTokenPipeline
from repro.dist.sharding import set_mesh
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.model_zoo import build_model as jax_build_model
from repro.train import optimizer as JO
from repro.train import train_step as JS
import repro_torch.configs as configs
from repro_torch.configs import get_config, list_archs
from repro_torch.convert import lm_params_from_numpy, train_state_from_numpy
from repro_torch.data.tokens import TokenPipeline
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.imc_mvm import imc_mvm_plain
from repro_torch.launch import serve
from repro_torch.launch import train as train_cli
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.model_zoo import build_model
from repro_torch.train import optimizer as O
from repro_torch.train.train_step import TrainConfig, make_train_step

torch.set_num_threads(1)

MOE_ARCHS = ("deepseek_moe_16b", "llama4_scout_17b_a16e")
DENSE_ARCHS = ("gemma_7b", "granite_20b", "granite_34b")
NEW_ARCHS = MOE_ARCHS + DENSE_ARCHS
RECURRENT = ("xlstm_125m", "hymba_1_5b")
ENCDEC_VLM = ("whisper_medium", "internvl2_76b")
B, S = 8, 64


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


def _ref_leaf(tree, name):
    """The reference leaf behind a port parameter name
    (``layers.1.moe.router`` -> ``tree["layers"]["moe"]["router"][1]``)."""
    parts = name.split(".")
    if parts[0] == "layers":
        return tree["layers"][parts[2]][parts[3]][int(parts[1])]
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


# ---------------------------------------------------------------- configs --

@pytest.mark.parametrize("arch", jax_configs.ARCH_IDS)
def test_every_config_is_the_references(arch):
    full_j, full_t = jax_get_config(arch), get_config(arch)
    assert dataclasses.asdict(full_t) == dataclasses.asdict(full_j)
    assert (dataclasses.asdict(full_t.reduced())
            == dataclasses.asdict(full_j.reduced()))
    for name in ("resolved_head_dim", "is_moe", "is_recurrent",
                 "supports_long_decode", "padded_vocab"):
        assert getattr(full_t, name) == getattr(full_j, name), name
    assert get_config(arch.replace("_", "-")) == full_t


def test_registry_and_shapes_are_the_references():
    assert list_archs() == jax_configs.list_archs()
    assert configs.ARCH_IDS == jax_configs.ARCH_IDS
    assert configs.__all__ == jax_configs.__all__
    assert ({k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()}
            == {k: dataclasses.asdict(v)
                for k, v in jax_configs.SHAPES.items()})
    for arch in list_archs():
        cfg = get_config(arch)
        for shape in configs.SHAPES:
            assert (configs.applicable(cfg.family, shape,
                                       cfg.supports_long_decode)
                    == jax_configs.applicable(cfg.family, shape,
                                              cfg.supports_long_decode))
    with pytest.raises(ModuleNotFoundError):
        get_config("gpt_5")


@pytest.mark.parametrize("arch", jax_configs.ARCH_IDS)
def test_block_kind_takes_every_decoder_only_config(arch):
    """Every layer's kind is the reference's: attn_moe, attn_ffn, hybrid,
    or xLSTM's mLSTM blocks with an sLSTM every ``ssm_ratio``-th (the
    VLM's and Whisper's ``block_kind`` is attn_ffn, as the reference's);
    every config builds."""
    cfg = get_config(arch)
    kinds = [T.block_kind(cfg, i) for i in range(cfg.num_layers)]
    jc = jax_get_config(arch)
    assert kinds == [JT.block_kind(jc, i) for i in range(jc.num_layers)]
    want = {"moe": {"attn_moe"}, "hybrid": {"hybrid"},
            "ssm": {"mlstm", "slstm"}}.get(cfg.family, {"attn_ffn"})
    assert set(kinds) == want
    assert build_model(cfg.reduced(), "cpu").cfg == cfg.reduced()


@pytest.mark.parametrize("arch", ENCDEC_VLM)
def test_decoder_stacks_of_the_encdec_and_vlm_families(arch):
    """The LM's decoder blocks are the reference's ``init_lm`` choice:
    ``dec_cross`` for the encoder-decoder (with ``num_encoder_layers``
    ``enc`` blocks beside them), ``attn_ffn`` for the VLM."""
    cfg = get_config(arch)
    kinds = {T.decoder_kind(cfg, i) for i in range(cfg.num_layers)}
    assert kinds == ({"dec_cross"} if cfg.is_encoder_decoder
                     else {"attn_ffn"})
    lm = build_model(cfg.reduced(), "cpu").init(0)
    jshapes = jax.eval_shape(
        lambda: JT.init_lm(jax.random.PRNGKey(0), jax_get_config(arch)
                           .reduced())[0])
    assert set(lm.layers[0]) == set(jshapes["layers"])
    if cfg.is_encoder_decoder:
        assert set(lm.enc_layers[0]) == set(jshapes["enc_layers"])
        assert len(lm.enc_layers) == cfg.reduced().num_encoder_layers
    else:
        assert "enc_layers" not in jshapes and lm.enc_layers is None


# ------------------------------------------------------------- MoE layer --

def _moe_params(jc, seed=0):
    jp, _ = JL.init_moe(jax.random.PRNGKey(seed), jc)
    return {k: np.array(v) for k, v in jp.items()}


def _torch_params(jp):
    return torch.nn.ParameterDict({k: L._param(_t(v)) for k, v in jp.items()})


def _ref_moe(jp, x, jc, monkeypatch):
    """The reference's ``apply_moe`` output with its routing: the chosen
    experts (``lax.top_k``) and its dense dispatch and combine tensors."""
    seen = {}
    top_k, constrain = jax.lax.top_k, JL.constrain

    def recording_top_k(a, k):
        v, i = top_k(a, k)
        seen["expert"] = np.asarray(i)
        return v, i

    def recording_constrain(a, *axes):
        if axes == ("batch", None, "experts", None):
            seen["combine" if "dispatch" in seen else "dispatch"] = (
                np.asarray(a))
        return constrain(a, *axes)

    with monkeypatch.context() as m:
        m.setattr(jax.lax, "top_k", recording_top_k)
        m.setattr(JL, "constrain", recording_constrain)
        y = JL.apply_moe({k: jnp.asarray(v) for k, v in jp.items()},
                         jnp.asarray(x), jc)
    return np.asarray(y), seen


def _port_moe(jp, x, tc, monkeypatch):
    """The port's ``apply_moe`` output and the routing it computed."""
    seen = []
    route = L.moe_route

    def recording_route(*args):
        r = route(*args)
        seen.append(r)
        return r

    with monkeypatch.context() as m:
        m.setattr(L, "moe_route", recording_route)
        y = L.apply_moe(_torch_params(jp), _t(x), tc)
    assert len(seen) == 1
    return y, seen[0]


def _dense_routing(r, num_experts, cap):
    """The port's routing as the reference's (g, s, e, c) dispatch and
    combine tensors."""
    g, s, k = r.expert.shape
    dispatch = np.zeros((g, s, num_experts, cap), np.float32)
    combine = np.zeros_like(dispatch)
    expert, pos = r.expert.numpy(), r.pos.numpy()
    keep, weight = r.keep.numpy(), r.weight.detach().numpy()
    for gi, si, j in zip(*np.nonzero(keep)):
        dispatch[gi, si, expert[gi, si, j], pos[gi, si, j]] = 1.0
        combine[gi, si, expert[gi, si, j], pos[gi, si, j]] = weight[gi, si, j]
    return dispatch, combine


def _assert_moe_matches(arch, groups, group_size, capacity_factor, zero_rows,
                        repeats, seed, monkeypatch):
    jc, tc = _cfgs(arch, moe_group_size=group_size,
                   capacity_factor=capacity_factor)
    jp = _moe_params(jc, seed)
    rng = np.random.default_rng(seed)
    n = groups * group_size
    b = 2 if n % 2 == 0 else 1
    x = rng.normal(size=(n, jc.d_model)).astype(np.float32)
    if repeats:      # identical tokens pick identical experts: drops
        x[1:1 + repeats] = x[0]
    x[rng.permutation(n)[:zero_rows]] = 0.0   # uniform gates: ties
    x = x.reshape(b, n // b, jc.d_model)
    want, ref = _ref_moe(jp, x, jc, monkeypatch)
    got, r = _port_moe(jp, x, tc, monkeypatch)
    _, g, cap = L.moe_groups(n, tc)
    assert g == groups
    np.testing.assert_array_equal(r.expert.numpy(), ref["expert"])
    dispatch, combine = _dense_routing(r, tc.num_experts, cap)
    np.testing.assert_array_equal(dispatch, ref["dispatch"])
    np.testing.assert_allclose(combine, ref["combine"], rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    if tc.top_k == 1:    # top-1: the normalised gate is 1.0
        assert bool((r.weight == 1.0).all())
    return r, cap


@settings(max_examples=30, deadline=None, derandomize=True)
@given(arch=st.sampled_from(MOE_ARCHS), groups=st.sampled_from([1, 2, 4]),
       group_size=st.sampled_from([4, 8, 16]),
       capacity_factor=st.sampled_from([0.25, 0.5, 1.25, 2.0]),
       zero_rows=st.integers(0, 3), repeats=st.integers(0, 5),
       seed=st.integers(0, 2**16))
def test_apply_moe_routing_and_output_match(arch, groups, group_size,
                                            capacity_factor, zero_rows,
                                            repeats, seed):
    with pytest.MonkeyPatch.context() as monkeypatch:
        _assert_moe_matches(arch, groups, group_size, capacity_factor,
                            zero_rows, repeats, seed, monkeypatch)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("groups", [1, 2, 4])
def test_apply_moe_drops_pairs_past_the_capacity(arch, groups, monkeypatch):
    """Capacity factor 0.25 over groups of 16 tokens, six of them
    identical: pairs are dropped in every group, as the reference
    drops them."""
    r, cap = _assert_moe_matches(arch, groups, 16, 0.25, 0, 5, groups,
                                 monkeypatch)
    assert cap == 1 and not bool(r.keep.all())
    # dropped pairs are exactly those past the capacity
    assert torch.equal(r.keep, r.pos < cap)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_apply_moe_all_zero_rows_take_the_lower_experts(arch, monkeypatch):
    """An all-zero token has uniform gates: lax.top_k's tie order picks
    experts 0 .. k-1, with equal normalised weights."""
    r, _ = _assert_moe_matches(arch, 1, 8, 4.0, 8, 0, 3, monkeypatch)
    k = r.expert.shape[-1]
    assert r.expert.tolist() == [[list(range(k))] * 8]
    torch.testing.assert_close(r.weight, torch.full_like(r.weight, 1 / k))


def test_moe_matches_dense_expert_oracle():
    """The reference's ``test_moe_matches_dense_expert_oracle`` on the
    port: with top_k == num_experts and generous capacity every token
    reaches every expert, so the output is the gate-weighted sum of the
    expert FFNs."""
    _, cfg = _cfgs("deepseek_moe_16b", num_experts=4, top_k=4,
                   num_shared_experts=0, capacity_factor=4.0,
                   moe_group_size=16)
    p = L.init_moe(cfg, generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 8, cfg.d_model,
                    generator=torch.Generator().manual_seed(1)) * 0.1
    out = L.apply_moe(p, x, cfg).reshape(-1, cfg.d_model)
    xt = x.reshape(-1, cfg.d_model)
    gates = torch.softmax(xt @ p["router"], -1)
    dense = torch.zeros_like(xt)
    for e in range(4):
        h = torch.nn.functional.silu(xt @ p["w_gate"][e]) * (xt
                                                              @ p["w_up"][e])
        dense += gates[:, e:e + 1] * (h @ p["w_down"][e])
    torch.testing.assert_close(out.detach(), dense.detach(), rtol=2e-3,
                               atol=2e-4)


def test_moe_capacity_drops_tokens():
    """The reference's ``test_moe_capacity_drops_tokens``: 16 identical
    tokens, capacity 1: one token is served, the rest are zero."""
    _, cfg = _cfgs("deepseek_moe_16b", num_experts=2, top_k=1,
                   num_shared_experts=0, capacity_factor=0.2,
                   moe_group_size=16)
    p = L.init_moe(cfg, generator=torch.Generator().manual_seed(0))
    x = torch.randn(1, 1, cfg.d_model,
                    generator=torch.Generator().manual_seed(1)).expand(
        1, 16, cfg.d_model)
    out = L.apply_moe(p, x, cfg).detach()
    assert int((out[0].abs().amax(-1) > 1e-6).sum()) == 1


@pytest.mark.parametrize("tokens,group", [(30, 16), (12, 8), (40, 32)])
def test_tokens_off_the_group_raise(tokens, group):
    jc, tc = _cfgs("deepseek_moe_16b", moe_group_size=group)
    jp = _moe_params(jc)
    x = np.zeros((1, tokens, jc.d_model), np.float32)
    with pytest.raises(AssertionError):
        JL.apply_moe({k: jnp.asarray(v) for k, v in jp.items()},
                     jnp.asarray(x), jc)
    with pytest.raises(ValueError, match="multiple of the MoE group"):
        L.apply_moe(_torch_params(jp), _t(x), tc)


@pytest.mark.parametrize("arch,tokens,cap", [
    ("deepseek_moe_16b", 32, 3), ("llama4_scout_17b_a16e", 32, 2),
    ("deepseek_moe_16b", 16_384, 120), ("llama4_scout_17b_a16e", 16_384, 80),
    ("deepseek_moe_16b", 4_096, 120)])
def test_moe_groups_at_full_width(arch, tokens, cap):
    """Decode of a batch of 32 (one group, small capacity), a 32 x 512
    prefill and an 8 x 512 training batch (groups of 1,024)."""
    cfg = get_config(arch)
    g_sz, g, c = L.moe_groups(tokens, cfg)
    assert (g_sz, g, c) == (min(1024, tokens), max(1, tokens // 1024), cap)
    assert c == max(int(g_sz * cfg.top_k * cfg.capacity_factor
                        / cfg.num_experts), 1)


def test_moe_ignores_imc_linear():
    """The reference's ``apply_moe`` never calls ``_imc_linear``: with
    ``imc_linear`` on, an MoE layer computes the same values and runs no
    ``imc_mvm``."""
    _, tc = _cfgs("deepseek_moe_16b")
    p = L.init_moe(tc, generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 16, 64, generator=torch.Generator().manual_seed(1))
    calls = imc_mvm_plain.calls
    y = L.apply_moe(p, x, dataclasses.replace(tc, imc_linear=True))
    assert imc_mvm_plain.calls == calls
    assert torch.equal(y, L.apply_moe(p, x, tc))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_init_moe_meets_the_references_shapes_and_scales(arch):
    cfg = dataclasses.replace(get_config(arch).reduced(), d_model=256,
                              expert_d_ff=256, dtype="bfloat16")
    p = L.init_moe(cfg, generator=torch.Generator().manual_seed(0))
    want = jax.eval_shape(lambda: JL.init_moe(jax.random.PRNGKey(0),
                                              cfg)[0])
    assert set(p) == set(want)
    scales = {"router": 256 ** -0.5, "w_gate": 256 ** -0.5,
              "w_up": 256 ** -0.5, "w_down": 256 ** -0.5,
              "shared_gate": 256 ** -0.5, "shared_up": 256 ** -0.5,
              "shared_down": 256 ** -0.5}
    for name, t in p.items():
        assert tuple(t.shape) == want[name].shape, name
        # the router stays float32: the reference never casts it
        assert t.dtype == (torch.float32 if name == "router"
                           else torch.bfloat16), name
        assert abs(float(t.float().std()) / scales[name] - 1) < 0.05, name
    trained = L.init_moe(cfg, trainable=True)
    assert all(t.dtype == torch.float32 and t.requires_grad
               for t in trained.values())


def test_lm_params_from_numpy_carries_an_moe_tree():
    arch = "deepseek_moe_16b"
    params, _, _ = _ref_init(arch)
    _, tc = _cfgs(arch)
    lm = lm_params_from_numpy(params, dataclasses.replace(
        tc, dtype="bfloat16"), "cpu")
    assert len(lm.layers) == tc.num_layers
    for i, lp in enumerate(lm.layers):
        assert set(lp) == {"norm1", "attn", "norm2", "moe"}
        for name, a in params["layers"]["moe"].items():
            t = lp["moe"][name]
            assert tuple(t.shape) == a.shape[1:], name
            if name == "router":
                assert t.dtype == torch.float32
                np.testing.assert_array_equal(t.numpy(), a[i])
            else:
                assert t.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="attn_ffn"):
        lm_params_from_numpy(params, get_config("gemma_7b").reduced(), "cpu")


# ------------------------------------------------------- the whole model --

@pytest.mark.parametrize("arch", NEW_ARCHS)
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
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", NEW_ARCHS)
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
        np.testing.assert_allclose(g.numpy(), _ref_leaf(jgrads, name),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("arch", NEW_ARCHS)
@pytest.mark.parametrize("batch,seq", [(2, 16), (5, 32)])
@pytest.mark.parametrize("kv_quant", [False, True])
def test_prefill_and_decode_match_the_reference(arch, batch, seq, kv_quant):
    """Model.prefill, then 6 decode steps teacher-forced on the reference's
    greedy tokens: greedy tokens equal, logits within 1e-4 with the
    float32 cache. With the int8 cache a code may differ from the
    reference's by one (``x / scale`` on a .5 boundary rounds either way
    when ``x`` differs in its last float32 bit), which moves that step's
    logits by up to ~1e-3: held at 2e-3, and every code within one of
    the reference's. Decode routes the batch's tokens as one group:
    capacity 1 at B = 2 and 5 for the reduced MoE configs, so pairs are
    dropped."""
    jc, tc = _cfgs(arch, kv_quant_int8=kv_quant)
    params = _ref_init(arch)[0]
    jm, tm = jax_build_model(jc), build_model(tc, "cpu")
    jparams = jax.tree.map(jnp.asarray, params)
    tparams = lm_params_from_numpy(params, tc, "cpu")
    gen = 7
    jbatch = JaxTokenPipeline(batch, seq, jc.vocab_size).get_for(jc, 3)
    tbatch = TokenPipeline(batch, seq, tc.vocab_size).get_for(tc, 3, "cpu")
    jcache = jm.init_cache(batch, seq + gen)
    tcache = tm.init_cache(batch, seq + gen)
    lj, jcache = jm.prefill(jparams, jbatch, jcache)
    lt, tcache = tm.prefill(tparams, tbatch, tcache)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-4,
                               atol=1e-4)
    if tc.is_moe:
        assert L.moe_groups(batch, tc)[2] == 1
    tok = jnp.argmax(lj[:, -1:], axis=-1).astype(jnp.int32)
    launches = decode_attention.launches
    tol = 2e-3 if kv_quant else 1e-4
    for i in range(gen - 1):
        lj, jcache = jm.decode_step(jparams, tok, jcache,
                                    jnp.asarray(seq + i, jnp.int32))
        lt, tcache = tm.decode_step(tparams, _t(tok), tcache, seq + i)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=tol,
                                   atol=tol)
        tok = jnp.argmax(lj, axis=-1).astype(jnp.int32)
        np.testing.assert_array_equal(torch.argmax(lt, -1).numpy(),
                                      np.asarray(tok))
    assert decode_attention.launches == launches   # CPU: the plain version
    if kv_quant:
        for i, c in enumerate(tcache):
            for name in ("k", "v"):
                d = (getattr(c, name).numpy().astype(np.int32)
                     - np.asarray(getattr(jcache, name)[i], np.int32))
                assert np.abs(d).max() <= 1, (i, name)


def _assert_step_params(got, ref_params, ref_grads, lr):
    for name, p in got.params.named_parameters():
        want = _ref_leaf(ref_params, name)
        g = np.abs(_ref_leaf(ref_grads, name))
        d = np.abs(p.detach().numpy() - want)
        firm = g > 1e-5
        assert (d[firm] <= 1e-6 + 1e-5 * np.abs(want[firm])).all(), name
        assert (d <= 2 * lr + 1e-6).all(), name


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_train_step_matches_the_reference(arch):
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
    jgrads = _np(jax.grad(lambda p: jmodel.loss(p, jb))(jstate.params))
    jstate, jm = jax.jit(JS.make_train_step(
        jmodel, JS.TrainConfig(optimizer=JO.AdamWConfig(**opt))))(jstate, jb)
    step = make_train_step(build_model(tc, "cpu"), TrainConfig(
        optimizer=O.AdamWConfig(**opt)))
    state, m = step(train_state_from_numpy(params, mu, nu, 0, tc, "cpu"), tb)
    assert state.step == 1 and set(m) == set(jm)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-6)
    assert m["dcn_raw_bytes"] == float(jm["dcn_raw_bytes"])
    _assert_step_params(state, _np(jstate.params), jgrads, opt["lr"])


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_remat_policies_give_equal_loss_and_grads(arch):
    """``full`` recomputes each block, ``dots`` keeps the router and
    shared-expert products and recomputes the expert, dispatch and
    combine work: both give ``none``'s loss and gradients exactly."""
    _, tc = _cfgs(arch)
    model = build_model(tc, "cpu")
    lm = model.init(0, trainable=True)
    batch = TokenPipeline(B, S, tc.vocab_size).get_for(tc, 0, "cpu")
    out = {}
    for remat in ("full", "dots", "none"):
        loss = model.loss(lm, batch, remat=remat)
        out[remat] = (float(loss.detach()), torch.autograd.grad(
            loss, list(lm.parameters())))
    for remat in ("full", "dots"):
        assert out[remat][0] == out["none"][0]
        for a, b in zip(out[remat][1], out["none"][1]):
            assert torch.equal(a, b)


def test_dots_policy_saves_the_unbatched_moe_products():
    """Under ``dots`` the router's and the shared experts' products (``mm``)
    are kept; the experts' products (``bmm`` over the expert axis) are
    recomputed."""
    from torch.utils import checkpoint as ckpt
    seen, policy = [], T._save_dots

    def spy(ctx, op, *args, **kwargs):
        how = policy(ctx, op, *args, **kwargs)
        shapes = tuple(tuple(a.shape) for a in args[:2]
                       if isinstance(a, torch.Tensor))
        seen.append((op, shapes, how == ckpt.CheckpointPolicy.MUST_SAVE))
        return how

    _, tc = _cfgs("deepseek_moe_16b")
    e, d, f = tc.num_experts, tc.d_model, tc.expert_d_ff
    model = build_model(tc, "cpu")
    lm = model.init(0, trainable=True)
    batch = TokenPipeline(2, 16, tc.vocab_size).get_for(tc, 0, "cpu")
    with pytest.MonkeyPatch.context() as m:
        m.setattr(T, "_save_dots", spy)
        model.loss(lm, batch, remat="dots").backward()
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    router = [keep for op, sh, keep in seen if op == mm
              and sh[1:] == ((d, e),)]
    shared = [keep for op, sh, keep in seen if op == mm
              and sh[1:] == ((d, f * tc.num_shared_experts),)]
    experts = [keep for op, sh, keep in seen if op == bmm
               and sh[1:] == ((e, d, f),)]
    assert router and all(router)
    assert shared and all(shared)
    assert experts and not any(experts)


# --------------------------------------------------------------- launchers --

@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_serve_launcher_runs_each_new_config_on_the_cpu(arch, capsys):
    run = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--kv-quant", "--batch", "2", "--prompt-len", "16",
                      "--gen", "4"])
    out = capsys.readouterr().out
    assert f"model: {arch}_reduced" in out
    assert "decode_attention launches: 0" in out
    assert run.tokens.shape == (2, 4)
    assert int(run.tokens.max()) < run.model.cfg.padded_vocab


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_train_launcher_runs_each_new_config_on_the_cpu(arch, capsys):
    state = train_cli.main(["--arch", arch, "--reduced", "--device", "cpu",
                            "--steps", "2", "--batch", "2", "--seq", "32",
                            "--log-every", "1"])
    out = capsys.readouterr().out
    assert "step 2: loss=" in out and "done: 2 steps" in out
    assert state.step == 2


def test_imc_linear_moe_training_routes_nothing_through_the_kernel(capsys):
    """``--imc-linear`` on an MoE config: the layers are MoE, so no
    ``imc_mvm`` runs, as in the reference."""
    calls = imc_mvm_plain.calls
    train_cli.main(["--arch", "llama4_scout_17b_a16e", "--reduced",
                    "--device", "cpu", "--steps", "1", "--batch", "2",
                    "--seq", "16", "--imc-linear"])
    assert imc_mvm_plain.calls == calls
    assert "done: 1 steps" in capsys.readouterr().out
