"""The MoE (expert-parallel), encoder-decoder and VLM families over a
device mesh (serving and training on DTensors) against the JAX package on
one device, on gloo CPU ranks.

The ranks are processes started with ``spawn`` from
``tests/_torch_family_mesh_ranks.py`` (which imports no JAX): 2 ranks
(the ``(1, 2)`` and ``(2, 1)`` meshes) and 4 ranks (``(2, 2)`` and
``(1, 4)``), both worlds at once, through ``file://`` stores under the
test's temporary directory; they join within ``JOIN_TIMEOUT_S`` or are
killed and the tests fail. The test process computes the reference on
one device (``repro.dist.sharding.set_mesh(None)``) while the ranks run.
Both sides start from the reference's parameters, carried to the ranks as
numpy and placed by ``convert``'s ``mesh=``.

Configs: the reduced ``deepseek_moe_16b`` (8 experts, top-2, a shared
expert) and ``llama4_scout_17b_a16e`` (8 experts, top-1, a shared expert),
both with token groups of 32, ``whisper_medium`` (2 encoder and 2 decoder
layers; also with ``imc_linear``) and ``internvl2_76b`` (2 patches before
14 tokens), all float32. A training or forward batch is 4 x 16: 64 tokens,
two MoE groups, one a data rank on ``data`` = 2; a decode step's 4 tokens
are one group, which does not divide ``data`` = 2, so every rank routes it
whole, as the reference replicates it.

Tolerances (float32):
- ``forward_train`` logits, the prefill's and the forced decode's logits
  with the plain KV cache: rtol / atol 1e-4, as ``tests/test_torch_lm_mesh.py``
  (the ranks sum partial products in other orders); decode steps with the
  int8 KV cache: rtol / atol 2e-3 (a k or v element at a code's .5
  boundary rounds to either code as the sums' order moves it by an ulp,
  ``tests/test_torch_lm_mesh.py``);
- every MoE routing decision (the chosen experts in ``lax.top_k``'s order,
  each pair's arrival position and whether it fits the capacity, i.e. the
  reference's whole dispatch tensor) in the forward and in every decode
  step: exact, on every rank; the MoE layer alone, on random tokens and on
  tokens that all pick the same experts (each group overflows its
  capacity): routing exact, output rtol 1e-5 / atol 1e-6
  (``tests/test_torch_moe.py``'s);
- 3 train steps (Whisper with ``imc_linear``): losses and grad norms rtol
  1e-4; every parameter within ``2 * lr`` a step of the reference's (a
  gradient whose sign is rounding noise moves its weight by up to a whole
  ``lr``, ``tests/test_torch_train.py``), and the mean difference under
  1e-2 ``lr``;
- every rank's whole results equal rank 0's, and an MoE checkpoint moves
  from ``(2, 2)`` to ``(1, 4)`` and to one device bit for bit.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_family_mesh_ranks as R
from repro.configs import get_config as jax_get_config
from repro.data.tokens import TokenPipeline as JaxTokenPipeline
from repro.dist import sharding as JSH
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.model_zoo import build_model as jax_build_model
from repro.train import optimizer as JO
from repro.train import train_step as JS
from repro_torch.convert import lm_params_from_numpy, train_state_from_numpy
from repro_torch.dist import sharding as SH
from repro_torch.dist.checkpoint import CheckpointManager
from repro_torch.launch import serve, train
from repro_torch.models import layers as L
from repro_torch.models.model_zoo import build_model

torch.set_num_threads(1)

JOIN_TIMEOUT_S = 300
WORLDS = (2, 4)
MESHES = [(w, s) for w in WORLDS for s in R.MESHES[w]]
MESH_IDS = [f"{w}ranks-{s[0]}x{s[1]}" for w, s in MESHES]
LAUNCH_TRAIN = ["--arch", "whisper_medium", "--reduced", "--steps", "2",
                "--batch", "4", "--seq", "16", "--device", "cpu",
                "--imc-linear", "--log-every", "1"]
LAUNCH_SERVE = ["--arch", "deepseek_moe_16b", "--reduced", "--device",
                "cpu", "--kv-quant", "--batch", "4", "--prompt-len", "16",
                "--gen", "4"]
TOL = dict(rtol=1e-4, atol=1e-4)
INT8_TOL = dict(rtol=2e-3, atol=2e-3)


@pytest.fixture(autouse=True)
def no_global_mesh():
    JSH.set_mesh(None)
    SH.set_mesh(None)
    yield
    SH.set_mesh(None)


def _jcfg(name: str, **kw):
    arch, over = R.CONFIGS[name]
    return dataclasses.replace(jax_get_config(arch).reduced(), **over, **kw)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _reference_init(name: str):
    state, _ = JS.init_train_state(jax_build_model(_jcfg(name)),
                                   jax.random.PRNGKey(0))
    return _np(state.params), _np(state.opt["mu"]), _np(state.opt["nu"])


def _port_leaves(params, name: str) -> list:
    """The reference's parameter tree as the port's leaves, in
    ``parameters()`` order (the layers' stacked leaves split)."""
    lm = lm_params_from_numpy(params, R.cfg_of(name), "cpu", trainable=True)
    return [p.detach().numpy() for p in lm.parameters()]


class _Routes:
    """Records the reference's MoE routings as it runs, jitted or scanned
    or not: each ``lax.top_k`` (the chosen experts) and each dispatch
    ``constrain`` (the (G, g_sz, E, cap) dispatch tensor), through ordered
    debug callbacks."""

    def __init__(self, monkeypatch):
        self.expert, self.dispatch = [], []
        top_k, constrain = jax.lax.top_k, JL.constrain
        pending = []

        def recording_top_k(a, k):
            v, i = top_k(a, k)
            jax.debug.callback(lambda t: self.expert.append(np.asarray(t)),
                               i, ordered=True)
            return v, i

        def recording_constrain(a, *axes):
            if axes == ("batch", None, "experts", None):
                # dispatch, then combine: keep every other one
                def keep(t):
                    pending.append(1)
                    if len(pending) % 2:
                        self.dispatch.append(np.asarray(t))
                jax.debug.callback(keep, a, ordered=True)
            return constrain(a, *axes)

        monkeypatch.setattr(jax.lax, "top_k", recording_top_k)
        monkeypatch.setattr(JL, "constrain", recording_constrain)

    def take(self):
        out = list(zip(self.expert, self.dispatch, strict=True))
        self.expert.clear()
        self.dispatch.clear()
        return out


def _family_forward(params, batch, jc):
    if jc.family == "vlm":
        tok_x = JT.embed_tokens(params, batch["tokens"], jc)
        x = jnp.concatenate([batch["patches"].astype(tok_x.dtype), tok_x],
                            axis=1)
        return JT.forward_train(params, x, jc, is_embedded=True)
    memory = None
    if jc.is_encoder_decoder:
        memory = JT.encode(params, batch["frames"], jc)
    return JT.forward_train(params, batch["tokens"], jc, memory=memory)


def _reference_serve(params, name: str, kv: bool, routes: _Routes):
    """Prefill and GEN - 1 forced decode steps (Whisper's cross K/V cut to
    the memory's rows, a correct cache, ROADMAP.md Queue 3 F4): every
    step's logits and the decode steps' routings."""
    jc = _jcfg(name, kv_quant_int8=kv)
    model = jax_build_model(jc)
    batch = JaxTokenPipeline(R.SERVE_B, R.PROMPT, jc.vocab_size).get_for(
        jc, 0)
    start = R.decode_start(jc)
    cache = model.init_cache(R.SERVE_B, start + R.GEN)
    logits, cache = jax.jit(model.prefill)(params, batch, cache)
    if jc.is_encoder_decoder:
        n = batch["frames"].shape[1]
        cache = (cache[0], tuple(a[:, :, :n] for a in cache[1]))
    steps = [np.asarray(logits)]
    forced = R.forced_tokens(jc.vocab_size)
    jax.effects_barrier()
    routes.take()
    decode = jax.jit(model.decode_step)
    for i in range(R.GEN - 1):
        logits, cache = decode(
            params, jnp.asarray(forced[:, i:i + 1]), cache,
            jnp.asarray(start + i, jnp.int32))
        steps.append(np.asarray(logits))
    jax.effects_barrier()
    return {"logits": steps, "routes": routes.take()}


def _reference(inits: dict, moe_layer: dict, monkeypatch) -> dict:
    """Everything the ranks compute, by the reference on one device."""
    out = {"forward": {}, "train": {}, "serve": {}, "moe_layer": {}}
    routes = _Routes(monkeypatch)
    for name in R.FORWARD:
        jc = _jcfg(name)
        batch = JaxTokenPipeline(R.B, R.S, jc.vocab_size).get_for(jc, 1)
        params = jax.tree.map(jnp.asarray, inits[name][0])
        out["forward"][name] = np.asarray(jax.jit(
            lambda p, b, jc=jc: _family_forward(p, b, jc))(params, batch))
        jax.effects_barrier()
        out["forward"][f"{name}_routes"] = routes.take()
    for name in R.SERVED:
        params = jax.tree.map(jnp.asarray, inits[name][0])
        for kv in (False, True):
            out["serve"][name, kv] = _reference_serve(params, name, kv,
                                                      routes)
    jc = _jcfg("deepseek")
    p = jax.tree.map(jnp.asarray, moe_layer)
    for case in R.LAYER_CASES:
        x = jnp.asarray(R.layer_input(case, jc.d_model))
        y = np.asarray(JL.apply_moe(p, x, jc))
        jax.effects_barrier()
        out["moe_layer"][case] = {"y": y, "routes": routes.take()}
    monkeypatch.undo()
    for name in R.TRAINED:
        jc = _jcfg(name)
        model = jax_build_model(jc)
        params, mu, nu = (jax.tree.map(jnp.asarray, t) for t in inits[name])
        state = JS.TrainState(params=params, opt={
            "mu": mu, "nu": nu, "step": jnp.zeros((), jnp.int32)},
            step=jnp.zeros((), jnp.int32))
        step = jax.jit(JS.make_train_step(model, JS.TrainConfig(
            optimizer=JO.AdamWConfig(**R.OPT))))
        pipe = JaxTokenPipeline(R.B, R.S, jc.vocab_size)
        losses, norms = [], []
        for i in range(R.STEPS):
            state, m = step(state, pipe.get_for(jc, i))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        out["train"][name] = (losses, norms, _port_leaves(
            _np(state.params), name))
    return out


def _one_process_launchers() -> dict:
    st = train.main(LAUNCH_TRAIN)
    run = serve.main(LAUNCH_SERVE)
    return {"params": [p.detach().numpy().copy()
                       for p in st.params.parameters()],
            "tokens": run.tokens.numpy().copy()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both worlds' ranks (started first), the reference and the
    one-process launchers (computed while the ranks run)."""
    JSH.set_mesh(None)
    # imc_linear changes no parameter: one draw an architecture
    drawn = {}
    for name in R.CONFIGS:
        arch = R.CONFIGS[name][0]
        if arch not in drawn:
            drawn[arch] = _reference_init(name)
    inits = {name: drawn[R.CONFIGS[name][0]] for name in R.CONFIGS}
    inputs = {key: {name: inits[name][i] for name in R.CONFIGS}
              for i, key in enumerate(("params", "mu", "nu"))}
    moe_layer, _ = JL.init_moe(jax.random.PRNGKey(3), _jcfg("deepseek"))
    inputs["moe_layer"] = _np(moe_layer)
    started = {}
    for world in WORLDS:
        out = tmp_path_factory.mktemp(f"family_mesh{world}")
        started[world] = (R.start(world, out, dict(
            inputs, launchers=(LAUNCH_TRAIN, LAUNCH_SERVE)
            if world == 2 else None)), out)
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        with pytest.MonkeyPatch.context() as mp:
            ref = _reference(inits, inputs["moe_layer"], mp)
        one = _one_process_launchers()
    except BaseException:
        for procs, _ in started.values():
            for p in procs:
                p.kill()
        raise
    ranks = {world: R.join(procs, out, deadline)
             for world, (procs, out) in started.items()}
    return {"ranks": ranks, "ref": ref, "one": one, "inits": inits,
            "dirs": {w: out for w, (_, out) in started.items()}}


def _rank0(run, world, shape):
    return run["ranks"][world][0][shape]


def _assembled(run, world, shape, get, groups: list) -> list:
    """The mesh's routings, call by call, over all the groups: the ranks
    of model coordinate 0 in data order each hold their data block's
    groups, or, where a rank holds them all (the groups do not divide
    ``data``), rank 0's; every rank of a data block holds the same."""
    data, model = shape
    per_rank = [get(r[shape]) for r in run["ranks"][world]]
    out = []
    for c, g in enumerate(groups):
        parts = [per_rank[d * model][c] for d in range(data)]
        for d in range(data):
            for m in range(1, model):
                for a, b in zip(per_rank[d * model + m][c], parts[d]):
                    np.testing.assert_array_equal(a, b)
        if parts[0][0].shape[0] == g:
            for p in parts[1:]:
                for a, b in zip(p, parts[0]):
                    np.testing.assert_array_equal(a, b)
            out.append(parts[0])
        else:
            out.append(tuple(np.concatenate(t) for t in zip(*parts)))
    return out


def _assert_routes_equal(got: list, want: list, num_experts: int):
    """Each call's (expert, pos, keep) equals the reference's chosen
    experts and its dispatch tensor."""
    assert len(got) == len(want) > 0
    for (expert, pos, keep), (w_expert, w_dispatch) in zip(got, want):
        np.testing.assert_array_equal(expert, w_expert)
        dispatch = np.zeros_like(w_dispatch)
        for gi, si, j in zip(*np.nonzero(keep)):
            dispatch[gi, si, expert[gi, si, j], pos[gi, si, j]] = 1.0
        np.testing.assert_array_equal(dispatch, w_dispatch)
        assert w_dispatch.shape[2] == num_experts


# ------------------------------------------------------------ the cases --

@pytest.mark.parametrize("world,shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("name", R.FORWARD)
def test_forward_train_matches_the_reference(run, world, shape, name):
    got = _rank0(run, world, shape)["forward"]
    assert got[f"{name}_placed"]
    np.testing.assert_allclose(got[name], run["ref"]["forward"][name],
                               **TOL)


@pytest.mark.parametrize("world,shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("name", R.MOE)
def test_every_forward_routing_decision_matches(run, world, shape, name):
    want = run["ref"]["forward"][f"{name}_routes"]
    got = _assembled(run, world, shape,
                     lambda r: r["forward"][f"{name}_routes"],
                     [w[0].shape[0] for w in want])
    _assert_routes_equal(got, want, R.cfg_of(name).num_experts)


@pytest.mark.parametrize("world,shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("name", R.SERVED)
@pytest.mark.parametrize("kv_quant", [False, True])
def test_forced_decode_matches_the_reference(run, world, shape, name,
                                             kv_quant):
    got = _rank0(run, world, shape)["serve"][name, kv_quant]
    want = run["ref"]["serve"][name, kv_quant]
    assert len(got["logits"]) == len(want["logits"]) == R.GEN
    for step, (g, w) in enumerate(zip(got["logits"], want["logits"])):
        tol = INT8_TOL if kv_quant and step else TOL
        np.testing.assert_allclose(g, w, **tol, err_msg=f"step {step}")
    # each rank's caches hold its batch block and the kv heads its query
    # heads read; Whisper's cross K/V the memory's rows
    cfg = R.cfg_of(name)
    data, model = shape
    heads = cfg.num_heads // model if cfg.num_heads % model == 0 else \
        cfg.num_heads
    kv = max(heads // (cfg.num_heads // cfg.num_kv_heads), 1)
    rows = R.SERVE_B // data
    hd = cfg.resolved_head_dim
    assert got["shapes"]["kv"] == (rows, R.decode_start(cfg) + R.GEN, kv,
                                   hd)
    if cfg.is_encoder_decoder:
        assert got["shapes"]["cross"] == (rows, R.PROMPT // 2, kv, hd)


@pytest.mark.parametrize("world,shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("name", R.MOE)
@pytest.mark.parametrize("kv_quant", [False, True])
def test_every_decode_routing_decision_matches(run, world, shape, name,
                                               kv_quant):
    """One group of SERVE_B tokens a step: on ``data`` = 2 it does not
    divide, so every rank routes it whole (as the reference replicates
    it), with the reference's capacity drops."""
    want = run["ref"]["serve"][name, kv_quant]["routes"]
    got = _assembled(run, world, shape,
                     lambda r: r["serve"][name, kv_quant]["routes"],
                     [w[0].shape[0] for w in want])
    assert all(w[0].shape[0] == 1 for w in want)
    _assert_routes_equal(got, want, R.cfg_of(name).num_experts)


@pytest.mark.parametrize("world,shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("case", R.LAYER_CASES)
def test_moe_layer_routing_and_capacity_drops_match(run, world, shape,
                                                    case):
    want = run["ref"]["moe_layer"][case]
    got = _assembled(run, world, shape,
                     lambda r: r["moe_layer"][case]["routes"],
                     [w[0].shape[0] for w in want["routes"]])
    _assert_routes_equal(got, want["routes"],
                         R.cfg_of("deepseek").num_experts)
    keep = got[0][2]
    if case == "one_expert":
        # every token picks the same experts: each group overflows
        assert not keep.all() and keep.sum() < keep.size // 2
    np.testing.assert_allclose(_rank0(run, world, shape)["moe_layer"][case][
        "y"], want["y"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("world,shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("name", R.TRAINED)
def test_three_train_steps_match_the_reference(run, world, shape, name):
    losses, norms, params, placed = _rank0(run, world, shape)["train"][name]
    want_l, want_n, want_p = run["ref"]["train"][name]
    assert placed
    np.testing.assert_allclose(losses, want_l, rtol=1e-4)
    np.testing.assert_allclose(norms, want_n, rtol=1e-4)
    lr = R.OPT["lr"]
    diffs = [np.abs(g - w) for g, w in zip(params, want_p, strict=True)]
    assert max(float(d.max()) for d in diffs) <= 2 * lr * R.STEPS + 1e-6
    mean = sum(float(d.sum()) for d in diffs) / sum(d.size for d in diffs)
    assert mean <= 1e-2 * lr


@pytest.mark.parametrize("world,shape", MESHES, ids=MESH_IDS)
def test_every_rank_gathers_rank0s_results(run, world, shape):
    ranks = [r[shape] for r in run["ranks"][world]]
    for r in ranks[1:]:
        for name in R.FORWARD:
            np.testing.assert_array_equal(r["forward"][name],
                                          ranks[0]["forward"][name])
        for name in R.TRAINED:
            a, b = r["train"][name], ranks[0]["train"][name]
            assert a[0] == b[0] and a[1] == b[1]
            for x, y in zip(a[2], b[2]):
                np.testing.assert_array_equal(x, y)
        for key, s in r["serve"].items():
            for x, y in zip(s["logits"], ranks[0]["serve"][key]["logits"]):
                np.testing.assert_array_equal(x, y)
        for case in R.LAYER_CASES:
            np.testing.assert_array_equal(r["moe_layer"][case]["y"],
                                          ranks[0]["moe_layer"][case]["y"])


def test_moe_checkpoint_moves_between_meshes_bit_for_bit(run):
    ck = run["ranks"][4][0]["checkpoint"]
    assert ck["step"] == ck["restored_step"] == R.STEPS
    assert ck["restored_placed"]
    # the 3-D expert leaves: 2 of the 8 experts a rank on (1, 4)
    cfg = R.cfg_of("deepseek")
    assert ck["expert_local"] and all(
        s[0] == cfg.num_experts // 4 for s in ck["expert_local"])
    for a, b in zip(ck["restored"], ck["saved"], strict=True):
        np.testing.assert_array_equal(a, b)
    # and on one device, from the files the (2, 2) mesh wrote
    params, mu, nu = run["inits"]["deepseek"]
    target = train_state_from_numpy(params, mu, nu, 0, cfg, "cpu")
    step, back = CheckpointManager(run["dirs"][4] / "ckpt").restore_latest(
        target)
    assert step == R.STEPS
    leaves = list(back.params.parameters()) + back.opt["mu"] + back.opt["nu"]
    for a, b in zip(leaves, ck["saved"], strict=True):
        np.testing.assert_array_equal(a.detach().numpy(), b)
    for r in run["ranks"][4][1:]:
        for a, b in zip(r["checkpoint"]["restored"], ck["restored"]):
            np.testing.assert_array_equal(a, b)


def test_launchers_on_two_ranks(run):
    for rank, res in enumerate(run["ranks"][2]):
        got = res["launchers"]
        np.testing.assert_array_equal(got["tokens"], run["one"]["tokens"])
        for a, b in zip(got["params"], run["one"]["params"], strict=True):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=2 * 3e-4 * 2)
        # the recurrent and hybrid families and a DCN route over the
        # sharded model run there since item 5.6c-3
        assert got["serve_xlstm"] == got["train_hymba"] == "none"
        assert got["train_dcn"] == "none"
        printed = got["printed"]
        if rank == 0:
            assert "mesh: {'data': 1, 'model': 2} devices=2" in printed
            assert "step 2: loss=" in printed and "decode:" in printed
        else:
            assert printed == ""


@pytest.mark.parametrize("world", WORLDS)
def test_the_moe_combine_takes_the_gloo_route(run, world):
    for res in run["ranks"][world]:
        counts = res["collectives"]
        assert counts.get("all_reduce", 0) > 0
        assert counts.get("all_gather", 0) > 0
        assert counts.get("reduce_scatter", 0) > 0


# ---------------------------------------------- one process, no group --

@pytest.mark.parametrize("name", list(R.CONFIGS))
def test_a_mesh_family_builds_over_ranks(name):
    model = build_model(R.cfg_of(name), "cpu", {"data": 2, "model": 2})
    assert model.mesh == {"data": 2, "model": 2}


@pytest.mark.parametrize("arch", ["xlstm_125m", "hymba_1_5b"])
def test_the_recurrent_families_over_ranks_raise(arch):
    """They raised over more than one rank until item 5.6c-3; they build
    now (``tests/test_torch_recurrent_mesh.py`` runs them)."""
    from repro_torch.configs import get_config

    model = build_model(get_config(arch).reduced(), "cpu",
                        {"data": 1, "model": 2})
    assert model.mesh == {"data": 1, "model": 2}
