"""The dense LM over a device mesh (serving and training on DTensors)
against the JAX package on one device, on gloo CPU ranks.

The ranks are processes started with ``spawn`` from
``tests/_torch_lm_mesh_ranks.py`` (which imports no JAX): 2 ranks (the
``(1, 2)`` and ``(2, 1)`` meshes) and 4 ranks (``(2, 2)`` and ``(1, 4)``),
both worlds at once, through ``file://`` stores under the test's
temporary directory; they join within ``JOIN_TIMEOUT_S`` or are killed
and the tests fail. The test process computes the reference (its own
8-device SPMD test fails under JAX 0.9, so on one device,
``repro.dist.sharding.set_mesh(None)``) while the ranks run. Both sides
start from the reference's parameters, carried to the ranks as numpy and
placed by ``convert``'s ``mesh=``.

Configs: ``qwen2_7b.reduced()`` (d_ff 128: an ``ff`` shard is not a whole
128-column tile, so ``_imc_linear`` gathers ``ff`` first) and the same
with d_ff 512 (whole tiles on ``model`` = 2 and 4: the chain runs on each
rank's shard), each with ``imc_linear`` off and on.

Tolerances (float32):
- ``forward_train`` logits, the prefill's and the forced decode's logits
  with the plain KV cache: rtol / atol 1e-4, ``tests/test_torch_lm.py``'s
  through a whole model (the ranks sum partial products in other
  orders); the decode steps with the int8 KV cache: rtol / atol 2e-3. A
  k or v element at a code's .5 boundary rounds to either code as the
  sums' order moves it by an ulp, which moves its value by its scale
  (``|x|max / 127``): the one-process port differs from the reference by
  up to 9.0e-4 on these inputs through that alone, and the bound is twice
  it;
- 3 train steps: losses and grad norms rtol 1e-4 (the reference's SPMD
  tolerance, ``tests/test_multidevice.py``); every parameter within
  ``2 * lr`` a step of the reference's (AdamW's first update is
  ``lr * g / (|g| + eps)``: a gradient whose sign is rounding noise moves
  its weight by up to a whole ``lr`` either way, as
  ``tests/test_torch_train.py`` states), and the mean difference under
  1e-2 ``lr``;
- ``_imc_linear`` with the row maxima on one rank's shard: rtol / atol
  1e-5 against the reference's (the ranks' scaled partial outputs are
  summed in another order), while the chain scaled by each rank's own
  maxima misses it by more than 1e-2;
- every rank's whole results equal rank 0's, and a checkpoint moves
  between meshes and to one device bit for bit.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_lm_mesh_ranks as R
from repro.configs import get_config as jax_get_config
from repro.data.tokens import TokenPipeline as JaxTokenPipeline
from repro.dist import sharding as JSH
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.model_zoo import build_model as jax_build_model
from repro.train import optimizer as JO
from repro.train import train_step as JS
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy, train_state_from_numpy
from repro_torch.dist import sharding as SH
from repro_torch.dist.checkpoint import CheckpointManager
from repro_torch.launch import serve, train
from repro_torch.models import layers as L
from repro_torch.train.train_step import TrainConfig, make_train_step

torch.set_num_threads(1)

JOIN_TIMEOUT_S = 300
WORLDS = (2, 4)
MESHES = [(w, s) for w in WORLDS for s in R.MESHES[w]]
MESH_IDS = [f"{w}ranks-{s[0]}x{s[1]}" for w, s in MESHES]
LAUNCH_TRAIN = ["--arch", "qwen2_7b", "--reduced", "--steps", "2",
                "--batch", "4", "--seq", "16", "--device", "cpu",
                "--log-every", "1"]
LAUNCH_SERVE = ["--arch", "qwen2_7b", "--reduced", "--device", "cpu",
                "--kv-quant", "--batch", "2", "--prompt-len", "16",
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
    return dataclasses.replace(jax_get_config("qwen2_7b").reduced(),
                               **R.CONFIGS[name], **kw)


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


def _reference(inits: dict) -> dict:
    """Everything the ranks compute, by the reference on one device."""
    out = {"forward": {}, "train": {}, "serve": {}}
    for name in R.CONFIGS:
        jc = _jcfg(name)
        tokens = JaxTokenPipeline(R.B, R.S, jc.vocab_size).get_for(
            jc, 1)["tokens"]
        out["forward"][name] = np.asarray(JT.forward_train(
            jax.tree.map(jnp.asarray, inits[name][0]), tokens, jc))
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
    for kv in (False, True):
        jc = _jcfg("ff128", kv_quant_int8=kv)
        model = jax_build_model(jc)
        params = jax.tree.map(jnp.asarray, inits["ff128"][0])
        batch = JaxTokenPipeline(R.SERVE_B, R.PROMPT, jc.vocab_size).get_for(
            jc, 0)
        cache = model.init_cache(R.SERVE_B, R.PROMPT + R.GEN)
        logits, cache = model.prefill(params, batch, cache)
        steps = [np.asarray(logits)]
        forced = R.forced_tokens(jc.vocab_size)
        for i in range(R.GEN - 1):
            logits, cache = model.decode_step(
                params, jnp.asarray(forced[:, i:i + 1]), cache,
                jnp.asarray(R.PROMPT + i, jnp.int32))
            steps.append(np.asarray(logits))
        out["serve"][kv] = steps
    h, w = R.amax_inputs()
    out["amax"] = np.asarray(JL._imc_linear(jnp.asarray(h), jnp.asarray(w),
                                            _jcfg("ff512_imc")))
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
    # imc_linear changes no parameter: one draw a width
    widths = {R.CONFIGS[n].get("d_ff"): n for n in ("ff128", "ff512")}
    drawn = {d: _reference_init(n) for d, n in widths.items()}
    inits = {name: drawn[R.CONFIGS[name].get("d_ff")] for name in R.CONFIGS}
    inputs = {key: {name: inits[name][i] for name in R.CONFIGS}
              for i, key in enumerate(("params", "mu", "nu"))}
    started = {}
    for world in WORLDS:
        out = tmp_path_factory.mktemp(f"lm_mesh{world}")
        started[world] = (R.start(world, out, dict(
            inputs, launchers=(LAUNCH_TRAIN, LAUNCH_SERVE)
            if world == 2 else None)), out)
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        ref = _reference(inits)
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


# ------------------------------------------------------------ the cases --

@pytest.mark.parametrize("world,shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("name", list(R.CONFIGS))
def test_forward_train_matches_the_reference(run, world, shape, name):
    got = _rank0(run, world, shape)["forward"]
    assert got[f"{name}_placed"]
    np.testing.assert_allclose(got[name], run["ref"]["forward"][name],
                               **TOL)


@pytest.mark.parametrize("world,shape", MESHES, ids=MESH_IDS)
def test_baseline_mode_moves_the_constrains_not_the_values(run, world,
                                                           shape):
    got = _rank0(run, world, shape)["forward"]["ff128_baseline"]
    np.testing.assert_allclose(got, run["ref"]["forward"]["ff128"], **TOL)


@pytest.mark.parametrize("world,shape", MESHES, ids=MESH_IDS)
def test_remat_policies_agree_on_the_mesh(run, world, shape):
    """One imc_linear step under remat none / dots / full on the mesh:
    the recompute repeats the forward's collectives and the analog
    chain's inputs, so the loss and the parameters are bit for bit the
    same."""
    got = _rank0(run, world, shape)["remat"]
    for policy in ("none", "dots"):
        assert got[policy][0] == got["full"][0]
        for a, b in zip(got[policy][1], got["full"][1], strict=True):
            np.testing.assert_array_equal(a, b)


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
@pytest.mark.parametrize("kv_quant", [False, True])
def test_forced_decode_matches_the_reference(run, world, shape, kv_quant):
    got = _rank0(run, world, shape)["serve"][kv_quant]
    want = run["ref"]["serve"][kv_quant]
    assert len(got["logits"]) == len(want) == R.GEN
    for step, (g, w) in enumerate(zip(got["logits"], want)):
        tol = INT8_TOL if kv_quant and step else TOL
        np.testing.assert_allclose(g, w, **tol, err_msg=f"step {step}")
    # each rank's cache holds its batch block and the kv heads its query
    # heads read
    cfg = R.cfg_of("ff128")
    data, model = shape
    heads = cfg.num_heads // model if cfg.num_heads % model == 0 else \
        cfg.num_heads
    kv = max(heads // (cfg.num_heads // cfg.num_kv_heads), 1)
    assert got["cache_shape"] == (R.SERVE_B // data, R.PROMPT + R.GEN, kv,
                                  cfg.resolved_head_dim)


@pytest.mark.parametrize("world,shape", MESHES, ids=MESH_IDS)
def test_every_rank_gathers_rank0s_results(run, world, shape):
    ranks = [r[shape] for r in run["ranks"][world]]
    for r in ranks[1:]:
        for name in R.CONFIGS:
            np.testing.assert_array_equal(r["forward"][name],
                                          ranks[0]["forward"][name])
        for name in R.TRAINED:
            a, b = r["train"][name], ranks[0]["train"][name]
            assert a[0] == b[0] and a[1] == b[1]
            for x, y in zip(a[2], b[2]):
                np.testing.assert_array_equal(x, y)
        for kv in (False, True):
            for x, y in zip(r["serve"][kv]["logits"],
                            ranks[0]["serve"][kv]["logits"]):
                np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(r["amax"]["mesh"],
                                      ranks[0]["amax"]["mesh"])


@pytest.mark.parametrize("world,shape", MESHES, ids=MESH_IDS)
def test_imc_scales_are_the_whole_ffs(run, world, shape):
    got = _rank0(run, world, shape)["amax"]
    want = run["ref"]["amax"]
    np.testing.assert_allclose(got["mesh"], want, rtol=1e-5, atol=1e-5)
    # on model = 2 and 4 the shards are whole tiles and the chain runs on
    # them; with each rank's own maxima it would miss
    assert got["tiled"] == (shape[1] > 1)
    if got["tiled"]:
        assert np.abs(got["local_amax"] - want).max() > 1e-2


def test_checkpoint_moves_between_meshes_bit_for_bit(run):
    ck = run["ranks"][4][0]["checkpoint"]
    assert ck["step"] == ck["restored_step"] == R.STEPS
    assert ck["restored_placed"]
    for a, b in zip(ck["restored"], ck["saved"], strict=True):
        np.testing.assert_array_equal(a, b)
    # and on one device, from the files the (2, 2) mesh wrote
    params, mu, nu = run["inits"]["ff128"]
    target = train_state_from_numpy(params, mu, nu, 0, R.cfg_of("ff128"),
                                    "cpu")
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
        assert got["train_single"] == "ValueError"
        # the recurrent and hybrid families and a DCN route over the
        # sharded model run there since item 5.6c-3
        assert got["train_recurrent"] == got["serve_recurrent"] == "none"
        assert got["train_dcn"] == "none"
        # rank 0 alone prints
        printed = got["printed"]
        if rank == 0:
            assert "mesh: {'data': 1, 'model': 2} devices=2" in printed
            assert "step 2: loss=" in printed and "decode:" in printed
        else:
            assert printed == ""


@pytest.mark.parametrize("world", WORLDS)
def test_redistributions_take_the_gloo_route(run, world):
    for res in run["ranks"][world]:
        counts = res["collectives"]
        assert counts.get("all_reduce", 0) > 0
        assert counts.get("all_gather", 0) > 0


# ---------------------------------------------- one process, no group --

def test_no_mesh_keeps_every_helper_the_identity():
    cfg = R.cfg_of("ff128")
    for mesh in (None, {"data": 1, "model": 1}):
        assert L.kv_block(cfg, 4, mesh) == (4, 0, cfg.num_kv_heads)
        assert SH.local_range(("batch", None), (4, 3), 0, mesh) == (0, 4)
        assert SH.dim_axes(("batch", None), (4, 3), 0, mesh) == ()
        x = torch.ones(4, 3)
        assert SH.place(x, ("batch", None), mesh) is x
        assert SH.distribute_tree({"a": x}, {"a": ("batch", None)},
                                  mesh)["a"] is x
    SH.set_mesh({"data": 1, "model": 1})
    x = torch.ones(2, 2)
    assert SH.constrain(x, "batch", None) is x


def test_a_non_dense_family_over_ranks_raises_before_running():
    """Every family builds over more than one rank: the MoE,
    encoder-decoder and VLM families since the slice that sharded them,
    the recurrent and hybrid ones since item 5.6c-3 (they raised before
    running until then)."""
    from repro_torch.models.model_zoo import build_model

    for arch in ("xlstm_125m", "hymba_1_5b", "deepseek_moe_16b",
                 "llama4_scout_17b_a16e", "whisper_medium",
                 "internvl2_76b"):
        build_model(get_config(arch).reduced(), "cpu",
                    {"data": 1, "model": 2})
    # the dense family, and any family on one device, builds
    build_model(get_config("gemma_7b").reduced(), "cpu",
                {"data": 2, "model": 2})
    build_model(get_config("xlstm_125m").reduced(), "cpu",
                {"data": 1, "model": 1})


def test_dcn_route_over_a_sharded_model_raises():
    """The DCN routes over a sharded model raised until item 5.6c-3; they
    build now (the emulated route on a mesh without a ``pod`` axis, the
    process-group route on one with it), and the process-group route on
    a mapping, which carries no process group, raises when it steps."""
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train.train_step import init_train_state

    model = build_model(R.cfg_of("ff128"), "cpu", {"data": 1, "model": 2})
    assert make_train_step(model, TrainConfig(dcn_pods=2)).dcn_route == \
        "emulated"
    assert make_train_step(model, TrainConfig()).dcn_route == "global"
    mesh = {"pod": 2, "data": 1, "model": 2}
    model = build_model(R.cfg_of("ff128"), "cpu", mesh)
    step = make_train_step(model, TrainConfig(dcn_pods=2), mesh)
    assert step.dcn_route == "shard_map"
    batch = {"tokens": torch.zeros((4, 8), dtype=torch.int32)}
    with pytest.raises(ValueError, match="needs a DeviceMesh"):
        step(init_train_state(model, 0), batch)


def test_tree_shardings_maps_a_train_state_with_scalars():
    from repro_torch.models import transformer as T
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train.train_step import init_train_state, state_axes

    cfg = R.cfg_of("ff128")
    state = init_train_state(build_model(cfg, "cpu"), 0)
    mesh = {"data": 2, "model": 2}
    sh = SH.tree_shardings(state_axes(T.param_axes(state.params, cfg)),
                           state, mesh)
    assert sh.step is None and sh.opt["step"] is None
    assert len(sh.params) == len(sh.opt["mu"]) == len(
        list(state.params.parameters()))
    # embed (vocab, fsdp): vocab rows on model, columns on data
    from torch.distributed.tensor import Shard

    assert sh.params[0] == (Shard(1), Shard(0))


def test_kv_block_of_a_query_block_across_groups_raises():
    cfg = dataclasses.replace(R.cfg_of("ff128"), num_heads=6,
                              num_kv_heads=2)

    class Mesh:   # a stand-in with one rank's coordinates
        mesh_dim_names = ("data", "model")
        mesh = torch.zeros(1, 4)

        def get_local_rank(self, axis):
            return 1 if axis == "model" else 0

    # 6 heads over model 4 do not divide: replicated, the whole cache
    assert L.kv_block(cfg, 4, Mesh()) == (4, 0, 2)
    cfg = dataclasses.replace(cfg, num_heads=12, num_kv_heads=3)
    with pytest.raises(ValueError, match="straddles"):
        L.kv_block(cfg, 4, Mesh())


def test_a_size_1_mesh_axis_replicates():
    """A mesh dim of size 1 holds the whole dim: ``Replicate()`` where
    GSPMD's spec names the axis (the same layout), and the spec itself
    still names it, as the reference's does."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = {"data": 1, "model": 2}
    assert SH.logical_to_spec(("batch", "heads"), (8, 4), mesh) == (
        "data", "model")
    assert SH.logical_to_sharding(("batch", "heads"), (8, 4), mesh) == (
        Replicate(), Shard(1))
    assert SH.logical_to_sharding(("batch", "heads"), (8, 4), {
        "data": 2, "model": 2}) == (Shard(0), Shard(1))
