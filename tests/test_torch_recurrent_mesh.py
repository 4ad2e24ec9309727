"""The recurrent (xLSTM) and hybrid (Hymba) families over a device mesh
(serving and training on DTensors) against the JAX package on one
device, on gloo CPU ranks.

The ranks are processes started with ``spawn`` from
``tests/_torch_recurrent_mesh_ranks.py`` (which imports no JAX): 2 ranks
(the ``(1, 2)`` and ``(2, 1)`` meshes) and 4 ranks (``(2, 2)`` and ``(1,
4)``), both worlds at once, through ``file://`` stores under the test's
temporary directory; they join within ``JOIN_TIMEOUT_S`` or are killed
and the tests fail. The test process computes the reference on one
device (``repro.dist.sharding.set_mesh(None)``) while the ranks run. Both
sides start from the port's seeded draw (``Model.init``), carried to the
reference as its parameter tree in numpy (and to the ranks as that tree,
placed by ``convert``'s ``mesh=``).

Configs (float32): the reduced ``xlstm_125m`` with 4 layers (mLSTM
blocks, the fourth an sLSTM; its 4 heads split over ``model``), the
reduced ``hymba_1_5b`` (4 heads over 2 kv heads, split over ``model``; a
16-position window) and a Hymba whose 5 heads over 1 kv head divide
neither 2 nor 4 (its attention replicated over ``model``, as full
Hymba's 25 heads over 5 are). Training runs Hymba with ``imc_linear``:
its ``d_ff`` of 128 is 64 or 32 columns a rank on ``model`` = 2 or 4, not
whole 128-column tiles, so ``_imc_linear`` gathers ``ff`` and runs the
whole chain on each rank (as full Hymba's 5,504 does, 2,752 or 1,376
columns a rank). Prompts of 32 positions (two whole windows: the
reference's ring is aligned) are compared with the reference's own
prefill and decode; a 24-position prompt (the ring shifted, ROADMAP.md
Queue 3 F1) with its ``forward_train`` over the whole sequence.

Tolerances (float32; ``atol`` in units of the reference tensor's largest
magnitude where that exceeds 1, as ``tests/test_torch_recurrent.py``):
- ``forward_train`` logits, the prefill's and the forced decode's logits
  with the plain KV cache: rtol / atol 1e-4 (``tests/test_torch_recurrent.py``:
  the ranks sum partial products in other orders); with the int8 KV
  cache 2e-3 (a k or v element at a code's .5 boundary rounds to either
  code, ``tests/test_torch_lm_mesh.py``);
- each layer's recurrent state after the prefill (gathered from the
  ranks' blocks): rtol / atol 1e-4 (the states of
  ``tests/test_torch_recurrent.py`` after a decode);
- 3 train steps: losses and grad norms rtol 1e-4 (xLSTM's grad norms
  after the first step 2e-3: the port on one device is already 3.5e-4
  and 8.1e-4 off the reference's there); every parameter within
  ``2 * lr`` a step of the reference's and the mean difference under
  1e-2 ``lr`` (``tests/test_torch_family_mesh.py``: a gradient whose sign
  is rounding noise moves its weight by a whole ``lr``);
- every rank's whole results equal rank 0's, and a checkpoint of each
  family moves from ``(2, 2)`` to ``(1, 4)`` and to one device bit for
  bit.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_recurrent_mesh_ranks as R
from repro.configs import get_config as jax_get_config
from repro.data.tokens import TokenPipeline as JaxTokenPipeline
from repro.dist import sharding as JSH
from repro.models import transformer as JT
from repro.models.model_zoo import build_model as jax_build_model
from repro.train import optimizer as JO
from repro.train import train_step as JS
from repro_torch.convert import lm_params_from_numpy, train_state_from_numpy
from repro_torch.dist import sharding as SH
from repro_torch.dist.checkpoint import CheckpointManager
from repro_torch.launch import serve, train
from repro_torch.models import transformer as T
from repro_torch.models.model_zoo import build_model

torch.set_num_threads(1)

JOIN_TIMEOUT_S = 300
WORLDS = (2, 4)
MESHES = [(w, s) for w in WORLDS for s in R.MESHES[w]]
MESH_IDS = [f"{w}ranks-{s[0]}x{s[1]}" for w, s in MESHES]
LAUNCH_TRAIN = ["--arch", "hymba_1_5b", "--reduced", "--steps", "2",
                "--batch", "4", "--seq", "16", "--device", "cpu",
                "--imc-linear", "--log-every", "1"]
LAUNCH_SERVE = ["--arch", "xlstm_125m", "--reduced", "--device", "cpu",
                "--batch", "4", "--prompt-len", "16", "--gen", "4"]
TOL = 1e-4
INT8_TOL = 2e-3
# xLSTM's grad norms after the first step: the port on one device is
# 3.5e-4 and 8.1e-4 off the reference's at steps 2 and 3 (its exponential
# gates amplify float32 rounding, which AdamW's update carries on)
XLSTM_LATER_NORMS = 2e-3
# the parameters each config draws: imc_linear changes none
DRAWN = ("xlstm", "hymba", "hymba_odd")


@pytest.fixture(autouse=True)
def no_global_mesh():
    JSH.set_mesh(None)
    SH.set_mesh(None)
    yield
    SH.set_mesh(None)


def _jcfg(name: str, **kw):
    arch, over = R.CONFIGS[name]
    return dataclasses.replace(jax_get_config(arch).reduced(), **over, **kw)


def _drawn(name: str) -> str:
    return name.removesuffix("_imc")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol, err_msg=""):
    """allclose at ``tol``, ``atol`` in units of the reference tensor's
    largest magnitude where that exceeds 1."""
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=tol,
                               atol=tol * scale, err_msg=err_msg)


def _reference_tree(lm) -> dict:
    """The port's LM as the reference's parameter tree (numpy): a
    ``layers`` leaf stacked on a leading layer axis, the ``ssm`` family's
    ``blocks`` a list of dicts."""
    tree: dict = {}
    for name, p in lm.named_parameters():
        parts = name.split(".")
        a = p.detach().numpy().copy()
        if parts[0] == "blocks":
            blocks = tree.setdefault("blocks", [])
            blocks.extend({} for _ in range(int(parts[1]) + 1 - len(blocks)))
            node, path = blocks[int(parts[1])], parts[2:]
        elif parts[0] == "layers":
            node, path = tree.setdefault("layers", {}), parts[2:]
        else:
            node, path = tree, parts
        for k in path[:-1]:
            node = node.setdefault(k, {})
        if parts[0] == "layers":
            node.setdefault(path[-1], []).append(a)
        else:
            node[path[-1]] = a

    def stack(node):
        return ({k: stack(v) for k, v in node.items()}
                if isinstance(node, dict) else np.stack(node))

    if "layers" in tree:
        tree["layers"] = stack(tree["layers"])
    return tree


def _initial_state(name: str):
    """The port's seeded float32 draw (seed 0) as the reference's
    parameter tree, with zero moments: both sides start from it."""
    params = _reference_tree(build_model(R.cfg_of(name), "cpu").init(
        0, trainable=True))
    zeros = jax.tree.map(np.zeros_like, params)
    return params, zeros, jax.tree.map(np.zeros_like, params)


def _port_leaves(params, name: str) -> list:
    """The reference's parameter tree as the port's leaves, in
    ``parameters()`` order (the layers' stacked leaves split)."""
    lm = lm_params_from_numpy(params, R.cfg_of(name), "cpu", trainable=True)
    return [p.detach().numpy() for p in lm.parameters()]


def _ref_states(jcache, jc) -> list:
    """Each layer's recurrent state ({field: numpy}): the ``ssm`` family's
    list of states, the hybrid's stacked Mamba states."""
    out = []
    for i in range(jc.num_layers):
        st = jcache[1] if jc.family == "hybrid" else jcache[i]
        out.append({f.name: np.asarray(getattr(st, f.name)[i]
                                       if jc.family == "hybrid"
                                       else getattr(st, f.name))
                    for f in dataclasses.fields(st)})
    return out


def _reference_serve(params, name: str, kv: bool) -> dict:
    """Prefill of the PROMPT-position prompt, each layer's state after it,
    and GEN - 1 forced decode steps: every step's logits."""
    jc = _jcfg(name, kv_quant_int8=kv)
    model = jax_build_model(jc)
    tokens = jnp.asarray(R.prompt_tokens(jc.vocab_size, R.PROMPT))
    cache = model.init_cache(R.SERVE_B, R.PROMPT + R.GEN)
    logits, cache = jax.jit(model.prefill)(params, {"tokens": tokens},
                                           cache)
    states = _ref_states(cache, jc)
    steps = [np.asarray(logits)]
    forced = R.forced_tokens(jc.vocab_size, R.PROMPT)
    decode = jax.jit(model.decode_step)
    for i in range(R.GEN - 1):
        logits, cache = decode(params, jnp.asarray(forced[:, i:i + 1]),
                               cache, jnp.asarray(R.PROMPT + i, jnp.int32))
        steps.append(np.asarray(logits))
    return {"logits": steps, "states": states}


def _reference(inits: dict) -> dict:
    """Everything the ranks compute, by the reference on one device."""
    out = {"forward": {}, "train": {}, "serve": {}}
    params = {name: jax.tree.map(jnp.asarray, inits[name][0])
              for name in DRAWN}
    for name in R.FORWARD:
        jc = _jcfg(name)
        batch = JaxTokenPipeline(R.B, R.S, jc.vocab_size).get_for(jc, 1)
        out["forward"][name] = np.asarray(jax.jit(
            lambda p, t, jc=jc: JT.forward_train(p, t, jc))(
                params[name], batch["tokens"]))
    for name, kv in R.SERVED:
        out["serve"][name, kv] = _reference_serve(params[name], name, kv)
    jc = _jcfg("hymba")
    seq = np.concatenate([R.prompt_tokens(jc.vocab_size, R.RING_PROMPT),
                          R.forced_tokens(jc.vocab_size, R.RING_PROMPT)], 1)
    out["ring"] = np.asarray(JT.forward_train(params["hymba"],
                                              jnp.asarray(seq), jc))
    for name in R.TRAINED:
        jc = _jcfg(name)
        model = jax_build_model(jc)
        p, mu, nu = (jax.tree.map(jnp.asarray, t)
                     for t in inits[_drawn(name)])
        state = JS.TrainState(params=p, opt={
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
    drawn = {name: _initial_state(name) for name in DRAWN}
    inits = {name: drawn[_drawn(name)] for name in R.CONFIGS}
    inputs = {key: {name: inits[name][i] for name in R.CONFIGS}
              for i, key in enumerate(("params", "mu", "nu"))}
    started = {}
    for world in WORLDS:
        out = tmp_path_factory.mktemp(f"recurrent_mesh{world}")
        started[world] = (R.start(world, out, dict(
            inputs, launchers=(LAUNCH_TRAIN, LAUNCH_SERVE)
            if world == 2 else None)), out)
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        ref = _reference(drawn)
        one = _one_process_launchers()
    except BaseException:
        for procs, _ in started.values():
            for p in procs:
                p.kill()
        raise
    ranks = {world: R.LM.join(procs, out, deadline)
             for world, (procs, out) in started.items()}
    return {"ranks": ranks, "ref": ref, "one": one, "inits": inits,
            "dirs": {w: out for w, (_, out) in started.items()}}


def _rank0(run, world, shape):
    return run["ranks"][world][0][shape]


# ------------------------------------------------------------ the cases --

@pytest.mark.parametrize("world,shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("name", R.FORWARD)
def test_forward_train_matches_the_reference(run, world, shape, name):
    got = _rank0(run, world, shape)["forward"]
    assert got[f"{name}_placed"]
    _close(got[name], run["ref"]["forward"][name], TOL)


@pytest.mark.parametrize("world,shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("name,kv_quant", R.SERVED)
def test_forced_decode_matches_the_reference(run, world, shape, name,
                                             kv_quant):
    got = _rank0(run, world, shape)["serve"][name, kv_quant]
    want = run["ref"]["serve"][name, kv_quant]
    assert len(got["logits"]) == len(want["logits"]) == R.GEN
    for step, (g, w) in enumerate(zip(got["logits"], want["logits"])):
        _close(g, w, INT8_TOL if kv_quant and step else TOL,
               f"step {step}")


@pytest.mark.parametrize("world,shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("name", R.FORWARD)
def test_prefill_states_match_the_reference(run, world, shape, name):
    """Each layer's state after the prompt (xLSTM: the mLSTM (C, n) and
    the sLSTM (c, n); Hymba: each layer's Mamba h), gathered from the
    ranks' blocks; each rank's block is its batch rows and, for the
    mLSTM, its heads."""
    got = _rank0(run, world, shape)["serve"][name, False]
    want = run["ref"]["serve"][name, False]["states"]
    assert len(got["states"]) == len(want) == R.cfg_of(name).num_layers
    for layer, (g, w) in enumerate(zip(got["states"], want)):
        assert set(g) == set(w)
        for field in w:
            _close(g[field], w[field], TOL, f"layer {layer} {field}")
    cfg = R.cfg_of(name)
    data, model = shape
    rows = R.SERVE_B // data
    if cfg.family == "ssm":
        heads = cfg.num_heads // model
        dh = 2 * cfg.d_model // cfg.num_heads
        assert got["shapes"] == [(rows, heads, dh, dh), (rows, heads, dh)]
    else:
        heads = (cfg.num_heads // model if cfg.num_heads % model == 0
                 else cfg.num_heads)
        kv = max(heads // (cfg.num_heads // cfg.num_kv_heads), 1)
        assert got["shapes"] == [
            (rows, cfg.sliding_window, kv, cfg.resolved_head_dim),
            (rows, cfg.d_model, cfg.ssm_state)]


@pytest.mark.parametrize("world,shape", MESHES, ids=MESH_IDS)
def test_hymba_ring_past_the_window_matches_forward_train(run, world,
                                                          shape):
    """F1 on a mesh: a 24-position prompt over a 16-position window (the
    ring shifted), then forced decode steps, each against the
    reference's ``forward_train`` over the whole sequence."""
    got = _rank0(run, world, shape)["ring"]["logits"]
    want = run["ref"]["ring"]
    _close(got[0], want[:, :R.RING_PROMPT], TOL)
    for i, g in enumerate(got[1:]):
        pos = R.RING_PROMPT + i
        _close(g, want[:, pos:pos + 1], TOL, f"position {pos}")


@pytest.mark.parametrize("world,shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("name", R.TRAINED)
def test_three_train_steps_match_the_reference(run, world, shape, name):
    losses, norms, params, placed, tiled = _rank0(run, world,
                                                  shape)["train"][name]
    want_l, want_n, want_p = run["ref"]["train"][name]
    assert placed
    # the reduced Hymba's d_ff of 128 is never whole tiles a rank here:
    # the gathered-ff route, as full Hymba's 5,504 takes on model 2 or 4
    assert not tiled
    np.testing.assert_allclose(losses, want_l, rtol=1e-4)
    np.testing.assert_allclose(norms[0], want_n[0], rtol=1e-4)
    np.testing.assert_allclose(norms[1:], want_n[1:],
                               rtol=XLSTM_LATER_NORMS if name == "xlstm"
                               else 1e-4)
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
            mine = ranks[0]["serve"][key]
            for x, y in zip(s["logits"], mine["logits"]):
                np.testing.assert_array_equal(x, y)
            for x, y in zip(s["states"], mine["states"]):
                for field in x:
                    np.testing.assert_array_equal(x[field], y[field])
        for x, y in zip(r["ring"]["logits"], ranks[0]["ring"]["logits"]):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", R.CHECKPOINTED)
def test_checkpoint_moves_between_meshes_bit_for_bit(run, name):
    """The xLSTM's ``blocks`` list and Hymba's ``alpha`` and Mamba leaves
    (with their moments) saved on ``(2, 2)`` restore on ``(1, 4)`` and on
    one device."""
    ck = run["ranks"][4][0]["checkpoint"][name]
    assert ck["step"] == ck["restored_step"] == R.STEPS
    assert ck["restored_placed"]
    for a, b in zip(ck["restored"], ck["saved"], strict=True):
        np.testing.assert_array_equal(a, b)
    params, mu, nu = run["inits"][name]
    target = train_state_from_numpy(params, mu, nu, 0, R.cfg_of(name),
                                    "cpu")
    step, back = CheckpointManager(
        run["dirs"][4] / f"ckpt_{name}").restore_latest(target)
    assert step == R.STEPS
    names = [n for n, _ in back.params.named_parameters()]
    want = ("blocks.",) if name == "xlstm" else (".alpha", ".mamba.")
    assert all(any(w in n for n in names) for w in want)
    leaves = list(back.params.parameters()) + back.opt["mu"] + back.opt["nu"]
    for a, b in zip(leaves, ck["saved"], strict=True):
        np.testing.assert_array_equal(a.detach().numpy(), b)
    for r in run["ranks"][4][1:]:
        for a, b in zip(r["checkpoint"][name]["restored"], ck["restored"]):
            np.testing.assert_array_equal(a, b)


def test_launchers_on_two_ranks(run):
    """``launch.train --arch hymba_1_5b --imc-linear`` and ``launch.serve
    --arch xlstm_125m`` on the (1, 2) debug mesh: the tokens of one
    process, and its parameters within float32 rounding of two steps."""
    for rank, res in enumerate(run["ranks"][2]):
        got = res["launchers"]
        np.testing.assert_array_equal(got["tokens"], run["one"]["tokens"])
        for a, b in zip(got["params"], run["one"]["params"], strict=True):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=2 * 3e-4 * 2)
        printed = got["printed"]
        if rank == 0:
            assert "mesh: {'data': 1, 'model': 2} devices=2" in printed
            assert "step 2: loss=" in printed and "decode:" in printed
        else:
            assert printed == ""


# ---------------------------------------------- one process, no group --

@pytest.mark.parametrize("name", list(R.CONFIGS))
def test_a_recurrent_family_builds_over_ranks(name):
    model = build_model(R.cfg_of(name), "cpu", {"data": 2, "model": 2})
    assert model.mesh == {"data": 2, "model": 2}


@pytest.mark.parametrize("name", R.FORWARD)
def test_states_without_a_mesh_are_whole(name):
    cfg = R.cfg_of(name)
    cache = T.init_cache(cfg, 3, 20, "cpu", {"data": 2, "model": 2})
    for entry in cache:
        st = entry[1] if isinstance(entry, tuple) else entry
        for f in dataclasses.fields(st):
            assert getattr(st, f.name).shape[0] == 3
