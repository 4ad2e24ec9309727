"""The KV cache's sequence striped over ``model`` (``kv_seq``) against the
JAX package on one device, on gloo CPU ranks.

The ranks are processes started with ``spawn`` from
``tests/_torch_kv_seq_mesh_ranks.py`` (which imports no JAX): 2 ranks (the
``(1, 2)`` mesh) and 4 ranks (``(1, 4)`` and ``(2, 2)``), both worlds at
once, through ``file://`` stores under the test's temporary directory;
they join within ``JOIN_TIMEOUT_S`` or are killed and the tests fail.
Each serves with ``set_mesh(mesh, rules.replace(kv_seq="model"))``, the
reference's own way in. The test process computes the reference on one
device (``repro.dist.sharding.set_mesh(None)``) and one process of the
port while the ranks run. Both sides start from the reference's
parameters, carried to the ranks as numpy and placed by ``convert``'s
``mesh=``.

Configs (float32), each with the int8 and the float cache: the reduced
granite_20b (1 kv head: MQA), the reduced qwen2_7b (4 heads over 2 kv
heads: GQA) and the reduced hymba_1_5b (a 16-slot window: a prompt of two
whole windows, so the reference's ring is aligned, and 8 decode steps
past the wrap). A Hymba prompt of 20 positions shifts the ring (ROADMAP.md
Queue 3 F1), and the reduced deepseek_moe_16b, whisper_medium and
internvl2_76b (the port's own draw) serve with the int8 cache: these are
held against one process of the port.

Tolerances:
- logits: rtol / atol 1e-5 with the float cache, and at the prefill; the
  decode steps with the int8 cache 2e-3 (``tests/test_torch_lm_mesh.py``:
  a k or v element at a code's .5 boundary rounds to either code as the
  sums' order moves it by an ulp);
- each rank's cache block against the matching slice of the reference's
  cache (its rows, its slots, every kv head): the float cache and the
  int8 scales rtol / atol 1e-5; the int8 codes equal but for codes one
  apart, at most ``CODE_SHARE`` of them (the same .5 boundaries);
- every rank's whole logits equal rank 0's; with ``kv_seq`` unset, and
  with ``kv_seq`` on a length no model axis divides (it falls back), the
  caches and logits are the same bit for bit.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_kv_seq_mesh_ranks as R
from _torch_lm_mesh_ranks import join
from repro.configs import get_config as jax_get_config
from repro.dist import sharding as JSH
from repro.models.model_zoo import build_model as jax_build_model
from repro.train import train_step as JS
from repro_torch.dist import sharding as SH

torch.set_num_threads(1)

JOIN_TIMEOUT_S = 300
WORLDS = (2, 4)
MESHES = [(w, s) for w in WORLDS for s in R.MESHES[w]]
MESH_IDS = [f"{w}ranks-{s[0]}x{s[1]}" for w, s in MESHES]
TOL = dict(rtol=1e-5, atol=1e-5)
INT8_TOL = dict(rtol=2e-3, atol=2e-3)
CODE_SHARE = 0.01
CASES = [(name, kv) for name in R.CONFIGS for kv in (False, True)]


@pytest.fixture(autouse=True)
def no_global_mesh():
    JSH.set_mesh(None)
    SH.set_mesh(None)
    yield
    SH.set_mesh(None)


def _jcfg(name: str, **kw):
    return dataclasses.replace(jax_get_config(R.CONFIGS[name]).reduced(),
                               **kw)


def _reference_params(name: str) -> dict:
    state, _ = JS.init_train_state(jax_build_model(_jcfg(name)),
                                   jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, state.params)


def _reference_serve(params, name: str, kv: bool) -> dict:
    """Prefill and GEN - 1 forced decode steps: every step's logits and
    the (stacked) attention cache after the last."""
    jc = _jcfg(name, kv_quant_int8=kv)
    model = jax_build_model(jc)
    prompt = R.PROMPTS[name]
    tokens = jnp.asarray(R.prompt_tokens(jc.vocab_size, prompt))
    cache = model.init_cache(R.SERVE_B, prompt + R.GEN)
    logits, cache = jax.jit(model.prefill)(params, {"tokens": tokens},
                                           cache)
    steps = [np.asarray(logits)]
    forced = R.forced_tokens(jc.vocab_size, prompt)
    decode = jax.jit(model.decode_step)
    for i in range(R.GEN - 1):
        logits, cache = decode(params, jnp.asarray(forced[:, i:i + 1]),
                               cache, jnp.asarray(prompt + i, jnp.int32))
        steps.append(np.asarray(logits))
    kvc = R.attention_cache(cache)
    return {"logits": steps, "cache": [
        {f.name: np.asarray(getattr(kvc, f.name))[layer]
         for f in dataclasses.fields(kvc)}
        for layer in range(jc.num_layers)]}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both worlds' ranks (started first), then the reference and one
    process of the port (computed while the ranks run)."""
    JSH.set_mesh(None)
    params = {name: _reference_params(name) for name in R.CONFIGS}
    started = {}
    for world in WORLDS:
        out = tmp_path_factory.mktemp(f"kv_seq{world}")
        started[world] = (R.start(world, out, params), out)
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        jparams = {n: jax.tree.map(jnp.asarray, p) for n, p in params.items()}
        ref = {case: _reference_serve(jparams[case[0]], *case)
               for case in CASES}
        ring = R.serve(params, "hymba", True, R.RING_PROMPT)
        families = {name: R.family_serve(name) for name in R.FAMILIES}
    except BaseException:
        for procs, _ in started.values():
            for p in procs:
                p.kill()
        raise
    ranks = {world: join(procs, out, deadline)
             for world, (procs, out) in started.items()}
    return {"ranks": ranks, "ref": ref, "ring": ring, "families": families}


def _slice(whole: dict, rows: tuple, blk) -> dict:
    """The rows and slots of a rank's block of a whole cache."""
    r0, rn = rows
    s0, sl = (blk[0], blk[1]) if blk else (0, whole["k"].shape[1])
    return {f: a[r0:r0 + rn, s0:s0 + sl] for f, a in whole.items()}


def _blocks_match(got: dict, want: dict, what: str) -> None:
    for f, w in want.items():
        g = got[f]
        assert g.shape == w.shape, (what, f, g.shape, w.shape)
        if g.dtype == np.int8:
            diff = np.abs(g.astype(np.int32) - w.astype(np.int32))
            assert diff.max() <= 1, (what, f)
            assert (diff > 0).mean() <= CODE_SHARE, (what, f)
        else:
            np.testing.assert_allclose(g, w, **TOL, err_msg=f"{what} {f}")


# ------------------------------------------------------------ the cases --

@pytest.mark.parametrize("world,shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("name,kv", CASES)
def test_forced_decode_matches_the_reference(run, world, shape, name, kv):
    got = run["ranks"][world][0][shape][name, kv]["logits"]
    want = run["ref"][name, kv]["logits"]
    assert len(got) == len(want) == R.GEN
    for step, (g, w) in enumerate(zip(got, want)):
        tol = INT8_TOL if kv and step else TOL
        np.testing.assert_allclose(g, w, **tol, err_msg=f"step {step}")


@pytest.mark.parametrize("world,shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("name,kv", CASES)
def test_each_rank_holds_its_slice_of_the_reference_cache(run, world,
                                                          shape, name, kv):
    """Each rank's block: its rows, 1 / model of the slots (``model`` =
    the rank's coordinate on it) and every kv head, equal to that slice
    of the reference's cache after the last decode step."""
    data, model = shape
    cfg = R.cfg_of(name)
    size = R.PROMPTS[name] + R.GEN
    size = min(size, cfg.sliding_window) if cfg.sliding_window else size
    sl = size // model
    for rank, res in enumerate(run["ranks"][world]):
        got = res[shape][name, kv]
        assert got["rows"] == ((rank // model) * (R.SERVE_B // data),
                               R.SERVE_B // data)
        for layer, (blk, whole) in enumerate(zip(
                got["blocks"], run["ref"][name, kv]["cache"], strict=True)):
            assert blk["seq_block"] == ((rank % model) * sl, sl, size,
                                        ("model",))
            assert blk["k"].shape[2] == cfg.num_kv_heads
            _blocks_match(blk, _slice(whole, got["rows"], blk["seq_block"]),
                          f"rank {rank} layer {layer}")


@pytest.mark.parametrize("world,shape", MESHES, ids=MESH_IDS)
def test_the_shifted_ring_matches_one_process(run, world, shape):
    """A 20-position prompt over Hymba's 16-slot ring (shift 4), then 8
    steps: each rank's slots are the ones one process fills."""
    one = run["ring"]
    for rank, res in enumerate(run["ranks"][world]):
        got = res[shape]["ring"]
        for step, (g, w) in enumerate(zip(got["logits"], one["logits"],
                                          strict=True)):
            np.testing.assert_allclose(g, w, **(INT8_TOL if step else TOL),
                                       err_msg=f"step {step}")
        for blk, whole in zip(got["blocks"], one["blocks"], strict=True):
            assert blk["seq_block"] is not None
            whole = {f: whole[f] for f in ("k", "v", "k_scale", "v_scale")}
            _blocks_match(blk, _slice(whole, got["rows"], blk["seq_block"]),
                          f"rank {rank}")


FAMILY_MESHES = [(w, s) for w, s in MESHES if s in R.FAMILY_MESHES]


@pytest.mark.parametrize("world,shape", FAMILY_MESHES,
                         ids=[f"{w}ranks-{s[0]}x{s[1]}"
                              for w, s in FAMILY_MESHES])
@pytest.mark.parametrize("name", list(R.FAMILIES))
def test_the_other_families_stripe_and_match_one_process(run, world, shape,
                                                         name):
    """deepseek_moe_16b, whisper_medium (its decoder's self-attention; the
    cross K/V keeps its placement) and internvl2_76b with the int8 cache:
    every layer's cache striped, the logits one process's."""
    got = run["ranks"][world][0][shape][name]
    one = run["families"][name]
    model = shape[1]
    assert all(b is not None and b[1] == 16 // model
               for b in got["seq_blocks"])
    assert all(b is None for b in one["seq_blocks"])
    for step, (g, w) in enumerate(zip(got["logits"], one["logits"],
                                      strict=True)):
        np.testing.assert_allclose(g, w, **(INT8_TOL if step else TOL),
                                   err_msg=f"step {step}")


@pytest.mark.parametrize("world,shape", MESHES, ids=MESH_IDS)
def test_every_rank_gathers_rank0s_logits(run, world, shape):
    ranks = [r[shape] for r in run["ranks"][world]]
    for r in ranks[1:]:
        for case in CASES + ["ring"] + [f for f in R.FAMILIES if f in r]:
            for a, b in zip(r[case]["logits"], ranks[0][case]["logits"],
                            strict=True):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("world,shape", MESHES, ids=MESH_IDS)
def test_kv_seq_on_an_indivisible_length_changes_nothing(run, world,
                                                         shape):
    """19 slots: no model axis divides them, so ``kv_seq`` falls back and
    the caches and logits are those with ``kv_seq`` unset, bit for bit;
    those hold every slot and the kv heads of the rank's query heads."""
    data, model = shape
    cfg = R.cfg_of(R.FALLBACK[0])
    kv = max(cfg.num_heads // model // (cfg.num_heads // cfg.num_kv_heads),
             1)
    for res in run["ranks"][world]:
        got, unset = (res[shape]["fallback", r] for r in ("kv_seq",
                                                          "default"))
        for a, b in zip(got["logits"], unset["logits"], strict=True):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(got["blocks"], unset["blocks"], strict=True):
            assert a["seq_block"] is None and b["seq_block"] is None
            assert a["k"].shape == (R.SERVE_B // data, 19, kv,
                                    cfg.resolved_head_dim)
            for f in ("k", "v", "k_scale", "v_scale"):
                np.testing.assert_array_equal(a[f], b[f])


@pytest.mark.parametrize("world,shape", MESHES, ids=MESH_IDS)
def test_the_combine_takes_the_gloo_route(run, world, shape):
    """The decode steps issue counted gloo collectives (the combine's two
    all-reduces a layer a step among them)."""
    for res in run["ranks"][world]:
        got = res[shape]["granite", True]
        layers = len(got["blocks"])
        assert got["collectives"] >= 2 * layers * (R.GEN - 1)
