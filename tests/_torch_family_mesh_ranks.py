"""Rank workers for the MoE, encoder-decoder and VLM families over a device
mesh (``tests/test_torch_family_mesh.py``).

It imports only ``torch``, numpy and ``repro_torch``: the tests start each
rank with the ``spawn`` method, and a child imports this module afresh,
so it must not pull in JAX. Each rank joins a gloo group through a
``file://`` store, runs one intra-op thread, builds each ``(data, model)``
mesh of its world size over the group, runs every case on it, and writes
what it computed (whole values and this rank's MoE routings, numpy) to
``<out>/rank<r>.pkl``; a failure writes its traceback to
``<out>/rank<r>.err`` first. The inputs (the reference's parameters and
train states, as numpy) come from the test process.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import pickle
import time
import traceback
from pathlib import Path

import numpy as np
import torch
from torch import nn

from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy, train_state_from_numpy
from repro_torch.data.tokens import TokenPipeline
from repro_torch.dist import sharding as SH
from repro_torch.dist.checkpoint import CheckpointManager
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.model_zoo import _vlm_inputs, build_model
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import (
    TrainConfig,
    make_train_step,
    state_axes,
)

import _torch_lm_mesh_ranks as LM
from _torch_lm_mesh_ranks import _np, _raises, join, placements_ok

MESHES = {2: ((1, 2), (2, 1)), 4: ((2, 2), (1, 4))}
NAMES = ("data", "model")
# the configs by name: each architecture's reduced config (float32), and
# Whisper with its FFN's down-projection on the analog chain
CONFIGS = {"deepseek": ("deepseek_moe_16b", {}),
           "llama4": ("llama4_scout_17b_a16e", {}),
           "whisper": ("whisper_medium", {}),
           "whisper_imc": ("whisper_medium", {"imc_linear": True}),
           "internvl2": ("internvl2_76b", {})}
FORWARD = ("deepseek", "llama4", "whisper", "internvl2")
TRAINED = ("deepseek", "llama4", "whisper_imc", "internvl2")
SERVED = FORWARD
MOE = ("deepseek", "llama4")
B, S = 4, 16                # forward and train batches: 64 tokens, 2 groups
STEPS = 3
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
SERVE_B, PROMPT, GEN = 4, 16, 4
# the MoE layer alone: (B, S) of its tokens, and the cases' names
LAYER_B, LAYER_S = 4, 16
LAYER_CASES = ("random", "one_expert")


def cfg_of(name: str, **kw):
    arch, over = CONFIGS[name]
    return dataclasses.replace(get_config(arch).reduced(), **over, **kw)


def decode_start(cfg) -> int:
    """The first decode position: after the decoder's tokens (half the
    prompt for the encoder-decoder), or after the patches and tokens."""
    return PROMPT // 2 if cfg.is_encoder_decoder else PROMPT


def forced_tokens(vocab: int) -> np.ndarray:
    """The (SERVE_B, GEN - 1) tokens forced into the decode steps."""
    rng = np.random.default_rng(5)
    return rng.integers(0, vocab, size=(SERVE_B, GEN - 1)).astype(np.int32)


def layer_input(case: str, d: int) -> np.ndarray:
    """(LAYER_B, LAYER_S, d) tokens for the MoE layer alone: random, or
    every token one vector (all pick the same experts, so each group
    overflows its capacity)."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(LAYER_B, LAYER_S, d)).astype(np.float32)
    if case == "one_expert":
        x[:] = x[0, 0]
    return x


@contextlib.contextmanager
def recorded_routes(sink: list):
    """Each ``moe_route`` call's (expert, pos, keep) on this rank (its
    groups only), appended to ``sink`` in call order."""
    real = L.moe_route

    def recording(*args):
        r = real(*args)
        sink.append(tuple(t.detach().numpy().copy()
                          for t in (r.expert, r.pos, r.keep)))
        return r

    L.moe_route = recording
    try:
        yield sink
    finally:
        L.moe_route = real


def family_forward(params, batch: dict, cfg):
    """``forward_train``'s logits of the family's inputs: the VLM's patches
    before its embedded tokens, the encoder-decoder's tokens over the
    encoded frames."""
    if cfg.family == "vlm":
        return T.forward_train(params, _vlm_inputs(params, batch, cfg), cfg,
                               is_embedded=True)
    memory = None
    if cfg.is_encoder_decoder:
        memory = T.encode(params, batch["frames"], cfg)
    return T.forward_train(params, batch["tokens"], cfg, memory=memory)


def forward(mesh, inputs) -> dict:
    out = {}
    for name in FORWARD:
        cfg = cfg_of(name)
        params = lm_params_from_numpy(inputs["params"][name], cfg, "cpu",
                                      mesh=mesh)
        batch = TokenPipeline(B, S, cfg.vocab_size).get_for(cfg, 1, "cpu",
                                                            mesh)
        with torch.no_grad(), recorded_routes([]) as routes:
            out[name] = _np(family_forward(params, batch, cfg))
        out[f"{name}_routes"] = routes
        out[f"{name}_placed"] = placements_ok(params, cfg, mesh)
    return out


def train(mesh, inputs, name: str):
    """STEPS global-route steps from the reference's initial state:
    (losses, grad norms, whole parameters after, the state)."""
    cfg = cfg_of(name)
    params, mu, nu = (inputs[k][name] for k in ("params", "mu", "nu"))
    state = train_state_from_numpy(params, mu, nu, 0, cfg, "cpu", mesh=mesh)
    step = make_train_step(build_model(cfg, "cpu", mesh),
                           TrainConfig(optimizer=AdamWConfig(**OPT)))
    pipe = TokenPipeline(B, S, cfg.vocab_size)
    losses, norms = [], []
    for i in range(STEPS):
        state, m = step(state, pipe.get_for(cfg, i, "cpu", mesh))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    placed = all(SH.on_mesh(t) for t in state.opt["mu"] + state.opt["nu"])
    return (losses, norms, [_np(p) for p in state.params.parameters()],
            placed), state


def serve(mesh, inputs, name: str, kv_quant: bool) -> dict:
    """Prefill and GEN - 1 forced decode steps: every step's logits, the
    MoE routings of the decode steps and each layer's cache shapes."""
    cfg = cfg_of(name, kv_quant_int8=kv_quant)
    model = build_model(cfg, "cpu", mesh)
    params = lm_params_from_numpy(inputs["params"][name], cfg, "cpu",
                                  mesh=mesh)
    batch = TokenPipeline(SERVE_B, PROMPT, cfg.vocab_size).get_for(
        cfg, 0, "cpu")
    start = decode_start(cfg)
    cache = model.init_cache(SERVE_B, start + GEN)
    logits, cache = model.prefill(params, batch, cache)
    steps = [_np(logits)]
    forced = torch.from_numpy(forced_tokens(cfg.vocab_size))
    with recorded_routes([]) as routes:
        for i in range(GEN - 1):
            logits, cache = model.decode_step(params, forced[:, i:i + 1],
                                              cache, start + i)
            steps.append(_np(logits))
    entry = cache[0]
    shapes = {"kv": tuple(entry[0].k.shape if isinstance(entry, tuple)
                          else entry.k.shape)}
    if isinstance(entry, tuple):
        shapes["cross"] = tuple(entry[1].k.shape)
    return {"logits": steps, "routes": routes, "shapes": shapes}


def moe_layer(mesh, inputs) -> dict:
    """``apply_moe`` alone on the reference's MoE parameters (deepseek's
    reduced config): its output and routing for each ``LAYER_CASES``
    input, placed as the residual is."""
    cfg = cfg_of("deepseek")
    out = {}
    for case in LAYER_CASES:
        p = nn.ParameterDict({k: L._param(torch.from_numpy(v.copy()))
                              for k, v in inputs["moe_layer"].items()})
        p = SH.distribute_tree(p, [T._MOE_AXES[k] for k in p], mesh)
        x = SH.place(torch.from_numpy(layer_input(case, cfg.d_model)),
                     L.SEQ_AXES, mesh)
        with torch.no_grad(), recorded_routes([]) as routes:
            y = L.apply_moe(p, x, cfg)
        out[case] = {"y": _np(y), "routes": routes}
    return out


def checkpoint(mesh, other, state, inputs, out: Path) -> dict:
    """The trained MoE state saved on ``mesh``, restored into a state
    placed on ``other`` (built from the reference's initial one); both
    whole values, and whether every restored leaf is placed on
    ``other``."""
    cfg = cfg_of("deepseek")
    mgr = CheckpointManager(out / "ckpt", keep=1)
    mgr.save(state.step, state)
    saved = [_np(t) for t in list(state.params.parameters())
             + state.opt["mu"] + state.opt["nu"]]
    SH.set_mesh(other)
    target = train_state_from_numpy(
        inputs["params"]["deepseek"], inputs["mu"]["deepseek"],
        inputs["nu"]["deepseek"], 0, cfg, "cpu", mesh=other)
    axes = state_axes(T.param_axes(target.params, cfg))
    step, back = mgr.restore_latest(target, SH.tree_shardings(
        axes, target, other))
    leaves = list(back.params.parameters()) + back.opt["mu"] + back.opt["nu"]
    expert = [t for t, a in zip(back.params.parameters(), T.param_axes(
        back.params, cfg)) if a[0] == "experts"]
    return {"saved": saved, "step": step, "restored_step": back.step,
            "restored": [_np(t) for t in leaves],
            "restored_placed": all(
                SH.on_mesh(t) and t.device_mesh == other for t in leaves),
            "expert_local": [tuple(t.to_local().shape) for t in expert]}


def launchers(argv_train: list, argv_serve: list) -> dict:
    """Both LM launchers on this rank's process group, and the recurrent
    and hybrid families and a DCN route on it."""
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.launch import train as train_launcher

    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        st = train_launcher.main(argv_train)
        run = serve_launcher.main(argv_serve)

    def other(arch):
        return ["--arch", arch, "--reduced", "--device", "cpu"]

    return {
        "printed": text.getvalue(),
        "params": [_np(p) for p in st.params.parameters()],
        "tokens": run.tokens.numpy().copy(),
        "serve_xlstm": _raises(lambda: serve_launcher.main(
            other("xlstm_125m") + ["--gen", "2"])),
        "train_hymba": _raises(lambda: train_launcher.main(
            other("hymba_1_5b") + ["--steps", "1"])),
        "train_dcn": _raises(lambda: train_launcher.main(
            argv_train + ["--dcn-pods", "2"])),
    }


def worker(rank: int, world: int, store: str, out: str, inputs: dict
           ) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    out_dir = Path(out)
    t0 = time.perf_counter()
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=world)
        try:
            res, states = {"seconds": {}}, {}
            meshes = {shape: init_device_mesh("cpu", shape,
                                              mesh_dim_names=NAMES)
                      for shape in MESHES[world]}
            res["seconds"]["group and meshes"] = time.perf_counter() - t0
            for shape, mesh in meshes.items():
                SH.set_mesh(mesh)
                r = {"seconds": {}, "train": {}, "serve": {}}
                clock = time.perf_counter()

                def lap(what):
                    nonlocal clock
                    now = time.perf_counter()
                    r["seconds"][what] = now - clock
                    clock = now

                r["forward"] = forward(mesh, inputs)
                lap("forward")
                for name in SERVED:
                    for kv in (False, True):
                        r["serve"][name, kv] = serve(mesh, inputs, name, kv)
                lap("serve")
                r["moe_layer"] = moe_layer(mesh, inputs)
                lap("moe layer")
                for name in TRAINED:
                    r["train"][name], states[shape, name] = train(
                        mesh, inputs, name)
                    lap(f"train {name}")
                res[shape] = r
            if world == 4:
                SH.set_mesh(meshes[(2, 2)])
                res["checkpoint"] = checkpoint(
                    meshes[(2, 2)], meshes[(1, 4)],
                    states[(2, 2), "deepseek"], inputs, out_dir)
            t1 = time.perf_counter()
            if inputs.get("launchers"):
                SH.set_mesh(None)
                res["launchers"] = launchers(*inputs["launchers"])
            res["seconds"]["checkpoint and launchers"] = \
                time.perf_counter() - t1
            res["collectives"] = dict(SH.GLOO_COLLECTIVES)
        finally:
            SH.set_mesh(None)
            dist.destroy_process_group()
        (out_dir / f"rank{rank}.pkl").write_bytes(pickle.dumps(res))
    except BaseException:
        (out_dir / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def start(world: int, out: Path, inputs: dict) -> list:
    """``world`` ranks of ``worker``, spawned and left running."""
    return LM.start(world, out, inputs, worker)
