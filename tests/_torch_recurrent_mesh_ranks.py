"""Rank workers for the recurrent (xLSTM) and hybrid (Hymba) families over
a device mesh (``tests/test_torch_recurrent_mesh.py``).

It imports only ``torch``, numpy and ``repro_torch``: the tests start each
rank with the ``spawn`` method, and a child imports this module afresh,
so it must not pull in JAX. Each rank joins a gloo group through a
``file://`` store, runs one intra-op thread, builds each ``(data, model)``
mesh of its world size over the group, runs every case on it, and writes
what it computed (whole values, numpy; a recurrent state gathered from
the ranks' blocks) to ``<out>/rank<r>.pkl``; a failure writes its
traceback to ``<out>/rank<r>.err`` first. The inputs (the reference's
parameters and train states, as numpy) come from the test process.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import time
import traceback
from pathlib import Path

import numpy as np
import pickle
import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy, train_state_from_numpy
from repro_torch.data.tokens import TokenPipeline
from repro_torch.dist import sharding as SH
from repro_torch.dist.checkpoint import CheckpointManager
from repro_torch.models import layers as L
from repro_torch.models import recurrent as R
from repro_torch.models import transformer as T
from repro_torch.models.model_zoo import build_model
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import (
    TrainConfig,
    make_train_step,
    state_axes,
)

import _torch_lm_mesh_ranks as LM
from _torch_lm_mesh_ranks import _np, placements_ok

MESHES = {2: ((1, 2), (2, 1)), 4: ((2, 2), (1, 4))}
NAMES = ("data", "model")
# the configs by name: the reduced xLSTM with 4 layers (``reduced()``
# gives 2, and with ssm_ratio 4 no sLSTM block), the reduced Hymba (4
# heads over 2 kv heads: split over model = 2 and 4) and a Hymba whose 5
# heads over 1 kv head divide neither (replicated, as full Hymba's 25 over
# 5), each also with its FFN's down-projection on the analog chain
CONFIGS = {"xlstm": ("xlstm_125m", {"num_layers": 4}),
           "hymba": ("hymba_1_5b", {}),
           "hymba_odd": ("hymba_1_5b", {"num_heads": 5, "num_kv_heads": 1}),
           "hymba_imc": ("hymba_1_5b", {"imc_linear": True}),
           "hymba_odd_imc": ("hymba_1_5b", {"num_heads": 5,
                                            "num_kv_heads": 1,
                                            "imc_linear": True})}
FORWARD = ("xlstm", "hymba", "hymba_odd")
# (config, int8 KV cache): xLSTM has no attention, so one cache
SERVED = (("xlstm", False), ("hymba", False), ("hymba", True),
          ("hymba_odd", False), ("hymba_odd", True))
TRAINED = ("xlstm", "hymba_imc", "hymba_odd_imc")
CHECKPOINTED = ("xlstm", "hymba_imc")
B, S = 4, 16                # forward and train batches
STEPS = 3
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
# a prompt of two whole windows of the reduced Hymba (16), and one that is
# not a multiple of it (the ring shifted: F1, against forward_train)
SERVE_B, PROMPT, RING_PROMPT, GEN = 4, 32, 24, 4


def cfg_of(name: str, **kw):
    arch, over = CONFIGS[name]
    return dataclasses.replace(get_config(arch).reduced(), **over, **kw)


def forced_tokens(vocab: int, prompt: int) -> np.ndarray:
    """The (SERVE_B, GEN - 1) tokens forced into the decode steps."""
    rng = np.random.default_rng(prompt)
    return rng.integers(0, vocab, size=(SERVE_B, GEN - 1)).astype(np.int32)


def prompt_tokens(vocab: int, prompt: int) -> np.ndarray:
    return TokenPipeline(SERVE_B, prompt, vocab).get(3, "cpu")[
        "tokens"].numpy()


def whole_state(state, cfg, mesh) -> dict:
    """A recurrent state's whole tensors ({field: numpy}), gathered from
    the ranks' blocks (each field placed by ``STATE_AXES``)."""
    out = {}
    for f in dataclasses.fields(state):
        axes, shape = STATE_AXES[type(state)][f.name], _global(state, f.name,
                                                                cfg)
        pl = SH.logical_to_sharding(axes, shape, mesh)
        out[f.name] = _np(DTensor.from_local(
            getattr(state, f.name), mesh, pl, run_check=False,
            shape=torch.Size(shape),
            stride=torch.empty(shape, device="meta").stride()))
    return out


def _global(state, field: str, cfg) -> tuple:
    """The global shape of a state field over SERVE_B rows."""
    if isinstance(state, R.MambaState):
        return (SERVE_B, cfg.d_model, cfg.ssm_state)
    if isinstance(state, R.MLSTMState):
        _, h, dh = R._mlstm_dims(cfg)
        return (SERVE_B, h, dh, dh) if field == "C" else (SERVE_B, h, dh)
    return (SERVE_B, cfg.d_model)


STATE_AXES = {R.MambaState: {"h": R.MAMBA_STATE_AXES},
              R.MLSTMState: {"C": R.MLSTM_C_AXES, "n": R.MLSTM_N_AXES},
              R.SLSTMState: {"c": R.SLSTM_STATE_AXES,
                             "n": R.SLSTM_STATE_AXES}}


def layer_states(cache, cfg, mesh) -> list:
    """Each layer's recurrent state, whole (the hybrid's Mamba state)."""
    out = []
    for entry in cache:
        st = entry[1] if isinstance(entry, tuple) else entry
        out.append(whole_state(st, cfg, mesh))
    return out


def forward(mesh, inputs) -> dict:
    out = {}
    for name in FORWARD:
        cfg = cfg_of(name)
        params = lm_params_from_numpy(inputs["params"][name], cfg, "cpu",
                                      mesh=mesh)
        tokens = TokenPipeline(B, S, cfg.vocab_size).get_for(
            cfg, 1, "cpu", mesh)["tokens"]
        with torch.no_grad():
            out[name] = _np(T.forward_train(params, tokens, cfg))
        out[f"{name}_placed"] = placements_ok(params, cfg, mesh)
    return out


def serve(mesh, inputs, name: str, kv_quant: bool, prompt: int) -> dict:
    """Prefill, each layer's state after it, then GEN - 1 forced decode
    steps: every step's logits, and the first layer's cache shapes."""
    cfg = cfg_of(name, kv_quant_int8=kv_quant)
    model = build_model(cfg, "cpu", mesh)
    params = lm_params_from_numpy(inputs["params"][name], cfg, "cpu",
                                  mesh=mesh)
    batch = {"tokens": torch.from_numpy(prompt_tokens(cfg.vocab_size,
                                                      prompt))}
    cache = model.init_cache(SERVE_B, prompt + GEN)
    logits, cache = model.prefill(params, batch, cache)
    states = layer_states(cache, cfg, mesh)
    steps = [_np(logits)]
    forced = torch.from_numpy(forced_tokens(cfg.vocab_size, prompt))
    for i in range(GEN - 1):
        logits, cache = model.decode_step(params, forced[:, i:i + 1], cache,
                                          prompt + i)
        steps.append(_np(logits))
    first = cache[0]
    shapes = ([tuple(first[0].k.shape), tuple(first[1].h.shape)]
              if isinstance(first, tuple) else
              [tuple(getattr(first, f.name).shape)
               for f in dataclasses.fields(first)])
    return {"logits": steps, "states": states, "shapes": shapes}


def train(mesh, inputs, name: str):
    """STEPS global-route steps from the reference's initial state:
    (losses, grad norms, whole parameters after, placed), and the
    state."""
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
    # _imc_linear's route: the chain on each rank's ff block when it is
    # whole 128-column tiles, else on ff gathered
    _, fl = SH.local_range(L.IMC_X_AXES, (B, S, cfg.d_ff), 2, mesh)
    tiled = cfg.imc_linear and fl < cfg.d_ff and fl % 128 == 0
    return (losses, norms, [_np(p) for p in state.params.parameters()],
            placed, tiled), state


def checkpoint(mesh, other, states: dict, inputs, out: Path) -> dict:
    """Each trained state saved on ``mesh``, restored into a state placed
    on ``other`` (built from the reference's initial one): both whole
    values, and whether every restored leaf is placed on ``other``."""
    res = {}
    for name in CHECKPOINTED:
        SH.set_mesh(mesh)
        cfg, state = cfg_of(name), states[name]
        mgr = CheckpointManager(out / f"ckpt_{name}", keep=1)
        mgr.save(state.step, state)
        saved = [_np(t) for t in list(state.params.parameters())
                 + state.opt["mu"] + state.opt["nu"]]
        SH.set_mesh(other)
        target = train_state_from_numpy(
            inputs["params"][name], inputs["mu"][name], inputs["nu"][name],
            0, cfg, "cpu", mesh=other)
        axes = state_axes(T.param_axes(target.params, cfg))
        step, back = mgr.restore_latest(target, SH.tree_shardings(
            axes, target, other))
        leaves = (list(back.params.parameters()) + back.opt["mu"]
                  + back.opt["nu"])
        res[name] = {"saved": saved, "step": step,
                     "restored_step": back.step,
                     "restored": [_np(t) for t in leaves],
                     "restored_placed": all(
                         SH.on_mesh(t) and t.device_mesh == other
                         for t in leaves)}
    return res


def launchers(argv_train: list, argv_serve: list) -> dict:
    """Both LM launchers on this rank's process group."""
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.launch import train as train_launcher

    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        st = train_launcher.main(argv_train)
        run = serve_launcher.main(argv_serve)
    return {"printed": text.getvalue(),
            "params": [_np(p) for p in st.params.parameters()],
            "tokens": run.tokens.numpy().copy()}


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
                for name, kv in SERVED:
                    r["serve"][name, kv] = serve(mesh, inputs, name, kv,
                                                 PROMPT)
                r["ring"] = serve(mesh, inputs, "hymba", False, RING_PROMPT)
                lap("serve")
                for name in TRAINED:
                    r["train"][name], states[shape, name] = train(
                        mesh, inputs, name)
                    lap(f"train {name}")
                res[shape] = r
            t1 = time.perf_counter()
            if world == 4:
                res["checkpoint"] = checkpoint(
                    meshes[(2, 2)], meshes[(1, 4)],
                    {n: states[(2, 2), n] for n in CHECKPOINTED}, inputs,
                    out_dir)
            if inputs.get("launchers"):
                SH.set_mesh(None)
                res["launchers"] = launchers(*inputs["launchers"])
            res["seconds"]["checkpoint and launchers"] = \
                time.perf_counter() - t1
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
