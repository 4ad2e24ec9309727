"""Rank workers for the dense LM over a device mesh
(``tests/test_torch_lm_mesh.py``).

It imports only ``torch``, numpy and ``repro_torch``: the tests start each
rank with the ``spawn`` method, and a child imports this module afresh,
so it must not pull in JAX. Each rank joins a gloo group through a
``file://`` store, runs one intra-op thread, builds each ``(data, model)``
mesh of its world size over the group, runs every case on it, and writes
what it computed (whole values, numpy) to ``<out>/rank<r>.pkl``; a
failure writes its traceback to ``<out>/rank<r>.err`` first. The inputs
(the reference's parameters and train states, as numpy) come from the
test process.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import multiprocessing
import os
import pickle
import time
import traceback
from pathlib import Path

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy, train_state_from_numpy
from repro_torch.data.tokens import TokenPipeline
from repro_torch.dist import sharding as SH
from repro_torch.dist.checkpoint import CheckpointManager
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.model_zoo import build_model
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import (
    TrainConfig,
    make_train_step,
    state_axes,
)

MESHES = {2: ((1, 2), (2, 1)), 4: ((2, 2), (1, 4))}
NAMES = ("data", "model")
# the configs by name: qwen2_7b.reduced() (d_ff 128: an ff shard is not a
# whole 128-column tile on model = 2 or 4) and d_ff 512 (whole tiles)
CONFIGS = {"ff128": {}, "ff128_imc": {"imc_linear": True},
           "ff512": {"d_ff": 512},
           "ff512_imc": {"d_ff": 512, "imc_linear": True}}
TRAINED = ("ff128", "ff128_imc", "ff512_imc")
B, S = 4, 16                # forward and train batches
STEPS = 3
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
SERVE_B, PROMPT, GEN = 4, 12, 9
AMAX = dict(rows=4, seq=4, ff=512, d=64, hot=5.0)


def cfg_of(name: str, **kw):
    return dataclasses.replace(get_config("qwen2_7b").reduced(),
                               **CONFIGS[name], **kw)


def forced_tokens(vocab: int) -> np.ndarray:
    """The (B, GEN - 1) tokens forced into the decode steps."""
    rng = np.random.default_rng(5)
    return rng.integers(0, vocab, size=(SERVE_B, GEN - 1)).astype(np.int32)


def amax_inputs() -> tuple[np.ndarray, np.ndarray]:
    """h (rows, seq, ff) and w (ff, d) for ``_imc_linear`` whose row maxima
    sit in the first quarter of ff (rank 0's block on model = 2 and 4),
    at ``hot`` times the rest: a rank that scaled by its own block's
    maximum would quantize its block otherwise."""
    rng = np.random.default_rng(9)
    h = rng.normal(size=(AMAX["rows"], AMAX["seq"], AMAX["ff"]))
    h[..., 7] = AMAX["hot"] * np.sign(h[..., 7] + 0.5)
    w = rng.normal(size=(AMAX["ff"], AMAX["d"])) * AMAX["ff"] ** -0.5
    w[3] *= AMAX["hot"]
    return h.astype(np.float32), w.astype(np.float32)


def _np(t) -> np.ndarray:
    return SH.full_value(t).detach().float().numpy().copy()


def _raises(fn) -> str:
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            fn()
    except Exception as e:  # the kind is what the test checks
        return type(e).__name__
    return "none"


def placements_ok(params, cfg, mesh) -> bool:
    """Every leaf is a DTensor placed by ``logical_to_sharding`` of its
    ``param_axes`` on ``mesh``."""
    return all(
        SH.on_mesh(p) and tuple(p.placements) == SH.logical_to_sharding(
            axes, tuple(p.shape), mesh)
        for p, axes in zip(params.parameters(), T.param_axes(params, cfg)))


def forward(mesh, inputs) -> dict:
    out = {}
    for name in CONFIGS:
        cfg = cfg_of(name)
        params = lm_params_from_numpy(inputs["params"][name], cfg, "cpu",
                                      mesh=mesh)
        tokens = TokenPipeline(B, S, cfg.vocab_size).get_for(
            cfg, 1, "cpu", mesh)["tokens"]
        with torch.no_grad():
            out[name] = _np(T.forward_train(params, tokens, cfg))
        out[f"{name}_placed"] = placements_ok(params, cfg, mesh)
    # REPRO_BASELINE=1 moves the block's constrains after the adds
    cfg = cfg_of("ff128")
    params = lm_params_from_numpy(inputs["params"]["ff128"], cfg, "cpu",
                                  mesh=mesh)
    tokens = TokenPipeline(B, S, cfg.vocab_size).get_for(
        cfg, 1, "cpu", mesh)["tokens"]
    os.environ["REPRO_BASELINE"] = "1"
    try:
        with torch.no_grad():
            out["ff128_baseline"] = _np(T.forward_train(params, tokens, cfg))
    finally:
        del os.environ["REPRO_BASELINE"]
    return out


def remat(mesh, inputs) -> dict:
    """One step of the reduced config from the reference's initial state
    under each remat policy: the loss and the whole parameters after."""
    cfg = cfg_of("ff128_imc")
    out = {}
    for policy in ("none", "dots", "full"):
        state = train_state_from_numpy(
            inputs["params"]["ff128"], inputs["mu"]["ff128"],
            inputs["nu"]["ff128"], 0, cfg, "cpu", mesh=mesh)
        step = make_train_step(build_model(cfg, "cpu", mesh), TrainConfig(
            optimizer=AdamWConfig(**OPT), remat=policy))
        state, m = step(state, TokenPipeline(B, S, cfg.vocab_size).get_for(
            cfg, 0, "cpu", mesh))
        out[policy] = (float(m["loss"]),
                       [_np(p) for p in state.params.parameters()])
    return out


def train(mesh, inputs, name: str):
    """STEPS global-route steps from the reference's initial state:
    (losses, grad norms, whole parameters after, the state)."""
    cfg = cfg_of(name)
    params, mu, nu = inputs["params"][name], inputs["mu"][name], \
        inputs["nu"][name]
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


def serve(mesh, inputs, kv_quant: bool) -> dict:
    """Prefill and GEN - 1 forced decode steps: every step's logits."""
    cfg = cfg_of("ff128", kv_quant_int8=kv_quant)
    model = build_model(cfg, "cpu", mesh)
    params = lm_params_from_numpy(inputs["params"]["ff128"], cfg, "cpu",
                                  mesh=mesh)
    batch = TokenPipeline(SERVE_B, PROMPT, cfg.vocab_size).get_for(
        cfg, 0, "cpu")
    cache = model.init_cache(SERVE_B, PROMPT + GEN)
    logits, cache = model.prefill(params, batch, cache)
    steps = [_np(logits)]
    forced = torch.from_numpy(forced_tokens(cfg.vocab_size))
    for i in range(GEN - 1):
        logits, cache = model.decode_step(params, forced[:, i:i + 1], cache,
                                          PROMPT + i)
        steps.append(_np(logits))
    return {"logits": steps, "cache_shape": tuple(cache[0].k.shape)}


def amax_case(mesh) -> dict:
    """``_imc_linear`` on an ff-sharded h and w_down whose row maxima sit
    in rank 0's block, and the same chain with each rank's own maxima."""
    cfg = cfg_of("ff512_imc")
    h, w = (torch.from_numpy(a) for a in amax_inputs())
    hd = SH.place(h, L.IMC_X_AXES, mesh)
    wd = SH.place(w, ("ff", "fsdp"), mesh)
    got = _np(L._imc_linear(hd, wd, cfg))
    hl, wl = (x.redistribute(mesh, SH.logical_to_sharding(
        axes, tuple(x.shape), mesh)).to_local() for x, axes in (
            (hd, L.IMC_X_AXES), (wd, L.IMC_W_AXES)))
    _, y = L._imc_parts(hl, wl, cfg)            # this block's maxima only
    for a in SH.dim_axes(L.IMC_X_AXES, hd.shape, 2, mesh):
        torch.distributed.all_reduce(y, group=mesh.get_group(a))
    y = DTensor.from_local(y, mesh, SH.logical_to_sharding(
        L.IMC_Y_AXES, (*h.shape[:2], w.shape[1]), mesh), run_check=False)
    fl = SH.local_range(L.IMC_X_AXES, hd.shape, 2, mesh)[1]
    return {"mesh": got, "local_amax": _np(y),
            "tiled": fl < AMAX["ff"] and fl % 128 == 0}


def checkpoint(mesh, other, state, inputs, out: Path) -> dict:
    """The trained state saved on ``mesh``, restored into a state placed
    on ``other`` (built from the reference's initial one); both whole
    values, and whether every restored leaf is placed on ``other``."""
    cfg = cfg_of("ff128")
    mgr = CheckpointManager(out / "ckpt", keep=1)
    mgr.save(state.step, state)
    saved = [_np(t) for t in list(state.params.parameters())
             + state.opt["mu"] + state.opt["nu"]]
    SH.set_mesh(other)
    target = train_state_from_numpy(
        inputs["params"]["ff128"], inputs["mu"]["ff128"],
        inputs["nu"]["ff128"], 0, cfg, "cpu", mesh=other)
    axes = state_axes(T.param_axes(target.params, cfg))
    step, back = mgr.restore_latest(target, SH.tree_shardings(
        axes, target, other))
    leaves = list(back.params.parameters()) + back.opt["mu"] + back.opt["nu"]
    return {"saved": saved, "step": step, "restored_step": back.step,
            "restored": [_np(t) for t in leaves],
            "restored_placed": all(
                SH.on_mesh(t) and t.device_mesh == other for t in leaves)}


def launchers(argv_train: list, argv_serve: list) -> dict:
    """Both LM launchers on this rank's process group, their failure on
    the production mesh, and the recurrent and hybrid families and a DCN
    route on this group."""
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
        "train_single": _raises(lambda: train_launcher.main(
            argv_train + ["--mesh", "single"])),
        "train_recurrent": _raises(lambda: train_launcher.main(
            other("xlstm_125m") + ["--steps", "1"])),
        "serve_recurrent": _raises(lambda: serve_launcher.main(
            other("hymba_1_5b") + ["--gen", "2"])),
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
                r = {"seconds": {}, "train": {}}
                clock = time.perf_counter()

                def lap(what):
                    nonlocal clock
                    now = time.perf_counter()
                    r["seconds"][what] = now - clock
                    clock = now

                r["forward"] = forward(mesh, inputs)
                lap("forward")
                r["serve"] = {kv: serve(mesh, inputs, kv)
                              for kv in (False, True)}
                lap("serve")
                r["amax"] = amax_case(mesh)
                lap("amax")
                r["remat"] = remat(mesh, inputs)
                lap("remat")
                for name in TRAINED:
                    r["train"][name], states[shape, name] = train(
                        mesh, inputs, name)
                    lap(f"train {name}")
                res[shape] = r
            if world == 4:
                SH.set_mesh(meshes[(2, 2)])
                res["checkpoint"] = checkpoint(
                    meshes[(2, 2)], meshes[(1, 4)],
                    states[(2, 2), "ff128"], inputs, out_dir)
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


def start(world: int, out: Path, inputs: dict, target=None) -> list:
    """``world`` ranks of ``target`` (default ``worker``), spawned and left
    running."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target or worker,
                         args=(r, world, str(out / "store"), str(out),
                               inputs))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs


def join(procs: list, out: Path, deadline: float) -> list:
    """The ranks joined by ``deadline`` (``time.monotonic``) or killed,
    and the test fails; returns each rank's results."""
    world = len(procs)
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
        alive = sum(p.is_alive() for p in procs)
        assert alive == 0, f"{alive} of {world} ranks still running"
        errs = [f.read_text() for f in sorted(out.glob("rank*.err"))]
        assert all(p.exitcode == 0 for p in procs) and not errs, (
            [p.exitcode for p in procs], errs)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    return [pickle.loads((out / f"rank{r}.pkl").read_bytes())
            for r in range(world)]
