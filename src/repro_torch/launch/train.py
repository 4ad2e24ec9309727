"""Training launcher (``repro.launch.train``) on one device or over a
device mesh.

Wires together: config -> model -> train step -> synthetic token
pipeline -> checkpointing (auto-resume, async, keep-N) -> straggler
monitor. The gradient reduction is the reference's: global, or with
``--dcn-pods P`` / ``--dcn-compression`` the emulated hierarchy over P pod
slices on this device (a ``grad sync:`` line names it, and each logged
step adds the pod's DCN bytes beside the raw ones), its ``topk_ef``
residuals checkpointed with the rest of the state. With ``--imc-linear``
every FFN down-projection (an
encoder-decoder's encoder layers too) runs through the SpecPCM analog
chain (the ``imc_mvm`` kernel on the card) with a straight-through
gradient; an MoE config's layers have no dense FFN, so there it routes
nothing, as in the reference. ``TokenPipeline.get_for`` gives each family
its batch (the VLM's patches, the encoder-decoder's frames).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_7b \
      --reduced --steps 3 --device cpu [--imc-linear] \
      [--dcn-pods 2 --dcn-compression topk_ef]

  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
      --arch qwen2_7b --reduced --steps 3 --device cpu

The flags are the reference's plus ``--device`` (default ``cuda``; asking
for it without a card raises). ``--mesh debug`` is ``make_debug_mesh``:
over the process group ``torchrun`` describes (``WORLD_SIZE`` > 1; NCCL
when each rank has a card of its own, else gloo, as ``serve_db`` picks
it), or the one-device mapping without one; ``single`` and ``multi`` are
``make_production_mesh``, which raises unless the group has 256 (512)
ranks. The run prints the reference's ``mesh: {...} devices=N`` line and
places the train state by its logical axes (``state_axes``); over more
than one rank every family runs (and ``--dcn-pods`` takes the emulated
route over the sharded model), every rank draws the same global batch
and keeps its block, rank 0 alone prints and writes the checkpoints (each leaf
gathered whole: a checkpoint restores on another mesh), and a straggler
eviction only reports (the ranks' clocks differ, and a save is
collective). Parameters are the port's own draw from seed 0. Each logged
step prints its loss, grad_norm and the mean wall seconds a step (the
log line reads the loss back, which waits for the device).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import time

import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.dist.checkpoint import CheckpointManager
from repro_torch.dist.sharding import is_device_mesh, tree_shardings
from repro_torch.dist.straggler import Action, StragglerMonitor
from repro_torch.kernels import _build
from repro_torch.launch.mesh import (
    join_group,
    make_debug_mesh,
    make_production_mesh,
    mesh_line,
)
from repro_torch.models import transformer as T
from repro_torch.models.model_zoo import build_model
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import (
    TrainConfig,
    init_train_state,
    make_train_step,
    state_axes,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="full")
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "int8", "topk"],
                    help="legacy in-graph compression of the already-"
                         "reduced grads (simulation only)")
    ap.add_argument("--dcn-compression", default="none",
                    choices=["none", "int8", "topk", "topk_ef"],
                    help="wire compression on the cross-pod (DCN) hop of "
                         "the hierarchical gradient reduction")
    ap.add_argument("--dcn-pods", type=int, default=0,
                    help="per-pod gradient slices, emulated on this device; "
                         "0 = size of the mesh's 'pod' axis (1 here)")
    ap.add_argument("--dcn-topk-frac", type=float, default=0.01)
    ap.add_argument("--seed", type=int, default=0,
                    help="base of the per-step stochastic-rounding key")
    ap.add_argument("--imc-linear", action="store_true",
                    help="route FFN down-projections through the SpecPCM "
                         "IMC quantized-matmul model (the imc_mvm kernel)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--mesh", default="debug",
                    choices=["debug", "single", "multi"],
                    help="debug: make_debug_mesh over the process group "
                         "(one device without one); single / multi: the "
                         "production meshes of 256 / 512 ranks")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    own_group = join_group(device)
    try:
        # rank 0 alone reports
        quiet = dist.is_initialized() and dist.get_rank() > 0
        with (contextlib.redirect_stdout(io.StringIO()) if quiet
              else contextlib.nullcontext()):
            return _train(args, device)
    finally:
        if own_group:
            dist.destroy_process_group()


def _train(args, device):
    """The launcher's run on this rank."""
    if args.mesh == "debug":
        mesh = make_debug_mesh(device_type=device.type)
    else:
        mesh = make_production_mesh(multi_pod=args.mesh == "multi",
                                    device_type=device.type)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.imc_linear:
        cfg = dataclasses.replace(cfg, imc_linear=True)
    print(mesh_line(mesh))

    model = build_model(cfg, device, mesh)
    tcfg = TrainConfig(
        optimizer=AdamWConfig(lr=args.lr, total_steps=args.steps),
        remat=args.remat, microbatches=args.microbatches,
        grad_compression=args.grad_compression,
        dcn_compression=args.dcn_compression, dcn_pods=args.dcn_pods,
        dcn_topk_frac=args.dcn_topk_frac, seed=args.seed,
    )
    step_fn = make_train_step(model, tcfg, mesh)
    if step_fn.dcn_route != "global":
        print(f"grad sync: {step_fn.dcn_route} hierarchy over "
              f"{step_fn.dcn_pods} pod(s), "
              f"dcn_compression={tcfg.dcn_compression}")
    if device.type == "cuda" and cfg.imc_linear:
        _build.load("imc_mvm")   # set-up: the kernel builds before step 1
    state = init_train_state(model, seed=0, tcfg=tcfg)
    state_sh = None
    if is_device_mesh(mesh):
        state_sh = tree_shardings(state_axes(T.param_axes(
            state.params, cfg), tcfg), state, mesh)
    pipe = TokenPipeline(batch=args.batch, seq=args.seq, vocab=cfg.vocab_size)

    start_step = 0
    ckpt = None
    if args.ckpt_dir:
        ckpt = CheckpointManager(args.ckpt_dir, keep=3)
        restored = ckpt.restore_latest(state, state_sh)
        if restored is not None:
            start_step, state = restored
            print(f"resumed from checkpoint step {start_step}")

    monitor = StragglerMonitor(
        on_warn=lambda s, dt: print(f"[straggler] step {s}: {dt:.3f}s"),
        on_evict=lambda s, dt: print(
            f"[straggler] step {s}: {dt:.3f}s — would evict+reshard"),
    )

    t_start = time.time()
    for step in range(start_step, args.steps):
        monitor.step_start()
        batch = pipe.get_for(cfg, step, device, mesh)
        state, metrics = step_fn(state, batch)
        action = monitor.step_end()
        if action == Action.EVICT and ckpt is not None and state_sh is None:
            ckpt.save_async(step + 1, state)
        if (step + 1) % args.log_every == 0 or step == start_step:
            loss = float(metrics["loss"])
            gn = float(metrics["grad_norm"])
            dcn = ""
            sent, raw = metrics["dcn_bytes"], metrics["dcn_raw_bytes"]
            if sent > 0:
                dcn = (f" dcn={sent / 2**20:.2f}MiB/pod "
                       f"({raw / max(sent, 1.0):.1f}x smaller)")
            print(f"step {step + 1}: loss={loss:.4f} grad_norm={gn:.3f} "
                  f"({(time.time() - t_start) / (step - start_step + 1):.2f}"
                  f"s/step)" + dcn, flush=True)
        if ckpt is not None and (step + 1) % args.ckpt_every == 0:
            ckpt.save_async(step + 1, state)
    if ckpt is not None:
        ckpt.save(args.steps, state)
        ckpt.wait()
    print(f"done: {args.steps - start_step} steps in "
          f"{time.time() - t_start:.1f}s")
    return state


if __name__ == "__main__":
    main()
