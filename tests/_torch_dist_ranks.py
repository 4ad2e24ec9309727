"""Rank workers for the multi-rank tests of the port's distributed routes
(``tests/test_torch_dist.py``), and the training run both sides share.

It imports only ``torch`` and ``repro_torch``: the tests start each rank
with the ``spawn`` method, and a child imports this module afresh, so it
must not pull in JAX. Each rank joins a gloo group through a ``file://``
store (no TCP port to share between test workers), runs one intra-op
thread, builds a one-dimensional ``pod`` mesh over the group, and writes
what it computed to ``<out>/rank<r>.pt``; a failure writes its
traceback to ``<out>/rank<r>.err`` first.
"""

from __future__ import annotations

import traceback
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.dist.compression import (
    cross_pod_allreduce,
    dcn_allreduce_tree,
    per_step_key,
)
from repro_torch.models.model_zoo import build_model
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import (
    TrainConfig,
    init_train_state,
    make_train_step,
)

BATCH, SEQ, LR = 8, 64, 1e-3
TOPK_FRAC = 0.25
COLLECTIVE_KEY = per_step_key(3, 7)
# (name, shape) of the stand-in gradient leaves of the collective tests
LEAVES = (("w", (6, 5)), ("b", (7,)), ("s", (1,)))


def run_steps(dcn: dict, steps: int, mesh=None) -> dict:
    """``steps`` train steps of ``qwen2_7b.reduced()`` on the CPU from
    seed 0 with ``TrainConfig(**dcn)`` (lr 1e-3): the route, each step's
    metrics, and the parameters, moments and residuals after them."""
    cfg = get_config("qwen2_7b").reduced()
    model = build_model(cfg, "cpu")
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=LR), **dcn)
    state = init_train_state(model, 0, tcfg, mesh)
    step_fn = make_train_step(model, tcfg, mesh)
    pipe = TokenPipeline(BATCH, SEQ, cfg.vocab_size)
    metrics = []
    for s in range(steps):
        state, m = step_fn(state, pipe.get_for(cfg, s, "cpu"))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"route": step_fn.dcn_route, "pods": step_fn.dcn_pods,
            "metrics": metrics,
            "params": [p.detach().clone() for p in state.params.parameters()],
            "mu": [t.clone() for t in state.opt["mu"]],
            "nu": [t.clone() for t in state.opt["nu"]],
            "ef": [t.clone() for t in state.ef] if state.ef else []}


def collective_inputs(pod: int, method: str) -> tuple[list, list]:
    """Pod ``pod``'s stand-in gradient leaves and (for ``topk_ef``) its
    residuals, from a seed: integers and halves, so ties are many."""
    rng = np.random.default_rng(100 + pod)
    grads = [torch.from_numpy((rng.integers(-4, 5, size=s) / 2.0)
                              .astype(np.float32)) for _, s in LEAVES]
    err = []
    if method == "topk_ef":
        err = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
               for _, s in LEAVES]
    return grads, err


def _mesh(rank: int, world: int, store: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    return init_device_mesh("cpu", (world,), mesh_dim_names=("pod",))


def worker(rank: int, world: int, store: str, out: str,
           train: list) -> None:
    """One rank: the process-group train step for each ``(name, dcn,
    steps)`` of ``train`` (``dcn_pods=world``), then
    ``dcn_allreduce_tree`` and ``cross_pod_allreduce`` on this pod's
    ``collective_inputs`` for each method."""
    import torch.distributed as dist

    out_dir = Path(out)
    try:
        mesh = _mesh(rank, world, store)
        try:
            res = {"train": {name: run_steps(dict(dcn, dcn_pods=world),
                                             steps, mesh)
                             for name, dcn, steps in train},
                   "tree": {}, "array": {}}
            for method in ("none", "int8", "topk", "topk_ef"):
                g, e = collective_inputs(rank, method)
                res["tree"][method] = dcn_allreduce_tree(
                    [t[None] for t in g], [t[None] for t in e] or {}, mesh,
                    "pod", method, TOPK_FRAC, COLLECTIVE_KEY)
                if method != "topk_ef":
                    res["array"][method] = cross_pod_allreduce(
                        g[0], mesh, "pod", method, TOPK_FRAC,
                        COLLECTIVE_KEY)
        finally:
            dist.destroy_process_group()
        torch.save(res, out_dir / f"rank{rank}.pt")
    except BaseException:
        (out_dir / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
