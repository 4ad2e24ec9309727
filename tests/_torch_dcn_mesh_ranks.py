"""Rank workers for the DCN routes over a model sharded within each pod
(``tests/test_torch_dcn_mesh.py``), and the training run both sides
share.

It imports only ``torch``, numpy and ``repro_torch``: the tests start each
rank with the ``spawn`` method, and a child imports this module afresh,
so it must not pull in JAX. Each rank joins a gloo group of 4 through a
``file://`` store, runs one intra-op thread, builds each ``(pod, data,
model)`` mesh over the group, trains every case on it, and writes what it
computed (whole values, numpy; the payloads of its first step) to
``<out>/rank<r>.pkl``; a failure writes its traceback to
``<out>/rank<r>.err`` first.
"""

from __future__ import annotations

import contextlib
import dataclasses
import pickle
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import get_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.dist import compression as C
from repro_torch.dist import sharding as SH
from repro_torch.models.model_zoo import build_model
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import (
    TrainConfig,
    init_train_state,
    make_train_step,
)

import _torch_lm_mesh_ranks as LM
from _torch_lm_mesh_ranks import _np

WORLD = 4
MESHES = ((2, 1, 2), (2, 2, 1))
NAMES = ("pod", "data", "model")
# the reduced Qwen (its layers stacked: one compressed leaf a name) and
# the reduced xLSTM with 4 layers (its blocks a list: a leaf a block)
CONFIGS = {"qwen": ("qwen2_7b", {}),
           "xlstm": ("xlstm_125m", {"num_layers": 4})}
METHODS = ("none", "int8", "topk", "topk_ef")
# none: the parameters after 3 steps; topk_ef: a second step sends the
# first one's residuals; int8 and topk: one step's payloads
STEPS = {"none": 3, "int8": 1, "topk": 1, "topk_ef": 2}
BATCH, SEQ = 8, 16
TOPK_FRAC = 0.25
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)


def cfg_of(name: str):
    arch, over = CONFIGS[name]
    return dataclasses.replace(get_config(arch).reduced(), **over)


def tcfg_of(method: str) -> TrainConfig:
    return TrainConfig(optimizer=AdamWConfig(**OPT), dcn_pods=2,
                       dcn_compression=method, dcn_topk_frac=TOPK_FRAC)


@contextlib.contextmanager
def recorded_sends(sink: list):
    """Each ``dcn_send_leaf`` call of ``dcn_allreduce_tree`` (the
    process-group route) on this rank: (leaf index, the gathered leaf,
    its residual, the pod's key, the payload, the new residual), numpy."""
    real = C.dcn_send_leaf

    def recording(g, e, i, method, frac, key, u=None):
        sent, ne = real(g, e, i, method, frac, key, u)
        sink.append((i, g.numpy().copy(),
                     None if e is None else e.numpy().copy(), key,
                     sent.numpy().copy(),
                     None if ne is None or e is None else ne.numpy().copy()))
        return sent, ne

    C.dcn_send_leaf = recording
    try:
        yield sink
    finally:
        C.dcn_send_leaf = real


def run_steps(name: str, method: str, steps: int, mesh=None,
              record: bool = False) -> dict:
    """``steps`` steps of ``dcn_pods=2`` from seed 0 over ``mesh`` (the
    model placed on it; None: one device): the route, each step's
    metrics, the whole parameters and the residual rows after them, and
    (``record``) the first step's payloads on this rank."""
    cfg = cfg_of(name)
    model = build_model(cfg, "cpu", mesh)
    tcfg = tcfg_of(method)
    state = init_train_state(model, 0, tcfg)
    step_fn = make_train_step(model, tcfg)
    pipe = TokenPipeline(BATCH, SEQ, cfg.vocab_size)
    metrics, sends = [], []
    for s in range(steps):
        with (recorded_sends(sends) if record and s == 0
              else contextlib.nullcontext()):
            state, m = step_fn(state, pipe.get_for(cfg, s, "cpu"))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"route": step_fn.dcn_route, "metrics": metrics,
            "params": [_np(p) for p in state.params.parameters()],
            "ef": [SH.local_value(e).numpy().copy() for e in state.ef]
            if state.ef else [],
            "ef_on_mesh": [SH.on_mesh(e) for e in state.ef]
            if state.ef else [],
            "sends": sends}


def worker(rank: int, world: int, store: str, out: str, inputs: dict
           ) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    out_dir = Path(out)
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=world)
        try:
            res = {"seconds": {}}
            for shape in MESHES:
                mesh = init_device_mesh("cpu", shape, mesh_dim_names=NAMES)
                res[shape, "pod"] = mesh.get_local_rank("pod")
                for name in CONFIGS:
                    for method in METHODS:
                        t0 = time.perf_counter()
                        res[shape, name, method] = run_steps(
                            name, method, STEPS[method], mesh, record=True)
                        res["seconds"][shape, name, method] = \
                            time.perf_counter() - t0
                    # the emulated route over the pod's own (data, model)
                    # ranks: the same sharded arithmetic, folded in order
                    res[shape, name, "submesh"] = run_steps(
                        name, "none", STEPS["none"], mesh["data", "model"])
        finally:
            SH.set_mesh(None)
            dist.destroy_process_group()
        (out_dir / f"rank{rank}.pkl").write_bytes(pickle.dumps(res))
    except BaseException:
        (out_dir / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def start(out: Path) -> list:
    """``WORLD`` ranks of ``worker``, spawned and left running."""
    return LM.start(WORLD, out, {}, worker)
