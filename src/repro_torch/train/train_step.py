"""Train step factory (``repro.train.train_step``): loss, gradients and
AdamW on one device, with microbatch gradient accumulation, the remat
policy and the bfloat16 parameter cast.

The port has the reference's **global** route: one backward pass over
the batch (or, with ``microbatches > 1``, over each slice in turn,
accumulated in float32 and scaled by ``1 / microbatches``). The
hierarchical ICI/DCN routes (``dcn_compression``, ``dcn_pods > 1``) and
the legacy in-graph ``grad_compression`` need ``dist/compression``, which
is not ported yet (ROADMAP.md, Queue 1 item 5.6): asking for them raises.

The parameters are the model's :class:`~repro_torch.models.transformer.LM`
with float32 leaves that carry gradients (``Model.init(trainable=True)``);
an optimizer step updates them and the moments in place, and
``TrainState.step`` is a Python int, so a step reads nothing back from
the device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models.model_zoo import Model
from repro_torch.models.transformer import LM
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update

# the reference's dist.compression.DCN_METHODS
DCN_METHODS = ("none", "int8", "topk", "topk_ef")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    remat: str = "full"              # full | dots | none
    microbatches: int = 1            # gradient accumulation
    grad_compression: str = "none"   # legacy in-graph simulation (not ported)
    # cast float32 master params (ndim > 1) to bfloat16 before the forward
    cast_params_bf16: bool = False
    # hierarchical ICI/DCN reduction (not ported: must stay none / 0 / 1)
    dcn_compression: str = "none"
    dcn_pods: int = 0
    dcn_topk_frac: float = 0.01
    seed: int = 0


@dataclasses.dataclass
class TrainState:
    params: LM
    opt: dict        # {"mu": [...], "nu": [...], "step": int}
    step: int


def resolve_pods(tcfg: TrainConfig) -> int:
    """Effective pod count: an explicit ``dcn_pods``, else 1 (one device
    has no mesh, so no ``pod`` axis)."""
    return tcfg.dcn_pods if tcfg.dcn_pods > 0 else 1


def init_train_state(model: Model, seed: int = 0) -> TrainState:
    """Trainable parameters drawn from ``seed`` and zero AdamW moments."""
    params = model.init(seed, trainable=True)
    return TrainState(params=params, opt=adamw_init(list(params.parameters())),
                      step=0)


def _cast_bf16(params: LM) -> dict:
    """The parameter tree with the reference's float32 leaves of ndim > 1
    cast to bfloat16 (gradients flow back through the cast to the float32
    leaves), in the layout ``forward_train`` reads. The reference stacks
    a ``layers`` (and ``enc_layers``) leaf on a leading layer axis, so
    there every per-layer leaf but a scalar is cast (norm scales, biases,
    Mamba's ``dt_bias`` and ``d_skip``, the hybrid's ``alpha``); the
    unstacked ``blocks`` of the ``ssm`` family keep their vectors
    (``f_bias``, norm scales) in float32; ``embed`` and ``lm_head`` are
    cast, ``final_norm`` and ``enc_norm`` are not."""
    stacked = params.stack == "layers"

    def cast(t, extra=0):
        if t is None or t.dtype != torch.float32 or t.ndim + extra < 2:
            return t
        return t.to(torch.bfloat16)

    def block(lp, e):
        out = {name: {k: cast(t, e) for k, t in group.items()}
               for name, group in lp.items()}
        out.update((k, cast(t, e)) for k, t in lp.named_parameters(
            recurse=False))
        return out

    tree = {
        "embed": cast(params.embed),
        params.stack: [block(lp, int(stacked))
                       for lp in params[params.stack]],
        "final_norm": {k: cast(t) for k, t in params.final_norm.items()},
        "lm_head": cast(params.lm_head),
    }
    if params.enc_layers is not None:
        tree["enc_layers"] = [block(lp, 1) for lp in params.enc_layers]
        tree["enc_norm"] = {k: cast(t) for k, t in params.enc_norm.items()}
    return tree


def make_train_step(model: Model, tcfg: TrainConfig) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    The function carries ``dcn_route = "global"`` and ``dcn_pods = 1``,
    the only reduction path on one device."""
    if tcfg.dcn_compression not in DCN_METHODS:
        raise ValueError(f"unknown dcn_compression: {tcfg.dcn_compression}")
    if (tcfg.dcn_compression != "none" or tcfg.dcn_pods > 1
            or tcfg.grad_compression != "none"):
        raise NotImplementedError(
            f"the hierarchical DCN reduction and gradient compression "
            f"(dcn_compression={tcfg.dcn_compression!r}, dcn_pods="
            f"{tcfg.dcn_pods}, grad_compression={tcfg.grad_compression!r}) "
            f"need dist/compression, which is not ported yet (ROADMAP.md, "
            f"Queue 1 item 5.6)")
    mb = tcfg.microbatches

    def loss_fn(params: LM, batch):
        tree = _cast_bf16(params) if tcfg.cast_params_bf16 else params
        return model.loss(tree, batch, remat=tcfg.remat)

    def value_and_grad(params: LM, batch):
        leaves = list(params.parameters())
        loss = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        return loss.detach(), list(grads)

    def compute_grads(params: LM, batch):
        if mb <= 1:
            return value_and_grad(params, batch)
        b = batch["tokens"].shape[0]
        if b % mb:
            raise ValueError(f"batch {b} is not a multiple of microbatches "
                             f"{mb}")
        loss = torch.zeros((), device=model.device)
        grads = [torch.zeros_like(p, dtype=torch.float32)
                 for p in params.parameters()]
        for i in range(mb):
            part = {k: v[i * (b // mb):(i + 1) * (b // mb)]
                    for k, v in batch.items()}
            l, g = value_and_grad(params, part)
            loss = loss + l
            for acc, gi in zip(grads, g):
                acc.add_(gi)
        inv = 1.0 / mb
        return loss * inv, [g.mul_(inv) for g in grads]

    def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        loss, grads = compute_grads(state.params, batch)
        leaves = list(state.params.parameters())
        raw_bytes = 4 * sum(p.numel() for p in leaves)
        _, opt, metrics = adamw_update(tcfg.optimizer, leaves, grads,
                                       state.opt)
        metrics = dict(metrics, loss=loss, dcn_bytes=0.0,
                       dcn_raw_bytes=float(raw_bytes))
        return TrainState(params=state.params, opt=opt,
                          step=state.step + 1), metrics

    train_step.dcn_route = "global"
    train_step.dcn_pods = 1
    return train_step
