"""Train step factory (``repro.train.train_step``): loss, gradients and
AdamW, with microbatch gradient accumulation, the remat policy, the
bfloat16 parameter cast, and the hierarchical ICI/DCN gradient reduction
with optional wire compression.

Reduction contract (the reference's)
------------------------------------
With ``dcn_compression='none'`` and ``dcn_pods`` 0 or 1 the step takes the
**global** route: one backward pass over the batch (or, with
``microbatches > 1``, over each slice in turn, accumulated in float32 and
scaled by ``1 / microbatches``).

Otherwise the batch is split into P pod slices, each pod computes its own
gradients (``compute_grads``, so microbatches compose within a pod), each
pod's payload is compressed (``repro_torch.dist.compression``) and only
the payloads are summed across pods, then scaled by ``1 / P``. Two routes
share that math:

* **emulated** (any device): the pod slices in ascending order on this
  device, each pod's send left-folded, leaf by leaf, into a float32 zero
  tree. With ``dcn_compression='none'`` this equals the global route with
  ``microbatches=P`` bit for bit (the same slices, adds and scaling).
* **"shard_map"** (the mesh's ``pod`` dim has size P == pods): the name is
  the reference's; in the port it is the process-group route. Each rank
  takes the batch slice at its coordinate on the ``pod`` dim, compresses
  its gradients and sums them with ``all_reduce`` over the ``pod`` dim's
  process group (``dcn_allreduce_tree``), and the loss likewise.

On a ``DeviceMesh`` the global route runs on DTensors: the parameters,
moments, batch, loss and gradients are placed by the reference's logical
axes, the loss and gradients are computed inside
``sharding.mesh_context`` (a remat's recompute and the backward formulas
take their plain position and mask tensors as replicated), and the loss
and grad norm in the metrics are whole values on every rank.

Both hierarchy routes also run over a model sharded on a ``DeviceMesh``
(in-pod sharding). On a ``(pod, data, model)`` mesh the process-group
route computes each pod's gradients on DTensors over the pod's ``(data,
model)`` ranks, with ``batch`` resolved without ``pod`` (the reference's
``rules_override``): the parameters are replicated over ``pod`` and no
collective of the pod's forward or backward runs over it, so each pod's
ranks compute their own slice. The emulated route runs each pod slice on
the sharded model in turn. Either way each leaf's gradient is gathered
whole, each of the reference's leaves is compressed whole (the
reference's ``dcn_allreduce_tree`` gathers the pod's tree too), the
payload is summed over the ``pod`` group (or folded, emulated, into a
zero tree placed as the parameters), and each reduced leaf is placed
back as its parameter as soon as it is summed, so a rank holds one whole
leaf at a time beside its blocks. ``TrainState.ef`` holds whole rows,
replicated within the pod (``state_axes``).

The compressors see the reference's tree (``transformer.tree_leaf_groups``):
a stacked layer leaf is compressed as one leaf (one int8 scale, one top-k
over all its layers), and its send and residual are split back onto the
layers' parameters.

``topk_ef`` carries the error-feedback residuals in ``TrainState.ef``:
float32 ``(P, *shape)`` tensors in ``parameters()`` order on the emulated
route, this rank's ``(1, *shape)`` row on the process-group route
(``sent + new_err == grads + old_err`` every step). int8 rounding keys
fold the step, the pod and the leaf index into ``seed``
(``compression.per_step_key``); the legacy ``grad_compression``, applied
to the reduced gradients, draws from a stream of its own.

The parameters are the model's :class:`~repro_torch.models.transformer.LM`
with float32 leaves that carry gradients (``Model.init(trainable=True)``);
a step updates them, the moments and the residuals in place, and
``TrainState.step`` is a Python int, so a step (its rounding keys
included) reads nothing back from the device.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.dist.compression import (
    DCN_METHODS,
    LEGACY_STREAM,
    cross_pod_allreduce,
    dcn_allreduce_tree,
    dcn_send_leaf,
    fold_in,
    leaf_wire_bytes,
    per_step_key,
)
from repro_torch.dist import sharding as SH
from repro_torch.dist.sharding import get_mesh, pod_axis_size
from repro_torch.models import transformer as T
from repro_torch.models.model_zoo import Model
from repro_torch.models.transformer import LM
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    remat: str = "full"              # full | dots | none
    microbatches: int = 1            # gradient accumulation (within a pod)
    grad_compression: str = "none"   # legacy in-graph simulation applied to
    #                                  the *reduced* grads (none | int8 | topk)
    # cast float32 master params (ndim > 1) to bfloat16 before the forward
    cast_params_bf16: bool = False
    # hierarchical ICI/DCN reduction:
    dcn_compression: str = "none"    # none | int8 | topk | topk_ef
    dcn_pods: int = 0                # per-pod slices; 0 = auto from the
    #                                  mesh's 'pod' dim (1 when absent)
    dcn_topk_frac: float = 0.01
    seed: int = 0                    # base of the per-step rounding key


@dataclasses.dataclass
class TrainState:
    params: LM
    opt: dict        # {"mu": [...], "nu": [...], "step": int}
    step: int
    ef: Any = dataclasses.field(default_factory=dict)  # per-pod EF residuals


def resolve_pods(tcfg: TrainConfig, mesh=None) -> int:
    """Effective pod count: an explicit ``dcn_pods``, or (when 0) the size
    of the mesh's ``pod`` dim (the installed mesh's when ``mesh`` is None;
    1 with no mesh or no ``pod`` dim)."""
    if tcfg.dcn_pods > 0:
        return tcfg.dcn_pods
    return pod_axis_size(mesh if mesh is not None else get_mesh())


def _uses_hierarchy(tcfg: TrainConfig) -> bool:
    """The hierarchy engages only when it buys something: compression on
    the DCN hop, or an *explicitly requested* pod split. With the defaults
    a multi-pod mesh keeps the global reduction."""
    return tcfg.dcn_compression != "none" or tcfg.dcn_pods > 1


def _route(tcfg: TrainConfig, mesh) -> tuple[str, int]:
    """(``dcn_route``, ``dcn_pods``) by the reference's rules."""
    mesh = mesh if mesh is not None else get_mesh()
    if not _uses_hierarchy(tcfg):
        return "global", 1
    pods = resolve_pods(tcfg, mesh)
    if pods > 1 and pod_axis_size(mesh) == pods:
        return "shard_map", pods
    return "emulated", pods


def _ef_zeros(leaves: list, rows: int) -> list:
    return [torch.zeros((rows, *p.shape), dtype=torch.float32,
                        device=p.device) for p in leaves]


def init_ef_state(params, tcfg: TrainConfig | None, mesh=None) -> Any:
    """Error-feedback residuals: float32 zeros in ``parameters()`` order
    when ``dcn_compression`` carries state (``topk_ef``), else ``{}``.
    ``(P, *shape)`` on the emulated route, this rank's ``(1, *shape)``
    row on the process-group route. ``params``: an LM or a list of
    leaves."""
    if tcfg is None or tcfg.dcn_compression != "topk_ef":
        return {}
    route, pods = _route(tcfg, mesh)
    leaves = list(params.parameters()) if isinstance(params, LM) \
        else list(params)
    return _ef_zeros(leaves, 1 if route == "shard_map" else pods)


def init_train_state(model: Model, seed: int = 0,
                     tcfg: TrainConfig | None = None,
                     mesh=None) -> TrainState:
    """Trainable parameters drawn from ``seed``, zero AdamW moments and,
    for ``topk_ef``, zero residuals (``init_ef_state``); on the model's
    ``DeviceMesh`` the state is placed by ``state_axes`` (the parameters
    as ``init_lm`` placed them, each moment as its leaf)."""
    params = model.init(seed, trainable=True)
    leaves = list(params.parameters())
    state = TrainState(params=params, opt=adamw_init(leaves), step=0,
                       ef=init_ef_state(leaves, tcfg, mesh))
    return SH.distribute_tree(state, state_axes(
        T.param_axes(params, model.cfg), tcfg), model.mesh)


def abstract_train_state(model: Model, tcfg: TrainConfig | None = None,
                         mesh=None) -> tuple[TrainState, list]:
    """The TrainState on ``meta`` tensors (it allocates nothing) and the
    parameters' logical axes (``transformer.param_axes``). The shapes are
    the reference's global ones: residuals ``(P, *shape)`` on either
    route (a rank of the process-group route holds one row)."""
    params = T.init_lm(model.cfg, "meta", None, trainable=True)
    leaves = list(params.parameters())
    ef = {}
    if tcfg is not None and tcfg.dcn_compression == "topk_ef":
        ef = _ef_zeros(leaves, resolve_pods(tcfg, mesh))
    state = TrainState(params=params, opt=adamw_init(leaves), step=0, ef=ef)
    return state, T.param_axes(params, model.cfg)


def state_axes(axes: list, tcfg: TrainConfig | None = None) -> TrainState:
    """Logical axes matching TrainState (mu / nu mirror the params; the
    residuals are whole rows behind a leading per-pod ``dcn_pod`` dim:
    compression takes each leaf whole)."""
    ef_axes: Any = {}
    if tcfg is not None and tcfg.dcn_compression == "topk_ef":
        ef_axes = [("dcn_pod",) + (None,) * len(a) for a in axes]
    return TrainState(params=axes, opt={"mu": axes, "nu": axes, "step": ()},
                      step=(), ef=ef_axes)


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


def _split(batch: dict, n: int, what: str) -> list[dict]:
    """``n`` equal slices of the batch along its leading dim, in order."""
    b = batch["tokens"].shape[0]
    if b % n:
        raise ValueError(f"batch {b} is not a multiple of {what} {n}")
    m = b // n
    return [{k: v[i * m:(i + 1) * m] for k, v in batch.items()}
            for i in range(n)]


def _group(ts: list) -> torch.Tensor:
    """A reference leaf from its parameters' tensors: the one tensor, or
    the layers' tensors stacked on a leading layer dim."""
    return ts[0] if len(ts) == 1 else torch.stack(ts)


def _ungroup(t: torch.Tensor, n: int) -> list:
    return [t] if n == 1 else list(t.unbind(0))


def _tree_bytes(leaves: list, groups: list, method: str,
                frac: float) -> int:
    """``tree_wire_bytes`` of the reference's tree: one leaf a group."""
    return sum(leaf_wire_bytes(sum(leaves[j].numel() for j in idx) or 1,
                               method, frac) for idx in groups)


def make_train_step(model: Model, tcfg: TrainConfig,
                    mesh=None) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    The function carries ``dcn_route``, the reduction it was built for:
    ``"global"``, ``"emulated"`` or ``"shard_map"`` (the process-group
    route), and ``dcn_pods``. ``mesh`` (default: the installed one) is a
    ``DeviceMesh`` or a ``{name: size}`` mapping; a mapping decides the
    route but carries no process group, so a step on the process-group
    route needs a ``DeviceMesh``.

    The compressors see the reference's tree (``tree_leaf_groups``): a
    stacked layer leaf is compressed whole (one int8 scale, one top-k
    over all its layers), as in the reference, and its send and residual
    are split back onto the layers' parameters."""
    if tcfg.dcn_compression not in DCN_METHODS:
        raise ValueError(f"unknown dcn_compression: {tcfg.dcn_compression}")
    if tcfg.grad_compression not in ("none", "int8", "topk"):
        raise ValueError(
            f"unknown grad_compression: {tcfg.grad_compression}")
    mesh = mesh if mesh is not None else get_mesh()
    route, pods = _route(tcfg, mesh)
    mb = tcfg.microbatches
    method, frac = tcfg.dcn_compression, tcfg.dcn_topk_frac

    def loss_fn(params: LM, batch):
        tree = _cast_bf16(params) if tcfg.cast_params_bf16 else params
        return model.loss(tree, batch, remat=tcfg.remat)

    def value_and_grad(params: LM, batch):
        leaves = list(params.parameters())
        with SH.mesh_context():
            loss = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        return SH.full_value(loss.detach()), list(grads)

    def compute_grads(params: LM, batch):
        """Pod-local (or global-route) grads: one backward pass, or the
        microbatch accumulation when ``microbatches > 1``."""
        if mb <= 1:
            return value_and_grad(params, batch)
        loss = torch.zeros((), device=model.device)
        grads = [torch.zeros_like(p, dtype=torch.float32)
                 for p in params.parameters()]
        for part in _split(batch, mb, "microbatches"):
            l, g = value_and_grad(params, part)
            loss = loss + l
            for acc, gi in zip(grads, g):
                acc.add_(gi)
        inv = 1.0 / mb
        return loss * inv, [g.mul_(inv) for g in grads]

    def check_ef(ef, rows: int):
        if ef and any(e.shape[0] != rows for e in ef):
            raise ValueError(
                f"TrainState.ef has {ef[0].shape[0]} rows a leaf; the "
                f"{route} route over {pods} pods keeps {rows} (build the "
                f"state with init_train_state(..., tcfg, mesh))")

    def send_groups(groups: list) -> list:
        """The groups to compress: the reference's leaves, or, when the
        send is the identity, each parameter alone (no stacked copy)."""
        if method == "none":
            return [[j] for idx in groups for j in idx]
        return groups

    def pod_slices(batch) -> list[dict]:
        """The pod slices of the step's global batch (whole values: a
        batch placed on the mesh is gathered first)."""
        return _split({k: SH.full_value(v) for k, v in batch.items()}, pods,
                      "dcn_pods")

    def hier_grads_emulated(params: LM, batch, ef, key: int, groups):
        """Each pod slice's grads, sent and folded in pod order, leaf by
        leaf (one pod's grads and one leaf's send live at a time); the
        residual rows are updated in place."""
        check_ef(ef, pods)
        ef = [SH.local_value(e) for e in ef]
        leaves = list(params.parameters())
        loss = torch.zeros((), device=model.device)
        # the fold, placed as the parameters (one whole send at a time)
        acc = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
        for p, part in enumerate(pod_slices(batch)):
            l, g = compute_grads(params, part)
            pod_key = fold_in(key, p)
            for i, idx in enumerate(send_groups(groups)):
                e = _group([ef[j][p] for j in idx]) if ef else None
                sent, new_e = dcn_send_leaf(
                    _group([SH.full_value(g[j]) for j in idx]), e, i, method,
                    frac, pod_key)
                sents = _ungroup(sent, len(idx))
                kept = _ungroup(new_e, len(idx)) if ef else [None] * len(idx)
                for j, s, ne in zip(idx, sents, kept):
                    g[j] = None
                    SH.local_value(acc[j]).add_(
                        SH.local_value(SH.place_like(s, leaves[j])))
                    if ef:
                        ef[j][p].copy_(ne)
                del sent, new_e, e, sents, kept
            loss = loss + l
        inv = 1.0 / pods
        for a in acc:
            SH.local_value(a).mul_(inv)
        return loss * inv, acc

    def hier_grads_process_group(params: LM, batch, ef, key: int, groups):
        """This rank's pod slice (on a sharded model, computed by the pod's
        ranks), its compressed grads summed over the ``pod`` group; the
        rank's residual row updated in place."""
        if isinstance(mesh, Mapping):
            raise ValueError(
                f"the process-group route over {pods} pods needs a "
                f"DeviceMesh; the mapping {dict(mesh)} carries no process "
                f"group")
        check_ef(ef, 1)
        ef = [SH.local_value(e) for e in ef]
        leaves = list(params.parameters())
        part = pod_slices(batch)[mesh.get_local_rank("pod")]
        with SH.rules_override(batch=SH.without_axis(SH.get_rules().batch,
                                                     "pod")):
            l, g = compute_grads(params, part)
        groups = send_groups(groups)
        inv = 1.0 / pods
        grads = [None] * len(leaves)

        def whole(idx):
            t = _group([SH.full_value(g[j]) for j in idx])[None]
            for j in idx:
                g[j] = None
            return t

        def take(i, red, new_e):
            """Group ``i``'s sum scaled and placed as its parameters, and
            its residual rows kept, as soon as it is summed (one whole
            leaf at a time)."""
            idx = groups[i]
            for j, r in zip(idx, _ungroup(red, len(idx))):
                grads[j] = SH.place_like(r.mul_(inv), leaves[j])
            if new_e is not None:
                for j, ne in zip(idx, _ungroup(new_e[0], len(idx))):
                    ef[j][0].copy_(ne)

        dcn_allreduce_tree(
            (whole(idx) for idx in groups),
            (_group([ef[j][0] for j in idx])[None] for idx in groups)
            if ef else {}, mesh, "pod", method, frac, key, out=take)
        loss = cross_pod_allreduce(l, mesh, "pod", "none")
        return loss * inv, grads

    hier_grads = (hier_grads_process_group if route == "shard_map"
                  else hier_grads_emulated)

    def legacy_compress(grads: list, groups: list, key: int) -> list:
        """The legacy ``grad_compression`` of the reduced grads, on the
        reference's leaves."""
        out = [None] * len(grads)
        for i, idx in enumerate(groups):
            c, _ = dcn_send_leaf(_group([grads[j] for j in idx]), None, i,
                                 tcfg.grad_compression, key=key)
            for j, t in zip(idx, _ungroup(c, len(idx))):
                out[j] = t
        return out

    def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        leaves = list(state.params.parameters())
        groups = T.tree_leaf_groups(state.params)
        if route == "global":
            loss, grads = compute_grads(state.params, batch)
            dcn_bytes = 0
        else:
            key = per_step_key(tcfg.seed, state.step)
            loss, grads = hier_grads(state.params, batch, state.ef, key,
                                     groups)
            dcn_bytes = _tree_bytes(leaves, groups, method, frac)
        raw_bytes = _tree_bytes(leaves, groups, "none", frac)
        if tcfg.grad_compression != "none":
            # a stream apart from the pods' keys
            grads = legacy_compress(grads, groups, fold_in(
                per_step_key(tcfg.seed, state.step), LEGACY_STREAM))
        _, opt, metrics = adamw_update(tcfg.optimizer, leaves, grads,
                                       state.opt)
        metrics = dict(metrics, loss=loss,
                       dcn_bytes=float(np.float32(dcn_bytes)),
                       dcn_raw_bytes=float(np.float32(raw_bytes)))
        return TrainState(params=state.params, opt=opt,
                          step=state.step + 1, ef=state.ef), metrics

    train_step.dcn_route = route
    train_step.dcn_pods = pods
    return train_step
