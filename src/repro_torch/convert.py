"""Carries arrays of the JAX package across to the port, as numpy.

``jax.random`` draws cannot be reproduced by ``torch.Generator``s, so
parity runs hand the reference's codebooks, banks and LM parameters to
the port through these functions; both packages then compute on the same
values. Packed uint32 words become their int32 bit-views (the port's
storage convention); int8 hypervectors stay int8; the PCM array's
programmed weights stay float32 (with their array and device
configurations, as an ``IMCArrayState``); LM matrices take the model's
dtype where the reference casts them to it (the leaves it computes with
in float32 stay float32), or float32 with gradients for training
(``train_state_from_numpy`` carries the reference's whole ``TrainState``
across). A tuning table does not cross: it is keyed by device kind and
names the kernels' own launch knobs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.imc.array import ArrayConfig, IMCArrayState
from repro_torch.core.imc.device import DeviceConfig
from repro_torch.device import resolve_device
from repro_torch.serve.db_search import QueryEncoder


def bank_rows_from_numpy(rows, device: str | torch.device = "cuda"
                         ) -> torch.Tensor:
    """uint32 packed words -> int32 bit-view; int8 HVs -> int8."""
    a = np.ascontiguousarray(np.asarray(rows))
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype != np.int8:
        raise ValueError(f"expected uint32 words or int8 HVs, got {a.dtype}")
    return torch.from_numpy(a.copy()).to(resolve_device(device))


def encoder_from_numpy(id_hvs, level_hvs,
                       device: str | torch.device = "cuda"
                       ) -> QueryEncoder:
    """A :class:`QueryEncoder` holding the given bipolar int8 codebooks."""
    return QueryEncoder(id_hvs=bank_rows_from_numpy(id_hvs, device),
                        level_hvs=bank_rows_from_numpy(level_hvs, device))


def imc_weights_from_numpy(weights, device: str | torch.device = "cuda"
                           ) -> torch.Tensor:
    """The reference's programmed PCM weights (``IMCArrayState.weights``,
    (R, Dp) noisy conductance-domain values) as a contiguous float32
    tensor for ``imc_mvm``."""
    a = np.asarray(weights)
    if a.ndim != 2 or not np.issubdtype(a.dtype, np.floating):
        raise ValueError(f"expected (R, Dp) float weights, got {a.dtype} "
                         f"{a.shape}")
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C")).to(
        resolve_device(device))


def imc_state_from_numpy(weights, array_cfg, device_cfg,
                         device: str | torch.device = "cuda"):
    """The reference's programmed bank (``IMCArrayState``'s weights and its
    array and device configurations, any objects with the same fields) as
    the port's :class:`~repro_torch.core.imc.array.IMCArrayState`."""
    return IMCArrayState(
        weights=imc_weights_from_numpy(weights, device),
        cfg=ArrayConfig(**dataclasses.asdict(array_cfg)),
        device=DeviceConfig(**dataclasses.asdict(device_cfg)))


def codebooks_from_numpy(id_hvs, level_hvs,
                         device: str | torch.device = "cuda"
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's bipolar int8 codebooks ((F, D) ID HVs, (m, D) level
    HVs), in the form ``make_codebooks`` returns them."""
    return (bank_rows_from_numpy(id_hvs, device),
            bank_rows_from_numpy(level_hvs, device))


# each block kind's parameter groups, in the order ``init_block`` makes
# them, and its loose leaves
_GROUPS = {
    "attn_ffn": ("norm1", "attn", "norm2", "ffn"),
    "attn_moe": ("norm1", "attn", "norm2", "moe"),
    "hybrid": ("norm1", "attn", "norm2", "ffn", "mamba"),
    "mlstm": ("norm1", "mix"),
    "slstm": ("norm1", "mix"),
    "enc": ("norm1", "attn", "norm2", "ffn"),
    "dec_cross": ("norm1", "attn", "norm_x", "xattn", "norm2", "ffn"),
}
_LEAVES = {"hybrid": ("alpha",)}


def _stays_float32(kind: str, group: str, name: str) -> bool:
    """Whether the serving store keeps a leaf in float32: norm scales and
    biases, the MoE router, Mamba's ``a_log`` / ``d_skip`` / ``dt_bias``,
    mLSTM's q / k / v projections and gates, every sLSTM leaf."""
    if group.startswith("norm") or (group, name) == ("moe", "router"):
        return True
    from repro_torch.models import recurrent as R

    if group == "mamba":
        return name in R.MAMBA_FLOAT32
    if group == "mix":
        return kind == "slstm" or name in R.MLSTM_FLOAT32
    return False


def lm_params_from_numpy(params, cfg, device: str | torch.device = "cuda",
                         dtype: torch.dtype | None = None,
                         trainable: bool = False, mesh=None):
    """The JAX package's LM parameter tree (numpy leaves, as
    ``repro.models.transformer.init_lm`` makes it: ``layers`` stacked on
    a leading ``layer`` axis, or for the ``ssm`` family a list
    ``blocks`` of unlike blocks) as the port's
    :class:`~repro_torch.models.transformer.LM`.

    A dense layer holds ``norm1``, ``attn``, ``norm2`` and ``ffn``; an MoE
    layer ``moe`` in place of ``ffn`` (``router``, the 3-D expert leaves
    ``w_gate`` / ``w_up`` / ``w_down`` and the ``shared_*`` matrices); a
    hybrid layer adds ``mamba`` and the leaf ``alpha``; an xLSTM block
    holds ``norm1`` and ``mix`` (an mLSTM or sLSTM); an encoder-decoder's
    ``dec_cross`` layer holds ``norm1``, ``attn``, ``norm_x``, ``xattn``,
    ``norm2`` and ``ffn``, and its ``enc_layers`` (stacked like
    ``layers``) and ``enc_norm`` come across too. Matrices, biases,
    ``embed`` and ``lm_head`` are stored in ``dtype`` (default
    ``cfg.dtype``) where the reference casts them to that dtype before
    every use, so the values are the same. The leaves it computes with in
    float32 stay float32: norm scales and biases, the MoE router,
    ``alpha``, and the recurrent leaves of ``_stays_float32``. With
    ``trainable`` every leaf is the reference's float32 master value
    (``cfg.param_dtype``) and carries gradients, as training needs. On a
    ``DeviceMesh`` (``mesh``) each leaf is placed by ``param_axes``, a
    DTensor holding this rank's block."""
    from torch import nn

    from repro_torch.dist.sharding import distribute_tree

    from repro_torch.models import transformer as T
    from repro_torch.models.layers import _dtype, _leaf_dtype, _param

    dev = resolve_device(device)
    dt = _leaf_dtype(cfg, True) if trainable else dtype or _dtype(cfg)
    kinds = [T.decoder_kind(cfg, i) for i in range(cfg.num_layers)]
    stack = T.stack_name(cfg)

    def tensor(a, f32=False):
        t = torch.from_numpy(np.array(a, dtype=np.float32))
        return t.to(device=dev, dtype=torch.float32 if f32 else dt)

    def block(kind, tree, take):
        want = set(_GROUPS[kind] + _LEAVES.get(kind, ()))
        if set(tree) != want:
            raise ValueError(f"expected the {stack} of an {kind} block "
                             f"({sorted(want)}), got {sorted(tree)}")
        groups = {g: nn.ParameterDict({
            name: _param(tensor(take(a), _stays_float32(kind, g, name)),
                         trainable)
            for name, a in tree[g].items()}) for g in _GROUPS[kind]}
        leaves = {name: _param(tensor(take(tree[name]), True), trainable)
                  for name in _LEAVES.get(kind, ())}
        return T.Block(groups, **leaves)

    if stack not in params:
        raise ValueError(f"expected {stack!r} for the {cfg.family} family, "
                         f"got {sorted(params)}")
    tree = params[stack]
    if stack == "blocks":
        if len(tree) != cfg.num_layers:
            raise ValueError(f"expected {cfg.num_layers} blocks, got "
                             f"{len(tree)}")
        blocks = [block(kind, bt, lambda a: a)
                  for kind, bt in zip(kinds, tree)]
    else:
        blocks = [block(kinds[i], tree, lambda a, i=i: a[i])
                  for i in range(cfg.num_layers)]

    def norm(tree):
        return nn.ParameterDict({name: _param(tensor(a, True), trainable)
                                 for name, a in tree.items()})

    enc = enc_norm = None
    if cfg.is_encoder_decoder:
        enc = [block("enc", params["enc_layers"], lambda a, i=i: a[i])
               for i in range(cfg.num_encoder_layers)]
        enc_norm = norm(params["enc_norm"])
    head = params.get("lm_head")
    lm = T.LM(tensor(params["embed"]), blocks, norm(params["final_norm"]),
              None if head is None else tensor(head), trainable, stack, enc,
              enc_norm)
    return distribute_tree(lm, T.param_axes(lm, cfg), mesh)


def _pod_slice(tree, p: int):
    """The numpy tree with every leaf's leading (per-pod) dim indexed at
    ``p``."""
    if isinstance(tree, dict):
        return {k: _pod_slice(v, p) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_pod_slice(v, p) for v in tree]
    return np.asarray(tree)[p]


def train_state_from_numpy(params, mu, nu, step, cfg,
                           device: str | torch.device = "cuda", ef=None,
                           mesh=None):
    """The reference's ``TrainState`` (its ``params``, ``opt["mu"]``,
    ``opt["nu"]`` as numpy trees of the same layout, ``step`` and, for
    ``topk_ef``, its ``ef`` tree of ``(P, *shape)`` leaves) as the port's
    :class:`~repro_torch.train.train_step.TrainState`: float32 trainable
    parameters, and float32 moments and ``(P, *shape)`` residuals in the
    order of ``params.parameters()`` (each pod's slice mapped as the
    parameters are); on a ``DeviceMesh`` placed by ``state_axes``."""
    from repro_torch.dist.sharding import distribute_tree
    from repro_torch.models.transformer import param_axes
    from repro_torch.train.train_step import TrainState, state_axes

    lm = lm_params_from_numpy(params, cfg, device, trainable=True)
    dev = resolve_device(device)

    def leaves(tree):
        m = lm_params_from_numpy(tree, cfg, "cpu", trainable=True)
        return [t.detach().to(dev) for t in m.parameters()]

    state_ef = {}
    if ef is not None and len(ef):
        pods = len(np.asarray(ef["embed"]))
        rows = [leaves(_pod_slice(ef, p)) for p in range(pods)]
        state_ef = [torch.stack(per_leaf) for per_leaf in zip(*rows)]
    step = int(step)
    state = TrainState(params=lm, opt={"mu": leaves(mu), "nu": leaves(nu),
                                       "step": step}, step=step, ef=state_ef)
    return distribute_tree(state, state_axes(param_axes(lm, cfg)), mesh)
