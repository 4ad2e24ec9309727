"""Carries arrays of the JAX package across to the port, as numpy.

``jax.random`` draws cannot be reproduced by ``torch.Generator``s, so
parity runs hand the reference's codebooks, banks and LM parameters to
the port through these functions; both packages then compute on the same
values. Packed uint32 words become their int32 bit-views (the port's
storage convention); int8 hypervectors stay int8; the PCM array's
programmed weights stay float32 (with their array and device
configurations, as an ``IMCArrayState``); LM matrices take the model's
dtype, or float32 with gradients for training (``train_state_from_numpy``
carries the reference's whole ``TrainState`` across). A tuning table does
not cross: it is keyed by device kind and names the kernels' own launch
knobs.
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


def lm_params_from_numpy(params, cfg, device: str | torch.device = "cuda",
                         dtype: torch.dtype | None = None,
                         trainable: bool = False):
    """The JAX package's LM parameter tree (numpy leaves, layers stacked on
    a leading ``layer`` axis, as ``repro.models.transformer.init_lm``
    makes it) as the port's :class:`~repro_torch.models.transformer.LM`.

    A dense layer holds ``norm1``, ``attn``, ``norm2`` and ``ffn``; an MoE
    layer ``moe`` in place of ``ffn`` (``router``, the 3-D expert leaves
    ``w_gate`` / ``w_up`` / ``w_down`` and the ``shared_*`` matrices).
    Matrices, biases, ``embed`` and ``lm_head`` are stored in ``dtype``
    (default ``cfg.dtype``): the reference casts each of them to that dtype
    before every use, so the values are the same. Norm scales and biases
    stay float32, as ``apply_norm`` computes in float32, and so does the
    MoE router, which the reference multiplies in float32 without a cast.
    With ``trainable`` every leaf is the reference's float32 master value
    (``cfg.param_dtype``) and carries gradients, as training needs."""
    from torch import nn

    from repro_torch.models import transformer as T
    from repro_torch.models.layers import _dtype, _leaf_dtype, _param

    dev = resolve_device(device)
    dt = _leaf_dtype(cfg, True) if trainable else dtype or _dtype(cfg)
    # raises for a family the port does not serve yet
    kind = T.block_kind(cfg)
    names = ("norm1", "attn", "norm2",
             "moe" if kind == "attn_moe" else "ffn")

    def tensor(a, f32=False):
        t = torch.from_numpy(np.array(a, dtype=np.float32))
        return t.to(device=dev, dtype=torch.float32 if f32 else dt)

    def group(g, i):
        return nn.ParameterDict({
            name: _param(tensor(a[i], g.startswith("norm") or (
                g, name) == ("moe", "router")), trainable)
            for name, a in layers[g].items()})

    layers = params["layers"]
    if set(layers) != set(names):
        raise ValueError(f"expected the layers of an {kind} block "
                         f"({sorted(names)}), got {sorted(layers)}")
    blocks = [nn.ModuleDict({g: group(g, i) for g in names})
              for i in range(cfg.num_layers)]
    final = nn.ParameterDict({name: _param(tensor(a, True), trainable)
                              for name, a in params["final_norm"].items()})
    head = params.get("lm_head")
    return T.LM(tensor(params["embed"]), blocks, final,
                None if head is None else tensor(head), trainable)


def train_state_from_numpy(params, mu, nu, step, cfg,
                           device: str | torch.device = "cuda"):
    """The reference's ``TrainState`` (its ``params``, ``opt["mu"]``,
    ``opt["nu"]`` as numpy trees of the same layout, and ``step``) as the
    port's :class:`~repro_torch.train.train_step.TrainState`: float32
    trainable parameters, and float32 moments in the order of
    ``params.parameters()``."""
    from repro_torch.train.train_step import TrainState

    lm = lm_params_from_numpy(params, cfg, device, trainable=True)
    dev = resolve_device(device)

    def moments(tree):
        m = lm_params_from_numpy(tree, cfg, "cpu", trainable=True)
        return [t.detach().to(dev) for t in m.parameters()]

    step = int(step)
    return TrainState(params=lm, opt={"mu": moments(mu), "nu": moments(nu),
                                      "step": step}, step=step)
