"""ID-level hyperdimensional encoding (SpecPCM Eq. 1), in PyTorch.

    HV = sign( sum_i  LV[level_i] * ID_i ),   sign(0) = -1

Counterpart of ``repro.core.hd.encoding``. Codebooks are drawn from a
``torch.Generator`` and so differ from the reference's threefry draws;
they keep the reference's invariants instead: both codebooks are
bipolar, and ``LV_k`` differs from ``LV_0`` in exactly
``k * (D // 2) // (m - 1)`` positions.

The encoders sum only over present bins (level > 0): absent bins add
exactly 0 in the reference, so the integer sums, and hence the signs,
are the same.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class HDEncoderConfig:
    """dim: HD dimensionality D; num_features: m/z bins F; num_levels: m;
    seed: codebook seed."""

    dim: int = 2048
    num_features: int = 1024
    num_levels: int = 32
    seed: int = 0

    def __post_init__(self):
        if self.dim <= 0 or self.num_features <= 0 or self.num_levels < 2:
            raise ValueError(f"invalid HDEncoderConfig: {self}")


def make_codebooks(cfg: HDEncoderConfig, device: str | torch.device = "cuda"
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(id_hvs (F, D), level_hvs (m, D)) bipolar int8 on ``device``.

    LV_0 is random; level k flips the first ``k * (D // 2) // (m - 1)``
    positions of a random permutation of LV_0, so LV_0 and LV_{m-1}
    differ in D/2 positions and similarity decays linearly with level
    distance. Drawn on a CPU generator seeded with ``cfg.seed``, so the
    codebooks do not depend on the device.
    """
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(cfg.seed)
    D, m = cfg.dim, cfg.num_levels
    id_hvs = (torch.randint(0, 2, (cfg.num_features, D), generator=g,
                            dtype=torch.int8) * 2 - 1)
    base = torch.randint(0, 2, (D,), generator=g, dtype=torch.int8) * 2 - 1
    perm = torch.randperm(D, generator=g)
    thresholds = torch.arange(m, dtype=torch.int64) * (D // 2) // (m - 1)
    rank = torch.empty(D, dtype=torch.int64)
    rank[perm] = torch.arange(D, dtype=torch.int64)
    flip = rank[None, :] < thresholds[:, None]
    level_hvs = torch.where(flip, -base[None, :], base[None, :])
    return id_hvs.to(dev), level_hvs.to(torch.int8).to(dev)


def quantize_levels(values: torch.Tensor, num_levels: int) -> torch.Tensor:
    """Feature values in [0, 1] -> int32 levels; 0 = absent bin, present
    peaks map to 1..m-1 (float32 arithmetic, as in the reference)."""
    v = values.to(torch.float32).clamp(0.0, 1.0)
    present = v > 1e-6
    lvl = 1 + torch.clamp_max((v * (num_levels - 1)).to(torch.int32),
                              num_levels - 2)
    return torch.where(present, lvl, torch.zeros_like(lvl))


def _bound_products(id_hvs: torch.Tensor, level_hvs: torch.Tensor
                    ) -> torch.Tensor:
    """(F*m + 1, D) int8 table of ``ID[f] * LV[l]`` at row ``f*m + l``,
    plus a final all-zero row that padding indices point at."""
    F, D = id_hvs.shape
    m = level_hvs.shape[0]
    prod = id_hvs[:, None, :] * level_hvs[None, :, :]        # (F, m, D)
    zero = torch.zeros((1, D), dtype=torch.int8, device=id_hvs.device)
    return torch.cat([prod.reshape(F * m, D), zero])


def _encode_rows(levels: torch.Tensor, table: torch.Tensor, m: int,
                 chunk_elems: int, width: int | None = None) -> torch.Tensor:
    """Sign of the Eq. 1 sum for (B, F) levels, over present bins only,
    ``chunk_elems`` bounding each gathered (rows, present, D) block.
    ``width`` is at least the most present bins of a row (read from the
    device when None: a host synchronization)."""
    B, F = levels.shape
    D = table.shape[1]
    pad_row = table.shape[0] - 1
    out = torch.empty((B, D), dtype=torch.int8, device=levels.device)
    if B == 0:
        return out
    present_all = levels > 0
    if width is None:
        width = int(present_all.sum(dim=1).max())
    width = max(1, min(int(width), F))
    step = max(1, chunk_elems // (width * D + F * 8))
    f_idx = torch.arange(F, device=levels.device, dtype=torch.int64)
    for r0 in range(0, B, step):
        present = present_all[r0:r0 + step]
        idx = f_idx[None, :] * m + levels[r0:r0 + step].to(
            torch.int64).clamp(0, m - 1)
        idx = torch.where(present, idx, torch.full_like(idx, pad_row))
        # present bins first; the padding slots point at the zero row
        order = torch.argsort((~present).to(torch.int8), dim=1,
                              stable=True)[:, :width]
        idx = torch.gather(idx, 1, order)
        acc = table[idx].sum(dim=1, dtype=torch.int32)        # (rows, D)
        out[r0:r0 + step] = torch.where(acc > 0, 1, -1).to(torch.int8)
    return out


def encode_levels_batch(levels: torch.Tensor, id_hvs: torch.Tensor,
                        level_hvs: torch.Tensor, *,
                        chunk_elems: int = 1 << 28,
                        width: int | None = None) -> torch.Tensor:
    """Eq. 1 from already quantized (B, F) levels -> bipolar (B, D) int8.

    Level 0 is the absent-peak sentinel and contributes nothing; sign
    ties (sum == 0) resolve to -1. Levels past ``m - 1`` read the last
    level HV, as the reference's clamped gather does.

    width: the most present bins (levels > 0) of any row, when the caller
    knows it from the host copy of the levels; the encode then reads
    nothing back from the device. Any width at or above that gives the
    same result.
    """
    levels = levels.to(torch.int32)
    if levels.ndim != 2 or levels.shape[1] != id_hvs.shape[0]:
        raise ValueError(f"levels {tuple(levels.shape)} vs id_hvs "
                         f"{tuple(id_hvs.shape)}")
    table = _bound_products(id_hvs.to(torch.int8), level_hvs.to(torch.int8))
    return _encode_rows(levels, table, int(level_hvs.shape[0]), chunk_elems,
                        width)


def encode_batch_reference(features: torch.Tensor, id_hvs: torch.Tensor,
                           level_hvs: torch.Tensor) -> torch.Tensor:
    """Eq. 1 oracle on (B, F) features in [0, 1] -> bipolar (B, D) int8,
    the reference's name for what :func:`encode_batch` computes."""
    return encode_batch(features, id_hvs, level_hvs)


def encode_batch(features: torch.Tensor, id_hvs: torch.Tensor,
                 level_hvs: torch.Tensor, *, chunk_elems: int = 1 << 28
                 ) -> torch.Tensor:
    """Memory-bounded encoder for whole banks: quantizes and encodes in
    row chunks, so a 10^6-row bank never materialises (B, F, D); each
    chunk gathers at most ``chunk_elems`` int8 products."""
    levels = quantize_levels(features, int(level_hvs.shape[0]))
    return encode_levels_batch(levels, id_hvs, level_hvs,
                               chunk_elems=chunk_elems)
