"""Dimension packing (SpecPCM §III.B), in PyTorch.

A bipolar HV of length D is compressed to D/n by summing n adjacent
elements; each packed value lies in [-n, n] and is stored in one n-bit
MLC cell. ``bits_per_cell=1`` is the identity, which the exact DB-search
path uses. Counterpart of ``repro.core.hd.packing``.
"""

from __future__ import annotations

import torch


def pack_dimensions(hv: torch.Tensor, bits_per_cell: int) -> torch.Tensor:
    """(..., D) bipolar -> (..., D // n) int8 block sums in [-n, n]."""
    n = int(bits_per_cell)
    if n < 1:
        raise ValueError(f"bits_per_cell must be >= 1, got {n}")
    if n == 1:
        return hv.to(torch.int8)
    *lead, D = hv.shape
    if D % n != 0:
        raise ValueError(f"D={D} not divisible by bits_per_cell={n}")
    # summed in int8 (|sum| <= n): no wider copy of a whole bank's HVs
    return hv.to(torch.int8).reshape(*lead, D // n, n).sum(
        dim=-1, dtype=torch.int8)


def unpack_dimensions(packed: torch.Tensor, bits_per_cell: int, dim: int
                      ) -> torch.Tensor:
    """Approximate inverse of :func:`pack_dimensions` (lossy for n > 1):
    within each block the first ceil((n + s) / 2) entries are +1."""
    n = int(bits_per_cell)
    if n == 1:
        return packed.to(torch.int8)
    *lead, Dp = packed.shape
    if Dp * n != dim:
        raise ValueError(f"packed dim {Dp} * n {n} != dim {dim}")
    s = packed.to(torch.int32)
    num_pos = torch.clamp(torch.div(n + s, 2, rounding_mode="floor")
                          + torch.remainder(n + s, 2), 0, n)
    idx = torch.arange(n, dtype=torch.int32, device=packed.device)
    block = torch.where(idx < num_pos[..., None], 1, -1).to(torch.int8)
    return block.reshape(*lead, dim)


def packed_levels(bits_per_cell: int) -> int:
    """Distinct stored values of n-bit packing: 2n + 1 levels in [-n, n],
    held by a 2T2R cell pair as a signed difference (n = 3 -> 7)."""
    return 2 * int(bits_per_cell) + 1
