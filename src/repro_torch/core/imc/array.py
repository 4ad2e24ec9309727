"""IMC array model (SpecPCM §III.C, Table 1), in PyTorch.

Counterpart of ``repro.core.imc.array``. A bank is a 128x128 array of
2T2R cell pairs; each pair stores one signed packed level in [-n, n]. An
HV of packed length D' is striped across ceil(D'/128) arrays at the same
row index. MVM drives the packed query through 3-bit DACs, all word lines
fire, and each array's analog partial sum is digitized by a 6-bit flash
ADC; the digital side accumulates the quantized partials.

:func:`imc_mvm` and :func:`imc_mvm_reference` compute that chain through
``repro_torch.kernels.imc_mvm.imc_mvm``: on CUDA tensors the hand-written
kernel (``csrc/imc_mvm.cu``), on CPU tensors its plain version. The
kernel takes each tile's partial sum as a chain of fused multiply-adds,
where the reference sums the tile in XLA's order and rounds ``code * lsb``
before summing, so float weights agree with the reference to rtol 1e-5 /
atol 1e-3 and integer-valued weights bit for bit.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.imc.device import DeviceConfig, apply_write_noise


@dataclasses.dataclass(frozen=True)
class ArrayConfig:
    """ISA-visible IMC array parameters (defaults = paper Table 1)."""
    rows: int = 128
    cols: int = 128
    dac_bits: int = 3
    adc_bits: int = 6
    bits_per_cell: int = 3
    full_scale: float | None = None  # override ADC full scale (tests/ideal)

    @property
    def dac_levels(self) -> int:
        # signed DAC: levels in [-(2^(b-1)-1), 2^(b-1)-1]; 3-bit -> [-3, 3]
        return 2 ** (self.dac_bits - 1) - 1

    @property
    def adc_levels(self) -> int:
        # signed flash ADC with 2^b - 1 comparators -> [-(2^(b-1)-1), ...]
        return 2 ** (self.adc_bits - 1) - 1


@dataclasses.dataclass
class IMCArrayState:
    """Programmed bank contents: (rows, packed_dim) float32 noisy
    conductance-domain weights, logically striped over
    ceil(packed_dim / cols) arrays; ``device`` is the PCM device
    configuration (the reference's field name), not a torch device."""
    weights: torch.Tensor
    cfg: ArrayConfig
    device: DeviceConfig


def dac_quantize(x: torch.Tensor, cfg: ArrayConfig) -> torch.Tensor:
    """Round (half to even) and clamp the packed query to the DAC range;
    exact for 3-bit DACs on 3-bit packing ([-3, 3] both)."""
    lim = cfg.dac_levels
    return torch.clamp(torch.round(x.to(torch.float32)), -lim, lim)


def adc_quantize(partial: torch.Tensor, cfg: ArrayConfig,
                 full_scale: float) -> torch.Tensor:
    """Flash-ADC transfer function for one array's analog partial sum:
    2^b - 1 uniform codes over [-full_scale, +full_scale], saturating."""
    lvl = cfg.adc_levels
    # a float32 tensor on the operand's device: a CPU scalar divisor may
    # become a multiply by its reciprocal
    lsb = torch.tensor(full_scale / lvl, dtype=torch.float32,
                       device=partial.device)
    code = torch.clamp(torch.round(partial / lsb), -lvl, lvl)
    return code * lsb


def default_full_scale(cfg: ArrayConfig) -> float:
    """ADC full scale: 4 sigma of a 128-row partial sum of random bipolar
    products, unless ``cfg.full_scale`` overrides it."""
    n = cfg.bits_per_cell
    d = cfg.dac_levels
    if cfg.full_scale is not None:
        return cfg.full_scale
    per_prod_std = (n * d) / 3.0
    return 4.0 * per_prod_std * (cfg.cols ** 0.5)


def program_hvs(generator: torch.Generator, packed_hvs: torch.Tensor,
                cfg: ArrayConfig, device: DeviceConfig) -> IMCArrayState:
    """Program packed HVs into the bank with write noise drawn from
    ``generator`` (write-verify folded into the device sigma)."""
    noisy = apply_write_noise(generator, packed_hvs, device)
    return IMCArrayState(weights=noisy, cfg=cfg, device=device)


def imc_mvm(queries: torch.Tensor, state: IMCArrayState) -> torch.Tensor:
    """(Q, Dp) packed queries against the programmed bank -> (Q, R)
    float32 scores through the modeled analog chain."""
    return imc_mvm_reference(queries, state.weights, state.cfg)


def imc_mvm_reference(queries: torch.Tensor, weights: torch.Tensor,
                      cfg: ArrayConfig) -> torch.Tensor:
    """:func:`imc_mvm` over bare weights: the ``imc_mvm`` kernel (its plain
    version on CPU tensors) at the array's column count, DAC and ADC
    ranges and full scale. Queries are cast to float32; the weights must
    be a float32 array the kernel can read in place (contiguous, on a
    16-byte boundary), as :func:`program_hvs` makes them."""
    # imported here: the kernels import repro_torch.core.hd, whose package
    # imports this module
    from repro_torch.kernels.imc_mvm import imc_mvm as imc_mvm_kernel

    return imc_mvm_kernel(
        queries.to(torch.float32).contiguous(), weights,
        full_scale=default_full_scale(cfg), tile_cols=cfg.cols,
        dac_limit=cfg.dac_levels, adc_levels=cfg.adc_levels)
