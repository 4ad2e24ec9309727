"""SpecPCM configuration and the encode-and-pack stage, in PyTorch.

Counterpart of ``repro.core.pipeline``'s ``SpecPCMConfig`` and
``encode_and_pack``; the end-to-end pipelines of that module are not
ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.hd.encoding import (
    HDEncoderConfig,
    encode_batch,
    make_codebooks,
)
from repro_torch.core.hd.packing import pack_dimensions


@dataclasses.dataclass(frozen=True)
class SpecPCMConfig:
    """Software-visible configuration (the ISA parameter block)."""
    hd_dim: int = 2048
    num_levels: int = 32
    mlc_bits: int = 3
    adc_bits: int = 6
    dac_bits: int = 3
    write_verify: int = 0
    material: str = "sb2te3"
    ideal: bool = False        # bypass analog non-idealities
    seed: int = 0


def encode_and_pack(spectra: torch.Tensor, cfg: SpecPCMConfig) -> torch.Tensor:
    """spectra (N, F) in [0, 1] -> packed HVs (N, D/n) int8, on the
    spectra's device, with the codebooks of ``cfg.seed``."""
    enc_cfg = HDEncoderConfig(dim=cfg.hd_dim, num_features=spectra.shape[1],
                              num_levels=cfg.num_levels, seed=cfg.seed)
    id_hvs, level_hvs = make_codebooks(enc_cfg, device=spectra.device)
    hvs = encode_batch(spectra, id_hvs, level_hvs)
    return pack_dimensions(hvs, cfg.mlc_bits)
