"""Roofline ceilings of the card the port runs on.

Counterpart of ``repro.launch.roofline``'s ``HardwareProfile`` and
``active_profile``: the ceilings roofline terms are priced against. The
defaults are the H100 SXM's published dense figures (NVIDIA's data sheet):
989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s float32 outside them,
3.35 TB/s HBM3 and 450 GB/s of NVLink each way. Each field holds one
precision. When a tuning table measured on the local device kind is
active (``REPRO_TORCH_TUNING_TABLE`` or
``repro_torch.tune.set_active_table``), its measured ceilings replace the
float32 and memory figures (``repro_torch.tune.microbench`` times float32
matmuls with TF32 off); the microbench measures no bf16 rate and, on one
card, no NVLink, so those figures stay the published ones. The
reference's HLO cost model (``dryrun``) is not ported yet.
"""

from __future__ import annotations

import dataclasses

from repro_torch.tune.table import measured_ceilings

PEAK_FLOPS = 989e12    # bf16 dense, tensor cores
PEAK_FLOPS_FP32 = 67e12  # float32, outside the tensor cores
HBM_BW = 3.35e12       # bytes/s, HBM3
LINK_BW = 450e9        # bytes/s, NVLink, each way


@dataclasses.dataclass(frozen=True)
class HardwareProfile:
    """Per-card roofline ceilings: measured, or the H100 SXM defaults."""

    peak_flops: float = PEAK_FLOPS
    peak_flops_fp32: float = PEAK_FLOPS_FP32
    hbm_bw: float = HBM_BW
    link_bw: float = LINK_BW
    source: str = "default:h100-sxm"


def active_profile(device=None) -> HardwareProfile:
    """The profile roofline terms are priced against on ``device``: the
    active table's measured float32 and memory ceilings when it was
    measured on this device kind, else the published H100 SXM figures."""
    ceil = measured_ceilings(device)
    if ceil and ceil.get("peak_flops_fp32") and ceil.get("hbm_bw"):
        return HardwareProfile(peak_flops_fp32=float(ceil["peak_flops_fp32"]),
                               hbm_bw=float(ceil["hbm_bw"]),
                               source="measured")
    return HardwareProfile()
