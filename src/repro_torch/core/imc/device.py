"""PCM device models (SpecPCM §III.E, Table S1, Fig. 7), in PyTorch.

Counterpart of ``repro.core.imc.device``. Two superlattice PCM
technologies with the measured parameters of Table S1:

  * Sb2Te3/Ge4Sb6Te7 — low programming energy (1.12 pJ), 30 h retention at
    105C, on/off 150x. Used for *clustering* (write-intensive).
  * TiTe2/Ge4Sb6Te7  — 2.88 pJ programming, >1e5 h retention, lower error.
    Used for *DB search* (read-intensive, long retention).

Noise model (§S.B): a stored value W is read back as W * (1 + eta),
eta ~ N(0, sigma^2), with sigma shrinking with write-verify cycles along
the exponential-floor fit of Fig. 7:

    sigma(c) = sigma_floor + (sigma_0 - sigma_floor) * exp(-c / c_decay)

The tables, ``noise_sigma``, ``bit_error_rate`` and
``programming_energy_j`` are plain Python, copied so that the port stands
alone. ``apply_write_noise`` draws eta from a ``torch.Generator``: its
draws differ from the reference's threefry stream and keep its
invariants instead (zero weights stay zero; ``noisy / weights`` has mean
1 and standard deviation ``noise_sigma``).
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class PCMMaterial:
    name: str
    programming_current_ua: float
    programming_voltage_v: float
    programming_energy_pj: float
    retention_hours_105c: float
    low_resistance_kohm: float
    on_off_ratio: float
    # fitted noise curve (relative conductance std)
    sigma_0: float        # std with no write-verify
    sigma_floor: float    # asymptotic std with many write-verify cycles
    c_decay: float        # write-verify decay constant (cycles)
    endurance_cycles: float = 1e8


SB2TE3_GST = PCMMaterial(
    name="Sb2Te3/Ge4Sb6Te7",
    programming_current_ua=80.0,
    programming_voltage_v=0.7,
    programming_energy_pj=1.12,
    retention_hours_105c=30.0,
    low_resistance_kohm=30.0,
    on_off_ratio=150.0,
    sigma_0=0.26,
    sigma_floor=0.185,
    c_decay=2.2,
)

TITE2_GST = PCMMaterial(
    name="TiTe2/Ge4Sb6Te7",
    programming_current_ua=160.0,
    programming_voltage_v=0.9,
    programming_energy_pj=2.88,
    retention_hours_105c=1e5,
    low_resistance_kohm=10.0,
    on_off_ratio=100.0,
    sigma_0=0.22,
    sigma_floor=0.155,
    c_decay=2.2,
)

MATERIALS: dict[str, PCMMaterial] = {
    "sb2te3": SB2TE3_GST,
    "tite2": TITE2_GST,
}


@dataclasses.dataclass(frozen=True)
class DeviceConfig:
    """Per-deployment device knobs (ISA-visible)."""
    material: str = "tite2"          # key into MATERIALS
    bits_per_cell: int = 3           # MLC depth (1 = SLC)
    write_verify_cycles: int = 3     # Fig. 7 x-axis

    @property
    def pcm(self) -> PCMMaterial:
        return MATERIALS[self.material]


def noise_sigma(cfg: DeviceConfig) -> float:
    """Relative read-noise std after the configured write-verify cycles."""
    m = cfg.pcm
    c = float(cfg.write_verify_cycles)
    return m.sigma_floor + (m.sigma_0 - m.sigma_floor) * math.exp(-c / m.c_decay)


def bit_error_rate(cfg: DeviceConfig) -> float:
    """Analytic level-error probability for an n-bit packed cell.

    Stored levels s = sum of n Rademacher variables lie in [-n, n]; a level
    is misread when |eta * s| exceeds half a level spacing (0.5 on the
    integer scale; the zero level takes sigma * 1 as its reference
    magnitude). The Gaussian tail averaged over the binomial levels of
    random bipolar data gives the BER (Fig. 7's shape).
    """
    n = cfg.bits_per_cell
    sigma = noise_sigma(cfg)
    if sigma <= 0:
        return 0.0
    total = 0.0
    for k in range(n + 1):
        s = 2 * k - n
        p_level = math.comb(n, k) / (2.0**n)
        eff = sigma * 1.0 if s == 0 else sigma * abs(s)
        z = 0.5 / max(eff, 1e-12)
        p_err = math.erfc(z / math.sqrt(2.0))
        total += p_level * p_err
    return total


def apply_write_noise(generator: torch.Generator, weights: torch.Tensor,
                      cfg: DeviceConfig) -> torch.Tensor:
    """Program and read back ``weights`` on the configured device:
    float32 ``weights * (1 + sigma * N(0, 1))`` on the weights' device,
    with sigma = :func:`noise_sigma` and N drawn from ``generator`` (a
    generator on that device).

    Built in place (``randn``, then ``mul_``, ``add_``, ``mul_``), so the
    result is the only float32 array made: 6.35 GB for iPRG2012's 581,196
    packed rows of 2,731 cells. Each step rounds to float32 as the
    reference's ``normal * sigma``, ``1 + eta`` and ``weights * (...)``
    do.
    """
    sigma = noise_sigma(cfg)
    out = torch.randn(weights.shape, generator=generator,
                      dtype=torch.float32, device=weights.device)
    return out.mul_(sigma).add_(1.0).mul_(weights)


def programming_energy_j(cfg: DeviceConfig, num_cells: int) -> float:
    """Energy to program ``num_cells`` cell pairs, one full programming
    pulse per write-verify pass on top of the first."""
    pulses = 1 + cfg.write_verify_cycles
    return num_cells * cfg.pcm.programming_energy_pj * 1e-12 * pulses
