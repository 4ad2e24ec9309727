"""The benchmark's own inputs, made on the device from ``--seed``.

A rewritten copy of the port's synthetic spectra (``spectra/synthetic.py``)
with what the benchmark needs beside it: a library of peptide identities,
each observed ``per_identity`` times (template x intensity jitter, peak
dropout, chemical-noise peaks), its m/z-reversed decoys, a pool of query
spectra that are all new noisy instances of library identities (a share of
them modified: half the spectrum shifted and the precursor made heavier),
the HD codebooks of Eq. 1, and the precursor masses of every spectrum.

Everything is drawn with ``torch.Generator``s on the device, in a few large
calls. Each stream (templates, library noise, queries, codebooks, masses)
has a generator of its own, seeded from ``(seed, stream)``, so one seed
always gives the same inputs and the streams do not depend on each other.

Spectra leave this module quantized: int8 levels, 0 for an absent bin and
1..m-1 for a peak (the port's ``quantize_levels`` rule, float32 arithmetic).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

PHI = 0.6180339887498949
CHUNK_ROWS = 1 << 16

STREAMS = {"templates": 1, "library": 2, "queries": 3, "codebooks": 4,
           "masses": 5, "warmup": 6}


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one stream of one run."""
    state = np.random.SeedSequence([int(seed) & (2**64 - 1),
                                    STREAMS[stream]]).generate_state(2)
    return int((int(state[0]) << 32 | int(state[1])) & (2**63 - 1))


def generator(seed: int, stream: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed,
                                                                  stream))


@dataclasses.dataclass(frozen=True)
class SpectraSpec:
    """What a configuration's ``library`` block states."""

    identities: int
    per_identity: int
    num_bins: int
    peaks_per_peptide: int
    intensity_jitter: float
    dropout: float
    noise_peaks: int
    precursor_range: tuple[float, float]
    precursor_noise: float
    query_modification_rate: float
    modification_mass_range: tuple[float, float]
    modification_shift_bins: tuple[int, int]

    @classmethod
    def from_config(cls, lib: dict) -> "SpectraSpec":
        return cls(
            identities=int(lib["identities"]),
            per_identity=int(lib["spectra_per_identity"]),
            num_bins=int(lib["num_bins"]),
            peaks_per_peptide=int(lib["peaks_per_peptide"]),
            intensity_jitter=float(lib["intensity_jitter"]),
            dropout=float(lib["dropout"]),
            noise_peaks=int(lib["noise_peaks"]),
            precursor_range=tuple(lib["precursor_range"]),
            precursor_noise=float(lib["precursor_noise"]),
            query_modification_rate=float(lib["query_modification_rate"]),
            modification_mass_range=tuple(lib["modification_mass_range"]),
            modification_shift_bins=tuple(lib["modification_shift_bins"]))

    @property
    def num_targets(self) -> int:
        return self.identities * self.per_identity


def quantize(spectra: torch.Tensor, num_levels: int) -> torch.Tensor:
    """Spectra in [0, 1] -> int8 levels: 0 absent (<= 1e-6), else
    ``1 + min(int(v * (m - 1)), m - 2)``."""
    v = spectra.to(torch.float32).clamp(0.0, 1.0)
    lvl = 1 + torch.clamp_max((v * (num_levels - 1)).to(torch.int32),
                              num_levels - 2)
    return torch.where(v > 1e-6, lvl, torch.zeros_like(lvl)).to(torch.int8)


def make_templates(spec: SpectraSpec, g: torch.Generator, device
                   ) -> torch.Tensor:
    """(identities, bins) float32 peptide templates: ``peaks_per_peptide``
    peaks at random bins with intensities in [0.2, 1)."""
    shape = (spec.identities, spec.peaks_per_peptide)
    pos = torch.randint(0, spec.num_bins, shape, generator=g, device=device)
    inten = 0.2 + 0.8 * torch.rand(shape, generator=g, device=device)
    rows = torch.arange(spec.identities, device=device)[:, None]
    flat = (rows * spec.num_bins + pos).reshape(-1)
    out = torch.zeros(spec.identities * spec.num_bins, dtype=torch.float32,
                      device=device)
    out.scatter_reduce_(0, flat, inten.reshape(-1), reduce="amax")
    return out.reshape(spec.identities, spec.num_bins)


def _roll_rows(spec: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    bins = spec.shape[1]
    idx = (torch.arange(bins, device=spec.device)[None, :]
           - shifts[:, None]) % bins
    return torch.gather(spec, 1, idx)


def instances(templates: torch.Tensor, ident: torch.Tensor,
              spec: SpectraSpec, g: torch.Generator, modification_rate: float
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Noisy observations of ``templates[ident]``, normalised by their
    maximum, and which of them carry a modification."""
    base = templates[ident]
    n, bins = base.shape
    dev = base.device
    jit = 1.0 + spec.intensity_jitter * torch.randn(base.shape, generator=g,
                                                    device=dev)
    out = base * jit.clamp_(0.1, 2.0)
    keep = torch.rand(base.shape, generator=g, device=dev) > spec.dropout
    out = torch.where(keep, out, torch.zeros_like(out))
    if spec.noise_peaks:
        npos = torch.randint(0, bins, (n, spec.noise_peaks), generator=g,
                             device=dev)
        nint = 0.05 + 0.3 * torch.rand((n, spec.noise_peaks), generator=g,
                                       device=dev)
        out.scatter_reduce_(1, npos, nint, reduce="amax")
    is_mod = (torch.rand((n,), generator=g, device=dev)
              < modification_rate)
    if modification_rate > 0:
        lo, hi = spec.modification_shift_bins
        shift = torch.randint(lo, hi, (n,), generator=g, device=dev)
        half = bins // 2
        shifted = torch.cat([out[:, :half], _roll_rows(out, shift)[:, half:]],
                            dim=1)
        out = torch.where(is_mod[:, None], shifted, out)
    mx = out.amax(dim=1, keepdim=True).clamp_min(1e-6)
    return out / mx, is_mod


def identity_precursor(ident: torch.Tensor, spec: SpectraSpec,
                       offset: float) -> torch.Tensor:
    """Noise-free precursor mass of each identity: a golden-ratio sequence
    (shifted by a per-run ``offset``) over ``precursor_range``."""
    lo, hi = spec.precursor_range
    frac = torch.remainder(ident.to(torch.float64) * PHI + offset, 1.0)
    return (lo + (hi - lo) * frac).to(torch.float32)


@dataclasses.dataclass
class Library:
    """The target library as quantized levels, identity-major (identity
    ``i`` owns rows ``[i * per_identity, (i + 1) * per_identity)``), with
    its precursors. Decoys are the targets with the m/z axis reversed and
    the same precursors: their levels are ``levels.flip(-1)``."""

    levels: torch.Tensor      # (N, bins) int8, on the device
    precursor: np.ndarray     # (N,) float32
    templates: torch.Tensor   # (identities, bins) float32, on the device
    mass_offset: float

    @property
    def num_targets(self) -> int:
        return int(self.levels.shape[0])

    def decoy_levels(self) -> torch.Tensor:
        return self.levels.flip(-1)


def make_library(spec: SpectraSpec, num_levels: int, seed: int, device
                 ) -> Library:
    """The library of one run, generated in row chunks on ``device``."""
    templates = make_templates(spec, generator(seed, "templates", device),
                               device)
    n = spec.num_targets
    ident = torch.arange(spec.identities, device=device).repeat_interleave(
        spec.per_identity)
    g = generator(seed, "library", device)
    levels = torch.empty((n, spec.num_bins), dtype=torch.int8, device=device)
    for r0 in range(0, n, CHUNK_ROWS):
        sp, _ = instances(templates, ident[r0:r0 + CHUNK_ROWS], spec, g, 0.0)
        levels[r0:r0 + CHUNK_ROWS] = quantize(sp, num_levels)
    gm = generator(seed, "masses", device)
    offset = float(torch.rand((), generator=gm, device=device,
                              dtype=torch.float64))
    prec = identity_precursor(ident, spec, offset) + spec.precursor_noise * (
        torch.randn((n,), generator=gm, device=device))
    return Library(levels=levels, precursor=prec.to(torch.float32).cpu()
                   .numpy(), templates=templates, mass_offset=offset)


@dataclasses.dataclass
class QueryPool:
    """Query spectra: quantized levels on the host (int8) and their
    precursors (float32)."""

    levels: np.ndarray        # (Q, bins) int8
    precursor: np.ndarray     # (Q,) float32

    def __len__(self) -> int:
        return int(self.levels.shape[0])


def make_queries(lib: Library, spec: SpectraSpec, num_levels: int, size: int,
                 seed: int, stream: str, device) -> QueryPool:
    """``size`` new noisy instances of uniformly drawn library identities;
    a ``query_modification_rate`` share of them modified, their precursor
    heavier by a mass drawn uniformly from ``modification_mass_range``."""
    g = generator(seed, stream, device)
    ident = torch.randint(0, spec.identities, (size,), generator=g,
                          device=device)
    levels = torch.empty((size, spec.num_bins), dtype=torch.int8,
                         device=device)
    is_mod = torch.empty((size,), dtype=torch.bool, device=device)
    for r0 in range(0, size, CHUNK_ROWS):
        sp, mod = instances(lib.templates, ident[r0:r0 + CHUNK_ROWS], spec, g,
                            spec.query_modification_rate)
        levels[r0:r0 + CHUNK_ROWS] = quantize(sp, num_levels)
        is_mod[r0:r0 + CHUNK_ROWS] = mod
    m_lo, m_hi = spec.modification_mass_range
    prec = identity_precursor(ident, spec, lib.mass_offset) + (
        spec.precursor_noise * torch.randn((size,), generator=g,
                                           device=device))
    shift = m_lo + (m_hi - m_lo) * torch.rand((size,), generator=g,
                                              device=device)
    prec = torch.where(is_mod, prec + shift, prec).to(torch.float32)
    return QueryPool(levels=levels.cpu().numpy(),
                     precursor=prec.cpu().numpy())


def make_codebooks(dim: int, num_features: int, num_levels: int, seed: int,
                   device) -> tuple[torch.Tensor, torch.Tensor]:
    """Eq. 1's codebooks: (F, D) random bipolar ID vectors and (m, D)
    level vectors, ``LV_k`` being ``LV_0`` with the first
    ``k * (D // 2) // (m - 1)`` positions of a random permutation flipped
    (so ``LV_0`` and ``LV_{m-1}`` differ in D/2 positions)."""
    g = generator(seed, "codebooks", device)
    id_hvs = (torch.randint(0, 2, (num_features, dim), generator=g,
                            device=device, dtype=torch.int8) * 2 - 1)
    base = torch.randint(0, 2, (dim,), generator=g, device=device,
                         dtype=torch.int8) * 2 - 1
    rank = torch.argsort(torch.rand((dim,), generator=g, device=device))
    rank = torch.empty_like(rank).scatter_(0, rank, torch.arange(
        dim, device=device))
    thresholds = (torch.arange(num_levels, device=device) * (dim // 2)
                  // (num_levels - 1))
    flip = rank[None, :] < thresholds[:, None]
    level_hvs = torch.where(flip, -base[None, :], base[None, :])
    return id_hvs.to(torch.int8), level_hvs.to(torch.int8)


def candidate_fraction(lib_prec: np.ndarray, query_prec: np.ndarray,
                       tol: float, open_tol: float) -> float:
    """Mean share of the library's targets whose precursor lies in each
    query's open window (``query - ref`` in ``(-tol, open_tol)``)."""
    srt = np.sort(np.asarray(lib_prec, np.float32))
    q = np.asarray(query_prec, np.float32)
    lo = q - np.float32(open_tol)
    hi = q + np.float32(tol)
    n = (np.searchsorted(srt, hi, side="left")
         - np.searchsorted(srt, lo, side="right"))
    return float(np.maximum(n, 0).mean() / max(srt.shape[0], 1))

