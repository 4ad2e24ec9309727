"""Synthetic tandem-MS spectra with ground-truth identities, in PyTorch.

Counterpart of ``repro.spectra.synthetic``: peptide templates of sparse
fragment peaks, observed as template x intensity jitter, peak dropout,
optional m/z shift, chemical-noise peaks and optional open
modifications. Draws come from ``torch.Generator``s on the target
device, so the spectra differ from the reference's threefry draws; the
invariants hold instead: precursors are the deterministic golden-ratio
function of identity (plus 0.02-sigma noise), and every spectrum is
normalised to [0, 1] by its maximum.

Instances are generated in row chunks so an iPRG2012-scale library
(~6e5 spectra x 1024 bins) never holds more than a chunk's temporaries.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device

_PHI = 0.6180339887498949
_CHUNK_ROWS = 1 << 16


@dataclasses.dataclass(frozen=True)
class SyntheticMSConfig:
    num_identities: int = 64          # distinct peptides
    spectra_per_identity: int = 16    # replicates (cluster sizes)
    num_bins: int = 1024              # m/z bins after preprocessing
    peaks_per_peptide: int = 48       # fragment peaks per template
    intensity_jitter: float = 0.25    # multiplicative jitter
    dropout: float = 0.15             # per-peak missing probability
    mz_shift_bins: int = 0            # m/z calibration error in bins
    noise_peaks: int = 12             # chemical noise peaks per spectrum
    modification_rate: float = 0.0    # fraction of spectra with a mass shift
    modification_mass_range: tuple[float, float] = (0.0, 0.0)
    precursor_range: tuple[float, float] = (400.0, 1600.0)
    seed: int = 0            # instance noise (jitter/dropout/noise peaks)
    template_seed: int = 42  # peptide templates, fixed across query/ref sets


@dataclasses.dataclass
class MSDataset:
    spectra: torch.Tensor      # (N, num_bins) float32 in [0, 1]
    identity: torch.Tensor     # (N,) int32 ground-truth template id
    precursor: torch.Tensor    # (N,) float32 precursor mass
    is_modified: torch.Tensor  # (N,) bool
    templates: torch.Tensor    # (num_identities, num_bins)

    @property
    def num_spectra(self) -> int:
        return self.spectra.shape[0]


def identity_precursor(identity: torch.Tensor, cfg: SyntheticMSConfig
                       ) -> torch.Tensor:
    """The noise-free precursor of each identity: a golden-ratio hash
    over ``precursor_range``, in float32 as in the reference."""
    lo, hi = cfg.precursor_range
    ids = identity.to(torch.float32)
    return (lo + (hi - lo) * torch.remainder(ids * _PHI, 1.0)).to(
        torch.float32)


def _generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def _make_templates(cfg: SyntheticMSConfig, device: torch.device
                    ) -> torch.Tensor:
    g = _generator(cfg.template_seed, device)
    shape = (cfg.num_identities, cfg.peaks_per_peptide)
    pos = (torch.rand(shape, generator=g, device=device)
           * cfg.num_bins).to(torch.int64) % cfg.num_bins
    inten = 0.2 + 0.8 * torch.rand(shape, generator=g, device=device)
    rows = torch.arange(cfg.num_identities, device=device)[:, None]
    flat = (rows * cfg.num_bins + pos).reshape(-1)
    templates = torch.zeros(cfg.num_identities * cfg.num_bins,
                            dtype=torch.float32, device=device)
    templates.scatter_reduce_(0, flat, inten.reshape(-1), reduce="amax")
    return templates.reshape(cfg.num_identities, cfg.num_bins)


def _roll_rows(spec: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """Row i rolled right by shifts[i] bins."""
    bins = spec.shape[1]
    idx = (torch.arange(bins, device=spec.device)[None, :]
           - shifts[:, None]) % bins
    return torch.gather(spec, 1, idx)


def _instances(base: torch.Tensor, cfg: SyntheticMSConfig,
               g: torch.Generator) -> tuple[torch.Tensor, torch.Tensor]:
    """(spectra, is_modified) for one chunk of template rows, before
    normalisation."""
    n, bins = base.shape
    dev = base.device
    jit = 1.0 + cfg.intensity_jitter * torch.randn(base.shape, generator=g,
                                                   device=dev)
    spec = base * jit.clamp_(0.1, 2.0)
    keep = torch.rand(base.shape, generator=g, device=dev) > cfg.dropout
    spec = torch.where(keep, spec, torch.zeros_like(spec))
    if cfg.mz_shift_bins:
        shifts = torch.randint(-cfg.mz_shift_bins, cfg.mz_shift_bins + 1,
                               (n,), generator=g, device=dev)
        spec = _roll_rows(spec, shifts)
    if cfg.noise_peaks:
        npos = torch.randint(0, bins, (n, cfg.noise_peaks), generator=g,
                             device=dev)
        nint = 0.05 + 0.3 * torch.rand((n, cfg.noise_peaks), generator=g,
                                       device=dev)
        spec.scatter_reduce_(1, npos, nint, reduce="amax")
    is_mod = torch.rand((n,), generator=g, device=dev) < cfg.modification_rate
    if cfg.modification_rate > 0:
        delta = torch.randint(8, 48, (n,), generator=g, device=dev)
        half = bins // 2
        shifted = _roll_rows(spec, delta)
        spec_mod = torch.cat([spec[:, :half], shifted[:, half:]], dim=1)
        spec = torch.where(is_mod[:, None], spec_mod, spec)
    return spec, is_mod


def generate_dataset(cfg: SyntheticMSConfig,
                     device: str | torch.device = "cuda") -> MSDataset:
    """``num_identities * spectra_per_identity`` spectra on ``device``."""
    dev = resolve_device(device)
    templates = _make_templates(cfg, dev)
    n = cfg.num_identities * cfg.spectra_per_identity
    identity = torch.arange(cfg.num_identities, dtype=torch.int32,
                            device=dev).repeat_interleave(
                                cfg.spectra_per_identity)
    g = _generator(cfg.seed, dev)
    spectra = torch.empty((n, cfg.num_bins), dtype=torch.float32, device=dev)
    is_mod = torch.empty((n,), dtype=torch.bool, device=dev)
    for r0 in range(0, n, _CHUNK_ROWS):
        ident = identity[r0:r0 + _CHUNK_ROWS].to(torch.int64)
        spec, mod = _instances(templates[ident], cfg, g)
        mx = spec.amax(dim=1, keepdim=True).clamp_min(1e-6)
        spectra[r0:r0 + _CHUNK_ROWS] = spec / mx
        is_mod[r0:r0 + _CHUNK_ROWS] = mod

    precursor = (identity_precursor(identity, cfg)
                 + 0.02 * torch.randn((n,), generator=g, device=dev))
    m_lo, m_hi = cfg.modification_mass_range
    if m_hi > m_lo:
        shift = m_lo + (m_hi - m_lo) * torch.rand((n,), generator=g,
                                                  device=dev)
        precursor = torch.where(is_mod, precursor + shift, precursor)
    elif m_lo == m_hi and m_hi > 0.0:
        precursor = torch.where(is_mod, precursor + m_hi, precursor)
    return MSDataset(spectra=spectra, identity=identity,
                     precursor=precursor.to(torch.float32),
                     is_modified=is_mod, templates=templates)


def generate_query_set(dataset: MSDataset, cfg: SyntheticMSConfig,
                       num_queries: int, seed: int = 1,
                       modification_rate: float = 0.3) -> MSDataset:
    """Fresh replicates of the dataset's identities, to use as DB-search
    queries against it (templates are shared through ``template_seed``),
    on the dataset's device."""
    qcfg = dataclasses.replace(
        cfg,
        spectra_per_identity=max(1, num_queries // cfg.num_identities),
        seed=seed,
        modification_rate=modification_rate,
    )
    return generate_dataset(qcfg, device=dataset.spectra.device)
