"""Spectrum preprocessing: binning, normalisation, precursor bucketing and
the precursor window, in PyTorch.

Counterpart of ``repro.spectra.preprocess`` (the HyperSpec/HyperOMS
preprocessing the paper reuses, §S.A): spectra are binned over the m/z
range and intensity-normalised; for clustering they are partitioned into
precursor-mass buckets so the quadratic distance matrix stays per bucket
(§II.B Fig. 1).
"""

from __future__ import annotations

import numpy as np
import torch


def bin_spectra(mz: torch.Tensor, intensity: torch.Tensor, num_bins: int,
                mz_range: tuple[float, float] = (200.0, 2000.0)
                ) -> torch.Tensor:
    """Bin (N, P) padded peak lists (zero-intensity pads are ignored) to
    (N, num_bins) vectors: the largest intensity per bin, divided by the
    row's largest."""
    lo, hi = mz_range
    idx = ((mz - lo) / (hi - lo) * num_bins).to(torch.int64).clamp(
        0, num_bins - 1)
    out = torch.zeros((mz.shape[0], num_bins), dtype=torch.float32,
                      device=mz.device)
    out.scatter_reduce_(1, idx, intensity.to(torch.float32), reduce="amax")
    return out / out.amax(dim=1, keepdim=True).clamp_min(1e-6)


def sqrt_normalize(spectra: torch.Tensor) -> torch.Tensor:
    """Square-root intensity transform (damps dominant peaks), then
    re-normalisation by the row's largest. The root is taken in float64
    and rounded once to float32: the correctly rounded float32 root, as
    the reference's; torch's vectorised float32 root on the CPU can be
    one ulp away."""
    s = torch.sqrt(spectra.clamp_min(0.0).to(torch.float64)).to(
        spectra.dtype)
    return s / s.amax(dim=1, keepdim=True).clamp_min(1e-6)


def bucket_by_precursor(precursor, bucket_width: float = 40.0
                        ) -> list[np.ndarray]:
    """Partition spectrum indices into precursor-mass buckets of
    ``bucket_width``, ascending by mass (host-side)."""
    prec = np.asarray(precursor)
    if prec.size == 0:
        return []
    bucket_ids = ((prec - float(prec.min())) / bucket_width).astype(np.int64)
    return [np.nonzero(bucket_ids == b)[0] for b in np.unique(bucket_ids)]


def candidate_window_mask(query_prec: torch.Tensor, ref_prec: torch.Tensor,
                          tol: float = 20.0, open_search: bool = True,
                          open_tol: float = 200.0) -> torch.Tensor:
    """(Q, R) bool mask of references inside each query's precursor
    window. Open search accepts ``query - ref`` in the open interval
    ``(-tol, open_tol)`` (a modification adds mass to the query); exact
    search ``|query - ref| < tol``."""
    d = ref_prec[None, :] - query_prec[:, None]
    if open_search:
        return (d > -open_tol) & (d < tol)
    return d.abs() < tol
