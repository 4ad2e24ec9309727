"""Complete-linkage agglomerative clustering over HD distances (SpecPCM
§III.C), in PyTorch.

Counterpart of ``repro.core.hd.clustering``. The paper computes an
all-pairs distance matrix inside the PCM array, then a near-memory ASIC
merges the closest pair of clusters under *complete linkage* (cluster
distance = max element-pair distance) until the minimum cluster distance
exceeds a threshold.

Packed HVs are int32 bit-views of the reference's uint32 words, so an
int32 matrix takes the bit-packed route (the ``hamming_pop`` kernel);
any other integer matrix holds unpacked HVs.

:func:`complete_linkage` merges exactly as the reference's
``lax.while_loop`` does (same pair, same survivor, same labels), but
keeps each row's minimum and its first column instead of rescanning the
whole matrix per merge: complete linkage only ever raises the merged
entries, so a row's minimum changes only where the merge touched its
minimum's column.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core.hd.similarity import dot_similarity

_BIG = torch.finfo(torch.float32).max


@dataclasses.dataclass
class ClusteringResult:
    labels: torch.Tensor  # (N,) int32 cluster id per point (canonical: min index)
    num_merges: int
    num_clusters: int


def _distance_from_similarity(a, b, d: int, hamming: Callable | None
                              ) -> torch.Tensor:
    if a.dtype == torch.int32:
        if hamming is None:
            from repro_torch.kernels.hamming_pop import hamming_pop as hamming
        # hamming_pop returns agreements (d - popcount); the distance is the
        # complement, exact for bipolar inputs
        return (d - hamming(a, b, dim=d)).to(torch.float32)
    return (d - dot_similarity(a, b)).to(torch.float32) * 0.5


def pairwise_distances(hvs: torch.Tensor, dim: int | None = None, *,
                       hamming: Callable | None = None) -> torch.Tensor:
    """(N, N) float32 Hamming distances between (packed or bipolar) HVs,
    zero on the diagonal.

    int32 input holds bit-packed words: the distance is exactly
    ``popcount(a ^ b)`` (``hamming``, the kernel by default). Other
    integer input holds unpacked HVs: ``(D - <a, b>) / 2``.

    Args:
      hvs: (N, D') integer HVs, or (N, D/32) int32 packed words.
      dim: original (unpacked) dimensionality D; defaults to D'.
      hamming: the packed similarity function; None runs
        :func:`repro_torch.kernels.hamming_pop.hamming_pop` (a test or a
        check passes its plain version).
    """
    d = dim if dim is not None else hvs.shape[1]
    dist = _distance_from_similarity(hvs, hvs, d, hamming)
    # self-distance is 0 even under packing estimation noise
    return dist.fill_diagonal_(0.0)


def cross_distances(a: torch.Tensor, b: torch.Tensor, dim: int | None = None,
                    *, hamming: Callable | None = None) -> torch.Tensor:
    """(Na, Nb) float32 Hamming distances between two HV sets: the
    cross-set twin of :func:`pairwise_distances` with no diagonal
    zeroing. The streaming-clustering step: a batch against the centroid
    bank."""
    d = dim if dim is not None else a.shape[-1]
    return _distance_from_similarity(a, b, d, hamming)


def complete_linkage(dist: torch.Tensor, threshold) -> ClusteringResult:
    """Complete-linkage clustering of an (N, N) distance matrix, on its
    device.

    Merges while the minimum inter-cluster distance is <= ``threshold``
    (float32), always the pair at the first flattened position of the
    minimum; the merged row is the elementwise max of both rows and
    survives under the lower index. Labels are canonical: each point's
    label is the smallest point index in its cluster. Each merge syncs
    with the host twice: to read the pair and to size the rows to
    rescan."""
    n = dist.shape[0]
    if dist.ndim != 2 or dist.shape[1] != n:
        raise ValueError(f"expected a square matrix, got {tuple(dist.shape)}")
    thr = float(torch.tensor(float(threshold), dtype=torch.float32))
    if not thr < _BIG:
        # every masked entry is finfo.max, so the merging would not stop
        raise ValueError(f"threshold {threshold} must be below float32 max")
    dev = dist.device
    labels = torch.arange(n, dtype=torch.int32, device=dev)
    if n == 0:
        return ClusteringResult(labels=labels, num_merges=0, num_clusters=0)
    # md is the reference's masked matrix: finfo.max on the diagonal and
    # in the rows and columns of merged-away points
    md = dist.to(torch.float32, copy=True).fill_diagonal_(_BIG)
    row_min, row_arg = md.min(dim=1)   # first column of each row's minimum
    merges = 0
    while True:
        i = torch.argmin(row_min)      # first row: the flattened argmin
        m, i, j = torch.stack([row_min[i].to(torch.float64),
                               i.to(torch.float64),
                               row_arg[i].to(torch.float64)]).tolist()
        if not m <= thr:
            break
        lo, hi = int(min(i, j)), int(max(i, j))
        # md[lo, lo] and md[hi, hi] are finfo.max, so the max row is
        # finfo.max at lo and hi and at every merged-away point already
        newrow = torch.maximum(md[lo], md[hi])
        md[lo] = newrow
        md[:, lo] = newrow
        md[hi] = _BIG
        md[:, hi] = _BIG
        labels.masked_fill_(labels == hi, lo)
        merges += 1
        # rows whose minimum sat in column lo or hi are rescanned; any
        # other row only gains the candidate (newrow[k], lo)
        stale = (row_arg == lo) | (row_arg == hi)
        stale[lo] = True
        stale[hi] = True
        gain = (newrow < row_min) | ((newrow == row_min) & (row_arg > lo))
        row_min = torch.where(gain, newrow, row_min)
        row_arg = torch.where(gain, torch.full_like(row_arg, lo), row_arg)
        rows = stale.nonzero().squeeze(1)
        row_min[rows], row_arg[rows] = md[rows].min(dim=1)
    return ClusteringResult(labels=labels, num_merges=merges,
                            num_clusters=n - merges)


def clustered_spectra_ratio(labels: torch.Tensor) -> torch.Tensor:
    """Fraction of points in clusters of size >= 2 (the paper's quality
    metric), float32."""
    n = labels.shape[0]
    sizes = torch.bincount(labels.to(torch.int64), minlength=n)
    count = (sizes[labels.to(torch.int64)] >= 2).sum().to(torch.float32)
    # the reference's jnp.mean multiplies by the float32 reciprocal of n
    return count * torch.tensor(1.0 / n, dtype=torch.float32)


def incorrect_clustering_ratio(labels: torch.Tensor, truth: torch.Tensor
                               ) -> torch.Tensor:
    """Fraction of *clustered* points whose cluster's majority
    ground-truth identity (first on ties) differs from their own (the
    paper's x-axis in Fig. 9), float32. Labels and truth ids must lie in
    [0, n)."""
    n = labels.shape[0]
    lab = labels.to(torch.int64)
    tru = truth.to(torch.int64).to(lab.device)
    votes = torch.zeros((n, n), dtype=torch.int32, device=lab.device)
    votes.index_put_((lab, tru), torch.ones(n, dtype=torch.int32,
                                            device=lab.device),
                     accumulate=True)
    majority = torch.argmax(votes[lab], dim=-1)
    del votes
    sizes = torch.bincount(lab, minlength=n)
    clustered = sizes[lab] >= 2
    wrong = clustered & (majority != tru)
    denom = max(int(clustered.sum()), 1)
    return wrong.sum().to(torch.float32) / denom
