"""Open-modification search (OMS): the precursor index and the host-side
candidate plan.

Counterpart of ``repro.serve.oms``, kept as the port's own copy (numpy
only, so ``np.searchsorted`` on float32 masses gives the same ranges in
both packages). OMS widens the precursor window on the query side: a
modified peptide is *heavier* than its unmodified reference, so a query
at mass ``m`` is compared with references where ``query - ref`` lies in
``(-tol, open_tol)`` (the convention of
:func:`repro_torch.spectra.preprocess.candidate_window_mask`). Instead of
scanning the whole bank per query:

  * :func:`repro_torch.serve.db_search.shard_database` sorts each bank
    *block* (the decoy block, then the target block; decoys first is what
    resolves score ties to the decoy) by precursor mass and keeps the
    permutation back to the original rows;
  * per query, the candidates inside each block are one contiguous
    ``[start, start + len)`` row range, found here by ``searchsorted``;
  * the banded kernels scan only the rows of those ranges, and the merged
    indices are translated back through the permutation.

Everything here runs on the host, once per batch, before the search.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class OMSConfig:
    """Tolerances of the precursor window, in the units of the bank's
    precursor column.

    ``open_search=True``: accept ``query - ref`` in the open interval
    ``(-tol, open_tol)``. ``open_search=False``: exact search,
    ``|query - ref| < tol``.
    """

    tol: float = 20.0
    open_tol: float = 200.0
    open_search: bool = True

    def window(self, query_prec: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Per-query (lo, hi) bounds: references strictly inside (lo, hi)."""
        q = np.asarray(query_prec, np.float32)
        lo = q - (self.open_tol if self.open_search else self.tol)
        hi = q + self.tol
        return lo, hi


@dataclasses.dataclass(frozen=True)
class PrecursorIndex:
    """Blockwise precursor-sorted layout of a [decoys; targets] bank.

    ``prec_sorted`` ascends *within each block* (block boundaries in
    ``block_bounds``); ``perm[i]`` is the original bank row stored at
    sorted row ``i``. Blocks sort independently, so every decoy row keeps
    a smaller index than every target row: the global index order on
    which the merge's tie-break (lowest index wins) resolves exact score
    ties to the decoy.
    """

    prec_sorted: np.ndarray        # (num_rows,) float32
    perm: np.ndarray               # (num_rows,) int32 sorted row -> original
    block_bounds: tuple[int, ...]  # e.g. (0, num_decoys, num_rows)

    @property
    def num_rows(self) -> int:
        return int(self.prec_sorted.shape[0])

    @property
    def num_blocks(self) -> int:
        return len(self.block_bounds) - 1

    def candidate_ranges(self, query_prec: np.ndarray, cfg: OMSConfig
                         ) -> tuple[np.ndarray, np.ndarray]:
        """Per-query per-block candidate row ranges in the sorted layout.

        Returns ``(starts, lens)``, both (num_blocks, Q) int32: block b's
        range for query q is ``[starts[b, q], starts[b, q] + lens[b, q])``
        and holds exactly the rows ``candidate_window_mask`` keeps (strict
        bounds on both sides).
        """
        lo, hi = cfg.window(query_prec)
        starts, lens = [], []
        for b in range(self.num_blocks):
            b0, b1 = self.block_bounds[b], self.block_bounds[b + 1]
            block = self.prec_sorted[b0:b1]
            # first row with prec > lo / first row with prec >= hi
            s = b0 + np.searchsorted(block, lo, side="right")
            e = b0 + np.searchsorted(block, hi, side="left")
            starts.append(s)
            lens.append(np.maximum(e - s, 0))
        return (np.stack(starts).astype(np.int32),
                np.stack(lens).astype(np.int32))


def build_precursor_index(precursor: np.ndarray,
                          decoy_precursor: np.ndarray | None = None
                          ) -> PrecursorIndex:
    """Sort the [decoys; targets] bank blockwise by precursor.

    ``precursor`` holds the target block's masses, ``decoy_precursor`` the
    decoy block's (m/z-reversed decoys keep their target's mass, so
    callers usually pass the same array). Without decoys the bank is one
    target block.
    """
    tgt = np.asarray(precursor, np.float32)
    blocks = [tgt] if decoy_precursor is None else [
        np.asarray(decoy_precursor, np.float32), tgt]
    bounds = [0]
    prec_parts, perm_parts = [], []
    for block in blocks:
        order = np.argsort(block, kind="stable").astype(np.int32)
        prec_parts.append(block[order])
        perm_parts.append(order + bounds[-1])
        bounds.append(bounds[-1] + block.shape[0])
    return PrecursorIndex(prec_sorted=np.concatenate(prec_parts),
                          perm=np.concatenate(perm_parts),
                          block_bounds=tuple(bounds))


@dataclasses.dataclass(frozen=True)
class OMSPlan:
    """One batch's plan: candidate ranges and the tile budget.

    ``num_tiles`` is rounded up to a power of two (the reference keys its
    compiled kernels on it); ``scanned_fraction`` is the bank share the
    budget prices per band (tiles per query block / total tiles),
    ``candidate_fraction`` the window's selectivity (candidate rows / bank
    rows, averaged over the queries).
    """

    starts: np.ndarray       # (B, Q) int32, sorted-layout rows
    lens: np.ndarray         # (B, Q) int32
    num_tiles: int           # per-band tile budget of a query block
    scanned_fraction: float
    candidate_fraction: float

    @property
    def has_candidate(self) -> np.ndarray:
        """(Q,) bool: at least one candidate row across all blocks."""
        return self.lens.sum(axis=0) > 0


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _next_pow2(x: int) -> int:
    n = 1
    while n < x:
        n *= 2
    return n


def plan_candidates(index: PrecursorIndex, query_prec: np.ndarray,
                    cfg: OMSConfig, *, num_rows_padded: int,
                    block_q: int = 128, block_r: int = 128) -> OMSPlan:
    """The banded search's plan for one query batch.

    ``num_rows_padded`` is the bank's padded row count (shards x
    shard_rows). ``num_tiles`` covers, for every band and every block of
    ``block_q`` queries, the ``block_r``-row tiles from
    ``floor(min start / block_r)`` to ``ceil(max end / block_r)``.
    """
    starts, lens = index.candidate_ranges(query_prec, cfg)
    q = starts.shape[1]
    nr = index.num_rows
    total_tiles = max(1, _round_up(max(num_rows_padded, 1), block_r) // block_r)
    bq = min(block_q, _round_up(max(q, 1), 8))
    span = 1
    for b in range(starts.shape[0]):
        s = starts[b]
        e = s + lens[b]
        for i in range(0, q, bq):
            blk_s = int(s[i:i + bq].min()) // block_r
            blk_e = -(-int(e[i:i + bq].max()) // block_r)
            span = max(span, blk_e - blk_s)
    num_tiles = min(_next_pow2(span), total_tiles)
    cand = float(lens.sum()) / max(q * max(nr, 1), 1)
    scanned = min(1.0, starts.shape[0] * num_tiles / total_tiles)
    return OMSPlan(starts=starts, lens=lens, num_tiles=num_tiles,
                   scanned_fraction=scanned, candidate_fraction=cand)


def translate_indices(index: PrecursorIndex, idx: np.ndarray) -> np.ndarray:
    """Sorted-layout rows -> original bank rows; rows outside the bank
    pass through unchanged."""
    idx = np.asarray(idx)
    ok = (idx >= 0) & (idx < index.num_rows)
    return np.where(ok, index.perm[np.clip(idx, 0, max(index.num_rows - 1, 0))],
                    idx)
