"""Append-only delta banks: streaming ingestion for the serving stack, in
PyTorch.

Counterpart of ``repro.serve.delta``. A tenant's base bank is the heavy
artifact (bit-packed, precursor-sorted for OMS), so an append does not
rebuild it: new refs and decoys land in a small **unpacked one-shard
delta bank** (:class:`DeltaBank`, rows kept on the base bank's device),
rebuilt per append in O(delta), and search runs an exact merged top-k
over base + delta:

  * each side runs its own search unchanged. The delta is a fused,
    unpacked :class:`~repro_torch.serve.db_search.ShardedDatabase`, so on
    the card its exact side is the ``topk_hamming`` kernel's int8 scan
    and its OMS side the ``topk_hamming_banded`` kernel's; neither
    builds the (Q, delta rows) score matrix;
  * every candidate's index is translated into the row numbering the bank
    *would* have after a from-scratch rebuild over the concatenated
    arrays (``[base decoys; delta decoys; base targets; delta targets]``,
    each block re-sorted by precursor for OMS banks);
  * the two candidate blocks merge by ``(score desc, rebuilt row asc)``,
    one ``torch.sort`` of an int64 key, because rebuilt rows *interleave*
    across the sides (a delta decoy sits between base decoys and base
    targets), so the positional tie-break of the shard merge does not
    apply across sides.

Both translations are strictly increasing (appended rows keep their
relative order inside each block, and a stable blockwise sort of the
concatenated precursors keeps base rows ahead of delta rows on mass
ties), so each side's top-k, re-keyed by rebuilt rows, is exactly the
rebuilt bank's top-k restricted to that side. Any rebuilt winner is
therefore among the merged candidates, and the merge reproduces the
rebuilt result **bit-identically**, tie order and (for OMS) overflow
slots included: the OMS path merges *sorted-layout* rows, then runs the
same ``canonicalize_overflow_slots`` + permutation a rebuilt bank's
OMS tail would, against the merged precursor index and window ranges.

The score scale is shared by construction: the unpacked delta scores
int8 dot products and the packed base ``D - 2 * hamming``, equal
integers for bipolar HVs.

:meth:`repro_torch.serve.cache.BankRegistry.compact` folds the delta back
into the packed base past a size threshold; by the identity above,
results are unchanged across the swap.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.hd.similarity import INT32_MIN
from repro_torch.device import resolve_device
from repro_torch.serve.oms import (
    OMSConfig,
    OMSPlan,
    PrecursorIndex,
    build_precursor_index,
)


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` without a host synchronization (a pinned
    copy on the card)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


@dataclasses.dataclass(frozen=True)
class MergedLayout:
    """Index maps from per-side storage rows into the rebuilt bank's rows.

    ``b_map``/``d_map`` take a base/delta *storage* row (original row for
    plain banks, sorted-layout row for OMS banks) to the storage row the
    same HV would occupy after a from-scratch rebuild over the
    concatenated arrays. Both maps are strictly increasing: the property
    that lets each side's own ascending-index tie-break stand in for the
    rebuilt bank's. The maps and ``perm`` (the merged index's permutation)
    live on the bank's device.
    """

    num_rows: int
    num_decoys: int
    b_map: torch.Tensor            # (base.num_rows,) int64
    d_map: torch.Tensor            # (delta.num_rows,) int64
    index: PrecursorIndex | None   # merged OMS index (None for plain banks)
    perm: torch.Tensor | None      # index.perm, int64


class DeltaBank:
    """Append-only unpacked delta rows for one tenant.

    Appended refs/decoys accumulate on ``device``; after every append the
    small one-shard, never-packed, fused
    :class:`~repro_torch.serve.db_search.ShardedDatabase` (``self.db``)
    is rebuilt: O(delta), not O(bank). For OMS tenants the delta carries
    its own precursor-sorted index, and :meth:`layout` caches the maps
    into the merged (rebuilt-equivalent) row space.
    """

    def __init__(self, dim: int, *, oms: bool,
                 device: str | torch.device = "cuda"):
        self.dim = int(dim)
        self.oms = bool(oms)
        self.device = resolve_device(device)
        self.refs = torch.zeros((0, self.dim), dtype=torch.int8,
                                device=self.device)
        self.decoys = torch.zeros_like(self.refs)
        self.precursor = np.zeros((0,), np.float32)
        self.decoy_precursor = np.zeros((0,), np.float32)
        self.version = 0
        self.db = None
        self._layout: MergedLayout | None = None
        self._layout_key = None

    @property
    def num_targets(self) -> int:
        return int(self.refs.shape[0])

    @property
    def num_decoys(self) -> int:
        return int(self.decoys.shape[0])

    @property
    def num_rows(self) -> int:
        return self.num_targets + self.num_decoys

    def _rows(self, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(self.device, torch.int8)
        return torch.from_numpy(np.asarray(a, np.int8)).to(self.device)

    def append(self, refs, decoys=None, *, precursor=None,
               decoy_precursor=None) -> int:
        """Land one batch of refs (+ optional decoys), numpy arrays or
        tensors, in the delta; returns the delta's total row count. OMS
        deltas require per-ref precursor masses (``decoy_precursor``
        defaulting to ``precursor`` when the decoy count matches, as
        ``shard_database`` does)."""
        r = self._rows(refs)
        if r.numel() == 0:
            r = torch.zeros((0, self.dim), dtype=torch.int8,
                            device=self.device)
        if r.ndim != 2 or r.shape[1] != self.dim:
            raise ValueError(f"appended refs shape {tuple(r.shape)} != "
                             f"(n, {self.dim})")
        d = None
        if decoys is not None:
            d = self._rows(decoys)
            if d.ndim != 2 or d.shape[1] != self.dim:
                raise ValueError(f"appended decoys shape {tuple(d.shape)} "
                                 f"!= (n, {self.dim})")
        n_new = r.shape[0] + (0 if d is None else d.shape[0])
        if n_new == 0:
            raise ValueError("append needs at least one ref or decoy row")
        if self.oms:
            if precursor is None:
                raise ValueError("this tenant's bank is precursor-sorted "
                                 "(OMS); append requires precursor=")
            prec = np.asarray(precursor, np.float32).reshape(-1)
            if prec.shape[0] != r.shape[0]:
                raise ValueError(f"precursor has {prec.shape[0]} entries "
                                 f"for {r.shape[0]} appended refs")
            dprec = None
            if d is not None:
                dprec = (prec if decoy_precursor is None
                         else np.asarray(decoy_precursor,
                                         np.float32).reshape(-1))
                if dprec.shape[0] != d.shape[0]:
                    raise ValueError(
                        f"decoy_precursor has {dprec.shape[0]} entries for "
                        f"{d.shape[0]} appended decoys")
        else:
            if precursor is not None or decoy_precursor is not None:
                raise ValueError("this tenant's bank has no precursor "
                                 "index; append must not pass precursor=")
            prec = dprec = None

        self.refs = torch.cat([self.refs, r])
        if d is not None:
            self.decoys = torch.cat([self.decoys, d])
        if self.oms:
            self.precursor = np.concatenate([self.precursor, prec])
            if dprec is not None:
                self.decoy_precursor = np.concatenate(
                    [self.decoy_precursor, dprec])
        self.version += 1
        self._rebuild()
        return self.num_rows

    def _rebuild(self) -> None:
        from repro_torch.serve.db_search import shard_database
        decoys = self.decoys if self.num_decoys else None
        self.db = shard_database(
            self.refs, decoys=decoys, pack=False, fused=True,
            precursor=self.precursor if self.oms else None,
            decoy_precursor=(self.decoy_precursor
                             if self.oms and decoys is not None else None))

    def layout(self, base) -> MergedLayout:
        """The (cached) rebuilt-row maps for this delta against ``base``.

        Keyed on the delta version and base geometry only: an evicted-and-
        rebuilt base is content-identical, so the maps survive it.
        """
        key = (self.version, base.num_rows, base.num_decoys)
        if self._layout is None or self._layout_key != key:
            self._layout = merged_layout(base, self)
            self._layout_key = key
        return self._layout


def merged_layout(base, delta: DeltaBank) -> MergedLayout:
    """Compute the rebuilt-row maps (see :class:`MergedLayout`)."""
    nd0, ndd = base.num_decoys, delta.num_decoys
    nt0 = base.num_rows - nd0
    n_m = base.num_rows + delta.num_rows
    dev = base.data.device
    b_orig = np.arange(base.num_rows, dtype=np.int32)
    b_trans = np.where(b_orig < nd0, b_orig, b_orig + ndd).astype(np.int32)
    d_orig = np.arange(delta.num_rows, dtype=np.int32)
    d_trans = np.where(d_orig < ndd, d_orig + nd0,
                       d_orig + nd0 + nt0).astype(np.int32)
    if base.oms is None:
        return MergedLayout(
            num_rows=n_m, num_decoys=nd0 + ndd,
            b_map=_to_device(b_trans.astype(np.int64), dev),
            d_map=_to_device(d_trans.astype(np.int64), dev), index=None,
            perm=None)
    # original-order base precursors, recovered exactly from the sorted
    # index (float32 round-trips, so this matches whatever register()
    # passed, the decoy default included)
    base_prec = np.empty(base.num_rows, np.float32)
    base_prec[base.oms.perm] = base.oms.prec_sorted
    tgt = np.concatenate([base_prec[nd0:], delta.precursor])
    dec = np.concatenate([base_prec[:nd0], delta.decoy_precursor])
    index = build_precursor_index(tgt, dec if dec.shape[0] else None)
    pos = np.empty(n_m, np.int32)
    pos[index.perm] = np.arange(n_m, dtype=np.int32)
    return MergedLayout(
        num_rows=n_m, num_decoys=nd0 + ndd,
        b_map=_to_device(pos[b_trans[base.oms.perm]].astype(np.int64), dev),
        d_map=_to_device(pos[d_trans[delta.db.oms.perm]].astype(np.int64),
                         dev),
        index=index, perm=_to_device(index.perm.astype(np.int64), dev))


def _merge_by_row(cand_vals: torch.Tensor, cand_rows: torch.Tensor, k: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over candidate blocks by ``(score desc, rebuilt row asc)``.

    The cross-side twin of the shard merge: rebuilt rows interleave across
    the base/delta blocks, so the tie-break must sort on the translated
    row itself, not block position. One ascending sort of the int64 key
    ``(-score) * 2**32 + row`` (scores are int32 bounded by +-D, rows
    below 2**31); sentinel slots (``INT32_MIN``) take the high half
    ``2**31 - 1`` and sort behind every real candidate, keeping their
    sentinel value for the caller's overflow canonicalization. Equal keys
    carry equal payloads, so the sort needs no stability. Returns (rows,
    vals), int32."""
    sentinel = cand_vals == INT32_MIN
    hi = torch.where(sentinel, torch.full_like(cand_vals, 2**31 - 1),
                     -cand_vals).to(torch.int64)
    key = hi * 2**32 + cand_rows.to(torch.int64)
    key = torch.sort(key, dim=-1).values[..., :k]
    hi = key >> 32
    rows = (key - (hi << 32)).to(torch.int32)
    vals = torch.where(hi == 2**31 - 1, torch.full_like(hi, INT32_MIN),
                       -hi).to(torch.int32)
    return rows, vals


def merged_search_encoded(base, delta: DeltaBank, q_enc: torch.Tensor,
                          q_raw: torch.Tensor, k: int
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over base + delta, bit-identical to a from-scratch
    rebuild over the concatenated arrays.

    ``q_enc`` is the batch in the *base* bank's storage form (packed or
    int8); ``q_raw`` the same batch as raw bipolar int8 rows for the
    unpacked delta. Returned indices are rebuilt-bank storage rows
    (original rows for plain banks; the sorted layout for OMS banks,
    matching what exact search over a rebuilt OMS bank returns).
    """
    from repro_torch.serve.db_search import search_database_encoded
    layout = delta.layout(base)
    bi, bv = search_database_encoded(base, q_enc, k)
    kd = min(k, delta.num_rows)
    di, dv = search_database_encoded(delta.db, q_raw, kd)
    b_rows = layout.b_map[bi.to(torch.int64).clamp(0, base.num_rows - 1)]
    d_rows = layout.d_map[di.to(torch.int64)]
    return _merge_by_row(torch.cat([bv, dv], dim=1),
                         torch.cat([b_rows, d_rows], dim=1), k)


@dataclasses.dataclass(frozen=True)
class MergedOMSPlan:
    """Per-batch OMS plan for a base + delta pair.

    Carries each side's own :class:`~repro_torch.serve.oms.OMSPlan` (the
    delta plan runs on the small unpacked bank) plus the *merged*
    candidate ranges, identical to the ranges a rebuilt bank's plan would
    hold, since they depend only on the merged precursor index.
    """

    base: OMSPlan
    delta: OMSPlan
    starts: np.ndarray       # (B, Q) int32, merged sorted-layout rows
    lens: np.ndarray         # (B, Q) int32
    candidate_fraction: float
    scanned_fraction: float

    @property
    def has_candidate(self) -> np.ndarray:
        return self.lens.sum(axis=0) > 0


def merged_oms_plan(base, delta: DeltaBank, query_prec: np.ndarray,
                    cfg: OMSConfig | None = None) -> MergedOMSPlan:
    """Host-side plan for one precursor-sorted query batch against
    base + delta. ``scanned_fraction`` counts the delta as a full scan
    (the reference searches it unbanded: it is small by construction)."""
    from repro_torch.serve.db_search import oms_plan
    cfg = cfg or OMSConfig()
    layout = delta.layout(base)
    bplan = oms_plan(base, query_prec, cfg)
    dplan = oms_plan(delta.db, query_prec, cfg)
    starts, lens = layout.index.candidate_ranges(
        np.asarray(query_prec), cfg)
    q = max(starts.shape[1], 1)
    cand = float(lens.sum()) / max(q * max(layout.num_rows, 1), 1)
    base_padded = base.num_shards * base.shard_rows
    total = max(base_padded + delta.db.num_rows, 1)
    scanned = min(1.0, (bplan.scanned_fraction * base_padded
                        + delta.db.num_rows) / total)
    return MergedOMSPlan(base=bplan, delta=dplan, starts=starts, lens=lens,
                         candidate_fraction=cand, scanned_fraction=scanned)


def merged_oms_search_encoded(base, delta: DeltaBank, q_enc: torch.Tensor,
                              q_raw: torch.Tensor, mplan: MergedOMSPlan,
                              k: int, *, arena=None
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """OMS top-k over base + delta, bit-identical to a rebuilt bank.

    Each side runs its inner (pre-canonicalization) OMS route against its
    own index; candidates merge in the *merged sorted layout*, then the
    shared overflow-canonicalize + permutation tail runs against the
    merged index and window ranges, the two steps a rebuilt bank's OMS
    tail applies. Returned indices are original merged-bank rows (delta
    decoys land after base decoys, delta targets after base targets).
    ``arena`` (a :class:`~repro_torch.serve.staging.PinnedArena`) stages
    the plans' bands without a host synchronization.
    """
    from repro_torch.kernels.topk_hamming import canonicalize_overflow_slots
    from repro_torch.serve.db_search import (
        _oms_search_inner,
        _plan_bands,
        _upload,
    )
    layout = delta.layout(base)
    bi, bv = _oms_search_inner(base, q_enc, mplan.base, k,
                               _plan_bands(base, mplan.base, arena, "base_"))
    kd = min(k, delta.db.num_rows)
    di, dv = _oms_search_inner(
        delta.db, q_raw, mplan.delta, kd,
        _plan_bands(delta.db, mplan.delta, arena, "delta_"))
    # kernel overflow fillers may point past the (padded) bank; clip
    # before the map gather: their values are sentinel, so the merge ranks
    # them behind every real candidate and canonicalization rewrites them
    b_rows = layout.b_map[bi.to(torch.int64).clamp(0, base.num_rows - 1)]
    d_rows = layout.d_map[di.to(torch.int64).clamp(
        0, delta.db.num_rows - 1)]
    rows, vals = _merge_by_row(torch.cat([bv, dv], dim=1),
                               torch.cat([b_rows, d_rows], dim=1), k)
    dev = base.data.device
    starts = _upload(mplan.starts.astype(np.int32), dev, arena,
                     "merged_starts")
    ends = starts + _upload(mplan.lens.astype(np.int32), dev, arena,
                            "merged_lens")
    s_c = starts.clamp(0, layout.num_rows)
    e_c = torch.maximum(ends, s_c).clamp(max=layout.num_rows)
    rows = canonicalize_overflow_slots(rows, vals, s_c, e_c, layout.num_rows)
    return layout.perm[rows.to(torch.int64)].to(torch.int32), vals
