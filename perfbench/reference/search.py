"""Plain reference of the spectral-library search that the benchmark checks.

What a search means, written out with plain ``torch`` and ``numpy`` calls,
independently of the program under test (nothing here imports it):

* Eq. 1 encode: ``HV = sign(sum over present bins f of ID[f] * LV[l_f])``
  with ``sign(0) = -1``; level 0 marks an absent bin, levels past ``m - 1``
  read ``LV[m - 1]``.
* Storage form: +1 is bit 1, dimension ``32 w + j`` is bit ``j`` of int32
  word ``w``.
* Score: the dot product of two bipolar vectors (``D - 2 * Hamming``).
* Bank: ``[decoys; targets]``, decoys being the targets' spectra with the
  m/z axis reversed and the targets' precursors. An open search keeps each
  block sorted by precursor (a stable sort, so equal masses keep their
  order) and admits a reference only when ``query - ref`` lies in
  ``(-tol, open_tol)``, computed in float32.
* Top-k: by score, highest first; equal scores go to the lower row of the
  stored order (the precursor-sorted order of an open search). Where a
  window holds fewer than k rows, the remaining slots score ``INT32_MIN``
  and name the lowest stored rows outside the window, as a top-k over the
  masked score matrix would. Rows are reported in the original order.
* FDR: over one served batch, in its order; rank 0 decides target or
  decoy; the accepted prefix is the longest run, by score (ties in batch
  order), whose decoys over targets stays at or below the FDR in float32;
  queries with an empty window take no part and are never accepted.

``cell_bits`` > 1 gives the control: the same search over multi-level
cells that sum ``cell_bits`` adjacent dimensions (the dimension packing of
SpecPCM's MLC arrays), half or a third of the bytes at a loss of
exactness.
"""

from __future__ import annotations

import numpy as np
import torch

INT32_MIN = -(2 ** 31)


def encode(levels: torch.Tensor, id_hvs: torch.Tensor,
           level_hvs: torch.Tensor, block: int = 1 << 16,
           out: torch.Tensor | None = None) -> torch.Tensor:
    """(B, F) levels -> (B, D) int8 bipolar hypervectors (into ``out``
    when given), ``block`` rows at a time.

    Each row's sum runs over its present bins as one bag of rows of the
    table ``ID[f] * LV[l]`` (``embedding_bag``, sum): the terms are +-1
    and a row has fewer than 2,048 present bins, so the float16 sums on
    the card (float32 elsewhere) are exact."""
    B, F = levels.shape
    m, D = level_hvs.shape
    dev = levels.device
    if out is None:
        out = torch.empty((B, D), dtype=torch.int8, device=dev)
    dtype = torch.float16 if dev.type == "cuda" else torch.float32
    table = (id_hvs.to(dtype)[:, None, :]
             * level_hvs.to(dtype)[None, :, :]).reshape(F * m, D)
    f_idx = torch.arange(F, device=dev, dtype=torch.int64)
    for r0 in range(0, B, block):
        lv = levels[r0:r0 + block].to(torch.int64)
        present = lv > 0
        rows, cols = present.nonzero(as_tuple=True)
        idx = f_idx[cols] * m + lv[rows, cols].clamp(0, m - 1)
        counts = present.sum(dim=1)
        offsets = torch.cumsum(counts, 0) - counts
        acc = torch.nn.functional.embedding_bag(idx, table, offsets,
                                                mode="sum")
        out[r0:r0 + block] = torch.where(acc > 0, 1, -1).to(torch.int8)
    return out


def pack_words(hv: torch.Tensor) -> torch.Tensor:
    """(B, D) bipolar -> (B, D / 32) int32 words in the storage form."""
    B, D = hv.shape
    bits = (hv > 0).to(torch.int64).reshape(B, D // 32, 32)
    weights = torch.ones(32, dtype=torch.int64, device=hv.device) << (
        torch.arange(32, device=hv.device))
    words = (bits * weights).sum(dim=-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32,
                       words).to(torch.int32)


def cells(hv: torch.Tensor, cell_bits: int) -> torch.Tensor:
    """Sums of ``cell_bits`` adjacent dimensions, int8 in [-n, n]."""
    if cell_bits == 1:
        return hv
    B, D = hv.shape
    return hv.reshape(B, D // cell_bits, cell_bits).sum(dim=-1,
                                                        dtype=torch.int8)


def sorted_positions(decoy_prec: np.ndarray | None, target_prec: np.ndarray
                     ) -> np.ndarray:
    """Stored position of each original row of ``[decoys; targets]`` when
    each block is sorted stably by its float32 precursor."""
    blocks = [] if decoy_prec is None else [np.asarray(decoy_prec,
                                                       np.float32)]
    blocks.append(np.asarray(target_prec, np.float32))
    pos, base = [], 0
    for b in blocks:
        order = np.argsort(b, kind="stable")
        p = np.empty(b.shape[0], np.int64)
        p[order] = np.arange(b.shape[0]) + base
        pos.append(p)
        base += b.shape[0]
    return np.concatenate(pos)


def scores(q: torch.Tensor, bank: torch.Tensor, block: int = 1 << 18
           ) -> torch.Tensor:
    """(S, D') x (R, D') int8 -> (S, R) int32 dot products, exact (integer
    products, ``block`` bank rows at a time)."""
    S, Dp = q.shape
    R = bank.shape[0]
    s_pad = max(24, -(-S // 8) * 8)
    qp = torch.zeros((s_pad, Dp), dtype=torch.int8, device=q.device)
    qp[:S] = q
    out = torch.empty((S, R), dtype=torch.int32, device=q.device)
    for r0 in range(0, R, block):
        rb = bank[r0:r0 + block]
        n = rb.shape[0]
        if n % 8:
            rb = torch.cat([rb, torch.zeros((8 - n % 8, Dp), dtype=torch.int8,
                                            device=rb.device)])
        out[:, r0:r0 + n] = torch._int_mm(qp, rb.t())[:S, :n]
    return out


def topk(score: torch.Tensor, k: int, dim: int, position: torch.Tensor,
         allowed: torch.Tensor | None = None
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of (S, R) ``score`` by (score desc, ``position`` asc), with
    rows outside ``allowed`` scoring ``INT32_MIN``. ``position`` (R,) is
    each row's stored position. Returns (rows (S, k) int64 in the original
    order, values (S, k) int32)."""
    R = score.shape[1]
    shift = max(1, int(R - 1).bit_length())
    top = (dim - score.to(torch.int64))
    if allowed is not None:
        top = torch.where(allowed, top, torch.full_like(top, 2 * dim + 1))
    key = (top << shift) | position[None, :].to(torch.int64)
    best, rows = torch.topk(key, k, dim=1, largest=False, sorted=True)
    hi = best >> shift
    vals = torch.where(hi == 2 * dim + 1, torch.full_like(hi, INT32_MIN),
                       dim - hi).to(torch.int32)
    return rows, vals


def window(row_prec: torch.Tensor, q_prec: torch.Tensor, tol: float,
           open_tol: float) -> torch.Tensor:
    """(S, R) bool: ``q - ref`` in ``(-tol, open_tol)``, in float32."""
    q = q_prec.to(torch.float32)
    lo = q - torch.tensor(open_tol, dtype=torch.float32, device=q.device)
    hi = q + torch.tensor(tol, dtype=torch.float32, device=q.device)
    r = row_prec.to(torch.float32)[None, :]
    return (r > lo[:, None]) & (r < hi[:, None])


def search(q_hv: torch.Tensor, bank_hv: torch.Tensor, k: int, *,
           position: torch.Tensor, row_prec: torch.Tensor | None = None,
           q_prec: torch.Tensor | None = None, tol: float = 0.0,
           open_tol: float = 0.0, cell_bits: int = 1, rows_at_once: int = 64
           ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Top-k of each query over the bank (original order ``[decoys;
    targets]``); with ``row_prec`` an open search inside each query's
    window. Returns (rows (S, k), values (S, k), has_candidate (S,)) on
    the host."""
    dim = q_hv.shape[1]
    bank = cells(bank_hv, cell_bits) if cell_bits > 1 else bank_hv
    rows, vals, valid = [], [], []
    for s0 in range(0, q_hv.shape[0], rows_at_once):
        q = cells(q_hv[s0:s0 + rows_at_once], cell_bits)
        sc = scores(q, bank)
        allowed = None
        if row_prec is not None:
            allowed = window(row_prec, q_prec[s0:s0 + rows_at_once], tol,
                             open_tol)
            valid.append(allowed.any(dim=1).cpu().numpy())
        else:
            valid.append(np.ones(q.shape[0], bool))
        r, v = topk(sc, k, dim, position, allowed)
        rows.append(r.cpu().numpy())
        vals.append(v.cpu().numpy())
        del sc, allowed
    return (np.concatenate(rows), np.concatenate(vals),
            np.concatenate(valid))


def fdr(top_row: np.ndarray, top_val: np.ndarray, num_decoys: int,
        rate: float, valid: np.ndarray | None = None
        ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Target-decoy FDR over one batch, in its order. Returns (is_target,
    accept, match): ``match`` is the accepted target's row in the target
    block, -1 otherwise."""
    n = top_row.shape[0]
    valid = np.ones(n, bool) if valid is None else np.asarray(valid, bool)
    is_target = np.asarray(top_row) >= num_decoys
    order = np.argsort(-np.asarray(top_val, np.int64), kind="stable")
    t = (is_target & valid)[order]
    d = (~is_target & valid)[order]
    n_t = np.cumsum(t, dtype=np.int64).astype(np.int32)
    n_d = np.cumsum(d, dtype=np.int64).astype(np.int32)
    running = n_d.astype(np.float32) / np.maximum(n_t, 1).astype(np.float32)
    ok = running <= np.float32(rate)
    pos = np.arange(1, n + 1)
    last = int(pos[ok].max()) if ok.any() else 0
    accept_sorted = (pos <= last) & t
    accept = np.zeros(n, bool)
    accept[order] = accept_sorted
    match = np.where(accept, np.asarray(top_row) - num_decoys, -1)
    return is_target & valid, accept, match
