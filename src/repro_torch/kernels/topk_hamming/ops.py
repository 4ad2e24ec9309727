"""Streaming top-k Hamming search, exact and banded: the CUDA kernels'
wrappers and their plain PyTorch versions.

Replaces ``repro.kernels.topk_hamming.topk_hamming_pallas`` (TPU kernel
``topk_hamming.py:_topk_kernel``) and ``topk_hamming_banded_pallas``
(``topk_hamming.py:_topk_banded_kernel``, the OMS twin: each query
scores only the rows of its own precursor bands). Both kernels are in
``csrc/topk_hamming.cu``; see its header for the bound on the H100 and
the design. :func:`topk_hamming_plain` and
:func:`topk_hamming_banded_plain` are also the counterparts of the
reference's ``ref.py`` oracles; :func:`canonicalize_overflow_slots` is
the reference's function of that name.

Launch shape: the query block (``block_q``) and the split count (``waves``,
target blocks per SM) resolve through ``kernels.block_utils``: an explicit
argument, else the active tuning table, else the fixed rules
(:func:`pick_block_q`, 4 blocks per SM). They change the time, never the
result.

Dispatch: CPU tensors take the plain versions (explicit knobs are checked,
then ignored: the plain versions have no blocks); CUDA tensors launch the
kernels or raise. Nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.hd.similarity import (
    INT32_MIN,
    dot_similarity,
    hamming_similarity_packed,
    topk_value_desc_index_asc,
)
from repro_torch.kernels import _build
from repro_torch.kernels.block_utils import (
    AUTO,
    check_overrides,
    resolve_blocks,
)

TILE_ROWS = 128          # bank rows per tile (hd_common.cuh kTileRows)
BANDED_BLOCK_Q = 8       # queries per block of the banded kernels, and the
                         # block the OMS plan prices its tile budget for: the
                         # server sorts each batch by precursor, so 8
                         # adjacent queries keep a block's window narrow
TILE_WORDS = 128 * 36    # shared words of the staged tile (kTileWords)
BLOCK_Q_CHOICES = (8, 16, 32)
MERGE_WARPS = 8          # queries per merge block (hd_common.cuh kWarps)


def _check_operands(q: torch.Tensor, r: torch.Tensor, k: int) -> bool:
    """Validates the operands; returns True for packed (int32) banks."""
    if q.ndim != 2 or r.ndim != 2 or q.shape[1] != r.shape[1]:
        raise ValueError(f"bad operand shapes {tuple(q.shape)} x "
                         f"{tuple(r.shape)}")
    if q.dtype != r.dtype:
        raise ValueError(f"dtype mismatch {q.dtype} vs {r.dtype}")
    if q.dtype not in (torch.int32, torch.int8):
        raise ValueError(f"expected int32 (packed) or int8, got {q.dtype}")
    if q.device != r.device:
        raise ValueError(f"device mismatch {q.device} vs {r.device}")
    if not 1 <= k <= r.shape[0]:
        raise ValueError(f"k={k} must be in [1, {r.shape[0]}]")
    return q.dtype == torch.int32


def _num_valid(num_valid, R: int) -> int:
    return R if num_valid is None else min(int(num_valid), R)


def scores_plain(q: torch.Tensor, r: torch.Tensor, dim: int) -> torch.Tensor:
    """(Q, R) int32 dot-scale scores: ``dim - 2 * popcount(q ^ r)`` for
    packed words, the integer dot for int8."""
    if q.dtype == torch.int32:
        return 2 * hamming_similarity_packed(q, r, dim) - dim
    return dot_similarity(q, r)


def topk_hamming_plain(q: torch.Tensor, r: torch.Tensor, *, dim: int, k: int,
                       num_valid: int | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version: the (Q, R) score matrix, rows at or past
    ``num_valid`` masked to ``INT32_MIN``, then
    :func:`topk_value_desc_index_asc`. Returns (idx, vals), int32."""
    _check_operands(q, r, k)
    R = r.shape[0]
    scores = scores_plain(q, r, dim)
    nv = _num_valid(num_valid, R)
    if nv < R:
        scores[:, max(nv, 0):] = INT32_MIN
    vals, idx = topk_value_desc_index_asc(scores, k)
    return idx.to(torch.int32), vals


def words_per_row(row_bytes: int) -> tuple[int, int]:
    """(words a row spans, that rounded up to 4: the shared row stride)."""
    wpr = -(-row_bytes // 4)
    return wpr, -(-wpr // 4) * 4


def smem_limit(device: torch.device) -> int:
    """Bytes of shared memory one block may opt into on ``device``."""
    return getattr(torch.cuda.get_device_properties(device),
                   "shared_memory_per_block_optin", 232448)


def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def block_smem(bq: int, qstride: int, k: int, extra_words: int) -> int:
    """Shared bytes of a ``bq``-query block: its resident words, the bank
    tile and the top-k lists."""
    return 4 * (bq * qstride + TILE_WORDS + 2 * bq * k + extra_words)


def pick_block_q(Q: int, qstride: int, k: int, extra_words: int,
                 limit: int) -> int:
    """The query block (8, 16 or 32 queries) for a batch of ``Q``: the
    smallest that covers ``Q``, else the largest, among those whose
    resident words, bank tile and top-k lists fit in ``limit`` bytes of
    shared memory. Every query slot of a block is scored whether or not
    it holds a query, so a block wider than ``Q`` wastes scan work.
    Raises where no block fits."""
    fits = [bq for bq in BLOCK_Q_CHOICES
            if block_smem(bq, qstride, k, extra_words) <= limit]
    if not fits:
        raise ValueError(
            f"no query block fits {limit} B of shared memory at row stride "
            f"{qstride} words and k={k}")
    return next((bq for bq in fits if bq >= Q), fits[-1])


def split_rows(Q: int, R: int, bq: int, sms: int, waves: int
               ) -> tuple[int, int]:
    """(rows per split, splits): enough bank splits that the grid holds
    about ``waves`` blocks per SM, each split a whole number of tiles."""
    tiles = -(-R // TILE_ROWS)
    want = max(1, -(-waves * sms // -(-Q // bq)))
    rows = -(-tiles // min(want, tiles)) * TILE_ROWS
    return rows, -(-R // rows)


def plan_scan(Q: int, R: int, qstride: int, k: int, extra_words: int,
              limit: int, sms: int, block_q: int, waves: int
              ) -> tuple[int, int, int]:
    """(query block, rows per split, splits) of one exact launch.
    ``block_q`` 0 picks the block by the batch (:func:`pick_block_q`); an
    explicit block whose shared memory exceeds ``limit`` raises."""
    if block_q == AUTO:
        bq = pick_block_q(Q, qstride, k, extra_words, limit)
    else:
        bq = block_q
        need = block_smem(bq, qstride, k, extra_words)
        if need > limit:
            raise ValueError(f"block_q={bq} needs {need} B of shared memory "
                             f"at row stride {qstride} words and k={k}; the "
                             f"card allows {limit}")
    return (bq, *split_rows(Q, R, bq, sms, waves))


def check_merge_fits(k: int, device: torch.device) -> None:
    limit = getattr(torch.cuda.get_device_properties(device),
                    "shared_memory_per_block_optin", 232448)
    if 2 * MERGE_WARPS * k * 4 > limit:
        raise ValueError(f"k={k} too large for the split merge's lists")


def check_aligned(t: torch.Tensor, row_bytes: int) -> None:
    """The kernels read rows in 16-byte (or 4-byte) loads where the row
    length allows; the rows must then start on such a boundary."""
    need = 16 if row_bytes % 16 == 0 else 4 if row_bytes % 4 == 0 else 1
    if t.data_ptr() % need:
        raise ValueError(f"rows of {row_bytes} B must start on a {need}-byte "
                         f"boundary")


def check_status(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _launcher():
    fn = _build.load("topk_hamming").topk_hamming_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, i, i, i, i, i, i, i, i, i, i, i, p, p, p, p, p]
    fn.restype = i
    return fn


def topk_hamming(q: torch.Tensor, r: torch.Tensor, *, dim: int, k: int,
                 num_valid: int | None = None, block_q: int | None = None,
                 waves: int | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Streaming top-k: (Q, W) x (R, W) int32 words (or (Q, D) x (R, D)
    int8) -> (idx (Q, k), vals (Q, k)) int32, ordered (score desc, row
    asc) as ``lax.top_k`` orders them. Rows at or past ``num_valid`` score
    ``INT32_MIN`` and stay candidates.

    block_q / waves: launch knobs (``kernels.block_utils``); None
    resolves through the tuning table to the fixed rules.

    CPU tensors run :func:`topk_hamming_plain`; CUDA tensors launch
    ``csrc/topk_hamming.cu`` on the current stream (counted in
    ``topk_hamming.launches``) or raise."""
    knobs = {"block_q": block_q, "waves": waves}
    if not q.is_cuda and q.device.type == "cpu":
        check_overrides("topk_hamming", knobs)
        return topk_hamming_plain(q, r, dim=dim, k=k, num_valid=num_valid)
    if not q.is_cuda:
        raise ValueError(f"unsupported device {q.device}")
    packed = _check_operands(q, r, k)
    if not (q.is_contiguous() and r.is_contiguous()):
        raise ValueError("topk_hamming needs contiguous operands")
    launch = _launcher()
    Q, R = q.shape[0], r.shape[0]
    cfg = resolve_blocks("topk_hamming", (Q, R, q.shape[1]), knobs, q.device)
    vals = torch.empty((Q, k), dtype=torch.int32, device=q.device)
    idx = torch.empty_like(vals)
    if Q == 0:
        return idx, vals
    row_bytes = q.shape[1] * q.element_size()
    check_aligned(q, row_bytes)
    check_aligned(r, row_bytes)
    wpr, qstride = words_per_row(row_bytes)
    bq, rows_per_split, splits = plan_scan(
        Q, R, qstride, k, 0, smem_limit(q.device), sm_count(q.device),
        cfg["block_q"], cfg["waves"])
    check_merge_fits(k, q.device)
    cand_v = torch.empty((Q, splits, k), dtype=torch.int32, device=q.device)
    cand_i = torch.empty_like(cand_v)
    with torch.cuda.device(q.device):  # the launch targets the current device
        err = launch(q.data_ptr(), r.data_ptr(), Q, R, row_bytes, wpr, qstride,
                     0 if packed else 1, int(dim), int(k),
                     _num_valid(num_valid, R), bq, rows_per_split, splits,
                     cand_v.data_ptr(), cand_i.data_ptr(), vals.data_ptr(),
                     idx.data_ptr(), torch.cuda.current_stream(q.device).cuda_stream)
    check_status(err, "topk_hamming")
    topk_hamming.launches += 1
    return idx, vals


topk_hamming.launches = 0


# --------------------------------------------------------------------------
# banded (OMS) search
# --------------------------------------------------------------------------

def canonicalize_overflow_slots(idx: torch.Tensor, vals: torch.Tensor,
                                starts: torch.Tensor, ends: torch.Tensor,
                                num_rows) -> torch.Tensor:
    """Rewrites the ``INT32_MIN``-valued slots of a banded top-k to the
    masked full matrix's overflow indices.

    A top-k over a matrix masked outside the bands fills the slots past
    the bands' width with the lowest *masked* rows (ties at the sentinel
    go to the lower row). The banded kernels never visit most masked rows
    and leave filler indices there; this writes the m-th smallest row
    outside the bands into the m-th such slot, so the result is
    bit-identical to the masked matrix's.

    starts/ends: (B, Q) (or (Q,)) ascending disjoint bands per query,
    clipped to ``num_rows``. Returns idx with the sentinel slots
    rewritten."""
    if starts.ndim == 1:
        starts, ends = starts[None], ends[None]
    starts = starts.to(torch.int64)
    ends = ends.to(torch.int64)
    sentinel = vals == INT32_MIN
    k = idx.shape[1]
    n_real = (~sentinel).sum(dim=1, keepdim=True)
    m = torch.arange(k, device=idx.device)[None, :] - n_real  # rank among masked
    # masked rows form B + 1 runs: [0, s_0), [e_0, s_1), ..., [e_{B-1}, rows)
    run_start = [torch.zeros_like(starts[0])]
    run_len = []
    for b in range(starts.shape[0]):
        run_len.append(starts[b] - run_start[-1])
        run_start.append(ends[b])
    run_len.append(num_rows - run_start[-1])
    col = torch.zeros_like(m)
    cum = torch.zeros_like(starts[0])
    done = torch.zeros_like(sentinel)
    for rs, rl in zip(run_start, run_len):
        in_run = ~done & (m < (cum + rl)[:, None])
        col = torch.where(in_run, rs[:, None] + (m - cum[:, None]), col)
        done |= in_run
        cum = cum + rl
    return torch.where(sentinel, col.to(idx.dtype), idx)


def clip_bands(starts, lens, num_valid: int, Q: int, device: torch.device
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, Q) int32 band bounds ``[s, e)`` on ``device``, clipped as the
    reference clips them: ``s = clip(start, 0, nv)``,
    ``e = clip(start + len, s, nv)``. (Q,) inputs are one band."""
    s0 = torch.as_tensor(starts, device=device).to(torch.int32)
    ln = torch.as_tensor(lens, device=device).to(torch.int32)
    if s0.ndim == 1:
        s0, ln = s0[None], ln[None]
    if s0.ndim != 2 or s0.shape != ln.shape or s0.shape[1] != Q:
        raise ValueError(f"starts/lens must be ({Q},) or (B, {Q}), got "
                         f"{tuple(s0.shape)}/{tuple(ln.shape)}")
    nv = max(int(num_valid), 0)
    s = s0.clamp(0, nv)
    e = torch.maximum(s0 + ln, s).clamp(max=nv)
    return s.contiguous(), e.contiguous()


def topk_hamming_banded_plain(q: torch.Tensor, r: torch.Tensor, starts, lens,
                              *, dim: int, k: int,
                              num_valid: int | None = None
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version: the (Q, R) score matrix masked to ``INT32_MIN``
    outside each query's bands ``[start, start + len)`` (the union over
    bands) and at or past ``num_valid``, then
    :func:`topk_value_desc_index_asc`. Its overflow slots are the
    canonical ones. Returns (idx, vals), int32."""
    _check_operands(q, r, k)
    R = r.shape[0]
    s, e = clip_bands(starts, lens, _num_valid(num_valid, R), q.shape[0],
                      q.device)
    scores = scores_plain(q, r, dim)
    col = torch.arange(R, dtype=torch.int32, device=q.device)[None, :]
    band = torch.zeros(scores.shape, dtype=torch.bool, device=q.device)
    for b in range(s.shape[0]):
        band |= (col >= s[b][:, None]) & (col < e[b][:, None])
    scores.masked_fill_(~band, INT32_MIN)
    vals, idx = topk_value_desc_index_asc(scores, k)
    return idx.to(torch.int32), vals


def check_banded_fits(qstride: int, k: int, extra_words: int,
                      device: torch.device) -> None:
    """Raises where a banded block (8 queries' words, the bank tile, the
    top-k lists and band bounds) does not fit in shared memory."""
    bq = BANDED_BLOCK_Q
    need = 4 * (bq * qstride + TILE_WORDS + 2 * bq * k + 2 * bq
                + extra_words)
    if need > smem_limit(device):
        raise ValueError(f"a banded block needs {need} B of shared memory "
                         f"at row stride {qstride} words and k={k}")


def banded_splits(Q: int, R: int, bands: int, num_tiles: int | None,
                  sms: int, waves: int) -> int:
    """Splits of each (query block, band) scan window: enough that the
    grid holds about ``waves`` blocks per SM, and no more than the tile
    budget ``num_tiles`` (the whole bank's tiles when None), so a window
    of that budget gives every split at least one tile."""
    tiles = -(-R // TILE_ROWS)
    budget = tiles if num_tiles is None else max(1, min(int(num_tiles), tiles))
    blocks = -(-Q // BANDED_BLOCK_Q) * bands
    return max(1, min(-(-waves * sms // blocks), budget))


def _banded_launcher():
    fn = _build.load("topk_hamming").topk_hamming_banded_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, i, i, i, i, i, i, i, p, p, i, i, p, p, p, p, p]
    fn.restype = i
    return fn


def topk_hamming_banded(q: torch.Tensor, r: torch.Tensor, starts, lens, *,
                        dim: int, k: int, num_valid: int | None = None,
                        num_tiles: int | None = None,
                        canonicalize: bool = True, waves: int | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Banded streaming top-k: each query scores only the bank rows in its
    bands ``[starts[b, q], starts[b, q] + lens[b, q])`` below
    ``num_valid`` (an OMS precursor window per bank block, over a
    precursor-sorted bank). ``starts``/``lens`` are (Q,) for one band or
    (B, Q) for B ascending disjoint bands, searched in one launch.

    Equal to :func:`topk_hamming_banded_plain` in every slot whose value
    is not ``INT32_MIN``; with ``canonicalize`` (the default) the
    remaining slots are rewritten by :func:`canonicalize_overflow_slots`
    and the whole result is bit-identical. Callers that merge several
    searches and canonicalize once, globally, pass ``canonicalize=False``.

    num_tiles: the plan's per-band tile budget of an 8-query block
    (``repro_torch.serve.oms.plan_candidates``); it only sizes the grid.
    Each block derives its scan window on the device from its own
    queries' bands, so no band row is skipped whatever the budget.

    waves: the launch knob (``kernels.block_utils``); None resolves
    through the tuning table to 4 blocks per SM.

    CPU tensors run the plain version; CUDA tensors launch
    ``csrc/topk_hamming.cu`` (counted in ``topk_hamming_banded.launches``)
    or raise."""
    knobs = {"waves": waves}
    if not q.is_cuda and q.device.type == "cpu":
        check_overrides("topk_hamming_banded", knobs)
        return topk_hamming_banded_plain(q, r, starts, lens, dim=dim, k=k,
                                         num_valid=num_valid)
    if not q.is_cuda:
        raise ValueError(f"unsupported device {q.device}")
    packed = _check_operands(q, r, k)
    if not (q.is_contiguous() and r.is_contiguous()):
        raise ValueError("topk_hamming_banded needs contiguous operands")
    launch = _banded_launcher()
    Q, R = q.shape[0], r.shape[0]
    s, e = clip_bands(starts, lens, _num_valid(num_valid, R), Q, q.device)
    cfg = resolve_blocks("topk_hamming_banded", (Q, R, q.shape[1]), knobs,
                         q.device)
    vals = torch.empty((Q, k), dtype=torch.int32, device=q.device)
    idx = torch.empty_like(vals)
    if Q == 0:
        return idx, vals
    row_bytes = q.shape[1] * q.element_size()
    check_aligned(q, row_bytes)
    check_aligned(r, row_bytes)
    wpr, qstride = words_per_row(row_bytes)
    check_banded_fits(qstride, k, 0, q.device)
    check_merge_fits(k, q.device)
    bands = s.shape[0]
    splits = banded_splits(Q, R, bands, num_tiles, sm_count(q.device),
                           cfg["waves"])
    cand_v = torch.empty((Q, bands * splits, k), dtype=torch.int32,
                         device=q.device)
    cand_i = torch.empty_like(cand_v)
    with torch.cuda.device(q.device):  # the launch targets the current device
        err = launch(q.data_ptr(), r.data_ptr(), Q, R, row_bytes, wpr, qstride,
                     0 if packed else 1, int(dim), int(k), s.data_ptr(),
                     e.data_ptr(), bands, splits, cand_v.data_ptr(),
                     cand_i.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                     torch.cuda.current_stream(q.device).cuda_stream)
    check_status(err, "topk_hamming_banded")
    topk_hamming_banded.launches += 1
    if canonicalize:
        idx = canonicalize_overflow_slots(idx, vals, s, e, R)
    return idx, vals


topk_hamming_banded.launches = 0
