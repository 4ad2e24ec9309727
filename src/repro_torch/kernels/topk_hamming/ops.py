"""Streaming top-k Hamming search: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces ``repro.kernels.topk_hamming.topk_hamming_pallas`` (TPU kernel
``topk_hamming.py:_topk_kernel``). The kernel is ``csrc/topk_hamming.cu``;
see its header for the bound on the H100 and the design.
:func:`topk_hamming_plain` is also the counterpart of the reference's
``ref.py`` oracle.

Dispatch: CPU tensors take :func:`topk_hamming_plain`; CUDA tensors
launch the kernel or raise. Nothing falls back.
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

TILE_ROWS = 128          # bank rows per tile (hd_common.cuh kTileRows)
TILE_WORDS = 128 * 36    # shared words of the staged tile (kTileWords)
BLOCK_Q_CHOICES = (8, 16, 32)
WAVES = 4                # target blocks per SM for the split count
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


def pick_block_q(Q: int, qstride: int, k: int, extra_words: int,
                 limit: int) -> int:
    """The query block (8, 16 or 32 queries) for a batch of ``Q``: the
    smallest that covers ``Q``, else the largest, among those whose
    resident words, bank tile and top-k lists fit in ``limit`` bytes of
    shared memory. Every query slot of a block is scored whether or not
    it holds a query, so a block wider than ``Q`` wastes scan work.
    Raises where no block fits."""
    fits = [bq for bq in BLOCK_Q_CHOICES
            if 4 * (bq * qstride + TILE_WORDS + 2 * bq * k + extra_words)
            <= limit]
    if not fits:
        raise ValueError(
            f"no query block fits {limit} B of shared memory at row stride "
            f"{qstride} words and k={k}")
    return next((bq for bq in fits if bq >= Q), fits[-1])


def split_rows(Q: int, R: int, bq: int, device: torch.device
               ) -> tuple[int, int]:
    """(rows per split, splits): enough bank splits that the grid holds
    about ``WAVES`` blocks per SM, each split a whole number of tiles."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    tiles = -(-R // TILE_ROWS)
    want = max(1, -(-WAVES * sms // -(-Q // bq)))
    rows = -(-tiles // min(want, tiles)) * TILE_ROWS
    return rows, -(-R // rows)


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
                 num_valid: int | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Streaming top-k: (Q, W) x (R, W) int32 words (or (Q, D) x (R, D)
    int8) -> (idx (Q, k), vals (Q, k)) int32, ordered (score desc, row
    asc) as ``lax.top_k`` orders them. Rows at or past ``num_valid`` score
    ``INT32_MIN`` and stay candidates.

    CPU tensors run :func:`topk_hamming_plain`; CUDA tensors launch
    ``csrc/topk_hamming.cu`` on the current stream (counted in
    ``topk_hamming.launches``) or raise."""
    if not q.is_cuda and q.device.type == "cpu":
        return topk_hamming_plain(q, r, dim=dim, k=k, num_valid=num_valid)
    if not q.is_cuda:
        raise ValueError(f"unsupported device {q.device}")
    packed = _check_operands(q, r, k)
    if not (q.is_contiguous() and r.is_contiguous()):
        raise ValueError("topk_hamming needs contiguous operands")
    launch = _launcher()
    Q, R = q.shape[0], r.shape[0]
    vals = torch.empty((Q, k), dtype=torch.int32, device=q.device)
    idx = torch.empty_like(vals)
    if Q == 0:
        return idx, vals
    row_bytes = q.shape[1] * q.element_size()
    check_aligned(q, row_bytes)
    check_aligned(r, row_bytes)
    wpr, qstride = words_per_row(row_bytes)
    bq = pick_block_q(Q, qstride, k, 0, smem_limit(q.device))
    check_merge_fits(k, q.device)
    rows_per_split, splits = split_rows(Q, R, bq, q.device)
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
