"""Fused encode -> pack -> streaming top-k: the CUDA kernel's wrapper and
its plain PyTorch version.

Replaces ``repro.kernels.encode_search.encode_search_pallas`` (TPU kernel
``encode_search.py:_encode_search_kernel``). The kernel is
``csrc/encode_search.cu``; see its header for the bound on the H100 and
the design. The kernel reads the codebooks bit-packed
(:func:`pack_codebook`); callers that search repeatedly pass them in
``codebook_words`` so they are packed once. :func:`encode_search_plain`
is also the counterpart of the reference's staged ``ref.py`` oracle.

Dispatch: CPU tensors take :func:`encode_search_plain`; CUDA tensors
launch the kernel or raise. Nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as nnf

from repro_torch.core.hd.encoding import encode_levels_batch
from repro_torch.core.hd.similarity import bitpack_bipolar
from repro_torch.kernels import _build
from repro_torch.kernels.topk_hamming.ops import (
    check_aligned,
    check_merge_fits,
    check_status,
    pick_block_q,
    smem_limit,
    split_rows,
    topk_hamming_plain,
    words_per_row,
)

MAX_FEATURES = 1 << 16   # the bit-sliced counters hold counts below 2**16


def _check_operands(levels, id_hvs, level_hvs, r, k) -> bool:
    """Validates the operands; returns True for packed (int32) banks."""
    if levels.ndim != 2 or id_hvs.ndim != 2 or level_hvs.ndim != 2:
        raise ValueError(f"bad operand ranks {tuple(levels.shape)} / "
                         f"{tuple(id_hvs.shape)} / {tuple(level_hvs.shape)}")
    F, D = id_hvs.shape
    if levels.shape[1] != F or level_hvs.shape[1] != D:
        raise ValueError(f"codebook shapes disagree: levels "
                         f"{tuple(levels.shape)}, id {tuple(id_hvs.shape)}, "
                         f"level {tuple(level_hvs.shape)}")
    packed = r.dtype == torch.int32
    if packed:
        if D % 32 != 0 or r.shape[1] != D // 32:
            raise ValueError(f"packed bank width {r.shape[1]} != D/32 "
                             f"for D={D}")
    elif r.dtype == torch.int8:
        if r.shape[1] != D:
            raise ValueError(f"bank width {r.shape[1]} != D={D}")
    else:
        raise ValueError(f"expected int32 (packed) or int8 bank, got "
                         f"{r.dtype}")
    if not 1 <= k <= r.shape[0]:
        raise ValueError(f"k={k} must be in [1, {r.shape[0]}]")
    devs = {t.device for t in (levels, id_hvs, level_hvs, r)}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {devs}")
    return packed


def pack_codebook(hv: torch.Tensor) -> torch.Tensor:
    """(n, D) bipolar codebook -> (n, ceil(D/32)) int32 words in the
    ``bitpack_bipolar`` order; pad dims pack as bit 0."""
    D = hv.shape[1]
    pad = (-D) % 32
    if pad:
        hv = nnf.pad(hv, (0, pad), value=-1)
    return bitpack_bipolar(hv)


def encode_queries_plain(levels, id_hvs, level_hvs, *, packed: bool
                         ) -> torch.Tensor:
    """Staged query encoding: Eq. 1 -> bank storage form."""
    hv = encode_levels_batch(levels, id_hvs, level_hvs)
    return bitpack_bipolar(hv) if packed else hv


def encode_search_plain(levels, id_hvs, level_hvs, r, *, dim: int, k: int,
                        num_valid: int | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version: ``encode_levels_batch`` -> ``bitpack_bipolar``
    (packed banks) -> :func:`topk_hamming_plain`."""
    packed = _check_operands(levels, id_hvs, level_hvs, r, k)
    q = encode_queries_plain(levels, id_hvs, level_hvs, packed=packed)
    return topk_hamming_plain(q, r, dim=dim, k=k, num_valid=num_valid)


def _launcher():
    fn = _build.load("encode_search").encode_search_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, i, i, i, p, p, i, i, p, i, i, i, i, i, i, i, i, i, i, i,
                   p, p, p, p, p]
    fn.restype = i
    return fn


def encode_search(levels: torch.Tensor, id_hvs: torch.Tensor,
                  level_hvs: torch.Tensor, r: torch.Tensor, *, dim: int,
                  k: int, num_valid: int | None = None,
                  codebook_words: tuple[torch.Tensor, torch.Tensor] | None
                  = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused query pipeline: raw (Q, F) levels -> (idx (Q, k), vals (Q, k))
    int32, bit-identical to :func:`encode_search_plain` (tie order and
    ``num_valid`` masking included). ``r`` is a packed (R, D/32) int32
    bank or an int8 (R, D) bank.

    codebook_words: ``(pack_codebook(id_hvs), pack_codebook(level_hvs))``
    when the caller holds them; packed here otherwise. CPU tensors run
    the plain version; CUDA tensors launch ``csrc/encode_search.cu``
    (counted in ``encode_search.launches``) or raise."""
    if not levels.is_cuda and levels.device.type == "cpu":
        return encode_search_plain(levels, id_hvs, level_hvs, r, dim=dim,
                                   k=k, num_valid=num_valid)
    if not levels.is_cuda:
        raise ValueError(f"unsupported device {levels.device}")
    packed = _check_operands(levels, id_hvs, level_hvs, r, k)
    if levels.dtype != torch.int32:
        raise ValueError(f"levels must be int32, got {levels.dtype}")
    if not (levels.is_contiguous() and r.is_contiguous()):
        raise ValueError("encode_search needs contiguous levels and bank")
    F, D = id_hvs.shape
    if F >= MAX_FEATURES:
        raise ValueError(f"F={F} features exceed the kernel's counters "
                         f"(< {MAX_FEATURES})")
    launch = _launcher()
    if codebook_words is None:
        codebook_words = (pack_codebook(id_hvs), pack_codebook(level_hvs))
    id_words, lv_words = (w.contiguous() for w in codebook_words)
    wc = -(-D // 32)
    if id_words.shape != (F, wc) or lv_words.shape != (level_hvs.shape[0],
                                                       wc):
        raise ValueError("codebook_words do not match the codebooks")
    Q, R = levels.shape[0], r.shape[0]
    vals = torch.empty((Q, k), dtype=torch.int32, device=levels.device)
    idx = torch.empty_like(vals)
    if Q == 0:
        return idx, vals
    row_bytes = r.shape[1] * r.element_size()
    check_aligned(r, row_bytes)
    wpr, qstride = words_per_row(row_bytes)
    bq = pick_block_q(Q, qstride, k, 4, smem_limit(levels.device))
    check_merge_fits(k, levels.device)
    rows_per_split, splits = split_rows(Q, R, bq, levels.device)
    cand_v = torch.empty((Q, splits, k), dtype=torch.int32,
                         device=levels.device)
    cand_i = torch.empty_like(cand_v)
    with torch.cuda.device(levels.device):  # the launch targets the current device
        err = launch(levels.data_ptr(), Q, F, int(level_hvs.shape[0]),
                     id_words.data_ptr(), lv_words.data_ptr(), wc, D,
                     r.data_ptr(), R, row_bytes, wpr, qstride,
                     0 if packed else 1, int(dim), int(k),
                     R if num_valid is None else min(int(num_valid), R), bq,
                     rows_per_split, splits, cand_v.data_ptr(),
                     cand_i.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                     torch.cuda.current_stream(levels.device).cuda_stream)
    check_status(err, "encode_search")
    encode_search.launches += 1
    return idx, vals


encode_search.launches = 0
