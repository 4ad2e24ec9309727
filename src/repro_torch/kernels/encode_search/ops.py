"""Fused encode -> pack -> streaming top-k, exact and banded: the CUDA
kernels' wrappers and their plain PyTorch versions.

Replaces ``repro.kernels.encode_search.encode_search_pallas`` (TPU kernel
``encode_search.py:_encode_search_kernel``) and
``encode_search_banded_pallas`` (``_encode_search_banded_kernel``, the
OMS twin with ``topk_hamming_banded``'s bands). Both kernels are in
``csrc/encode_search.cu``; see its header for the bound on the H100 and
the design. The kernels read the codebooks bit-packed
(:func:`pack_codebook`); callers that search repeatedly pass them in
``codebook_words`` so they are packed once. :func:`encode_search_plain`
and :func:`encode_search_banded_plain` are also the counterparts of the
reference's staged ``ref.py`` oracles.

Launch knobs (``block_q``, ``waves``) resolve as ``topk_hamming``'s do
(``kernels.block_utils``); the banded kernel has ``waves`` only.

Dispatch: CPU tensors take the plain versions (explicit knobs are checked,
then ignored); CUDA tensors launch the kernels or raise. Nothing falls
back.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as nnf

from repro_torch.core.hd.encoding import encode_levels_batch
from repro_torch.core.hd.similarity import bitpack_bipolar
from repro_torch.kernels import _build
from repro_torch.kernels.block_utils import check_overrides, resolve_blocks
from repro_torch.kernels.topk_hamming.ops import (
    banded_splits,
    canonicalize_overflow_slots,
    check_aligned,
    check_banded_fits,
    check_merge_fits,
    check_status,
    clip_bands,
    plan_scan,
    sm_count,
    smem_limit,
    topk_hamming_banded_plain,
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


def _check_kernel_operands(levels, id_hvs, level_hvs, r, k, codebook_words
                           ) -> tuple[bool, torch.Tensor, torch.Tensor]:
    """Validates the operands of a kernel launch on CUDA tensors; returns
    (packed bank, contiguous ID words, contiguous level words), packing
    the codebooks when ``codebook_words`` is None."""
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
    if codebook_words is None:
        codebook_words = (pack_codebook(id_hvs), pack_codebook(level_hvs))
    id_words, lv_words = (w.contiguous() for w in codebook_words)
    wc = -(-D // 32)
    if id_words.shape != (F, wc) or lv_words.shape != (level_hvs.shape[0],
                                                       wc):
        raise ValueError("codebook_words do not match the codebooks")
    return packed, id_words, lv_words


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
                  = None, block_q: int | None = None,
                  waves: int | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused query pipeline: raw (Q, F) levels -> (idx (Q, k), vals (Q, k))
    int32, bit-identical to :func:`encode_search_plain` (tie order and
    ``num_valid`` masking included). ``r`` is a packed (R, D/32) int32
    bank or an int8 (R, D) bank.

    codebook_words: ``(pack_codebook(id_hvs), pack_codebook(level_hvs))``
    when the caller holds them; packed here otherwise. block_q / waves:
    launch knobs, as for ``topk_hamming``. CPU tensors run the plain
    version; CUDA tensors launch ``csrc/encode_search.cu`` (counted in
    ``encode_search.launches``) or raise."""
    knobs = {"block_q": block_q, "waves": waves}
    if not levels.is_cuda and levels.device.type == "cpu":
        check_overrides("encode_search", knobs)
        return encode_search_plain(levels, id_hvs, level_hvs, r, dim=dim,
                                   k=k, num_valid=num_valid)
    packed, id_words, lv_words = _check_kernel_operands(
        levels, id_hvs, level_hvs, r, k, codebook_words)
    launch = _launcher()
    F, D = id_hvs.shape
    wc = id_words.shape[1]
    Q, R = levels.shape[0], r.shape[0]
    cfg = resolve_blocks("encode_search", (Q, R, F), knobs, levels.device)
    vals = torch.empty((Q, k), dtype=torch.int32, device=levels.device)
    idx = torch.empty_like(vals)
    if Q == 0:
        return idx, vals
    row_bytes = r.shape[1] * r.element_size()
    check_aligned(r, row_bytes)
    wpr, qstride = words_per_row(row_bytes)
    bq, rows_per_split, splits = plan_scan(
        Q, R, qstride, k, 4, smem_limit(levels.device),
        sm_count(levels.device), cfg["block_q"], cfg["waves"])
    check_merge_fits(k, levels.device)
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


def encode_search_banded_plain(levels, id_hvs, level_hvs, r, starts, lens, *,
                               dim: int, k: int,
                               num_valid: int | None = None
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version: ``encode_levels_batch`` -> ``bitpack_bipolar``
    (packed banks) -> :func:`topk_hamming_banded_plain`."""
    packed = _check_operands(levels, id_hvs, level_hvs, r, k)
    q = encode_queries_plain(levels, id_hvs, level_hvs, packed=packed)
    return topk_hamming_banded_plain(q, r, starts, lens, dim=dim, k=k,
                                     num_valid=num_valid)


def _banded_launcher():
    fn = _build.load("encode_search").encode_search_banded_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, i, i, i, p, p, i, i, p, i, i, i, i, i, i, i, p, p, i, i,
                   p, p, p, p, p]
    fn.restype = i
    return fn


def encode_search_banded(levels: torch.Tensor, id_hvs: torch.Tensor,
                         level_hvs: torch.Tensor, r: torch.Tensor, starts,
                         lens, *, dim: int, k: int,
                         num_valid: int | None = None,
                         num_tiles: int | None = None,
                         canonicalize: bool = True,
                         codebook_words: tuple[torch.Tensor, torch.Tensor]
                         | None = None, waves: int | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Banded fused query pipeline: raw (Q, F) levels, each spectrum
    scoring only the bank rows of its bands. Same contract as
    ``topk_hamming_banded`` (bands, clipping, ``num_tiles``,
    ``canonicalize``, ``waves``) with the encode fused in, and
    bit-identical to :func:`encode_search_banded_plain` in the same way.

    CPU tensors run the plain version; CUDA tensors launch
    ``csrc/encode_search.cu`` (counted in
    ``encode_search_banded.launches``) or raise."""
    knobs = {"waves": waves}
    if not levels.is_cuda and levels.device.type == "cpu":
        check_overrides("encode_search_banded", knobs)
        return encode_search_banded_plain(levels, id_hvs, level_hvs, r,
                                          starts, lens, dim=dim, k=k,
                                          num_valid=num_valid)
    packed, id_words, lv_words = _check_kernel_operands(
        levels, id_hvs, level_hvs, r, k, codebook_words)
    launch = _banded_launcher()
    F, D = id_hvs.shape
    wc = id_words.shape[1]
    Q, R = levels.shape[0], r.shape[0]
    nv = R if num_valid is None else min(int(num_valid), R)
    s, e = clip_bands(starts, lens, nv, Q, levels.device)
    cfg = resolve_blocks("encode_search_banded", (Q, R, F), knobs,
                         levels.device)
    vals = torch.empty((Q, k), dtype=torch.int32, device=levels.device)
    idx = torch.empty_like(vals)
    if Q == 0:
        return idx, vals
    row_bytes = r.shape[1] * r.element_size()
    check_aligned(r, row_bytes)
    wpr, qstride = words_per_row(row_bytes)
    check_banded_fits(qstride, k, 4, levels.device)
    check_merge_fits(k, levels.device)
    bands = s.shape[0]
    splits = banded_splits(Q, R, bands, num_tiles, sm_count(levels.device),
                           cfg["waves"])
    cand_v = torch.empty((Q, bands * splits, k), dtype=torch.int32,
                         device=levels.device)
    cand_i = torch.empty_like(cand_v)
    with torch.cuda.device(levels.device):  # the launch targets the current device
        err = launch(levels.data_ptr(), Q, F, int(level_hvs.shape[0]),
                     id_words.data_ptr(), lv_words.data_ptr(), wc, D,
                     r.data_ptr(), R, row_bytes, wpr, qstride,
                     0 if packed else 1, int(dim), int(k), s.data_ptr(),
                     e.data_ptr(), bands, splits, cand_v.data_ptr(),
                     cand_i.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                     torch.cuda.current_stream(levels.device).cuda_stream)
    check_status(err, "encode_search_banded")
    encode_search_banded.launches += 1
    if canonicalize:
        idx = canonicalize_overflow_slots(idx, vals, s, e, R)
    return idx, vals


encode_search_banded.launches = 0
