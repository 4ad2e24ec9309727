"""ID-level HD encoding (Eq. 1): the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces ``repro.kernels.hd_encode.hd_encode_pallas`` (TPU kernel
``hd_encode.py:_hd_encode_kernel``). The kernel is ``csrc/hd_encode.cu``;
see its header for the bound on the H100 and the design.
:func:`hd_encode_plain` is the counterpart of the reference's ``ref.py``
oracle ``hd_encode_ref``: levels past ``m - 1`` read ``LV[m - 1]``, as its
clamped gather does (the TPU kernel's one-hot gives 0 there).

Launch knobs ``block_b`` (queries per block) and ``block_d`` (dims per
block, a multiple of 32) resolve through ``kernels.block_utils``; they
change the time, never the result.

Dispatch: CPU tensors take the plain version (explicit knobs are checked,
then ignored); CUDA tensors launch the kernel or raise. Nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.hd.encoding import encode_levels_batch
from repro_torch.kernels import _build
from repro_torch.kernels.block_utils import check_overrides, resolve_blocks
from repro_torch.kernels.encode_search.ops import MAX_FEATURES, pack_codebook
from repro_torch.kernels.topk_hamming.ops import check_status, smem_limit

CAP = 1024            # present (feature, level) pairs compacted at once
                      # (hd_encode.cu kCap)
MAX_GRID_Y = 65535    # CUDA's limit on the grid's dim-block axis


def _check_operands(levels, id_hvs, level_hvs) -> None:
    if levels.ndim != 2 or id_hvs.ndim != 2 or level_hvs.ndim != 2:
        raise ValueError(f"bad operand ranks {tuple(levels.shape)} / "
                         f"{tuple(id_hvs.shape)} / {tuple(level_hvs.shape)}")
    if levels.shape[1] != id_hvs.shape[0] \
            or id_hvs.shape[1] != level_hvs.shape[1]:
        raise ValueError(f"codebook shapes disagree: levels "
                         f"{tuple(levels.shape)}, id {tuple(id_hvs.shape)}, "
                         f"level {tuple(level_hvs.shape)}")
    if level_hvs.shape[0] < 1:
        raise ValueError("the level codebook is empty")
    devs = {t.device for t in (levels, id_hvs, level_hvs)}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {devs}")


def hd_encode_plain(levels: torch.Tensor, id_hvs: torch.Tensor,
                    level_hvs: torch.Tensor) -> torch.Tensor:
    """The plain version: the port's Eq. 1 encoder
    (``core.hd.encoding.encode_levels_batch``), the sum
    ``acc[b, d] = sum_f [l > 0] LV[min(l, m - 1), d] * ID[f, d]`` in int32,
    then ``acc > 0 ? 1 : -1`` as int8."""
    _check_operands(levels, id_hvs, level_hvs)
    return encode_levels_batch(levels, id_hvs, level_hvs)


def _launcher():
    fn = _build.load("hd_encode").hd_encode_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, i, i, i, p, p, i, i, i, i, p, p]
    fn.restype = i
    return fn


def hd_encode(levels: torch.Tensor, id_hvs: torch.Tensor,
              level_hvs: torch.Tensor, *, block_b: int | None = None,
              block_d: int | None = None,
              codebook_words: tuple[torch.Tensor, torch.Tensor] | None = None
              ) -> torch.Tensor:
    """(B, F) int32 levels + bipolar int8 codebooks (F, D) and (m, D) ->
    (B, D) bipolar int8 hypervectors, bit-identical to
    :func:`hd_encode_plain`.

    codebook_words: ``(pack_codebook(id_hvs), pack_codebook(level_hvs))``
    when the caller holds them; packed here otherwise. block_b / block_d:
    launch knobs (``kernels.block_utils``). CPU tensors run the plain
    version; CUDA tensors launch ``csrc/hd_encode.cu`` on the current
    stream (counted in ``hd_encode.launches``) or raise."""
    knobs = {"block_b": block_b, "block_d": block_d}
    if not levels.is_cuda and levels.device.type == "cpu":
        check_overrides("hd_encode", knobs)
        return hd_encode_plain(levels, id_hvs, level_hvs)
    if not levels.is_cuda:
        raise ValueError(f"unsupported device {levels.device}")
    _check_operands(levels, id_hvs, level_hvs)
    if levels.dtype != torch.int32 or not levels.is_contiguous():
        raise ValueError(f"levels must be contiguous int32, got "
                         f"{levels.dtype}")
    B, F = levels.shape
    m, D = level_hvs.shape
    if F >= MAX_FEATURES:
        raise ValueError(f"F={F} features exceed the kernel's counters "
                         f"(< {MAX_FEATURES})")
    launch = _launcher()
    cfg = resolve_blocks("hd_encode", (B, D, F), knobs, levels.device)
    bb, bd = cfg["block_b"], cfg["block_d"]
    need = bd + 8 * CAP + 16
    if need > smem_limit(levels.device):
        raise ValueError(f"block_d={bd} needs {need} B of shared memory; the "
                         f"card allows {smem_limit(levels.device)}")
    wc = -(-D // 32)
    if -(-wc // (bd // 32)) > MAX_GRID_Y:
        raise ValueError(f"D={D} needs more than {MAX_GRID_Y} blocks of "
                         f"block_d={bd} dims")
    if codebook_words is None:
        codebook_words = (pack_codebook(id_hvs), pack_codebook(level_hvs))
    id_words, lv_words = (w.contiguous() for w in codebook_words)
    if id_words.shape != (F, wc) or lv_words.shape != (m, wc):
        raise ValueError("codebook_words do not match the codebooks")
    out = torch.empty((B, D), dtype=torch.int8, device=levels.device)
    if B == 0 or D == 0:
        return out
    with torch.cuda.device(levels.device):  # the launch targets the current device
        err = launch(levels.data_ptr(), B, F, m, id_words.data_ptr(),
                     lv_words.data_ptr(), wc, D, bb, bd, out.data_ptr(),
                     torch.cuda.current_stream(levels.device).cuda_stream)
    check_status(err, "hd_encode")
    hd_encode.launches += 1
    return out


hd_encode.launches = 0
