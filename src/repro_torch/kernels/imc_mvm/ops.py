"""Analog PCM in-memory MVM model: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces ``repro.kernels.imc_mvm.imc_mvm_pallas`` (TPU kernel
``imc_mvm.py:_imc_mvm_kernel``), the array model of
``repro.core.imc.array.imc_mvm_reference``: per ``tile_cols``-column tile
(one PCM array) the DAC rounds and clamps the query, the tile's partial
dot product is taken in float32, the ADC quantizes it to a code, and the
codes times ``lsb`` accumulate tile by tile. The kernel is
``csrc/imc_mvm.cu``; see its header for the bound on the H100 and the
design.

Both versions take each partial sum as a chain of fused multiply-adds,
``part = fmaf(a_c, w_c, part)`` column by column, c = 0 first (one
rounding per column: the kernel's FMA pipe issues one instruction per
product, where a separate rounded multiply and add took two), and
accumulate the tiles in order, t = 0 first, each step
``fmaf(code, lsb, acc)``, as the reference's kernel accumulates (XLA
fuses that multiply-add). So on the same inputs they agree bit for bit.
The reference sums each tile's dot product in XLA's order, so against it
float weights agree to a tolerance; integer-valued weights make the
partials exact and the results bit-identical to the reference's kernel.
(The reference's oracles ``imc_mvm_ref`` and ``imc_mvm_reference`` round
``code * lsb`` before summing, so they differ from its kernel, and from
the port, by an ulp.) ``lsb`` is ``full_scale / adc_levels`` in double,
rounded once to float32, as the reference's Python scalar is.

``tile_cols`` is the array's column count (``ArrayConfig.cols``), not a
launch knob: another value computes another function. The launch knobs
``block_q`` / ``block_r`` (the output tile) resolve through
``kernels.block_utils``.

Dispatch: CPU tensors (and ``meta`` tensors, which the dry run traces)
take the plain version (explicit knobs are checked, then ignored); CUDA
tensors launch the kernel or raise. Nothing falls back.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as nnf

from repro_torch.kernels import _build
from repro_torch.kernels.block_utils import check_overrides, resolve_blocks
from repro_torch.kernels.topk_hamming.ops import check_status

MAX_GRID_Y = 65535    # CUDA's limit on the grid's query-tile axis
CHUNK_ROWS = 1 << 16  # weight rows per block of the plain version
DAC_LIMIT_MAX = 1 << 24  # integers from 2**24 + 1 up are not all exact in float32


def lsb_of(full_scale: float, adc_levels: int) -> float:
    """The ADC step as the kernel and the plain version use it:
    ``full_scale / adc_levels`` in double, rounded once to float32."""
    return float(np.float32(float(full_scale) / int(adc_levels)))


def _check_operands(queries, weights, tile_cols, dac_limit, adc_levels
                    ) -> None:
    if queries.ndim != 2 or weights.ndim != 2 \
            or queries.shape[1] != weights.shape[1] or queries.shape[1] < 1:
        raise ValueError(f"bad operand shapes {tuple(queries.shape)} x "
                         f"{tuple(weights.shape)}")
    if queries.device != weights.device:
        raise ValueError(f"device mismatch {queries.device} vs "
                         f"{weights.device}")
    if not (isinstance(tile_cols, int) and tile_cols > 0):
        raise ValueError(f"tile_cols={tile_cols!r} must be a positive int "
                         f"(the PCM array's column count)")
    if dac_limit < 0 or adc_levels < 1:
        raise ValueError(f"dac_limit={dac_limit} and adc_levels={adc_levels} "
                         f"must be >= 0 and >= 1")
    if dac_limit >= DAC_LIMIT_MAX:
        raise ValueError(f"dac_limit={dac_limit} must be < 2**24: the "
                         f"kernel clamps the DAC-rounded query to it in "
                         f"float32, where larger integers are not exact")


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
            ) -> torch.Tensor:
    """``fmaf(a, b, c)`` elementwise on float32 tensors: ``a * b + c``
    rounded once to float32 (round to nearest, ties to even), as the CUDA
    FMA computes it.

    The product of two float32 values is exact in float64. A TwoSum gives
    the float64 sum ``s`` and its exact error ``e``; where ``e != 0`` and
    ``s``'s last mantissa bit is even, ``s`` moves one ulp toward ``e``
    (rounding to odd), so the one cast to float32 rounds the exact value,
    never a float64 tie that rounding had made."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    to_odd = (e != 0) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.copysign(torch.full_like(s, float("inf")), e)
    return torch.where(to_odd, torch.nextafter(s, toward), s).float()


def imc_mvm_plain(queries: torch.Tensor, weights: torch.Tensor, *,
                  full_scale: float, tile_cols: int = 128,
                  dac_limit: int = 3, adc_levels: int = 31) -> torch.Tensor:
    """The plain version: per-tile partials as a chain of float32 fused
    multiply-adds over the tile's columns (:func:`fma_f32`), then the
    ADC, then a sequential accumulation over the tiles, t = 0 first, each
    step ``fmaf(code, lsb, acc)``; weights in blocks of
    :data:`CHUNK_ROWS` rows. (Q, Dp) x (R, Dp) -> (Q, R) float32. Counts
    its calls in ``imc_mvm_plain.calls``."""
    imc_mvm_plain.calls += 1
    _check_operands(queries, weights, tile_cols, dac_limit, adc_levels)
    dev = queries.device
    q = torch.clamp(torch.round(queries.to(torch.float32)), -dac_limit,
                    dac_limit)
    Q, Dp = q.shape
    R = weights.shape[0]
    T = -(-Dp // tile_cols)
    pad = T * tile_cols - Dp
    qt = nnf.pad(q, (0, pad)).view(Q, T, tile_cols)
    # a float32 tensor on the operands' device: a CPU scalar divisor may
    # become a multiply by its reciprocal
    lsb = torch.tensor(lsb_of(full_scale, adc_levels), dtype=torch.float32,
                       device=dev)
    out = torch.empty((Q, R), dtype=torch.float32, device=dev)
    for r0 in range(0, R, CHUNK_ROWS):
        w = nnf.pad(weights[r0:r0 + CHUNK_ROWS].to(torch.float32), (0, pad))
        # (tile_cols, rows, T): each column's slice contiguous
        wt = w.view(-1, T, tile_cols).permute(2, 0, 1).contiguous()
        part = torch.zeros((Q, wt.shape[1], T), dtype=torch.float32,
                           device=dev)
        for c in range(tile_cols):
            part = fma_f32(qt[:, None, :, c], wt[c][None], part)
        code = torch.clamp(torch.round(part / lsb), -adc_levels, adc_levels)
        acc = torch.zeros((Q, wt.shape[1]), dtype=torch.float32, device=dev)
        for t in range(T):
            acc = fma_f32(code[:, :, t], lsb, acc)
        out[:, r0:r0 + CHUNK_ROWS] = acc
    return out


imc_mvm_plain.calls = 0


def _launcher():
    lib = _build.load("imc_mvm")
    fn = lib.imc_mvm_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, i, i, i, i, i, ctypes.c_float, i, i, p, p, p]
    fn.restype = i
    scratch = lib.imc_mvm_scratch_floats
    scratch.argtypes = [i, i, i, i]
    scratch.restype = ctypes.c_longlong
    return fn, scratch


def imc_mvm(queries: torch.Tensor, weights: torch.Tensor, *,
            full_scale: float, tile_cols: int = 128, dac_limit: int = 3,
            adc_levels: int = 31, block_q: int | None = None,
            block_r: int | None = None) -> torch.Tensor:
    """(Q, Dp) packed queries x (R, Dp) programmed weights, float32 ->
    (Q, R) float32 scores through the modeled analog chain, bit-identical
    to :func:`imc_mvm_plain`.

    block_q / block_r: launch knobs (``kernels.block_utils``). CPU and
    meta tensors run the plain version; CUDA tensors launch ``csrc/imc_mvm.cu`` on the
    current stream (counted in ``imc_mvm.launches``) or raise."""
    knobs = {"block_q": block_q, "block_r": block_r}
    if not queries.is_cuda and queries.device.type in ("cpu", "meta"):
        check_overrides("imc_mvm", knobs)
        return imc_mvm_plain(queries, weights, full_scale=full_scale,
                             tile_cols=tile_cols, dac_limit=dac_limit,
                             adc_levels=adc_levels)
    if not queries.is_cuda:
        raise ValueError(f"unsupported device {queries.device}")
    _check_operands(queries, weights, tile_cols, dac_limit, adc_levels)
    if queries.dtype != torch.float32 or weights.dtype != torch.float32:
        raise ValueError(f"expected float32 operands, got {queries.dtype} "
                         f"and {weights.dtype}")
    if not (queries.is_contiguous() and weights.is_contiguous()):
        raise ValueError("imc_mvm needs contiguous operands")
    if weights.data_ptr() % 16:
        raise ValueError("imc_mvm needs weights that start on a 16-byte "
                         "boundary (it copies each row's span in aligned "
                         "16-byte quads)")
    Q, Dp = queries.shape
    R = weights.shape[0]
    launch, scratch_floats = _launcher()
    cfg = resolve_blocks("imc_mvm", (Q, R, Dp), knobs, queries.device)
    bq, br = cfg["block_q"], cfg["block_r"]
    if -(-Q // bq) > MAX_GRID_Y:
        raise ValueError(f"Q={Q} exceeds {MAX_GRID_Y * bq} queries")
    out = torch.empty((Q, R), dtype=torch.float32, device=queries.device)
    if Q == 0 or R == 0:
        return out
    # the DAC-rounded queries in the kernel's per-chunk layout
    scratch = torch.empty(scratch_floats(Q, Dp, tile_cols, bq),
                          dtype=torch.float32, device=queries.device)
    with torch.cuda.device(queries.device):  # the launch targets the current device
        err = launch(queries.data_ptr(), weights.data_ptr(), Q, R, Dp,
                     tile_cols, int(dac_limit), int(adc_levels),
                     lsb_of(full_scale, adc_levels), bq, br,
                     scratch.data_ptr(), out.data_ptr(),
                     torch.cuda.current_stream(queries.device).cuda_stream)
    check_status(err, "imc_mvm")
    imc_mvm.launches += 1
    return out


imc_mvm.launches = 0
