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

Both versions take each partial sum in the same order (column by column,
a rounded multiply and a rounded add each) and accumulate the tiles in
order, t = 0 first, each step ``code * lsb + acc`` rounded once, as the
reference's kernel accumulates (XLA fuses that multiply-add), so on the
same inputs they agree bit for bit. The reference sums each tile's dot
product in XLA's order, so against it float weights agree to a
tolerance; integer-valued weights make the partials exact and the results
bit-identical to the reference's kernel. (The reference's oracles
``imc_mvm_ref`` and ``imc_mvm_reference`` round ``code * lsb`` before
summing, so they differ from its kernel, and from the port, by an ulp.)
``lsb`` is ``full_scale / adc_levels`` in double, rounded once to float32,
as the reference's Python scalar is.

``tile_cols`` is the array's column count (``ArrayConfig.cols``), not a
launch knob: another value computes another function. The launch knobs
``block_q`` / ``block_r`` (the output tile) resolve through
``kernels.block_utils``.

Dispatch: CPU tensors take the plain version (explicit knobs are checked,
then ignored); CUDA tensors launch the kernel or raise. Nothing falls back.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as nnf

from repro_torch.kernels import _build
from repro_torch.kernels.block_utils import check_overrides, resolve_blocks
from repro_torch.kernels.topk_hamming.ops import check_status, smem_limit

MAX_GRID_Y = 65535    # CUDA's limit on the grid's query-tile axis
CHUNK_ROWS = 1 << 16  # weight rows per block of the plain version


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


def imc_mvm_plain(queries: torch.Tensor, weights: torch.Tensor, *,
                  full_scale: float, tile_cols: int = 128,
                  dac_limit: int = 3, adc_levels: int = 31) -> torch.Tensor:
    """The plain version: per-tile partials summed column by column (a
    float32 multiply, then a float32 add, each rounded), then the ADC,
    then a sequential accumulation over the tiles, t = 0 first, each step
    ``code * lsb + acc`` rounded once (in float64, where it is exact, then
    to float32); weights in blocks of :data:`CHUNK_ROWS` rows. (Q, Dp) x
    (R, Dp) -> (Q, R) float32."""
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
            part = part + qt[:, None, :, c] * wt[c][None]
        code = torch.clamp(torch.round(part / lsb), -adc_levels, adc_levels)
        acc = torch.zeros((Q, wt.shape[1]), dtype=torch.float32, device=dev)
        for t in range(T):
            acc = (acc.to(torch.float64) + code[:, :, t].to(torch.float64)
                   * lsb.to(torch.float64)).to(torch.float32)
        out[:, r0:r0 + CHUNK_ROWS] = acc
    return out


def _launcher():
    fn = _build.load("imc_mvm").imc_mvm_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, i, i, i, i, i, ctypes.c_float, i, i, p, p]
    fn.restype = i
    return fn


def imc_mvm(queries: torch.Tensor, weights: torch.Tensor, *,
            full_scale: float, tile_cols: int = 128, dac_limit: int = 3,
            adc_levels: int = 31, block_q: int | None = None,
            block_r: int | None = None) -> torch.Tensor:
    """(Q, Dp) packed queries x (R, Dp) programmed weights, float32 ->
    (Q, R) float32 scores through the modeled analog chain, bit-identical
    to :func:`imc_mvm_plain`.

    block_q / block_r: launch knobs (``kernels.block_utils``). CPU tensors
    run the plain version; CUDA tensors launch ``csrc/imc_mvm.cu`` on the
    current stream (counted in ``imc_mvm.launches``) or raise."""
    knobs = {"block_q": block_q, "block_r": block_r}
    if not queries.is_cuda and queries.device.type == "cpu":
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
    Q, Dp = queries.shape
    R = weights.shape[0]
    launch = _launcher()
    cfg = resolve_blocks("imc_mvm", (Q, R, Dp), knobs, queries.device)
    bq, br = cfg["block_q"], cfg["block_r"]
    need = 4 * tile_cols * (bq + br + 1)
    if need > smem_limit(queries.device):
        raise ValueError(f"block_q={bq}, block_r={br} at tile_cols="
                         f"{tile_cols} need {need} B of shared memory; the "
                         f"card allows {smem_limit(queries.device)}")
    if -(-Q // bq) > MAX_GRID_Y:
        raise ValueError(f"Q={Q} exceeds {MAX_GRID_Y * bq} queries")
    out = torch.empty((Q, R), dtype=torch.float32, device=queries.device)
    if Q == 0 or R == 0:
        return out
    with torch.cuda.device(queries.device):  # the launch targets the current device
        err = launch(queries.data_ptr(), weights.data_ptr(), Q, R, Dp,
                     tile_cols, int(dac_limit), int(adc_levels),
                     lsb_of(full_scale, adc_levels), bq, br, out.data_ptr(),
                     torch.cuda.current_stream(queries.device).cuda_stream)
    check_status(err, "imc_mvm")
    imc_mvm.launches += 1
    return out


imc_mvm.launches = 0
