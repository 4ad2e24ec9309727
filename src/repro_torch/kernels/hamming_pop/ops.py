"""Full bit-packed Hamming similarity: the CUDA kernel's wrapper and its
plain PyTorch version.

Replaces ``repro.kernels.hamming_pop.hamming_pop_pallas`` (TPU kernel
``hamming_pop.py:_hamming_kernel``), the distance step of clustering.
The kernel is ``csrc/hamming_pop.cu`` (int8 tensor cores); see its
header for the bound on the H100 and the design.
:func:`hamming_pop_plain` is also the counterpart of the reference's
``ref.py`` oracle. The reference pads Q
and R to 128 and W to 32 and slices the result; the kernel masks the
ragged edges itself, with the same results.

Dispatch: CPU tensors take the plain version; CUDA tensors launch the
kernel or raise. Nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.hd.similarity import hamming_similarity_packed
from repro_torch.kernels import _build
from repro_torch.kernels.topk_hamming.ops import check_status

BLOCK_Q = 128         # output rows per block (hamming_pop.cu)
MAX_GRID_Y = 65535    # CUDA's limit on the grid's query-tile axis


def _check_operands(q: torch.Tensor, r: torch.Tensor) -> None:
    if q.ndim != 2 or r.ndim != 2 or q.shape[1] != r.shape[1]:
        raise ValueError(f"bad operand shapes {tuple(q.shape)} x "
                         f"{tuple(r.shape)}")
    if q.dtype != torch.int32 or r.dtype != torch.int32:
        raise ValueError(f"expected int32 packed words, got {q.dtype} and "
                         f"{r.dtype}")
    if q.device != r.device:
        raise ValueError(f"device mismatch {q.device} vs {r.device}")


def hamming_pop_plain(q: torch.Tensor, r: torch.Tensor, *, dim: int
                      ) -> torch.Tensor:
    """The plain version: (Q, W) x (R, W) int32 words -> (Q, R) int32
    ``dim - popcount(q ^ r)``."""
    _check_operands(q, r)
    return hamming_similarity_packed(q, r, int(dim))


def _launcher():
    fn = _build.load("hamming_pop").hamming_pop_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, i, i, i, i, p, p]
    fn.restype = i
    return fn


def hamming_pop(q: torch.Tensor, r: torch.Tensor, *, dim: int
                ) -> torch.Tensor:
    """(Q, W) x (R, W) int32 bit-views of packed words -> (Q, R) int32
    ``dim - popcount(q ^ r)``, the number of agreeing bipolar dimensions.

    CPU tensors run :func:`hamming_pop_plain`; CUDA tensors launch
    ``csrc/hamming_pop.cu`` on the current stream (counted in
    ``hamming_pop.launches``) or raise."""
    if not q.is_cuda and q.device.type == "cpu":
        return hamming_pop_plain(q, r, dim=dim)
    if not q.is_cuda:
        raise ValueError(f"unsupported device {q.device}")
    _check_operands(q, r)
    if not (q.is_contiguous() and r.is_contiguous()):
        raise ValueError("hamming_pop needs contiguous operands")
    Q, W = q.shape
    R = r.shape[0]
    if -(-Q // BLOCK_Q) > MAX_GRID_Y:
        raise ValueError(f"Q={Q} exceeds {MAX_GRID_Y * BLOCK_Q} rows")
    launch = _launcher()
    out = torch.empty((Q, R), dtype=torch.int32, device=q.device)
    if Q == 0 or R == 0:
        return out
    vec = W % 4 == 0 and q.data_ptr() % 16 == 0 and r.data_ptr() % 16 == 0
    with torch.cuda.device(q.device):  # the launch targets the current device
        err = launch(q.data_ptr(), r.data_ptr(), Q, R, W, int(dim), int(vec),
                     out.data_ptr(),
                     torch.cuda.current_stream(q.device).cuda_stream)
    check_status(err, "hamming_pop")
    hamming_pop.launches += 1
    return out


hamming_pop.launches = 0
