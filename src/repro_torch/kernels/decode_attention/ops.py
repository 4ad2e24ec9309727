"""One-token GQA decode attention over an int8 KV store: the CUDA
kernel's wrapper and its plain PyTorch version.

Replaces ``repro.kernels.decode_attention.decode_attention_pallas`` (TPU
kernel ``decode_attention.py:_decode_attn_kernel``), the fused form of the
int8 branch of ``repro.models.layers.attention_decode``. The kernel is
``csrc/decode_attention.cu``; see its header for the bound on the H100 and
the design. :func:`decode_attention_plain` is the port of the reference's
``ref.py`` oracle: two float32 einsums and a softmax. The reference pads
K/V to a multiple of its chunk on every call; the kernel masks the ragged
tail itself, so a decode step never copies the cache.

The kernel splits S across blocks and merges the splits in the same
launch (flash-decoding): :func:`decode_splits` picks the split count from
S and the SM count, :func:`split_plan` cuts S into that many ranges. Each
(b, kv) pair keeps a uint32 counter in a per-stream buffer that the
kernel leaves at 0 (:func:`_tickets`).

``valid_len`` is a Python int (positions ``< valid_len`` attend), so a
decode loop passes it without reading anything back from the card. With
``valid_len = 0`` every position is masked and both versions return the
uniform average over all S positions, as the reference does.

:func:`decode_attention_partial` is the same launch with one more output,
each head's natural-log log-sum-exp, for a cache whose sequence is cut
into blocks on several ranks (``kv_seq``): each rank attends its block
and the blocks combine as ``sum_r exp(lse_r - M) out_r / sum_r exp(lse_r
- M)``. There ``valid_len = 0`` is an empty block, which gives ``out =
0`` and ``lse = -inf`` (weight 0 in the combine), not the uniform
average.

Dispatch: CPU tensors (and ``meta`` tensors, which the dry run traces)
take the plain version; CUDA tensors launch the kernel or raise. Nothing
falls back.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.topk_hamming.ops import check_status, sm_count

MAX_HEAD_DIM = 256
SMEM_LIMIT = 232_448   # bytes of shared memory one block may use (sm_90)
CHUNK = 64             # positions a block stages per step (csrc kChunk)
SPLIT_MIN = 2 * CHUNK  # fewest positions the split rule gives a split
SPLIT_WAVES = 3        # blocks per SM the split rule aims at


def _check_operands(q, k8, v8, k_scale, v_scale) -> None:
    if q.ndim != 4 or k8.ndim != 4:
        raise ValueError(f"expected q (B, KV, G, hd) and k8 (B, S, KV, hd), "
                         f"got {tuple(q.shape)} and {tuple(k8.shape)}")
    B, KV, G, hd = q.shape
    S = k8.shape[1]
    if (tuple(k8.shape) != (B, S, KV, hd) or v8.shape != k8.shape
            or tuple(k_scale.shape) != (B, S, KV)
            or v_scale.shape != k_scale.shape):
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k8 "
                         f"{tuple(k8.shape)}, v8 {tuple(v8.shape)}, scales "
                         f"{tuple(k_scale.shape)} {tuple(v_scale.shape)}")
    if (q.dtype != torch.float32 or k8.dtype != torch.int8
            or v8.dtype != torch.int8 or k_scale.dtype != torch.float32
            or v_scale.dtype != torch.float32):
        raise ValueError(f"expected float32 q and scales and int8 K/V, got "
                         f"{q.dtype}, {k8.dtype}, {v8.dtype}, "
                         f"{k_scale.dtype}, {v_scale.dtype}")
    devs = {t.device for t in (q, k8, v8, k_scale, v_scale)}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {devs}")


def _plain_logits(q: torch.Tensor, k8: torch.Tensor, k_scale: torch.Tensor,
                  valid_len: int) -> torch.Tensor:
    """(B, KV, G, S) float32 logits, the positions from ``valid_len`` on
    masked to -1e30."""
    logits = torch.einsum("bngk,bsnk->bngs", q, k8.float())
    logits = logits * k_scale.transpose(1, 2)[:, :, None, :]
    mask = torch.arange(k8.shape[1], device=q.device) < int(valid_len)
    return torch.where(mask, logits, -1e30)


def _plain_values(w: torch.Tensor, v8: torch.Tensor, v_scale: torch.Tensor
                  ) -> torch.Tensor:
    w = w * v_scale.transpose(1, 2)[:, :, None, :]
    return torch.einsum("bngs,bsnk->bngk", w, v8.float())


def decode_attention_plain(q: torch.Tensor, k8: torch.Tensor,
                           v8: torch.Tensor, k_scale: torch.Tensor,
                           v_scale: torch.Tensor, valid_len: int
                           ) -> torch.Tensor:
    """The plain version: q (B, KV, G, hd) float32 (rope'd and scaled by
    ``hd**-0.5``), k8 / v8 (B, S, KV, hd) int8, scales (B, S, KV) float32
    -> (B, KV, G, hd) float32. Counts its calls in
    ``decode_attention_plain.calls``."""
    _check_operands(q, k8, v8, k_scale, v_scale)
    decode_attention_plain.calls += 1
    w = torch.softmax(_plain_logits(q, k8, k_scale, valid_len), dim=-1)
    return _plain_values(w, v8, v_scale)


decode_attention_plain.calls = 0


def decode_attention_partial_plain(q: torch.Tensor, k8: torch.Tensor,
                                   v8: torch.Tensor, k_scale: torch.Tensor,
                                   v_scale: torch.Tensor, valid_len: int
                                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`decode_attention_partial`: the output
    of :func:`decode_attention_plain` and its (B, KV, G) float32
    log-sum-exp over the positions ``< valid_len``; ``valid_len <= 0``
    gives zeros and ``-inf``. Counts its calls in
    ``decode_attention_plain.calls``."""
    _check_operands(q, k8, v8, k_scale, v_scale)
    decode_attention_plain.calls += 1
    B, KV, G, hd = q.shape
    if int(valid_len) <= 0:
        return (q.new_zeros((B, KV, G, hd)),
                q.new_full((B, KV, G), float("-inf")))
    logits = _plain_logits(q, k8, k_scale, valid_len)
    w = torch.softmax(logits, dim=-1)
    return _plain_values(w, v8, v_scale), torch.logsumexp(logits, dim=-1)


def split_plan(S: int, splits: int) -> tuple[int, int]:
    """(splits, positions per split) of a cache of S positions cut into at
    most ``splits`` contiguous ranges: ranges of ceil(S / splits)
    positions, the last one shorter."""
    per = -(-S // max(1, min(int(splits), S)))
    return -(-S // per), per


def decode_splits(B: int, KV: int, S: int, sms: int) -> int:
    """The kernel's split count: as many splits of each (b, kv) pair as
    keep the grid within ``SPLIT_WAVES`` blocks per SM (one resident
    wave: each block's start-up and merge cost more than the balance of
    smaller splits gains), and no split under ``SPLIT_MIN`` positions
    (S <= ``SPLIT_MIN``: one split). Depends on S and the card, never on
    ``valid_len``, so a decode loop launches the same grid at every
    step."""
    want = SPLIT_WAVES * sms // max(1, B * KV)
    return max(1, min(want, -(-S // SPLIT_MIN)))


_TICKET_BUFFERS: dict[tuple[int, int], torch.Tensor] = {}


def _tickets(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """n uint32 merge counters (as int32) for launches on ``stream``: zero
    when made, and every launch leaves them zero. One buffer per stream,
    since launches on one stream run in order."""
    key = (device.index, stream)
    buf = _TICKET_BUFFERS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(n, dtype=torch.int32, device=device)
        _TICKET_BUFFERS[key] = buf
    return buf


@functools.cache
def _launcher():
    lib = _build.load("decode_attention")
    fn = lib.decode_attention_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, p, p, p, p, p]
    fn.restype = i
    smem = lib.decode_attention_smem_bytes
    smem.argtypes = [i, i]
    smem.restype = ctypes.c_longlong
    most = lib.decode_attention_max_splits
    most.argtypes = [i, i]
    most.restype = i
    slab = lib.decode_attention_partial_floats
    slab.argtypes = [i, i]
    slab.restype = i
    return fn, smem, most, slab


def decode_attention(q: torch.Tensor, k8: torch.Tensor, v8: torch.Tensor,
                     k_scale: torch.Tensor, v_scale: torch.Tensor,
                     valid_len: int) -> torch.Tensor:
    """Decode attention of one token per sequence over an int8 KV store.

    q (B, KV, G, hd) float32, already rope'd and multiplied by
    ``hd**-0.5``; k8, v8 (B, S, KV, hd) int8; k_scale, v_scale (B, S, KV)
    float32; positions ``< valid_len`` attend. Returns (B, KV, G, hd)
    float32.

    CPU and meta tensors run :func:`decode_attention_plain`; CUDA tensors
    launch
    ``csrc/decode_attention.cu`` on the current stream at
    :func:`decode_splits`' split count (one launch per call, counted in
    ``decode_attention.launches``) or raise. The kernel takes any S and
    G, and hd a multiple of 16 up to 256."""
    if not q.is_cuda and q.device.type in ("cpu", "meta"):
        return decode_attention_plain(q, k8, v8, k_scale, v_scale, valid_len)
    return _launch(q, k8, v8, k_scale, v_scale, valid_len, None)


def decode_attention_partial(q: torch.Tensor, k8: torch.Tensor,
                             v8: torch.Tensor, k_scale: torch.Tensor,
                             v_scale: torch.Tensor, valid_len: int
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`decode_attention` over one block of a cache's sequence, and
    each head's log-sum-exp: returns (out (B, KV, G, hd), lse (B, KV, G))
    float32, ``lse = log sum_s exp(logit_s)`` over the positions ``<
    valid_len``. ``valid_len <= 0`` gives ``out = 0`` and ``lse = -inf``.

    CPU and meta tensors run :func:`decode_attention_partial_plain`; CUDA
    tensors launch ``csrc/decode_attention.cu``'s partial form (one
    launch, counted in ``decode_attention.launches``) or raise."""
    if not q.is_cuda and q.device.type in ("cpu", "meta"):
        return decode_attention_partial_plain(q, k8, v8, k_scale, v_scale,
                                              valid_len)
    return _launch(q, k8, v8, k_scale, v_scale, valid_len, None,
                   partial=True)


def _launch(q: torch.Tensor, k8: torch.Tensor, v8: torch.Tensor,
            k_scale: torch.Tensor, v_scale: torch.Tensor, valid_len: int,
            splits: int | None, partial: bool = False):
    """Launches the kernel on CUDA operands with ``splits`` splits of S
    (None: :func:`decode_splits`; tests and the chip check force others),
    capped where the merge's table would outgrow the block's shared
    memory (787 splits at the served G and hd). Counted in
    ``decode_attention.launches``. Returns the output, or with
    ``partial`` (out, lse) of the partial form."""
    if not q.is_cuda:
        raise ValueError(f"unsupported device {q.device}")
    _check_operands(q, k8, v8, k_scale, v_scale)
    B, KV, G, hd = q.shape
    S = k8.shape[1]
    if hd % 16 or not 16 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd}: the kernel takes a multiple of 16 "
                         f"up to {MAX_HEAD_DIM}")
    if S == 0:
        raise ValueError("an empty KV store (S = 0) has nothing to attend")
    if not all(t.is_contiguous() for t in (q, k8, v8, k_scale, v_scale)):
        raise ValueError("decode_attention needs contiguous operands")
    if q.data_ptr() % 16 or k8.data_ptr() % 16 or v8.data_ptr() % 16:
        raise ValueError("decode_attention needs q and K/V on 16-byte "
                         "boundaries")
    launch, smem_bytes, max_splits, partial_floats = _launcher()
    if smem_bytes(G, hd) > SMEM_LIMIT:
        raise ValueError(f"G={G} heads of width {hd} need "
                         f"{smem_bytes(G, hd)} bytes of shared memory, over "
                         f"{SMEM_LIMIT}")
    if B > 65535 or KV > 65535:
        raise ValueError(f"B={B}, KV={KV}: the grid takes at most 65535 of "
                         f"each")
    out = torch.empty((B, KV, G, hd), dtype=torch.float32, device=q.device)
    lse = (torch.empty((B, KV, G), dtype=torch.float32, device=q.device)
           if partial else None)
    if B == 0 or KV == 0 or G == 0:
        return (out, lse) if partial else out
    valid = max(0, min(int(valid_len), S))
    if splits is None:
        splits = decode_splits(B, KV, S, sm_count(q.device))
    n, per = split_plan(S, min(splits, max_splits(G, hd)))
    part = torch.empty((B * KV * n, partial_floats(G, hd)),
                       dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tickets = _tickets(q.device, stream, B * KV)
    with torch.cuda.device(q.device):  # the launch targets the current device
        err = launch(q.data_ptr(), k8.data_ptr(), v8.data_ptr(),
                     k_scale.data_ptr(), v_scale.data_ptr(), B, S, KV, G, hd,
                     valid, per, n, part.data_ptr(), tickets.data_ptr(),
                     out.data_ptr(), lse.data_ptr() if partial else None,
                     stream)
    check_status(err, "decode_attention")
    decode_attention.launches += 1
    return (out, lse) if partial else out


decode_attention.launches = 0
