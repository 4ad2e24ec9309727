"""Similarity search primitives (SpecPCM DB search, §III.C), in PyTorch.

Counterpart of ``repro.core.hd.similarity``. For bipolar a, b in
{-1, +1}^D, <a, b> = D - 2 * hamming(a, b), so search runs either as an
integer dot product or over bit-packed words with XOR + popcount.

Storage convention: packed words are **int32 bit-views** of the
reference's uint32 words. Bit j of word w is dim 32w + j, and +1 maps
to bit 1. Tie order follows ``lax.top_k``: equal scores go to the lower
index, which :func:`topk_value_desc_index_asc` reproduces.
"""

from __future__ import annotations

import torch

INT32_MIN = -(2 ** 31)

# elements of one XOR/popcount or matmul block; bounds the plain paths'
# temporaries (~64 MB of int32) whatever the bank size
_CHUNK_ELEMS = 1 << 24


def topk_value_desc_index_asc(scores: torch.Tensor, k: int
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis ordered (value desc, position asc):
    ``lax.top_k``'s order. A stable descending sort keeps equal values in
    position order; ``torch.topk`` specifies no tie order, so it is not
    used on any parity path. Returns (vals, positions int64)."""
    vals, pos = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], pos[..., :k]


def dot_similarity(queries: torch.Tensor, refs: torch.Tensor) -> torch.Tensor:
    """(Q, D') x (R, D') -> (Q, R) int32 dot-product scores.

    Runs as a float64 product, exact for int8 operands at any D below
    2**37, in R blocks so no temporary outgrows ``_CHUNK_ELEMS``."""
    Q, D = queries.shape
    R = refs.shape[0]
    q = queries.to(torch.float64)
    out = torch.empty((Q, R), dtype=torch.int32, device=queries.device)
    step = max(1, _CHUNK_ELEMS // max(1, D))
    for r0 in range(0, R, step):
        r = refs[r0:r0 + step].to(torch.float64)
        out[:, r0:r0 + step] = (q @ r.T).to(torch.int32)
    return out


def hamming_similarity(queries: torch.Tensor, refs: torch.Tensor
                       ) -> torch.Tensor:
    """Hamming *similarity* (agreeing positions) of bipolar HVs:
    ``(D + <q, r>) // 2``, (Q, R) int32."""
    d = queries.shape[-1]
    return torch.div(d + dot_similarity(queries, refs), 2,
                     rounding_mode="floor")


def top1_search(queries: torch.Tensor, refs: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Best match per query: (indices (Q,) int64, the first index of each
    row's maximum, as ``jnp.argmax``; scores (Q,) int32)."""
    scores = dot_similarity(queries, refs)
    idx = torch.argmax(scores, dim=-1)
    return idx, torch.gather(scores, 1, idx[:, None])[:, 0]


def topk_search(queries: torch.Tensor, refs: torch.Tensor, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k matches per query: (indices (Q, k) int32, scores (Q, k))."""
    vals, idx = topk_value_desc_index_asc(dot_similarity(queries, refs), k)
    return idx.to(torch.int32), vals


def bitpack_bipolar(hv: torch.Tensor) -> torch.Tensor:
    """Pack bipolar (..., D) into int32 words (..., D/32): +1 -> bit 1,
    dim 32w + j at bit j of word w. The words are built in int64, values
    at or above 2**31 wrap to negative int32 (the bit-view of the uint32
    word), then cast. Row-chunked, so a whole bank packs in bounded
    memory."""
    *lead, D = hv.shape
    if D % 32 != 0:
        raise ValueError(f"D={D} must be a multiple of 32")
    flat = hv.reshape(-1, D)
    out = torch.empty((flat.shape[0], D // 32), dtype=torch.int32,
                      device=hv.device)
    weights = torch.ones(32, dtype=torch.int64,
                         device=hv.device) << torch.arange(
                             32, dtype=torch.int64, device=hv.device)
    step = max(1, _CHUNK_ELEMS // (D * 2))
    for r0 in range(0, flat.shape[0], step):
        bits = (flat[r0:r0 + step] > 0).to(torch.int64).reshape(-1, D // 32,
                                                                  32)
        words = (bits * weights).sum(dim=-1)
        words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
        out[r0:r0 + step] = words.to(torch.int32)
    return out.reshape(*lead, D // 32)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of int32 bit patterns -> int32 (SWAR; torch
    has no popcount op). ``>>`` on int32 is arithmetic, so the words are
    first widened to int64 and masked to their 32 bits; no step can then
    overflow or pull in a sign bit."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = ((x * 0x01010101) & 0xFFFFFFFF) >> 24
    return x.to(torch.int32)


def hamming_similarity_packed(q_packed: torch.Tensor, r_packed: torch.Tensor,
                              dim: int) -> torch.Tensor:
    """(Q, W) x (R, W) int32 words -> (Q, R) int32 ``dim - popcount(q^r)``,
    in R blocks so the (Q, block, W) XOR never outgrows
    ``_CHUNK_ELEMS``."""
    Q, W = q_packed.shape
    R = r_packed.shape[0]
    out = torch.empty((Q, R), dtype=torch.int32, device=q_packed.device)
    step = max(1, _CHUNK_ELEMS // max(1, Q * W))
    for r0 in range(0, R, step):
        x = q_packed[:, None, :] ^ r_packed[None, r0:r0 + step, :]
        out[:, r0:r0 + step] = dim - popcount32(x).sum(-1, dtype=torch.int32)
    return out


def topk_search_packed(q_packed: torch.Tensor, r_packed: torch.Tensor,
                       dim: int, k: int, *, fused: bool = False
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over packed HVs on the dot-product scale
    (``dim - 2 * popcount``): bit-identical to :func:`topk_search` on the
    unpacked vectors, tie order included. ``fused=True`` runs the
    streaming top-k kernel (:mod:`repro_torch.kernels.topk_hamming`)."""
    if fused:
        from repro_torch.kernels.topk_hamming import topk_hamming
        return topk_hamming(q_packed, r_packed, dim=dim, k=k)
    scores = 2 * hamming_similarity_packed(q_packed, r_packed, dim) - dim
    vals, idx = topk_value_desc_index_asc(scores, k)
    return idx.to(torch.int32), vals
