"""Core transformer layers of the decoder (``repro.models.layers``):
norms, RoPE, GQA attention (full / chunked / prefill / decode against a
KV cache), the dense FFN variants (SwiGLU / GeGLU / GELU) and the
GShard-style MoE layer with capacity-factor dispatch and shared experts.

Parameters are ``nn.ParameterDict``s keyed by the JAX package's names
(``wq`` (D, H, hd), ``wo`` (H, hd, D), ``w_gate`` (D, F), ...), so a layer
reads ``p["wq"]`` as the reference does. Matrices and biases are stored in
``cfg.dtype``, norm scales in float32; the reference keeps float32
parameters and casts each to the activation dtype before use, which is the
same value.

The reference's ``dist.sharding.constrain`` calls are kept where it has
them (``_qkv``, the attention outputs, ``apply_ffn``'s hidden): the
identity with no mesh, a redistribution of the ``DTensor`` activations on
a ``DeviceMesh``. The int8 branch of :func:`attention_decode` calls the
hand-written ``decode_attention`` kernel; the bfloat16 ``KVCache`` branch
stays plain PyTorch, as the reference computes it in XLA. Caches are
updated in place: a decode step writes one slot of each layer's cache
instead of returning a new cache. On a mesh a cache is this rank's own
plain tensors: its ``batch`` block and the kv heads its query-head block
reads (``kv_block``); the cache writes and the attention over it run in
one local region (``sharding.local_map_axes``) on the rank's blocks.
When the rules stripe the cache's sequence (``kv_seq``, which then takes
its mesh axes before the kv heads, as the reference's ``logical_to_spec``
does) a cache holds the rank's block of slots with every kv head; a
decode step attends each block on its own rank and combines the blocks'
outputs by their log-sum-exps (:func:`attention_decode`).

With ``trainable=True`` the init functions store every leaf in
``cfg.param_dtype`` (float32) with ``requires_grad``: the training path's
master weights, which the layers cast to the activation dtype at use as
the reference does. The FFN's IMC-routed down-projection
(``_imc_linear``) runs the hand-written ``imc_mvm`` kernel on CUDA
tensors.

The MoE layer routes with indices where the reference multiplies dense
one-hot dispatch and combine tensors: each (expert, group, slot) of the
capacity buffer receives at most one (token, slot) pair, so gathering
gives the reference's dispatched values exactly, and the combine sums the
same ``<= top_k`` weighted terms. The routing reads nothing back from the
card. It never goes through ``_imc_linear``, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.core.imc.array import ArrayConfig, default_full_scale
from repro_torch.dist import sharding as SH
from repro_torch.kernels.decode_attention import (
    decode_attention,
    decode_attention_partial,
)
from repro_torch.kernels.imc_mvm import imc_mvm

Params = nn.ParameterDict


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _leaf_dtype(cfg: ArchConfig, trainable: bool) -> torch.dtype:
    """Where a matrix or bias is stored: ``cfg.dtype`` for serving,
    ``cfg.param_dtype`` (the float32 master copy) for training."""
    return getattr(torch, cfg.param_dtype) if trainable else _dtype(cfg)


def _param(t: torch.Tensor, trainable: bool = False) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=trainable)


def _normal(shape, std: float, cfg: ArchConfig, device, generator,
            trainable: bool = False, dtype: torch.dtype | None = None
            ) -> nn.Parameter:
    """A float32 normal draw times ``std``, cast to the leaf dtype (or
    ``dtype``): one matrix at a time, so a full-width serving model never
    holds its float32 weights at once."""
    w = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    dt = dtype or _leaf_dtype(cfg, trainable)
    return _param(w.mul_(std).to(dt), trainable)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_norm(cfg: ArchConfig, d: int | None = None, device="cpu",
              trainable: bool = False) -> Params:
    d = d or cfg.d_model
    p = {"scale": _param(torch.ones(d, device=device), trainable)}
    if cfg.norm == "layernorm":
        p["bias"] = _param(torch.zeros(d, device=device), trainable)
    return nn.ParameterDict(p)


def apply_norm(p: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + 1e-6) * p["scale"] + p["bias"]
    else:
        var = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + 1e-6) * p["scale"]
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device="cpu") -> torch.Tensor:
    # theta stays a Python scalar: a tensor made from it on the card would
    # be a host-to-device copy, which synchronizes the stream
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=device) / half
    return 1.0 / torch.pow(theta, exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) or (S,) int."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                # (hd/2,)
    if positions.ndim == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freqs          # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def init_attention(cfg: ArchConfig, device="cpu",
                   generator: torch.Generator | None = None,
                   trainable: bool = False) -> Params:
    """The reference's distributions: normal x ``d**-0.5`` for wq / wk / wv,
    normal x ``(h * hd)**-0.5`` for wo, zero QKV biases."""
    d, h, kv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    s = d ** -0.5
    t = trainable
    p = {
        "wq": _normal((d, h, hd), s, cfg, device, generator, t),
        "wk": _normal((d, kv, hd), s, cfg, device, generator, t),
        "wv": _normal((d, kv, hd), s, cfg, device, generator, t),
        "wo": _normal((h, hd, d), (h * hd) ** -0.5, cfg, device, generator,
                      t),
    }
    if cfg.qkv_bias:
        dt = _leaf_dtype(cfg, t)
        for name, n in (("bq", h), ("bk", kv), ("bv", kv)):
            p[name] = _param(torch.zeros((n, hd), dtype=dt, device=device), t)
    return nn.ParameterDict(p)


# the logical axes of the dense layers' weights (the reference's
# ``init_attention`` / ``init_ffn``)
WQ_AXES = ("fsdp", "heads", None)
WKV_AXES = ("fsdp", "kv_heads", None)
WO_AXES = ("heads", None, "fsdp")
W_IN_AXES = ("fsdp", "ff")
W_OUT_AXES = ("ff", "fsdp")
# the logical axes of the (B, S, D) activations between blocks
SEQ_AXES = ("batch", "seq_shard", None)


def gather_fsdp(w: torch.Tensor, axes: tuple) -> torch.Tensor:
    """A weight with its FSDP-sharded dim gathered (its other dims as
    ``axes`` place them): FSDP gathers a weight before it is used and
    reduce-scatters its gradient, so the contraction over d_model runs
    whole on each rank. The identity with no mesh."""
    return SH.constrain(w, *(None if a == "fsdp" else a for a in axes))


def project(x: torch.Tensor, w: torch.Tensor, axes: tuple | None = None,
            dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x @ w`` in ``dtype`` (default x's), w rounded to it. On a mesh
    the product is placed by ``axes``; under autograd (training) it is
    taken in float32 and rounded once: where the ranks each hold a block
    of the contraction (heads, d_ff) its partial sums are reduced in
    float32 first, as one device's GEMM accumulates in float32 and rounds
    once (bfloat16 partial sums round each rank's share, then their sum,
    and an analog chain's quantization turns that into a loss apart).
    Serving keeps the activation dtype: half the bytes through the
    collectives, and its logits came no closer to one process's
    (PERF.md §6)."""
    dtype = dtype or x.dtype
    w = w.to(dtype)
    if not SH.on_mesh(x):
        return x @ w
    y = x.float() @ w.float() if torch.is_grad_enabled() else x @ w
    if axes is not None:
        y = SH.constrain(y, *axes)
    return y.to(dtype)


def _proj(x: torch.Tensor, w: torch.Tensor, w_axes: tuple | None = None,
          dtype: torch.dtype | None = None) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one (B*S, D) x (D, H*hd) product in
    ``dtype`` (default x's); on a mesh the weight's FSDP dim gathered
    first (``w_axes``)."""
    d, h, k = w.shape
    dtype = dtype or x.dtype
    w = w.to(dtype)
    if w_axes is not None:
        w = gather_fsdp(w, w_axes)
    return project(x, w.reshape(d, h * k), dtype=dtype).unflatten(-1,
                                                                  (h, k))


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bqhk,hkd->bqd"), the heads' partial sums reduced onto the
    sequence-sharded layout on a mesh."""
    wo = gather_fsdp(wo.to(out.dtype), WO_AXES)
    return project(out.flatten(-2), wo.flatten(0, 1), SEQ_AXES)


# the logical axes of the (B, S, H, hd) queries and (B, S, KV, hd) keys and
# values, as the reference constrains them
Q_AXES = ("batch", None, "heads", None)
KV_AXES = ("batch", None, "kv_heads", None)


def gather_seq(x: torch.Tensor) -> torch.Tensor:
    """A (B, S, D) activation with its whole sequence on each rank
    (("batch", None, None)) before it enters a projection: the all-gather
    GSPMD's partitioner inserts for the reference where a sequence-sharded
    activation meets a column-sharded weight (DTensor does not split a
    sharded sequence out of a matmul's flattened rows). On a mesh under
    autograd it is widened to float32 first, so that backward reduces the
    projections' partial input gradients in float32 and rounds them once
    (``project`` then rounds its output to the activation dtype). The
    identity with no mesh."""
    if not SH.on_mesh(x):
        return x
    if torch.is_grad_enabled():
        x = x.float()
    return SH.constrain(x, "batch", None, None)


def _qkv(p: Params, x: torch.Tensor, cfg: ArchConfig,
         positions: torch.Tensor, use_rope: bool = True):
    dt = x.dtype
    x = gather_seq(x)
    q = _proj(x, p["wq"], WQ_AXES, dt)
    k, v = _proj(x, p["wk"], WKV_AXES, dt), _proj(x, p["wv"], WKV_AXES, dt)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    q = SH.constrain(q, *Q_AXES)
    k = SH.constrain(k, *KV_AXES)
    v = SH.constrain(v, *KV_AXES)
    return q, k, v


def _group_q(q: torch.Tensor, num_kv: int) -> torch.Tensor:
    """(B, S, H, hd) -> (B, S, KV, G, hd): query heads grouped by kv head,
    so GQA never materializes repeated K/V."""
    b, s, h, hd = q.shape
    return q.reshape(b, s, num_kv, h // num_kv, hd)


def _causal_band_mask(sq: int, skv: int, q_off: int, window: int,
                      device="cpu") -> torch.Tensor:
    """(sq, skv) bool mask: kv position j visible from query position
    (q_off + i) if j <= q_off+i and (window == 0 or j > q_off+i - window)."""
    qi = torch.arange(sq, device=device)[:, None] + q_off
    kj = torch.arange(skv, device=device)[None, :]
    m = kj <= qi
    if window:
        m = m & (kj > qi - window)
    return m


def attention_full(q, k, v, cfg: ArchConfig, q_off: int = 0,
                   causal: bool = True) -> torch.Tensor:
    """Materialized-scores attention, the prefill route up to 8,192
    positions. The (B, KV, G, Sq, S) logits are converted, masked and
    normalised one buffer at a time, so at most two of them are alive."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    qg = _group_q(q, kv)
    logits = torch.einsum("bqngk,bsnk->bngqs", qg, k)
    logits = logits.div_(hd ** 0.5).float()
    if causal:
        mask = _causal_band_mask(sq, k.shape[1], q_off, cfg.sliding_window,
                                 q.device)
        logits.masked_fill_(~mask, -1e30)
    w = torch.softmax(logits, dim=-1)
    del logits
    w = w.to(q.dtype)
    out = torch.einsum("bngqs,bsnk->bqngk", w, v)
    return out.reshape(b, sq, h, hd)


def attention_chunked(q, k, v, cfg: ArchConfig, chunk: int = 1024,
                      causal: bool = True) -> torch.Tensor:
    """Online-softmax attention over KV chunks (the reference's jnp-level
    FlashAttention), the prefill route past 8,192 positions: memory is
    O(Sq * chunk) instead of O(Sq * S)."""
    h = q.shape[2]
    hd = q.shape[-1]
    b, sq = q.shape[0], q.shape[1]
    kv = k.shape[2]
    g = h // kv
    skv = k.shape[1]
    chunk = min(chunk, skv)
    if skv % chunk:
        raise ValueError(f"kv length {skv} is not a multiple of the chunk "
                         f"{chunk}")
    qg = _group_q(q, kv).float()               # (b, sq, kv, g, hd)
    scale = hd ** -0.5
    m = torch.full((b, kv, g, sq), float("-inf"), device=q.device)
    denom = torch.zeros((b, kv, g, sq), device=q.device)
    acc = torch.zeros((b, kv, g, sq, hd), device=q.device)
    qi = torch.arange(sq, device=q.device)[:, None]
    for c0 in range(0, skv, chunk):
        kb, vb = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        logits = torch.einsum("bqngk,bsnk->bngqs", qg, kb.float()) * scale
        kj = c0 + torch.arange(chunk, device=q.device)[None, :]
        mask = kj <= qi
        if cfg.sliding_window:
            mask = mask & (kj > qi - cfg.sliding_window)
        if causal:
            logits = torch.where(mask, logits, -1e30)
        m_new = torch.maximum(m, logits.amax(-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        denom = denom * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bngqs,bsnk->bngqk", p, vb.float())
        m = m_new
    out = acc / torch.clamp(denom[..., None], min=1e-30)
    # (b, kv, g, sq, hd) -> (b, sq, h, hd)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).to(q.dtype)


@SH.in_mesh_context
def attention_train(p: Params, x: torch.Tensor, cfg: ArchConfig,
                    causal: bool = True, chunk_threshold: int = 8192
                    ) -> torch.Tensor:
    """Self-attention over a full sequence (training): the materialized
    route up to ``chunk_threshold`` positions, the chunked one past it."""
    s = x.shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(p, x, cfg, positions)
    route = attention_full if s <= chunk_threshold else attention_chunked
    out = _on_kv_block(lambda q, k, v: route(q, k, v, cfg, causal=causal),
                       q, k, v, cfg)
    return _out_proj(SH.constrain(out, *Q_AXES), p["wo"])


# the logical axes of a cache's (B, S, KV, hd) K / V and (B, S, KV) scales
# (the reference's ``cache_axes_for``): the sequence striped by ``kv_seq``
CACHE_AXES = ("batch", "kv_seq", "kv_heads", None)
CACHE_SCALE_AXES = ("batch", "kv_seq", "kv_heads")


class SeqBlock(NamedTuple):
    """A rank's block of a cache's slots under ``kv_seq``."""
    first: int     # the block's first slot
    length: int    # its slots
    size: int      # the whole cache's slots
    axes: tuple    # the mesh axes that stripe the slots


class _Cache:
    """``seq_block``: the rank's :class:`SeqBlock` when the cache holds a
    block of the slots, else None. A class attribute, not a dataclass
    field: the tree helpers (placements, the dry run's byte counts) see
    the tensors alone."""
    seq_block: SeqBlock | None = None


@dataclasses.dataclass
class KVCache(_Cache):
    k: torch.Tensor  # (B, S_max, KV, hd)
    v: torch.Tensor


@dataclasses.dataclass
class QuantKVCache(_Cache):
    """int8 KV store with per-(batch, position, kv-head) scales: half the
    bytes of a bfloat16 cache per decode step, with the scales factoring
    out of the QK dot product per position."""
    k: torch.Tensor        # (B, S, KV, hd) int8
    v: torch.Tensor        # (B, S, KV, hd) int8
    k_scale: torch.Tensor  # (B, S, KV) float32
    v_scale: torch.Tensor  # (B, S, KV) float32


def _kv_quant(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, S, KV, hd) -> int8 codes + per-(B, S, KV) scale."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(-1), min=1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def kv_block(cfg: ArchConfig, batch: int, mesh=None, size: int | None = None
             ) -> tuple:
    """(rows, first kv head, kv heads) of this rank's cache block on
    ``mesh`` (default: the installed one): its block of the ``batch`` dim
    and the kv heads its block of query heads reads (the rules may leave
    the kv heads replicated while the query heads are sharded); the whole
    cache with no ``DeviceMesh``. A query-head block that is neither whole
    kv groups nor inside one group raises ``ValueError``.

    With ``size`` (the cache's slots) also (first slot, slots) of the
    rank's block of the sequence. When the rules stripe it
    (``CACHE_AXES``' ``kv_seq`` takes mesh axes: they divide ``size``)
    the block holds every kv head, since ``kv_seq`` takes its mesh axes
    before ``kv_heads``; a rule that splits the kv heads besides raises
    ``ValueError``. Else the whole sequence and the heads above."""
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    shape = (batch, 1, h, hd)
    _, rows = SH.local_range(Q_AXES, shape, 0, mesh)
    if size is not None:
        cache = (batch, size, kv, hd)
        s0, sl = SH.local_range(CACHE_AXES, cache, 1, mesh)
        if sl < size:
            if SH.dim_axes(CACHE_AXES, cache, 2, mesh):
                raise ValueError("a cache striped by kv_seq whose kv heads "
                                 "are split too")
            return rows, 0, kv, s0, sl
    h0, hl = SH.local_range(Q_AXES, shape, 2, mesh)
    g = h // kv
    if hl % g and g % hl:
        raise ValueError(f"a block of {hl} query heads straddles the kv "
                         f"groups of {g} heads")
    heads = (rows, h0 // g, max(hl // g, 1))
    return heads if size is None else heads + (0, size)


def init_kv_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=None,
                  device="cpu", mesh=None):
    """For sliding-window layers the cache is bounded by the window. K, V
    and their scales are separate buffers (they are written in place). On
    a ``DeviceMesh`` the buffers hold this rank's block (``kv_block``);
    a block of the slots is recorded in the cache's ``seq_block``."""
    size = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    rows, _, kv, s0, sl = kv_block(cfg, batch, mesh, size)
    hd = cfg.resolved_head_dim
    shape = (rows, sl, kv, hd)
    if cfg.kv_quant_int8:
        cache = QuantKVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            k_scale=torch.ones((rows, sl, kv), device=device),
            v_scale=torch.ones((rows, sl, kv), device=device))
    else:
        dt = dtype or _dtype(cfg)
        cache = KVCache(k=torch.zeros(shape, dtype=dt, device=device),
                        v=torch.zeros(shape, dtype=dt, device=device))
    if sl < size:
        cache.seq_block = SeqBlock(s0, sl, size, SH.dim_axes(
            CACHE_AXES, (batch, size, kv, hd), 1, mesh))
    return cache


def _write_slots(cache, at, k: torch.Tensor, v: torch.Tensor) -> None:
    """k and v (rows, n, KV, hd) written to the cache's slots ``at`` (a
    slice of n slots), quantized per (row, position, kv head) for an
    int8 cache."""
    if isinstance(cache, QuantKVCache):
        k8, ks = _kv_quant(k)
        v8, vs = _kv_quant(v)
        cache.k[:, at] = k8
        cache.v[:, at] = v8
        cache.k_scale[:, at] = ks
        cache.v_scale[:, at] = vs
    else:
        cache.k[:, at] = k
        cache.v[:, at] = v


def _on_kv_block(fn: Callable, q: torch.Tensor | None, k: torch.Tensor,
                 v: torch.Tensor, cfg: ArchConfig):
    """``fn(q, k, v)`` with k and v cut to the kv heads this rank's block
    of query heads reads (``kv_block``): the tensors themselves with no
    mesh; on a mesh each rank's local blocks in one local region, the
    output (if any) placed as q. Attention is independent across batch
    rows and kv groups, so each rank attends its own block."""
    if not SH.on_mesh(k):
        return fn(q, k, v)
    _, first, n = kv_block(cfg, k.shape[0])
    lo = first - SH.local_range(KV_AXES, k.shape, 2)[0]

    def local(*t):
        ql, kl, vl = (None, *t) if q is None else t
        return fn(ql, kl[:, :, lo:lo + n], vl[:, :, lo:lo + n])

    if q is None:
        return SH.local_map_axes(local, (KV_AXES, KV_AXES), ())(k, v)
    return SH.local_map_axes(local, (Q_AXES, KV_AXES, KV_AXES),
                             (Q_AXES,))(q, k, v)


# the (B, S, KV, hd) keys and values, or (B, 1, H, hd) queries, with every
# head on each rank of a row block: what a striped cache's block reads
WHOLE_HEADS = ("batch", None, None, None)


@SH.in_mesh_context
def attention_prefill(p: Params, x: torch.Tensor, cfg: ArchConfig, cache):
    """Full-sequence causal attention that also fills the KV cache in
    place: position ``p`` of the last ``min(S, size)`` lands in slot
    ``p % size``, the slot decode writes it to. (The reference writes the
    kept tail to slots ``0..size-1``, which misaligns the sliding-window
    ring when S > size and S % size != 0; the port follows the ring.) A
    cache striped by ``kv_seq`` is filled with the slots of its block
    alone, from k and v with every kv head gathered."""
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(p, x, cfg, positions)
    route = attention_full if s <= 8192 else attention_chunked
    out = _on_kv_block(lambda q, k, v: route(q, k, v, cfg), q, k, v, cfg)
    blk = cache.seq_block
    size = blk.size if blk else cache.k.shape[1]
    n = min(s, size)
    shift = s % size if s > size else 0

    def ring(t):
        return torch.roll(t, shift, dims=1) if shift else t

    def fill(_, k, v):
        _write_slots(cache, slice(0, n), ring(k[:, -size:]),
                     ring(v[:, -size:]))

    def fill_block(k, v):
        # slot j of the ring holds position j - shift of the kept tail
        lo, hi = blk.first, min(blk.first + blk.length, n)
        if hi > lo:
            idx = (torch.arange(lo, hi, device=k.device) - shift) % n
            _write_slots(cache, slice(0, hi - lo), k[:, -size:][:, idx],
                         v[:, -size:][:, idx])

    if blk is None:
        _on_kv_block(fill, None, k, v, cfg)
    else:
        SH.local_map_axes(fill_block, (WHOLE_HEADS, WHOLE_HEADS), ())(k, v)
    return _out_proj(SH.constrain(out, *Q_AXES), p["wo"]), cache


Attend = Callable[..., torch.Tensor]


def _dense_logits(qg: torch.Tensor, k: torch.Tensor, valid_len: int
                  ) -> torch.Tensor:
    """(b, kv, g, S) float32 logits of grouped queries over a float cache
    block, the slots from ``valid_len`` on masked to -1e30."""
    hd = qg.shape[-1]
    logits = torch.einsum("bngk,bsnk->bngs", qg, k.float()) / (hd ** 0.5)
    valid = torch.arange(k.shape[1], device=qg.device) < valid_len
    return torch.where(valid, logits, -1e30)


def dense_partial(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  valid_len: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The bfloat16 cache's counterpart of ``decode_attention_partial``:
    (out (b, kv, g, hd), lse (b, kv, g)) float32 of grouped queries ``qg``
    over the slots ``< valid_len`` of a (b, S, kv, hd) block; zeros and
    ``-inf`` when ``valid_len <= 0``."""
    if valid_len <= 0:
        return qg.new_zeros(qg.shape), qg.new_full(qg.shape[:-1],
                                                   float("-inf"))
    logits = _dense_logits(qg, k, valid_len)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bngs,bsnk->bngk", w, v.float())
    return out, torch.logsumexp(logits, dim=-1)


def combine_partials(out: torch.Tensor, lse: torch.Tensor,
                     reduce: Callable) -> torch.Tensor:
    """The attention over a whole cache from each rank's block of it:
    ``out`` (..., hd) and ``lse`` (...) float32 of this rank's block,
    combined by ``reduce(t, op)`` (``t`` reduced over the ranks that hold
    the blocks, ``op`` "max" or "sum"; every rank takes part): a MAX of
    ``lse`` to ``m``, then one SUM of ``[exp(lse - m) * out, exp(lse -
    m)]`` and a division. An empty block (``lse = -inf``) weighs exactly
    0; some block holds slot 0, so the sum of the weights is at least
    1."""
    m = reduce(lse.clone(), "max")
    w = torch.exp(lse - m)[..., None]
    packed = reduce(torch.cat([out * w, w], dim=-1), "sum")
    return packed[..., :-1] / packed[..., -1:]


@SH.in_mesh_context
def attention_decode(p: Params, x: torch.Tensor, cfg: ArchConfig, cache,
                     pos: int, attend: Attend | None = None):
    """One-token decode against the KV cache, written in place.

    x: (B, 1, D); pos: the new token's absolute position (a Python int, so
    the decode loop reads nothing back from the card). Sliding-window
    layers use the cache as a ring buffer of size ``window``. With a
    ``QuantKVCache`` the attention runs in ``attend`` (by default the
    ``decode_attention`` kernel) on q grouped to (B, KV, G, hd) in float32
    and scaled by ``hd**-0.5``, over ``valid_len = min(pos + 1, size)``
    positions: the whole ring once it has wrapped, else the slots up to
    ``pos``, exactly the reference's mask. ``attend`` lets a caller swap
    in the plain version on the same device. Without a window, a ``pos``
    past the cache raises a ``ValueError`` (the reference's clamped write
    would overwrite the last slot). On a mesh the slot's write and the
    attention run in one local region on the rank's (batch, kv-head)
    block of the cache, the kernel on the rank's local shapes.

    A cache striped by ``kv_seq`` (its ``seq_block``) takes
    :func:`_decode_seq_block` instead; there ``attend`` takes the partial
    form's arguments and returns (out, lse) (by default
    ``decode_attention_partial``)."""
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(p, x, cfg, positions)
    blk = cache.seq_block
    size = blk.size if blk else cache.k.shape[1]
    if not cfg.sliding_window and pos >= size:
        raise ValueError(f"decode position {pos} is past the KV cache's "
                         f"{size} positions (no sliding window)")
    slot = pos % size if cfg.sliding_window else pos
    valid_len = min(pos + 1, size)
    if blk is not None:
        out = _decode_seq_block(q, k, v, cache, slot, valid_len, attend)
        return _out_proj(out, p["wo"]), cache

    def attend_cached(q, k, v):
        """The cache's slot written and attended, on this rank's block."""
        b, _, h, hd = q.shape
        kv = cache.k.shape[2]
        _write_slots(cache, slice(slot, slot + 1), k, v)
        if isinstance(cache, QuantKVCache):
            qg = _group_q(q, kv)[:, 0].float() * hd ** -0.5  # (b, kv, g, hd)
            out = (attend or decode_attention)(
                qg.contiguous(), cache.k, cache.v, cache.k_scale,
                cache.v_scale, valid_len)
        else:
            qg = _group_q(q, kv)[:, 0].float()              # (b, kv, g, hd)
            w = torch.softmax(_dense_logits(qg, cache.k, valid_len), dim=-1)
            out = torch.einsum("bngs,bsnk->bngk", w, cache.v.float())
        return out.reshape(b, 1, h, hd).to(q.dtype)

    out = _on_kv_block(attend_cached, q, k, v, cfg)
    return _out_proj(out, p["wo"]), cache


def _decode_seq_block(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      cache, slot: int, valid_len: int,
                      attend: Attend | None) -> torch.Tensor:
    """One decode step's attention over a cache striped by ``kv_seq``.
    q, k and v are gathered to every head of the rank's rows (small:
    (B, 1, H, hd)); the rank that owns ``slot`` writes it; every rank
    attends every head of its rows over its block of slots, the slots
    below ``clamp(valid_len - first, 0, length)`` (the int8 cache on the
    ``decode_attention_partial`` kernel, the bfloat16 one in
    :func:`dense_partial`), and the blocks' outputs are combined over the
    ranks that stripe the slots (:func:`combine_partials`). Returns the
    output placed as q (``Q_AXES``: the rank's own head block)."""
    blk = cache.seq_block

    def local(q, k, v):
        b, _, h, hd = q.shape
        kv = cache.k.shape[2]
        if blk.first <= slot < blk.first + blk.length:
            at = slot - blk.first
            _write_slots(cache, slice(at, at + 1), k, v)
        count = min(max(valid_len - blk.first, 0), blk.length)
        qg = _group_q(q, kv)[:, 0].float()                  # (b, kv, g, hd)
        if isinstance(cache, QuantKVCache):
            out, lse = (attend or decode_attention_partial)(
                (qg * hd ** -0.5).contiguous(), cache.k, cache.v,
                cache.k_scale, cache.v_scale, count)
        else:
            out, lse = dense_partial(qg, cache.k, cache.v, count)
        out = combine_partials(out, lse, lambda t, op: SH.all_reduce_axes(
            t, op, blk.axes))
        return out.reshape(b, 1, h, hd).to(q.dtype)

    out = SH.local_map_axes(local, (WHOLE_HEADS,) * 3, (WHOLE_HEADS,))(
        q, k, v)
    return SH.constrain(out, *Q_AXES)


# ---------------------------------------------------------------------------
# FFN (dense)
# ---------------------------------------------------------------------------

def init_ffn(cfg: ArchConfig, d_ff: int | None = None, device="cpu",
             generator: torch.Generator | None = None,
             trainable: bool = False) -> Params:
    """The reference's distributions: normal x ``d**-0.5`` into the FFN,
    normal x ``f**-0.5`` out of it, zero biases."""
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    s_in, s_out = d ** -0.5, f ** -0.5
    t = trainable
    if cfg.activation in ("swiglu", "geglu"):
        p = {
            "w_gate": _normal((d, f), s_in, cfg, device, generator, t),
            "w_up": _normal((d, f), s_in, cfg, device, generator, t),
            "w_down": _normal((f, d), s_out, cfg, device, generator, t),
        }
    else:
        dt = _leaf_dtype(cfg, t)
        p = {
            "w_up": _normal((d, f), s_in, cfg, device, generator, t),
            "w_down": _normal((f, d), s_out, cfg, device, generator, t),
            "b_up": _param(torch.zeros(f, dtype=dt, device=device), t),
            "b_down": _param(torch.zeros(d, dtype=dt, device=device), t),
        }
    return nn.ParameterDict(p)


def _imc_parts(x: torch.Tensor, w: torch.Tensor, cfg: ArchConfig,
               amax=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(``x @ w`` exact, the SpecPCM chain's ``x @ w``) in float32 over
    the ff columns of ``x`` and rows of ``w`` at hand, the analog value
    without autograd; ``amax(t)`` completes the scales' maxima over the
    blocks of ff that other ranks hold (None: ff is whole here)."""
    acfg = ArrayConfig(adc_bits=cfg.imc_adc_bits,
                       bits_per_cell=cfg.imc_mlc_bits)
    dac = acfg.dac_levels
    xf, wf = x.float(), w.float()
    # the exact product first: it holds the last tensors autograd saves
    # in a block, so a remat's recompute stops before the analog chain,
    # whose value backward never reads (as XLA drops it from the
    # reference's rematerialized forward)
    y_exact = xf @ wf
    with torch.no_grad():
        mx = xf.abs().amax(-1, keepdim=True)
        mw = wf.abs().amax(0, keepdim=True)
        if amax is not None:
            mx, mw = amax(mx), amax(mw)
        # divisors as tensors: a Python-scalar divisor may become a
        # multiply by its reciprocal on the card
        mx = torch.clamp(mx, min=1e-6)
        sx = mx / torch.full_like(mx, dac)
        mw = torch.clamp(mw, min=1e-6)
        sw = mw / torch.full_like(mw, cfg.imc_mlc_bits)
        xq = torch.round(xf / sx)
        wq = torch.round(wf / sw)
        f = wq.shape[0]
        pad = (-f) % acfg.cols
        q = F.pad(xq.reshape(-1, f), (0, pad)).contiguous()
        wt = F.pad(wq.t(), (0, pad)).contiguous()        # (d_out, f + pad)
        y_imc = imc_mvm(q, wt, full_scale=default_full_scale(acfg),
                        tile_cols=acfg.cols, dac_limit=dac,
                        adc_levels=acfg.adc_levels)
        y_imc = y_imc.reshape(*x.shape[:-1], -1) * sx * sw
    return y_exact, y_imc


# the logical axes of _imc_linear's (B, S, F) input and (F, D) weight
IMC_X_AXES = ("batch", None, "ff")
IMC_W_AXES = ("ff", None)
IMC_Y_AXES = ("batch", None, None)


def _imc_linear(x: torch.Tensor, w: torch.Tensor, cfg: ArchConfig
                ) -> torch.Tensor:
    """``x @ w`` through the SpecPCM analog chain, with a straight-through
    gradient: the value is the chain's, the gradient the exact matmul's.

    Activations are quantized to the DAC range ([-3, 3]) per token and
    weights to [-mlc, mlc] per output column, as the reference computes
    them; the quantized product then runs in ``imc_mvm`` (the kernel on
    CUDA tensors, its plain version on CPU tensors) over d_ff padded to
    whole 128-column tiles, and is scaled back by ``sx * sw``. The tiles'
    partials are integers below 128 * 9, exact in float32 in any order,
    so the ADC codes equal the reference's; ``y_imc`` differs from it only
    in the order the codes times lsb are summed.

    On a mesh ``x`` is ``ff``-sharded (``IMC_X_AXES``). When each rank's
    block of ff is whole 128-column tiles the chain runs on the rank's
    block (``imc_mvm`` on its local shape), the scales' maxima all-reduced
    over the ranks that share a row (``sx`` and ``sw`` are the whole
    ff's, as the reference's), and the ranks' scaled outputs are summed in
    float32 (a partial sum: an order other than the reference's); else
    ``x`` and ``w`` are gathered over ff first and every rank runs the
    whole chain."""
    if not (SH.on_mesh(x) or SH.on_mesh(w)):
        y_exact, y_imc = _imc_parts(x, w, cfg)
        # straight-through: value = imc, gradient = exact
        y = y_exact + (y_imc - y_exact).detach()
        return y.to(x.dtype)
    cols = ArrayConfig().cols
    _, fl = SH.local_range(IMC_X_AXES, x.shape, 2)
    tiled = fl < x.shape[-1] and fl % cols == 0
    axes = SH.dim_axes(IMC_X_AXES, x.shape, 2) if tiled else ()

    def amax(t):
        return SH.all_reduce_axes(t, "max", axes)

    def local(xl, wl):
        y_exact, y_imc = _imc_parts(xl, wl, cfg, amax if axes else None)
        return y_exact + (y_imc - y_exact).detach()

    if tiled:
        run = SH.local_map_axes(local, (IMC_X_AXES, IMC_W_AXES),
                                (IMC_Y_AXES,), reduced=("ff",))
    else:
        run = SH.local_map_axes(local, (IMC_Y_AXES, (None, None)),
                                (IMC_Y_AXES,))
    # the ranks' float32 partial sums reduced, then one cast, as the
    # reference casts its float32 sum
    return SH.constrain(run(x, w), *IMC_Y_AXES).to(x.dtype)


def apply_ffn(p: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Without autograd the gate's activation and product are taken in
    place (each elementwise step rounds as its out-of-place form), which
    keeps the (tokens, d_ff) buffers of a full-width prefill to two; under
    autograd, and on a mesh, they are out of place, since backward reads
    their inputs (and a DTensor's in-place op keeps its placement).
    With ``cfg.imc_linear`` the down-projection is :func:`_imc_linear`."""
    dt = x.dtype
    # (not on a mesh: an in-place op cannot change a DTensor's placement)
    inplace = not torch.is_grad_enabled() and not SH.on_mesh(x)
    x = gather_seq(x)
    hidden = ("batch", None, "ff")

    def up(name):
        return project(x, gather_fsdp(p[name].to(dt), W_IN_AXES), hidden,
                       dt)

    if cfg.activation in ("swiglu", "geglu"):
        h = up("w_gate")
        u = up("w_up")
        if cfg.activation == "swiglu":
            h = F.silu(h, inplace=inplace)
        else:
            h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
        h = h.mul_(u) if inplace else h * u
        del u
    else:
        h = F.gelu(up("w_up") + p["b_up"].to(dt), approximate="tanh")
    h = SH.constrain(h, *IMC_X_AXES)
    if cfg.imc_linear:
        y = _imc_linear(h, p["w_down"], cfg)
    else:
        y = project(h, gather_fsdp(p["w_down"].to(dt), W_OUT_AXES),
                    SEQ_AXES)
    if "b_down" in p:
        y = y + p["b_down"].to(dt)
    return y


# ---------------------------------------------------------------------------
# MoE (GShard-style capacity dispatch + shared experts)
# ---------------------------------------------------------------------------

def init_moe(cfg: ArchConfig, device="cpu",
             generator: torch.Generator | None = None,
             trainable: bool = False) -> Params:
    """The reference's distributions: the router and the experts' input
    matrices normal x ``d**-0.5``, the output matrices (the shared
    experts' too) normal x ``expert_d_ff**-0.5``. The router is kept in
    float32 whatever ``cfg.dtype`` is: the reference multiplies it in
    float32 without a cast, and a bfloat16 copy would change routing."""
    d, e, f = cfg.d_model, cfg.num_experts, cfg.expert_d_ff
    s_in, s_out = d ** -0.5, f ** -0.5
    t = trainable
    p = {
        "router": _normal((d, e), s_in, cfg, device, generator, t,
                          dtype=torch.float32),
        "w_gate": _normal((e, d, f), s_in, cfg, device, generator, t),
        "w_up": _normal((e, d, f), s_in, cfg, device, generator, t),
        "w_down": _normal((e, f, d), s_out, cfg, device, generator, t),
    }
    if cfg.num_shared_experts:
        fs = f * cfg.num_shared_experts
        p["shared_gate"] = _normal((d, fs), s_in, cfg, device, generator, t)
        p["shared_up"] = _normal((d, fs), s_in, cfg, device, generator, t)
        p["shared_down"] = _normal((fs, d), s_out, cfg, device, generator,
                                   t)
    return nn.ParameterDict(p)


def moe_groups(tokens: int, cfg: ArchConfig) -> tuple[int, int, int]:
    """(group size, groups, capacity) of an MoE layer over ``tokens``
    tokens, as the reference computes them; a token count that is not a
    multiple of the group raises (the reference asserts)."""
    g_sz = min(cfg.moe_group_size, tokens)
    if tokens % g_sz:
        raise ValueError(f"{tokens} tokens are not a multiple of the MoE "
                         f"group size {g_sz}")
    cap = max(int(g_sz * cfg.top_k * cfg.capacity_factor
                  / cfg.num_experts), 1)
    return g_sz, tokens // g_sz, cap


@dataclasses.dataclass
class MoERoute:
    """One MoE layer's routing of its (G, g_sz) token groups, per
    (group, token, top-k slot)."""
    weight: torch.Tensor   # float32 top-k gates over their sum
    expert: torch.Tensor   # int64, in lax.top_k's order
    pos: torch.Tensor      # int32 arrival position within the expert
    keep: torch.Tensor     # bool: pos < capacity


def moe_route(router: torch.Tensor, xt: torch.Tensor, cfg: ArchConfig,
              cap: int) -> MoERoute:
    """Router, top-k and capacity of ``xt`` (G, g_sz, D): float32 router
    product and softmax; the top ``k`` experts in ``lax.top_k``'s order
    (descending gates, ties to the lower expert); the gates normalised by
    ``max(sum, 1e-9)``; arrival order over the group's (token, slot)
    pairs flattened token-major, and a pair kept while its expert has
    taken fewer than ``cap``. No host synchronization."""
    e, k = cfg.num_experts, cfg.top_k
    gates = torch.softmax(xt.float() @ router.float(), dim=-1)
    # torch.topk promises no order among ties, so it ranks unique keys:
    # the gates are >= 0, whose float32 bit patterns order as the values
    # do, and the expert index breaks ties toward the lower one
    idx = torch.arange(e, device=xt.device)
    key = gates.detach().view(torch.int32).to(torch.int64) * e + (e - 1 - idx)
    expert = torch.topk(key, k, dim=-1).indices
    topv = torch.gather(gates, -1, expert)
    weight = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    g, g_sz = expert.shape[:2]
    flat = expert.reshape(g, g_sz * k)
    onehot = (flat[..., None] == idx).to(torch.int32)        # (G, g_sz*k, E)
    before = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot
    pos = torch.gather(before, -1, flat[..., None]).reshape(g, g_sz, k)
    return MoERoute(weight=weight, expert=expert, pos=pos, keep=pos < cap)


# the logical axes of the MoE's expert leaves (the reference's
# ``init_moe``), its (G, g_sz, D) token groups (``xt``) and its output
MOE_IN_AXES = ("experts", "fsdp", None)
MOE_OUT_AXES = ("experts", None, "fsdp")
MOE_W_AXES = ("experts", None, None)
MOE_X_AXES = ("batch", None, None)


def _routed(tokens: torch.Tensor, router: torch.Tensor,
            w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
            cfg: ArchConfig, g_sz: int, cap: int, first: int = 0,
            dtype: torch.dtype | None = None) -> torch.Tensor:
    """The routed experts' weighted sum over ``tokens`` (n, D), grouped
    ``g_sz`` a group with capacity ``cap``, from the experts ``first ..
    first + El`` whose (El, ...) weights are given (all E by default). The
    whole routing is computed; the pairs routed to experts held elsewhere
    land in the overflow row and are weighted 0, so the ranks that each
    hold a block of the experts sum to the whole output. The combine is
    taken in ``dtype`` (default the tokens')."""
    dt = tokens.dtype
    n, d = tokens.shape
    k = cfg.top_k
    el = w_gate.shape[0]
    g = n // g_sz
    r = moe_route(router, tokens.view(g, g_sz, d), cfg, cap)

    slots = el * g * cap
    dev = tokens.device
    group = torch.arange(g, device=dev)[:, None, None]
    local = r.expert - first
    held = r.keep & (local >= 0) & (local < el)
    dest = torch.where(held, (local * g + group) * cap + r.pos,
                       slots).reshape(n * k)
    token = torch.arange(n, device=dev)[:, None].expand(n, k).reshape(n * k)
    src = torch.full((slots + 1,), n, dtype=torch.int64,
                     device=dev).scatter(0, dest, token)
    padded = torch.cat([tokens, tokens.new_zeros(1, d)])    # row n: zeros
    expert_in = padded[src[:slots]].view(el, g * cap, d)
    h = F.silu(torch.bmm(expert_in, w_gate))
    h = h * torch.bmm(expert_in, w_up)
    expert_out = torch.bmm(h, w_down).view(slots, d)

    picked = expert_out[torch.where(dest < slots, dest, 0)].view(n, k, d)
    w = (r.weight * held).to(dt).view(n, 1, k)
    cd = dtype or dt
    return torch.bmm(w.to(cd), picked.to(cd)).view(n, d)


def apply_moe(p: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Top-k capacity-factor MoE over ``x`` (B, S, D) in token groups of
    ``moe_group_size``, dispatched by index into an (E, G, cap, D) buffer:
    a kept pair lands in its (expert, group, arrival position) slot, a
    dropped one in an overflow row past the buffer that is never read;
    each token then sums its kept pairs' expert outputs times their
    gates (a dropped pair reads row 0 with weight 0, as the reference's
    combine multiplies it by 0). Plus the shared experts' SwiGLU over
    ``expert_d_ff * num_shared_experts``.

    On a mesh the experts are split over ``model`` (expert parallelism,
    ``MOE_W_AXES``, their FSDP dim gathered) and the token groups over
    the ``batch`` axes as the reference places ``xt``: each rank takes its
    data block's whole groups (the sequence gathered; every rank when the
    groups do not divide, as one group at decode), routes them all, as
    every rank of the block does alike, runs the experts it holds on an
    (E / model, G_local, cap, D) buffer and returns its partial combine in
    float32; the partial sums are reduced over the experts' ranks in
    float32 and rounded once. The shared experts take the dense FFN's
    route (``ff``-sharded products)."""
    dt = x.dtype
    b, s, d = x.shape
    g_sz, g, cap = moe_groups(b * s, cfg)
    if not SH.on_mesh(x):
        y = _routed(x.reshape(b * s, d), p["router"], p["w_gate"].to(dt),
                    p["w_up"].to(dt), p["w_down"].to(dt), cfg, g_sz,
                    cap).view(b, s, d)
        if cfg.num_shared_experts:
            sg = F.silu(x @ p["shared_gate"].to(dt))
            su = x @ p["shared_up"].to(dt)
            y = y + (sg * su) @ p["shared_down"].to(dt)
        return y
    xs = gather_seq(x)
    # the rank's batch rows are its token groups when both split over the
    # same mesh axes; otherwise each rank routes the whole batch
    x_axes = MOE_X_AXES
    if SH.dim_axes(MOE_X_AXES, (g, g_sz, d), 0) != SH.dim_axes(
            MOE_X_AXES, (b, s, d), 0):
        x_axes = (None, None, None)
    first, _ = SH.local_range(MOE_W_AXES, p["w_gate"].shape, 0)
    weights = [gather_fsdp(p[name].to(dt), axes) for name, axes in (
        ("w_gate", MOE_IN_AXES), ("w_up", MOE_IN_AXES),
        ("w_down", MOE_OUT_AXES))]

    def local(xl, router, wg, wu, wd):
        rows = xl.shape[0]
        y = _routed(xl.reshape(rows * s, d).to(dt), router, wg, wu, wd, cfg,
                    g_sz, cap, first, torch.float32)
        return y.view(rows, s, d)

    y = SH.local_map_axes(
        local, (x_axes, (None, None)) + (MOE_W_AXES,) * 3,
        (MOE_X_AXES,), reduced=("experts",))(xs, p["router"], *weights)
    # the float32 partial sums reduced onto the residual's layout, then
    # one rounding
    y = SH.constrain(y, *SEQ_AXES).to(dt)
    if cfg.num_shared_experts:
        def up(name):
            return project(xs, gather_fsdp(p[name].to(dt), W_IN_AXES),
                           ("batch", None, "ff"), dt)

        h = F.silu(up("shared_gate")) * up("shared_up")
        y = y + project(h, gather_fsdp(p["shared_down"].to(dt),
                                       W_OUT_AXES), SEQ_AXES)
    return y
