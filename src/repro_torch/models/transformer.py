"""Model assembly (``repro.models.transformer``): blocks (``attn_ffn``
for the dense and VLM families, ``attn_moe`` for the MoE one, ``hybrid``
for Hymba's attention and Mamba heads side by side, ``mlstm`` and
``slstm`` for xLSTM, ``enc`` and ``dec_cross`` for the encoder-decoder),
the LM's parameters, caches, the training forward pass, the encoder,
prefill and decode.

The reference stacks a homogeneous family's layer parameters on a leading
``layer`` axis and scans over them (``lax.scan``); here the layers are an
``nn.ModuleList`` walked by a Python loop. The ``ssm`` family's blocks
differ from layer to layer (every ``ssm_ratio``-th is an sLSTM), so the
reference keeps them in a list ``params["blocks"]`` and unrolls it; the
port's :class:`LM` has a ``blocks`` list for that family in place of
``layers``. The cache is a list with one entry a layer: a ``KVCache`` /
``QuantKVCache`` (attention, updated in place), ``(KV cache,
MambaState)`` for a hybrid layer, ``(KV cache, CrossKV)`` for a
``dec_cross`` layer, an ``MLSTMState`` or an ``SLSTMState`` (replaced by
each step's new state); on a ``DeviceMesh`` each holds this rank's block
(the recurrent states as the reference's ``cache_axes_for`` places them,
``recurrent.*_STATE_AXES``). The training forward wraps each block in the
remat policy (``_remat``), as the reference wraps its scan body or each
unrolled block.

A prefill leaves each recurrent layer the state after the whole prompt,
computed as the reference computes it (``_*_state_after``: one scan over
the whole prompt, or a closed form), not the last carry of the chunked
training scan, which rounds differently.

The encoder-decoder (``whisper_medium``) runs ``encode`` (sinusoids, then
a stack of non-causal ``enc`` blocks with RoPE, then ``enc_norm``) over
the stub frontend's frame embeddings, and its decoder's ``dec_cross``
blocks attend to that memory (no RoPE). The VLM (``internvl2_76b``) is a
decoder-only ``attn_ffn`` stack fed patch embeddings before the text
(``Model.loss`` / ``prefill``). A ``dec_cross`` layer's cross K/V are
kept at the memory's own length: the reference keeps them in a
``max_len``-row buffer of zeros and decode attends every row, zeros
included (ROADMAP.md, Queue 3, F4).
"""

from __future__ import annotations

import dataclasses
import functools

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ArchConfig
from repro_torch.dist import sharding as SH
from repro_torch.models import layers as L
from repro_torch.models import recurrent as R

KINDS = ("attn_ffn", "attn_moe", "hybrid", "mlstm", "slstm", "enc",
         "dec_cross")


def block_kind(cfg: ArchConfig, layer_idx: int = 0) -> str:
    """The reference's rule: MoE, hybrid, or for the ``ssm`` family an
    sLSTM block every ``ssm_ratio``-th layer and mLSTM blocks between;
    ``attn_ffn`` otherwise (the VLM and audio families too: an
    encoder-decoder's stacks are chosen by :func:`decoder_kind`)."""
    if cfg.family == "moe":
        return "attn_moe"
    if cfg.family == "hybrid":
        return "hybrid"
    if cfg.family == "ssm":
        if cfg.ssm_ratio and (layer_idx + 1) % cfg.ssm_ratio == 0:
            return "slstm"
        return "mlstm"
    return "attn_ffn"


def decoder_kind(cfg: ArchConfig, layer_idx: int = 0) -> str:
    """The kind of the LM's ``layer_idx``-th decoder block: ``dec_cross``
    for an encoder-decoder (as the reference's ``init_lm``,
    ``init_cache`` and forwards choose it), else :func:`block_kind`."""
    return "dec_cross" if cfg.is_encoder_decoder else block_kind(
        cfg, layer_idx)


def stack_name(cfg: ArchConfig) -> str:
    """Where the LM keeps its blocks: ``blocks`` (a list of unlike blocks,
    the ``ssm`` family) or ``layers``."""
    return "blocks" if cfg.family == "ssm" else "layers"


class Block(nn.ModuleDict):
    """One block: its parameter groups by name (``norm1``, ``attn``,
    ``mix``, ...), read as ``p["attn"]``, and the leaves the reference
    keeps beside them (the hybrid's ``alpha``), read as ``p["alpha"]``."""

    def __init__(self, groups: dict, **leaves: nn.Parameter):
        super().__init__(groups)
        for name, t in leaves.items():
            self.register_parameter(name, t)

    def __getitem__(self, key: str):
        if key in self._parameters:
            return self._parameters[key]
        return super().__getitem__(key)


def init_block(cfg: ArchConfig, kind: str, device="cpu",
               generator: torch.Generator | None = None,
               trainable: bool = False) -> Block:
    if kind not in KINDS:
        raise ValueError(kind)
    t = trainable
    norm1 = L.init_norm(cfg, device=device, trainable=t)
    if kind in ("mlstm", "slstm"):
        init = R.init_mlstm if kind == "mlstm" else R.init_slstm
        return Block({"norm1": norm1,
                      "mix": init(cfg, device, generator, t)})
    p = {"norm1": norm1, "attn": L.init_attention(cfg, device, generator, t)}
    if kind == "dec_cross":
        p["norm_x"] = L.init_norm(cfg, device=device, trainable=t)
        p["xattn"] = L.init_attention(cfg, device, generator, t)
    p["norm2"] = L.init_norm(cfg, device=device, trainable=t)
    if kind == "attn_moe":
        p["moe"] = L.init_moe(cfg, device, generator, t)
    else:
        p["ffn"] = L.init_ffn(cfg, device=device, generator=generator,
                              trainable=t)
    if kind == "hybrid":
        p["mamba"] = R.init_mamba(cfg, device, generator, t)
        return Block(p, alpha=L._param(torch.full((2,), 0.5, device=device),
                                       t))
    return Block(p)


def _mlp(p: nn.ModuleDict, h: torch.Tensor, cfg: ArchConfig, kind: str
         ) -> torch.Tensor:
    """The block's second half: the MoE layer or the dense FFN."""
    if kind == "attn_moe":
        return L.apply_moe(p["moe"], h, cfg)
    return L.apply_ffn(p["ffn"], h, cfg)


def _hybrid_mix(p, attn: torch.Tensor, ssm: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """``alpha[0] * attn + alpha[1] * ssm``, alpha cast to the activation
    dtype."""
    alpha = p["alpha"].to(dtype)
    return alpha[0] * attn + alpha[1] * ssm


@dataclasses.dataclass
class CrossKV:
    """A ``dec_cross`` layer's cross-attention keys and values over the
    encoder memory, (B, S_enc, KV, hd) in ``cfg.dtype``: empty (S_enc =
    0) until a prefill stores them."""
    k: torch.Tensor
    v: torch.Tensor


def cross_kv(p: nn.ParameterDict, memory: torch.Tensor, cfg: ArchConfig
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The memory's keys and values (no RoPE, no bias), in its dtype; on a
    mesh the memory's sequence and the weights' FSDP dim gathered first,
    the K/V placed by ``layers.KV_AXES``."""
    dt = memory.dtype
    memory = L.gather_seq(memory)
    k, v = (SH.constrain(L._proj(memory, p[w], L.WKV_AXES, dt), *L.KV_AXES)
            for w in ("wk", "wv"))
    return k, v


@SH.in_mesh_context
def _cross_attention(p: nn.ParameterDict, x: torch.Tensor, memory_kv,
                     cfg: ArchConfig) -> torch.Tensor:
    """Non-causal attention of ``x`` over the memory's K/V (no RoPE). On a
    mesh each rank attends its (batch, kv-head) block: of the K/V
    ``DTensor``s ``cross_kv`` gives, or of a decode cache's ``CrossKV``,
    which holds that block as plain tensors."""
    k, v = memory_kv
    q = SH.constrain(L._proj(L.gather_seq(x), p["wq"], L.WQ_AXES, x.dtype),
                     *L.Q_AXES)

    def attend(q, k, v):
        return L.attention_full(q, k, v, cfg, causal=False)

    if SH.on_mesh(q) and not SH.on_mesh(k):
        out = SH.local_map_axes(lambda ql: attend(ql, k, v), (L.Q_AXES,),
                                (L.Q_AXES,))(q)
    else:
        out = L._on_kv_block(attend, q, k, v, cfg)
    return L._out_proj(SH.constrain(out, *L.Q_AXES), p["wo"])


def _cross_cache(k: torch.Tensor, v: torch.Tensor, cfg: ArchConfig
                 ) -> CrossKV:
    """The cross K/V a prefill stores, in ``cfg.dtype``: on a mesh this
    rank's (batch, kv-head) block as plain tensors, as the self-attention
    cache holds its own."""
    dt = L._dtype(cfg)
    kept = []

    def keep(_, kl, vl):
        kept.extend(t.to(dt).contiguous() for t in (kl, vl))

    L._on_kv_block(keep, None, k, v, cfg)
    return CrossKV(k=kept[0], v=kept[1])


def apply_block_train(p: nn.ModuleDict, x: torch.Tensor, cfg: ArchConfig,
                      kind: str, memory: torch.Tensor | None = None
                      ) -> torch.Tensor:
    """One block over a full sequence (training; ``enc``: the encoder,
    non-causal; ``dec_cross``: also attending to ``memory``). The
    reference's ``constrain`` calls are the identity with no mesh."""
    if kind not in KINDS:
        raise ValueError(kind)
    h = L.apply_norm(p["norm1"], x, cfg)
    if kind == "mlstm":
        return x + R.mlstm_train(p["mix"], h, cfg)
    if kind == "slstm":
        return x + R.slstm_train(p["mix"], h, cfg)
    attn = L.attention_train(p["attn"], h, cfg, causal=kind != "enc")
    if kind == "dec_cross":
        x = x + attn
        h = L.apply_norm(p["norm_x"], x, cfg)
        attn = _cross_attention(p["xattn"], h, cross_kv(p["xattn"], memory,
                                                        cfg), cfg)
    if kind == "hybrid":
        attn = _hybrid_mix(p, attn, R.mamba_train(p["mamba"], h, cfg),
                           x.dtype)
    # the reference constrains the attention and MLP outputs to the
    # sequence-sharded layout before each residual add (after it with
    # baseline_mode); its dec_cross block has no constrain
    seq = kind != "dec_cross"
    x = _residual(x, attn, seq)
    h = L.apply_norm(p["norm2"], x, cfg)
    return _residual(x, _mlp(p, h, cfg, kind), seq)


def _residual(x: torch.Tensor, y: torch.Tensor, constrain: bool
              ) -> torch.Tensor:
    """``x + y`` in x's dtype, with the reference's ``constrain`` to
    ("batch", "seq_shard", None) on y before the add, or on the sum with
    ``baseline_mode()``."""
    y = y.to(x.dtype)
    if not constrain:
        return x + y
    if SH.baseline_mode():
        return SH.constrain(x + y, *L.SEQ_AXES)
    return x + SH.constrain(y, *L.SEQ_AXES)


def init_block_cache(cfg: ArchConfig, kind: str, batch: int, max_len: int,
                     device="cpu", mesh=None):
    if kind in ("attn_ffn", "attn_moe"):
        return L.init_kv_cache(cfg, batch, max_len, device=device, mesh=mesh)
    if kind == "hybrid":
        return (L.init_kv_cache(cfg, batch, max_len, device=device,
                                mesh=mesh),
                R.init_mamba_state(cfg, batch, device, mesh))
    if kind == "mlstm":
        return R.init_mlstm_state(cfg, batch, device, mesh)
    if kind == "slstm":
        return R.init_slstm_state(cfg, batch, device, mesh)
    if kind == "dec_cross":
        rows, _, kv = L.kv_block(cfg, batch, mesh)
        empty = torch.zeros((rows, 0, kv, cfg.resolved_head_dim),
                            dtype=L._dtype(cfg), device=device)
        return (L.init_kv_cache(cfg, batch, max_len, device=device,
                                mesh=mesh),
                CrossKV(k=empty, v=empty.clone()))
    raise ValueError(kind)


def apply_block_prefill(p: nn.ModuleDict, x: torch.Tensor, cfg: ArchConfig,
                        kind: str, cache, memory: torch.Tensor | None = None):
    """One block over the prompt: its output and its cache entry (the KV
    cache filled in place; a recurrent layer's state after the prompt; a
    ``dec_cross`` layer's cross K/V over the whole ``memory``)."""
    if kind not in KINDS or kind == "enc":
        raise ValueError(kind)
    h = L.apply_norm(p["norm1"], x, cfg)
    if kind in ("mlstm", "slstm", "hybrid"):
        # read two or three times (the layer, its state after the prompt,
        # a hybrid's attention): on a mesh its sequence is gathered once
        h = L.gather_seq(h)
    if kind == "mlstm":
        return (x + R.mlstm_train(p["mix"], h, cfg),
                _mlstm_state_after(p["mix"], h, cfg))
    if kind == "slstm":
        return (x + R.slstm_train(p["mix"], h, cfg),
                _slstm_state_after(p["mix"], h, cfg))
    if kind == "hybrid":
        kvc, _ = cache
        attn, kvc = L.attention_prefill(p["attn"], h, cfg, kvc)
        ssm = R.mamba_train(p["mamba"], h, cfg)
        # the SSM state rolled forward over the whole prompt
        cache = (kvc, _mamba_state_after(p["mamba"], h, cfg))
        attn = _hybrid_mix(p, attn, ssm, x.dtype)
    elif kind == "dec_cross":
        kvc, _ = cache
        attn, kvc = L.attention_prefill(p["attn"], h, cfg, kvc)
        x = x + attn
        xk, xv = cross_kv(p["xattn"], memory, cfg)
        h = L.apply_norm(p["norm_x"], x, cfg)
        attn = _cross_attention(p["xattn"], h, (xk, xv), cfg)
        # stored at the memory's length, in cfg.dtype
        cache = (kvc, _cross_cache(xk, xv, cfg))
    else:
        attn, cache = L.attention_prefill(p["attn"], h, cfg, cache)
    x = x + attn
    h = L.apply_norm(p["norm2"], x, cfg)
    return x + _mlp(p, h, cfg, kind), cache


def apply_block_decode(p: nn.ModuleDict, x: torch.Tensor, cfg: ArchConfig,
                       kind: str, cache, pos: int,
                       attend: L.Attend | None = None):
    """One token a row; an MoE block routes the batch's B tokens as one
    group (as the reference's decode does), so its capacity is small and
    drops pairs as the reference's does. A ``dec_cross`` block attends
    to exactly the memory rows its prefill stored."""
    if kind not in KINDS or kind == "enc":
        raise ValueError(kind)
    h = L.apply_norm(p["norm1"], x, cfg)
    if kind == "mlstm":
        y, st = R.mlstm_decode(p["mix"], h, cfg, cache)
        return x + y, st
    if kind == "slstm":
        y, st = R.slstm_decode(p["mix"], h, cfg, cache)
        return x + y, st
    if kind == "hybrid":
        kvc, sst = cache
        attn, kvc = L.attention_decode(p["attn"], h, cfg, kvc, pos, attend)
        ssm, sst = R.mamba_decode(p["mamba"], h, cfg, sst)
        cache = (kvc, sst)
        attn = _hybrid_mix(p, attn, ssm, x.dtype)
    elif kind == "dec_cross":
        kvc, xkv = cache
        if xkv.k.shape[1] == 0:
            raise ValueError("a dec_cross layer decodes after a prefill has "
                             "stored its cross K/V")
        attn, kvc = L.attention_decode(p["attn"], h, cfg, kvc, pos, attend)
        x = x + attn
        h = L.apply_norm(p["norm_x"], x, cfg)
        attn = _cross_attention(p["xattn"], h, (xkv.k, xkv.v), cfg)
        cache = (kvc, xkv)
    else:
        attn, cache = L.attention_decode(p["attn"], h, cfg, cache, pos,
                                         attend)
    x = x + attn
    h = L.apply_norm(p["norm2"], x, cfg)
    return x + _mlp(p, h, cfg, kind), cache


# --- the states after a prompt (prefill of the recurrent layers) ---------

def _mamba_state_after(p, h: torch.Tensor, cfg: ArchConfig
                       ) -> R.MambaState:
    """The recurrence run again over the whole prompt (one associative
    scan), keeping only the final state; on a mesh each rank's batch
    block, every leaf whole (``recurrent.state_on_mesh``)."""
    if SH.on_mesh(h):
        return R.state_on_mesh(_mamba_state_after, p, h, cfg)
    xi_f, _, Bt, _, dt, a = R._mamba_inputs(p, h)
    decay = torch.exp(dt[..., None] * a)
    inp = (dt * xi_f)[..., None] * Bt[:, :, None, :]
    _, bb = R.associative_scan(R._affine, (decay, inp), dim=1)
    # a copy: a view would keep the whole (B, S, d, n) scan alive
    return R.MambaState(h=bb[:, -1].clone())


def _mlstm_state_after(p, h: torch.Tensor, cfg: ArchConfig
                       ) -> R.MLSTMState:
    """The closed form ``C = sum_s exp(F_T - F_s) i_s k_s v_s^T`` (and
    ``n`` alike) over the whole prompt, k and v in float32; on a mesh
    each rank's (batch, heads) block, ``w_up`` whole (its first half is
    ``xi`` whole over ``d_inner``)."""
    if SH.on_mesh(h):
        return R.state_on_mesh(_mlstm_state_after, p, h, cfg, R._by_heads)
    up = h @ p["w_up"].to(h.dtype)
    xf = up.chunk(2, dim=-1)[0].float()
    k = L._proj(xf, p["w_k"])
    v = L._proj(xf, p["w_v"])
    ig, fg = R._mlstm_gates(p, xf)
    Fs = torch.cumsum(torch.log(torch.clamp(fg, min=1e-9)), dim=1)
    wk = torch.exp(Fs[:, -1][:, None] - Fs) * ig            # (b, s, h)
    C = torch.einsum("bshk,bshl->bhkl", k * wk[..., None], v)
    n = torch.einsum("bshk,bsh->bhk", k, wk)
    return R.MLSTMState(C=C, n=n)


def _slstm_state_after(p, h: torch.Tensor, cfg: ArchConfig
                       ) -> R.SLSTMState:
    if SH.on_mesh(h):
        return R.state_on_mesh(_slstm_state_after, p, h, cfg)
    z, i, f = R._slstm_gates(p, h.float())
    _, c = R.associative_scan(R._affine, (f, i * z), dim=1)
    _, n = R.associative_scan(R._affine, (f, i), dim=1)
    return R.SLSTMState(c=c[:, -1].clone(),
                        n=torch.clamp(n[:, -1], min=1e-6))


# matmuls without batch dimensions: what the reference's "dots" policy
# (``dots_with_no_batch_dims_saveable``) keeps, the MoE router and shared
# experts' products among them; the attention's batched einsums and the
# MoE's expert and combine products (bmm, with the expert or token axis
# as batch) and its dispatch and combine gathers are recomputed
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, policy: str):
    """The reference's remat policies on one block: ``none`` keeps every
    activation, ``full`` keeps only the block's input and recomputes the
    block in backward, ``dots`` recomputes it but keeps the outputs of
    its unbatched matmuls."""
    if policy == "none":
        return fn
    if policy == "full":
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False)
    if policy == "dots":
        return functools.partial(
            ckpt.checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _save_dots))
    raise ValueError(f"unknown remat policy {policy!r} (full | dots | none)")


class LM(nn.Module):
    """The LM's parameters under the reference's names: ``embed`` (V, D),
    ``layers`` (one :class:`Block` per layer) or, for the ``ssm`` family,
    ``blocks`` (``stack``), ``final_norm``, unless embeddings are tied
    ``lm_head`` (D, V), and for an encoder-decoder ``enc_layers`` (one
    ``enc`` block per encoder layer) and ``enc_norm``. ``lm["embed"]``
    reads as ``params["embed"]`` does in the reference."""

    def __init__(self, embed: torch.Tensor, layers: list[nn.ModuleDict],
                 final_norm: nn.ParameterDict,
                 lm_head: torch.Tensor | None = None,
                 trainable: bool = False, stack: str = "layers",
                 enc_layers: list[nn.ModuleDict] | None = None,
                 enc_norm: nn.ParameterDict | None = None):
        super().__init__()
        if stack not in ("layers", "blocks"):
            raise ValueError(stack)
        self.embed = L._param(embed, trainable)
        self.stack = stack
        setattr(self, stack, nn.ModuleList(layers))
        self.final_norm = final_norm
        self.lm_head = (None if lm_head is None
                        else L._param(lm_head, trainable))
        self.enc_layers = (None if enc_layers is None
                           else nn.ModuleList(enc_layers))
        self.enc_norm = enc_norm

    def __getitem__(self, name: str):
        return getattr(self, name)


def init_lm(cfg: ArchConfig, device="cpu",
            generator: torch.Generator | None = None,
            trainable: bool = False, mesh=None) -> LM:
    """The port's own initialisation, drawn from ``generator`` on
    ``device``. It cannot reproduce ``jax.random``; it meets the
    reference's distributions: embed and lm_head normal x ``D**-0.5``,
    the scales of ``layers.init_attention`` / ``init_ffn`` / ``init_moe``
    and ``recurrent.init_mamba`` / ``init_mlstm`` / ``init_slstm``, zero
    biases, unit norms. Each matrix is drawn in float32 and cast to
    ``cfg.dtype`` before the next is drawn, except the leaves the
    reference uses in float32 (the MoE router, the recurrent layers'
    gates and sLSTM), which stay float32; ``trainable``: every leaf in
    ``cfg.param_dtype``, with gradients. An encoder-decoder's decoder
    blocks are ``dec_cross``, its ``num_encoder_layers`` encoder blocks
    ``enc``, drawn after the head.

    On a ``DeviceMesh`` (``mesh``) every rank draws the same values, and
    each leaf is placed by ``param_axes`` as soon as its block (or the
    embedding, the head) is drawn: a rank keeps its blocks, so the full
    model never lives on a rank at once (the peak is the largest leaf)."""
    V, D = cfg.padded_vocab, cfg.d_model
    t = trainable

    def block(kind: str) -> Block:
        b = init_block(cfg, kind, device, generator, t)
        axes = [_leaf_axes(kind, name.split(".")) for name, _ in
                b.named_parameters()]
        return SH.distribute_tree(b, axes, mesh)

    embed = SH.place(L._normal((V, D), D ** -0.5, cfg, device, generator, t),
                     EMBED_AXES, mesh)
    layers = [block(decoder_kind(cfg, i)) for i in range(cfg.num_layers)]
    lm_head = None
    if not cfg.tie_embeddings:
        lm_head = SH.place(L._normal((D, V), D ** -0.5, cfg, device,
                                     generator, t), HEAD_AXES, mesh)
    enc_layers = enc_norm = None
    if cfg.is_encoder_decoder:
        enc_layers = [block("enc") for _ in range(cfg.num_encoder_layers)]
        enc_norm = L.init_norm(cfg, device=device, trainable=t)
    lm = LM(embed, layers, L.init_norm(cfg, device=device, trainable=t),
            lm_head, t, stack_name(cfg), enc_layers, enc_norm)
    # the norms (replicated); the placed leaves are kept as they are
    return SH.distribute_tree(lm, param_axes(lm, cfg), mesh)


# the logical axes the reference's init functions give each leaf (a
# stacked layer's without its leading "layer"), by parameter group
_ATTN_AXES = {"wq": L.WQ_AXES, "wk": L.WKV_AXES, "wv": L.WKV_AXES,
              "wo": L.WO_AXES,
              "bq": ("heads", None), "bk": ("kv_heads", None),
              "bv": ("kv_heads", None)}
_FFN_AXES = {"w_gate": L.W_IN_AXES, "w_up": L.W_IN_AXES,
             "w_down": L.W_OUT_AXES, "b_up": ("ff",), "b_down": (None,)}
_MOE_AXES = {"router": (None, None), "w_gate": ("experts", "fsdp", None),
             "w_up": ("experts", "fsdp", None),
             "w_down": ("experts", None, "fsdp"),
             "shared_gate": ("fsdp", "ff"), "shared_up": ("fsdp", "ff"),
             "shared_down": ("ff", "fsdp")}
_MAMBA_AXES = {"w_in": ("fsdp", "ff"), "w_b": ("fsdp", None),
               "w_c": ("fsdp", None), "w_dt": ("fsdp", None),
               "a_log": (None, None), "d_skip": (None,),
               "w_out": ("fsdp", None), "dt_bias": (None,)}
_MLSTM_AXES = {"w_up": ("fsdp", "ff"), "w_q": (None, "heads", None),
               "w_k": (None, "heads", None), "w_v": (None, "heads", None),
               "w_i": (None, "heads"), "w_f": (None, "heads"),
               "f_bias": (None,), "w_down": ("ff", "fsdp")}
_SLSTM_AXES = {"w_z": ("fsdp", None), "w_i": ("fsdp", None),
               "w_f": ("fsdp", None), "w_o": ("fsdp", None),
               "f_bias": (None,), "w_down": ("fsdp", None)}
_GROUP_AXES = {"attn": _ATTN_AXES, "xattn": _ATTN_AXES, "ffn": _FFN_AXES,
               "moe": _MOE_AXES, "mamba": _MAMBA_AXES}


EMBED_AXES = ("vocab", "fsdp")
HEAD_AXES = ("fsdp", "vocab")


def _leaf_axes(kind: str, parts: list[str]) -> tuple:
    """The logical axes of a block's leaf by its name within the block
    (``group.leaf``, or ``alpha``)."""
    if parts[-1] == "alpha":
        return (None,)
    group, leaf = parts
    if group.startswith("norm"):
        return (None,)
    if group == "mix":
        return (_MLSTM_AXES if kind == "mlstm" else _SLSTM_AXES)[leaf]
    return _GROUP_AXES[group][leaf]


def param_axes(p: LM, cfg: ArchConfig) -> list[tuple]:
    """The logical axes (``repro_torch.dist.sharding``'s names) of each
    leaf of ``p``, in ``p.parameters()`` order: the reference's
    ``init_lm`` axes, a per-layer leaf's without the stacked tree's
    leading ``"layer"``."""
    out = []
    for name, _ in p.named_parameters():
        parts = name.split(".")
        if parts[0] == "embed":
            out.append(EMBED_AXES)
        elif parts[0] == "lm_head":
            out.append(HEAD_AXES)
        elif parts[0] in ("final_norm", "enc_norm"):
            out.append((None,))
        else:
            kind = "enc" if parts[0] == "enc_layers" else decoder_kind(
                cfg, int(parts[1]))
            out.append(_leaf_axes(kind, parts[2:]))
    return out


def tree_leaf_groups(p: LM) -> list[list[int]]:
    """The reference's parameter tree leaves, in its flatten order (dict
    keys sorted, list items in order), as groups of indices into
    ``p.parameters()``: a leaf of a stacked stack (``layers``,
    ``enc_layers``: one ``(L, ...)`` leaf a name) groups its layers'
    parameters of that name in layer order; any other leaf (``embed``,
    a norm, each ``ssm`` block's) is one parameter. Gradient compression
    treats a group as the one leaf it is in the reference."""
    groups: dict[tuple, list[int]] = {}
    for i, (name, _) in enumerate(p.named_parameters()):
        parts = name.split(".")
        if parts[0] in ("layers", "enc_layers"):
            path = (parts[0], *parts[2:])
        elif parts[0] == "blocks":
            path = ("blocks", int(parts[1]), *parts[2:])
        else:
            path = tuple(parts)
        groups.setdefault(path, []).append(i)
    return [groups[k] for k in sorted(groups)]


def _blocks(p, cfg: ArchConfig) -> list:
    """(block parameters, kind) for each layer, from an :class:`LM` or a
    mapping with its layout."""
    return [(bp, decoder_kind(cfg, i))
            for i, bp in enumerate(p[stack_name(cfg)])]


def _embed_sharded(table: torch.Tensor, tokens: torch.Tensor
                   ) -> torch.Tensor:
    """The rows of a vocab-sharded table: each rank looks up the tokens
    that fall in its block of rows (zeros elsewhere), a partial sum over
    the vocab's mesh axes that adds one row and zeros, so its sum is the
    row itself. (DTensor's own strategy for it, a masked partial, loses
    its mask when the batch is sharded too.)"""
    v0, vl = SH.local_range(EMBED_AXES, table.shape, 0)

    def lookup(tok, rows):
        local = tok.long() - v0
        inside = (local >= 0) & (local < vl)
        x = rows[local.clamp(0, vl - 1)]
        return torch.where(inside[..., None], x, torch.zeros_like(x))

    return SH.local_map_axes(lookup, (("batch", None), ("vocab", None)),
                             (("batch", None, None),),
                             reduced=("vocab",))(tokens, table)


def embed_tokens(p: LM, tokens: torch.Tensor, cfg: ArchConfig
                 ) -> torch.Tensor:
    if SH.on_mesh(p["embed"]):
        x = _embed_sharded(p["embed"], tokens).to(L._dtype(cfg))
    else:
        x = p["embed"][tokens].to(L._dtype(cfg))
    if cfg.name.startswith("gemma"):
        # the reference scales by sqrt(d_model) rounded to the activation
        # dtype; a Python float, so nothing is copied to the card
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype).item()
    return SH.constrain(x, *L.SEQ_AXES)


def unembed(p: LM, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    dt = x.dtype
    x = L.gather_seq(x)
    if cfg.tie_embeddings:
        head = L.gather_fsdp(p["embed"].to(dt), EMBED_AXES).t()
    else:
        head = L.gather_fsdp(p["lm_head"].to(dt), HEAD_AXES)
    return L.project(x, head, ("batch", None, "vocab"), dt).float()


def _run_stack(blocks, x: torch.Tensor, cfg: ArchConfig, remat: str,
               memory: torch.Tensor | None = None) -> torch.Tensor:
    """``apply_block_train`` over (block parameters, kind) pairs, each
    block wrapped in the remat policy. ``memory`` is passed to the
    wrapped block as an argument, so its gradient reaches the encoder."""
    for lp, kind in blocks:
        body = _remat(functools.partial(apply_block_train, cfg=cfg,
                                        kind=kind), remat)
        x = body(lp, x) if memory is None else body(lp, x, memory=memory)
    return x


def forward_train(p, tokens_or_x: torch.Tensor, cfg: ArchConfig,
                  remat: str = "full", is_embedded: bool = False,
                  memory: torch.Tensor | None = None) -> torch.Tensor:
    """Full-sequence forward: tokens (B, S) (or, ``is_embedded``, their
    embeddings (B, S, D)) -> logits (B, S, V) float32; an
    encoder-decoder's decoder attends to ``memory`` (``encode``'s
    output). ``p`` is an :class:`LM` or a mapping with its layout
    (``"embed"``, ``"layers"`` or ``"blocks"``, ``"final_norm"``,
    ``"lm_head"``, ``"enc_layers"``, ``"enc_norm"``), as the train step's
    bfloat16 view of the parameters is."""
    x = tokens_or_x if is_embedded else embed_tokens(p, tokens_or_x, cfg)
    x = _run_stack(_blocks(p, cfg), x, cfg, remat, memory)
    x = L.apply_norm(p["final_norm"], x, cfg)
    return unembed(p, x, cfg)


@SH.in_mesh_context
def encode(p, frames: torch.Tensor, cfg: ArchConfig, remat: str = "full"
           ) -> torch.Tensor:
    """The encoder over precomputed frame embeddings (B, S, D): plus
    sinusoids (``freq = exp(-(arange(D / 2) / (D / 2)) * 9)`` in float32,
    sin then cos, cast to the frames' dtype), the ``enc`` blocks, then
    ``enc_norm``. On a mesh the sum is placed as the reference constrains
    it, by ``layers.SEQ_AXES``."""
    _, s, d = frames.shape
    pos = torch.arange(s, dtype=torch.float32, device=frames.device)
    half = d // 2
    freq = torch.exp(-torch.arange(half, dtype=torch.float32,
                                   device=frames.device) / half * 9.0)
    ang = pos[:, None] * freq[None, :]
    x = frames + torch.cat([torch.sin(ang), torch.cos(ang)],
                           -1).to(frames.dtype)[None]
    x = SH.constrain(x, *L.SEQ_AXES)
    x = _run_stack([(lp, "enc") for lp in p["enc_layers"]], x, cfg, remat)
    return L.apply_norm(p["enc_norm"], x, cfg)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device="cpu",
               mesh=None) -> list:
    """One cache entry per layer (``init_block_cache``); on a
    ``DeviceMesh`` each attention cache holds this rank's block."""
    return [init_block_cache(cfg, decoder_kind(cfg, i), batch, max_len,
                             device, mesh) for i in range(cfg.num_layers)]


def forward_prefill(p: LM, tokens_or_x: torch.Tensor, cfg: ArchConfig,
                    cache, last_only: bool = False,
                    is_embedded: bool = False,
                    memory: torch.Tensor | None = None):
    """tokens (B, S) (or, ``is_embedded``, their embeddings) -> logits
    (B, S, V) float32 and the filled cache; an encoder-decoder's decoder
    attends to ``memory``. With ``last_only`` only the last position is
    unembedded (B, 1, V): the same values for that position without a
    (B, S, V) buffer, which is what serving keeps."""
    x = tokens_or_x if is_embedded else embed_tokens(p, tokens_or_x, cfg)
    for i, (lp, kind) in enumerate(_blocks(p, cfg)):
        x, cache[i] = apply_block_prefill(lp, x, cfg, kind, cache[i],
                                          memory)
    if last_only:
        x = x[:, -1:]
    x = L.apply_norm(p["final_norm"], x, cfg)
    return unembed(p, x, cfg), cache


def forward_decode(p: LM, token: torch.Tensor, cfg: ArchConfig, cache,
                   pos: int, attend: L.Attend | None = None):
    """token: (B, 1) int; pos: the absolute position, a Python int."""
    x = embed_tokens(p, token, cfg)
    for i, (lp, kind) in enumerate(_blocks(p, cfg)):
        x, cache[i] = apply_block_decode(lp, x, cfg, kind, cache[i], pos,
                                         attend)
    x = L.apply_norm(p["final_norm"], x, cfg)
    return unembed(p, x, cfg), cache
