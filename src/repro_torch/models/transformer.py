"""Model assembly of the decoder-only families (``repro.models.transformer``):
blocks (``attn_ffn`` for the dense family, ``attn_moe`` for the MoE one),
the LM's parameters, KV caches, the training forward pass, prefill and
decode.

The reference stacks its layers' parameters on a leading ``layer`` axis
and scans over them (``lax.scan``); here the layers are an
``nn.ModuleList`` walked by a Python loop, and the cache is a list with
one ``KVCache`` / ``QuantKVCache`` per layer, updated in place. The
training forward wraps each block in the remat policy (``_remat``), as
the reference wraps its scan body.

The SSM, hybrid, encoder-decoder (audio) and VLM families are not ported
yet (ROADMAP.md, Queue 1 items 5.4-5.5); building or running one raises.
"""

from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L

KINDS = ("attn_ffn", "attn_moe")


def block_kind(cfg: ArchConfig, layer_idx: int = 0) -> str:
    if (cfg.family in ("ssm", "hybrid", "audio", "vlm")
            or cfg.is_encoder_decoder):
        raise NotImplementedError(
            f"the {cfg.family} family ({cfg.name}) is not ported yet; the "
            f"port runs decoder-only dense and MoE models (ROADMAP.md, "
            f"Queue 1 items 5.4-5.5)")
    return "attn_moe" if cfg.family == "moe" else "attn_ffn"


def init_block(cfg: ArchConfig, kind: str, device="cpu",
               generator: torch.Generator | None = None,
               trainable: bool = False) -> nn.ModuleDict:
    if kind not in KINDS:
        raise ValueError(kind)
    t = trainable
    p = {
        "norm1": L.init_norm(cfg, device=device, trainable=t),
        "attn": L.init_attention(cfg, device, generator, t),
        "norm2": L.init_norm(cfg, device=device, trainable=t),
    }
    if kind == "attn_moe":
        p["moe"] = L.init_moe(cfg, device, generator, t)
    else:
        p["ffn"] = L.init_ffn(cfg, device=device, generator=generator,
                              trainable=t)
    return nn.ModuleDict(p)


def _mlp(p: nn.ModuleDict, h: torch.Tensor, cfg: ArchConfig, kind: str
         ) -> torch.Tensor:
    """The block's second half: the MoE layer or the dense FFN."""
    if kind == "attn_moe":
        return L.apply_moe(p["moe"], h, cfg)
    return L.apply_ffn(p["ffn"], h, cfg)


def apply_block_train(p: nn.ModuleDict, x: torch.Tensor, cfg: ArchConfig,
                      kind: str) -> torch.Tensor:
    """One block over a full sequence (training). The reference's
    ``constrain`` calls are the identity on one device."""
    if kind not in KINDS:
        raise ValueError(kind)
    h = L.apply_norm(p["norm1"], x, cfg)
    x = x + L.attention_train(p["attn"], h, cfg).to(x.dtype)
    h = L.apply_norm(p["norm2"], x, cfg)
    return x + _mlp(p, h, cfg, kind).to(x.dtype)


def apply_block_prefill(p: nn.ModuleDict, x: torch.Tensor, cfg: ArchConfig,
                        kind: str, cache):
    if kind not in KINDS:
        raise ValueError(kind)
    h = L.apply_norm(p["norm1"], x, cfg)
    attn, cache = L.attention_prefill(p["attn"], h, cfg, cache)
    x = x + attn
    h = L.apply_norm(p["norm2"], x, cfg)
    return x + _mlp(p, h, cfg, kind), cache


def apply_block_decode(p: nn.ModuleDict, x: torch.Tensor, cfg: ArchConfig,
                       kind: str, cache, pos: int,
                       attend: L.Attend | None = None):
    """One token a row; an MoE block routes the batch's B tokens as one
    group (as the reference's decode does), so its capacity is small and
    drops pairs as the reference's does."""
    if kind not in KINDS:
        raise ValueError(kind)
    h = L.apply_norm(p["norm1"], x, cfg)
    attn, cache = L.attention_decode(p["attn"], h, cfg, cache, pos, attend)
    x = x + attn
    h = L.apply_norm(p["norm2"], x, cfg)
    return x + _mlp(p, h, cfg, kind), cache


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
    """The decoder-only LM's parameters under the reference's names:
    ``embed`` (V, D), ``layers`` (one ``ModuleDict`` per layer),
    ``final_norm`` and, unless embeddings are tied, ``lm_head`` (D, V).
    ``lm["embed"]`` reads as ``params["embed"]`` does in the reference."""

    def __init__(self, embed: torch.Tensor, layers: list[nn.ModuleDict],
                 final_norm: nn.ParameterDict,
                 lm_head: torch.Tensor | None = None,
                 trainable: bool = False):
        super().__init__()
        self.embed = L._param(embed, trainable)
        self.layers = nn.ModuleList(layers)
        self.final_norm = final_norm
        self.lm_head = (None if lm_head is None
                        else L._param(lm_head, trainable))

    def __getitem__(self, name: str):
        return getattr(self, name)


def init_lm(cfg: ArchConfig, device="cpu",
            generator: torch.Generator | None = None,
            trainable: bool = False) -> LM:
    """The port's own initialisation, drawn from ``generator`` on
    ``device``. It cannot reproduce ``jax.random``; it meets the
    reference's distributions: embed and lm_head normal x ``D**-0.5``,
    the attention, FFN and MoE scales of ``layers.init_attention`` /
    ``init_ffn`` / ``init_moe``, zero biases, unit norms. Each matrix is
    drawn in float32 and cast to ``cfg.dtype`` (the MoE router stays
    float32; ``trainable``: kept in ``cfg.param_dtype``, with gradients)
    before the next is drawn."""
    kind = block_kind(cfg)
    V, D = cfg.padded_vocab, cfg.d_model
    t = trainable
    embed = L._normal((V, D), D ** -0.5, cfg, device, generator, t)
    layers = [init_block(cfg, kind, device, generator, t)
              for _ in range(cfg.num_layers)]
    lm_head = None
    if not cfg.tie_embeddings:
        lm_head = L._normal((D, V), D ** -0.5, cfg, device, generator, t)
    return LM(embed, layers, L.init_norm(cfg, device=device, trainable=t),
              lm_head, t)


def embed_tokens(p: LM, tokens: torch.Tensor, cfg: ArchConfig
                 ) -> torch.Tensor:
    x = p["embed"][tokens].to(L._dtype(cfg))
    if cfg.name.startswith("gemma"):
        # the reference scales by sqrt(d_model) rounded to the activation
        # dtype; a Python float, so nothing is copied to the card
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype).item()
    return x


def unembed(p: LM, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = x @ p["embed"].to(x.dtype).t()
    else:
        logits = x @ p["lm_head"].to(x.dtype)
    return logits.float()


def forward_train(p, tokens: torch.Tensor, cfg: ArchConfig,
                  remat: str = "full") -> torch.Tensor:
    """Full-sequence forward: tokens (B, S) -> logits (B, S, V) float32.
    ``p`` is an :class:`LM` or a mapping with its layout (``"embed"``,
    ``"layers"``, ``"final_norm"``, ``"lm_head"``), as the train step's
    bfloat16 view of the parameters is."""
    kind = block_kind(cfg)
    body = _remat(functools.partial(apply_block_train, cfg=cfg, kind=kind),
                  remat)
    x = embed_tokens(p, tokens, cfg)
    for lp in p["layers"]:
        x = body(lp, x)
    x = L.apply_norm(p["final_norm"], x, cfg)
    return unembed(p, x, cfg)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device="cpu"
               ) -> list:
    """One cache per layer."""
    block_kind(cfg)
    return [L.init_kv_cache(cfg, batch, max_len, device=device)
            for _ in range(cfg.num_layers)]


def forward_prefill(p: LM, tokens: torch.Tensor, cfg: ArchConfig, cache,
                    last_only: bool = False):
    """tokens (B, S) -> logits (B, S, V) float32 and the filled cache.
    With ``last_only`` only the last position is unembedded (B, 1, V): the
    same values for that position without a (B, S, V) buffer, which is
    what serving keeps."""
    kind = block_kind(cfg)
    x = embed_tokens(p, tokens, cfg)
    for i, lp in enumerate(p.layers):
        x, cache[i] = apply_block_prefill(lp, x, cfg, kind, cache[i])
    if last_only:
        x = x[:, -1:]
    x = L.apply_norm(p["final_norm"], x, cfg)
    return unembed(p, x, cfg), cache


def forward_decode(p: LM, token: torch.Tensor, cfg: ArchConfig, cache,
                   pos: int, attend: L.Attend | None = None):
    """token: (B, 1) int; pos: the absolute position, a Python int."""
    kind = block_kind(cfg)
    x = embed_tokens(p, token, cfg)
    for i, lp in enumerate(p.layers):
        x, cache[i] = apply_block_decode(lp, x, cfg, kind, cache[i], pos,
                                         attend)
    x = L.apply_norm(p["final_norm"], x, cfg)
    return unembed(p, x, cfg), cache
