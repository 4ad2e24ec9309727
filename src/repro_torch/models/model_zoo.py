"""Unified Model API (``repro.models.model_zoo``) over every family: the
decoder-only dense, MoE, SSM (xLSTM) and hybrid (Hymba) LMs, the VLM
(InternVL2) and the encoder-decoder (Whisper).

``build_model(cfg)`` returns a :class:`Model` on a device (CUDA unless the
caller asks for the CPU; asking for CUDA without a card raises) with
``init``, ``loss`` (training), ``init_cache``, ``prefill`` and
``decode_step``. Inputs follow the reference:

* decoder LM / moe / ssm / hybrid: ``{"tokens": (B, S) int}``;
* vlm: ``{"patches": (B, P, D), "tokens": (B, S - P) int}``, the patch
  embeddings of the stub frontend placed before the text;
* audio (encoder-decoder): ``{"frames": (B, S_enc, D), "tokens": (B,
  S_dec) int}``, the stub frontend's frame embeddings for the encoder.

A recurrent layer's cache entry is its state (``models.recurrent``); a
``dec_cross`` layer's holds its cross K/V (``transformer.CrossKV``).

``build_model(cfg, device, mesh=)`` with a ``DeviceMesh`` installs it as
the global mesh (``sharding.set_mesh``, keeping the installed rules, so
``set_mesh(mesh, rules.replace(kv_seq="model"))`` before it stripes the
caches' sequence): the parameters are DTensors
placed by ``param_axes``, a batch is placed by its ``batch`` dim, and the
forwards run on DTensors. Every family runs over a mesh of more than one
rank: the dense, MoE (expert-parallel), VLM and encoder-decoder ones, the
recurrent (``ssm``: xLSTM's mLSTM heads split over ``model``, sLSTM on
each rank's batch block) and the ``hybrid`` (Hymba: the attention as the
dense family's, its Mamba heads on each rank's batch block;
``models.recurrent``).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.data.tokens import place_batch
from repro_torch.device import resolve_device
from repro_torch.dist import sharding as SH
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.layers import Attend


def _xent(logits: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor
          ) -> torch.Tensor:
    """Masked mean cross-entropy; logits float32 (B, S, V)."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())
    # on a mesh a vocab-sharded gather is a masked partial sum: reduced
    # before the view (DTensor's mask does not follow the view)
    gold = SH.constrain(gold, "batch", None, None)[..., 0]
    nll = (logz - gold) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1.0)


@dataclasses.dataclass
class Model:
    cfg: ArchConfig
    device: torch.device
    mesh: object = None   # None, a {name: size} mapping or a DeviceMesh

    # ---- init -------------------------------------------------------------
    def init(self, seed: int = 0, trainable: bool = False) -> T.LM:
        """Parameters drawn from a ``torch.Generator`` seeded with ``seed``
        on the model's device; ``trainable``: float32 leaves with
        gradients (``cfg.param_dtype``), as training needs."""
        g = torch.Generator(device=self.device).manual_seed(seed)
        return T.init_lm(self.cfg, self.device, g, trainable, self.mesh)

    # ---- train ------------------------------------------------------------
    def loss(self, params, batch: dict, remat: str = "full"
             ) -> torch.Tensor:
        """Next-token cross-entropy; for the VLM over the text positions
        only (positions P-1 .. P+St-2 predict the St tokens), for the
        encoder-decoder of the decoder over the encoded frames."""
        cfg = self.cfg
        batch = place_batch(batch, self.mesh)
        tokens = batch["tokens"]
        if cfg.family == "vlm":
            logits = T.forward_train(params, _vlm_inputs(params, batch, cfg),
                                     cfg, remat=remat, is_embedded=True)
            text_logits = logits[:, batch["patches"].shape[1] - 1:-1]
            return _xent(text_logits, tokens,
                         torch.ones_like(tokens, dtype=torch.float32))
        memory = None
        if cfg.is_encoder_decoder:
            memory = T.encode(params, batch["frames"], cfg, remat=remat)
        logits = T.forward_train(params, tokens, cfg, remat=remat,
                                 memory=memory)
        targets = tokens[:, 1:]
        return _xent(logits[:, :-1], targets,
                     torch.ones_like(targets, dtype=torch.float32))

    # ---- serving ----------------------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> list:
        return T.init_cache(self.cfg, batch, max_len, self.device, self.mesh)

    @torch.no_grad()
    def prefill(self, params: T.LM, batch: dict, cache,
                last_only: bool = False):
        """The prompt's logits and the filled cache: the VLM's patches and
        tokens as one embedded sequence; the encoder-decoder's frames
        encoded into the memory its decoder attends to."""
        cfg = self.cfg
        batch = place_batch(batch, self.mesh)
        if cfg.family == "vlm":
            return T.forward_prefill(params, _vlm_inputs(params, batch, cfg),
                                     cfg, cache, last_only=last_only,
                                     is_embedded=True)
        memory = None
        if cfg.is_encoder_decoder:
            # no gradients here, so the remat policy changes nothing
            memory = T.encode(params, batch["frames"], cfg, remat="none")
        return T.forward_prefill(params, batch["tokens"], cfg, cache,
                                 last_only=last_only, memory=memory)

    @torch.no_grad()
    def decode_step(self, params: T.LM, token: torch.Tensor, cache,
                    pos: int, attend: Attend | None = None):
        token = place_batch({"tokens": token}, self.mesh)["tokens"]
        return T.forward_decode(params, token, self.cfg, cache, pos, attend)


def _vlm_inputs(params, batch: dict, cfg: ArchConfig) -> torch.Tensor:
    """The VLM's embedded sequence: the patches (cast to the activation
    dtype) before the embedded tokens. On a mesh both are gathered over
    the sequence first (the batch stays placed) and the sequence is
    placed as the residual's after the concatenation (``seq_shard``
    where P + S_text divides)."""
    tok_x = SH.constrain(T.embed_tokens(params, batch["tokens"], cfg),
                         "batch", None, None)
    patches = SH.constrain(batch["patches"].to(tok_x.dtype), "batch", None,
                           None)
    return SH.constrain(torch.cat([patches, tok_x], dim=1), *L.SEQ_AXES)


def build_model(cfg: ArchConfig, device: str | torch.device = "cuda",
                mesh=None) -> Model:
    """The model on ``device``; over ``mesh`` (installed as the global
    mesh with the installed rules when it is a ``DeviceMesh``; see the
    module docstring)."""
    if SH.is_device_mesh(mesh):
        SH.set_mesh(mesh, SH.get_rules())
    return Model(cfg=cfg, device=resolve_device(device), mesh=mesh)
