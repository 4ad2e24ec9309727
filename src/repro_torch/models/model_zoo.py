"""Unified Model API (``repro.models.model_zoo``) for the families the
port serves: the decoder-only dense, MoE, SSM (xLSTM) and hybrid (Hymba)
LMs.

``build_model(cfg)`` returns a :class:`Model` on a device (CUDA unless the
caller asks for the CPU; asking for CUDA without a card raises) with
``init``, ``loss`` (training), ``init_cache``, ``prefill`` and
``decode_step``. Inputs follow the reference: ``{"tokens": (B, S) int}``.
A recurrent layer's cache entry is its state (``models.recurrent``). The
VLM and encoder-decoder (audio) families are not ported yet (ROADMAP.md,
Queue 1 item 5.5): ``build_model`` and ``loss`` raise for them.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.layers import Attend


def _xent(logits: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor
          ) -> torch.Tensor:
    """Masked mean cross-entropy; logits float32 (B, S, V)."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = (logz - gold) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1.0)


@dataclasses.dataclass
class Model:
    cfg: ArchConfig
    device: torch.device

    # ---- init -------------------------------------------------------------
    def init(self, seed: int = 0, trainable: bool = False) -> T.LM:
        """Parameters drawn from a ``torch.Generator`` seeded with ``seed``
        on the model's device; ``trainable``: float32 leaves with
        gradients (``cfg.param_dtype``), as training needs."""
        g = torch.Generator(device=self.device).manual_seed(seed)
        return T.init_lm(self.cfg, self.device, g, trainable)

    # ---- train ------------------------------------------------------------
    def loss(self, params, batch: dict, remat: str = "full"
             ) -> torch.Tensor:
        """Next-token cross-entropy of the decoder-only LM (dense, MoE, SSM
        or hybrid)."""
        cfg = self.cfg
        if cfg.family == "vlm" or cfg.is_encoder_decoder:
            raise NotImplementedError(
                f"the {cfg.family} loss is not ported yet (ROADMAP.md, "
                f"Queue 1 item 5.5)")
        tokens = batch["tokens"]
        logits = T.forward_train(params, tokens, cfg, remat=remat)
        targets = tokens[:, 1:]
        return _xent(logits[:, :-1], targets,
                     torch.ones(targets.shape, device=logits.device))

    # ---- serving ----------------------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> list:
        return T.init_cache(self.cfg, batch, max_len, self.device)

    @torch.no_grad()
    def prefill(self, params: T.LM, batch: dict, cache,
                last_only: bool = False):
        return T.forward_prefill(params, batch["tokens"], self.cfg, cache,
                                 last_only=last_only)

    @torch.no_grad()
    def decode_step(self, params: T.LM, token: torch.Tensor, cache,
                    pos: int, attend: Attend | None = None):
        return T.forward_decode(params, token, self.cfg, cache, pos, attend)


def build_model(cfg: ArchConfig, device: str | torch.device = "cuda"
                ) -> Model:
    T.block_kind(cfg)  # raises for a family the port does not serve yet
    return Model(cfg=cfg, device=resolve_device(device))
