"""AdamW with global-norm clipping and a linear-warmup cosine schedule
(``repro.train.optimizer``), as plain functions on lists of tensors.

The arithmetic is the reference's, in float32 and in its order: the clip
scale from the global norm, the bias corrections ``1 - b ** step`` of the
float32 step, weight decay on every leaf (norm scales and biases too).
``torch.optim.AdamW`` orders the update differently (decoupled decay
first, ``eps`` added to the bias-corrected root), so it is not used.

The step counter is a Python int: the schedule and the bias corrections
are float32 values computed on the host (numpy float32, the reference's
dtype), so an update reads nothing back from the device. Parameters and
moments are updated in place.

On a mesh the leaves, gradients and moments are DTensors: each gradient
is first placed as its leaf (autograd may leave one in another layout),
the update is then elementwise on each rank's blocks, and the global
norm sums every leaf's squares over all its blocks (one all-reduce of
the partial sums), the whole model's norm on every rank.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.dist import sharding as SH


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def schedule(cfg: AdamWConfig, step: int) -> float:
    """The learning rate at ``step``, rounded to float32 as the reference
    computes it (a linear warmup, then a cosine decay to
    ``min_lr_frac * lr``)."""
    f = np.float32
    s = f(step)
    warm = s / f(max(cfg.warmup_steps, 1))
    prog = np.clip((s - f(cfg.warmup_steps))
                   / f(max(cfg.total_steps - cfg.warmup_steps, 1)),
                   f(0), f(1))
    # (1 - min_lr_frac) * 0.5 is a Python (double) product in the reference
    cos = f(cfg.min_lr_frac) + f((1 - cfg.min_lr_frac) * 0.5) * (
        f(1) + np.cos(f(np.pi) * prog))
    return float(f(cfg.lr) * (warm if s < f(cfg.warmup_steps) else cos))


def adamw_init(params: list[torch.Tensor]) -> dict:
    """Zero first and second moments (float32, beside each leaf) and step
    0."""
    return {
        "mu": [torch.zeros_like(p, dtype=torch.float32) for p in params],
        "nu": [torch.zeros_like(p, dtype=torch.float32) for p in params],
        "step": 0,
    }


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, summed leaf by leaf in
    float32 (a 0-dim tensor on the leaves' device)."""
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: list[torch.Tensor],
                 grads: list[torch.Tensor], state: dict
                 ) -> tuple[list[torch.Tensor], dict, dict]:
    """One AdamW step, in place on ``params`` and on the state's moments.
    Returns ``(params, new_state, metrics)`` with ``metrics`` holding
    ``grad_norm`` (a 0-dim device tensor) and ``lr`` (a float)."""
    step = state["step"] + 1
    grads = [g.redistribute(p.device_mesh, p.placements)
             if SH.on_mesh(g) and g.placements != p.placements else g
             for p, g in zip(params, grads)]
    gnorm = global_norm(grads)
    clip = torch.full_like(gnorm, cfg.clip_norm)
    # a tensor numerator: ``scalar / tensor`` multiplies by the reciprocal
    scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = schedule(cfg, step)
    f = np.float32
    b1, b2 = cfg.b1, cfg.b2
    # 0-dim device tensors, divided by as the reference divides
    bc1 = torch.full_like(gnorm, float(f(1) - f(b1) ** f(step)))
    bc2 = torch.full_like(gnorm, float(f(1) - f(b2) ** f(step)))
    for p, g, mu, nu in zip(params, grads, state["mu"], state["nu"]):
        g = g.float() * scale
        mu.mul_(b1).add_(g * (1 - b1))
        nu.mul_(b2).add_(g * (1 - b2) * g)
        mhat = mu / bc1
        nhat = nu / bc2
        delta = (mhat / (torch.sqrt(nhat) + cfg.eps)
                 + cfg.weight_decay * p.float())
        p.copy_(p.float() - lr * delta)
    metrics = {"grad_norm": SH.full_value(gnorm), "lr": lr}
    return params, {"mu": state["mu"], "nu": state["nu"], "step": step}, \
        metrics
