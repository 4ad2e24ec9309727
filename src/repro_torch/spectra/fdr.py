"""Target-decoy false-discovery-rate filtering (paper §II.B), in PyTorch.

Counterpart of ``repro.spectra.fdr``. Decoys are m/z-reversed spectra;
the FDR at a score threshold is (#decoys >= t) / (#targets >= t).
"""

from __future__ import annotations

import torch


def make_decoys(refs: torch.Tensor) -> torch.Tensor:
    """Decoy spectra: reverse the m/z axis."""
    return refs.flip(-1)


def decoy_competition(scores_target: torch.Tensor, scores_decoy: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """(is_target_win, best_score): a hit survives if its best target
    score beats its best decoy score."""
    return scores_target > scores_decoy, torch.maximum(scores_target,
                                                       scores_decoy)


def fdr_filter(best_scores: torch.Tensor, is_target: torch.Tensor,
               fdr: float = 0.01, valid: torch.Tensor | None = None
               ) -> torch.Tensor:
    """Accept mask at the given FDR (the largest score-sorted prefix whose
    running decoys/targets stays <= fdr, then its targets).

    The sort is stable, as ``jnp.argsort`` is, so tied scores keep query
    order. Negating an ``INT32_MIN`` int32 score wraps to itself in both
    frameworks, so such a query sorts first in both. ``running_fdr`` is
    int32 / int32 -> float32, compared against ``fdr`` in float32, as in
    the reference. ``valid=False`` queries are left out of the counts and
    never accepted.
    """
    order = torch.argsort(-best_scores, stable=True)
    tgt_sorted = is_target[order]
    if valid is None:
        valid_sorted = torch.ones_like(tgt_sorted, dtype=torch.bool)
    else:
        valid_sorted = valid[order]
    n_tgt = torch.cumsum((tgt_sorted & valid_sorted).to(torch.int32), 0,
                         dtype=torch.int32)
    n_dec = torch.cumsum((~tgt_sorted & valid_sorted).to(torch.int32), 0,
                         dtype=torch.int32)
    running_fdr = n_dec.to(torch.float32) / torch.clamp_min(
        n_tgt, 1).to(torch.float32)
    ok = running_fdr <= torch.tensor(fdr, dtype=torch.float32)
    pos = torch.arange(1, ok.shape[0] + 1, device=ok.device)
    k = int(torch.where(ok, pos, torch.zeros_like(pos)).max()) if ok.numel() \
        else 0
    accept_sorted = (pos <= k) & tgt_sorted & valid_sorted
    accept = torch.zeros_like(accept_sorted)
    accept[order] = accept_sorted
    return accept
