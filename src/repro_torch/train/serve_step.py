"""Serving step factories (``repro.train.serve_step``): prefill (prompt ->
last position's logits + cache) and decode (one token against the
cache). Over a mesh they run as the model does: a plain batch or token
is placed by its batch dim, the logits are DTensors, and each rank's
cache holds its own block."""

from __future__ import annotations

from typing import Callable

from repro_torch.models.model_zoo import Model


def make_prefill(model: Model) -> Callable:
    def prefill(params, batch, cache):
        # the reference unembeds every position and slices the last; only
        # the last is computed here (the same values, no (B, S, V) buffer)
        return model.prefill(params, batch, cache, last_only=True)
    return prefill


def make_decode_step(model: Model) -> Callable:
    def decode_step(params, token, cache, pos, attend=None):
        return model.decode_step(params, token, cache, pos, attend)
    return decode_step
