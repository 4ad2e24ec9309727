"""Deterministic synthetic token pipeline (``repro.data.tokens``).

Token ids are a hash of (step, position) pushed through a Zipf-ish
transform, deterministic per (step, seed), and bit-identical to the JAX
package's. The reference computes in uint32 with wraparound; here the
words live in int64 tensors masked to 32 bits, and each 32 x 32-bit
product is split at 16 bits so no intermediate leaves int64's range. The
uint32 -> float32 conversion rounds to nearest (exact through float64,
as every word fits there), and ``u ** 3`` is ``u * (u * u)``: XLA lowers
the integer power by repeated squaring into those two rounded products,
which the port writes out (``torch.pow(u, 3)`` gave the same bits on the
CPU for the tested batches, but makes no such promise).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device

_MASK32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``a * c mod 2**32`` for int64 ``a`` in [0, 2**32) and a 32-bit
    constant ``c``, with every intermediate below 2**49."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _hash2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cheap stateless integer hash (xorshift-multiply) on uint32 values
    held in int64 tensors."""
    x = _mul32(a & _MASK32, 0x9E3779B9) ^ _mul32(b & _MASK32, 0x85EBCA6B)
    x = x ^ (x >> 15)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 13)


def synthetic_batch(step: int, batch: int, seq: int, vocab: int,
                    seed: int = 0, device: str | torch.device = "cuda"
                    ) -> dict:
    """Batch of (batch, seq) int32 tokens, Zipf-flavored, deterministic."""
    dev = resolve_device(device)
    rows = torch.arange(batch, dtype=torch.int64, device=dev)[:, None]
    cols = torch.arange(seq, dtype=torch.int64, device=dev)[None, :]
    salt = (int(step) + int(seed) * 0x27D4EB2F) & _MASK32
    h = _hash2((rows * seq + cols) & _MASK32,
               torch.full((1, 1), salt, dtype=torch.int64, device=dev))
    u = h.to(torch.float64).to(torch.float32) / 2.0**32   # U[0, 1)
    # Zipf-ish: token = floor(vocab * u^3) concentrates mass on small ids
    tok = (u * (u * u) * vocab).to(torch.int32)
    return {"tokens": torch.clamp(tok, max=vocab - 1)}


@dataclasses.dataclass
class TokenPipeline:
    """Stateless data pipeline facade: ``get(step)`` -> batch dict."""
    batch: int
    seq: int
    vocab: int
    seed: int = 0

    def get(self, step: int, device: str | torch.device = "cuda") -> dict:
        return synthetic_batch(step, self.batch, self.seq, self.vocab,
                               self.seed, device)

    def get_for(self, cfg, step: int, device: str | torch.device = "cuda"
                ) -> dict:
        """Family-aware batch; the port has the decoder-only families."""
        if cfg.family == "vlm" or cfg.is_encoder_decoder:
            raise NotImplementedError(
                f"{cfg.family} batches are not ported yet (ROADMAP.md, "
                f"Queue 1 item 5.5)")
        return self.get(step, device)
