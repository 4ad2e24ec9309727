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

The VLM and encoder-decoder batches add stub-frontend embeddings (patches,
frames): a hash of each element's flat index, mapped to [-1, 1) in
float32, rounded to the activation dtype and scaled by 0.02. The
reference multiplies by a weakly typed 0.02, which JAX rounds to the
activation dtype first; the port multiplies by that rounded constant (a
bfloat16 product of two bfloat16 values is exact in float32 and rounds
once, as XLA's does).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device
from repro_torch.dist import sharding as SH

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


def _stub_embeddings(step_salt: int, batch: int, n: int, d_model: int,
                     dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    """(batch, n, d_model) stub-frontend embeddings: ``_hash2`` of each
    element's flat index and ``step_salt``, as the reference's
    ``vlm_get`` / ``encdec_get`` compute them in uint32."""
    size = batch * n * d_model
    if size > 2**32:
        raise ValueError(f"{batch} x {n} x {d_model} embedding elements: the "
                         f"reference's uint32 index cannot count past 2**32")
    idx = torch.arange(size, dtype=torch.int64, device=dev)
    h = _hash2(idx, torch.full((1,), step_salt & _MASK32, dtype=torch.int64,
                               device=dev))
    x = (h.to(torch.float64).to(torch.float32) / 2.0**31 - 1.0).to(dtype)
    # 0.02 rounded to the activation dtype, as JAX rounds the weak scalar
    scale = torch.tensor(0.02, dtype=dtype).item()
    return (x * scale).reshape(batch, n, d_model)


def place_batch(batch: dict, mesh) -> dict:
    """The batch with each tensor placed by its leading ``batch`` dim on a
    ``DeviceMesh`` (every rank drew the same global batch; each keeps its
    block): the reference's batch sharding. As it is with no
    ``DeviceMesh``, or when already placed."""
    if not SH.is_device_mesh(mesh):
        return batch
    return {k: SH.place(v, ("batch",) + (None,) * (v.ndim - 1), mesh)
            for k, v in batch.items()}


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

    def vlm_get(self, step: int, d_model: int, vision_fraction: int = 8,
                dtype: torch.dtype = torch.bfloat16,
                device: str | torch.device = "cuda") -> dict:
        """``seq // vision_fraction`` patch embeddings (B, P, d_model) and
        ``seq - P`` tokens."""
        dev = resolve_device(device)
        p_len = self.seq // vision_fraction
        t = synthetic_batch(step, self.batch, self.seq - p_len, self.vocab,
                            self.seed, dev)
        patches = _stub_embeddings(int(step), self.batch, p_len, d_model,
                                   dtype, dev)
        return {"patches": patches, "tokens": t["tokens"]}

    def encdec_get(self, step: int, d_model: int,
                   dtype: torch.dtype = torch.bfloat16,
                   device: str | torch.device = "cuda") -> dict:
        """``seq // 2`` encoder frame embeddings (B, seq // 2, d_model) and
        ``seq // 2`` decoder tokens."""
        dev = resolve_device(device)
        s2 = self.seq // 2
        t = synthetic_batch(step, self.batch, s2, self.vocab, self.seed, dev)
        frames = _stub_embeddings(int(step) + 7, self.batch, s2, d_model,
                                  dtype, dev)
        return {"frames": frames, "tokens": t["tokens"]}

    def get_for(self, cfg, step: int, device: str | torch.device = "cuda",
                mesh=None) -> dict:
        """Family-aware batch: patches and tokens (vlm), frames and tokens
        (encoder-decoder), or tokens, the embeddings in ``cfg.dtype``; on
        a ``DeviceMesh`` the step's global batch, placed by its ``batch``
        dim (``place_batch``)."""
        dtype = getattr(torch, cfg.dtype)
        if cfg.family == "vlm":
            batch = self.vlm_get(step, cfg.d_model, cfg.vision_fraction,
                                 dtype, device)
        elif cfg.is_encoder_decoder:
            batch = self.encdec_get(step, cfg.d_model, dtype, device)
        else:
            batch = self.get(step, device)
        return place_batch(batch, mesh)
