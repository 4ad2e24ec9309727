"""Carries arrays of the JAX package across to the port, as numpy.

``jax.random`` draws cannot be reproduced by ``torch.Generator``s, so
parity runs hand the reference's codebooks and banks to the port through
these functions; both packages then search the same codebooks and bank.
Packed uint32 words become their int32 bit-views (the port's storage
convention); int8 hypervectors stay int8.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.serve.db_search import QueryEncoder


def bank_rows_from_numpy(rows, device: str | torch.device = "cuda"
                         ) -> torch.Tensor:
    """uint32 packed words -> int32 bit-view; int8 HVs -> int8."""
    a = np.ascontiguousarray(np.asarray(rows))
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype != np.int8:
        raise ValueError(f"expected uint32 words or int8 HVs, got {a.dtype}")
    return torch.from_numpy(a.copy()).to(resolve_device(device))


def encoder_from_numpy(id_hvs, level_hvs,
                       device: str | torch.device = "cuda"
                       ) -> QueryEncoder:
    """A :class:`QueryEncoder` holding the given bipolar int8 codebooks."""
    return QueryEncoder(id_hvs=bank_rows_from_numpy(id_hvs, device),
                        level_hvs=bank_rows_from_numpy(level_hvs, device))
