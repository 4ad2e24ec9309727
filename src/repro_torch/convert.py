"""Carries arrays of the JAX package across to the port, as numpy.

``jax.random`` draws cannot be reproduced by ``torch.Generator``s, so
parity runs hand the reference's codebooks and banks to the port through
these functions; both packages then search the same codebooks and bank.
Packed uint32 words become their int32 bit-views (the port's storage
convention); int8 hypervectors stay int8; the PCM array's programmed
weights stay float32. A tuning table does not cross: it is keyed by
device kind and names the kernels' own launch knobs.
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


def imc_weights_from_numpy(weights, device: str | torch.device = "cuda"
                           ) -> torch.Tensor:
    """The reference's programmed PCM weights (``IMCArrayState.weights``,
    (R, Dp) noisy conductance-domain values) as a contiguous float32
    tensor for ``imc_mvm``."""
    a = np.asarray(weights)
    if a.ndim != 2 or not np.issubdtype(a.dtype, np.floating):
        raise ValueError(f"expected (R, Dp) float weights, got {a.dtype} "
                         f"{a.shape}")
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C")).to(
        resolve_device(device))
