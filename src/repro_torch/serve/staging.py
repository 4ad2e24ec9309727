"""Pinned host staging for batches in flight.

A served batch reaches the card through page-locked (pinned) host
buffers and ``non_blocking`` copies, and its results come back the same
way, so dispatching a batch never waits for the device: a pageable
``tensor.to(device)`` synchronizes the stream, which would make each
dispatch wait for every batch still searching ahead of it.

Each batch in flight holds one :class:`PinnedArena`, taken from a
:class:`StagingPool` at dispatch and handed back at finalize, after the
batch's last copy has completed (its ``ready`` event). An arena is
therefore never refilled while a copy from or into it may still run, and
the pool holds as many arenas as batches were ever in flight at once
(the scheduler's slots, plus the one being dispatched). Buffers grow on
demand and are kept, so pinned memory is allocated once per shape class,
not per batch.

On a CPU device nothing is pinned: uploads are host tensors that own
their memory, and downloads return the tensor itself.
"""

from __future__ import annotations

import math

import numpy as np
import torch


class PinnedArena:
    """Named pinned host buffers of one batch in flight."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._bufs: dict[str, torch.Tensor] = {}

    def _buffer(self, name: str, shape, dtype: torch.dtype) -> torch.Tensor:
        n = math.prod(shape)
        buf = self._bufs.get(name)
        if buf is None or buf.dtype != dtype or buf.numel() < n:
            size = max(n, 2 * buf.numel() if buf is not None
                       and buf.dtype == dtype else n)
            buf = torch.empty(size, dtype=dtype, pin_memory=True)
            self._bufs[name] = buf
        return buf[:n].view(shape)

    def upload(self, name: str, array: np.ndarray) -> torch.Tensor:
        """``array`` on the arena's device, copied through the buffer
        ``name`` without waiting for the device."""
        host = torch.from_numpy(np.array(array, copy=True, order="C"))
        if self.device.type != "cuda":
            return host
        buf = self._buffer(name, tuple(host.shape), host.dtype)
        buf.copy_(host)
        return buf.to(self.device, non_blocking=True)

    def download(self, name: str, tensor: torch.Tensor) -> torch.Tensor:
        """Starts copying ``tensor`` into the buffer ``name`` and returns
        that host view; it holds the values once the stream has passed
        this point (an event recorded after it has fired). Read it before
        the arena goes back to its pool."""
        if tensor.device.type != "cuda":
            return tensor
        buf = self._buffer(name, tuple(tensor.shape), tensor.dtype)
        buf.copy_(tensor, non_blocking=True)
        return buf


class StagingPool:
    """Free :class:`PinnedArena` objects, per device."""

    def __init__(self):
        self._free: dict[torch.device, list[PinnedArena]] = {}
        self.arenas = 0  # arenas ever made: the most in flight at once

    def acquire(self, device: torch.device) -> PinnedArena:
        free = self._free.setdefault(torch.device(device), [])
        if free:
            return free.pop()
        self.arenas += 1
        return PinnedArena(device)

    def release(self, arena: PinnedArena) -> None:
        """Hands an arena back; every copy from or into it must have
        completed."""
        self._free.setdefault(arena.device, []).append(arena)
