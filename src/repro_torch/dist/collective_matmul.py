"""Collective matmuls (``repro.dist.collective_matmul``): a collective
decomposed into ring steps interleaved with the matmuls.

Matmul-then-all-reduce (or all-gather-then-matmul) serializes the
collective and the compute. These functions break the collective into
``n - 1`` point-to-point ring steps (``dist.batch_isend_irecv`` over the
mesh axis's process group) and issue the next piece of arithmetic while
a step is in flight, the "collective matmul" pattern (Wang et al.,
ASPLOS'23). The partial products are ``torch.matmul``, as in the
reference, where they run outside any Pallas kernel.

The API is the reference's: every rank passes the global ``x`` and ``w``
and receives the global ``x @ w``. ``ring_matmul_reduce`` shards the
contraction dim of ``x`` and the rows of ``w`` over the axis; rank r
adds, in the reference's order, its own partial, then those arriving
from r - 1, r - 2, ... (each rank's sum has its own order, so ranks may
differ in the last bits). ``ag_matmul_pipelined`` shards the rows of
``x`` and the columns of ``w``; row chunks of ``x`` circulate and each
is multiplied into its slot of the rank's column block, and the blocks
are gathered at the end. Ring neighbours are read from the mesh
(:func:`repro_torch.dist.sharding.axis_ranks`).

Fallback, as the reference's: a size-1 axis (no mesh, or a mapping), or
dims not divisible by the axis size, compute ``x @ w`` here. A gloo group
has no point-to-point transfer of CUDA tensors, so there a step moves
through host copies; NCCL moves device tensors.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.dist.sharding import all_gather_axis, axis_ranks, mesh_shape


def _axis_size(mesh, axis: str) -> int:
    return 1 if mesh is None else mesh_shape(mesh).get(axis, 1)


def _ring(mesh, axis: str) -> tuple[int, int, int, int, object]:
    """(size, this rank's coordinate, next rank, previous rank, group)."""
    ranks = axis_ranks(mesh, axis)
    n = len(ranks)
    c = ranks.index(dist.get_rank())
    return n, c, ranks[(c + 1) % n], ranks[(c - 1) % n], mesh.get_group(axis)


class _Step:
    """One ring step in flight: ``chunk`` to the next rank, the previous
    rank's chunk into a fresh buffer. ``wait`` returns the received
    chunk on ``chunk``'s device."""

    def __init__(self, chunk: torch.Tensor, nxt: int, prv: int, group):
        staged = chunk.is_cuda and dist.get_backend(group) == "gloo"
        self.device = chunk.device
        send = chunk.cpu() if staged else chunk.contiguous()
        self.recv = torch.empty_like(send)
        self.works = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, nxt, group=group),
            dist.P2POp(dist.irecv, self.recv, prv, group=group)])
        self.send = send  # alive until the step ends

    def wait(self) -> torch.Tensor:
        for w in self.works:
            w.wait()
        return self.recv.to(self.device)


def ring_matmul_reduce(x: torch.Tensor, w: torch.Tensor, mesh,
                       axis: str = "model") -> torch.Tensor:
    """``x @ w`` with the contraction dim sharded over ``axis``: each rank
    multiplies its k-shard into a full-size partial, then the partials
    circulate the ring, each rank adding what arrives (an all-reduce
    unrolled into ``n - 1`` steps; the add of one arrival runs while the
    next is in flight). The result is on every rank."""
    n = _axis_size(mesh, axis)
    if n == 1 or x.shape[-1] % n:
        return x @ w
    n, c, nxt, prv, group = _ring(mesh, axis)
    kl = x.shape[-1] // n
    acc = x[..., c * kl:(c + 1) * kl] @ w[c * kl:(c + 1) * kl]
    step = _Step(acc, nxt, prv, group)
    for t in range(n - 1):
        chunk = step.wait()
        if t < n - 2:
            step = _Step(chunk, nxt, prv, group)
        acc = acc + chunk
    return acc


def ag_matmul_pipelined(x: torch.Tensor, w: torch.Tensor, mesh,
                        axis: str = "model") -> torch.Tensor:
    """``x @ w`` with ``x`` row-sharded and ``w`` column-sharded over
    ``axis``: row chunks of ``x`` circulate the ring, each multiplied into
    its slot of this rank's column block while the next chunk is in
    flight (a pipelined all-gather + matmul); the column blocks are then
    gathered, so the result is on every rank."""
    n = _axis_size(mesh, axis)
    if n == 1 or x.shape[0] % n or w.shape[-1] % n:
        return x @ w
    n, c, nxt, prv, group = _ring(mesh, axis)
    ml, nl = x.shape[0] // n, w.shape[-1] // n
    wl = w[:, c * nl:(c + 1) * nl]
    chunk = x[c * ml:(c + 1) * ml]
    out = torch.empty((x.shape[0], nl), dtype=torch.result_type(x, w),
                      device=x.device)
    for t in range(n):
        step = _Step(chunk, nxt, prv, group) if t < n - 1 else None
        src = (c - t) % n
        out[src * ml:(src + 1) * ml] = chunk @ wl
        if step is not None:
            chunk = step.wait()
    return all_gather_axis(out, mesh, axis, dim=1)
