"""Gradient compression for the cross-pod (DCN) hop
(``repro.dist.compression``): stochastic-rounding int8, magnitude top-k,
error-feedback top-k, the compressed all-reduces, and the wire-format
accounting behind the train step's ``dcn_bytes`` metric.

A gradient tree is a list of tensors, in the order ``params.parameters()``
yields them. The compressors return the *decompressed* values (same
shapes and dtypes), so they compose with any optimizer; the wire format
is implied by the math (int8 codes and one float32 scale a leaf, or
exactly k (int32 index, float32 value) pairs) and is what
``tree_wire_bytes`` counts.

Rounding draws. ``floor(x / s + u)`` with ``u ~ U[0, 1)`` keeps int8
unbiased (E[q s] = x). ``jax.random`` streams cannot be reproduced in
torch, so the port keys its own: a key is a 64-bit integer,
``per_step_key(seed, step)`` folds the step into the seed's root key and
``fold_in`` folds in the pod and then the leaf index (a fixed splitmix64
mix, never Python's ``hash``), mirroring the reference's ``fold_in``
chain; the legacy ``grad_compression`` folds in ``LEGACY_STREAM`` (the
reference's ``0x7e6``). A leaf's key seeds a ``torch.Generator`` on the
leaf's device, whose ``torch.rand`` gives the uniforms: seeding is host
arithmetic and makes the host wait for nothing. Every int8 entry point
also takes the uniforms as tensors (``u`` / ``uniforms``), so that parity
tests can pass in the reference's own draws.

Top-k. ``torch.topk`` promises no order among ties, so ``_topk_mask``
ranks unique int64 keys: the float32 bit pattern of ``|x|`` (monotone for
non-negative floats; ``-0.0`` becomes ``+0.0``) times ``n``, plus ``n - 1
- flat index``. The mask then selects exactly ``topk_count(n, frac)``
coordinates, ties going to the lower flat index, as ``lax.top_k`` does.
Error feedback keeps the reference's products ``acc * mask`` and
``acc * (1 - mask)``, so ``sent + new_err == grads + old_err`` bit for
bit.

The collectives take the mesh and one axis name (``"pod"``). As under the
reference's ``shard_map`` they take and return the calling rank's local
blocks: each rank compresses its own block, then sums (``all_reduce``)
the payload over that axis's process group (``DeviceMesh.get_group``).
The sum is one unordered ``all_reduce``: with two ranks it equals the
emulated route's pod-order fold bit for bit; with more, the collective's
summation order may differ from it in the last bits. With no mesh, or a
mapping whose axis has size 1, the collective is a no-op, as the
reference's psum is; a mapping whose axis is larger carries no process
group and raises, and so does a mesh without the axis: nothing swaps a
collective for a local sum.
"""

from __future__ import annotations

import itertools
import math
from collections.abc import Callable, Mapping

import torch
import torch.distributed as dist

from repro_torch.dist.sharding import mesh_shape

DCN_METHODS = ("none", "int8", "topk", "topk_ef")

# the legacy in-graph grad_compression's stream (the reference's 0x7e6)
LEGACY_STREAM = 0x7E6

_M64 = (1 << 64) - 1
# elements a chunk of the top-k key construction widens to int64 at once
_KEY_CHUNK = 1 << 26


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def root_key(seed: int) -> int:
    """The key of ``seed`` (the counterpart of ``PRNGKey(seed)``)."""
    return _splitmix64(seed & _M64)


def fold_in(key: int, data: int) -> int:
    """A new key from ``key`` and an integer (step, pod, leaf, stream)."""
    return _splitmix64(_splitmix64(key) ^ (data & _M64))


def per_step_key(seed: int, step: int) -> int:
    """Per-step rounding key: the seed's root key with the step folded in,
    so stochastic-rounding noise decorrelates across steps."""
    return fold_in(root_key(seed), step)


def _key(key: int | None) -> int:
    # the reference's default is the fixed legacy key PRNGKey(0)
    return root_key(0) if key is None else key


def draw_uniforms(shape, key: int, device) -> torch.Tensor:
    """U[0, 1) float32 draws from a generator on ``device`` seeded with
    ``key``."""
    g = torch.Generator(device=device)
    g.manual_seed(key)
    return torch.rand(shape, generator=g, device=device, dtype=torch.float32)


def _int8_quantize(x: torch.Tensor, key: int | None = None,
                   u: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(codes, scale): ``clip(floor(x / s + u), -127, 127)`` as float32
    and the float32 scale ``s = max(max |x|, 1e-30) / 127``."""
    xf = x.detach().float()
    scale = torch.clamp(xf.abs().amax(), min=1e-30) / 127.0
    if u is None:
        u = draw_uniforms(xf.shape, _key(key), xf.device)
    q = xf / scale
    q.add_(u).floor_().clamp_(-127, 127)
    return q, scale


def _int8_stochastic(x: torch.Tensor, key: int | None = None,
                     u: torch.Tensor | None = None) -> torch.Tensor:
    q, scale = _int8_quantize(x, key, u)
    return q.mul_(scale).to(x.dtype)


def topk_count(n: int, frac: float) -> int:
    """Coordinates top-k keeps of an n-element leaf:
    max(round(frac * n), 1)."""
    return max(int(round(frac * n)), 1)


def _topk_mask(x: torch.Tensor, frac: float) -> torch.Tensor:
    """0/1 mask (``x``'s dtype) selecting *exactly* ``topk_count``
    coordinates by |value|, ties broken toward the lower flat index
    (``lax.top_k`` order)."""
    bits = x.detach().float().abs().reshape(-1).view(torch.int32)
    n = bits.numel()
    k = topk_count(n, frac)
    key = torch.arange(n - 1, -1, -1, dtype=torch.int64, device=x.device)
    for s in range(0, n, _KEY_CHUNK):
        key[s:s + _KEY_CHUNK].add_(bits[s:s + _KEY_CHUNK].to(torch.int64)
                                   * n)
    del bits
    idx = torch.topk(key, k, sorted=False).indices
    del key
    mask = torch.zeros(n, dtype=x.dtype, device=x.device)
    mask.index_fill_(0, idx, 1)
    return mask.reshape(x.shape)


def _topk(x: torch.Tensor, frac: float) -> torch.Tensor:
    return x * _topk_mask(x, frac)


def _ef_leaf(g: torch.Tensor, e: torch.Tensor, frac: float
             ) -> tuple[torch.Tensor, torch.Tensor]:
    acc = g.detach().float() + e
    mask = _topk_mask(acc, frac)
    sent = acc * mask
    mask.neg_().add_(1.0)             # 1 - mask, exactly
    return sent, acc.mul_(mask)       # acc * (1 - mask)


def dcn_send_leaf(g: torch.Tensor, e: torch.Tensor | None, i: int,
                  method: str, topk_frac: float = 0.01,
                  key: int | None = None, u: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Leaf ``i`` of ``dcn_send``: ``(sent, new_error)``, ``e`` None for
    the stateless methods. ``key`` is the tree's key (int8 draws with
    ``fold_in(key, i)``), ``u`` the leaf's uniforms if given. The train
    step folds leaf by leaf with it, so no second tree of sends is held."""
    if method == "none":
        return g, e
    if method == "topk_ef":
        return _ef_leaf(g, e, topk_frac)
    if method == "topk":
        return _topk(g, topk_frac), e
    if method == "int8":
        return _int8_stochastic(g, fold_in(_key(key), i), u), e
    raise ValueError(f"unknown compression method: {method}")


def compress_tree(grads: list, method: str = "int8", topk_frac: float = 0.01,
                  key: int | None = None, uniforms: list | None = None
                  ) -> list:
    """Compress+decompress every leaf. ``method``: none | int8 | topk.

    ``key`` seeds the int8 stochastic rounding (leaf ``i`` draws with
    ``fold_in(key, i)``, or from ``uniforms[i]`` when given). The default
    is the fixed legacy key: identical noise every call, so training
    callers pass ``per_step_key(seed, step)``."""
    if method == "none":
        return grads
    if method not in ("int8", "topk"):
        raise ValueError(f"unknown compression method: {method}")
    us = uniforms if uniforms is not None else [None] * len(grads)
    return [dcn_send_leaf(g, None, i, method, topk_frac, key, u)[0]
            for i, (g, u) in enumerate(zip(grads, us))]


def init_error_state(grads: list) -> list:
    """Zero error-feedback residuals mirroring the grad tree (float32)."""
    return [torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for g in grads]


def topk_ef_compress(grads: list, error_state: list,
                     topk_frac: float = 0.01) -> tuple[list, list]:
    """Error-feedback top-k: returns (sent, new_error_state), with
    sent + new_error == grads + old_error exactly."""
    pairs = [_ef_leaf(g, e, topk_frac) for g, e in zip(grads, error_state)]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def dcn_send(grads: list, error, method: str = "int8",
             topk_frac: float = 0.01, key: int | None = None,
             uniforms: list | None = None):
    """One pod's DCN payload: ``(sent, new_error)``. ``error`` is ``{}``
    for the stateless methods (none / int8 / topk) and a grads-shaped
    float32 list for ``topk_ef``. ``method='none'`` is the identity."""
    if method == "none":
        return grads, error
    if method == "topk_ef":
        return topk_ef_compress(grads, error, topk_frac)
    return compress_tree(grads, method, topk_frac, key, uniforms), error


def leaf_wire_bytes(n: int, method: str, topk_frac: float = 0.01) -> int:
    """Bytes one n-element float32 leaf costs on the DCN per pod per step.

    none: 4n (raw float32). int8: n codes + one float32 scale.
    topk/topk_ef: exactly-k (int32 index, float32 value) pairs."""
    if method == "none":
        return 4 * n
    if method == "int8":
        return n + 4
    if method in ("topk", "topk_ef"):
        return 8 * topk_count(n, topk_frac)
    raise ValueError(f"unknown compression method: {method}")


def tree_wire_bytes(tree: list, method: str, topk_frac: float = 0.01) -> int:
    """Total per-pod DCN bytes for one send of a gradient tree."""
    return sum(leaf_wire_bytes(math.prod(t.shape) or 1, method, topk_frac)
               for t in tree)


def _axis_group(mesh, axis: str):
    """(process group or None, this rank's coordinate) of ``axis``."""
    if mesh is None:
        return None, 0
    sizes = mesh_shape(mesh)
    if axis not in sizes:
        raise ValueError(f"the mesh {sizes} has no {axis!r} axis")
    if isinstance(mesh, Mapping):
        if sizes[axis] > 1:
            raise ValueError(
                f"a mesh given as a mapping carries no process group: the "
                f"{axis!r} axis of size {sizes[axis]} needs a DeviceMesh")
        return None, 0
    return mesh.get_group(axis), mesh.get_local_rank(axis)


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def dcn_allreduce_tree(grads_stacked: list, error, mesh, axis: str = "pod",
                       method: str = "int8", topk_frac: float = 0.01,
                       key: int | None = None,
                       uniforms: list | None = None,
                       out: Callable | None = None):
    """Compressed all-reduce of this rank's gradient blocks over one mesh
    axis: the train step's DCN hop.

    ``grads_stacked`` leaves (any iterable: the train step gathers each
    leaf as it is reached) are this rank's ``(1, *shape)`` blocks of the
    per-pod stacked tree; ``error`` is ``{}`` or the matching ``(1,
    *shape)`` residual blocks (a list, or an iterable read in step with
    the leaves). The rank compresses its block (rounding key
    ``fold_in(key, pod)``, pod = its coordinate on ``axis``, as the
    emulated route's) and only then sums the payload over ``axis``.
    Returns ``(summed leaves without the leading dim, new (1, *shape)
    residuals or {})``; scaling by 1/P is the caller's job. The caller's
    blocks are not written. ``method='none'`` is a plain sum.

    ``out(i, summed leaf, new (1, *shape) residual or None)``, where
    given, takes each leaf as soon as it is summed, and the function
    returns ``(out's results, {})``: a caller that places each sum and
    keeps its residual there holds one whole leaf at a time."""
    if method not in DCN_METHODS:
        raise ValueError(f"unknown compression method: {method}")
    group, pod = _axis_group(mesh, axis)
    pod_key = fold_in(_key(key), pod)
    us = uniforms if uniforms is not None else itertools.repeat(None)
    errs = error if error else itertools.repeat(None)
    red, new_err = [], []
    for i, (gP, eP, u) in enumerate(zip(grads_stacked, errs, us)):
        if gP.shape[0] != 1:
            raise ValueError(f"leaf {i}: expected this rank's (1, ...) "
                             f"block, got {tuple(gP.shape)}")
        sent, ne = dcn_send_leaf(gP[0], None if eP is None else eP[0], i,
                                 method, topk_frac, pod_key, u)
        if method == "none":
            sent = sent.clone()
        summed = _all_reduce(sent, group)
        ne = ne[None] if error else None
        if out is not None:
            red.append(out(i, summed, ne))
        else:
            red.append(summed)
            new_err.append(ne)
        # the next leaf is gathered with none of this leaf's tensors held
        del gP, eP, sent, summed, ne
    return red, (new_err if error and out is None else {})


def cross_pod_allreduce(x: torch.Tensor, mesh, axis: str = "pod",
                        method: str = "int8", topk_frac: float = 0.01,
                        key: int | None = None,
                        u: torch.Tensor | None = None) -> torch.Tensor:
    """All-reduce (sum) over one mesh axis with this rank's block
    compressed before the wire (int8: key ``fold_in(key, rank's
    coordinate)``; topk: the block's top-k). ``x`` is the rank's block of
    an array sharded over ``axis`` on its leading dim; every rank gets
    the full sum. Per-step callers pass ``key=per_step_key(seed, step)``;
    with no key the fixed legacy key is used."""
    if method not in ("none", "int8", "topk"):
        raise ValueError(f"unknown compression method: {method}")
    group, idx = _axis_group(mesh, axis)
    if method == "int8":
        xl = _int8_stochastic(x, fold_in(_key(key), idx), u)
    elif method == "topk":
        xl = _topk(x, topk_frac)
    else:
        xl = x.clone()
    return _all_reduce(xl, group)
