"""Logical-axis sharding rules and placements (``repro.dist.sharding``).

Model code names *logical* axes (``batch``, ``heads``, ``ff``, ``fsdp``,
``dcn_pod``, ...); a :class:`ShardingRules` table maps each to zero or
more *mesh* axes (``pod``, ``data``, ``model``), and ``logical_to_spec``
resolves a tuple of logical names against a mesh into the entries a
``PartitionSpec`` holds: ``None`` (replicated), a mesh-axis name, or a
tuple of names. It keeps the reference's three rules for degrading a
spec: mesh axes absent from the mesh are dropped; a mesh axis already
used by an earlier dim is dropped; a dim not divisible by the product of
the axes picked so far stops taking more (possibly none: replicated).

A mesh here is a ``torch.distributed.device_mesh.DeviceMesh`` with
``mesh_dim_names``, or a plain ``{axis name: size}`` mapping (which
describes a mesh and carries no process group); ``mesh_shape`` reads
either as names and sizes. ``set_mesh`` installs a process-global mesh
and rules, as the reference's does, so the train step can find the
``pod`` axis without a mesh threaded through every call.

The placing half maps a spec onto DTensor placements:
``logical_to_sharding`` gives one placement a mesh dim (``Shard(d)``
where the spec puts that mesh axis on tensor dim ``d``, else
``Replicate()``), ``tree_shardings`` maps it over nested dict / list /
tuple trees, and ``constrain`` redistributes a ``DTensor`` against the
global mesh (the reference's ``with_sharding_constraint``).

A spec entry that is a tuple puts several mesh axes on one tensor dim.
GSPMD orders their blocks by the tuple's order, DTensor by the mesh's
dim order; the two agree when the tuple follows the mesh's order, as
every rule of ``DEFAULT_RULES`` and ``RULE_PRESETS`` does. A tuple out of
the mesh's order raises ``ValueError`` in ``logical_to_sharding``
rather than being laid out in another block order than the reference's.

``distribute_tree`` places a tree of tensors (``nn.Module`` parameters,
dataclasses, dicts, lists) by a matching tree of logical axes, each leaf
cut to a copy of this rank's block on its own (every rank holds the same
full value, so nothing is sent, and the full value can be freed);
``local_map_axes`` runs a function on each rank's local blocks behind
``local_map``, with the placements read from logical axes, and
``local_range`` says which block of a dim this rank holds.

gloo refuses no collective on CUDA tensors through its ``c10d`` calls,
but DTensor issues its redistributions through the functional
collectives, which crashed on CUDA tensors in a gloo group on the H100
(torch 2.11). ``install_gloo_collectives`` swaps the four functional
collectives DTensor's placements call (all-gather, all-reduce,
reduce-scatter and the shard-dim all-to-all, the last as an all-gather
and a local chunk, as DTensor does on CPU meshes) for blocking ``c10d``
calls on a gloo group, and counts each in ``GLOO_COLLECTIVES`` (its host
seconds in ``GLOO_COLLECTIVE_S``); any other backend takes torch's own
functions.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import os
import time
from collections.abc import Mapping
from typing import Callable, Union

# a logical axis maps to: no mesh axis (replicate), one mesh axis, or an
# ordered preference of mesh axes (all that exist + divide are used)
Rule = Union[None, str, tuple]


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Logical-axis -> mesh-axis mapping (the GSPMD "logical axis rules"
    idiom). Field names are the logical axes the models use."""

    batch: Rule = ("pod", "data")      # data-parallel batch dim
    dcn_pod: Rule = "pod"              # stacked per-pod dim (grads/EF state)
    fsdp: Rule = "data"                # FSDP-sharded param dim
    heads: Rule = "model"              # attention query heads (TP)
    kv_heads: Rule = "model"           # attention kv heads (TP)
    ff: Rule = "model"                 # FFN hidden dim (TP)
    experts: Rule = "model"            # MoE expert dim (EP)
    vocab: Rule = "model"              # embedding/unembed vocab dim
    seq: Rule = None                   # sequence dim (context parallelism)
    seq_shard: Rule = "model"          # TP sequence-parallel activations
    kv_seq: Rule = None                # KV-cache sequence dim
    layer: Rule = None                 # stacked-layer leading dim

    def lookup(self, name: str) -> Rule:
        return getattr(self, name)

    def replace(self, **kw) -> "ShardingRules":
        return dataclasses.replace(self, **kw)


DEFAULT_RULES = ShardingRules()

RULE_PRESETS = {
    "default": DEFAULT_RULES,
    # pure FSDP: no tensor/expert parallelism, weights sharded over 'data'
    "fsdp_only": ShardingRules(heads=None, kv_heads=None, ff=None,
                               experts=None, vocab=None, seq_shard=None),
}

_STATE: dict = {"mesh": None, "rules": DEFAULT_RULES}


def set_mesh(mesh, rules: ShardingRules | None = None) -> None:
    """Install the process-global mesh (+ optional rules).
    ``set_mesh(None)`` returns to the single-device mode. A ``DeviceMesh``
    over a gloo group also installs ``install_gloo_collectives``."""
    if is_device_mesh(mesh):
        install_gloo_collectives()
    _STATE["mesh"] = mesh
    _STATE["rules"] = rules or DEFAULT_RULES


def get_mesh():
    return _STATE["mesh"]


def get_rules() -> ShardingRules:
    return _STATE["rules"]


def mesh_shape(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (by its
    ``mesh_dim_names``) or of a mapping; ``{}`` for no mesh."""
    if mesh is None:
        return {}
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    names = getattr(mesh, "mesh_dim_names", None)
    if not names:
        raise ValueError("a DeviceMesh needs mesh_dim_names to be read as "
                         "named axes")
    return dict(zip(names, (int(s) for s in mesh.mesh.shape)))


def pod_axis_size(mesh) -> int:
    """Size of the 'pod' (DCN) axis of a mesh, 1 when absent / no mesh."""
    return mesh_shape(mesh).get("pod", 1)


def without_axis(rule: Rule, axis: str) -> Rule:
    """Drop one mesh axis from a rule (None/str/tuple all handled)."""
    if rule is None:
        return None
    if isinstance(rule, str):
        return None if rule == axis else rule
    kept = tuple(a for a in rule if a != axis)
    return kept or None


@contextlib.contextmanager
def rules_override(**kw):
    """Temporarily replace rule fields on the installed global rules."""
    old = _STATE["rules"]
    _STATE["rules"] = old.replace(**kw)
    try:
        yield _STATE["rules"]
    finally:
        _STATE["rules"] = old


def baseline_mode() -> bool:
    """REPRO_BASELINE=1 disables the tuned sharding-constraint placements
    (the reference's A/B lever; the port keeps its own copy)."""
    return os.environ.get("REPRO_BASELINE", "0") == "1"


def logical_to_spec(axes: tuple, shape: tuple, mesh,
                    rules: ShardingRules | None = None) -> tuple:
    """Resolve logical axis names against a mesh into the entries of a
    ``PartitionSpec`` (one a dim: ``None``, a mesh-axis name or a tuple
    of names), degrading as the module docstring says."""
    rules = rules or get_rules()
    sizes = mesh_shape(mesh)
    used: set[str] = set()
    entries = []
    for name, dim in zip(axes, shape):
        rule = rules.lookup(name) if name else None
        if rule is None:
            entries.append(None)
            continue
        cands = (rule,) if isinstance(rule, str) else tuple(rule)
        picked = []
        prod = 1
        for c in cands:
            if c not in sizes or c in used:
                continue
            if dim % (prod * sizes[c]) != 0:
                continue
            picked.append(c)
            prod *= sizes[c]
        used.update(picked)
        if not picked:
            entries.append(None)
        elif len(picked) == 1:
            entries.append(picked[0])
        else:
            entries.append(tuple(picked))
    return tuple(entries)


def is_axes_leaf(x) -> bool:
    """True for a logical-axes tuple leaf like ('batch', None, 'heads')."""
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def logical_to_sharding(axes: tuple, shape: tuple, mesh,
                        rules: ShardingRules | None = None) -> tuple:
    """The DTensor placements of ``logical_to_spec``'s entries, one a mesh
    dim in the mesh's order: ``Shard(d)`` on each mesh dim the spec puts
    on tensor dim ``d``, ``Replicate()`` on every other, and on a mesh dim
    of size 1 (which holds the whole dim either way: the same layout, and
    DTensor then never splits or merges a dim it calls sharded). A tuple
    entry whose axes are out of the mesh's order raises ``ValueError``
    (see the module docstring)."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = mesh_shape(mesh)
    names = list(sizes)
    placements: list = [Replicate()] * len(names)
    for d, entry in enumerate(logical_to_spec(axes, shape, mesh, rules)):
        if entry is None:
            continue
        picked = (entry,) if isinstance(entry, str) else tuple(entry)
        order = [names.index(a) for a in picked]
        if order != sorted(order):
            raise ValueError(
                f"the spec entry {picked} of dim {d} puts mesh axes on one "
                f"tensor dim out of the mesh's order {tuple(names)}: GSPMD "
                f"would order its blocks {picked}, DTensor by the mesh")
        for i in order:
            if sizes[names[i]] > 1:
                placements[i] = Shard(d)
    return tuple(placements)


def tree_shardings(axes_tree, shapes_tree, mesh,
                   rules: ShardingRules | None = None):
    """Map a tree (nested dicts, lists, tuples, dataclasses) of
    logical-axes tuples and a matching tree of tensors (or anything with
    ``.shape``, or shape tuples; an ``nn.Module`` as its ``parameters()``
    list) to the same tree of placements; a scalar leaf (a step counter)
    maps to None."""
    import torch

    if isinstance(shapes_tree, torch.nn.Module):
        shapes_tree = list(shapes_tree.parameters())
    if is_axes_leaf(axes_tree):
        if shapes_tree is None or isinstance(shapes_tree, (bool, int,
                                                           float)):
            return None
        shape = getattr(shapes_tree, "shape", shapes_tree)
        return logical_to_sharding(axes_tree, tuple(shape), mesh, rules)
    if dataclasses.is_dataclass(axes_tree):
        return dataclasses.replace(axes_tree, **{
            f.name: tree_shardings(getattr(axes_tree, f.name),
                                   getattr(shapes_tree, f.name), mesh, rules)
            for f in dataclasses.fields(axes_tree)})
    if isinstance(axes_tree, Mapping):
        return {k: tree_shardings(v, shapes_tree[k], mesh, rules)
                for k, v in axes_tree.items()}
    if isinstance(axes_tree, (list, tuple)):
        out = [tree_shardings(a, s, mesh, rules)
               for a, s in zip(axes_tree, shapes_tree, strict=True)]
        return out if isinstance(axes_tree, list) else tuple(out)
    raise TypeError(f"not an axes tree node: {axes_tree!r}")


def constrain(x, *axes):
    """The reference's ``with_sharding_constraint`` against the global
    mesh: a ``DTensor`` is redistributed to the placements of ``axes``.
    With no mesh, or a mesh given as a mapping (no process group), it is
    the identity. A plain tensor is returned as it is when a mesh is set:
    it is this rank's own value, and nothing says how it relates to the
    other ranks' (placing it is ``distribute_tensor``'s work)."""
    mesh = get_mesh()
    if mesh is None or isinstance(mesh, Mapping):
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh, logical_to_sharding(tuple(axes),
                                                    tuple(x.shape), mesh))


# --------------------------------------------------------------------------
# a mesh axis's process group, in the axis's order
# --------------------------------------------------------------------------

def axis_ranks(mesh, axis: str) -> list[int]:
    """The global ranks along ``axis`` through this rank, in ascending
    coordinate of the axis (the order of its blocks). A mapping mesh
    carries no ranks: its axis must have size 1, and this rank is taken
    alone."""
    sizes = mesh_shape(mesh)
    if axis not in sizes:
        raise ValueError(f"the mesh {sizes} has no {axis!r} axis")
    if isinstance(mesh, Mapping):
        if sizes[axis] > 1:
            raise ValueError(
                f"a mesh given as a mapping carries no process group: the "
                f"{axis!r} axis of size {sizes[axis]} needs a DeviceMesh")
        return [0]
    d = list(sizes).index(axis)
    coord = list(mesh.get_coordinate())
    index = tuple(slice(None) if i == d else c for i, c in enumerate(coord))
    return [int(r) for r in mesh.mesh[index].tolist()]


def all_gather_axis(t, mesh, axis: str, dim: int):
    """Every rank's ``t`` along ``axis``, concatenated on ``dim`` in
    ascending coordinate of the axis (read from the mesh, not from the
    group's rank order). ``t`` has one shape on every rank."""
    import torch
    import torch.distributed as dist

    ranks = axis_ranks(mesh, axis)
    if len(ranks) == 1:
        return t
    group = mesh.get_group(axis)
    t = t.contiguous()
    bufs = [torch.empty_like(t) for _ in ranks]
    dist.all_gather(bufs, t, group=group)
    by_rank = {dist.get_global_rank(group, i): b for i, b in enumerate(bufs)}
    return torch.cat([by_rank[r] for r in ranks], dim=dim)


def all_reduce_axes(t, op: str, axes: tuple, mesh=None):
    """``t`` reduced in place (``op``: "sum" or "max") over the ranks
    along each mesh axis of ``axes`` in turn (default mesh: the installed
    one), through blocking ``c10d`` calls; on a gloo group each is counted
    in ``GLOO_COLLECTIVES``, as DTensor's redistributions are. Returns
    ``t``."""
    import torch.distributed as dist

    mesh = mesh if mesh is not None else get_mesh()
    for a in axes:
        if mesh_shape(mesh)[a] == 1:
            continue
        pg = mesh.get_group(a)
        with (_counted("all_reduce") if _is_gloo(pg)
              else contextlib.nullcontext()):
            dist.all_reduce(t, op=_reduce_op(op), group=pg)
    return t


# --------------------------------------------------------------------------
# DTensors: placing trees, local regions, the gloo collectives
# --------------------------------------------------------------------------

def is_device_mesh(mesh) -> bool:
    """True for a ``DeviceMesh`` (a mesh with process groups); False for
    None or a ``{name: size}`` mapping."""
    return mesh is not None and not isinstance(mesh, Mapping)


def on_mesh(x) -> bool:
    """True when ``x`` is a ``DTensor``."""
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def full_value(x):
    """A ``DTensor``'s whole value on every rank (a collective); any other
    tensor as it is."""
    return x.full_tensor() if on_mesh(x) else x


def local_value(x):
    """A ``DTensor``'s local block (a view: writing it writes the DTensor);
    any other tensor as it is."""
    return x.to_local() if on_mesh(x) else x


def place_like(t, ref):
    """``t`` (the whole value, the same on every rank) placed as the
    ``DTensor`` ``ref`` is (its mesh and placements), cut to this rank's
    block with nothing sent; ``t`` itself when ``ref`` is no DTensor."""
    if not on_mesh(ref):
        return t
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )

    shape, offset = compute_local_shape_and_global_offset(
        tuple(t.shape), ref.device_mesh, ref.placements)
    local = t
    if tuple(shape) != tuple(t.shape):
        # a copy of the block: a view would keep the whole value alive
        local = t[tuple(slice(o, o + n) for o, n in
                        zip(offset, shape))].clone()
    return DTensor.from_local(local, ref.device_mesh,
                              ref.placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def place(t, axes: tuple, mesh):
    """``t`` (this rank's full value, the same on every rank) as a DTensor
    placed by ``axes``, cut to this rank's block with nothing sent; an
    ``nn.Parameter`` stays a parameter with its ``requires_grad``. ``t``
    itself with no ``DeviceMesh``."""
    import torch
    from torch.distributed.tensor import DTensor, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )

    if not is_device_mesh(mesh) or on_mesh(t):
        return t
    install_gloo_collectives()
    pl = logical_to_sharding(tuple(axes), tuple(t.shape), mesh)
    local = t.detach()
    if any(isinstance(p, Shard) for p in pl):
        # a copy of the block: a view would keep the whole value alive
        shape, offset = compute_local_shape_and_global_offset(
            tuple(t.shape), mesh, pl)
        local = local[tuple(slice(o, o + n) for o, n in
                            zip(offset, shape))].clone()
    d = DTensor.from_local(local, mesh, pl, run_check=False,
                           shape=t.shape, stride=t.stride())
    if isinstance(t, torch.nn.Parameter):
        return torch.nn.Parameter(d, requires_grad=t.requires_grad)
    return d


def distribute_tree(tree, axes_tree, mesh):
    """The reference's ``device_put`` of each leaf by
    ``logical_to_sharding``: every tensor leaf of ``tree`` becomes a
    DTensor placed by the logical axes at the same place of
    ``axes_tree``, leaf by leaf (each rank keeps its block and drops the
    full value). ``tree`` holds tensors, ``nn.Module``s (their parameters
    are replaced in place, ``axes_tree`` a list in ``parameters()``
    order), dataclasses, dicts, lists and scalars (kept). With no mesh or
    a mapping mesh the tree is returned as it is."""
    import torch

    if not is_device_mesh(mesh):
        return tree
    if isinstance(tree, torch.nn.Module):
        named = list(tree.named_parameters())
        if len(named) != len(axes_tree):
            raise ValueError(f"{len(axes_tree)} axes for {len(named)} "
                             f"parameters")
        for (name, p), axes in zip(named, axes_tree):
            owner, _, leaf = name.rpartition(".")
            mod = tree.get_submodule(owner) if owner else tree
            setattr(mod, leaf, place(p, axes, mesh))
        return tree
    if isinstance(tree, torch.Tensor):
        return place(tree, axes_tree, mesh)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: distribute_tree(getattr(tree, f.name),
                                    getattr(axes_tree, f.name), mesh)
            for f in dataclasses.fields(tree)})
    if isinstance(tree, Mapping):
        return {k: distribute_tree(v, axes_tree[k], mesh)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(distribute_tree(v, a, mesh)
                          for v, a in zip(tree, axes_tree, strict=True))
    return tree


def local_range(axes: tuple, shape: tuple, dim: int, mesh=None
                ) -> tuple[int, int]:
    """(first index, length) of this rank's block of dim ``dim`` of a
    tensor of global ``shape`` placed by ``axes`` on ``mesh`` (default:
    the installed one); the whole dim with no ``DeviceMesh``."""
    mesh = mesh if mesh is not None else get_mesh()
    if not is_device_mesh(mesh):
        return 0, int(shape[dim])
    sizes = mesh_shape(mesh)
    index, count = 0, 1
    for a in dim_axes(axes, shape, dim, mesh):   # blocks in the mesh's order (logical_to_sharding)
        index = index * sizes[a] + mesh.get_local_rank(a)
        count *= sizes[a]
    n = int(shape[dim]) // count
    return index * n, n


def dim_axes(axes: tuple, shape: tuple, dim: int, mesh=None) -> tuple:
    """The mesh axes that shard dim ``dim`` of a tensor of global
    ``shape`` placed by ``axes`` (in the mesh's order); () with no
    ``DeviceMesh`` or a replicated dim."""
    mesh = mesh if mesh is not None else get_mesh()
    if not is_device_mesh(mesh):
        return ()
    entry = logical_to_spec(tuple(axes), tuple(shape), mesh)[dim]
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_map_axes(fn: Callable, in_axes: tuple, out_axes: tuple,
                   reduced: tuple = ()) -> Callable:
    """``fn`` run on each rank's local blocks (``local_map``), placed by
    logical axes: argument ``i`` is redistributed to ``in_axes[i]`` (None:
    passed as it is), and output ``j`` is placed by ``out_axes[j]``, each
    logical name taking the mesh axes it took in the inputs (a name no
    input had is replicated). The mesh axes the names in ``reduced`` took
    in the inputs hold partial sums of the outputs (``Partial``): ``fn``
    summed over those blocks. An input's gradient is partial over the
    mesh axes that split another input but not it (a weight beside a
    batch-sharded activation). With no DTensor argument ``fn`` is called
    as it is."""
    def run(*args):
        from torch.distributed.tensor import Partial, Replicate, Shard
        from torch.distributed.tensor.experimental import local_map

        if not any(on_mesh(a) for a in args):
            return fn(*args)
        m = next(a.device_mesh for a in args if on_mesh(a))
        taken: dict = {}
        placed, in_pl = [], []
        for a, axes in zip(args, in_axes, strict=True):
            if axes is None or not on_mesh(a):
                placed.append(a)
                in_pl.append(None)
                continue
            pl = logical_to_sharding(tuple(axes), tuple(a.shape), m)
            for d, name in enumerate(axes):
                if name is not None:
                    taken.setdefault(name, tuple(
                        i for i, p in enumerate(pl) if p == Shard(d)))
            placed.append(a.redistribute(m, pl))
            in_pl.append(pl)
        # an input replicated over a mesh dim that splits another input
        # (its batch, say) gets a partial gradient there: each rank's
        # block of the work contributes its own part
        split = {i for pl in in_pl if pl for i, p in enumerate(pl)
                 if p != Replicate()}
        grad_pl = [None if pl is None else tuple(
            Partial() if i in split and p == Replicate() else p
            for i, p in enumerate(pl)) for pl in in_pl]
        out_pl = []
        for axes in out_axes:
            pl = [Replicate()] * m.ndim
            for d, name in enumerate(axes):
                for i in taken.get(name, ()):
                    pl[i] = Shard(d)
            for name in reduced:
                for i in taken.get(name, ()):
                    pl[i] = Partial()
            out_pl.append(tuple(pl))
        def contiguous(*local):
            # a DTensor's views assume its local block is contiguous: the
            # outputs, and the gradients that leave the region, are made so
            out = fn(*(_contiguous_grad(t) for t in local))
            if isinstance(out, tuple):
                return tuple(o.contiguous() for o in out)
            return None if out is None else out.contiguous()

        # no outputs: fn returns None, which local_map takes as one leaf
        return local_map(contiguous, out_placements=tuple(out_pl) or None,
                         in_placements=tuple(in_pl),
                         in_grad_placements=tuple(grad_pl),
                         device_mesh=m)(*placed)
    return run


@functools.cache
def _contiguous_grad_fn():
    import torch

    class ContiguousGrad(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            return g.contiguous()

    return ContiguousGrad


def _contiguous_grad(t):
    """``t`` itself, its gradient made contiguous in backward (a tensor
    that needs none is passed as it is)."""
    import torch

    if not (isinstance(t, torch.Tensor) and t.requires_grad):
        return t
    return _contiguous_grad_fn().apply(t)


@contextlib.contextmanager
def mesh_context():
    """Inside a forward on a ``DeviceMesh``: plain tensors made on the way
    (positions, masks, RoPE angles; the same on every rank) are taken as
    replicated (``implicit_replication``), also when entered again inside
    itself (a remat's recompute in backward); a no-op otherwise."""
    if not is_device_mesh(get_mesh()) or _STATE.get("implicit"):
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication

    _STATE["implicit"] = True
    try:
        with implicit_replication():
            yield
    finally:
        _STATE["implicit"] = False


def in_mesh_context(fn: Callable) -> Callable:
    """``fn`` run inside :func:`mesh_context`."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with mesh_context():
            return fn(*args, **kwargs)
    return run


# the functional collectives DTensor's placements call, by the names the
# torch releases use, and the blocking c10d route a gloo group takes
GLOO_COLLECTIVES: collections.Counter = collections.Counter()
GLOO_COLLECTIVE_S: collections.Counter = collections.Counter()  # host s
_FUNCOL_NAMES = {"all_gather_single": "all_gather",
                 "all_gather_tensor": "all_gather",
                 "all_reduce": "all_reduce",
                 "reduce_scatter_single": "reduce_scatter",
                 "reduce_scatter_tensor": "reduce_scatter"}
_ORIGINAL: dict = {}


def _group(group):
    """The ``ProcessGroup`` of a functional collective's ``group``
    argument: a group, a ``(DeviceMesh, dim)`` pair, a 1-D mesh or a
    group name."""
    import torch.distributed as dist
    from torch.distributed import distributed_c10d as c10d

    if isinstance(group, dist.ProcessGroup):
        return group
    if isinstance(group, tuple):
        mesh, dim = group
        return mesh.get_group(dim)
    if isinstance(group, str):
        return c10d._resolve_process_group(group)
    return group.get_group(0)


def _is_gloo(pg) -> bool:
    import torch.distributed as dist

    return dist.get_backend(pg) == "gloo"


def _reduce_op(name: str):
    import torch.distributed as dist

    return {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
            "min": dist.ReduceOp.MIN,
            "product": dist.ReduceOp.PRODUCT}[name.lower()]


@contextlib.contextmanager
def _counted(kind: str):
    """Counts one gloo collective of ``kind`` and its host seconds (the
    c10d calls block until the group has finished)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        GLOO_COLLECTIVES[kind] += 1
        GLOO_COLLECTIVE_S[kind] += time.perf_counter() - t0


def _gloo_all_gather(t, gather_dim: int, pg):
    import torch
    import torch.distributed as dist

    n = pg.size()
    t = t.contiguous()
    out = t.new_empty((n * t.shape[0], *t.shape[1:]))
    # the name newer torch releases give c10d's all_gather_into_tensor
    getattr(dist, "all_gather_single", dist.all_gather_into_tensor)(
        out, t, group=pg)
    if gather_dim != 0:
        out = torch.cat(out.chunk(n), dim=gather_dim)
    return out


def _gloo_collective(kind: str, original: Callable) -> Callable:
    import torch
    import torch.distributed as dist

    def all_gather(self, gather_dim, group, tag=""):
        pg = _group(group)
        if not _is_gloo(pg):
            return original(self, gather_dim, group, tag)
        with _counted("all_gather"):
            return _gloo_all_gather(self, gather_dim, pg)

    def all_reduce(self, reduceOp, group, tag=""):
        pg = _group(group)
        if not _is_gloo(pg):
            return original(self, reduceOp, group, tag)
        out = self.clone(memory_format=torch.contiguous_format)
        avg = reduceOp.lower() == "avg"
        with _counted("all_reduce"):
            dist.all_reduce(out, op=_reduce_op("sum" if avg else reduceOp),
                            group=pg)
        return out.div_(pg.size()) if avg else out

    def reduce_scatter(self, reduceOp, scatter_dim, group, tag=""):
        pg = _group(group)
        if not _is_gloo(pg):
            return original(self, reduceOp, scatter_dim, group, tag)
        n = pg.size()
        x = self
        if scatter_dim != 0:
            x = torch.cat(x.chunk(n, dim=scatter_dim), dim=0)
        x = x.contiguous()
        out = x.new_empty((x.shape[0] // n, *x.shape[1:]))
        avg = reduceOp.lower() == "avg"
        with _counted("reduce_scatter"):
            getattr(dist, "reduce_scatter_single", dist.reduce_scatter_tensor)(
                out, x, op=_reduce_op("sum" if avg else reduceOp), group=pg)
        # chunk i of scatter_dim as rows block i: each rank's block has the
        # shape of its chunk
        return out.div_(n) if avg else out

    return {"all_gather": all_gather, "all_reduce": all_reduce,
            "reduce_scatter": reduce_scatter}[kind]


def _gloo_shard_dim_alltoall(original: Callable) -> Callable:
    def shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        pg = mesh.get_group(mesh_dim)
        if not _is_gloo(pg):
            return original(input, gather_dim, shard_dim, mesh, mesh_dim)
        with _counted("all_gather"):
            out = _gloo_all_gather(input, gather_dim, pg)
        n = mesh.size(mesh_dim)
        return out.chunk(n, dim=shard_dim)[
            mesh.get_local_rank(mesh_dim)].contiguous()
    return shard_dim_alltoall


def install_gloo_collectives() -> None:
    """Routes DTensor's functional collectives on a gloo group through
    blocking ``c10d`` calls (see the module docstring); idempotent. A
    group of any other backend still takes torch's functions."""
    if _ORIGINAL:
        return
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import _collective_utils, placement_types

    for name, kind in _FUNCOL_NAMES.items():
        if hasattr(funcol, name):
            _ORIGINAL[name] = getattr(funcol, name)
            setattr(funcol, name, _gloo_collective(kind, _ORIGINAL[name]))
    _ORIGINAL["shard_dim_alltoall"] = _collective_utils.shard_dim_alltoall
    swapped = _gloo_shard_dim_alltoall(_ORIGINAL["shard_dim_alltoall"])
    for mod in (_collective_utils, placement_types):
        if hasattr(mod, "shard_dim_alltoall"):
            setattr(mod, "shard_dim_alltoall", swapped)
