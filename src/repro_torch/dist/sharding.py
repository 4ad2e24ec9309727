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
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from collections.abc import Mapping
from typing import Union

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
    ``set_mesh(None)`` returns to the single-device mode."""
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
    on tensor dim ``d``, ``Replicate()`` on every other. A tuple entry
    whose axes are out of the mesh's order raises ``ValueError`` (see the
    module docstring)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_shape(mesh))
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
            placements[i] = Shard(d)
    return tuple(placements)


def tree_shardings(axes_tree, shapes_tree, mesh,
                   rules: ShardingRules | None = None):
    """Map a tree (nested dicts, lists, tuples) of logical-axes tuples and
    a matching tree of tensors (or anything with ``.shape``, or shape
    tuples) to the same tree of placements."""
    if is_axes_leaf(axes_tree):
        shape = getattr(shapes_tree, "shape", shapes_tree)
        return logical_to_sharding(axes_tree, tuple(shape), mesh, rules)
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
