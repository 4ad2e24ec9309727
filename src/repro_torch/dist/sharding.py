"""Logical-axis sharding rules (``repro.dist.sharding``), the pure half.

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

Nothing here places a tensor. The placing half of the reference
(``logical_to_sharding``, ``tree_shardings``, ``constrain``,
``baseline_mode``) maps onto DTensor placements and waits for ROADMAP.md
Queue 1 item 5.6b.
"""

from __future__ import annotations

import contextlib
import dataclasses
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
