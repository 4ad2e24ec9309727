"""Persisted tuning tables: measured ceilings + winning launch knobs.

Counterpart of ``repro.tune.table``, with the same JSON schema and the
same shape-bucket strings. A table is one JSON file written by
``repro_torch.launch.tune`` (the sweep in :mod:`repro_torch.tune.sweep`):

.. code-block:: json

    {
      "schema": 1,
      "device_kind": "NVIDIA H100 80GB HBM3",
      "ceilings": {"peak_flops_fp32": 5.1e13, "hbm_bw": 2.9e12, ...},
      "ops": {
        "topk_hamming": {
          "32x2097152x256": {
            "blocks": {"block_q": 32, "waves": 2},
            "us": 2700.0, "default_us": 2800.0
          }
        }
      }
    }

Lookups are keyed by (device kind, op, shape bucket):

* **device kind** is ``torch.cuda.get_device_name`` on the card and
  ``"cpu"`` on the CPU; a table written on one kind is never applied on
  another (one-time log line, then defaults). The knobs are the CUDA
  kernels', not the TPU's, so the port reads its own env var,
  ``REPRO_TORCH_TUNING_TABLE``: a JAX table and a port table written on
  the CPU would both say ``"cpu"``.
* **shape bucket**: each shape dimension rounds up to a power of two
  (:func:`shape_bucket`), so nearby problem sizes share one entry.
* A corrupt, partial or schema-mismatched file degrades to "no table"
  with a one-time log line, and never raises into the serving path;
  entries whose knobs break the kernel's rules are dropped at load
  (``block_utils.block_aligned``).

The wrappers resolve their knobs on every launch, and the served paths
are host-bound, so each (op, device, bucket) lookup is memoized: with no
table the resolution costs a dict lookup. The env var is read once, at
the first lookup, and again after :func:`reset`;
:func:`set_active_table` installs a table and clears the memo.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from pathlib import Path

import torch

SCHEMA = 1
ENV_VAR = "REPRO_TORCH_TUNING_TABLE"

log = logging.getLogger("repro_torch.tune")

# each distinct fallback cause is reported once per process
_logged: set[str] = set()


def _log_once(key: str, msg: str) -> None:
    if key not in _logged:
        _logged.add(key)
        log.warning(msg)


def device_kind(device=None) -> str:
    """The device kind a table is keyed by: the card's name
    (``torch.cuda.get_device_name``) for a CUDA device, ``"cpu"`` for the
    CPU. ``device=None`` means the current CUDA device where there is one,
    else the CPU."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


def _pow2_ceil(n: int) -> int:
    n = max(int(n), 1)
    return 1 << (n - 1).bit_length()


def shape_bucket(shape: tuple[int, ...]) -> str:
    """Power-of-two bucket key for an op shape tuple, e.g. ``(100, 8000,
    32)`` -> ``"128x8192x32"``."""
    return "x".join(str(_pow2_ceil(d)) for d in shape)


@dataclasses.dataclass
class TuningTable:
    """In-memory form of one persisted table (see module docstring)."""

    device_kind: str
    ceilings: dict = dataclasses.field(default_factory=dict)
    ops: dict = dataclasses.field(default_factory=dict)
    meta: dict = dataclasses.field(default_factory=dict)

    def lookup(self, op: str, shape: tuple[int, ...]) -> dict | None:
        """Winning knobs for (op, bucket of shape), or None."""
        entry = self.ops.get(op, {}).get(shape_bucket(shape))
        if not entry:
            return None
        return dict(entry.get("blocks") or {}) or None

    def set_entry(self, op: str, shape: tuple[int, ...], blocks: dict,
                  **extra) -> None:
        self.ops.setdefault(op, {})[shape_bucket(shape)] = {
            "blocks": dict(blocks), **extra}

    def to_json(self) -> dict:
        return {"schema": SCHEMA, "device_kind": self.device_kind,
                "ceilings": self.ceilings, "ops": self.ops,
                "meta": self.meta}

    def save(self, path: str | Path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(path.suffix + ".tmp")
        tmp.write_text(json.dumps(self.to_json(), indent=2) + "\n")
        tmp.replace(path)  # atomic: readers never see a partial table
        return path


def _sanitize_ops(ops: dict, source: str) -> dict:
    """Drop entries whose op is unknown or whose knobs break the kernel's
    rules: a hand-edited or stale table degrades entry by entry."""
    from repro_torch.kernels.block_utils import ALIGN, block_aligned
    clean: dict = {}
    for op, buckets in ops.items():
        if op not in ALIGN or not isinstance(buckets, dict):
            _log_once(f"op:{op}", f"tuning table {source}: unknown op "
                                  f"{op!r} ignored")
            continue
        for bucket, entry in buckets.items():
            blocks = entry.get("blocks") if isinstance(entry, dict) else None
            if not isinstance(blocks, dict) or not block_aligned(op, blocks):
                _log_once(
                    f"entry:{op}/{bucket}",
                    f"tuning table {source}: entry {op}/{bucket} has "
                    f"misaligned blocks {blocks!r}; entry dropped")
                continue
            clean.setdefault(op, {})[bucket] = entry
    return clean


def load_table(path: str | Path) -> TuningTable | None:
    """Parse a table file; corrupt, partial or unreadable -> None (one-time
    log line), never an exception."""
    path = Path(path)
    try:
        raw = json.loads(path.read_text())
        if not isinstance(raw, dict) or raw.get("schema") != SCHEMA \
                or not isinstance(raw.get("device_kind"), str):
            raise ValueError(f"not a schema-{SCHEMA} tuning table")
        return TuningTable(
            device_kind=raw["device_kind"],
            ceilings=dict(raw.get("ceilings") or {}),
            ops=_sanitize_ops(dict(raw.get("ops") or {}), path.name),
            meta=dict(raw.get("meta") or {}),
        )
    except (OSError, ValueError, TypeError, AttributeError) as e:
        _log_once(f"load:{path}", f"tuning table {path}: unreadable "
                                  f"({e}); falling back to default blocks")
        return None


# process-wide state: the active table (or None), whether the env var has
# been read, and the memo of lookups by (op, device, shape bucket)
_UNREAD = object()
_active: TuningTable | None = None
_source: object = _UNREAD
_memo: dict[tuple, dict | None] = {}


def set_active_table(table: TuningTable | str | Path | None) -> None:
    """Install (a path is loaded first) or, with None, clear the active
    table; the env var is then not consulted until :func:`reset`."""
    global _active, _source
    if isinstance(table, (str, Path)):
        table = load_table(table)
    _active, _source = table, "set_active_table"
    _memo.clear()


def reset() -> None:
    """Forget the active table, the memo and the one-time-log memory; the
    next lookup reads the env var again."""
    global _active, _source
    _active, _source = None, _UNREAD
    _memo.clear()
    _logged.clear()


def active_table(device=None) -> TuningTable | None:
    """The table the ops layer consults for ``device``, or None.

    The table installed by :func:`set_active_table`, else the file named by
    ``REPRO_TORCH_TUNING_TABLE`` (read once). A table recorded on another
    device kind than ``device``'s is rejected here (one-time log): knobs
    swept on one card, or on the CPU, must not steer another."""
    global _active, _source
    if _source is _UNREAD:
        env = os.environ.get(ENV_VAR) or None
        _active, _source = (load_table(env) if env else None), env
    table = _active
    if table is None:
        return None
    local = device_kind(device)
    if table.device_kind != local:
        _log_once(
            f"kind:{table.device_kind}->{local}",
            f"tuning table was measured on device kind "
            f"{table.device_kind!r} but this call runs on {local!r}; "
            f"ignoring it (default blocks apply)")
        return None
    return table


def lookup_blocks(op: str, shape: tuple[int, ...], device=None
                  ) -> dict | None:
    """Tuned knobs for (active table, op, shape bucket) on ``device``, or
    None; memoized until the table changes."""
    key = (op, device, *(_pow2_ceil(d) for d in shape))
    try:
        return _memo[key]
    except KeyError:
        pass
    table = active_table(device)
    found = None if table is None else table.lookup(op, shape)
    _memo[key] = found
    return found


def measured_ceilings(device=None) -> dict | None:
    """The active table's measured device ceilings (for the roofline
    profile), or None when no table of ``device``'s kind is active."""
    table = active_table(device)
    if table is None or not table.ceilings:
        return None
    return dict(table.ceilings)
