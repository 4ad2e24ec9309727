"""Launch-shape knobs of the port's CUDA kernels: validation and
resolution.

Counterpart of ``repro.kernels.block_utils``, with Hopper rules for the
knobs the CUDA kernels really have in place of TPU tile alignment. Every
kernel ops layer resolves its knobs through :func:`resolve_blocks`:

  1. an **explicit** caller argument wins, validated here, so a bad value
     raises a ``ValueError`` naming the CUDA constraint before launch;
  2. else the **active tuning table** (``repro_torch.tune.table``, written
     by ``repro_torch.launch.tune`` and selected by the
     ``REPRO_TORCH_TUNING_TABLE`` env var) for this (device kind, op,
     shape bucket);
  3. else :data:`DEFAULTS`, the fixed rules: the query block picked by
     the batch (``block_q=0``, see ``topk_hamming.ops.pick_block_q``), 4
     blocks per SM for the exact scans' split count and 2 for the banded
     scan's.

The knobs:

* ``block_q`` of ``topk_hamming`` / ``encode_search``: queries per block,
  one of the kernels' compiled instantiations, or 0 for the smallest
  that covers the batch and fits shared memory. For packed banks 16 and
  32 are the N of the tensor-core scan's ``wgmma`` and 8 keeps the POPC
  scan (``csrc/hd_exact_scan.cuh``); for int8 banks 8, 16 and 32 are 1, 2
  or 4 queries per warp. The banded twins hold up to 32 queries a block
  (``topk_hamming.ops.plan_banded``) and have no query knob.
* ``waves``: target blocks per SM when the bank (or a query group's
  window) is split across blocks; it sets the split count, never the
  result. The banded scan fits two blocks an SM, so its rule is 2: one
  resident wave.
* ``block_b`` / ``block_d`` of ``hd_encode``: queries per block and dims
  per block, the latter in whole 32-dim packed codebook words; 2,048 dims
  (64 words: four feature slices of 64 threads) was the fastest at every
  served bucket on the H100.
* ``block_q`` / ``block_r`` of ``imc_mvm``: the output tile; a warp
  covers 8, 16 or 32 queries (2, 4 or 8 a lane; two warps at 64) by 32
  rows, so block_r sets 1, 2, 4 or 8 warps along the rows.

``imc_mvm``'s ``tile_cols`` is not a knob: it is the PCM array's column
count, and another value computes another function.
"""

from __future__ import annotations

AUTO = 0          # block_q: picked by the batch (topk_hamming.ops.pick_block_q)

# per-op rules: knob -> required positive multiple (int) or the allowed
# values (tuple)
ALIGN: dict[str, dict[str, int | tuple[int, ...]]] = {
    "topk_hamming": {"block_q": (AUTO, 8, 16, 32), "waves": 1},
    "topk_hamming_banded": {"waves": 1},
    "encode_search": {"block_q": (AUTO, 8, 16, 32), "waves": 1},
    "encode_search_banded": {"waves": 1},
    "hd_encode": {"block_b": 1, "block_d": 32},
    "imc_mvm": {"block_q": (8, 16, 32, 64), "block_r": (32, 64, 128, 256)},
}

# what a multiple-of rule stands for, for the error message
_WHY = {"waves": "target blocks per SM", "block_b": "queries per block",
        "block_d": "whole 32-dim packed codebook words"}

# the fixed rules of the wrappers before the tuner: the fallback when no
# table entry exists, and the baseline every sweep candidate must beat
DEFAULTS: dict[str, dict[str, int]] = {
    "topk_hamming": {"block_q": AUTO, "waves": 4},
    "topk_hamming_banded": {"waves": 2},
    "encode_search": {"block_q": AUTO, "waves": 4},
    "encode_search_banded": {"waves": 2},
    "hd_encode": {"block_b": 1, "block_d": 2048},
    "imc_mvm": {"block_q": 32, "block_r": 128},
}


def validate_block(op: str, name: str, value) -> int:
    """Return ``value`` if it satisfies ``op``'s rule for ``name``, else
    raise a ``ValueError`` naming the constraint."""
    rules = ALIGN[op]
    if name not in rules:
        raise ValueError(f"{op}: unknown knob {name!r} (knobs: "
                         f"{', '.join(rules)})")
    rule = rules[name]
    ok = isinstance(value, int) and not isinstance(value, bool)
    if isinstance(rule, tuple):
        if not (ok and value in rule):
            auto = "; 0 picks by batch" if AUTO in rule else ""
            raise ValueError(f"{op}: {name}={value!r} must be one of {rule} "
                             f"(the kernel's compiled instantiations{auto})")
    elif not (ok and value >= rule and value % rule == 0):
        raise ValueError(f"{op}: {name}={value!r} must be a positive "
                         f"multiple of {rule} ({_WHY[name]})")
    return value


def block_aligned(op: str, cfg: dict) -> bool:
    """True when every entry of ``cfg`` is a valid knob value for ``op``:
    the tuning-table sanitizer (invalid persisted entries are dropped,
    never raised, so a stale table degrades to defaults)."""
    try:
        for name, value in cfg.items():
            validate_block(op, name, value)
    except (ValueError, KeyError):
        return False
    return True


def check_overrides(op: str, overrides: dict) -> None:
    """Validates the explicit (non-None) knobs of one call."""
    for name, value in overrides.items():
        if value is not None:
            validate_block(op, name, value)


def resolve_blocks(op: str, shape: tuple[int, ...], overrides: dict,
                   device=None) -> dict[str, int]:
    """Final knobs for one kernel call.

    shape: the op's bucketing shape (e.g. ``(Q, R, W)``), used only to
      pick the tuning-table bucket.
    overrides: caller kwargs, ``None`` meaning "not specified"; explicit
      values are validated here.
    device: the device the call runs on; a table measured on another
      device kind is not applied.
    """
    from repro_torch.tune.table import lookup_blocks
    cfg = dict(DEFAULTS[op])
    tuned = lookup_blocks(op, shape, device)
    if tuned:
        cfg.update((n, v) for n, v in tuned.items() if n in cfg)
    for name, value in overrides.items():
        if value is not None:
            cfg[name] = validate_block(op, name, value)
    return cfg
