"""Assigned input-shape set (LM-family: seq_len x global_batch)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def applicable(arch_family: str, shape_name: str, supports_long: bool) -> bool:
    """long_500k only for sub-quadratic archs (DESIGN.md §4)."""
    if shape_name == "long_500k":
        return supports_long
    return True
