"""The single-device part of ``repro.dist``: checkpointing and straggler
detection. Sharding, gradient compression and collective matmuls are not
ported yet (ROADMAP.md, Queue 1 item 5.6)."""

from repro_torch.dist import checkpoint, straggler

__all__ = ["checkpoint", "straggler"]
