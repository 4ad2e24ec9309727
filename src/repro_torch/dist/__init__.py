"""The distribution substrate (``repro.dist``): checkpointing, gradient
compression and the compressed cross-pod all-reduces on
``torch.distributed``, the pure half of the logical-axis sharding rules,
and straggler detection (the EWMA monitor and host heartbeats).

  * ``checkpoint`` — atomic step directories, keep-N GC, async save;
  * ``compression`` — stochastic-rounding int8 and error-feedback top-k,
    ``dcn_allreduce_tree`` / ``cross_pod_allreduce`` over a mesh axis's
    process group, and the wire accounting behind ``dcn_bytes``;
  * ``sharding`` — ``ShardingRules``, ``logical_to_spec``, the global
    mesh and the ``pod`` axis size;
  * ``straggler`` — ``StragglerMonitor`` and ``HeartbeatRegistry``.

Placing tensors on a mesh (DTensor shardings, ``constrain``) and the
collective matmuls are not ported yet (ROADMAP.md, Queue 1 item 5.6b)."""

from repro_torch.dist import checkpoint, compression, sharding, straggler

__all__ = ["checkpoint", "compression", "sharding", "straggler"]
