"""The distribution substrate (``repro.dist``): checkpointing, gradient
compression and the compressed cross-pod all-reduces on
``torch.distributed``, the logical-axis sharding rules and their DTensor
placements, the collective matmuls, and straggler detection (the EWMA
monitor and host heartbeats).

  * ``checkpoint`` — atomic step directories, keep-N GC, async save;
  * ``collective_matmul`` — ``ring_matmul_reduce`` and
    ``ag_matmul_pipelined``, rings of point-to-point steps over a mesh
    axis's process group with the next partial product issued while a
    step is in flight;
  * ``compression`` — stochastic-rounding int8 and error-feedback top-k,
    ``dcn_allreduce_tree`` / ``cross_pod_allreduce`` over a mesh axis's
    process group, and the wire accounting behind ``dcn_bytes``;
  * ``sharding`` — ``ShardingRules``, ``logical_to_spec``, the global
    mesh and the ``pod`` axis size; ``logical_to_sharding``,
    ``tree_shardings``, ``distribute_tree``, ``constrain`` and
    ``local_map_axes`` on DTensor placements; the gloo route of
    DTensor's collectives; ``baseline_mode``;
  * ``straggler`` — ``StragglerMonitor`` and ``HeartbeatRegistry``.

Every LM family runs on DTensors over a ``DeviceMesh`` (the dense, MoE
(expert-parallel), VLM and encoder-decoder ones at the reference's
``constrain`` sites; the recurrent and hybrid ones in local regions on
each rank's blocks), and the DCN routes over a model sharded within each
pod."""

from repro_torch.dist import (
    checkpoint,
    collective_matmul,
    compression,
    sharding,
    straggler,
)

__all__ = ["checkpoint", "collective_matmul", "compression", "sharding",
           "straggler"]
