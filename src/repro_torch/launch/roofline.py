"""Roofline terms of one traced step, priced on the card the port runs on.

Counterpart of ``repro.launch.roofline``. Three terms per (arch, shape,
mesh), in seconds, per step, per rank:

  compute    = FLOPs / peak_flops
  memory     = HBM bytes / hbm_bw
  collective = collective bytes / link_bw

The reference reads its counts off the partitioned HLO of an AOT-compiled
step. The port has no HLO: it runs the step once (on ``meta`` tensors in
the dry run, so nothing is allocated) under a ``TorchDispatchMode`` that
sees every aten op *below* DTensor, on this rank's local tensors:

* **FLOPs**: ``torch.utils.flop_counter.FlopCounterMode``'s formulas
  (its ``flop_registry``: matmuls, convolutions, attention) applied to
  each local op. Counted above DTensor, ``FlopCounterMode`` would count
  every product at its global size; below it, a product of sharded
  operands counts this rank's share, and replicated work counts in full
  on every rank, as each rank does it. DTensor's own shape propagation
  (ops on fake tensors) is left out.
* **HBM bytes**: each local op's tensor inputs and outputs, each tensor
  once an op (views, allocations and the functional collectives'
  bookkeeping move nothing and are left out). Eager ops are unfused, so
  this is an upper bound on the traffic of a fused program.
* **Collective bytes**: the operand bytes of every collective issued on
  this rank (the functional collectives DTensor issues, and the
  ``c10d`` ones of explicit ``torch.distributed`` calls), keyed by the
  reference's kinds (``all-gather``, ``all-reduce``, ``reduce-scatter``,
  ``all-to-all``, ``collective-permute`` for point-to-point sends).
  Broadcasts and barriers are not counted.

These counts are not the HLO's and are not claimed equal to them: an
eager step runs what PyTorch dispatches (no fusion, no rematerialization
the compiler would choose, DTensor's redistributions where GSPMD might
pick others), and a Python loop over layers is counted as executed, where
the reference multiplies a scan body by its trip count.

Ceilings come from :func:`active_profile`: the H100 SXM's published dense
figures (NVIDIA's data sheet: 989 TFLOP/s bf16 on the tensor cores, 67
TFLOP/s float32 outside them, 3.35 TB/s HBM3 and 450 GB/s of NVLink each
way), or, when a tuning table measured on the local device kind is active
(``REPRO_TORCH_TUNING_TABLE`` or ``repro_torch.tune.set_active_table``),
its measured float32 and memory ceilings (``repro_torch.tune.microbench``
times float32 matmuls with TF32 off); the microbench measures no bf16
rate and, on one card, no NVLink, so those stay the published ones.
Every time priced here is a bound, not a measurement.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.tune.table import measured_ceilings

PEAK_FLOPS = 989e12    # bf16 dense, tensor cores
PEAK_FLOPS_FP32 = 67e12  # float32, outside the tensor cores
HBM_BW = 3.35e12       # bytes/s, HBM3
LINK_BW = 450e9        # bytes/s, NVLink, each way

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# op (namespace.name) -> (kind, index of the argument holding its operand)
_COLLECTIVE_OPS = {
    "_c10d_functional.all_gather_into_tensor": ("all-gather", 0),
    "_c10d_functional.all_gather_into_tensor_coalesced": ("all-gather", 0),
    "_c10d_functional.all_reduce": ("all-reduce", 0),
    "_c10d_functional.all_reduce_coalesced": ("all-reduce", 0),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", 0),
    "_c10d_functional.reduce_scatter_tensor_coalesced":
        ("reduce-scatter", 0),
    "_c10d_functional.all_to_all_single": ("all-to-all", 0),
    "c10d.allgather_": ("all-gather", 1),
    "c10d._allgather_base_": ("all-gather", 1),
    "c10d.allgather_into_tensor_coalesced_": ("all-gather", 1),
    "c10d.allreduce_": ("all-reduce", 0),
    "c10d.reduce_scatter_": ("reduce-scatter", 1),
    "c10d._reduce_scatter_base_": ("reduce-scatter", 1),
    "c10d.reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "c10d.alltoall_": ("all-to-all", 1),
    "c10d.alltoall_base_": ("all-to-all", 1),
    "c10d.send": ("collective-permute", 0),
}
# ops that move no data
_NO_TRAFFIC = {"aten.empty", "aten.empty_like", "aten.empty_strided",
               "aten.new_empty", "aten.new_empty_strided",
               "_c10d_functional.wait_tensor",
               "_c10d_functional._wrap_tensor_autograd",
               "c10d.broadcast_", "c10d.barrier", "c10d.recv_"}


def _nbytes(tensors) -> int:
    """Bytes of each distinct tensor once."""
    seen = {id(t): t for t in tensors if isinstance(t, torch.Tensor)}
    return sum(t.numel() * t.element_size() for t in seen.values())


@dataclasses.dataclass
class TraceCost:
    """What one traced call cost on this rank (see the module docstring)."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll: dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVES})


class _CostMode(TorchDispatchMode):
    """Counts the local ops below DTensor into a :class:`TraceCost`."""

    def __init__(self, cost: TraceCost):
        super().__init__()
        self.cost = cost

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import is_fake
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        flat = tree_leaves((args, kwargs))
        if any(isinstance(a, DTensor) for a in flat):
            # DTensor dispatches its local ops, which come back here
            return NotImplemented
        out = func(*args, **kwargs)
        if any(isinstance(a, torch.Tensor) and is_fake(a) for a in flat):
            return out  # DTensor's shape propagation, not work
        cost, name = self.cost, f"{func.namespace}.{func._opname}"
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            cost.flops += formula(*args, **kwargs, out_val=out)
        coll = _COLLECTIVE_OPS.get(name)
        if coll is not None:
            cost.coll[coll[0]] += _nbytes(tree_leaves(args[coll[1]]))
        if not func.is_view and name not in _NO_TRAFFIC:
            cost.hbm_bytes += _nbytes(flat + tree_leaves(out))
        return out


def trace_cost(fn: Callable, *args, **kwargs) -> tuple[TraceCost, Any]:
    """Runs ``fn(*args, **kwargs)`` once under the counting mode; returns
    (this rank's :class:`TraceCost`, ``fn``'s result)."""
    cost = TraceCost()
    with _CostMode(cost):
        out = fn(*args, **kwargs)
    return cost, out


def exec_cost(fn: Callable, *args, **kwargs) -> tuple[float, float]:
    """(FLOPs, HBM bytes) of one call of ``fn`` on this rank: FLOPs by
    ``FlopCounterMode``'s formulas on each local op (below DTensor: a
    rank's share of a sharded product), bytes as each local op's inputs
    and outputs, an unfused upper bound (module docstring)."""
    cost, _ = trace_cost(fn, *args, **kwargs)
    return cost.flops, cost.hbm_bytes


def collective_bytes(fn: Callable, *args, **kwargs) -> dict[str, float]:
    """Operand bytes of the collectives one call of ``fn`` issues on this
    rank, by the reference's kinds (module docstring)."""
    cost, _ = trace_cost(fn, *args, **kwargs)
    return cost.coll


@dataclasses.dataclass(frozen=True)
class HardwareProfile:
    """Per-card roofline ceilings: measured, or the H100 SXM defaults."""

    peak_flops: float = PEAK_FLOPS
    peak_flops_fp32: float = PEAK_FLOPS_FP32
    hbm_bw: float = HBM_BW
    link_bw: float = LINK_BW
    source: str = "default:h100-sxm"


def active_profile(device=None) -> HardwareProfile:
    """The profile roofline terms are priced against on ``device``: the
    active table's measured float32 and memory ceilings when it was
    measured on this device kind, else the published H100 SXM figures."""
    ceil = measured_ceilings(device)
    if ceil and ceil.get("peak_flops_fp32") and ceil.get("hbm_bw"):
        return HardwareProfile(peak_flops_fp32=float(ceil["peak_flops_fp32"]),
                               hbm_bw=float(ceil["hbm_bw"]),
                               source="measured")
    return HardwareProfile()


@dataclasses.dataclass
class RooflineReport:
    flops: float              # per-rank FLOPs per step
    hbm_bytes: float          # per-rank HBM traffic per step (upper bound)
    coll_bytes: float         # per-rank collective bytes per step
    coll_breakdown: dict[str, float]
    chips: int
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops: float = 0.0  # 6*N*D useful flops (whole job)
    peak_flops: float = PEAK_FLOPS   # ceiling the terms were priced with
    profile_source: str = "default:h100-sxm"

    @property
    def step_time_lower_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def mfu_bound(self) -> float:
        """Model-FLOPs utilization at the roofline-limited step time."""
        if self.model_flops <= 0 or self.step_time_lower_bound <= 0:
            return 0.0
        return (self.model_flops / self.chips / self.step_time_lower_bound
                / self.peak_flops)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self) | {
            "step_time_lower_bound": self.step_time_lower_bound,
            "mfu_bound": self.mfu_bound,
        }


def roofline_report(cost: TraceCost, chips: int, model_flops: float = 0.0,
                    profile: HardwareProfile | None = None
                    ) -> RooflineReport:
    """A :class:`TraceCost` priced on ``profile`` (default: the active
    one); the link term at ``link_bw``."""
    if profile is None:
        profile = active_profile()
    cbytes = float(sum(cost.coll.values()))
    terms = {"compute": cost.flops / profile.peak_flops,
             "memory": cost.hbm_bytes / profile.hbm_bw,
             "collective": cbytes / profile.link_bw}
    return RooflineReport(
        flops=float(cost.flops), hbm_bytes=float(cost.hbm_bytes),
        coll_bytes=cbytes, coll_breakdown=dict(cost.coll), chips=chips,
        t_compute=terms["compute"], t_memory=terms["memory"],
        t_collective=terms["collective"],
        bottleneck=max(terms, key=terms.get), model_flops=model_flops,
        peak_flops=profile.peak_flops, profile_source=profile.source)


def roofline_from_trace(fn: Callable, *args, chips: int,
                        model_flops: float = 0.0,
                        profile: HardwareProfile | None = None
                        ) -> tuple[RooflineReport, Any]:
    """The counterpart of the reference's ``roofline_from_compiled``: one
    call of ``fn(*args)`` traced on this rank and priced. Its counts are
    the eager, unfused local ops' (module docstring), not the compiled
    HLO's, and no equality with the reference's is claimed. Returns (the
    report, ``fn``'s result)."""
    cost, out = trace_cost(fn, *args)
    return roofline_report(cost, chips, model_flops, profile), out


def model_flops_estimate(cfg, shape) -> float:
    """MODEL_FLOPS = 6 * N_active * D_tokens (dense) per step; decode counts
    one token per sequence (the reference's arithmetic, term for term)."""
    # active params per token
    d, hd = cfg.d_model, cfg.resolved_head_dim
    attn = d * (cfg.num_heads + 2 * cfg.num_kv_heads) * hd \
        + cfg.num_heads * hd * d
    if cfg.is_moe:
        ffn_active = 3 * d * cfg.expert_d_ff * (cfg.top_k
                                                + cfg.num_shared_experts)
    elif cfg.family == "ssm":
        d_inner = 2 * d
        attn = 0
        ffn_active = d * 2 * d_inner + 3 * d_inner * (
            d_inner // max(cfg.num_heads, 1)) + d_inner * d
    else:
        nmat = 3 if cfg.activation in ("swiglu", "geglu") else 2
        ffn_active = nmat * d * cfg.d_ff
    if cfg.family == "hybrid":
        ffn_active += d * 2 * d + 2 * d * cfg.ssm_state + d * d
    n_active = cfg.num_layers * (attn + ffn_active)
    n_active += cfg.padded_vocab * d  # embedding/unembed (once)
    if cfg.is_encoder_decoder:
        n_active += cfg.num_encoder_layers * (attn + ffn_active)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch
