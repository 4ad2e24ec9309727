"""Empirical autotuner for the port's CUDA kernels (ERT-style).

Counterpart of ``repro.tune``: measures the card's ceilings
(:mod:`repro_torch.tune.microbench`), sweeps each kernel's launch knobs
against them (:mod:`repro_torch.tune.sweep`), and persists the winners in
a JSON table (:mod:`repro_torch.tune.table`) that the kernel ops layers
consult, falling back to the fixed rules whenever no table (or no
matching device kind or shape bucket) is there.
``repro_torch.launch.tune`` is the CLI.
"""

from repro_torch.tune.microbench import (
    measure_ceilings,
    measure_mem_bandwidth,
    measure_peak_flops,
)
from repro_torch.tune.sweep import (
    build_tuning_table,
    sweep_op,
    tuned_vs_default_ratio,
)
from repro_torch.tune.table import (
    ENV_VAR,
    TuningTable,
    active_table,
    device_kind,
    load_table,
    lookup_blocks,
    measured_ceilings,
    reset,
    set_active_table,
    shape_bucket,
)

__all__ = [
    "ENV_VAR",
    "TuningTable",
    "active_table",
    "build_tuning_table",
    "device_kind",
    "load_table",
    "lookup_blocks",
    "measure_ceilings",
    "measure_mem_bandwidth",
    "measure_peak_flops",
    "measured_ceilings",
    "reset",
    "set_active_table",
    "shape_bucket",
    "sweep_op",
    "tuned_vs_default_ratio",
]
