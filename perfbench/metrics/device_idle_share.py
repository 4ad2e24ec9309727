"""``device_idle_share``: 100 x (1 - the union of the device's operations
in the profiler's trace over the traced window's length)."""

from perfbench.harness import readers


def read(run):
    return readers.idle_pct(run)
