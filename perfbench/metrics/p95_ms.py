"""``p95_ms``: the 95th percentile, over every request due in the window,
of the time from when it was due to when the harness got its answer back
from ``step()``. A request never answered counts as having waited the
window and the harness's whole wait after it."""

import numpy as np


def read(run):
    lat = run.latencies_s
    if lat is None or lat.size == 0:
        return None
    cap = run.seconds + run.drain_wait_s
    return float(np.percentile(np.minimum(lat, cap), 95)) * 1e3
