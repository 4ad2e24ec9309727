"""What the metric readers under ``perfbench/metrics`` share.

A reader is a module with ``read(run) -> float | None``; ``run`` is the
driver's record of the run (``perfbench/drivers/<driver>.py``'s ``Run``).
A reader that finds nothing to read returns None, and the metric is left
out of the result line.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from perfbench.harness import work
from perfbench.harness.trace import kernel_parts


def reader_file(metrics: Path, name: str) -> Path:
    """The reader of metric ``name`` in the folder ``metrics``:
    ``<name>.py``, or where there is none, that of the name without its
    last dotted part (``host_ms_per_batch.live`` is read as
    ``host_ms_per_batch``: one quantity, split by the end-to-end metric
    its cells report)."""
    stem = name
    while not (metrics / f"{stem}.py").is_file() and "." in stem:
        stem = stem.rsplit(".", 1)[0]
    return metrics / f"{stem}.py"


def kernels_named(*idents: str, mode: str | None = None):
    """A match on a kernel's identifier (and, with ``mode``, on its first
    template argument, e.g. ``1`` for the int8 lanes of the scans)."""
    want = set(idents)

    def match(name: str) -> bool:
        ident, args = kernel_parts(name)
        if ident not in want:
            return False
        return mode is None or (bool(args) and args[0].endswith(mode))

    return match


def roofline(run, route: str, match, work_of) -> float | None:
    """The share of the roofline of the kernels ``match`` accepts, over the
    traced window's batches, when every one of them took ``route``."""
    tr, bs = run.trace, run.traced_batches
    if tr is None or not bs or any(b.route != route for b in bs):
        return None
    total = work.ZERO
    for b in bs:
        total = total + work_of(b, run.sizes)
    return work.roofline_pct(total, tr.device_s(match),
                             work.peaks(run.device_name))


def host_ms_per_batch(run) -> float | None:
    """The host's milliseconds inside the harness's submit and step calls
    that submitted, dispatched or retired something (a step that only
    polled the batches in flight is waiting, not working), less the CUDA
    synchronizations the trace records inside them, per batch dispatched
    in the traced window."""
    if run.trace is None or not run.traced_batches:
        return None
    spans = [(s, e) for s, e, label in run.host_spans
             if label != "step: poll"]
    busy = sum(e - s for s, e in spans) - run.trace.sync_s_inside(spans)
    return 1e3 * busy / len(run.traced_batches)


def idle_pct(run) -> float | None:
    tr = run.trace
    if tr is None or tr.window_s <= 0 or not tr.ops:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)


def queue_wait_p95_ms(run) -> float | None:
    waits = [w for b in run.traced_batches if b.waits is not None
             for w in b.waits]
    return float(np.percentile(waits, 95)) * 1e3 if waits else None


def batch_fill(run) -> float | None:
    bs = run.traced_batches
    if not bs:
        return None
    return float(np.mean([b.n for b in bs])) / run.sizes["max_batch"]
