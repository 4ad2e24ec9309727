"""The device trace of a traced run, and what the harness reads from it.

``Tracer`` runs ``torch.profiler`` (CUDA activity only, so the host's
operators are not instrumented) over a sub-window of the measured window,
exports the trace as Chrome JSON into a temporary file and reduces it to a
:class:`Trace`: the device's operations (kernels, copies, fills) and the
host's CUDA synchronization calls, on the host's ``perf_counter`` clock.

The two clocks are tied by a ``cudaDeviceSynchronize`` issued at a known
host time just after the profiler starts and just before it stops; the
trace records those calls, so the offset between the clocks is read, not
assumed. Without them the operations keep the trace's own clock and host
spans are not matched to device gaps.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SYNC_NAMES = ("cudaDeviceSynchronize", "cudaStreamSynchronize",
              "cudaEventSynchronize")


@dataclasses.dataclass
class Trace:
    """A traced window: ``t0``, ``t1`` on the host's clock (s); ``ops``
    are (name, start s, duration s) of device operations; ``syncs`` are
    (name, start s, duration s) of the host's synchronization calls;
    ``aligned`` says whether both lie on the host's clock."""

    t0: float
    t1: float
    ops: list[tuple[str, float, float]]
    syncs: list[tuple[str, float, float]]
    aligned: bool
    counts: dict = dataclasses.field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_intervals(self) -> np.ndarray:
        """The union of the device's operations inside the window, as
        sorted, disjoint (start, end) rows."""
        if not self.ops:
            return np.zeros((0, 2))
        iv = np.array([(s, s + d) for _, s, d in self.ops], np.float64)
        iv[:, 0] = np.clip(iv[:, 0], self.t0, self.t1)
        iv[:, 1] = np.clip(iv[:, 1], self.t0, self.t1)
        iv = iv[iv[:, 1] > iv[:, 0]]
        if iv.shape[0] == 0:
            return np.zeros((0, 2))
        iv = iv[np.argsort(iv[:, 0], kind="stable")]
        out = [list(iv[0])]
        for s, e in iv[1:]:
            if s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return np.array(out)

    def busy_s(self) -> float:
        iv = self.busy_intervals()
        return float((iv[:, 1] - iv[:, 0]).sum()) if iv.size else 0.0

    def idle_gaps(self) -> np.ndarray:
        """(start, end) rows of the device's idle time inside the window."""
        iv = self.busy_intervals()
        edges = np.concatenate([[self.t0], iv.reshape(-1), [self.t1]])
        gaps = edges.reshape(-1, 2)
        return gaps[gaps[:, 1] > gaps[:, 0]]

    def device_s(self, match) -> float:
        """Device seconds, inside the window, of the operations whose name
        ``match`` accepts."""
        total = 0.0
        for name, s, d in self.ops:
            if match(name):
                total += max(0.0, min(s + d, self.t1) - max(s, self.t0))
        return total

    def top_ops(self, n: int = 10) -> list[list]:
        per: dict[str, float] = {}
        for name, s, d in self.ops:
            key = short_name(name)
            per[key] = per.get(key, 0.0) + d
        return [[k, v] for k, v in sorted(per.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def sync_s_inside(self, spans) -> float:
        """Seconds of host synchronization calls inside the (start, end)
        host spans (each counted once, clipped to its span)."""
        if not self.aligned or not self.syncs or not spans:
            return 0.0
        starts = np.array([s for s, _ in spans])
        ends = np.array([e for _, e in spans])
        order = np.argsort(starts)
        starts, ends = starts[order], ends[order]
        total = 0.0
        for _, s, d in self.syncs:
            i = int(np.searchsorted(starts, s, side="right")) - 1
            if i >= 0 and s < ends[i]:
                total += max(0.0, min(s + d, ends[i]) - s)
        return total


def short_name(name: str) -> str:
    """A kernel's name without its return type and arguments."""
    n = name
    if n.startswith("void "):
        n = n[5:]
    depth, out = 0, []
    for ch in n:
        if ch == "(" and depth == 0:
            break
        depth += ch == "<"
        depth -= ch == ">"
        out.append(ch)
    return "".join(out)[:120]


def read_chrome_trace(path: str, t0: float, t1: float,
                      marks: tuple[float, float]) -> Trace:
    """Reduces an exported trace. ``marks`` are the host times at which the
    two aligning ``cudaDeviceSynchronize`` calls were made."""
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    ops, syncs, marker_ts, counts = [], [], [], {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        counts[cat] = counts.get(cat, 0) + 1
        ts, dur = float(ev.get("ts", 0.0)) * 1e-6, float(ev.get("dur", 0.0)) * 1e-6
        name = ev.get("name", "")
        if cat in DEVICE_CATS:
            ops.append((name, ts, dur))
        elif cat in ("cuda_runtime", "cuda_driver"):
            if name in SYNC_NAMES:
                syncs.append((name, ts, dur))
            if name == "cudaDeviceSynchronize":
                marker_ts.append(ts)
    offset = _offset(sorted(marker_ts), marks)
    aligned = offset is not None
    if aligned:
        ops = [(n, s + offset, d) for n, s, d in ops]
        syncs = [(n, s + offset, d) for n, s, d in syncs]
        # the aligning calls themselves lie outside the window
        syncs = [x for x in syncs if t0 <= x[1] < t1]
    elif ops:
        lo = min(s for _, s, _ in ops)
        ops = [(n, s - lo + t0, d) for n, s, d in ops]
        syncs = []
    return Trace(t0=t0, t1=t1, ops=ops, syncs=syncs, aligned=aligned,
                 counts=counts)


def _offset(marker_ts: list[float], marks: tuple[float, float]
            ) -> float | None:
    """Host clock minus trace clock, from the pair of recorded
    ``cudaDeviceSynchronize`` calls whose spacing best matches the two
    aligning calls' (other synchronizations may lie between them)."""
    if len(marker_ts) < 2:
        return None
    want = marks[1] - marks[0]
    best = None
    for i, a in enumerate(marker_ts):
        for b in marker_ts[i + 1:]:
            err = abs((b - a) - want)
            if best is None or err < best[0]:
                best = (err, a)
    if best[0] > 1e-3:
        return None
    return marks[0] - best[1]


def kernel_parts(name: str) -> tuple[str, list[str]]:
    """(identifier, template arguments) of a kernel's name, e.g.
    ``('banded_scan_kernel', ['1', 'true'])``."""
    s = short_name(name)
    head, _, rest = s.partition("<")
    ident = head.split("::")[-1].strip()
    args = []
    if rest:
        depth, cur = 0, ""
        for ch in rest.rsplit(">", 1)[0]:
            if ch == "," and depth == 0:
                args.append(cur.strip())
                cur = ""
                continue
            depth += ch == "<"
            depth -= ch == ">"
            cur += ch
        args.append(cur.strip())
    return ident, args


class Tracer:
    """The profiler over a sub-window of the measured window.

    ``prepare`` (during set-up) starts the profiler in its warm-up step, so
    that the activity tracing is set up before the window; ``start`` steps
    it into recording, cheaply; ``stop`` steps it out, and the trace is
    exported then (the run goes on, past the traced part); ``finish``
    (after the window) reads the export into :attr:`trace`.
    """

    def __init__(self, torch, device):
        self.torch = torch
        self.device = device
        self.prof = None
        self.path: str | None = None
        self.trace: Trace | None = None
        self.marks: list[float] = []
        self.t0 = self.t1 = 0.0
        self.start_s = 0.0   # host seconds the step into recording took

    def prepare(self) -> None:
        from torch.profiler import ProfilerActivity, profile, schedule
        fd, self.path = tempfile.mkstemp(suffix=".json",
                                         prefix="perfbench-trace-")
        os.close(fd)
        self.prof = profile(
            activities=[ProfilerActivity.CUDA],
            schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
            on_trace_ready=lambda p: p.export_chrome_trace(self.path))
        self.prof.start()

    def _mark(self) -> float:
        t = time.perf_counter()
        self.torch.cuda.synchronize(self.device)
        return t

    def start(self) -> None:
        a = time.perf_counter()
        self.prof.step()
        self.start_s = time.perf_counter() - a
        self.marks = [self._mark()]
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        self.t1 = time.perf_counter()
        self.marks.append(self._mark())
        self.prof.step()

    def finish(self) -> None:
        try:
            self.prof.stop()
            if len(self.marks) == 2:
                self.trace = read_chrome_trace(self.path, self.t0, self.t1,
                                               tuple(self.marks))
        finally:
            os.unlink(self.path)
            self.prof = None


def attribute_gaps(trace: Trace, spans: list[tuple[float, float, str]],
                   n: int = 10) -> list[list]:
    """The device's idle time inside the window, summed by what the host
    was doing (the label of the harness span that covers most of each
    gap; ``outside calls`` where none does), largest first."""
    gaps = trace.idle_gaps()
    if gaps.size == 0:
        return []
    per: dict[str, float] = {}
    if not trace.aligned or not spans:
        per["host not aligned"] = float((gaps[:, 1] - gaps[:, 0]).sum())
    else:
        sp = sorted(spans)
        starts = np.array([s for s, _, _ in sp])
        for g0, g1 in gaps:
            i = max(0, int(np.searchsorted(starts, g0, side="right")) - 1)
            best, label = 0.0, "outside calls"
            while i < len(sp) and sp[i][0] < g1:
                ov = min(g1, sp[i][1]) - max(g0, sp[i][0])
                if ov > best:
                    best, label = ov, sp[i][2]
                i += 1
            per[label] = per.get(label, 0.0) + float(g1 - g0)
    return [[k, v] for k, v in sorted(per.items(), key=lambda kv: -kv[1])[:n]]
