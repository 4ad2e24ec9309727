"""What the program's own spans say about a traced run.

The port's serving path records spans when a span recorder
(``repro_torch.serve.trace.SpanRecorder``) is attached to its server:
each batch's ``dispatch`` (with ``dispatch.assemble``, ``.plan``,
``.encode``, ``.search``, ``.copy_out``) and ``finalize``
(``finalize.wait``, ``.cache``, ``.fdr``, ``.results``), ``compact``. A
span is an object with ``name``, ``start``, ``end`` (None while open),
``id``, ``parent``, ``bid`` and ``counts``, on the host's
``time.perf_counter`` clock: the clock the :class:`~perfbench.harness.
trace.Trace` aligns the device's operations to, so the two are compared
with no offset.

Each function takes the run's trace and span list and returns None where
there is nothing to read: no trace, no spans, no batch dispatched in the
traced window, or, for the idle split, a trace not aligned with the
host's clock. Everything is read over the traced window ``[trace.t0,
trace.t1]``: spans are clipped to it, and a batch is in it when its
``dispatch`` span starts in it.
"""

from __future__ import annotations

import numpy as np


def _named(spans, name: str) -> list:
    return [s for s in spans if s.name == name and s.end is not None]


def _clipped_s(trace, spans) -> float:
    return sum(max(0.0, min(s.end, trace.t1) - max(s.start, trace.t0))
               for s in spans)


def batches(trace, spans) -> list | None:
    """The ``dispatch`` spans that start inside the traced window."""
    if trace is None or not spans:
        return None
    return [s for s in _named(spans, "dispatch")
            if trace.t0 <= s.start < trace.t1]


def ms_per_batch(trace, spans, name: str, less: str | None = None
                 ) -> float | None:
    """Milliseconds inside spans ``name`` (less those inside spans
    ``less``) in the window, per batch dispatched in it; None where no
    span ``name`` lies in the window."""
    bs = batches(trace, spans)
    if not bs:
        return None
    inside = [s for s in _named(spans, name)
              if s.start < trace.t1 and s.end > trace.t0]
    if not inside:
        return None
    t = _clipped_s(trace, inside)
    if less is not None:
        t -= _clipped_s(trace, _named(spans, less))
    return 1e3 * t / len(bs)


def _union(trace, spans) -> np.ndarray:
    """The union of the spans, clipped to the window, as sorted disjoint
    (start, end) rows."""
    iv = sorted((max(s.start, trace.t0), min(s.end, trace.t1))
                for s in spans)
    out: list[list[float]] = []
    for a, b in iv:
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return np.array(out).reshape(-1, 2)


def idle_in_pct(trace, spans, name: str) -> float | None:
    """100 x the time in which the device is idle and the host is inside a
    span ``name``, over the window's length."""
    if (trace is None or not spans or not trace.aligned or not trace.ops
            or trace.window_s <= 0):
        return None
    gaps, iv = trace.idle_gaps(), _union(trace, _named(spans, name))
    total, j = 0.0, 0
    for g0, g1 in gaps:
        while j < len(iv) and iv[j][1] <= g0:
            j += 1
        k = j
        while k < len(iv) and iv[k][0] < g1:
            total += min(g1, iv[k][1]) - max(g0, iv[k][0])
            k += 1
    return 100.0 * total / trace.window_s


def cache_hit_rate(trace, spans) -> float | None:
    """The window's batches' query-HV cache hits over hits and misses;
    None where none of them looked the cache up."""
    bs = batches(trace, spans)
    if not bs:
        return None
    hits = sum(s.counts.get("cache_hits", 0) for s in bs)
    looked = hits + sum(s.counts.get("cache_misses", 0) for s in bs)
    return hits / looked if looked else None


def device_ms(trace, spans) -> float | None:
    """The device's milliseconds a batch between each batch's timing
    events (``finalize``'s ``device_ms``), over the batches finalized in
    the window; None off the card."""
    fs = [s for s in _named(spans or [], "finalize")
          if trace is not None and trace.t0 <= s.start < trace.t1
          and "device_ms" in s.counts]
    return sum(s.counts["device_ms"] for s in fs) / len(fs) if fs else None


def routes(trace, spans) -> dict | None:
    """How many of the window's batches took each route."""
    bs = batches(trace, spans)
    if not bs:
        return None
    out: dict[str, int] = {}
    for s in bs:
        r = s.counts.get("route", "")
        out[r] = out.get(r, 0) + 1
    return out


def breakdown(trace, spans) -> dict | None:
    """For each span name in the window: milliseconds a batch, in all
    (``ms``) and less its children (``self_ms``)."""
    bs = batches(trace, spans)
    if not bs:
        return None
    done = [s for s in spans if s.end is not None
            and s.start < trace.t1 and s.end > trace.t0]
    inner: dict[int, float] = {}
    for s in done:
        if s.parent is not None:
            inner[s.parent] = inner.get(s.parent, 0.0) + _clipped_s(
                trace, [s])
    out: dict[str, dict] = {}
    for s in done:
        d = out.setdefault(s.name, {"ms": 0.0, "self_ms": 0.0})
        t = _clipped_s(trace, [s])
        d["ms"] += 1e3 * t / len(bs)
        d["self_ms"] += 1e3 * (t - inner.get(s.id, 0.0)) / len(bs)
    return out


def host_span_ms(trace, spans, host_spans, label: str) -> float | None:
    """Milliseconds inside the harness's own host spans ``label`` (start,
    end, label) in the window, per batch dispatched in it: the calls the
    program records nothing of (``submit``)."""
    bs = batches(trace, spans)
    if not bs:
        return None
    t = sum(max(0.0, min(e, trace.t1) - max(s, trace.t0))
            for s, e, lab in host_spans if lab == label)
    return 1e3 * t / len(bs)


def report(trace, spans, host_spans=()) -> dict:
    """Every quantity above for one run (None where there is nothing to
    read); ``submit_ms`` from the harness's ``submit`` host spans."""
    return {
        "batches": None if batches(trace, spans) is None
        else len(batches(trace, spans)),
        "dispatch_ms": ms_per_batch(trace, spans, "dispatch"),
        "finalize_ms": ms_per_batch(trace, spans, "finalize",
                                    less="finalize.wait"),
        "submit_ms": host_span_ms(trace, spans, host_spans, "submit"),
        "oms_plan_ms": ms_per_batch(trace, spans, "dispatch.plan"),
        "idle_in_dispatch_pct": idle_in_pct(trace, spans, "dispatch"),
        "idle_in_finalize_pct": idle_in_pct(trace, spans, "finalize"),
        "query_cache_hit_rate": cache_hit_rate(trace, spans),
        "device_ms": device_ms(trace, spans),
        "routes": routes(trace, spans),
        "by_span": breakdown(trace, spans),
    }
