"""The readers of the program's spans (``harness/spans.py``) on a hand-made
trace and span list, and ``tools/spans.py`` attaching the program's
recorder over a traced sub-window on the CPU."""

from __future__ import annotations

import json
import sys
from typing import NamedTuple

import pytest

from conftest import ROOT
from perfbench.harness import spans as sp
from perfbench.harness.trace import Trace


class Span(NamedTuple):
    """A span as the readers take it (the program's records have these
    fields; the readers import nothing of the program)."""

    name: str
    start: float
    end: float | None
    id: int
    parent: int | None
    bid: int | None
    counts: dict


def span(name, start, end, id_, parent=None, bid=None, **counts):
    return Span(name, start, end, id_, parent, bid, counts)


def window(ops, aligned=True):
    """The window 10.0-11.0 s with device operations ``ops`` ((start,
    duration) pairs)."""
    return Trace(t0=10.0, t1=11.0, ops=[("k", s, d) for s, d in ops],
                 syncs=[], aligned=aligned)


def two_batches():
    """Two batches: the first dispatched before the window opens (it
    counts only as far as it lies inside), the second inside it, its
    finalize running past the window's end."""
    return [
        span("compact", 9.80, 9.85, 0),
        span("dispatch", 9.90, 10.10, 1, bid=1, n=32, cache_hits=0,
             cache_misses=32),
        span("dispatch.plan", 9.95, 10.05, 2, parent=1, bid=1,
             scanned_fraction=0.4),
        span("compact", 10.20, 10.30, 3),
        span("dispatch", 10.40, 10.60, 4, bid=4, n=32, cache_hits=8,
             cache_misses=24),
        span("dispatch.plan", 10.42, 10.50, 5, parent=4, bid=4,
             scanned_fraction=0.5),
        span("finalize", 10.70, 11.10, 6, bid=1, device_ms=1.5),
        span("finalize.wait", 10.70, 10.80, 7, parent=6, bid=1),
        span("finalize.fdr", 10.80, 10.90, 8, parent=6, bid=1),
        span("dispatch", 10.95, None, 9, bid=9, n=5),   # left open
    ]


def test_times_a_batch_clip_to_the_window_and_leave_out_the_wait():
    t, s = window([(10.0, 0.05)]), two_batches()
    # one batch starts inside the window (the open one counts nowhere)
    assert [b.id for b in sp.batches(t, s)] == [4]
    # dispatch: 0.10 s of the first inside, 0.20 of the second
    assert sp.ms_per_batch(t, s, "dispatch") == pytest.approx(300.0)
    # finalize: 0.30 s inside the window, less its 0.10 s wait
    assert sp.ms_per_batch(t, s, "finalize", less="finalize.wait") == \
        pytest.approx(200.0)
    assert sp.ms_per_batch(t, s, "compact") == pytest.approx(100.0)
    assert sp.ms_per_batch(t, s, "dispatch.plan") == pytest.approx(130.0)
    assert sp.ms_per_batch(t, s, "dispatch.encode") is None
    # the harness's own submit spans, clipped alike
    host = [(9.9, 10.05, "submit"), (10.3, 10.35, "submit"),
            (10.35, 10.4, "step: dispatch")]
    assert sp.host_span_ms(t, s, host, "submit") == pytest.approx(100.0)
    assert sp.report(t, s, host)["submit_ms"] == pytest.approx(100.0)
    by = sp.breakdown(t, s)
    assert by["dispatch"]["ms"] == pytest.approx(300.0)
    assert by["dispatch"]["self_ms"] == pytest.approx(170.0)
    assert by["finalize"]["self_ms"] == pytest.approx(100.0)


def test_idle_split_against_known_gaps():
    # busy 10.0-10.1 and 10.5-10.8: idle 10.1-10.5 and 10.8-11.0 (0.6 s)
    t = window([(10.0, 0.1), (10.5, 0.3)])
    s = two_batches()
    # dispatch covers 10.0-10.1 (busy) and 10.4-10.6: idle 10.4-10.5
    assert sp.idle_in_pct(t, s, "dispatch") == pytest.approx(10.0)
    # finalize covers 10.7-11.0: idle 10.8-11.0
    assert sp.idle_in_pct(t, s, "finalize") == pytest.approx(20.0)
    idle = 100.0 * (1 - t.busy_s() / t.window_s)
    assert idle == pytest.approx(60.0)
    assert (sp.idle_in_pct(t, s, "dispatch")
            + sp.idle_in_pct(t, s, "finalize")) <= idle
    r = sp.report(t, s)
    assert r["idle_in_dispatch_pct"] == pytest.approx(10.0)
    assert r["batches"] == 1
    assert r["device_ms"] == 1.5
    s[4].counts["route"] = "banded"
    assert sp.routes(t, s) == {"banded": 1}


def test_cache_hit_rate_over_the_window_batches():
    t, s = window([(10.0, 0.1)]), two_batches()
    assert sp.cache_hit_rate(t, s) == pytest.approx(8 / 32)
    s[4].counts.update(cache_hits=0, cache_misses=0)
    assert sp.cache_hit_rate(t, s) is None       # nothing looked up


def test_nothing_to_read():
    t, s = window([(10.0, 0.1)]), two_batches()
    not_aligned = window([(10.0, 0.1)], aligned=False)
    assert sp.idle_in_pct(not_aligned, s, "dispatch") is None
    assert sp.idle_in_pct(window([]), s, "dispatch") is None
    for spans in (None, []):
        r = sp.report(t, spans)
        assert r["batches"] is None
        assert all(v is None for v in r.values())
    # off the card no batch carries its device time
    assert sp.device_ms(t, [span("finalize", 10.1, 10.2, 0)]) is None
    assert all(v is None for v in sp.report(None, s).values())
    # spans, but no batch dispatched inside the window
    assert sp.ms_per_batch(t, s[:3], "dispatch") is None


class FakeTracer:
    """The device tracer's seam without a device: a window of no
    operations, aligned with the host's clock."""

    def __init__(self, torch, device):
        self.trace = None
        self.start_s = 0.0

    def prepare(self):
        pass

    def start(self):
        import time
        self.t0 = time.perf_counter()

    def stop(self):
        import time
        self.t1 = time.perf_counter()

    def finish(self):
        self.trace = Trace(t0=self.t0, t1=self.t1, ops=[], syncs=[],
                           aligned=True)


def _tool_and_driver(monkeypatch):
    """``tools/spans.py`` with the driver's device tracer replaced by
    :class:`FakeTracer`."""
    sys.path.insert(0, str(ROOT / "perfbench" / "tools"))
    try:
        import spans as tool
    finally:
        sys.path.remove(str(ROOT / "perfbench" / "tools"))
    sys.path.insert(0, str(ROOT / "perfbench"))
    import run as harness_run
    sys.path.remove(str(ROOT / "perfbench"))
    drv = harness_run.load_module(ROOT / "perfbench" / "drivers"
                                  / "db_search.py",
                                  "perfbench_driver_db_search")
    monkeypatch.setattr(drv, "Tracer", FakeTracer)
    return tool


def test_the_tool_attaches_the_recorder_over_the_traced_window(
        tiny_root, capsys, monkeypatch):
    pytest.importorskip("repro_torch.serve.trace")
    tool = _tool_and_driver(monkeypatch)
    rc = tool.main(["--", "--workload", "hek293_oms.delta", "--seed",
                    str(2**33 + 5), "--seconds", "1.0", "--trace", "1"],
                   device="cpu", root=tiny_root)
    out, err = capsys.readouterr()
    assert rc == 0, err[-3000:]
    lines = out.strip().splitlines()
    result, spans = json.loads(lines[-2]), json.loads(lines[-1])
    assert result["correct"] is True
    r = spans["spans"]
    assert r["batches"] > 0 and spans["records"] > 0
    assert r["dispatch_ms"] > 0 and r["finalize_ms"] > 0
    assert r["oms_plan_ms"] > 0
    assert 0.0 <= r["query_cache_hit_rate"] <= 1.0
    assert {"dispatch", "dispatch.plan", "dispatch.encode",
            "dispatch.search", "finalize", "finalize.fdr"} <= set(r["by_span"])
    assert r["submit_ms"] > 0
    # no device operations: no idle split
    assert r["idle_in_dispatch_pct"] is None
    # untraced: the run as run.py runs it, nothing attached
    rc = tool.main(["--", "--workload", "iprg2012_db.backlog", "--seed",
                    "7", "--seconds", "0.5", "--trace", "0"],
                   device="cpu", root=tiny_root)
    out, err = capsys.readouterr()
    assert rc == 0, err[-3000:]
    assert json.loads(out.strip().splitlines()[-1]) == {"spans": None}


def test_the_tool_on_a_program_without_the_recorder(tiny_root, capsys,
                                                    monkeypatch):
    """A program with no ``repro_torch.serve.trace`` (an import of it
    fails) runs the traced cell as ``run.py`` does: the result stays
    correct and the spans' line reads null."""
    tool = _tool_and_driver(monkeypatch)
    monkeypatch.setitem(sys.modules, "repro_torch.serve.trace", None)
    rc = tool.main(["--", "--workload", "iprg2012_db.backlog", "--seed",
                    str(2**32 + 3), "--seconds", "0.5", "--trace", "1"],
                   device="cpu", root=tiny_root)
    out, err = capsys.readouterr()
    assert rc == 0, err[-3000:]
    lines = out.strip().splitlines()
    assert json.loads(lines[-2])["correct"] is True
    assert json.loads(lines[-1]) == {"spans": None}
