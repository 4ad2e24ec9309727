"""Runs one benchmark cell as ``perfbench/run.py`` does, with the program's
span recorder attached to its server over the traced sub-window, and
prints after the run's result line one JSON line of what the spans say
(``perfbench/harness/spans.py``).

    python3 perfbench/tools/spans.py -- --workload <name> --seed <n> \\
        --seconds <s> --trace 1

The recorder (``repro_torch.serve.trace.SpanRecorder``) is attached as
``server.tracer`` when the device tracer starts its sub-window and
detached when it stops, so spans and device operations cover the same
window on the same clock. An untraced run, or a program without the
recorder, runs as ``run.py`` runs it and prints ``{"spans": null}``.
Beside the spans' numbers the line carries the run's harness-side
``host_ms_per_batch`` and ``device_idle_share``, read from the same trace,
and (``submit_ms``) the harness's own spans around its submit calls, which
the program does not record.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main(argv=None, *, device=None, root: Path | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("rest", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    rest = args.rest[1:] if args.rest[:1] == ["--"] else args.rest
    sys.path.insert(0, str(HERE))
    import run as harness_run
    harness_run._paths()
    from perfbench.harness import loop, readers
    from perfbench.harness import spans as span_readers
    try:
        from repro_torch.serve.trace import SpanRecorder
    except ImportError:
        SpanRecorder = None

    got: dict = {}
    real_open, real_close = loop.Window.open, loop.Window.close
    real_read = harness_run.read_metrics

    def flip(win, before: int) -> None:
        srv = win.cell.server
        if SpanRecorder is None:
            return
        if before == 0 and win.phase == 1:
            srv.tracer = SpanRecorder()
        elif before == 1 and win.phase == 2 and srv.tracer is not None:
            got["spans"] = srv.tracer.export()
            srv.tracer = None

    def open_(win, now):
        before = win.phase
        out = real_open(win, now)
        flip(win, before)
        return out

    def close_(win):
        before = win.phase
        real_close(win)
        flip(win, before)

    def read_metrics(entries, run):
        got["run"] = run
        return real_read(entries, run)

    loop.Window.open, loop.Window.close = open_, close_
    harness_run.read_metrics = read_metrics
    try:
        rc = harness_run.main(rest, device=device, root=root)
    finally:
        loop.Window.open, loop.Window.close = real_open, real_close
        harness_run.read_metrics = real_read
    run, spans = got.get("run"), got.get("spans")
    out: dict = {"spans": None}
    if run is not None and spans is not None and run.trace is not None:
        out = {"spans": span_readers.report(run.trace, spans,
                                            run.host_spans),
               "host_ms_per_batch": readers.host_ms_per_batch(run),
               "device_idle_share": readers.idle_pct(run),
               "traced_batches": len(run.traced_batches),
               "records": len(spans)}
    print(json.dumps(out))
    sys.stdout.flush()
    return rc


if __name__ == "__main__":
    sys.exit(main())
