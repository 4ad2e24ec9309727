"""What the traffic generators share: finding a generator by name, and the
measured window's clock, traced sub-window and host spans.

A mix file (``perfbench/traffic/<mix>.json``) names its ``generator``,
a module ``perfbench/traffic/generators/<generator>.py`` that provides

* ``SAMPLE_BATCHES``: whole served batches the check compares;
* ``check(mix)``: raises ValueError for a mix it cannot run;
* ``warm_spectra(max_batch)``: the warm-up queries it needs;
* ``warm_up(cell)``: serves every batch shape its window will use;
* ``serve(cell, run, seconds, seed, rate)``: drives the window and fills
  the run's counts.

Every mix also gives ``pool_spectra``, the distinct query spectra made at
set-up (they cycle if a run uses them up), and may give
``append_fraction``: that share of the library's targets, and their
decoys, held out of the registration and appended before the window.

A generator drives a driver's cell through ``cell.server`` (``step``,
``run_until_drained``, ``queue``), ``cell.submitter(pool)``,
``cell.pool`` / ``cell.warm``, ``cell.max_batch``, ``cell.mix``,
``cell.tracer`` (None untraced) and ``cell.recorder`` (``active``,
``t_until``, ``dispatched``, ``retired``).
"""

from __future__ import annotations

import importlib.util
import sys
import time
from pathlib import Path

GENERATORS = Path(__file__).resolve().parents[1] / "traffic" / "generators"
DRAIN_WAIT_S = 60.0         # how long an answer due in the window may take
TRACE_LEAD = 0.25           # the traced sub-window starts this far in
TRACE_MAX_S = 4.0           # and lasts at most this long


def generator(name: str):
    """The generator module ``name``; ValueError if there is none."""
    path = GENERATORS / f"{name}.py"
    if not isinstance(name, str) or not path.is_file():
        raise ValueError(f"unknown generator {name!r}; one of "
                         f"{sorted(p.stem for p in GENERATORS.glob('*.py'))}")
    key = "perfbench_generator_" + name.replace(".", "_")
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]


def check_mix(mix: dict):
    """Raises ValueError for a mix that cannot run; returns its
    generator."""
    gen = generator(mix.get("generator"))
    if int(mix.get("pool_spectra", 0)) < 1:
        raise ValueError("a mix needs pool_spectra >= 1")
    frac = float(mix.get("append_fraction", 0.0))
    if not 0.0 <= frac < 1.0:
        raise ValueError("append_fraction must be in [0, 1)")
    gen.check(mix)
    return gen


class Window:
    """The measured window's clock: it opens on construction, starts and
    stops the cell's tracer over its traced sub-window, and meanwhile
    keeps the host spans (start, end, label) of the harness's calls."""

    def __init__(self, cell, run, seconds: float):
        self.cell, self.run = cell, run
        self.clock = time.perf_counter
        self.t0 = self.clock()
        self.t_end = self.t0 + seconds
        self.t_tr0 = self.t0 + TRACE_LEAD * seconds
        self.t_tr1 = self.t_tr0 + min(TRACE_MAX_S,
                                      seconds * (1 - 2 * TRACE_LEAD))
        self.phase = 0 if cell.tracer is not None else 2
        self.spans: list | None = None

    def open(self, now: float) -> bool:
        """False once the window has closed; starts and stops the trace."""
        if now >= self.t_end:
            return False
        if self.phase == 0 and now >= self.t_tr0:
            self.cell.tracer.start()
            self.spans, self.phase = [], 1
        elif self.phase == 1 and now >= self.t_tr1:
            self.cell.tracer.stop()
            self.run.host_spans, self.spans, self.phase = self.spans, None, 2
        return True

    def close(self) -> None:
        if self.phase == 1:
            self.cell.tracer.stop()
            self.run.host_spans, self.spans, self.phase = self.spans, None, 2

    def span(self, a: float, label: str) -> None:
        if self.spans is not None:
            self.spans.append((a, self.clock(), label))

    def step(self):
        """One ``server.step()``, its span labelled by what it did."""
        step = self.cell.server.step
        if self.spans is None:
            return step()
        rec = self.cell.recorder
        a, d, r = self.clock(), rec.dispatched, rec.retired
        out = step()
        d, r = rec.dispatched - d, rec.retired - r
        label = ("step: retire and dispatch" if d and r else
                 "step: dispatch" if d else "step: retire" if r else
                 "step: poll")
        self.spans.append((a, self.clock(), label))
        return out
