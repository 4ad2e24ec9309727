"""Runs one benchmark cell with faults planted in the program underneath,
to show that the check fails them and to read the upper ends of its
limits.

    python3 perfbench/tools/faults.py --fault bank_bit \\
        --fault answer_dropped -- --workload <name> --seed <n> \\
        --seconds <s> --trace 0 [--control 2]

Everything after ``--`` goes to ``perfbench/run.py``. The faults:

* ``answer_altered``: every batch's first answer names the next row
  (an answer altered where it is produced);
* ``half_batch``: the second half of every batch is answered with the
  first half's answers (half of the batch left out);
* ``bank_bit``: one bit of the first stored row of the packed bank is
  flipped once it is built (the library's encode altered);
* ``answer_dropped``: the last request of every ``DROP_EVERY``-th batch
  is never answered.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
DROP_EVERY = 10


def _routed_fault(change):
    def plant(monkeypatch):
        import numpy as np

        import repro_torch.serve.db_search as served
        real = served.fdr_route

        def broken(*a, **kw):
            routed = real(*a, **kw)
            for name in ("indices", "scores", "is_target", "accept",
                         "match"):
                setattr(routed, name, np.array(getattr(routed, name)))
            change(routed)
            return routed

        monkeypatch.setattr(served, "fdr_route", broken)
    return plant


def _alter(routed):
    routed.indices[0, 0] += 1


def _half(routed):
    n = routed.indices.shape[0]
    h = n - n // 2
    for name in ("indices", "scores", "is_target", "accept", "match"):
        a = getattr(routed, name)
        a[h:] = a[:n - h]


def _bank_bit(monkeypatch):
    import torch

    import repro_torch.serve.db_search as served
    real = served.shard_database

    def broken(*a, **kw):
        db = real(*a, **kw)
        if db.data.dtype == torch.int32:
            db.data[0, 0] ^= 1
        return db

    monkeypatch.setattr(served, "shard_database", broken)


def _answer_dropped(monkeypatch):
    from repro_torch.serve import SearchExecutor
    real = SearchExecutor.finalize
    seen = [0]

    def broken(self, handle):
        live = real(self, handle)
        seen[0] += 1
        if seen[0] % DROP_EVERY == 0 and live:
            live.pop()
        return live

    monkeypatch.setattr(SearchExecutor, "finalize", broken)


FAULTS = {"answer_altered": _routed_fault(_alter),
          "half_batch": _routed_fault(_half),
          "bank_bit": _bank_bit,
          "answer_dropped": _answer_dropped}


class Patches:
    """A minimal stand-in for pytest's ``monkeypatch``: sets attributes and
    puts them back on ``undo``."""

    def __init__(self):
        self._saved = []

    def setattr(self, obj, name, value):
        self._saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        while self._saved:
            obj, name, value = self._saved.pop()
            setattr(obj, name, value)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fault", action="append", choices=sorted(FAULTS),
                    required=True)
    ap.add_argument("rest", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    rest = args.rest[1:] if args.rest[:1] == ["--"] else args.rest
    sys.path.insert(0, str(HERE))
    import run as harness_run
    harness_run._paths()
    patches = Patches()
    try:
        for name in args.fault:
            FAULTS[name](patches)
        return harness_run.main(rest)
    finally:
        patches.undo()


if __name__ == "__main__":
    sys.exit(main())
