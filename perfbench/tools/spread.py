"""Spreads and bounds from the JSON lines ``series.py`` wrote.

    python3 perfbench/tools/spread.py chiprun_out/set1.jsonl \\
        chiprun_out/set2.jsonl

Each file is one set of runs. For every cell and end-to-end metric it
prints each set's median and spread (the distance between the first and
the third quartile, ``statistics.quantiles(values, n=4)``, over the
median), the spread with each set's run farthest from its median left
out, and five times the widest spread: the bound that spread supports
(never under 1%). A set's first run of a cell builds the kernels, so
its ``setup_s`` is left out, as the check leaves it out. It also prints
how many runs were correct, on how many seeds.
"""

from __future__ import annotations

import json
import statistics
import sys
from collections import defaultdict


def spread(values: list[float]) -> float:
    if len(values) < 2:
        return float("nan")
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def trimmed(values: list[float]) -> list[float]:
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return [v for i, v in enumerate(values) if i != far]


def load(path: str) -> dict:
    """cell -> metric -> values, and cell -> (correct, seeds)."""
    vals: dict = defaultdict(lambda: defaultdict(list))
    ok: dict = defaultdict(lambda: [0, 0, set()])
    for line in open(path):
        rec = json.loads(line)
        work, seed = rec["run"].split(":")[:2]
        res = rec.get("result") or {}
        ok[work][1] += 1
        if res.get("correct"):
            ok[work][0] += 1
            ok[work][2].add(seed)
        for name, m in res.get("metrics", {}).items():
            vals[work][name].append(m["value"])
    for work in vals:
        # a set's first run of a cell builds the kernels: its set-up is
        # held apart, as the check holds it
        vals[work]["setup_s"] = vals[work]["setup_s"][1:]
    return {"values": vals, "ok": ok}


def main(argv=None) -> int:
    paths = (argv if argv is not None else sys.argv[1:])
    sets = [load(p) for p in paths]
    cells = sorted({c for s in sets for c in s["values"]})
    for cell in cells:
        metrics = sorted({m for s in sets for m in s["values"][cell]})
        for m in metrics:
            rows, widest = [], 0.0
            for s in sets:
                v = s["values"][cell][m]
                if not v:
                    continue
                sp = spread(v)
                widest = max(widest, sp)
                rows.append(f"median {statistics.median(v):.6g} spread "
                            f"{sp:.4f} (less the farthest "
                            f"{spread(trimmed(v)) if len(v) > 2 else sp:.4f})"
                            f" n {len(v)}")
            print(f"{cell} {m}: " + " | ".join(rows)
                  + f" -> bound {max(0.01, 5 * widest):.4f}")
        for i, s in enumerate(sets):
            c, n, seeds = s["ok"][cell]
            print(f"{cell} set {i + 1}: {c} of {n} correct, "
                  f"{len(seeds)} seeds")
    return 0


if __name__ == "__main__":
    sys.exit(main())
