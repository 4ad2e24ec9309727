"""Runs benchmark cells one after another on this machine and keeps what
each run printed, for measuring spreads, seeds and sweeps.

    python3 perfbench/tools/series.py --out chiprun_out/NAME.jsonl \\
        --seconds 20 RUN [RUN ...]

Each RUN is ``workload:seed[:trace[:extra,args]]``, e.g.
``iprg2012_db.backlog:101:0`` or ``iprg2012_db.live:7:0:--rate,5000``;
``--fault=NAME`` among the extra arguments runs the cell through
``tools/faults.py`` with that fault planted.
Every run is its own process (as the benchmark's check runs it). One JSON
line a run goes to ``--out``: the arguments, the exit code, the wall
seconds, the result line and the last lines of standard error. The
card's name and power limit are printed first.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--tail", type=int, default=40,
                    help="lines of standard error kept a run")
    ap.add_argument("runs", nargs="+")
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    print(f"card: {card()}", flush=True)
    worst = 0
    with out.open("a") as f:
        for spec in args.runs:
            parts = spec.split(":")
            work, seed = parts[0], parts[1]
            trace = parts[2] if len(parts) > 2 else "0"
            extra = parts[3].split(",") if len(parts) > 3 else []
            faults = [e for e in extra if e.startswith("--fault=")]
            extra = [e for e in extra if e not in faults]
            cmd = [sys.executable, "perfbench/run.py"]
            if faults:
                cmd = [sys.executable, "perfbench/tools/faults.py", *faults,
                       "--"]
            cmd += ["--workload", work, "--seed", seed, "--seconds",
                    str(args.seconds), "--trace", trace, *extra]
            t0 = time.perf_counter()
            p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
            wall = time.perf_counter() - t0
            lines = p.stdout.strip().splitlines()
            try:
                result = json.loads(lines[-1]) if lines else None
            except json.JSONDecodeError:
                result = None
            err = p.stderr.strip().splitlines()[-args.tail:]
            rec = {"run": spec, "rc": p.returncode, "wall_s": wall,
                   "result": result, "stderr": err}
            f.write(json.dumps(rec) + "\n")
            f.flush()
            m = (result or {}).get("metrics", {})
            print(f"{spec}: rc {p.returncode}, {wall:.1f} s, correct "
                  f"{(result or {}).get('correct')}, "
                  + ", ".join(f"{k} {v['value']:.6g}" for k, v in m.items()),
                  flush=True)
            if p.returncode != 0:
                print("\n".join(err[-15:]), flush=True)
            worst = max(worst, p.returncode)
    return worst


if __name__ == "__main__":
    sys.exit(main())
