"""ERT-style autotuner CLI for the port's CUDA kernels.

Counterpart of ``repro.launch.tune``. Measures this card's float32 compute
and memory-bandwidth ceilings (:mod:`repro_torch.tune.microbench`), sweeps
each kernel's launch knobs against representative workloads
(:mod:`repro_torch.tune.sweep`: the reference's quick shapes with
``--quick``, else the shapes the port serves), and writes the winners to
a JSON tuning table keyed by (device kind, op, shape bucket). Point
``REPRO_TORCH_TUNING_TABLE`` at the file and every kernel wrapper resolves
its knobs from it, falling back to the fixed rules for shapes (or device
kinds) the table does not cover; ``repro_torch.launch.roofline`` then
prices with the measured ceilings.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.tune --out artifacts/tuning_table_torch.json
  PYTHONPATH=src python -m repro_torch.launch.tune --device cpu --quick --out /tmp/t.json

Runs on the card unless ``--device cpu`` is given, and raises where the
card is asked for but absent.
"""

from __future__ import annotations

import argparse
import json

from repro_torch.device import resolve_device
from repro_torch.launch.roofline import HBM_BW, PEAK_FLOPS_FP32
from repro_torch.tune.sweep import (
    FULL_REDUCED,
    OPS,
    build_tuning_table,
    tuned_vs_default_ratio,
)
from repro_torch.tune.table import ENV_VAR


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default="artifacts/tuning_table_torch.json",
                    help="tuning-table JSON path (written atomically)")
    ap.add_argument("--quick", action="store_true",
                    help="the reference's quick shapes (CPU runs, tests)")
    ap.add_argument("--ops", default=None,
                    help=f"comma-separated subset of {','.join(OPS)}")
    ap.add_argument("--iters", type=int, default=3,
                    help="timed calls per candidate (median taken)")
    ap.add_argument("--skip-ceilings", action="store_true",
                    help="sweep knobs only; keep the table ceiling-free")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    ops = None
    if args.ops:
        ops = tuple(s.strip() for s in args.ops.split(",") if s.strip())
        unknown = [o for o in ops if o not in OPS]
        if unknown:
            ap.error(f"unknown ops {unknown}; choose from {OPS}")
    dev = resolve_device(args.device)
    if not args.quick:
        print(f"reduced: {FULL_REDUCED}")

    table = build_tuning_table(args.out, quick=args.quick, ops=ops,
                               iters=args.iters,
                               skip_ceilings=args.skip_ceilings, device=dev)

    print(f"device_kind: {table.device_kind}")
    if table.ceilings:
        print("ceilings: peak %.2f GFLOP/s (%s), hbm %.2f GB/s; published "
              "H100 SXM: %.0f GFLOP/s float32, %.0f GB/s"
              % (table.ceilings["peak_flops_fp32"] / 1e9,
                 table.ceilings["matmul"], table.ceilings["hbm_bw"] / 1e9,
                 PEAK_FLOPS_FP32 / 1e9, HBM_BW / 1e9))
    for op, buckets in table.ops.items():
        for bucket, entry in buckets.items():
            us, dus = entry.get("us"), entry.get("default_us")
            speedup = (f" ({dus / us:.2f}x vs default; {us:.1f} us, default "
                       f"{dus:.1f} us)" if us and dus else "")
            print(f"  {op} [{bucket}]: {json.dumps(entry['blocks'])}"
                  f"{speedup}")
    print("worst tuned-vs-default ratio: %.3f" % tuned_vs_default_ratio(table))
    print(f"wrote {args.out}; activate with {ENV_VAR}={args.out}")
    return table


if __name__ == "__main__":
    main()
