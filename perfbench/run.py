"""One run of one benchmark cell of the PyTorch/CUDA port.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell (``workloads`` in ``BENCHMARK.json``) names a configuration file
and a traffic mix (``perfbench/traffic/<traffic>.json``); the
configuration names the driver that runs it (``perfbench/drivers/
<driver>.py``), the mix its generator (``perfbench/traffic/generators/
<generator>.py``), and each metric is read by ``perfbench/metrics/
<name>.py`` (or, where there is none, by the reader of the name without
its last dotted part).
So a configuration, a mix or a metric is added with files and entries,
without an edit here.

The run sets the program up (inputs made on the card from ``--seed``,
every shape warmed up; ``setup_s``), serves the mix for ``--seconds``,
checks what was served against the plain reference, and prints as its
last line of standard output one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics read from a device trace of part of
the window), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each number compared beside its limit, also printed as the
last lines of standard error.

It exits with another code than 0, and prints no result, without enough
CUDA devices, without the program's package beside it, or if the JAX
package or JAX was loaded by the time the window closed.

``--rate`` (an open loop's offered spectra/s, for a sweep) and
``--control N`` (the reference over N-bit cells put in the program's place,
to show that the check fails it) are for the benchmark's own tools; a
measured run passes neither.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _paths() -> None:
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    build = ROOT / "build"
    # every cache of the run lives at a fixed path inside the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton_cache"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(build / "torch_extensions"))


def load_module(path: Path, name: str):
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rate", type=float, default=None)
    ap.add_argument("--control", type=int, default=None)
    return ap.parse_args(argv)


def metric_entries(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics, or its per-layer metrics."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def read_metrics(entries: list[dict], run) -> dict:
    from perfbench.harness.readers import reader_file
    out = {}
    for m in entries:
        path = reader_file(HERE / "metrics", m["name"])
        reader = load_module(path, "perfbench_metric_"
                             + path.stem.replace(".", "_"))
        value = reader.read(run)
        if value is None:
            print(f"metric {m['name']}: nothing to read", file=sys.stderr)
            continue
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def main(argv=None, *, device=None, root: Path | None = None) -> int:
    """Runs one cell; returns the exit code. ``device`` (tests only) skips
    the look for CUDA devices and runs there; ``root`` is where
    ``BENCHMARK.json`` and the files it names lie (the checkout)."""
    args = parse(argv)
    root = ROOT if root is None else Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    cell = cells[args.workload]
    _paths()
    import torch
    if device is None:
        if not torch.cuda.is_available() or (
                torch.cuda.device_count() < int(cell["chips"])):
            print(f"the cell needs {cell['chips']} CUDA device(s); "
                  f"found {torch.cuda.device_count()}", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    device = torch.device(device)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("the program (src/repro_torch) is not beside the benchmark",
              file=sys.stderr)
        return 2
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = json.loads((root / cfg_entry["file"]).read_text())
    from perfbench.harness import host
    print(f"host: {host.apply(cfg.get('host'), torch)}", file=sys.stderr)
    mix = json.loads((root / "perfbench" / "traffic"
                      / f"{cell['traffic']}.json").read_text())
    driver = load_module(HERE / "drivers" / f"{cfg['driver']}.py",
                         "perfbench_driver_" + cfg["driver"])
    run = driver.run(cfg, mix, seed=args.seed, seconds=args.seconds,
                     trace=bool(args.trace), device=device, t_start=T_START,
                     rate=args.rate, control=args.control)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}; the benchmark "
              f"runs the port alone", file=sys.stderr)
        return 3
    entries = metric_entries(bench, args.workload, bool(args.trace))
    metrics = read_metrics(entries, run)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": name, "count": int(cell["chips"]),
           "memory_peak_bytes": int(run.memory_peak_bytes)}
    out = {}
    if args.trace:
        tr = run.trace
        dev["busy_s"] = tr.busy_s() if tr is not None else 0.0
        dev["window_s"] = tr.window_s if tr is not None else 0.0
        from perfbench.harness.trace import attribute_gaps
        out["breakdown"] = {
            "device_ops": tr.top_ops() if tr is not None else [],
            "idle_gaps": (attribute_gaps(tr, run.host_spans)
                          if tr is not None else [])}
    checks = run.checks
    correct = all(v <= lim for v, lim in checks.values())
    for k, v in run.notes.items():
        if k != "rid0":
            print(f"{k}: {v}", file=sys.stderr)
    print(f"setup_s {run.setup_s:.3f}, window {args.seconds:g} s, "
          f"attempted {run.attempted}, completed in window "
          f"{run.completed}, failed {run.failed}", file=sys.stderr)
    for k, (v, lim) in checks.items():
        print(f"check {k}: {v} limit {lim}", file=sys.stderr)
    result = {"correct": bool(correct), "attempted": int(run.attempted),
              "failed": int(run.failed), "metrics": metrics, "device": dev,
              **out,
              "checks": {k: {"value": v, "limit": lim}
                         for k, (v, lim) in checks.items()}}
    print(json.dumps(result, allow_nan=False))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
