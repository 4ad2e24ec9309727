#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises, so the script
exits non-zero and prints no result line:

1. Build: compiles every CUDA kernel of the port from ``src/repro_torch/csrc``
   (one ``nvcc`` per source, in parallel) and prints the seconds taken,
   each kernel's registers and spills, and the card's name and power limit.
2. Kernels vs plain versions: every kernel against its plain PyTorch
   version on the card, on edge cases (packed and int8 banks, int8 at
   D = 1000, ragged R, num_valid < R, k > num_valid, k = R, duplicate
   rows). Tolerance: exact (integer indices and scores).
3. Serving at iPRG2012 scale: ``repro_torch.launch.serve_db.main`` once
   with ``--fused`` (the ``topk_hamming`` kernel) and once with
   ``--fused-e2e`` (the ``encode_search`` kernel), each on a bank of
   1,162,392 rows (581,196 targets = 145,299 identities x 4, and as many
   m/z-reversed decoys) at D = 8192, 1024 bins, 16 levels, k = 4. Kernel
   launch counts are set to 0 just before each run and read just after;
   a kernel of the run's path that was never launched fails the run.
   Each run prints how its serving span splits into the traffic
   generator's sleeps, the device's searches (CUDA events around each
   batch's search) and host work. A served batch of 32, recorded by a
   ``SearchExecutor`` subclass handed to the launcher, is held against
   the plain route on the card; then each kernel is timed with CUDA
   events on that batch and bank (and on its first rows at each smaller
   served bucket) beside its plain version.

It then prints one ``{"kernels": [...]}`` line and, last, one
``{"ok": true, "device": {...}}`` line. It exits non-zero where
``torch.cuda.is_available()`` is False, and where ``src/repro_torch`` is
missing beside it.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# iPRG2012 (core/imc/energy.py): 145,299 identities x 4 replicates; its
# 15,867 queries are cut to 4,096 per run for the time limit
IDENTITIES = 145_299
REPLICATES = 4
QUERIES = 4096
IPRG_QUERIES = 15_867
DIM, K, MAX_BATCH = 8192, 4, 32

# H100 SXM published peaks (dense, 700 W): 3.35 TB/s HBM3 and 1,979 TOP/s
# int8 on the tensor cores. POPC issues 16 per clock per SM (a quarter of
# the 64-wide integer pipe): the ceiling of the kernels' current design.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
POPC_PER_CLOCK_PER_SM = 16

TPU_KERNELS = {
    "topk_hamming": "src/repro/kernels/topk_hamming/topk_hamming.py:85",
    "encode_search": "src/repro/kernels/encode_search/encode_search.py:78",
}


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"FAILED: {what}")


def phase_build(build):
    t0 = time.perf_counter()
    paths = build.build()
    secs = time.perf_counter() - t0
    print(f"build: {len(paths)} kernels in {secs:.2f} s "
          f"({', '.join(p.name for p in paths.values())})")
    for name in paths:
        regs = [ln.strip() for ln in build.build_log(name).splitlines()
                if "registers" in ln or "spill" in ln]
        spills = sum("0 bytes spill stores" not in ln for ln in regs
                     if "spill" in ln)
        print(f"build: {name}: {len(regs) // 2} entry points, "
              f"{spills} with spills; "
              f"{'; '.join(r for r in regs if 'registers' in r)[:400]}")
    print(nvidia_smi("name,power.limit"))


# phase 2 cases: (Q, R, D, packed, k, num_valid, duplicate rows)
EDGE_CASES = [
    (32, 3000, 8192, True, 4, None, False),
    (5, 1000, 256, True, 7, 600, False),      # ragged Q, num_valid < R
    (40, 517, 64, True, 20, 9, False),        # k > num_valid
    (3, 37, 32, True, 37, None, False),       # k = R
    (17, 300, 96, True, 9, None, True),       # duplicate rows: tied scores
    (32, 2000, 1000, False, 4, None, False),  # int8 at D = 1000
    (9, 129, 1000, False, 129, 77, True),     # int8, k = R, ties, masked
]


def phase_kernels_vs_plain(torch, np):
    from repro_torch.core.hd.similarity import bitpack_bipolar
    from repro_torch.kernels.encode_search import (
        encode_search,
        encode_search_plain,
    )
    from repro_torch.kernels.topk_hamming import (
        topk_hamming,
        topk_hamming_plain,
    )
    dev = torch.device("cuda")

    def bank(rng, rows, d, packed, dup=False):
        hv = rng.choice([-1, 1], size=(rows, d)).astype(np.int8)
        if dup:
            hv = np.concatenate([hv, hv, hv])
        t = torch.from_numpy(hv).to(dev)
        return bitpack_bipolar(t) if packed else t

    mismatches = {"topk_hamming": 0, "encode_search": 0}
    for Q, R, D, packed, k, nv, dup in EDGE_CASES:
        rng = np.random.default_rng(Q * 1000 + R + D)
        r = bank(rng, R // 3 if dup else R, D, packed, dup)
        q = bank(rng, Q, D, packed)
        got = topk_hamming(q, r, dim=D, k=k, num_valid=nv)
        want = topk_hamming_plain(q, r, dim=D, k=k, num_valid=nv)
        mismatches["topk_hamming"] += int((got[0] != want[0]).sum()
                                          + (got[1] != want[1]).sum())
        F, m = 300, 16
        idh = torch.from_numpy(rng.choice([-1, 1], size=(F, D)).astype(
            np.int8)).to(dev)
        lvh = torch.from_numpy(rng.choice([-1, 1], size=(m, D)).astype(
            np.int8)).to(dev)
        lev = rng.integers(0, m, size=(Q, F))
        lev[:, rng.random(F) < 0.7] = 0
        lev[0] = 0
        lev = torch.from_numpy(lev.astype(np.int32)).to(dev)
        got = encode_search(lev, idh, lvh, r, dim=D, k=k, num_valid=nv)
        want = encode_search_plain(lev, idh, lvh, r, dim=D, k=k,
                                   num_valid=nv)
        mismatches["encode_search"] += int((got[0] != want[0]).sum()
                                           + (got[1] != want[1]).sum())
    torch.cuda.synchronize()
    print(f"kernels vs plain: {len(EDGE_CASES)} cases each, mismatches "
          f"{json.dumps(mismatches)}")
    check(not any(mismatches.values()), "kernel disagrees with its plain "
                                         "version")


def recording_executor(rows: int):
    """A ``SearchExecutor`` subclass that keeps the device batch, bank,
    encoder and results of the first served batch of ``rows`` queries."""
    from repro_torch.serve import SearchExecutor

    class Recording(SearchExecutor):
        got = None

        def dispatch(self, reqs):
            h = super().dispatch(reqs)
            if Recording.got is None and h.n == rows:
                Recording.got = (h.db, self.server.encoder, h.batch.clone(),
                                 h.idx.clone(), h.vals.clone())
            return h

    return Recording


def time_ms(torch, fn, iters, warmup=1):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(ops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take, in ms: the larger of ``ops``
    at the int8 tensor-core peak and ``nbytes`` at HBM bandwidth. The
    score is a +-1 dot product, which int8 tensor cores compute exactly."""
    t_ops = ops / INT8_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def popc_pipe_ms(popc: float, sms: int) -> float:
    """This design's own ceiling: ``popc`` POPCs at 16 per clock per SM
    and the card's maximum SM clock, in ms."""
    clock_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    return 1e3 * popc / (POPC_PER_CLOCK_PER_SM * sms * clock_hz)


def phase_serve(torch, np, fused_e2e: bool):
    from repro_torch.kernels.encode_search import (
        encode_search,
        encode_search_plain,
    )
    from repro_torch.kernels.topk_hamming import (
        topk_hamming,
        topk_hamming_plain,
    )
    from repro_torch.launch import serve_db

    path = "fused-e2e" if fused_e2e else "fused"
    kernel = "encode_search" if fused_e2e else "topk_hamming"
    recorder = recording_executor(MAX_BATCH)
    argv = ["--hd-dim", str(DIM), "--identities", str(IDENTITIES),
            "--refs-per-identity", str(REPLICATES), "--queries",
            str(QUERIES), "--k", str(K), "--max-batch", str(MAX_BATCH),
            "--device", "cuda", f"--{path}"]
    torch.cuda.reset_peak_memory_stats()
    for fn in serve_db.KERNELS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    s = serve_db.main(argv, executor_cls=recorder)
    launches = {n: fn.launches for n, fn in serve_db.KERNELS.items()}
    wall = time.perf_counter() - t0
    print(json.dumps({
        "path": path, "queries": s["count"], "qps": s["qps"],
        "p50_ms": s["p50_ms"], "p95_ms": s["p95_ms"],
        "identified_at_fdr": s["identified"], "correct": s["correct"],
        "library_s": s["library_s"], "bank_build_s": s["bank_build_s"],
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": launches, "batches": s["batches"],
        "buckets": s["buckets"], "span_s": s["span_s"],
        "sleep_s": s["sleep_s"], "device_busy_s": s["device_busy_s"],
        "host_s": s["span_s"] - s["sleep_s"] - s["device_busy_s"],
        "run_s": wall}))
    check(launches[kernel] > 0, f"{kernel} never launched on the {path} path")
    check(s["count"] == QUERIES, f"{path}: served {s['count']} of {QUERIES}")
    check(recorder.got is not None, f"{path}: no served batch of {MAX_BATCH}")

    db, enc, batch, idx, vals = recorder.got
    R, W = db.data.shape
    if fused_e2e:
        def run(n=MAX_BATCH):
            return encode_search(batch[:n], enc.id_hvs, enc.level_hvs,
                                 db.data, dim=db.dim, k=K,
                                 num_valid=db.num_rows,
                                 codebook_words=enc.codebook_words)

        def plain():
            return encode_search_plain(batch, enc.id_hvs, enc.level_hvs,
                                       db.data, dim=db.dim, k=K,
                                       num_valid=db.num_rows)

        n_present = int((batch > 0).sum())
        ops = 2 * (MAX_BATCH * R + n_present) * db.dim
        popc = MAX_BATCH * R * W + n_present * W
        nbytes = (batch.numel() * 4 + sum(w.numel() * 4
                                          for w in enc.codebook_words)
                  + db.data.numel() * 4 + 2 * MAX_BATCH * K * 4)
    else:
        def run(n=MAX_BATCH):
            return topk_hamming(batch[:n], db.data, dim=db.dim, k=K,
                                num_valid=db.num_rows)

        def plain():
            return topk_hamming_plain(batch, db.data, dim=db.dim, k=K,
                                      num_valid=db.num_rows)

        n_present = None
        ops = 2 * MAX_BATCH * R * db.dim
        popc = MAX_BATCH * R * W
        nbytes = (batch.numel() * 4 + db.data.numel() * 4
                  + 2 * MAX_BATCH * K * 4)
    p_idx, p_vals = plain()
    served_diff = int((p_idx != idx).sum() + (p_vals != vals).sum())
    k_idx, k_vals = run()
    max_abs_err = int((k_vals.to(torch.int64) - p_vals.to(torch.int64))
                      .abs().max())
    mismatches = int((k_idx != p_idx).sum() + (k_vals != p_vals).sum())
    print(f"{path}: served batch of {MAX_BATCH} vs plain route on the card: "
          f"{served_diff} differing entries; kernel vs plain: {mismatches}")
    check(served_diff == 0, f"{path}: served batch differs from plain route")
    check(mismatches == 0, f"{path}: {kernel} differs from its plain version")

    ms = time_ms(torch, run, iters=20, warmup=2)
    # the served buckets below 32 queries, on the same bank
    bucket_ms = {n: time_ms(torch, lambda n=n: run(n), iters=20, warmup=2)
                 for n in sorted(s["buckets"]) if n < MAX_BATCH}
    plain_ms = time_ms(torch, plain, iters=2, warmup=0)
    clocks = nvidia_smi("clocks.sm,power.draw,power.limit")
    b_ms, b_by = bound_ms(ops, nbytes)
    popc_ms = popc_pipe_ms(
        popc, torch.cuda.get_device_properties(0).multi_processor_count)
    print(f"{path}: {kernel} {ms:.4f} ms, plain {plain_ms:.2f} ms, bound "
          f"{b_ms:.4f} ms ({b_by}; {ops:.4g} int8 ops, {nbytes:.4g} B), "
          f"this design's POPC-pipe ceiling {popc_ms:.4f} ms ({popc:.4g} "
          f"POPC) at Q={MAX_BATCH}, R={R}"
          + ("" if n_present is None
             else f", {n_present} present bins in the batch")
          + f"; by served bucket (Q: ms) "
          f"{json.dumps(bucket_ms)}; sm clock, power, limit: {clocks}")
    return {
        "name": kernel, "route": "cuda",
        "source": f"src/repro_torch/csrc/{kernel}.cu",
        "replaces": TPU_KERNELS[kernel], "launches": launches[kernel],
        "mismatches": mismatches, "max_abs_err": max_abs_err,
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by,
        # no single PyTorch call computes a streaming top-k by Hamming
        # distance (with or without the encode)
        "library_ms": None,
    }


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test "
              "runs only on a CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    phase_build(_build)
    phase_kernels_vs_plain(torch, np)
    print(f"reduced: queries {QUERIES} per run of iPRG2012's {IPRG_QUERIES} "
          f"(time limit); bank rows {2 * IDENTITIES * REPLICATES} (full), "
          f"D={DIM}")
    kernels = [phase_serve(torch, np, fused_e2e=False),
               phase_serve(torch, np, fused_e2e=True)]
    print(f"total: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
