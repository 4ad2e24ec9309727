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
   D = 1000, ragged Q and R, num_valid < R, k > num_valid, k = R,
   duplicate rows; for the banded kernels also empty bands, bands
   narrower than k, bands crossing splits and running past num_valid,
   two bands, no tile budget and the plan's tight one, and bands far
   apart inside one 8-query block; for ``hamming_pop`` Q = R = 1, ragged
   Q and R, W = 1, 2, 3 and 64, rows off a 16-byte boundary, all-zero and
   all-ones words, q = r, and the served buckets 4 / 8 / 16 / 32 against
   1,000 and 3,000 centroids; for ``hd_encode`` ragged B, F and D,
   all-absent rows, sign ties and levels past m - 1, at several launch
   shapes; for ``imc_mvm`` integer and float weights, exact .5 points of
   part / lsb, saturated codes, ragged Q, R and Dp, a 64-column array and
   every compiled output tile). Tolerance: exact (integer indices, scores,
   similarities and HVs; ``imc_mvm`` rounds every float32 step as its
   plain version does).
3. The autotuner: ``repro_torch.launch.tune.main`` in-process at the
   served shapes (``tune/sweep.py``), into a temporary file. The six swept
   kernels' launch counts are set to 0 just before and read just after; a
   kernel never launched fails the run, as does a candidate whose result
   differs from the default's, a worst tuned-vs-default ratio under 1.0,
   or a table left active. Prints the measured ceilings beside the
   published ones and each op's default and tuned microseconds. Then
   ``hd_encode`` (B = 32, F = 1,024, D = 8,192) and ``imc_mvm`` (Q = 32
   against 581,196 rows at Dp = 2,731, 6.35 GB of float32 weights) are
   held against their plain versions at those shapes and timed beside
   them, and ``imc_mvm`` beside one float32 ``torch.matmul`` (TF32 off)
   over the same tile dot products without the ADC; the weights are
   freed after.
4. Serving at iPRG2012 scale (no tuning table active): ``repro_torch.launch.serve_db.main`` four
   times, ``--fused`` (the ``topk_hamming`` kernel), ``--fused-e2e``
   (``encode_search``), ``--oms --fused`` (``topk_hamming_banded``) and
   ``--oms --fused-e2e`` (``encode_search_banded``; the OMS runs at the
   launcher's default window, ``query - ref`` in (-20, +200)), each on a
   bank of 1,162,392 rows (581,196 targets = 145,299 identities x 4, and
   as many m/z-reversed decoys) at D = 8192, 1024 bins, 16 levels,
   k = 4. Kernel launch counts are set to 0 just before each run and read
   just after; a kernel of the run's path that was never launched fails
   the run. Each run prints how its serving span splits into the traffic
   generator's sleeps, the device's searches (CUDA events around each
   batch's search) and host work; the OMS runs also their candidate and
   scanned fractions. A served batch of 32, recorded by a
   ``SearchExecutor`` subclass handed to the launcher, is held against
   the plain route on the card (for OMS, the unfused masked route); then
   each kernel is timed with CUDA events on that batch and bank (and, at
   each smaller served bucket, on evenly spaced rows of it) beside its
   plain version.
5. Clustering serving: ``repro_torch.launch.serve_cluster.main`` with two
   tenants, each streaming one paper-average precursor bucket (10,624
   spectra = 1,328 identities x 8) at D = 2048, 1024 bins, 16 levels,
   threshold 0.36 D, max batch 32, consolidation every 2,048 spectra.
   The ``hamming_pop`` count is set to 0 just before the run and read
   just after. The run's batches, recorded by a ``SearchExecutor``
   subclass, are replayed through clusterers whose distance step is the
   plain version, on the card: every assignment (cluster id, spawn flag,
   distance) and each tenant's summary must be equal. Then
   ``hamming_pop`` is timed at the served shape (each bucket against the
   largest final centroid bank) beside its plain version, one served
   distance step and ``torch._int_mm`` on the unpacked operands.
6. One bucket batch-wise: the kernel's pairwise distances over 10,624
   encoded spectra and complete linkage at 0.36 D must give the labels,
   merges and cluster count of the same pipeline over the plain distance
   function; prints the pairwise kernel's time, bound, plain and
   ``torch._int_mm`` times and the linkage's seconds.

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

# H100 SXM published peaks (dense, 700 W): 3.35 TB/s HBM3, 1,979 TOP/s
# int8 on the tensor cores and 67 TFLOP/s float32 outside them. POPC
# issues 16 per clock per SM (a quarter of the 64-wide integer pipe): the
# ceiling of the search kernels' current design.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
FP32_OPS_PER_S = 67e12
POPC_PER_CLOCK_PER_SM = 16

TPU_KERNELS = {
    "topk_hamming": "src/repro/kernels/topk_hamming/topk_hamming.py:85",
    "encode_search": "src/repro/kernels/encode_search/encode_search.py:78",
    "topk_hamming_banded":
        "src/repro/kernels/topk_hamming/topk_hamming.py:165",
    "encode_search_banded":
        "src/repro/kernels/encode_search/encode_search.py:176",
    "hamming_pop": "src/repro/kernels/hamming_pop/hamming_pop.py:20",
    "hd_encode": "src/repro/kernels/hd_encode/hd_encode.py:60",
    "imc_mvm": "src/repro/kernels/imc_mvm/imc_mvm.py:24",
}
# iPRG2012's OMS candidate fraction (core/imc/energy.py DATASETS)
IPRG_CANDIDATE_FRACTION = 0.025


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


# banded cases: (Q, R, D, packed, k, num_valid, duplicate rows, bands,
# tile budget); "plan" bands and budget come from plan_candidates over
# sorted precursors, as the OMS server makes them
BANDED_EDGE_CASES = [
    (32, 3000, 8192, True, 4, None, False, "wide", None),   # crosses splits
    (5, 1000, 256, True, 7, 600, False, "random", None),    # ragged, past nv
    (40, 517, 64, True, 20, 9, False, "random", 1),         # k > num_valid
    (16, 400, 96, True, 9, None, True, "narrow", None),     # ties, < k, empty
    (16, 5000, 256, True, 4, None, False, "far_apart", 8),  # one 8-query block
    (24, 2000, 256, True, 5, 1900, False, "two", None),     # two bands
    (32, 6000, 256, True, 4, None, False, "plan", "plan"),  # tight budget
    (32, 2000, 1000, False, 4, None, False, "wide", None),  # int8 at D = 1000
    (9, 129, 1000, False, 129, 77, True, "two", None),      # int8, k = R, ties
]


def banded_case(np, rng, Q, R, kind, num_tiles):
    """(starts, lens, tile budget) of one banded edge case: (Q,) arrays for
    one band, (2, Q) for two."""
    if kind == "random":        # empty, narrow and wide, some past R
        starts, lens = rng.integers(-3, R + 1, Q), rng.integers(0, R // 2, Q)
    elif kind == "narrow":      # narrower than k, some empty
        starts, lens = rng.integers(0, R - 3, Q), rng.integers(0, 3, Q)
    elif kind == "far_apart":   # inside each 8-query block, both bank ends
        starts = np.where(np.arange(Q) % 2 == 0, 5, R - 700)
        lens = np.full(Q, 600)
    elif kind == "wide":        # many tiles each
        starts, lens = rng.integers(0, 200, Q), rng.integers(R // 2, R, Q)
    elif kind == "two":
        s0, s1 = rng.integers(0, R // 3, Q), rng.integers(R // 2, R - 10, Q)
        starts = np.stack([s0, s1])
        lens = np.stack([rng.integers(0, R // 4, Q),
                         np.minimum(rng.integers(0, R, Q), R - s1)])
    else:                       # "plan": decoy and target blocks
        from repro_torch.serve.oms import (
            OMSConfig,
            build_precursor_index,
            plan_candidates,
        )
        index = build_precursor_index(
            rng.uniform(400, 1600, R // 2), rng.uniform(400, 1600, R // 2))
        plan = plan_candidates(index, np.sort(rng.uniform(400, 1700, Q)),
                               OMSConfig(), num_rows_padded=R, block_q=8)
        starts, lens, num_tiles = plan.starts, plan.lens, plan.num_tiles
    return starts.astype(np.int32), lens.astype(np.int32), num_tiles


# hamming_pop cases: (Q, R, W, layout); ragged Q and R against the 64 x 64
# tile, W = 1, 3 and 64, W % 4 != 0, rows off a 16-byte boundary, all-zero
# and all-ones words, q = r (the pairwise shape), and the served buckets
# against grown centroid banks
HAMMING_EDGE_CASES = [
    (1, 1, 1, "random"), (1, 1000, 64, "random"), (70, 130, 3, "random"),
    (65, 64, 64, "random"), (33, 200, 2, "random"), (40, 77, 64, "offset"),
    (5, 300, 64, "zeros_ones"), (500, 500, 64, "same"),
] + [(q, c, 64, "random") for q in (4, 8, 16, 32) for c in (1000, 3000)]


# hd_encode cases: (B, F, D, m, layout, block_b, block_d): ragged B, F and
# D, all-absent rows, sign ties (two present bins), levels past m - 1, and
# several launch shapes
HD_ENCODE_EDGE_CASES = [
    (32, 1024, 8192, 16, "sparse", None, None),
    (5, 37, 100, 8, "past_m", None, None),
    (13, 300, 1000, 16, "sparse", 4, 256),
    (9, 64, 96, 4, "absent", 2, 32),
    (7, 2, 64, 4, "ties", 1, 8192),
]

# imc_mvm cases: (Q, R, Dp, weights, full_scale, tile_cols, block_q,
# block_r): noisy packed levels, integer weights, exact .5 points of
# part / lsb (lsb = 2), saturated codes, ragged Q, R and Dp, a 64-column
# array, and every compiled tile size along each axis
IMC_EDGE_CASES = [
    (32, 4000, 2731, "noisy", 135.7645, 128, None, None),
    (9, 70, 300, "integer", 135.76, 128, 8, 32),
    (17, 300, 257, "integer", 62.0, 128, 16, 64),
    (8, 129, 128, "saturate", 31.0, 128, 32, 128),
    (40, 515, 1000, "normal", 128.0, 64, 64, 256),
]


def hd_encode_case(torch, np, B, F, D, m, layout):
    """(levels, id_hvs, level_hvs) on the card for one hd_encode case."""
    rng = np.random.default_rng(B * 1000 + F + D)
    idh = rng.choice([-1, 1], size=(F, D)).astype(np.int8)
    lvh = rng.choice([-1, 1], size=(m, D)).astype(np.int8)
    lev = rng.integers(0, m, size=(B, F))
    if layout == "sparse":
        lev[:, rng.random(F) < 0.9] = 0
    elif layout == "past_m":
        lev[:, :5] = m + 2
    elif layout == "absent":
        lev[::2] = 0
    elif layout == "ties":
        lev = rng.integers(1, m, size=(B, F))
    return (torch.from_numpy(lev.astype(np.int32)).cuda(),
            torch.from_numpy(idh).cuda(), torch.from_numpy(lvh).cuda())


def imc_case(torch, np, Q, R, Dp, kind):
    """(queries, weights) float32 on the card for one imc_mvm case."""
    rng = np.random.default_rng(Q * 1000 + R + Dp)
    if kind in ("integer", "saturate"):
        q = rng.integers(-4, 5, size=(Q, Dp)).astype(np.float32)
        w = rng.integers(-3, 4, size=(R, Dp)).astype(np.float32)
        if kind == "saturate":
            w = np.sign(q[:1]) * 3 + 0 * w
    elif kind == "noisy":
        q = (2 * rng.binomial(3, 0.5, size=(Q, Dp)) - 3).astype(np.float32)
        w = (2 * rng.binomial(3, 0.5, size=(R, Dp)) - 3) * (
            1 + 0.1716 * rng.standard_normal((R, Dp)))
    else:
        q = rng.standard_normal((Q, Dp)) * 2
        w = rng.standard_normal((R, Dp))
    return (torch.from_numpy(np.ascontiguousarray(q, np.float32)).cuda(),
            torch.from_numpy(np.ascontiguousarray(w, np.float32)).cuda())


def hamming_case(torch, Q, R, W, layout):
    """(q, r) int32 word operands on the card for one hamming_pop case."""
    g = torch.Generator().manual_seed(Q * 1000 + R + W)

    def words(rows):
        flat = torch.randint(-2**31, 2**31, (rows * W + 1,), generator=g,
                             dtype=torch.int64).to(torch.int32).cuda()
        # "offset": rows start one word past a 16-byte boundary
        return (flat[1:] if layout == "offset" else flat[:-1]).view(rows, W)

    q, r = words(Q), words(R)
    if layout == "zeros_ones":
        q, r = torch.zeros_like(q), torch.full_like(r, -1)
    elif layout == "same":
        r = q
    return q, r


def phase_kernels_vs_plain(torch, np):
    from repro_torch.core.hd.similarity import INT32_MIN, bitpack_bipolar
    from repro_torch.kernels.encode_search import (
        encode_search,
        encode_search_banded,
        encode_search_banded_plain,
        encode_search_plain,
    )
    from repro_torch.kernels.hamming_pop import hamming_pop, hamming_pop_plain
    from repro_torch.kernels.hd_encode import hd_encode, hd_encode_plain
    from repro_torch.kernels.imc_mvm import imc_mvm, imc_mvm_plain
    from repro_torch.kernels.topk_hamming import (
        topk_hamming,
        topk_hamming_banded,
        topk_hamming_banded_plain,
        topk_hamming_plain,
    )
    dev = torch.device("cuda")

    def bank(rng, rows, d, packed, dup=False):
        hv = rng.choice([-1, 1], size=(rows, d)).astype(np.int8)
        if dup:
            hv = np.concatenate([hv, hv, hv])
        t = torch.from_numpy(hv).to(dev)
        return bitpack_bipolar(t) if packed else t

    def codebooks(rng, Q, D):
        F, m = 300, 16
        idh = torch.from_numpy(rng.choice([-1, 1], size=(F, D)).astype(
            np.int8)).to(dev)
        lvh = torch.from_numpy(rng.choice([-1, 1], size=(m, D)).astype(
            np.int8)).to(dev)
        lev = rng.integers(0, m, size=(Q, F))
        lev[:, rng.random(F) < 0.7] = 0
        lev[0] = 0
        return torch.from_numpy(lev.astype(np.int32)).to(dev), idh, lvh

    def diff(got, want):
        return int((got[0] != want[0]).sum() + (got[1] != want[1]).sum())

    mismatches = dict.fromkeys(TPU_KERNELS, 0)
    for Q, R, D, packed, k, nv, dup in EDGE_CASES:
        rng = np.random.default_rng(Q * 1000 + R + D)
        r = bank(rng, R // 3 if dup else R, D, packed, dup)
        q = bank(rng, Q, D, packed)
        mismatches["topk_hamming"] += diff(
            topk_hamming(q, r, dim=D, k=k, num_valid=nv),
            topk_hamming_plain(q, r, dim=D, k=k, num_valid=nv))
        lev, idh, lvh = codebooks(rng, Q, D)
        mismatches["encode_search"] += diff(
            encode_search(lev, idh, lvh, r, dim=D, k=k, num_valid=nv),
            encode_search_plain(lev, idh, lvh, r, dim=D, k=k, num_valid=nv))
    for Q, R, D, packed, k, nv, dup, kind, nt in BANDED_EDGE_CASES:
        rng = np.random.default_rng(Q * 1000 + R + D + 1)
        r = bank(rng, R // 3 if dup else R, D, packed, dup)
        q = bank(rng, Q, D, packed)
        starts, lens, nt = banded_case(np, rng, Q, r.shape[0], kind, nt)
        starts = torch.from_numpy(starts).to(dev)
        lens = torch.from_numpy(lens).to(dev)
        want = topk_hamming_banded_plain(q, r, starts, lens, dim=D, k=k,
                                         num_valid=nv)
        mismatches["topk_hamming_banded"] += diff(
            topk_hamming_banded(q, r, starts, lens, dim=D, k=k, num_valid=nv,
                                num_tiles=nt), want)
        # without canonicalization only the fillers of INT32_MIN slots differ
        raw_i, raw_v = topk_hamming_banded(q, r, starts, lens, dim=D, k=k,
                                           num_valid=nv, num_tiles=nt,
                                           canonicalize=False)
        real = want[1] != INT32_MIN
        mismatches["topk_hamming_banded"] += int(
            (raw_v != want[1]).sum() + (raw_i[real] != want[0][real]).sum())
        lev, idh, lvh = codebooks(rng, Q, D)
        mismatches["encode_search_banded"] += diff(
            encode_search_banded(lev, idh, lvh, r, starts, lens, dim=D, k=k,
                                 num_valid=nv, num_tiles=nt),
            encode_search_banded_plain(lev, idh, lvh, r, starts, lens, dim=D,
                                       k=k, num_valid=nv))
    for Q, R, W, layout in HAMMING_EDGE_CASES:
        q, r = hamming_case(torch, Q, R, W, layout)
        mismatches["hamming_pop"] += int(
            (hamming_pop(q, r, dim=32 * W)
             != hamming_pop_plain(q, r, dim=32 * W)).sum())
    for B, F, D, m, layout, bb, bd in HD_ENCODE_EDGE_CASES:
        lev, idh, lvh = hd_encode_case(torch, np, B, F, D, m, layout)
        mismatches["hd_encode"] += int(
            (hd_encode(lev, idh, lvh, block_b=bb, block_d=bd)
             != hd_encode_plain(lev, idh, lvh)).sum())
    for Q, R, Dp, kind, fs, tc, bq, br in IMC_EDGE_CASES:
        q, w = imc_case(torch, np, Q, R, Dp, kind)
        mismatches["imc_mvm"] += int(
            (imc_mvm(q, w, full_scale=fs, tile_cols=tc, block_q=bq,
                     block_r=br)
             != imc_mvm_plain(q, w, full_scale=fs, tile_cols=tc)).sum())
    torch.cuda.synchronize()
    print(f"kernels vs plain: {len(EDGE_CASES)} exact, "
          f"{len(BANDED_EDGE_CASES)} banded, {len(HAMMING_EDGE_CASES)} "
          f"hamming_pop, {len(HD_ENCODE_EDGE_CASES)} hd_encode and "
          f"{len(IMC_EDGE_CASES)} imc_mvm cases, mismatches "
          f"{json.dumps(mismatches)}")
    check(not any(mismatches.values()), "kernel disagrees with its plain "
                                         "version")


def phase_tune(torch, np):
    """The autotuner at the served shapes, then ``hd_encode`` and
    ``imc_mvm`` timed at the sweep's shapes; returns their kernel entries."""
    import gc
    import os
    import tempfile

    import torch.nn.functional as nnf

    from repro_torch.kernels.encode_search import (
        encode_search,
        encode_search_banded,
    )
    from repro_torch.kernels.hd_encode import hd_encode, hd_encode_plain
    from repro_torch.kernels.imc_mvm import imc_mvm, imc_mvm_plain
    from repro_torch.kernels.topk_hamming import (
        topk_hamming,
        topk_hamming_banded,
    )
    from repro_torch.launch import roofline, tune
    from repro_torch.tune import sweep
    from repro_torch.tune import table as tune_table
    from repro_torch.tune.microbench import burst_seconds

    swept = {"topk_hamming": topk_hamming,
             "topk_hamming_banded": topk_hamming_banded,
             "encode_search": encode_search,
             "encode_search_banded": encode_search_banded,
             "hd_encode": hd_encode, "imc_mvm": imc_mvm}
    check(tuple(swept) == sweep.OPS, "chip_smoke's swept kernels are not "
                                      "the sweep's ops")
    tune_table.reset()
    for fn in swept.values():
        fn.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "table.json")
        t0 = time.perf_counter()
        table = tune.main(["--out", out, "--iters", "3"])
        wall = time.perf_counter() - t0
        launches = {op: fn.launches for op, fn in swept.items()}
        loaded = tune_table.load_table(out)
    ratio = sweep.tuned_vs_default_ratio(table)
    ops = {}
    rejected = 0
    for op, buckets in table.ops.items():
        for bucket, e in buckets.items():
            rejected += sum("rejected" in c for c in e["candidates"])
            ops[op] = {"bucket": bucket, "default_us": e["default_us"],
                       "default_spread": e["default_spread"],
                       "tuned_us": e["us"], "blocks": e["blocks"],
                       "candidates": len(e["candidates"])}
    ceil = table.ceilings
    print(json.dumps({
        "path": "tune", "wall_s": wall, "device_kind": table.device_kind,
        "ceilings": {"peak_flops_fp32": ceil["peak_flops_fp32"],
                     "hbm_bw": ceil["hbm_bw"], "matmul": ceil["matmul"]},
        "published": {"peak_flops_bf16": roofline.PEAK_FLOPS,
                      "peak_flops_fp32": roofline.PEAK_FLOPS_FP32,
                      "hbm_bw": roofline.HBM_BW},
        "ops": ops, "launches": launches, "rejected_candidates": rejected,
        "worst_tuned_vs_default": ratio}))
    check(all(launches[op] > 0 for op in swept),
          f"a swept kernel was never launched on the tune path: {launches}")
    check(loaded is not None and set(loaded.ops) == set(swept)
          and loaded.device_kind == torch.cuda.get_device_name(0),
          "the written table does not load back whole")
    check(rejected == 0, "a sweep candidate differs from the default's "
                         "result")
    check(ratio >= 1.0, f"worst tuned-vs-default ratio {ratio} < 1.0")
    # the serving phases run on the fixed rules
    check(tune_table.active_table() is None
          and not os.environ.get(tune_table.ENV_VAR),
          "a tuning table is active after the sweep")

    entries = []
    lev, idh, lvh, words = sweep.encoder_operands(False, "cuda")
    B, F = lev.shape
    D = idh.shape[1]
    got = hd_encode(lev, idh, lvh, codebook_words=words)
    want = hd_encode_plain(lev, idh, lvh)
    mism = int((got != want).sum())
    check(mism == 0, "hd_encode differs from its plain version at the "
                     "sweep's shape")
    ms = time_ms(torch, lambda: hd_encode(lev, idh, lvh,
                                          codebook_words=words),
                 iters=200, warmup=5)
    # the kernel alone: the same 200 launches queued behind a device wait
    dev_ms = 1e3 * sorted(burst_seconds(
        lambda: hd_encode(lev, idh, lvh, codebook_words=words),
        torch.device("cuda"), calls=200, iters=3))[1]
    plain_ms = time_ms(torch, lambda: hd_encode_plain(lev, idh, lvh),
                       iters=2, warmup=1)
    n_present = int((lev > 0).sum())
    b_ms, b_by = bound_ms(2 * n_present * D,
                          lev.numel() * 4 + sum(w.numel() * 4 for w in words)
                          + B * D)
    print(f"tune: hd_encode at B={B}, F={F}, D={D} ({n_present} present "
          f"bins): {ms:.4f} ms per launch (200 back to back; "
          f"{dev_ms:.4f} ms with the host's issue hidden), plain "
          f"{plain_ms:.2f} ms, bound {b_ms:.6f} ms ({b_by}); kernel vs "
          f"plain: {mism} mismatches; no single PyTorch call computes Eq. 1 "
          f"with its sign; sm clock, power, limit: "
          f"{nvidia_smi('clocks.sm,power.draw,power.limit')}")
    entries.append({
        "name": "hd_encode", "route": "cuda",
        "source": "src/repro_torch/csrc/hd_encode.cu",
        "replaces": TPU_KERNELS["hd_encode"],
        "launches": launches["hd_encode"], "mismatches": mism,
        "max_abs_err": int((got.to(torch.int32) - want.to(torch.int32))
                           .abs().max()),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None, "device_ms": dev_ms,
        "shape": f"B={B}, F={F}, D={D} (tune sweep)"})
    del lev, idh, lvh, words, got, want

    qf, wf, fs = sweep.imc_operands(False, "cuda")
    Q, Dp = qf.shape
    R = wf.shape[0]
    got = imc_mvm(qf, wf, full_scale=fs)
    t0 = time.perf_counter()
    want = imc_mvm_plain(qf, wf, full_scale=fs)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    mism = int((got != want).sum())
    max_abs_err = float((got - want).abs().max())
    check(bool(torch.isfinite(got).all()), "imc_mvm gave non-finite scores")
    check(mism == 0, "imc_mvm differs from its plain version at the sweep's "
                     "shape")
    del want
    ms = time_ms(torch, lambda: imc_mvm(qf, wf, full_scale=fs), iters=10,
                 warmup=2)
    # the yardstick: the same tile dot products as one float32 batched
    # matmul (TF32 off), no DAC or ADC; its layouts made beforehand
    T = -(-Dp // 128)
    pad = T * 128 - Dp
    q3 = nnf.pad(qf.round().clamp(-3, 3), (0, pad)).view(Q, T, 128)
    q3 = q3.transpose(0, 1).contiguous()
    w3 = nnf.pad(wf, (0, pad)).view(R, T, 128).permute(1, 2, 0).contiguous()
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        lib_ms = time_ms(torch, lambda: torch.matmul(q3, w3), iters=10,
                         warmup=2)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    del q3, w3
    b_ms, b_by = bound_ms(2 * Q * R * Dp, (Q + R) * Dp * 4 + Q * R * 4,
                          FP32_OPS_PER_S)
    print(f"tune: imc_mvm at Q={Q}, R={R}, Dp={Dp} ({wf.numel() * 4 / 1e9:.3f}"
          f" GB of weights): {ms:.4f} ms, plain {plain_ms:.1f} ms (one "
          f"call), float32 torch.matmul over the same tile dot products "
          f"(TF32 off, no ADC) {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
          f"{2 * Q * R * Dp:.4g} float32 ops at {FP32_OPS_PER_S:.3g}/s, "
          f"{(Q + R) * Dp * 4 + Q * R * 4:.4g} B); kernel vs plain: {mism} "
          f"mismatches; sm clock, power, limit: "
          f"{nvidia_smi('clocks.sm,power.draw,power.limit')}")
    entries.append({
        "name": "imc_mvm", "route": "cuda",
        "source": "src/repro_torch/csrc/imc_mvm.cu",
        "replaces": TPU_KERNELS["imc_mvm"], "launches": launches["imc_mvm"],
        "mismatches": mism, "max_abs_err": max_abs_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms,
        "library": f"float32 torch.matmul ({T}, {Q}, 128) x ({T}, 128, "
                   f"{R}), TF32 off, no ADC",
        "shape": f"Q={Q}, R={R}, Dp={Dp} (tune sweep)"})
    del qf, wf, got
    gc.collect()
    torch.cuda.empty_cache()
    return entries


def recording_executor(rows: int):
    """A ``SearchExecutor`` subclass that keeps the device batch, bank,
    encoder, results and OMS plan of the first served batch of ``rows``
    queries."""
    from repro_torch.serve import SearchExecutor

    class Recording(SearchExecutor):
        got = None

        def dispatch(self, reqs):
            h = super().dispatch(reqs)
            if Recording.got is None and h.n == rows:
                Recording.got = (h.db, self.server.encoder, h.batch.clone(),
                                 h.idx.clone(), h.vals.clone(), h.plan)
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


def bound_ms(ops: float, nbytes: float, ops_per_s: float = INT8_OPS_PER_S
             ) -> tuple[float, str]:
    """The least time the card could take, in ms: the larger of ``ops``
    at ``ops_per_s`` (by default the int8 tensor-core peak: the search
    score and Eq. 1 are +-1 products, which int8 tensor cores compute
    exactly) and ``nbytes`` at HBM bandwidth."""
    t_ops = ops / ops_per_s
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def popc_pipe_ms(popc: float, sms: int) -> float:
    """This design's own ceiling: ``popc`` POPCs at 16 per clock per SM
    and the card's maximum SM clock, in ms."""
    clock_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    return 1e3 * popc / (POPC_PER_CLOCK_PER_SM * sms * clock_hz)


def band_rows(starts, lens):
    """Distinct rows inside any band of a (B, Q) plan."""
    iv = sorted((int(a), int(a + n)) for a, n in zip(starts.ravel(),
                                                      lens.ravel()) if n > 0)
    total, hi = 0, -1
    for a, b in iv:
        if b > hi:
            total += b - max(a, hi)
            hi = b
    return total


def design_rows(starts, lens, block=8):
    """Rows the banded kernels read: per 8-query block and band, the span
    from its lowest band start to its highest band end (non-empty bands)."""
    total = 0
    for b in range(starts.shape[0]):
        for i in range(0, starts.shape[1], block):
            s, n = starts[b, i:i + block], lens[b, i:i + block]
            if (n > 0).any():
                total += int((s + n)[n > 0].max() - s[n > 0].min())
    return total


def phase_serve(torch, np, fused_e2e: bool, oms: bool):
    import dataclasses
    import gc

    from repro_torch.kernels.encode_search import (
        encode_search,
        encode_search_banded,
        encode_search_banded_plain,
        encode_search_plain,
    )
    from repro_torch.kernels.topk_hamming import (
        topk_hamming,
        topk_hamming_banded,
        topk_hamming_banded_plain,
        topk_hamming_plain,
    )
    from repro_torch.launch import serve_db
    from repro_torch.serve import (
        oms_search_encoded,
        oms_search_levels,
        search_database_encoded,
        search_database_levels,
    )

    route = "fused-e2e" if fused_e2e else "fused"
    path = f"oms {route}" if oms else route
    kernel = ("encode_search" if fused_e2e else "topk_hamming") + (
        "_banded" if oms else "")
    recorder = recording_executor(MAX_BATCH)
    argv = ["--hd-dim", str(DIM), "--identities", str(IDENTITIES),
            "--refs-per-identity", str(REPLICATES), "--queries",
            str(QUERIES), "--k", str(K), "--max-batch", str(MAX_BATCH),
            "--device", "cuda", f"--{route}"] + (["--oms"] if oms else [])
    gc.collect()  # an earlier run's server and banks sit in reference cycles
    torch.cuda.reset_peak_memory_stats()
    for fn in serve_db.KERNELS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    s = serve_db.main(argv, executor_cls=recorder)
    launches = {n: fn.launches for n, fn in serve_db.KERNELS.items()}
    wall = time.perf_counter() - t0
    line = {
        "path": path, "queries": s["count"], "qps": s["qps"],
        "p50_ms": s["p50_ms"], "p95_ms": s["p95_ms"],
        "identified_at_fdr": s["identified"], "correct": s["correct"],
        "library_s": s["library_s"], "bank_build_s": s["bank_build_s"],
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": launches, "batches": s["batches"],
        "buckets": s["buckets"], "span_s": s["span_s"],
        "sleep_s": s["sleep_s"], "device_busy_s": s["device_busy_s"],
        "host_s": s["span_s"] - s["sleep_s"] - s["device_busy_s"],
        "run_s": wall}
    if oms:
        line.update({key: s["oms"][key] for key in (
            "candidate_fraction", "scanned_fraction", "no_candidate")},
            iprg2012_candidate_fraction=IPRG_CANDIDATE_FRACTION)
    print(json.dumps(line))
    check(launches[kernel] > 0, f"{kernel} never launched on the {path} path")
    check(s["count"] == QUERIES, f"{path}: served {s['count']} of {QUERIES}")
    check(recorder.got is not None, f"{path}: no served batch of {MAX_BATCH}")

    db, enc, batch, idx, vals, plan = recorder.got
    R, W = db.data.shape
    unfused = dataclasses.replace(db, fused=False)
    # each smaller served bucket: its first rows, and on OMS evenly spaced
    # rows of the sorted batch (a batch of n sorted queries spans the mass
    # range as the 32 do)
    sel = {n: torch.arange(0, MAX_BATCH, MAX_BATCH // n, device=batch.device)
           for n in [*sorted(s["buckets"]), MAX_BATCH] if n <= MAX_BATCH}
    n_present = int((batch > 0).sum()) if fused_e2e else 0
    cb_bytes = (sum(w.numel() * 4 for w in enc.codebook_words)
                if fused_e2e else 0)
    if oms:
        starts = torch.from_numpy(plan.starts).to(batch.device)
        lens = torch.from_numpy(plan.lens).to(batch.device)
        args = {n: (batch[i].contiguous(), starts[:, i].contiguous(),
                    lens[:, i].contiguous()) for n, i in sel.items()}
        if fused_e2e:
            def run(n=MAX_BATCH, canonicalize=False):
                b, st, ln = args[n]
                return encode_search_banded(
                    b, enc.id_hvs, enc.level_hvs, db.data, st, ln, dim=db.dim,
                    k=K, num_valid=db.num_rows, num_tiles=plan.num_tiles,
                    canonicalize=canonicalize,
                    codebook_words=enc.codebook_words)

            def plain():
                return encode_search_banded_plain(
                    batch, enc.id_hvs, enc.level_hvs, db.data, starts, lens,
                    dim=db.dim, k=K, num_valid=db.num_rows)

            served = oms_search_levels(unfused, enc, batch, plan, K)

            def route():
                return oms_search_levels(db, enc, batch, plan, K,
                                         fused_e2e=True)
        else:
            def run(n=MAX_BATCH, canonicalize=False):
                b, st, ln = args[n]
                return topk_hamming_banded(
                    b, db.data, st, ln, dim=db.dim, k=K,
                    num_valid=db.num_rows, num_tiles=plan.num_tiles,
                    canonicalize=canonicalize)

            def plain():
                return topk_hamming_banded_plain(batch, db.data, starts, lens,
                                                 dim=db.dim, k=K,
                                                 num_valid=db.num_rows)

            served = oms_search_encoded(unfused, batch, plan, K)

            def route():
                return oms_search_encoded(db, batch, plan, K)
        cand = int(plan.lens.sum())
        union = band_rows(plan.starts, plan.lens)
        ops = 2 * (cand + n_present) * db.dim
        popc = (cand + n_present) * W
        nbytes = (batch.numel() * batch.element_size() + cb_bytes
                  + union * W * 4 + 2 * plan.starts.nbytes
                  + 2 * MAX_BATCH * K * 4)
        fetched = design_rows(plan.starts, plan.lens) * W * 4
        priced = (-(-MAX_BATCH // 8) * plan.starts.shape[0] * plan.num_tiles
                  * 128 * W * 4)
        extra = (f"; {cand} candidate rows over {plan.starts.shape[0]} bands "
                 f"(candidate fraction {plan.candidate_fraction:.4f}, plan "
                 f"num_tiles {plan.num_tiles}, scanned fraction "
                 f"{plan.scanned_fraction:.4f}), {union} distinct band rows; "
                 f"this design reads {fetched / 1e9:.4g} GB (the plan's "
                 f"budget prices {priced / 1e9:.4g} GB)")
    else:
        if fused_e2e:
            def run(n=MAX_BATCH, canonicalize=None):
                return encode_search(batch[:n], enc.id_hvs,
                                     enc.level_hvs, db.data, dim=db.dim, k=K,
                                     num_valid=db.num_rows,
                                     codebook_words=enc.codebook_words)

            def plain():
                return encode_search_plain(batch, enc.id_hvs, enc.level_hvs,
                                           db.data, dim=db.dim, k=K,
                                           num_valid=db.num_rows)

            def route():
                return search_database_levels(db, enc, batch, K,
                                              fused_e2e=True)

        else:
            def run(n=MAX_BATCH, canonicalize=None):
                return topk_hamming(batch[:n], db.data, dim=db.dim, k=K,
                                    num_valid=db.num_rows)

            def plain():
                return topk_hamming_plain(batch, db.data, dim=db.dim, k=K,
                                          num_valid=db.num_rows)

            def route():
                return search_database_encoded(db, batch, K)

        served = None  # the plain version is the plain route here
        ops = 2 * (MAX_BATCH * R + n_present) * db.dim
        popc = MAX_BATCH * R * W + n_present * W
        nbytes = (batch.numel() * 4 + cb_bytes + db.data.numel() * 4
                  + 2 * MAX_BATCH * K * 4)
        extra = ""
    p_idx, p_vals = plain()
    if served is None:
        served = p_idx, p_vals
    served_diff = int((served[0] != idx).sum() + (served[1] != vals).sum())
    k_idx, k_vals = run(canonicalize=True)
    max_abs_err = int((k_vals.to(torch.int64) - p_vals.to(torch.int64))
                      .abs().max())
    mismatches = int((k_idx != p_idx).sum() + (k_vals != p_vals).sum())
    print(f"{path}: served batch of {MAX_BATCH} vs the "
          f"{'unfused masked' if oms else 'plain'} route on the card: "
          f"{served_diff} differing entries; kernel vs plain: {mismatches}")
    check(served_diff == 0, f"{path}: served batch differs from the route")
    check(mismatches == 0, f"{path}: {kernel} differs from its plain version")

    ms = time_ms(torch, run, iters=20, warmup=2)
    bucket_ms = {n: time_ms(torch, lambda n=n: run(n), iters=20, warmup=2)
                 for n in sel if n < MAX_BATCH}
    # the served route on the same batch: the kernel plus the route's own
    # tensor work around it (bands, merge, overflow slots, permutation)
    route_ms = time_ms(torch, route, iters=20, warmup=2)
    plain_ms = time_ms(torch, plain, iters=2, warmup=0)
    clocks = nvidia_smi("clocks.sm,power.draw,power.limit")
    b_ms, b_by = bound_ms(ops, nbytes)
    popc_ms = popc_pipe_ms(
        popc, torch.cuda.get_device_properties(0).multi_processor_count)
    print(f"{path}: {kernel} {ms:.4f} ms (the served route around it "
          f"{route_ms:.4f} ms), plain {plain_ms:.2f} ms, bound "
          f"{b_ms:.4f} ms ({b_by}; {ops:.4g} int8 ops, {nbytes:.4g} B), "
          f"this design's POPC-pipe {'floor' if oms else 'ceiling'} "
          f"{popc_ms:.4f} ms ({popc:.4g} POPC) at Q={MAX_BATCH}, R={R}"
          + (f", {n_present} present bins in the batch" if fused_e2e else "")
          + extra + f"; by served bucket (Q: ms) {json.dumps(bucket_ms)}; "
          f"sm clock, power, limit: {clocks}")
    return {
        "name": kernel, "route": "cuda",
        "source": f"src/repro_torch/csrc/{kernel.removesuffix('_banded')}.cu",
        "replaces": TPU_KERNELS[kernel], "launches": launches[kernel],
        "mismatches": mismatches, "max_abs_err": max_abs_err,
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by,
        # no single PyTorch call computes a streaming top-k by Hamming
        # distance (with or without the encode, banded or not)
        "library_ms": None,
    }


# the clustering configuration: two tenants, each streaming one
# paper-average precursor bucket (core/imc/energy.py: 10,624 spectra,
# here 1,328 identities x 8 replicates) at D = 2048, 1024 bins, 16 levels,
# threshold 0.36 D, max batch 32 (4 buckets), 5 ms flush
CLUSTER_IDENTITIES, CLUSTER_REPLICATES, CLUSTER_DIM = 1328, 8, 2048
CLUSTER_ARGV = ["--identities", str(CLUSTER_IDENTITIES),
                "--spectra-per-identity", str(CLUSTER_REPLICATES),
                "--tenants", "2", "--consolidate-every", "2048",
                "--device", "cuda"]


def cluster_recorder():
    """A ``SearchExecutor`` subclass that keeps the server and, per
    finalized clustering batch, (tenant, HVs, assignments)."""
    from repro_torch.serve import SearchExecutor

    class Recording(SearchExecutor):
        server = None
        batches = []

        def _dispatch_cluster(self, reqs, tenant):
            Recording.server = self.server
            return super()._dispatch_cluster(reqs, tenant)

        def _finalize_cluster(self, handle):
            live = super()._finalize_cluster(handle)
            Recording.batches.append((handle.tenant,
                                      handle.hvs[:handle.n].copy(),
                                      [r.result for r in handle.reqs]))
            return live

    return Recording


def unpacked_int_mm_ms(torch, a, b):
    """``torch._int_mm`` of two unpacked int8 operands (the same function
    up to (D + dot) / 2), with its rows padded to a multiple of 8 (and
    above 16) as the call requires; returns (ms, padded shape)."""
    def pad(t, mult, least=0):
        rows = max(least, -(-t.shape[0] // mult) * mult)
        return torch.nn.functional.pad(t, (0, 0, 0, rows - t.shape[0]))

    a8, b8 = pad(a, 8, 17), pad(b, 8)
    return (time_ms(torch, lambda: torch._int_mm(a8, b8.t()), iters=20,
                    warmup=2), (a8.shape[0], b8.shape[0]))


def phase_serve_cluster(torch, np):
    import gc

    from repro_torch.core.hd.clustering import cross_distances
    from repro_torch.core.hd.similarity import bitpack_bipolar
    from repro_torch.kernels.hamming_pop import hamming_pop, hamming_pop_plain
    from repro_torch.launch import serve_cluster
    from repro_torch.serve import StreamingClusterer

    recorder = cluster_recorder()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    hamming_pop.launches = 0
    t0 = time.perf_counter()
    s = serve_cluster.main(CLUSTER_ARGV, executor_cls=recorder)
    launches = hamming_pop.launches
    wall = time.perf_counter() - t0
    total = 2 * CLUSTER_IDENTITIES * CLUSTER_REPLICATES
    server = recorder.server
    line = {
        "path": "serve_cluster", "spectra": s["count"], "spectra_per_s":
        s["qps"], "p50_ms": s["p50_ms"], "p95_ms": s["p95_ms"],
        "batches": s["batches"], "buckets": s["buckets"],
        "launches": {"hamming_pop": launches},
        "tenants": {t: {k: q[k] for k in (
            "clusters", "spawned", "merges", "consolidations",
            "clustered_ratio", "incorrect_ratio")}
            for t, q in s["cluster_quality"].items()},
        "span_s": s["span_s"], "sleep_s": s["sleep_s"],
        "device_busy_s": s["device_busy_s"], "decide_s": s["decide_s"],
        "consolidate_s": s["consolidate_s"],
        "other_host_s": (s["span_s"] - s["sleep_s"] - s["device_busy_s"]
                         - s["decide_s"] - s["consolidate_s"]),
        "library_s": s["library_s"],
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "run_s": wall}
    print(json.dumps(line))
    check(launches > 0, "hamming_pop never launched on the serve_cluster path")
    check(s["count"] == total, f"serve_cluster: served {s['count']} of {total}")

    # the same batches, in the same order, through clusterers whose
    # distance step is the plain version, on the card
    t0 = time.perf_counter()
    replay = {}
    differing = 0
    for tenant, hvs, want in recorder.batches:
        cl = replay.get(tenant)
        if cl is None:
            cl = replay[tenant] = StreamingClusterer(
                server.clustering, "cuda", hamming=hamming_pop_plain)
        c0, version = cl.num_clusters, cl.struct_version
        d = cl.snapshot_distances(hvs)
        got = cl.assign_batch(hvs, None if d is None else d.cpu().numpy(),
                              c0, version)
        differing += sum((a.cluster_id, a.spawned, a.distance)
                         != (b.cluster_id, b.spawned, b.distance)
                         for a, b in zip(got, want))
    same_state = all(replay[t].summary() == server.clusterers[t].summary()
                     for t in server.clusterers)
    print(f"serve_cluster: {len(recorder.batches)} recorded batches replayed "
          f"through the plain distance function on the card in "
          f"{time.perf_counter() - t0:.2f} s: {differing} differing "
          f"assignment entries, tenant summaries equal: {same_state}")
    check(differing == 0 and same_state,
          "serve_cluster differs from its plain-path replay")

    # the served shape: each bucket against the largest final centroid bank
    tenant = max(server.clusterers,
                 key=lambda t: server.clusterers[t].num_clusters)
    cl = server.clusterers[tenant]
    bank = cl.device_bank()
    C, W = bank.shape
    hv32 = next(h for t, h, _ in recorder.batches
                if t == tenant and len(h) == 32)
    q = bitpack_bipolar(torch.from_numpy(hv32).cuda())
    want = hamming_pop_plain(q, bank, dim=CLUSTER_DIM)
    got = hamming_pop(q, bank, dim=CLUSTER_DIM)
    max_abs_err = int((got.to(torch.int64) - want.to(torch.int64))
                      .abs().max())
    mismatches = int((got != want).sum())
    check(mismatches == 0, "hamming_pop differs from its plain version at "
                           "the served shape")
    ms = {n: time_ms(torch, lambda n=n: hamming_pop(q[:n], bank,
                                                     dim=CLUSTER_DIM),
                     iters=200, warmup=5) for n in (4, 8, 16, 32)}
    plain_ms = time_ms(torch, lambda: hamming_pop_plain(q, bank,
                                                         dim=CLUSTER_DIM),
                       iters=5, warmup=1)
    # a served batch's distance step, whole and by piece: the events take
    # in the host's launch gaps between the small kernels
    pack_ms = time_ms(torch, lambda: bitpack_bipolar(
        torch.from_numpy(hv32).cuda()), iters=50, warmup=2)
    dist_ms = time_ms(torch, lambda: cross_distances(q, bank,
                                                     dim=CLUSTER_DIM),
                      iters=50, warmup=2)

    def served_step():
        cl._dirty.update(range(32))  # as after a batch that touched 32 rows
        return cl.snapshot_distances(hv32)

    step_ms = time_ms(torch, served_step, iters=50, warmup=2)
    print(f"serve_cluster: one served distance step (32 changed centroid "
          f"rows rewritten, the batch copied and packed, hamming_pop, the "
          f"float distances) {step_ms:.4f} ms; of it, copying and packing "
          f"32 HVs {pack_ms:.4f} ms and the distances from packed words "
          f"{dist_ms:.4f} ms")
    cent = torch.from_numpy(cl._cent.copy()).cuda()
    lib_ms, lib_shape = unpacked_int_mm_ms(
        torch, torch.from_numpy(hv32).cuda(), cent)
    ops = 2 * 32 * C * CLUSTER_DIM
    nbytes = (32 + C) * W * 4 + 32 * C * 4
    b_ms, b_by = bound_ms(ops, nbytes)
    print(f"serve_cluster: hamming_pop at the served shape against "
          f"{tenant}'s final {C} centroids ({W} words): by bucket (Q: ms) "
          f"{json.dumps(ms)}, plain {plain_ms:.4f} ms, torch._int_mm on the "
          f"unpacked operands {lib_ms:.4f} ms (padded to {lib_shape}), "
          f"bound {b_ms:.6f} ms ({b_by}; {ops:.4g} int8 ops, {nbytes:.4g} "
          f"B) at Q=32; kernel vs plain: {mismatches} mismatches; sm "
          f"clock, power, limit: {nvidia_smi('clocks.sm,power.draw,power.limit')}")
    return {
        "name": "hamming_pop", "route": "cuda",
        "source": "src/repro_torch/csrc/hamming_pop.cu",
        "replaces": TPU_KERNELS["hamming_pop"], "launches": launches,
        "mismatches": mismatches, "max_abs_err": max_abs_err,
        "ms": ms[32], "plain_ms": plain_ms, "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": lib_ms,
        "shape": f"Q=32 x C={C}, W={W} (served)", "served_step_ms": step_ms,
    }


def phase_bucket(torch, np, entry):
    """One paper-average bucket batch-wise: the kernel's pairwise distances
    and complete linkage at 0.36 D, against the same pipeline over the
    plain distance function; adds the pairwise shape's numbers to the
    kernel's ``entry``."""
    from repro_torch.core import SpecPCMConfig, encode_and_pack
    from repro_torch.core.hd.clustering import (
        complete_linkage,
        pairwise_distances,
    )
    from repro_torch.core.hd.similarity import bitpack_bipolar
    from repro_torch.kernels.hamming_pop import hamming_pop, hamming_pop_plain
    from repro_torch.spectra import SyntheticMSConfig, generate_dataset

    n = CLUSTER_IDENTITIES * CLUSTER_REPLICATES
    ds = generate_dataset(SyntheticMSConfig(
        num_identities=CLUSTER_IDENTITIES,
        spectra_per_identity=CLUSTER_REPLICATES, num_bins=1024, seed=0),
        device="cuda")
    hv = encode_and_pack(ds.spectra, SpecPCMConfig(
        hd_dim=CLUSTER_DIM, mlc_bits=1, num_levels=16, ideal=True, seed=0))
    del ds
    words = bitpack_bipolar(hv)
    W = words.shape[1]
    thr = 0.36 * CLUSTER_DIM
    k_ms = time_ms(torch, lambda: hamming_pop(words, words, dim=CLUSTER_DIM),
                   iters=10, warmup=2)
    p_ms = time_ms(torch, lambda: hamming_pop_plain(words, words,
                                                     dim=CLUSTER_DIM),
                   iters=1, warmup=0)
    lib_ms, lib_shape = unpacked_int_mm_ms(torch, hv, hv)
    ops = 2 * n * n * CLUSTER_DIM
    nbytes = n * W * 4 + n * n * 4
    b_ms, b_by = bound_ms(ops, nbytes)
    popc_ms = popc_pipe_ms(
        n * n * W, torch.cuda.get_device_properties(0).multi_processor_count)
    results, linkage_s = {}, {}
    for name, fn in (("kernel", None), ("plain", hamming_pop_plain)):
        dist = pairwise_distances(words, dim=CLUSTER_DIM, hamming=fn)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = complete_linkage(dist, thr)
        torch.cuda.synchronize()
        linkage_s[name] = time.perf_counter() - t0
        results[name] = res
        del dist
    a, b = results["kernel"], results["plain"]
    same = (torch.equal(a.labels, b.labels) and a.num_merges == b.num_merges
            and a.num_clusters == b.num_clusters)
    print(f"bucket: N={n} (the paper's average precursor bucket), D="
          f"{CLUSTER_DIM}, threshold {thr:g}: hamming_pop pairwise "
          f"{k_ms:.4f} ms (Q=R={n}, W={W}), plain {p_ms:.2f} ms, "
          f"torch._int_mm on the unpacked operands {lib_ms:.4f} ms (padded "
          f"to {lib_shape}), bound {b_ms:.4f} ms ({b_by}; {ops:.4g} int8 "
          f"ops, {nbytes:.4g} B), this design's POPC-pipe ceiling "
          f"{popc_ms:.4f} ms; complete linkage {linkage_s['kernel']:.2f} s "
          f"(plain-distance run {linkage_s['plain']:.2f} s), "
          f"{a.num_merges} merges, {a.num_clusters} clusters; labels, "
          f"merges and clusters equal to the plain pipeline: {same}")
    check(same, "linkage over kernel distances differs from the plain "
                "pipeline")
    entry.update(pairwise_ms=k_ms, pairwise_plain_ms=p_ms,
                 pairwise_bound_ms=b_ms, pairwise_bound_by=b_by,
                 pairwise_library_ms=lib_ms,
                 pairwise_shape=f"Q=R={n}, W={W}",
                 linkage_s=linkage_s["kernel"], linkage_merges=a.num_merges)


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
    tuned = phase_tune(torch, np)
    print(f"reduced: queries {QUERIES} per run of iPRG2012's {IPRG_QUERIES} "
          f"(time limit); bank rows {2 * IDENTITIES * REPLICATES} (full), "
          f"D={DIM}; the OMS window (-20, +200) over synthetic precursors "
          f"uniform on 400-1600 selects more of the bank than iPRG2012's "
          f"candidate fraction {IPRG_CANDIDATE_FRACTION}")
    kernels = [phase_serve(torch, np, fused_e2e=e2e, oms=oms)
               for oms in (False, True) for e2e in (False, True)]
    print(f"clustering: {CLUSTER_IDENTITIES} identities x "
          f"{CLUSTER_REPLICATES} spectra per tenant, one paper-average "
          f"bucket each (core/imc/energy.py), 2 tenants; not cut")
    entry = phase_serve_cluster(torch, np)
    phase_bucket(torch, np, entry)
    kernels.append(entry)
    kernels += tuned
    print(f"total: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
