"""Launch-knob sweeps for the port's CUDA kernels.

Counterpart of ``repro.tune.sweep``. For each op one representative
workload per shape bucket is timed under a small grid of candidate knobs
(the default always among them). The winner is persisted to the tuning
table only when every one of its timed samples beats every one of the
default's by :data:`WIN_MARGIN`: measurement noise never displaces the
default rule. Times are the device's (``microbench.burst_seconds``): the
wrappers' host work is not timed, so a launch-bound kernel is tuned on
its kernel.

Every candidate is passed as explicit knobs, so an already-active table
cannot steer the sweep that is about to replace it, and every candidate's
result is checked bit for bit against the default's before it may win:
tuning changes speed, never results.

Shapes. ``quick`` keeps the reference's quick shapes (the CPU tests run
them). The full sweep runs at the shapes the port serves on the card
(``chip_smoke.py``), so that its table entries are the ones a served call
looks up: a batch of Q = 32 against the 1,162,392-row, 256-word
iPRG2012-scale bank at k = 4 (the banded ops over ``plan_candidates``
bands of sorted synthetic precursors, window (-20, +200)); 1,024 bins,
16 levels, D = 8,192 for the encoders; and for ``imc_mvm`` 32 packed
queries against iPRG2012's 581,196 target rows (``run_db_search`` scores
targets and decoys in separate calls) at Dp = ceil(8192 / 3) = 2,731,
float32 (6.35 GB), full scale 135.76 (``default_full_scale(ArrayConfig())``
of the reference). :data:`FULL_REDUCED` lists what the full sweep cuts.

The banded ops hold up to 32 queries a block and sweep ``waves`` (blocks
per SM) only; ``imc_mvm``'s ``tile_cols`` is the PCM array's
column count and is never swept.
"""

from __future__ import annotations

import gc
import itertools

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.block_utils import DEFAULTS
from repro_torch.tune.microbench import burst_seconds, measure_ceilings
from repro_torch.tune.table import TuningTable, device_kind

WIN_MARGIN = 0.03  # a candidate's slowest sample must be >= 3% faster
                   # than the default's fastest to displace the default
CALLS = 5          # back-to-back calls per timed sample

OPS = ("topk_hamming", "topk_hamming_banded", "encode_search",
       "encode_search_banded", "hd_encode", "imc_mvm")

FULL_REDUCED = (
    "one bucket per op, Q = 32 (served buckets 4 / 8 / 16 keep the "
    "defaults); random bank words and codebooks; encoder levels with 5% of "
    "bins present; imc_mvm on iPRG2012's target half with synthetic packed "
    "levels times (1 + 0.1716 N(0, 1)) write noise")

# the reference's DeviceConfig() write-noise sigma and
# default_full_scale(ArrayConfig()) (core/imc/device.py, array.py)
NOISE_SIGMA = 0.17162239539435153
FULL_SCALE = 135.76450198781714

# candidate grids: knob -> values (the default is always added)
_GRIDS_QUICK: dict[str, dict[str, tuple[int, ...]]] = {
    "topk_hamming": {"block_q": (8, 32), "waves": (2, 4)},
    "topk_hamming_banded": {"waves": (2, 8)},
    "encode_search": {"block_q": (8, 32), "waves": (2, 4)},
    "encode_search_banded": {"waves": (2, 8)},
    "hd_encode": {"block_b": (1, 4), "block_d": (256, 1024)},
    "imc_mvm": {"block_q": (8, 32), "block_r": (64, 128)},
}

_GRIDS_FULL: dict[str, dict[str, tuple[int, ...]]] = {
    "topk_hamming": {"block_q": (8, 16, 32), "waves": (1, 2, 4, 8)},
    "topk_hamming_banded": {"waves": (1, 2, 4, 8, 16)},
    "encode_search": {"block_q": (8, 16, 32), "waves": (1, 2, 4, 8)},
    "encode_search_banded": {"waves": (1, 2, 4, 8, 16)},
    "hd_encode": {"block_b": (1, 2, 4),
                  "block_d": (256, 1024, 2048, 8192)},
    "imc_mvm": {"block_q": (8, 16, 32, 64),
                "block_r": (32, 64, 128, 256)},
}


def _candidates(op: str, quick: bool) -> list[dict[str, int]]:
    grid = (_GRIDS_QUICK if quick else _GRIDS_FULL)[op]
    names = list(grid)
    cands = [dict(zip(names, vals))
             for vals in itertools.product(*(grid[n] for n in names))]
    default = dict(DEFAULTS[op])
    if default not in cands:
        cands.insert(0, default)
    return cands


def _words(rows: int, W: int, g: torch.Generator, dev: torch.device,
           chunk: int = 1 << 16) -> torch.Tensor:
    """(rows, W) int32 words of random bits, made on ``dev``."""
    out = torch.empty((rows, W), dtype=torch.int32, device=dev)
    for r0 in range(0, rows, chunk):
        n = min(chunk, rows - r0)
        out[r0:r0 + n] = torch.randint(-2**31, 2**31, (n, W), generator=g,
                                       device=dev, dtype=torch.int64)
    return out


def _bipolar(shape, g, dev) -> torch.Tensor:
    return (torch.randint(0, 2, shape, generator=g, device=dev,
                          dtype=torch.int8) * 2 - 1)


def encoder_operands(quick: bool, device: str | torch.device = "cuda"):
    """(levels (Q, F) int32, id_hvs (F, D), level_hvs (m, D), their packed
    words) of the encoder workloads, made on ``device`` from a fixed
    seed."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(12)
    q_n, dim, feats, levels_n = (32, 1024, 64, 16) if quick else (
        32, 8192, 1024, 16)
    lv = torch.randint(0, levels_n, (q_n, feats), generator=g, device=dev,
                       dtype=torch.int32)
    if not quick:   # 5% of bins present, as in the synthetic library
        present = torch.rand((q_n, feats), generator=g, device=dev) < 0.05
        lv = torch.where(present, lv.clamp(min=1), 0).to(torch.int32)
    id_hvs = _bipolar((feats, dim), g, dev)
    level_hvs = _bipolar((levels_n, dim), g, dev)
    from repro_torch.kernels.encode_search import pack_codebook
    return lv, id_hvs, level_hvs, (pack_codebook(id_hvs),
                                   pack_codebook(level_hvs))


def _oms_bands(q_n: int, r_n: int, rng: np.random.Generator):
    """(starts, lens, num_tiles) of one OMS batch: ``plan_candidates`` over
    a [decoys; targets] bank whose blocks are precursor-sorted (uniform on
    400-1600, decoys keeping their target's mass), for q_n sorted queries
    of which 30% carry a +60 to +150 modification; window (-20, +200)."""
    from repro_torch.serve.oms import (
        OMSConfig,
        build_precursor_index,
        plan_candidates,
    )
    prec = rng.uniform(400.0, 1600.0, r_n // 2).astype(np.float32)
    index = build_precursor_index(prec, prec)
    qp = rng.uniform(400.0, 1600.0, q_n)
    qp = qp + np.where(rng.random(q_n) < 0.3,
                       rng.uniform(60.0, 150.0, q_n), 0.0)
    plan = plan_candidates(index, np.sort(qp).astype(np.float32),
                           OMSConfig(), num_rows_padded=r_n, block_q=8)
    return plan.starts, plan.lens, plan.num_tiles


def imc_operands(quick: bool, device: str | torch.device = "cuda",
                 chunk: int = 1 << 16):
    """(queries (Q, Dp), weights (R, Dp), full_scale) of the ``imc_mvm``
    workload, float32, made on ``device`` from a fixed seed: packed
    queries in {-3, -1, 1, 3} (three random bipolar dims summed, as
    ``pack_dimensions`` packs them); weights such levels times
    (1 + sigma N(0, 1)) write noise. The quick shapes are the reference's
    (standard normal queries and weights)."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(12)
    if quick:   # the reference's quick shapes
        q_n, r_n, dp = 32, 512, 128
        qf = torch.randn((q_n, dp), generator=g, device=dev)
        wf = torch.randn((r_n, dp), generator=g, device=dev)
        return qf, wf, float(dp)
    q_n, r_n, dp = 32, 581_196, -(-8192 // 3)

    def packed(n):  # three bipolar dims summed: 2 * (ones of 3) - 3
        bits = torch.randint(0, 2, (n, dp, 3), generator=g, device=dev,
                             dtype=torch.int8)
        return (2 * bits.sum(-1, dtype=torch.int8) - 3).to(torch.float32)

    qf = packed(q_n)
    wf = torch.empty((r_n, dp), dtype=torch.float32, device=dev)
    for r0 in range(0, r_n, chunk):
        n = min(chunk, r_n - r0)
        wf[r0:r0 + n] = packed(n) * (1.0 + NOISE_SIGMA * torch.randn(
            (n, dp), generator=g, device=dev))
    return qf, wf, FULL_SCALE


def _workload(op: str, quick: bool, device: str | torch.device = "cuda"):
    """(shape, run) for one op: ``shape`` is the table's bucketing tuple,
    ``run(blocks)`` calls the op under explicit knobs and returns its
    result (for the bit-identity check)."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(12)
    rng = np.random.default_rng(12)
    if quick:   # the reference's quick shapes
        q_n, r_n, dim, k, feats = 32, 1024, 1024, 8, 64
    else:       # the served shapes
        q_n, r_n, dim, k, feats = 32, 1_162_392, 8192, 4, 1024
    W = dim // 32

    if op in ("topk_hamming", "topk_hamming_banded"):
        from repro_torch.kernels.topk_hamming import (
            topk_hamming,
            topk_hamming_banded,
        )
        q, r = _words(q_n, W, g, dev), _words(r_n, W, g, dev)
        if op == "topk_hamming":
            def run(blocks):
                return topk_hamming(q, r, dim=dim, k=k, **blocks)
            return (q_n, r_n, W), run
        starts, lens, nt = _band_plan(q_n, r_n, k, quick, rng)
        starts, lens = (torch.from_numpy(a).to(dev) for a in (starts, lens))

        def run(blocks):
            return topk_hamming_banded(q, r, starts, lens, dim=dim, k=k,
                                       num_tiles=nt, **blocks)
        return (q_n, r_n, W), run

    if op in ("encode_search", "encode_search_banded"):
        from repro_torch.kernels.encode_search import (
            encode_search,
            encode_search_banded,
        )
        lv, id_hvs, level_hvs, words = encoder_operands(quick, dev)
        bank = _words(r_n, W, g, dev)
        if op == "encode_search":
            def run(blocks):
                return encode_search(lv, id_hvs, level_hvs, bank, dim=dim,
                                     k=k, codebook_words=words, **blocks)
            return (q_n, r_n, feats), run
        starts, lens, nt = _band_plan(q_n, r_n, k, quick, rng)
        starts, lens = (torch.from_numpy(a).to(dev) for a in (starts, lens))

        def run(blocks):
            return encode_search_banded(lv, id_hvs, level_hvs, bank, starts,
                                        lens, dim=dim, k=k, num_tiles=nt,
                                        codebook_words=words, **blocks)
        return (q_n, r_n, feats), run

    if op == "hd_encode":
        from repro_torch.kernels.hd_encode import hd_encode
        lv, id_hvs, level_hvs, words = encoder_operands(quick, dev)

        def run(blocks):
            return hd_encode(lv, id_hvs, level_hvs, codebook_words=words,
                             **blocks)
        return (q_n, dim, feats), run

    if op == "imc_mvm":
        from repro_torch.kernels.imc_mvm import imc_mvm
        qf, wf, fs = imc_operands(quick, dev)

        def run(blocks):
            return imc_mvm(qf, wf, full_scale=fs, **blocks)
        return (qf.shape[0], wf.shape[0], qf.shape[1]), run

    raise ValueError(f"unknown op {op!r}")


def _band_plan(q_n: int, r_n: int, k: int, quick: bool,
               rng: np.random.Generator):
    """Bands of the banded workloads: the reference's quick bands (one
    random window of a quarter of the bank per query), or the OMS plan."""
    if not quick:
        return _oms_bands(q_n, r_n, rng)
    width = max(r_n // 4, k)
    starts = rng.integers(0, r_n - width, size=q_n).astype(np.int32)
    lens = np.full((q_n,), width, np.int32)
    return starts, lens, -(-width // 128) + 1


def _same_result(a, b) -> bool:
    la = list(a) if isinstance(a, (tuple, list)) else [a]
    lb = list(b) if isinstance(b, (tuple, list)) else [b]
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def _spread(samples: list[float]) -> float:
    """(slowest - fastest) / median of a candidate's samples."""
    med = float(np.median(samples))
    return (max(samples) - min(samples)) / med if med > 0 else 0.0


def sweep_op(op: str, *, quick: bool = True, iters: int = 3,
             device: str | torch.device = "cuda") -> dict:
    """Time every candidate knob set for ``op``'s workload.

    Returns ``{"shape", "blocks", "us", "default_us", "default_spread",
    "candidates"}``: ``blocks`` is the default unless a candidate was both
    bit-identical to it and faster in every sample, its slowest at least
    :data:`WIN_MARGIN` under the default's fastest (the fastest such
    median wins). Time per call: the median of ``iters`` samples of
    :data:`CALLS` back-to-back calls, after a warm-up; each candidate's
    spread, ``(slowest - fastest) / median``, is reported with it."""
    dev = resolve_device(device)
    shape, run = _workload(op, quick, dev)
    default = dict(DEFAULTS[op])
    oracle = run(default)

    def samples_us(blocks):
        return [1e6 * t for t in burst_seconds(lambda: run(blocks), dev,
                                               calls=CALLS, iters=iters)]

    base = samples_us(default)
    default_us = float(np.median(base))
    best, best_us = default, default_us
    report = []
    for cand in _candidates(op, quick):
        if cand == default:
            report.append({"blocks": cand, "us": default_us,
                           "spread": _spread(base)})
            continue
        if not _same_result(oracle, run(cand)):
            report.append({"blocks": cand, "us": None,
                           "rejected": "result mismatch vs default config"})
            continue
        got = samples_us(cand)
        t = float(np.median(got))
        report.append({"blocks": cand, "us": t, "spread": _spread(got)})
        if t < best_us and max(got) < min(base) * (1.0 - WIN_MARGIN):
            best, best_us = cand, t
    del run, oracle
    gc.collect()  # the workload's tensors (6.35 GB of imc_mvm weights)
    return {"shape": shape, "blocks": best, "us": best_us,
            "default_us": default_us, "default_spread": _spread(base),
            "candidates": report}


def build_tuning_table(out_path=None, *, quick: bool = True, ops=None,
                       iters: int = 3, skip_ceilings: bool = False,
                       device: str | torch.device = "cuda") -> TuningTable:
    """Measure ceilings, sweep every op, persist the winning knobs.

    The entries carry the measured ``us`` / ``default_us`` pair, the
    default's spread and each op's candidate report."""
    dev = resolve_device(device)
    ceilings = {} if skip_ceilings else measure_ceilings(quick=quick,
                                                          device=dev)
    table = TuningTable(device_kind=device_kind(dev), ceilings=ceilings,
                        meta={"quick": bool(quick), "win_margin": WIN_MARGIN,
                              "reduced": None if quick else FULL_REDUCED})
    for op in (ops or OPS):
        res = sweep_op(op, quick=quick, iters=iters, device=dev)
        table.set_entry(op, res["shape"], res["blocks"], us=res["us"],
                        default_us=res["default_us"],
                        default_spread=res["default_spread"],
                        candidates=res["candidates"])
    if out_path is not None:
        table.save(out_path)
    return table


def tuned_vs_default_ratio(table: TuningTable) -> float:
    """The worst tuned-vs-default throughput ratio over the table's
    entries, ``default_us / us``: >= 1.0 when every winner is at least as
    fast as the default it displaced (entries without timings skipped)."""
    ratios = []
    for buckets in table.ops.values():
        for entry in buckets.values():
            us, dus = entry.get("us"), entry.get("default_us")
            if us and dus:
                ratios.append(dus / us)
    return min(ratios) if ratios else 1.0
