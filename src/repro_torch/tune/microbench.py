"""ERT-style device-ceiling microbenchmarks, in PyTorch.

Counterpart of ``repro.tune.microbench``. Peak compute from float32
matmuls of growing size (small ones are launch-bound, large ones saturate
the FMA units) and memory bandwidth from ``x + 1`` streams of growing size;
the ceiling is the largest rate across the sweep, as in the Berkeley ERT.

On the card the matmuls run in full float32, with TF32 off
(``torch.backends.cuda.matmul.allow_tf32 = False`` for the sweep, restored
after), so the compute ceiling is the float32 SIMT rate (the H100 SXM
publishes 67 TFLOP/s), not a tensor-core rate. The full bandwidth sweep
streams arrays past the H100's 50 MB L2, so its ceiling is the HBM rate.
Times come from CUDA events on the card and the host clock on the CPU,
median of ``iters``.

These numbers replace the published H100 defaults of
``repro_torch.launch.roofline`` whenever a tuning table measured on the
local device kind is active.
"""

from __future__ import annotations

import contextlib
import time

import torch

from repro_torch.device import resolve_device


@contextlib.contextmanager
def _tf32_off():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def median_seconds(fn, device: torch.device, *, warmup: int = 1,
                   iters: int = 5) -> float:
    """Median seconds of one ``fn()``: CUDA events around each call on the
    card (the device's time), the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    times = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def _sleep_cycles_per_s(device: torch.device) -> float:
    """Clock cycles per second of ``torch.cuda._sleep`` on ``device``."""
    cycles = 10_000_000
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    return cycles / (start.elapsed_time(end) / 1e3)


def burst_seconds(fn, device: torch.device, *, calls: int, iters: int,
                  warmup: int = 1) -> list[float]:
    """Seconds per ``fn()``, one sample per burst of ``calls`` back-to-back
    calls.

    On the card each burst is queued behind a device-side wait
    (``torch.cuda._sleep``) that outlasts the host's time to issue it, so
    the CUDA events around the burst time the device's work alone: a call
    whose kernel is shorter than its wrapper's host work is timed on the
    kernel, not on the host. A burst the host did not queue in time (its
    start event had already fired) is timed again behind a longer wait.
    ``fn`` must not synchronize. On the CPU, the host clock around each
    burst."""
    for _ in range(warmup):
        fn()
    samples: list[float] = []
    if device.type != "cuda":
        for _ in range(iters):
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            samples.append((time.perf_counter() - t0) / calls)
        return samples
    with torch.cuda.device(device):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        issue_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        cycles = int((2 * issue_s + 1e-3) * _sleep_cycles_per_s(device))
        retries = 0
        while len(samples) < iters:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(cycles)
            start.record()
            for _ in range(calls):
                fn()
            queued = not start.query()
            end.record()
            end.synchronize()
            if queued:
                samples.append(start.elapsed_time(end) / 1e3 / calls)
                continue
            retries += 1
            if retries > 8:
                raise RuntimeError("the host could not queue a burst ahead "
                                   "of the device")
            cycles *= 2
    return samples


def measure_peak_flops(sizes: tuple[int, ...] | None = None, iters: int = 5,
                       device: str | torch.device = "cuda") -> dict:
    """Peak achieved float32 FLOP/s from a growing-matmul sweep (TF32 off).

    Square matmuls of side n cost ``2 n^3`` FLOPs; the max rate across the
    sweep is the ceiling. Returns ``{"peak_flops", "by_size": {n: flops}}``.
    """
    dev = resolve_device(device)
    sizes = sizes or (1024, 2048, 4096, 8192)
    g = torch.Generator(device=dev).manual_seed(0)
    by_size = {}
    with _tf32_off():
        for n in sizes:
            a = torch.randn((n, n), generator=g, device=dev)
            b = torch.randn((n, n), generator=g, device=dev)
            t = median_seconds(lambda: a @ b, dev, iters=iters)
            by_size[int(n)] = 2.0 * n ** 3 / t
    return {"peak_flops": max(by_size.values()), "by_size": by_size}


def measure_mem_bandwidth(sizes_mb: tuple[float, ...] | None = None,
                          iters: int = 5,
                          device: str | torch.device = "cuda") -> dict:
    """Peak achieved memory bandwidth from a growing ``x + 1`` sweep: one
    read and one write per element, so 2 x the array's bytes per call.
    Returns ``{"hbm_bw", "by_size_mb": {mb: bytes_per_s}}``."""
    dev = resolve_device(device)
    sizes_mb = sizes_mb or (256.0, 1024.0, 4096.0)
    g = torch.Generator(device=dev).manual_seed(1)
    by_size = {}
    for mb in sizes_mb:
        n = int(mb * (1 << 20) // 4)
        x = torch.randn(n, generator=g, device=dev)
        t = median_seconds(lambda: x + 1.0, dev, iters=iters)
        by_size[float(mb)] = 2.0 * n * 4 / t
        del x
    return {"hbm_bw": max(by_size.values()), "by_size_mb": by_size}


def measure_ceilings(quick: bool = False,
                     device: str | torch.device = "cuda") -> dict:
    """Both sweeps -> the ``ceilings`` dict a tuning table persists
    (``peak_flops_fp32`` / ``hbm_bw`` in SI units, the per-size curves,
    and the matmul precision). ``quick`` shrinks the sweeps to the reference's
    quick sizes, for CPU runs: the ceilings are then lower bounds, and on
    the card the small arrays sit in L2."""
    sizes = (256, 512, 1024) if quick else (1024, 2048, 4096, 8192)
    mbs = (4.0, 16.0, 64.0) if quick else (256.0, 1024.0, 4096.0)
    iters = 3 if quick else 5
    flops = measure_peak_flops(sizes, iters=iters, device=device)
    bw = measure_mem_bandwidth(mbs, iters=iters, device=device)
    return {
        "peak_flops_fp32": flops["peak_flops"],
        "hbm_bw": bw["hbm_bw"],
        "flops_by_size": {str(k): v for k, v in flops["by_size"].items()},
        "bw_by_size_mb": {str(k): v for k, v in bw["by_size_mb"].items()},
        "matmul": "float32, TF32 off",
        "quick": bool(quick),
    }
