"""The host side of a run: the deployment's host settings, and readings of
how fast the host ran for the run.

Every cell is paced in part by the host's Python path, so a run on a host
that runs slower reads slower. Two readings say how fast it ran: a fixed
pure-Python probe timed just before the window (the host's single-thread
speed at that moment), and the share of the window's wall time that the
process spent on a CPU.
"""

from __future__ import annotations

import resource
import time


def apply(settings: dict | None, torch) -> dict:
    """Applies a configuration's ``host`` settings to this process:
    ``threads``, the program's intra-op CPU threads (0: PyTorch's
    default). Returns what was applied."""
    threads = int((settings or {}).get("threads", 0))
    if threads > 0:
        torch.set_num_threads(threads)
    return {"threads": torch.get_num_threads()}


def snapshot() -> dict:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"t": time.perf_counter(), "cpu_s": ru.ru_utime + ru.ru_stime}


def over(a: dict, b: dict) -> dict:
    """The wall seconds between two snapshots, and the process's CPU
    seconds over them."""
    wall = max(b["t"] - a["t"], 1e-9)
    return {"wall_s": round(wall, 3),
            "cpu_share": round((b["cpu_s"] - a["cpu_s"]) / wall, 4)}


def probe_ms(repeats: int = 5, n: int = 200_000) -> float:
    """The fastest of ``repeats`` timings of a fixed pure-Python loop: the
    host's single-thread speed just now (lower is faster)."""
    best = float("inf")
    for _ in range(repeats):
        t = time.perf_counter()
        acc = 0
        for i in range(n):
            acc += i & 7
        best = min(best, time.perf_counter() - t)
    return best * 1e3
