"""``open_loop``: bursts of ``burst[0]..burst[1]`` spectra (uniform) at
exponential gaps, offered at ``rate_per_s`` spectra/s whatever the server
does; each request is due when its burst is, and is timed from then to
when the harness gets its answer back from ``step()``.

The set of gaps and burst sizes comes from the mix's fixed
``master_seed`` for a given rate and window; the run's seed only orders
them, so every seed offers the same work in another order.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from perfbench.harness import loop

SAMPLE_BATCHES = 32         # whole served batches checked (some 512 queries)
WARM_BURSTS = (3, 4, 7, 8, 15, 16, 31, 32)   # one bucket size below and
                                             # at each bucket, twice
WARM_FULL_BATCHES = 8       # then full batches


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Bursts of an open loop: due times (s after the window opens, sorted)
    and sizes."""

    due: np.ndarray    # (n,) float64
    size: np.ndarray   # (n,) int64

    @property
    def requests(self) -> int:
        return int(self.size.sum())


def check(mix: dict) -> None:
    lo, hi = mix.get("burst", (0, 0))
    if not 1 <= lo <= hi or float(mix.get("rate_per_s", 0)) <= 0:
        raise ValueError("an open loop needs 1 <= burst[0] <= burst[1] "
                         "and rate_per_s > 0")


def master_bursts(mix: dict, seconds: float, rate: float
                  ) -> tuple[np.ndarray, np.ndarray]:
    """The gaps (s) and burst sizes every seed draws its order from: a
    quarter more than a window of ``seconds`` at ``rate`` needs."""
    lo, hi = (int(b) for b in mix["burst"])
    mean_burst = (lo + hi) / 2.0
    n = int(math.ceil(1.25 * rate * seconds / mean_burst)) + 16
    master = np.random.default_rng(int(mix.get("master_seed", 0)))
    return master.exponential(mean_burst / rate, n), master.integers(
        lo, hi + 1, n)


def schedule(mix: dict, seconds: float, seed: int,
             rate_per_s: float | None = None) -> Schedule:
    """The bursts due in a window of ``seconds`` (``rate_per_s``
    overrides the mix's rate, for a sweep)."""
    rate = float(mix["rate_per_s"] if rate_per_s is None else rate_per_s)
    gaps, sizes = master_bursts(mix, seconds, rate)
    n = gaps.shape[0]
    order = np.random.default_rng(int(seed) & (2**64 - 1))
    gaps = gaps[order.permutation(n)]
    sizes = sizes[order.permutation(n)]
    due = np.cumsum(gaps)
    keep = due < seconds
    return Schedule(due=due[keep], size=sizes[keep].astype(np.int64))


def warm_spectra(max_batch: int) -> int:
    return 2 * sum(WARM_BURSTS) + WARM_FULL_BATCHES * max_batch


def warm_up(cell) -> None:
    put, srv = cell.submitter(cell.warm), cell.server
    i = 0
    for size in WARM_BURSTS * 2:
        for _ in range(size):
            put(i)
            i += 1
        srv.run_until_drained()
    for _ in range(WARM_FULL_BATCHES * cell.max_batch):
        put(i)
        i += 1
    srv.run_until_drained()


def serve(cell, run, seconds: float, seed: int,
          rate: float | None = None) -> None:
    """Offers the mix's bursts at their due times, stepping the server in
    between; then waits for every answer due in the window."""
    srv, queue = cell.server, cell.server.queue
    put = cell.submitter(cell.pool)
    sch = schedule(cell.mix, seconds, seed, rate)
    n_b = sch.due.shape[0]
    due_of = np.empty(sch.requests, np.float64)   # per request, absolute
    got = np.full(sch.requests, np.nan)
    late = np.empty(n_b, np.float64)
    rid0 = queue.next_rid
    i = j = 0
    win = loop.Window(cell, run, seconds)
    clock, t_end = win.clock, win.t_end
    due = win.t0 + sch.due
    cell.recorder.active = True

    def take(out, t):
        for r in out:
            got[r.rid - rid0] = t

    while True:
        now = clock()
        if not win.open(now):
            break
        if i < n_b and due[i] <= now:
            a = clock()
            while i < n_b and due[i] <= now:
                late[i] = now - due[i]
                for _ in range(int(sch.size[i])):
                    put(j)
                    due_of[j] = due[i]
                    j += 1
                i += 1
            win.span(a, "submit")
        out = win.step()
        if out:
            take(out, clock())
    win.close()
    # bursts that fell due inside the window but after its last look
    now = clock()
    while i < n_b:
        late[i] = now - due[i]
        for _ in range(int(sch.size[i])):
            put(j)
            due_of[j] = due[i]
            j += 1
        i += 1
    run.drain_wait_s = loop.DRAIN_WAIT_S
    t_wait = clock() + run.drain_wait_s
    while np.isnan(got[:j]).any() and clock() < t_wait:
        out = srv.step()
        if out:
            take(out, clock())
    cell.recorder.active = False
    srv.run_until_drained()
    lat = got[:j] - due_of[:j]
    run.failed = int(np.isnan(lat).sum())
    run.latencies_s = np.where(np.isnan(lat), np.inf, lat)
    run.attempted = j
    run.completed = int(np.sum(got[:j] < t_end))
    run.notes["rid0"] = rid0
    run.notes["generator_late_ms"] = (
        [float(np.percentile(late, q)) * 1e3 for q in (50, 95, 100)]
        if n_b else [0.0, 0.0, 0.0])
    run.notes["offered_per_s"] = sch.requests / seconds
    fin = np.isfinite(run.latencies_s)
    if fin.any():
        run.notes["p50_ms"] = float(np.median(run.latencies_s[fin])) * 1e3
    # a queue that grows through the window: answers still out at its
    # close, and the latency of the last quarter's requests over the first's
    run.notes["pending_at_close"] = int(np.sum(~(got[:j] < t_end)))
    q = max(1, j // 4)
    first, last = run.latencies_s[:q], run.latencies_s[-q:]
    run.notes["latency_growth"] = float(np.median(last) / max(
        np.median(first), 1e-9))
