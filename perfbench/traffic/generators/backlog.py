"""``backlog``: whole run files submitted as a backlog. The harness keeps at
least ``queued_batches`` full batches queued behind the batches in
flight, so every batch the server takes is full; ``spectra_per_s`` counts
the answers returned inside the window."""

from __future__ import annotations

from perfbench.harness import loop

SAMPLE_BATCHES = 16         # whole served batches checked (some 512 queries)
WARM_FULL_BATCHES = 8       # full batches of the warm-up


def check(mix: dict) -> None:
    if int(mix.get("queued_batches", 0)) < 1:
        raise ValueError("a backlog needs queued_batches >= 1")


def warm_spectra(max_batch: int) -> int:
    return WARM_FULL_BATCHES * max_batch


def warm_up(cell) -> None:
    put = cell.submitter(cell.warm)
    for i in range(WARM_FULL_BATCHES * cell.max_batch):
        put(i)
    cell.server.run_until_drained()


def serve(cell, run, seconds: float, seed: int, rate=None) -> None:
    srv, queue = cell.server, cell.server.queue
    put = cell.submitter(cell.pool)
    target = int(cell.mix["queued_batches"]) * cell.max_batch
    j = completed = answered = 0
    per_s = [0] * (int(seconds) + 1)
    rid0 = queue.next_rid
    win = loop.Window(cell, run, seconds)
    clock, t0, t_end = win.clock, win.t0, win.t_end
    cell.recorder.t_until = t_end
    cell.recorder.active = True
    while win.open(clock()):
        if len(queue) < target:
            a = clock()
            while len(queue) < target:
                put(j)
                j += 1
            win.span(a, "submit")
        out = win.step()
        if out:
            answered += len(out)
            t = clock()
            if t < t_end:
                completed += len(out)
                per_s[int(t - t0)] += len(out)
    win.close()
    cell.recorder.active = False
    answered += len(srv.run_until_drained())
    run.completed = completed
    run.attempted = j
    run.failed = max(0, j - answered)
    run.notes["answered_by_second"] = per_s[:int(seconds)]
    run.notes["rid0"] = rid0
