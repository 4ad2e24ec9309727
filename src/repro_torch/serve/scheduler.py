"""Continuous-batching scheduler: a fixed pool of in-flight batch slots.

Counterpart of ``repro.serve.scheduler``: the same pure host code, with
the same contract, driving the PyTorch port's executor.

The flush-and-wait loop (``DBSearchServer.step`` pre-continuous) is the
p95 killer in the serving bench: every request admitted into a flush
waits for the whole batch to finish before the next flush even starts,
and a lone straggler waits out the full flush timeout on top. LLM
serving schedulers solved the same shape of problem with **continuous
batching**: keep a small fixed pool of in-flight batch slots, retire any
slot whose device work has completed, and immediately re-admit queued
requests into the freed slot — per *step*, not per *flush*.

This module is the host-side half of that design, deliberately built
around two injectable seams so every scheduling decision is
deterministically unit-testable (the seams are as much the deliverable
as the scheduler — see ``tests/test_torch_scheduler.py``):

  * **time** — the ``clock`` callable (shared with
    :class:`~repro_torch.serve.queue.MicroBatchQueue`), so admission order,
    fairness, and latency accounting run against a fake clock in tests;
  * **device dispatch** — an *executor* object with three methods::

        dispatch(reqs) -> handle   # assemble + launch, stamp t_dispatch;
                                   # must NOT block on device work
        poll(handle) -> bool       # True when the handle's work is done
        finalize(handle) -> list[Request]
                                   # block on the handle, fill results,
                                   # stamp t_done, record stats; returns
                                   # the non-cancelled requests

    Production uses :class:`~repro_torch.serve.db_search.SearchExecutor`
    (batches staged through pinned host buffers and copied with
    ``non_blocking=True``, the search launched on the current stream, the
    results copied back the same way; ``poll`` on the batch's CUDA
    event); tests use recording/simulated executors.
    Handles are *opaque* to the scheduler — which is how the clustering
    endpoint rides the same slot pool: the executor hands back a
    ``ClusterBatchHandle`` for ``kind="cluster"`` batches and a
    ``BatchHandle`` for search, and the scheduler never looks inside.

**Backlog policy is the queue's.** The scheduler reuses
:class:`~repro_torch.serve.queue.MicroBatchQueue` unchanged as its backlog:
``take_batch`` already implements tenant-homogeneous FIFO batches, the
globally-oldest-first tenant pick (no starvation: a cold tenant's head
request only ages until it *is* the oldest), and the fairness cap with
skip-last-served rotation. Continuous batching changes only *when*
batches leave the queue: whenever a slot is free and requests are
pending — never waiting for a full lane or a flush timeout. Under light
load that admits singleton batches immediately (latency-optimal); under
load the slots stay busy and the backlog coalesces into larger batches
between admissions (throughput recovers) — the classic continuous-
batching behavior.

**Cancellation.** ``cancel`` removes a still-pending request from the
queue outright; an already in-flight request is only *marked* (its slot
keeps its position and batch shape — device work is not restartable) and
its result is dropped at retire time. Slot accounting is unaffected
either way, which is exactly what the tests pin.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

from repro_torch.serve.queue import MicroBatchQueue, Request


@dataclasses.dataclass
class Slot:
    """One in-flight batch: its requests and the executor's handle."""

    sid: int
    reqs: list[Request]
    handle: Any
    t_dispatch: float


class ContinuousScheduler:
    """Fixed-slot continuous batching over a ``MicroBatchQueue`` backlog.

    ``step()`` is the one-call serving loop body: retire every completed
    slot (collecting finished requests), then admit queued batches into
    the freed slots — retire-then-admit, so a slot freed this step is
    refilled this same step and the pool never idles while work is
    queued.
    """

    def __init__(self, queue: MicroBatchQueue, executor, *,
                 num_slots: int = 2,
                 clock: Callable[[], float] = time.monotonic):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        self.queue = queue
        self.executor = executor
        self.num_slots = int(num_slots)
        self._clock = clock
        self._slots: dict[int, Slot] = {}
        self._next_sid = 0
        self.dispatched_batches = 0
        self.retired_batches = 0
        self.cancellations = 0

    @property
    def in_flight(self) -> int:
        """Slots currently occupied (always <= num_slots)."""
        return len(self._slots)

    @property
    def free_slots(self) -> int:
        return self.num_slots - len(self._slots)

    def in_flight_requests(self) -> int:
        return sum(len(s.reqs) for s in self._slots.values())

    def cancel(self, rid: int) -> bool:
        """Drop a request: un-queue it if still pending, else mark the
        in-flight copy cancelled (result discarded at retire; the slot's
        accounting is untouched). Returns False for unknown/finished
        rids."""
        if self.queue.cancel(rid):
            self.cancellations += 1
            return True
        for slot in self._slots.values():
            for r in slot.reqs:
                if r.rid == rid and not r.cancelled:
                    r.cancelled = True
                    self.cancellations += 1
                    return True
        return False

    def admit(self) -> int:
        """Fill free slots from the backlog; returns batches admitted.

        Each admission is one ``take_batch`` — tenant-homogeneous, FIFO,
        fairness-capped by the queue's own policy — dispatched through
        the executor without blocking on the device.
        """
        admitted = 0
        while len(self._slots) < self.num_slots and len(self.queue):
            reqs = self.queue.take_batch()
            if not reqs:
                break
            handle = self.executor.dispatch(reqs)
            slot = Slot(sid=self._next_sid, reqs=reqs, handle=handle,
                        t_dispatch=self._clock())
            self._next_sid += 1
            self._slots[slot.sid] = slot
            self.dispatched_batches += 1
            admitted += 1
        return admitted

    def retire(self, block: bool = False) -> list[Request]:
        """Finalize completed slots (all in-flight slots with ``block``);
        returns the finished, non-cancelled requests."""
        done: list[Request] = []
        for sid in list(self._slots):
            slot = self._slots[sid]
            if block or self.executor.poll(slot.handle):
                done.extend(self.executor.finalize(slot.handle))
                del self._slots[sid]
                self.retired_batches += 1
        return done

    def step(self, block: bool = False) -> list[Request]:
        """One scheduler step: retire completed slots, then refill free
        slots from the queue. Returns the requests finished this step."""
        done = self.retire(block=block)
        self.admit()
        return done

    def drain(self) -> list[Request]:
        """Run steps with blocking retires until queue and slots are empty."""
        done: list[Request] = []
        while self._slots or len(self.queue):
            self.admit()
            done.extend(self.retire(block=True))
        return done

    def summary(self) -> dict:
        return {
            "num_slots": self.num_slots,
            "in_flight": self.in_flight,
            "dispatched_batches": self.dispatched_batches,
            "retired_batches": self.retired_batches,
            "cancellations": self.cancellations,
        }
