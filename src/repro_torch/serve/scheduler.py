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

**Over a mesh.** Ranks that share sharded banks must dispatch the same
batches. :class:`CoordinatedScheduler` has rank 0 decide which slots
retire and agrees that plan, and every rank's next batches, in one
all-gather a step; a rank whose queue differs raises on every rank.
With one rank (or no mesh) the server builds the plain
:class:`ContinuousScheduler`, which issues no collective.
"""

from __future__ import annotations

import dataclasses
import time
import zlib
from typing import Any, Callable

import numpy as np
import torch

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
            self._dispatch(reqs)
            admitted += 1
        return admitted

    def _dispatch(self, reqs: list[Request]) -> None:
        """Dispatches one batch into a new slot."""
        handle = self.executor.dispatch(reqs)
        slot = Slot(sid=self._next_sid, reqs=reqs, handle=handle,
                    t_dispatch=self._clock())
        self._next_sid += 1
        self._slots[slot.sid] = slot
        self.dispatched_batches += 1

    def _finalize(self, sid: int) -> list[Request]:
        """Finalizes (blocking on) slot ``sid`` and frees it."""
        done = self.executor.finalize(self._slots[sid].handle)
        del self._slots[sid]
        self.retired_batches += 1
        return done

    def retire(self, block: bool = False) -> list[Request]:
        """Finalize completed slots (all in-flight slots with ``block``);
        returns the finished, non-cancelled requests."""
        done: list[Request] = []
        for sid in list(self._slots):
            if block or self.executor.poll(self._slots[sid].handle):
                done.extend(self._finalize(sid))
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


class CoordinatedScheduler(ContinuousScheduler):
    """Continuous batching over a multi-rank mesh: rank 0 plans each step.

    Every rank runs the same server on the same submissions, and the
    sharded routes' collectives need every rank to dispatch the same
    batches in the same order. Admission (``take_batch``) is already
    deterministic given the queue, so the one decision that depends on a
    rank's own timing is which slots ``poll`` finds done. Here rank 0
    alone polls, and each step is one ``exchange`` (an all-gather of one
    fixed-size int64 row a rank):

    * ``[0]`` the rank's pending count, ``[1]`` its slots in flight,
      ``[2]`` the next request id its queue will give;
    * ``[3 : 3 + S]`` (rank 0's row) the slot ids rank 0 retires, -1
      padded (``S`` = ``num_slots``);
    * then ``S`` blocks of ``max_batch_size`` entries: the batches the
      rank's next ``S`` ``take_batch`` calls would give, each request as
      its id times 2^32 plus a CRC-32 of its query, tenant, kind and
      precursor (-1 padded).

    Every rank checks every row against rank 0's, request for request.
    Any difference (a request submitted or cancelled on some ranks only)
    raises ``RuntimeError`` on every rank, naming the first differing
    rank and request id, before anything is retired or dispatched: the
    ranks leave the step together and no batch that differs is launched.
    Otherwise each rank finalizes the slots rank 0 retired (blocking on
    its own handles) and admits rank 0's first batches into the freed
    slots. ``drain`` runs at least one such step even when this rank is
    idle, so a rank holding requests the others lack raises instead of
    waiting alone in a collective.

    ``cancel`` (a pending request is removed, an in-flight one marked)
    and ``submit`` must be called alike on every rank.

    ``exchange(row)`` returns the ``(world, L)`` stack of every rank's
    row in rank order; ``rank`` is this rank's place in it.
    """

    HEADER = 3

    def __init__(self, queue: MicroBatchQueue, executor, *,
                 exchange: Callable, rank: int, num_slots: int = 2,
                 clock: Callable[[], float] = time.monotonic):
        super().__init__(queue, executor, num_slots=num_slots, clock=clock)
        self._exchange = exchange
        self.rank = int(rank)
        self.exchanges = 0
        self._digests: dict[int, int] = {}  # rid -> CRC-32, while pending

    def _entry(self, r: Request) -> int:
        crc = self._digests.get(r.rid)
        if crc is None:
            crc = zlib.crc32(np.ascontiguousarray(r.query).tobytes())
            crc = zlib.crc32(repr((r.tenant, r.kind, r.precursor)).encode(),
                             crc)
            self._digests[r.rid] = crc
        return (r.rid << 32) | crc

    def _row(self, block: bool) -> torch.Tensor:
        S, B, H = self.num_slots, self.queue.max_batch_size, self.HEADER
        row = torch.full((H + S + S * B,), -1, dtype=torch.int64)
        row[0] = len(self.queue)
        row[1] = len(self._slots)
        row[2] = self.queue.next_rid
        if self.rank == 0:
            sids = [sid for sid, slot in self._slots.items()
                    if block or self.executor.poll(slot.handle)]
            row[H:H + len(sids)] = torch.tensor(sids, dtype=torch.int64)
        for i, reqs in enumerate(self.queue.peek_batches(S)):
            at = H + S + i * B
            row[at:at + len(reqs)] = torch.tensor(
                [self._entry(r) for r in reqs], dtype=torch.int64)
        return row

    def _check(self, rows: torch.Tensor) -> None:
        """Raises RuntimeError when a rank's queue or slots differ from
        rank 0's (the same on every rank: each sees every row)."""
        S, H = self.num_slots, self.HEADER
        plan = rows[0]
        for r in range(1, rows.shape[0]):
            row = rows[r]
            if torch.equal(row[:H], plan[:H]) and torch.equal(
                    row[H + S:], plan[H + S:]):
                continue
            at = next((i for i, (a, b) in enumerate(zip(
                row[H + S:].tolist(), plan[H + S:].tolist())) if a != b),
                None)
            if at is not None:
                a, b = (int(v) >> 32 if v >= 0 else -1 for v in (
                    row[H + S + at], plan[H + S + at]))
                rid = min(a, b) if min(a, b) >= 0 else max(a, b)
                what = (f"first differing request id {rid} (rank {r}'s "
                        f"batches hold {a if a >= 0 else 'none'} there, "
                        f"rank 0's {b if b >= 0 else 'none'}")
                what += ", same id, other query)" if a == b else ")"
            elif row[2] != plan[2]:
                # the next batches agree: a later submission differs
                rid = int(min(row[2], plan[2]))
                what = (f"first differing request id {rid} (rank {r} "
                        f"submitted {int(row[2])}, rank 0 {int(plan[2])})")
            else:
                what = "a request pending beyond the next batches differs"
            raise RuntimeError(
                f"rank {r} differs from rank 0's plan: {what}; pending "
                f"{int(row[0])} vs {int(plan[0])}, in flight {int(row[1])} "
                f"vs {int(plan[1])}. submit and cancel must be called "
                f"alike on every rank; nothing was dispatched")

    def _plan_step(self, block: bool) -> list[Request]:
        S, B, H = self.num_slots, self.queue.max_batch_size, self.HEADER
        rows = self._exchange(self._row(block))
        self.exchanges += 1
        self._check(rows)
        plan = rows[0].tolist()
        done: list[Request] = []
        for sid in plan[H:H + S]:
            if sid >= 0:
                done.extend(self._finalize(sid))
        for i in range(S - len(self._slots)):
            at = H + S + i * B
            rids = [e >> 32 for e in plan[at:at + B] if e >= 0]
            if not rids:
                break
            reqs = self.queue.take_batch()
            if [r.rid for r in reqs] != rids:
                raise RuntimeError(
                    f"rank {self.rank}: the queue gave {[r.rid for r in reqs]}"
                    f" where the agreed plan has {rids}")
            for r in reqs:
                self._digests.pop(r.rid, None)
            self._dispatch(reqs)
        return done

    def cancel(self, rid: int) -> bool:
        self._digests.pop(rid, None)
        return super().cancel(rid)

    def step(self, block: bool = False) -> list[Request]:
        """One agreed step: retire the slots rank 0 found done (all of
        them with ``block``), then refill free slots with rank 0's next
        batches. Every rank must call it alike."""
        return self._plan_step(block)

    def drain(self) -> list[Request]:
        """Agreed blocking steps until every rank's queue and slots are
        empty (at least one step, even on an idle rank)."""
        done = self._plan_step(True)
        while self._slots or len(self.queue):
            done.extend(self._plan_step(True))
        return done

    def summary(self) -> dict:
        return super().summary() | {"exchanges": self.exchanges}
