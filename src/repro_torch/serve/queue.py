"""Tenant-aware FIFO micro-batching queue with per-request latency accounting.

Serving throughput comes from batching queries over the 'data' mesh axis,
but requests arrive one at a time — and, multi-tenant, against different
reference banks, so a flush must be tenant-homogeneous. The queue keeps
one FIFO lane per tenant and flushes a batch when either

  * some tenant has ``max_batch_size`` requests pending (throughput
    bound), or
  * the oldest pending request (across all tenants) has waited
    ``flush_timeout_s`` (latency bound — a lone request is never
    stranded).

``take_batch`` picks the tenant with a full lane first (oldest such
lane), else the tenant owning the globally-oldest request. With a
``fairness_cap``, a flush is additionally capped at that many requests
while other tenants wait, and the tenant just served is skipped on the
next pick — so one hot tenant can neither fill every flush nor take
consecutive flushes while others are pending.

Lanes are actually keyed by ``(tenant, kind)``: a server that exposes
several request types (DB search and the clustering endpoint) gets
kind-homogeneous batches from the same flush/fairness machinery — a
tenant's search lane and cluster lane rotate against each other exactly
like two tenants would.

The clock is injectable so flush-on-timeout is deterministic to test:

>>> now = [0.0]
>>> q = MicroBatchQueue(max_batch_size=2, flush_timeout_s=1.0,
...                     clock=lambda: now[0])
>>> _ = q.submit([0.5]); q.ready()       # one pending, not timed out yet
False
>>> now[0] = 1.25
>>> q.ready()                            # oldest has waited >= 1.0s
True
>>> [r.rid for r in q.take_batch()]
[0]
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable

import numpy as np


@dataclasses.dataclass
class Request:
    """One in-flight query and its timing record.

    ``t_submit`` is stamped at *enqueue* (never at flush), so
    ``latency_s`` always includes the time spent waiting in the queue;
    ``t_dispatch`` is stamped when the request leaves the queue for the
    device (flush-sync flush, or continuous-batching slot admission),
    splitting the total into ``queue_wait_s`` + ``service_s``.
    """

    rid: int
    query: Any
    t_submit: float
    tenant: str = "default"
    t_done: float | None = None
    result: Any = None
    precursor: float | None = None  # query precursor mass (OMS serving mode)
    t_dispatch: float | None = None  # left the queue for the device
    cancelled: bool = False          # dropped by the scheduler's cancel()
    kind: str = "search"             # request type: "search" | "cluster"

    @property
    def latency_s(self) -> float:
        if self.t_done is None:
            raise ValueError(f"request {self.rid} not completed yet")
        return self.t_done - self.t_submit

    @property
    def queue_wait_s(self) -> float:
        if self.t_dispatch is None:
            raise ValueError(f"request {self.rid} not dispatched yet")
        return self.t_dispatch - self.t_submit

    @property
    def service_s(self) -> float:
        if self.t_done is None or self.t_dispatch is None:
            raise ValueError(f"request {self.rid} not completed yet")
        return self.t_done - self.t_dispatch


class MicroBatchQueue:
    """Per-tenant FIFO queues that group requests into micro-batches.

    ``submit`` never blocks; the serving loop calls ``ready`` /
    ``take_batch`` (see :class:`repro_torch.serve.db_search.DBSearchServer`).
    Every batch returned by ``take_batch`` holds requests of a single
    tenant, in FIFO order.
    """

    def __init__(self, max_batch_size: int = 32, flush_timeout_s: float = 0.01,
                 clock: Callable[[], float] = time.monotonic,
                 fairness_cap: int | None = None):
        if max_batch_size < 1:
            raise ValueError(f"max_batch_size must be >= 1, got {max_batch_size}")
        if flush_timeout_s < 0:
            raise ValueError(f"flush_timeout_s must be >= 0, got {flush_timeout_s}")
        if fairness_cap is not None and fairness_cap < 1:
            raise ValueError(f"fairness_cap must be >= 1, got {fairness_cap}")
        self.max_batch_size = int(max_batch_size)
        self.flush_timeout_s = float(flush_timeout_s)
        self.fairness_cap = fairness_cap
        self._clock = clock
        # lane key: (tenant, kind) — see module docstring
        self._pending: dict[tuple[str, str],
                            collections.deque[Request]] = {}
        self._next_rid = 0
        self._last_served: tuple[str, str] | None = None

    def __len__(self) -> int:
        return sum(len(d) for d in self._pending.values())

    def pending_tenants(self) -> list[str]:
        """Tenants with at least one pending request (insertion order)."""
        return list(dict.fromkeys(t for t, _ in self._pending))

    def submit(self, query, tenant: str = "default",
               precursor: float | None = None,
               kind: str = "search") -> int:
        """Enqueue one query; returns its request id (FIFO-ordered)."""
        req = Request(rid=self._next_rid, query=query, tenant=tenant,
                      t_submit=self._clock(), precursor=precursor,
                      kind=kind)
        self._next_rid += 1
        self._pending.setdefault((tenant, kind),
                                 collections.deque()).append(req)
        return req.rid

    def cancel(self, rid: int) -> bool:
        """Remove a still-pending request from its lane. Returns False when
        ``rid`` is not pending (already taken by a flush, or unknown) —
        in-flight cancellation is the scheduler's job."""
        for key, lane in self._pending.items():
            for r in lane:
                if r.rid == rid:
                    lane.remove(r)
                    if not lane:
                        del self._pending[key]
                    return True
        return False

    def _oldest(self) -> Request | None:
        heads = [d[0] for d in self._pending.values() if d]
        return min(heads, key=lambda r: r.rid) if heads else None

    def oldest_age_s(self) -> float | None:
        oldest = self._oldest()
        if oldest is None:
            return None
        return self._clock() - oldest.t_submit

    def ready(self) -> bool:
        """True when a batch should flush: some tenant's lane is full, or
        the globally-oldest request timed out."""
        if any(len(d) >= self.max_batch_size for d in self._pending.values()):
            return True
        age = self.oldest_age_s()
        return age is not None and age >= self.flush_timeout_s

    def time_until_flush(self) -> float | None:
        """Seconds until the timeout would flush; None when the queue is
        empty, 0.0 when already flushable. Lets a serving loop sleep
        precisely."""
        if not len(self):
            return None
        if any(len(d) >= self.max_batch_size for d in self._pending.values()):
            return 0.0
        return max(0.0, self.flush_timeout_s - self.oldest_age_s())

    def _next_lane(self) -> tuple[str, str] | None:
        """The lane the next ``take_batch`` would serve: the oldest full
        lane, else the lane of the globally-oldest request — except that,
        under a ``fairness_cap``, the lane served by the previous flush
        is skipped while other lanes are waiting."""
        lanes = self._pending
        if (self.fairness_cap is not None and len(lanes) > 1
                and self._last_served in lanes):
            lanes = {t: d for t, d in lanes.items() if t != self._last_served}
        full = [d[0] for d in lanes.values()
                if len(d) >= self.max_batch_size]
        if full:
            head = min(full, key=lambda r: r.rid)
        else:
            heads = [d[0] for d in lanes.values() if d]
            if not heads:
                return None
            head = min(heads, key=lambda r: r.rid)
        return (head.tenant, head.kind)

    def next_tenant(self) -> str | None:
        """The tenant the next ``take_batch`` would serve (see
        ``_next_lane`` — lane selection is per (tenant, kind))."""
        lane = self._next_lane()
        return None if lane is None else lane[0]

    def take_batch(self) -> list[Request]:
        """Pop up to ``max_batch_size`` requests of one lane (single
        tenant, single kind) in FIFO order (may be called
        unconditionally, e.g. to drain on shutdown). With other lanes
        waiting, the flush is additionally capped at ``fairness_cap``
        requests."""
        key = self._next_lane()
        if key is None:
            return []
        lane = self._pending[key]
        n = min(len(lane), self.max_batch_size)
        if self.fairness_cap is not None and len(self._pending) > 1:
            n = min(n, self.fairness_cap)
        batch = [lane.popleft() for _ in range(n)]
        if not lane:
            del self._pending[key]
        self._last_served = key
        return batch

    @property
    def next_rid(self) -> int:
        """The id the next ``submit`` will return."""
        return self._next_rid

    def peek_batches(self, n: int) -> list[list[Request]]:
        """The batches the next ``n`` ``take_batch`` calls would return
        (fewer when the queue runs dry), leaving the queue as it was."""
        saved = self._pending, self._last_served
        self._pending = {key: collections.deque(lane)
                         for key, lane in saved[0].items()}
        try:
            out = []
            for _ in range(n):
                batch = self.take_batch()
                if not batch:
                    break
                out.append(batch)
            return out
        finally:
            self._pending, self._last_served = saved


class LatencyStats:
    """Streaming per-request latency + batch-size accounting.

    Counts and timestamps are exact running values; percentiles/means are
    computed over a bounded sliding window of the most recent ``window``
    requests, so a long-lived server's memory and ``summary`` cost stay
    O(window) under sustained traffic.
    """

    def __init__(self, window: int = 8192):
        self._latencies: collections.deque[float] = collections.deque(
            maxlen=window)
        self._queue_waits: collections.deque[float] = collections.deque(
            maxlen=window)
        self._batch_sizes: collections.deque[int] = collections.deque(
            maxlen=window)
        self._count = 0
        self._batches = 0
        self._t_first: float | None = None
        self._t_last: float | None = None

    def record_batch(self, requests: list[Request]) -> None:
        """Record a completed batch (each request must have ``t_done``)."""
        if not requests:
            return
        self._batches += 1
        self._batch_sizes.append(len(requests))
        for r in requests:
            self._count += 1
            self._latencies.append(r.latency_s)
            if r.t_dispatch is not None:
                self._queue_waits.append(r.queue_wait_s)
            if self._t_first is None or r.t_submit < self._t_first:
                self._t_first = r.t_submit
            if self._t_last is None or r.t_done > self._t_last:
                self._t_last = r.t_done

    @property
    def count(self) -> int:
        return self._count

    def summary(self) -> dict:
        """{count, batches, mean_batch, qps, p50_ms, p95_ms, mean_ms,
        queue_wait_p50_ms, queue_wait_p95_ms} — count/batches/qps over the
        full history, the rest over the latest ``window`` requests. The
        ``queue_wait_*`` split (time before dispatch, part of every
        latency number) is 0.0 when no request carried ``t_dispatch``."""
        if not self._count:
            return {"count": 0, "batches": 0, "mean_batch": 0.0, "qps": 0.0,
                    "p50_ms": 0.0, "p95_ms": 0.0, "mean_ms": 0.0,
                    "queue_wait_p50_ms": 0.0, "queue_wait_p95_ms": 0.0}
        lat = np.asarray(self._latencies)
        span = max(self._t_last - self._t_first, 1e-9)
        qw = np.asarray(self._queue_waits) if self._queue_waits else None
        return {
            "count": self._count,
            "batches": self._batches,
            "mean_batch": float(np.mean(self._batch_sizes)),
            "qps": float(self._count / span),
            "p50_ms": float(np.percentile(lat, 50) * 1e3),
            "p95_ms": float(np.percentile(lat, 95) * 1e3),
            "mean_ms": float(lat.mean() * 1e3),
            "queue_wait_p50_ms": (0.0 if qw is None
                                  else float(np.percentile(qw, 50) * 1e3)),
            "queue_wait_p95_ms": (0.0 if qw is None
                                  else float(np.percentile(qw, 95) * 1e3)),
        }
