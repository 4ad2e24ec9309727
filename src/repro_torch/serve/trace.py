"""Spans of the serving path, kept in memory.

A :class:`SpanRecorder` attached to a
:class:`~repro_torch.serve.db_search.DBSearchServer` (``tracer=``, or the
``server.tracer`` attribute at any time; ``None`` detaches it) records
where the host's time goes inside the server: each batch's ``dispatch``
and ``finalize`` and their parts, each compaction. ``submit`` records
nothing: a span a request would cost more than the batch's ten together
(the caller's own clock around its submits times them).
:meth:`SpanRecorder.export` hands the records over as :class:`Span`\\ s:
name, start and end, own id, parent's id, the batch id ``bid`` that the
spans of one batch share (the id of its ``dispatch`` span), and a small
dict of counts.

**The clock.** Spans are stamped with ``time.perf_counter``: the clock
onto which a device trace of the benchmark (``perfbench/harness/
trace.py``) maps the profiler's device operations, through the two
``cudaDeviceSynchronize`` calls it makes at known ``perf_counter`` times.
So spans and device operations lie on one time axis, with no further
offset. The server's own ``clock`` (``time.monotonic`` by default) stays
what the requests' ``t_submit`` / ``t_dispatch`` / ``t_done`` stamps use.

**Nesting.** A name with a dot (``dispatch.plan``) is a child of the
innermost open span and takes its id as parent and its ``bid``. A name
without one is a root span: it drops whatever an exception left open
(those spans keep ``end`` None and count nowhere).

**Cost.** Off by default: with no recorder the server's only cost is one
attribute read a call and an ``is not None`` test at each point. With
one, a span is a few list appends, no object of its own (the records are
kept column by column, so the collector has nothing new to walk), and a
span with no children is recorded once, when it ends (:meth:`span`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable


@dataclasses.dataclass(slots=True)
class Span:
    """One recorded interval (seconds on the recorder's clock)."""

    name: str
    start: float
    end: float | None
    id: int
    parent: int | None
    bid: int | None
    counts: dict


class SpanRecorder:
    """Records spans in memory until :meth:`export`."""

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self.clock = clock
        self._name: list[str] = []
        self._start: list[float] = []
        self._end: list[float | None] = []
        self._parent: list[int | None] = []
        self._bid: list[int | None] = []
        self._counts: list[dict | None] = []
        self._open: list[int] = []   # ids of the open spans, outermost first
        self._first = 0              # id of the first record held

    def __len__(self) -> int:
        return len(self._name)

    @property
    def next_id(self) -> int:
        """The id the next span takes: ``begin(name, bid=next_id)`` opens
        a batch whose spans share that span's id."""
        return self._first + len(self._name)

    def _add(self, name: str, start: float, end: float | None,
             bid: int | None, counts: dict) -> int:
        i = self._first + len(self._name)
        op = self._open
        if op and "." in name:
            parent = op[-1]
            bid = self._bid[parent - self._first]
        else:
            op.clear()
            parent = None
        self._name.append(name)
        self._start.append(start)
        self._end.append(end)
        self._parent.append(parent)
        self._bid.append(bid)
        self._counts.append(counts or None)
        return i

    def begin(self, name: str, bid: int | None = None, **counts) -> int:
        """Opens span ``name`` (see the module docstring for its parent;
        a root span takes ``bid``); returns its id."""
        i = self._add(name, self.clock(), None, bid, counts)
        self._open.append(i)
        return i

    def end(self, i: int, **counts) -> None:
        """Closes span ``i`` (and whatever is still open inside it) and
        adds ``counts`` to its own. A span exported while open stays
        open."""
        t = self.clock()
        j = i - self._first
        if j < 0:
            return
        self._end[j] = t
        if counts:
            c = self._counts[j]
            if c is None:
                self._counts[j] = counts
            else:
                c.update(counts)
        op = self._open
        if i in op:
            del op[op.index(i):]

    def span(self, name: str, start: float, **counts) -> None:
        """Records span ``name`` from ``start`` (a reading of
        :attr:`clock`) to now, a span with no children."""
        self._add(name, start, self.clock(), None, counts)

    def add(self, **counts) -> None:
        """Adds ``counts`` to the outermost open span's (a batch's
        ``dispatch`` or ``finalize``, from a part of it)."""
        if self._open:
            j = self._open[0] - self._first
            c = self._counts[j]
            if c is None:
                c = self._counts[j] = {}
            for k, v in counts.items():
                c[k] = c.get(k, 0) + v

    def _records(self):
        first = self._first
        return zip(range(first, first + len(self._name)), self._name,
                   self._start, self._end, self._parent, self._bid,
                   self._counts)

    def export(self) -> list[Span]:
        """The records so far, handed over; the recorder starts anew
        (ids go on)."""
        out = [Span(name, s, e, i, p, b, c or {})
               for i, name, s, e, p, b, c in self._records()]
        self._first += len(self._name)
        for col in (self._name, self._start, self._end, self._parent,
                    self._bid, self._counts):
            col.clear()
        self._open.clear()
        return out

    def summary(self) -> dict:
        """For each span name of the records not yet exported: ``count``,
        ``total_ms``, ``self_ms`` (the duration less the part its children
        cover) and ``counts`` (each numeric count summed), over the closed
        spans."""
        done = [r for r in self._records() if r[3] is not None]
        inner: dict[int, float] = {}
        for _, _, s, e, p, _, _ in done:
            if p is not None:
                inner[p] = inner.get(p, 0.0) + e - s
        out: dict[str, dict] = {}
        for i, name, s, e, _, _, counts in done:
            d = out.setdefault(name, {"count": 0, "total_ms": 0.0,
                                      "self_ms": 0.0, "counts": {}})
            d["count"] += 1
            d["total_ms"] += 1e3 * (e - s)
            d["self_ms"] += 1e3 * (e - s - inner.get(i, 0.0))
            c = d["counts"]
            for k, v in (counts or {}).items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    c[k] = c.get(k, 0) + v
        return out
