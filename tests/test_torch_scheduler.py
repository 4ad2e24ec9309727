"""The PyTorch port's continuous-batching scheduler, on the CPU.

Every case of the reference's ``tests/test_scheduler.py``, run against
the port (``repro_torch.serve.scheduler`` and the port's server) with the
same fake clock and fake executors (recording / simulated service time),
so admission order, tenant fairness, slot accounting, cancellation and
the tail-latency behaviour of both queue modes are asserted exactly. Then
the same traces through the reference's ``DBSearchServer(continuous=True)``
and the port's, each on its real executor: the batch compositions, the
dispatch and retire order and every per-request result must be equal.
Tolerance: exact.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist.sharding import set_mesh
from repro.serve import DBSearchServer as JServer
from repro.serve import OMSConfig as JOMSConfig
from repro.serve import shard_database as jshard
from repro_torch.serve import (
    ContinuousScheduler,
    CoordinatedScheduler,
    DBSearchServer,
    LatencyStats,
    MicroBatchQueue,
    OMSConfig,
    SearchExecutor,
    shard_database,
)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _no_global_mesh():
    set_mesh(None)


class Clock:
    """Settable fake clock (the queue/scheduler/server time seam)."""

    def __init__(self, now: float = 0.0):
        self.now = now

    def __call__(self) -> float:
        return self.now


class RecordingExecutor:
    """Executor seam fake: records every dispatched batch; completion is
    test-controlled via ``ready`` handles."""

    def __init__(self, clock):
        self.clock = clock
        self.dispatched = []
        self.ready = set()
        self._handles = {}
        self._next = 0

    def dispatch(self, reqs):
        t = self.clock()
        for r in reqs:
            r.t_dispatch = t
        h = self._next
        self._next += 1
        self.dispatched.append(list(reqs))
        self._handles[h] = reqs
        return h

    def poll(self, h):
        return h in self.ready

    def finalize(self, h):
        reqs = self._handles.pop(h)
        t = self.clock()
        live = [r for r in reqs if not r.cancelled]
        for r in live:
            r.t_done = t
            r.result = "done"
        return live


class SimulatedExecutor:
    """Executor seam fake with a serial device model: each dispatch takes
    ``c0 + c1 * batch`` seconds of device time, batches execute one after
    another, and ``finalize`` advances the fake clock to the completion
    time when asked to block early."""

    def __init__(self, clock, c0=0.01, c1=0.0025):
        self.clock = clock
        self.c0, self.c1 = c0, c1
        self._free_at = 0.0
        self._handles = {}
        self._next = 0

    def dispatch(self, reqs):
        t = self.clock()
        for r in reqs:
            r.t_dispatch = t
        start = max(t, self._free_at)
        t_ready = start + self.c0 + self.c1 * len(reqs)
        self._free_at = t_ready
        h = self._next
        self._next += 1
        self._handles[h] = (reqs, t_ready)
        return h

    def poll(self, h):
        return self.clock() >= self._handles[h][1]

    def finalize(self, h):
        reqs, t_ready = self._handles.pop(h)
        self.clock.now = max(self.clock.now, t_ready)
        live = [r for r in reqs if not r.cancelled]
        for r in live:
            r.t_done = self.clock()
            r.result = "done"
        return live


def _make(clock, *, max_batch=2, num_slots=2, fairness_cap=None,
          flush_timeout_s=0.5):
    queue = MicroBatchQueue(max_batch_size=max_batch,
                            flush_timeout_s=flush_timeout_s, clock=clock,
                            fairness_cap=fairness_cap)
    ex = RecordingExecutor(clock)
    sched = ContinuousScheduler(queue, ex, num_slots=num_slots)
    return queue, ex, sched


# --------------------------------------------------------------------------
# admission, slot accounting, refill
# --------------------------------------------------------------------------

class TestAdmission:
    def test_fifo_admission_fills_slots_in_order(self):
        clock = Clock()
        queue, ex, sched = _make(clock)
        rids = [queue.submit(i) for i in range(6)]
        assert sched.admit() == 2
        assert sched.in_flight == 2 and sched.free_slots == 0
        assert [[r.rid for r in b] for b in ex.dispatched] == [
            rids[0:2], rids[2:4]]
        assert len(queue) == 2
        assert sched.admit() == 0

    def test_retire_then_admit_refills_freed_slot_same_step(self):
        clock = Clock()
        queue, ex, sched = _make(clock)
        rids = [queue.submit(i) for i in range(6)]
        sched.admit()
        ex.ready.add(0)
        clock.now = 1.0
        done = sched.step()
        assert [r.rid for r in done] == rids[0:2]
        assert sched.in_flight == 2
        assert [r.rid for r in ex.dispatched[2]] == rids[4:6]
        assert sched.retired_batches == 1 and sched.dispatched_batches == 3

    def test_admission_needs_no_flush_trigger(self):
        clock = Clock()
        queue, ex, sched = _make(clock, max_batch=8, flush_timeout_s=10.0)
        rid = queue.submit(0)
        assert not queue.ready()
        assert sched.step() == []
        assert sched.in_flight == 1
        assert ex.dispatched[0][0].rid == rid
        assert ex.dispatched[0][0].queue_wait_s == 0.0

    def test_step_block_waits_out_in_flight_slots(self):
        clock = Clock()
        queue, ex, sched = _make(clock)
        queue.submit(0)
        sched.step()
        done = sched.step(block=True)
        assert len(done) == 1 and sched.in_flight == 0

    def test_drain_empties_queue_and_slots(self):
        clock = Clock()
        queue, ex, sched = _make(clock, max_batch=3, num_slots=2)
        rids = [queue.submit(i) for i in range(10)]
        done = sched.drain()
        assert sorted(r.rid for r in done) == rids
        assert sched.in_flight == 0 and len(queue) == 0
        assert sched.dispatched_batches == sched.retired_batches == 4

    def test_num_slots_validation(self):
        clock = Clock()
        queue, ex, _ = _make(clock)
        with pytest.raises(ValueError, match="num_slots"):
            ContinuousScheduler(queue, ex, num_slots=0)


# --------------------------------------------------------------------------
# tenant fairness and starvation
# --------------------------------------------------------------------------

class TestFairness:
    def test_fairness_cap_under_skewed_load(self):
        clock = Clock()
        queue, ex, sched = _make(clock, max_batch=4, num_slots=8,
                                 fairness_cap=2)
        for i in range(8):
            queue.submit(i, tenant="hot")
        queue.submit(99, tenant="cold")
        sched.admit()
        batches = [(b[0].tenant, len(b)) for b in ex.dispatched]
        assert batches == [("hot", 2), ("cold", 1), ("hot", 4), ("hot", 2)]

    def test_cold_tenant_not_starved_with_one_slot(self):
        clock = Clock()
        queue, ex, sched = _make(clock, max_batch=4, num_slots=1,
                                 fairness_cap=4)
        for i in range(4):
            queue.submit(i, tenant="hot")
        cold_rid = queue.submit(99, tenant="cold")
        sched.step()
        for i in range(4):
            queue.submit(10 + i, tenant="hot")
        ex.ready.add(0)
        sched.step()
        assert ex.dispatched[1][0].rid == cold_rid
        assert [b[0].tenant for b in ex.dispatched] == ["hot", "cold"]


# --------------------------------------------------------------------------
# cancellation and slot accounting
# --------------------------------------------------------------------------

class TestCancellation:
    def test_pending_cancel_removes_from_queue(self):
        clock = Clock()
        queue, ex, sched = _make(clock, max_batch=2, num_slots=1)
        rids = [queue.submit(i) for i in range(4)]
        sched.admit()
        assert sched.cancel(rids[2]) is True
        assert len(queue) == 1
        ex.ready.add(0)
        done = sched.drain()
        assert sorted(r.rid for r in done) == [rids[0], rids[1], rids[3]]
        assert sched.cancellations == 1

    def test_in_flight_cancel_keeps_slot_accounting(self):
        clock = Clock()
        queue, ex, sched = _make(clock, max_batch=2, num_slots=2)
        rids = [queue.submit(i) for i in range(4)]
        sched.admit()
        assert sched.cancel(rids[1]) is True
        assert sched.in_flight == 2
        assert sched.in_flight_requests() == 4
        ex.ready.update({0, 1})
        done = sched.step()
        assert [r.rid for r in done] == [rids[0], rids[2], rids[3]]
        assert sched.retired_batches == 2
        assert sched.cancel(rids[0]) is False

    def test_unknown_rid_cancel_returns_false(self):
        clock = Clock()
        _, _, sched = _make(clock)
        assert sched.cancel(123) is False
        assert sched.cancellations == 0


# --------------------------------------------------------------------------
# latency accounting
# --------------------------------------------------------------------------

def _tiny_hvs(seed, n=24, d=64):
    rng = np.random.default_rng(seed)
    return (rng.choice([-1, 1], size=(n, d)).astype(np.int8),
            rng.choice([-1, 1], size=(n, d)).astype(np.int8))


def _tiny_db(seed, n=24, d=64):
    refs, decoys = _tiny_hvs(seed, n, d)
    return shard_database(torch.from_numpy(refs),
                          decoys=torch.from_numpy(decoys))


def _tiny_jdb(seed, n=24, d=64):
    refs, decoys = _tiny_hvs(seed, n, d)
    return jshard(jnp.asarray(refs), decoys=jnp.asarray(decoys))


def _tiny_query(seed, d=64):
    rng = np.random.default_rng(seed)
    return rng.choice([-1, 1], size=d).astype(np.int8)


class TestLatencyAccounting:
    def test_queue_wait_visible_in_continuous_mode(self):
        clock = Clock()
        queue = MicroBatchQueue(max_batch_size=4, clock=clock)
        ex = SimulatedExecutor(clock, c0=0.1, c1=0.0)
        sched = ContinuousScheduler(queue, ex, num_slots=1)
        queue.submit(0)
        clock.now = 0.3
        (r,) = sched.drain()
        assert r.queue_wait_s == pytest.approx(0.3)
        assert r.service_s == pytest.approx(0.1)
        assert r.latency_s == pytest.approx(0.4)

    def test_queue_wait_visible_in_flush_sync_mode(self):
        clock = Clock()
        server = DBSearchServer(_tiny_db(7), k=2, fdr=0.5, max_batch_size=4,
                                flush_timeout_s=1.0, clock=clock)
        server.submit(_tiny_query(7))
        assert server.step() == []
        clock.now = 1.5
        (r,) = server.step()
        assert r.t_submit == 0.0
        assert r.queue_wait_s == pytest.approx(1.5)
        assert r.latency_s == pytest.approx(1.5)
        assert server.summary()["queue_wait_p50_ms"] == pytest.approx(1500.0)

    def test_stats_summary_reports_queue_wait_percentiles(self):
        clock = Clock()
        queue = MicroBatchQueue(max_batch_size=2, clock=clock)
        ex = SimulatedExecutor(clock, c0=0.05, c1=0.0)
        sched = ContinuousScheduler(queue, ex, num_slots=1)
        stats = LatencyStats()
        for _ in range(4):
            queue.submit(0)
        clock.now = 0.2
        stats.record_batch(sched.drain())
        s = stats.summary()
        assert s["queue_wait_p50_ms"] > 0.0
        assert s["queue_wait_p95_ms"] >= s["queue_wait_p50_ms"]
        assert s["p50_ms"] > s["queue_wait_p50_ms"]


# --------------------------------------------------------------------------
# tail latency: continuous vs flush-sync on an open-loop trace
# --------------------------------------------------------------------------

def _drive(trace, clock, queue, step_fn, drain_fn, tick=0.005):
    done = []
    for t_arrival, n in trace:
        while clock.now < t_arrival:
            clock.now = min(t_arrival, clock.now + tick)
            done.extend(step_fn())
        for _ in range(n):
            queue.submit(0)
        done.extend(step_fn())
    done.extend(drain_fn())
    return done


def _open_loop_trace():
    trace = []
    t = 0.0
    for _ in range(10):
        trace.append((t, 8))
        t += 0.08
    for _ in range(8):
        trace.append((t, 1))
        t += 0.7
    return trace


class TestTailLatency:
    FLUSH_TIMEOUT = 0.5

    def _run_flush_sync(self, trace):
        clock = Clock()
        queue = MicroBatchQueue(max_batch_size=8,
                                flush_timeout_s=self.FLUSH_TIMEOUT,
                                clock=clock)
        ex = SimulatedExecutor(clock)

        def step():
            if not queue.ready():
                return []
            return ex.finalize(ex.dispatch(queue.take_batch()))

        def drain():
            done = []
            while len(queue):
                done.extend(ex.finalize(ex.dispatch(queue.take_batch())))
            return done

        return _drive(trace, clock, queue, step, drain)

    def _run_continuous(self, trace):
        clock = Clock()
        queue = MicroBatchQueue(max_batch_size=8,
                                flush_timeout_s=self.FLUSH_TIMEOUT,
                                clock=clock)
        sched = ContinuousScheduler(queue, SimulatedExecutor(clock),
                                    num_slots=2)
        return _drive(trace, clock, queue, sched.step, sched.drain)

    def test_continuous_holds_p95_within_4x_p50(self):
        trace = _open_loop_trace()
        total = sum(n for _, n in trace)
        sync_done = self._run_flush_sync(trace)
        cont_done = self._run_continuous(trace)
        assert len(sync_done) == len(cont_done) == total

        def ratio(done):
            lat = np.asarray([r.latency_s for r in done])
            return float(np.percentile(lat, 95) / np.percentile(lat, 50))

        sync_ratio, cont_ratio = ratio(sync_done), ratio(cont_done)
        assert sync_ratio > 4.0, sync_ratio
        assert cont_ratio <= 4.0, cont_ratio
        assert cont_ratio < sync_ratio / 2


# --------------------------------------------------------------------------
# both modes through the real executor
# --------------------------------------------------------------------------

class TestServerModes:
    def test_continuous_and_flush_sync_bit_identical(self):
        queries = [_tiny_query(100 + i) for i in range(7)]
        results = {}
        for continuous in (False, True):
            clock = Clock()
            server = DBSearchServer(_tiny_db(3), k=3, fdr=0.5,
                                    max_batch_size=4, flush_timeout_s=0.01,
                                    clock=clock, continuous=continuous,
                                    num_slots=2)
            rids = [server.submit(q) for q in queries]
            done = server.run_until_drained()
            assert sorted(r.rid for r in done) == rids
            results[continuous] = {
                r.rid: (tuple(r.result.indices), tuple(r.result.scores),
                        r.result.match) for r in done}
            assert server.summary()["mode"] == (
                "continuous" if continuous else "flush-sync")
        assert results[False] == results[True]

    def test_bucket_reuse_across_admissions(self):
        clock = Clock()
        server = DBSearchServer(_tiny_db(4), k=2, fdr=0.5, max_batch_size=8,
                                clock=clock, buckets=2, continuous=True,
                                num_slots=1)
        for i in range(3):
            server.submit(_tiny_query(i))
        server.run_until_drained()
        for i in range(3):
            server.submit(_tiny_query(10 + i))
        server.run_until_drained()
        assert server.summary()["buckets"] == {4: 2}

    def test_server_cancel_roundtrip(self):
        clock = Clock()
        server = DBSearchServer(_tiny_db(5), k=2, fdr=0.5, max_batch_size=8,
                                clock=clock, continuous=True, num_slots=1)
        rids = [server.submit(_tiny_query(i)) for i in range(3)]
        assert server.cancel(rids[1]) is True
        done = server.run_until_drained()
        assert sorted(r.rid for r in done) == [rids[0], rids[2]]


# --------------------------------------------------------------------------
# the port against the reference: one trace through both servers
# --------------------------------------------------------------------------

class TraceExecutor:
    """Wraps a server's real executor: records each dispatched batch's
    rids and the retire order. ``poll`` reports a batch done once it has
    been polled ``lag`` times, so both packages retire at the same steps
    whatever their runtimes' readiness."""

    def __init__(self, inner, lag):
        self.inner = inner
        self.lag = lag
        self.dispatched = []
        self.retired = []
        self._polls = {}

    def dispatch(self, reqs):
        h = self.inner.dispatch(reqs)
        self.dispatched.append([r.rid for r in reqs])
        self._polls[id(h)] = 0
        return h

    def poll(self, h):
        self._polls[id(h)] += 1
        return self._polls[id(h)] > self.lag

    def finalize(self, h):
        live = self.inner.finalize(h)
        self.retired.append([r.rid for r in h.reqs])
        return live


def _trace(seed, n):
    """(arrival time, tenant, query seed, precursor) of an open-loop trace:
    bursts of 1-6 requests over two tenants, gaps of 0-20 ms."""
    rng = np.random.default_rng(seed)
    out, t = [], 0.0
    while len(out) < n:
        for _ in range(int(rng.integers(1, 7))):
            out.append((t, "a" if rng.random() < 0.7 else "b",
                        int(rng.integers(0, 40)),
                        float(rng.uniform(420, 1650))))
        t += float(rng.uniform(0.0, 0.02))
    return out[:n]


def _run_trace(make_server, wrap, trace, oms):
    clock = Clock()
    server = make_server(clock)
    ex = wrap(server)
    rid_of, done = {}, []
    for i, (t, tenant, q, prec) in enumerate(trace):
        while clock.now < t:
            clock.now = min(t, clock.now + 0.004)
            done.extend(server.step())
        rid_of[i] = server.submit(_tiny_query(q), tenant=tenant,
                                  precursor=prec if oms else None)
        if i % 3 == 2:
            done.extend(server.step())
    done.extend(server.run_until_drained())
    by_rid = {r.rid: r.result for r in done}
    results = [by_rid[rid_of[i]] for i in range(len(trace))]
    return ex, results, server.summary()


def _wrap_jax(lag):
    def wrap(server):
        ex = TraceExecutor(server.executor, lag)
        server.executor = ex
        if server.scheduler is not None:
            server.scheduler.executor = ex
        return ex
    return wrap


@pytest.mark.parametrize("oms", [False, True], ids=["exact", "oms"])
@pytest.mark.parametrize("continuous,num_slots,lag",
                         [(True, 2, 0), (True, 2, 2), (True, 3, 1),
                          (True, 1, 0), (False, 2, 0)])
def test_trace_matches_the_reference_server(continuous, num_slots, lag, oms):
    """The same trace through the reference's server and the port's, each
    on its real executor: equal batch compositions, dispatch and retire
    order, per-request results, bucket use and scheduler counters."""
    trace = _trace(7 + num_slots + 3 * lag, 60)
    prec = np.random.default_rng(1).uniform(400, 1600, 24).astype(np.float32)
    jcfg = JOMSConfig(tol=20.0, open_tol=200.0) if oms else None
    cfg = OMSConfig(tol=20.0, open_tol=200.0) if oms else None
    kw = dict(k=3, fdr=0.5, max_batch_size=6, flush_timeout_s=0.01,
              buckets=2, fairness_cap=4, continuous=continuous,
              num_slots=num_slots)

    def make_jax(clock):
        from repro.serve import BankRegistry as JRegistry
        reg = JRegistry()
        for i, t in enumerate(("a", "b")):
            refs, dec = _tiny_hvs(30 + i)
            reg.register(t, jnp.asarray(refs), decoys=jnp.asarray(dec),
                         precursor=prec if oms else None)
        return JServer(reg, clock=clock, oms=jcfg, **kw)

    def make_port(clock):
        from repro_torch.serve import BankRegistry
        reg = BankRegistry()
        for i, t in enumerate(("a", "b")):
            refs, dec = _tiny_hvs(30 + i)
            reg.register(t, torch.from_numpy(refs),
                         decoys=torch.from_numpy(dec),
                         precursor=prec if oms else None)
        return DBSearchServer(reg, clock=clock, oms=cfg, **kw)

    jex, jres, js = _run_trace(make_jax, _wrap_jax(lag), trace, oms)
    pex, pres, ps = _run_trace(make_port, _wrap_jax(lag), trace, oms)
    assert pex.dispatched == jex.dispatched
    assert pex.retired == jex.retired
    for p, j in zip(pres, jres):
        assert (np.asarray(p.indices) == np.asarray(j.indices)).all()
        assert (np.asarray(p.scores) == np.asarray(j.scores)).all()
        assert (p.is_target, p.accept, p.match, p.has_candidate) == (
            bool(j.is_target), bool(j.accept), int(j.match),
            bool(j.has_candidate))
    assert ps["buckets"] == js["buckets"]
    assert ps["mode"] == js["mode"]
    assert ps["scheduler"] == js["scheduler"]
    for t in ("a", "b"):
        for key in ("cache_hits", "cache_misses", "count"):
            assert ps["tenants"][t][key] == js["tenants"][t][key], (t, key)


def test_continuous_equals_flush_sync_through_the_real_executor():
    """One trace through the port's server in both modes, two tenants,
    cancellations included: every surviving request's result is equal."""
    trace = _trace(11, 48)
    out = {}
    for continuous in (False, True):
        clock = Clock()
        from repro_torch.serve import BankRegistry
        reg = BankRegistry()
        for i, t in enumerate(("a", "b")):
            refs, dec = _tiny_hvs(40 + i)
            reg.register(t, torch.from_numpy(refs),
                         decoys=torch.from_numpy(dec))
        server = DBSearchServer(reg, k=4, fdr=0.5, max_batch_size=5,
                                flush_timeout_s=0.01, clock=clock,
                                buckets=3, continuous=continuous,
                                num_slots=2)
        rids = [server.submit(_tiny_query(q), tenant=tn)
                for _, tn, q, _ in trace]
        for rid in rids[::9]:
            assert server.cancel(rid)
        done = server.run_until_drained()
        out[continuous] = {r.rid: (tuple(r.result.indices),
                                   tuple(r.result.scores), r.result.accept,
                                   r.result.match) for r in done}
        assert sorted(out[continuous]) == sorted(
            set(rids) - set(rids[::9]))
    assert out[False] == out[True]


def test_executor_subclass_observes_every_batch():
    """``executor_cls`` still builds the executor on the server in
    continuous mode, and the staging pool holds no more arenas than
    batches were in flight at once."""
    seen = []

    class Observing(SearchExecutor):
        def dispatch(self, reqs):
            h = super().dispatch(reqs)
            seen.append(h.n)
            return h

    server = DBSearchServer(_tiny_db(9), k=2, fdr=0.5, max_batch_size=4,
                            clock=Clock(), continuous=True, num_slots=2,
                            executor_cls=Observing)
    for i in range(11):
        server.submit(_tiny_query(200 + i))
    done = server.run_until_drained()
    assert len(done) == 11 and sum(seen) == 11
    assert isinstance(server.executor, Observing)
    assert server.executor.staging.arenas <= 2


# --------------------------------------------------------------------------
# over a mesh: rank 0 plans each step (CoordinatedScheduler); one rank
# issues no collective
# --------------------------------------------------------------------------

class Exchange:
    """In-process stand-in for the all-gather: ``world`` threads meet at a
    barrier and each gets every rank's row; counts the exchanges."""

    def __init__(self, world: int):
        self.barrier = threading.Barrier(world, timeout=20)
        self.rows = [None] * world
        self.calls = 0

    def for_rank(self, rank: int):
        def exchange(row):
            self.rows[rank] = row.clone()
            self.barrier.wait()
            out = torch.stack(self.rows)
            self.barrier.wait()
            if rank == 0:
                self.calls += 1
            return out
        return exchange


class PolledExecutor(RecordingExecutor):
    """A recording executor whose handles are done when ``done(h)`` says
    so; counts its polls."""

    def __init__(self, clock, done):
        super().__init__(clock)
        self.done = done
        self.polls = 0

    def poll(self, h):
        self.polls += 1
        return self.done(h)


def _ranks(world, script, *, done=lambda h: True, max_batch=3,
           num_slots=2, fairness_cap=None):
    """Runs ``script(rank, queue, sched)`` on ``world`` threads, each with
    its own queue, executor and CoordinatedScheduler over one Exchange;
    returns each rank's (error message or None, executor) and the
    exchange."""
    ex_all = Exchange(world)
    out = [None] * world

    def body(rank):
        clock = Clock()
        queue = MicroBatchQueue(max_batch_size=max_batch,
                                flush_timeout_s=0.0, clock=clock,
                                fairness_cap=fairness_cap)
        ex = PolledExecutor(clock, done)
        sched = CoordinatedScheduler(queue, ex, num_slots=num_slots,
                                     rank=rank,
                                     exchange=ex_all.for_rank(rank))
        try:
            script(rank, queue, sched)
            out[rank] = (None, ex, sched)
        except RuntimeError as e:
            out[rank] = (str(e), ex, sched)

    threads = [threading.Thread(target=body, args=(r,))
               for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads), "a rank hung"
    return out, ex_all


def _batches(ex):
    return [[r.rid for r in b] for b in ex.dispatched]


def _serve_alike(rank, queue, sched):
    for i in range(11):
        queue.submit(np.full(4, i, np.int8), tenant="ab"[i % 3 == 0])
        sched.step()
    sched.drain()


@pytest.mark.parametrize("world", [2, 3, 4])
def test_coordinated_ranks_dispatch_rank_0s_batches(world):
    out, ex_all = _ranks(world, _serve_alike, done=lambda h: h % 3 != 1,
                         fairness_cap=2)
    errs = [e for e, _, _ in out]
    assert errs == [None] * world
    want = _batches(out[0][1])
    assert sorted(r for b in want for r in b) == list(range(11))
    for _, ex, sched in out:
        assert _batches(ex) == want
        assert sched.in_flight == 0 and len(sched.queue) == 0
        assert sched.exchanges == ex_all.calls
    # rank 0 alone polls; the others finalize what it retired
    assert out[0][1].polls > 0
    assert all(ex.polls == 0 for _, ex, _ in out[1:])


def test_rank_0s_polls_decide_every_ranks_retires():
    """Rank 0's handles 1 and 2 stay busy for the first steps; rank 1's
    executor would call everything done but is never asked: both retire
    the same slots at the same steps."""
    busy = {1, 2}

    def script(rank, queue, sched):
        for i in range(6):
            queue.submit(np.full(4, i, np.int8))
        steps = []
        for _ in range(3):
            steps.append(sorted(r.rid for r in sched.step()))
        if rank == 0:
            busy.clear()
        steps.append(sorted(r.rid for r in sched.drain()))
        sched.retired_steps = steps

    out, _ = _ranks(2, script, done=lambda h: h not in busy, max_batch=2)
    assert [e for e, _, _ in out] == [None, None]
    assert out[0][2].retired_steps == out[1][2].retired_steps
    assert out[0][2].retired_steps[0] == []      # nothing done yet


def test_one_exchange_a_step():
    def script(rank, queue, sched):
        for i in range(5):
            queue.submit(np.full(4, i, np.int8))
            sched.step()
        assert sched.exchanges == 5

    out, ex_all = _ranks(3, script)
    assert [e for e, _, _ in out] == [None] * 3 and ex_all.calls == 5


@pytest.mark.parametrize("world", [2, 3])
def test_an_extra_request_raises_on_every_rank(world):
    def script(rank, queue, sched):
        for i in range(4):
            queue.submit(np.full(4, i, np.int8))
        sched.step(block=True)
        sched.step(block=True)
        if rank == world - 1:
            queue.submit(np.full(4, 99, np.int8))
        for i in range(4, 7):
            queue.submit(np.full(4, i, np.int8))
        sched.drain()

    out, _ = _ranks(world, script)
    for err, ex, _ in out:
        assert err is not None
        assert f"rank {world - 1} differs from rank 0's plan" in err
        assert "first differing request id 4 " in err and "other query" in err
        # nothing dispatched after the disagreement
        assert _batches(ex) == [[0, 1, 2], [3]]


def test_a_pending_cancel_on_rank_0_alone_raises():
    def script(rank, queue, sched):
        for i in range(7):
            queue.submit(np.full(4, i, np.int8))
        if rank == 0:
            assert sched.cancel(5)
        sched.drain()

    out, _ = _ranks(3, script)
    for err, ex, _ in out:
        assert "rank 1 differs from rank 0's plan" in err
        assert "first differing request id 5 " in err
        assert ex.dispatched == []


def test_a_cancel_beyond_the_next_batches_raises_too():
    """Rank 0 alone cancels a request past the batches each rank peeks:
    the pending counts differ, and every rank raises before dispatch."""
    def script(rank, queue, sched):
        for i in range(10):
            queue.submit(np.full(4, i, np.int8))
        if rank == 0:
            assert sched.cancel(8)
        sched.step()

    out, _ = _ranks(2, script, max_batch=2)
    for err, ex, _ in out:
        assert "rank 1 differs" in err and "beyond the next batches" in err
        assert "pending 10 vs 9" in err
        assert ex.dispatched == []


def test_cancels_made_alike_serve():
    def script(rank, queue, sched):
        for i in range(7):
            queue.submit(np.full(4, i, np.int8))
        sched.step(block=False)
        assert sched.cancel(1)       # in flight: marked
        assert sched.cancel(6)       # pending: removed
        done = sched.drain()
        sched.served = sorted(r.rid for r in done)

    out, _ = _ranks(2, script, done=lambda h: False)
    for err, _, sched in out:
        assert err is None
        assert sched.served == [0, 2, 3, 4, 5]
        assert sched.cancellations == 2


def test_an_idle_rank_drains_with_the_others():
    """A rank whose queue is empty still takes part in ``drain``: a rank
    holding requests the others lack raises instead of hanging."""
    def script(rank, queue, sched):
        if rank == 1:
            queue.submit(np.full(4, 0, np.int8))
        sched.drain()

    out, _ = _ranks(2, script)
    for err, ex, _ in out:
        assert "rank 1 differs" in err and "first differing request id 0 " \
            in err
        assert ex.dispatched == []


def test_idle_ranks_agree_in_one_exchange():
    out, ex_all = _ranks(3, lambda rank, queue, sched: sched.drain())
    assert [e for e, _, _ in out] == [None] * 3 and ex_all.calls == 1


def test_peek_batches_leaves_the_queue_as_it_was():
    clock = Clock()
    queue = MicroBatchQueue(max_batch_size=2, flush_timeout_s=0.0,
                            clock=clock, fairness_cap=1)
    for i in range(7):
        queue.submit(i, tenant="ab"[i % 2])
    peeked = [[r.rid for r in b] for b in queue.peek_batches(3)]
    assert len(queue) == 7
    taken = [[r.rid for r in queue.take_batch()] for _ in range(3)]
    assert peeked == taken
    assert queue.next_rid == 7
    assert queue.peek_batches(10) == queue.peek_batches(10)
    assert len(queue.peek_batches(10)) == 4


COLLECTIVES = ("all_gather", "all_gather_into_tensor", "all_reduce",
               "broadcast", "barrier", "reduce", "gather", "scatter",
               "reduce_scatter_tensor", "all_to_all_single", "send", "recv")


@pytest.mark.parametrize("mesh_kind", ["none", "mapping", "one_rank_group"])
def test_one_rank_issues_no_collective(monkeypatch, tmp_path, mesh_kind):
    """With no mesh, the one-device mapping or a 1-rank group's (1, 1)
    mesh, continuous serving builds the plain ContinuousScheduler and
    serves without any collective (each is replaced by a counting
    fake)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.serve import BankRegistry, ContinuousScheduler

    own_group = mesh_kind == "one_rank_group"
    if own_group:
        dist.init_process_group("gloo", init_method=f"file://{tmp_path}/s",
                                rank=0, world_size=1)
    try:
        mesh = {"none": None, "mapping": {"data": 1, "model": 1}}.get(
            mesh_kind)
        if own_group:
            mesh = init_device_mesh("cpu", (1, 1),
                                    mesh_dim_names=("data", "model"))
        calls = []
        for name in COLLECTIVES:
            monkeypatch.setattr(dist, name,
                                lambda *a, _n=name, **k: calls.append(_n))
        reg = BankRegistry(mesh=mesh, fused=True)
        refs, dec = _tiny_hvs(70)
        reg.register("a", torch.from_numpy(refs),
                     decoys=torch.from_numpy(dec))
        server = DBSearchServer(reg, k=2, fdr=0.5, max_batch_size=3,
                                clock=Clock(), continuous=True, num_slots=2)
        assert type(server.scheduler) is ContinuousScheduler
        for i in range(8):
            server.submit(_tiny_query(300 + i), tenant="a")
            server.step()
        server.append("a", refs[:2], dec[:1])
        server.submit(_tiny_query(400), tenant="a")
        server.run_until_drained()
        assert server.stats.summary()["count"] == 9
        assert calls == []
    finally:
        monkeypatch.undo()
        if own_group:
            dist.destroy_process_group()
