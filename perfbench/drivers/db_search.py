"""Cells of the spectral-library search: the port's ``DBSearchServer``
serving one library, exact (the ``encode_search`` route) or open (the
precursor-banded ``encode_search_banded`` route, and with appended rows the
merged base + delta route).

``run`` makes the cell's inputs from the seed, sets up the server, drives
it through the mix for the window, and checks what it served against the
plain reference in ``perfbench/reference``. It returns a :class:`Run` that
the harness's metric readers take their numbers from.
"""

from __future__ import annotations

import dataclasses
import gc
import random
import sys
import time

import numpy as np
import torch

from perfbench.harness import data, host, loop
from perfbench.harness.trace import Tracer
from perfbench.reference import search as ref

ENCODE_ROWS = 1 << 15       # library rows a program encode call takes
CELL_BITS = 1               # the port's banks hold one bit a cell


@dataclasses.dataclass
class Batch:
    """One served batch as the recording executor saw it."""

    t: float                  # host clock just after its dispatch returned
    n: int                    # real queries
    route: str                # "exact", "banded" or "merged"
    plan: object = None       # the program's window plan (open search)
    rids: list | None = None  # request ids in the batch's order
    results: list | None = None
    waits: np.ndarray | None = None  # the server's dispatch - submit
                                     # stamps (s)
    t_done: float | None = None


class Recorder:
    """Counts every batch dispatched and retired, collects those
    dispatched while ``active``, and keeps the answers of a uniform sample
    of ``keep`` of them, drawn from the seed as they are answered (a
    reservoir), so that the run holds no more answers than it checks. Only
    batches answered before ``t_until`` are drawn."""

    def __init__(self, seed: int, keep: int):
        self.active = False
        self.dispatched = self.retired = 0
        self.batches: list[Batch] = []
        self.sample: list[Batch] = []
        self.keep = keep
        self.seen = 0
        self.t_until = float("inf")
        self._rng = random.Random(int(seed) * 1_000_003 + 11)

    def offer(self, b: Batch, reqs) -> None:
        if b.t_done >= self.t_until:
            return
        self.seen += 1
        if len(self.sample) < self.keep:
            self.sample.append(b)
        else:
            j = self._rng.randrange(self.seen)
            if j >= self.keep:
                return
            self.sample[j] = b
        b.rids = [r.rid for r in reqs]
        b.results = [r.result for r in reqs]

    def executor_class(self):
        from repro_torch.serve import SearchExecutor
        rec = self

        class Recording(SearchExecutor):
            def dispatch(self, reqs):
                h = super().dispatch(reqs)
                rec.dispatched += 1
                if rec.active:
                    route = ("merged" if h.delta is not None else
                             "banded" if h.plan is not None else "exact")
                    b = Batch(t=time.perf_counter(), n=h.n, route=route,
                              plan=h.plan)
                    rec.batches.append(b)
                    h.perfbench_batch = b
                return h

            def finalize(self, handle):
                live = super().finalize(handle)
                rec.retired += 1
                b = getattr(handle, "perfbench_batch", None)
                if b is not None:
                    b.t_done = time.perf_counter()
                    b.waits = np.array([r.t_dispatch - r.t_submit
                                        for r in handle.reqs])
                    rec.offer(b, handle.reqs)
                return live

        return Recording


@dataclasses.dataclass
class Run:
    """What a run measured, for the metric readers."""

    seconds: float
    setup_s: float = 0.0
    completed: int = 0               # answers returned inside the window
    attempted: int = 0
    failed: int = 0
    latencies_s: np.ndarray | None = None   # open loop: due -> answer
    drain_wait_s: float = 0.0        # how long answers were waited for
                                     # after the window
    trace: object = None
    host_spans: list = dataclasses.field(default_factory=list)
    batches: list = dataclasses.field(default_factory=list)
    traced_batches: list = dataclasses.field(default_factory=list)
    sizes: dict = dataclasses.field(default_factory=dict)
    memory_peak_bytes: int = 0
    device_name: str = ""
    checks: dict = dataclasses.field(default_factory=dict)
    notes: dict = dataclasses.field(default_factory=dict)


class Cell:
    """The program set up for one run, with the inputs both sides share."""

    def __init__(self, cfg: dict, mix: dict, gen, seed: int, device,
                 trace: bool):
        from repro_torch.kernels.encode_search import pack_codebook
        from repro_torch.kernels.hd_encode import hd_encode
        from repro_torch.serve import (
            BankRegistry,
            DBSearchServer,
            OMSConfig,
            QueryEncoder,
        )

        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        hd, srch = cfg["hd"], cfg["search"]
        self.spec = data.SpectraSpec.from_config(cfg["library"])
        self.dim, self.levels_m = int(hd["dim"]), int(hd["num_levels"])
        if int(hd.get("cell_bits", CELL_BITS)) != CELL_BITS:
            raise ValueError(f"the port's banks hold {CELL_BITS} bit a "
                             f"cell; cell_bits {hd['cell_bits']} cannot run")
        self.tenant = str(srch["tenant"])
        self.k, self.fdr = int(srch["k"]), float(srch["fdr"])
        oms = srch.get("open_window")
        self.oms = None if oms is None else (float(oms["tol"]),
                                             float(oms["open_tol"]))
        F = self.spec.num_bins
        self.phases: dict[str, float] = {}
        self._t = time.perf_counter()
        self.id_hvs, self.level_hvs = data.make_codebooks(
            self.dim, F, self.levels_m, seed, device)
        self.lib = data.make_library(self.spec, self.levels_m, seed, device)
        N = self.lib.num_targets
        self._phase("library")
        # the program encodes the library (its Eq. 1 kernel on the card)
        words = (pack_codebook(self.id_hvs), pack_codebook(self.level_hvs))
        refs = torch.empty((N, self.dim), dtype=torch.int8, device=device)
        decoys = torch.empty_like(refs)
        for r0 in range(0, N, ENCODE_ROWS):
            lv = self.lib.levels[r0:r0 + ENCODE_ROWS].to(torch.int32)
            refs[r0:r0 + ENCODE_ROWS] = hd_encode(
                lv, self.id_hvs, self.level_hvs, codebook_words=words)
            decoys[r0:r0 + ENCODE_ROWS] = hd_encode(
                lv.flip(-1).contiguous(), self.id_hvs, self.level_hvs,
                codebook_words=words)
            del lv
        self._phase("encode")
        self.keep = N - int(float(mix.get("append_fraction", 0.0)) * N)
        prec = self.lib.precursor if self.oms else None
        registry = BankRegistry(pack="auto", fused=True)
        registry.register(self.tenant, refs[:self.keep],
                          decoys=decoys[:self.keep], pin=True,
                          precursor=None if prec is None
                          else prec[:self.keep])
        self.encoder = QueryEncoder(id_hvs=self.id_hvs,
                                    level_hvs=self.level_hvs)
        self.recorder = Recorder(seed, gen.SAMPLE_BATCHES)
        self.server = DBSearchServer(
            registry, k=self.k, fdr=self.fdr,
            max_batch_size=int(srch["max_batch"]),
            buckets=tuple(int(b) for b in srch["buckets"]),
            cache_bytes=int(float(srch["query_cache_mb"]) * 2**20) or None,
            oms=(None if self.oms is None
                 else OMSConfig(tol=self.oms[0], open_tol=self.oms[1])),
            encoder=self.encoder, fused_e2e=bool(srch["fused_e2e"]),
            continuous=bool(srch["continuous"]),
            num_slots=int(srch["num_slots"]),
            flush_timeout_s=float(srch.get("flush_timeout_ms", 10.0)) / 1e3,
            executor_cls=self.recorder.executor_class())
        self.registry = registry
        self.db = registry.get(self.tenant)            # builds the packed bank
        if self.keep < N:
            self.server.append(
                self.tenant, refs[self.keep:], decoys[self.keep:],
                precursor=None if prec is None else prec[self.keep:])
        del refs, decoys
        self._phase("bank")
        self.pool = data.make_queries(self.lib, self.spec, self.levels_m,
                                      int(mix["pool_spectra"]), seed,
                                      "queries", device)
        self.warm = data.make_queries(self.lib, self.spec, self.levels_m,
                                      gen.warm_spectra(self.max_batch), seed,
                                      "warmup", device)
        del self.lib.templates
        self._phase("queries")
        self.tracer = Tracer(torch, device) if trace else None

    def _phase(self, name: str) -> None:
        """Closes a set-up phase: its seconds, the device's work included."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t = time.perf_counter()
        self.phases[name] = t - self._t
        self._t = t

    @property
    def max_batch(self) -> int:
        return self.server.max_batch_size

    def submitter(self, pool: data.QueryPool):
        """A function that submits pool row ``i`` (cycling) and returns
        its request id."""
        submit, levels, prec = self.server.submit, pool.levels, pool.precursor
        n, tenant = len(pool), self.tenant
        if self.oms is None:
            return lambda i: submit(levels[i % n], tenant)
        return lambda i: submit(levels[i % n], tenant,
                                precursor=float(prec[i % n]))

    def warm_up(self, gen) -> None:
        """Serves warm-up queries at every batch shape the window uses, so
        that nothing builds or warms up inside it."""
        gen.warm_up(self)
        self._phase("warm_up")
        if self.tracer is not None:
            self.tracer.prepare()
            self._phase("profiler")


def check(cell: Cell, run: Run, control: int | None) -> dict:
    """Frees the program's state, then compares the bank the program
    built and a seed-drawn sample of its answers with the reference.
    ``control`` (cell bits) puts the reference computed over multi-level
    cells in the program's place."""
    dev = cell.device
    db = cell.db
    delta = cell.registry.delta(cell.tenant)
    prog_words = db.data
    delta_rows = (None if delta is None
                  else (delta.refs, delta.decoys))
    picked = list(cell.recorder.sample)
    rid0 = run.notes["rid0"]
    del db, delta
    cell.server = cell.registry = cell.db = cell.encoder = None
    cell.recorder = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    N, D, keep = cell.lib.num_targets, cell.dim, cell.keep
    # the reference's own library: [decoys; targets], original order
    bank = torch.empty((2 * N, D), dtype=torch.int8, device=dev)
    ref.encode(cell.lib.decoy_levels(), cell.id_hvs, cell.level_hvs,
               out=bank[:N])
    ref.encode(cell.lib.levels, cell.id_hvs, cell.level_hvs, out=bank[N:])
    prec = cell.lib.precursor
    # the program's base bank, stored row of each original base row
    if cell.oms is None:
        stored = np.arange(2 * keep)
    else:
        stored = ref.sorted_positions(prec[:keep], prec[:keep])
    base_orig = np.concatenate([np.arange(keep), N + np.arange(keep)])
    differing = 0
    for r0 in range(0, 2 * keep, 1 << 13):
        rows = torch.from_numpy(base_orig[r0:r0 + (1 << 13)]).to(dev)
        at = torch.from_numpy(stored[r0:r0 + (1 << 13)]).to(dev)
        want = ref.pack_words(bank[rows])
        differing += int((prog_words[at] != want).any(dim=1).sum())
    if delta_rows is not None:
        refs_d, dec_d = delta_rows
        differing += int((refs_d != bank[N + keep:]).any(dim=1).sum())
        differing += int((dec_d != bank[keep:N]).any(dim=1).sum())
    del prog_words, delta_rows

    # the sampled batches' answers
    idx = np.array([rid - rid0 for b in picked for rid in b.rids], np.int64)
    pool_i = idx % len(cell.pool)
    q_levels = torch.from_numpy(cell.pool.levels[pool_i]).to(dev)
    q_hv = ref.encode(q_levels, cell.id_hvs, cell.level_hvs)
    kw = {}
    if cell.oms is not None:
        kw = dict(row_prec=torch.from_numpy(np.concatenate([prec, prec])).to(
                      dev),
                  q_prec=torch.from_numpy(cell.pool.precursor[pool_i]).to(
                      dev),
                  tol=cell.oms[0], open_tol=cell.oms[1])
        position = torch.from_numpy(ref.sorted_positions(prec, prec)).to(dev)
    else:
        position = torch.arange(2 * N, device=dev)
    want = ref.search(q_hv, bank, cell.k, position=position, **kw)
    got = None
    if control is not None:
        got = ref.search(q_hv, bank, cell.k, position=position,
                         cell_bits=control, **kw)
    topk_bad = fdr_bad = 0
    at = 0
    for b in picked:
        n = len(b.rids)
        rows, vals, valid = (x[at:at + n] for x in want)
        is_t, acc, match = ref.fdr(rows[:, 0], vals[:, 0], N, cell.fdr,
                                   valid if cell.oms else None)
        if got is None:
            g_rows = np.stack([r.indices for r in b.results])
            g_vals = np.stack([r.scores for r in b.results])
            g_is_t = np.array([r.is_target for r in b.results])
            g_acc = np.array([r.accept for r in b.results])
            g_match = np.array([r.match for r in b.results])
            g_valid = np.array([r.has_candidate for r in b.results])
        else:
            g_rows, g_vals, g_valid = (x[at:at + n] for x in got)
            g_is_t, g_acc, g_match = ref.fdr(
                g_rows[:, 0], g_vals[:, 0], N, cell.fdr,
                g_valid if cell.oms else None)
        topk_bad += int(((g_rows != rows).any(axis=1)
                         | (g_vals != vals).any(axis=1)).sum())
        fdr_bad += int(((g_is_t != is_t) | (g_acc != acc)
                        | (g_match != match) | (g_valid != valid)).sum())
        at += n
    run.notes["reference_s"] = time.perf_counter() - t_ref
    run.notes["checked_queries"] = int(at)
    run.notes["checked_batches"] = len(picked)
    return {"bank_rows_differing": (differing, 0),
            "topk_mismatches": (topk_bad, 0),
            "fdr_mismatches": (fdr_bad, 0),
            "unanswered": (run.failed, 0)}


def run(cfg: dict, mix: dict, *, seed: int, seconds: float, trace: bool,
        device, t_start: float, rate: float | None = None,
        control: int | None = None) -> Run:
    gen = loop.check_mix(mix)
    result = Run(seconds=seconds)
    t_cell = time.perf_counter()
    cell = Cell(cfg, mix, gen, seed, device, trace)
    if cell.oms is not None:
        frac = data.candidate_fraction(cell.lib.precursor,
                                       cell.pool.precursor, *cell.oms)
        print(f"candidate fraction of the query pool: {frac:.5f} (source: "
              f"{cfg['library'].get('source_candidate_fraction')})",
              file=sys.stderr, flush=True)
    cell.warm_up(gen)
    # what set-up made lives on: keep the collector from walking it
    gc.collect()
    gc.freeze()
    result.notes["host_probe_ms"] = round(host.probe_ms(), 3)
    result.setup_s = time.perf_counter() - t_start
    result.notes["setup_phases_s"] = {
        "process_start": round(t_cell - t_start, 3),
        **{k: round(v, 3) for k, v in cell.phases.items()}}
    before = host.snapshot()
    gen.serve(cell, result, seconds, seed, rate)
    result.notes["host_window"] = host.over(before, host.snapshot())
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        result.memory_peak_bytes = int(torch.cuda.max_memory_allocated(
            device))
    result.device_name = (torch.cuda.get_device_name(device)
                          if device.type == "cuda" else "cpu")
    result.batches = list(cell.recorder.batches)
    if cell.tracer is not None:
        cell.tracer.finish()
    if cell.tracer is not None and cell.tracer.trace is not None:
        tr = cell.tracer.trace
        result.trace = tr
        result.notes["trace_events"] = dict(tr.counts, aligned=tr.aligned)
        result.notes["trace_start_ms"] = cell.tracer.start_s * 1e3
        result.traced_batches = [b for b in result.batches
                                 if tr.t0 <= b.t < tr.t1]
    result.sizes = {
        "dim": cell.dim, "num_features": cell.spec.num_bins, "k": cell.k,
        "max_batch": cell.max_batch, "base_rows": 2 * cell.keep}
    result.checks = check(cell, result, control)
    return result
