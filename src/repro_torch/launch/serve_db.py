"""Multi-tenant DB-search serving launcher, exact or open-modification,
in PyTorch, on one card or over a device mesh.

HD-encodes one synthetic spectral library (+ m/z-reversed decoys) per
tenant, registers them in a lazy
:class:`~repro_torch.serve.cache.BankRegistry` (tenant 0 pinned hot),
then streams bursty, hot-tenant-skewed queries, drawn with replacement
so repeats hit the :class:`~repro_torch.serve.cache.QueryHVCache`,
through the :class:`~repro_torch.serve.DBSearchServer`, flush-sync or,
with ``--continuous``, with ``--num-slots`` batches in flight
(closed-loop: the generator blocks on the oldest slot once a bucket's
worth of requests is queued). Reports queries/sec, aggregate and
per-tenant p50/p95 latency, cache and bank counters, the scheduler's
counters, identifications at the requested FDR, the library generation +
encode time and the hot bank's build time, peak device memory, each
kernel's launch count, and the serving span beside the traffic
generator's sleeps and the device's busy seconds (CUDA events around each
batch's device work) with the device's idle share of the rest; in
flush-sync mode also the host's share (there host and device take turns;
in continuous mode they overlap).

``--append FRAC`` holds that fraction of every bank (a suffix of its
refs and decoys) out of the registration and streams it back in with
``server.append`` halfway through the run: later batches search the
exact merged base + delta (:mod:`repro_torch.serve.delta`), and
``--compact-threshold`` folds a delta past that fraction of its tenant's
rows into the packed base between batches. The run prints the append's
and the compactions' counts and the rows still pending.

``--fused`` searches each bank through the ``topk_hamming`` kernel;
``--fused-e2e`` submits raw quantized spectra and runs the
``encode_search`` kernel. ``--oms`` serves open-modification search:
banks are precursor-sorted, each query carries its precursor and scans
only its window (``query - ref`` in ``(-tolerance, open-tol)``), through
the banded twins of those kernels, and the run prints its candidate and
scanned fractions. Runs on CUDA unless ``--device cpu``.

**Over a mesh.** The run prints ``mesh: {...}`` from
:func:`~repro_torch.launch.mesh.make_debug_mesh`. Under ``torchrun``
(``WORLD_SIZE`` > 1) it joins the process group from the environment
(NCCL on CUDA; gloo on the CPU, and where a node runs more ranks than it
has cards, which NCCL refuses) and
serves over the debug mesh: every bank is row-sharded over ``model``
(each rank keeps its own block on its device; the library's rows wait on
the host), queries split over ``data``, every rank draws the same
traffic from ``--seed``, and rank 0 alone prints. Flush-sync, the ranks
agree on each flush; ``--continuous`` (with ``--append`` and
``--compact-threshold`` as in one process), rank 0 plans each step and
the ranks agree on it (``serve.scheduler.CoordinatedScheduler``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve_db --reduced --fused
  PYTHONPATH=src python -m repro_torch.launch.serve_db --reduced --oms \\
      --device cpu --fused-e2e
  PYTHONPATH=src python -m repro_torch.launch.serve_db --reduced \\
      --device cpu --tenants 4 --cache-mb 16 --buckets 3 --fairness-cap 8
  PYTHONPATH=src python -m repro_torch.launch.serve_db --reduced \\
      --device cpu --fused --continuous --append 0.25 \\
      --compact-threshold 0.1
  PYTHONPATH=src torchrun --nproc-per-node 2 -m \\
      repro_torch.launch.serve_db --reduced --device cpu --fused
  PYTHONPATH=src torchrun --nproc-per-node 2 -m \\
      repro_torch.launch.serve_db --reduced --device cpu --fused \\
      --continuous --append 0.25
"""

from __future__ import annotations

import argparse
import contextlib
import io
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import SpecPCMConfig, encode_and_pack
from repro_torch.core.hd.encoding import quantize_levels
from repro_torch.device import resolve_device
from repro_torch.dist.sharding import mesh_shape
from repro_torch.kernels.encode_search import (
    encode_search,
    encode_search_banded,
)
from repro_torch.kernels.topk_hamming import topk_hamming, topk_hamming_banded
from repro_torch.launch.mesh import join_group, make_debug_mesh
from repro_torch.serve import (
    BankRegistry,
    DBSearchServer,
    OMSConfig,
    QueryEncoder,
    SearchExecutor,
    fdr_route,
    oms_plan,
    oms_search_levels,
    oms_search_with_fdr,
    search_database_levels,
    search_with_fdr,
)
from repro_torch.spectra import (
    SyntheticMSConfig,
    generate_dataset,
    generate_query_set,
    make_decoys,
)

KERNELS = {"topk_hamming": topk_hamming, "encode_search": encode_search,
           "topk_hamming_banded": topk_hamming_banded,
           "encode_search_banded": encode_search_banded}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None, *, executor_cls: type[SearchExecutor] = SearchExecutor):
    """Runs the launcher; returns the server summary with the launcher's
    own keys added. ``executor_cls`` is passed to the server (a subclass
    of :class:`SearchExecutor` observes the served batches)."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--reduced", action="store_true",
                    help="small sizes for CPU smoke runs")
    ap.add_argument("--hd-dim", type=int, default=None)
    ap.add_argument("--identities", type=int, default=None)
    ap.add_argument("--refs-per-identity", type=int, default=None)
    ap.add_argument("--queries", type=int, default=None,
                    help="requests per tenant")
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--max-batch", type=int, default=None)
    ap.add_argument("--flush-ms", type=float, default=5.0)
    ap.add_argument("--fdr", type=float, default=0.01)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-pack", action="store_true",
                    help="disable the bit-packed XOR+popcount bank")
    ap.add_argument("--fused", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="search each bank through the streaming top-k "
                         "kernel (topk_hamming)")
    ap.add_argument("--fused-e2e", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="submit raw quantized spectra and run the fused "
                         "encode->pack->search kernel (encode_search); "
                         "batches merged with a delta take the staged "
                         "encode and search the base as --fused says")
    ap.add_argument("--tenants", type=int, default=1,
                    help="number of tenant banks (tenant 0 is pinned hot)")
    ap.add_argument("--cache-mb", type=float, default=64.0,
                    help="query-HV cache byte budget in MiB (0 disables)")
    ap.add_argument("--buckets", type=int, default=4,
                    help="batch-shape buckets (geometric ladder up to "
                         "--max-batch; 1 = always pad to max)")
    ap.add_argument("--fairness-cap", type=int, default=None,
                    help="max requests one tenant may take per flush while "
                         "others wait (default: no cap)")
    ap.add_argument("--max-banks", type=int, default=None,
                    help="LRU-evict cold built banks beyond this many "
                         "(default: keep all)")
    ap.add_argument("--oms", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="open-modification serving: banks are "
                         "precursor-sorted and each query scans only its "
                         "precursor window (query - ref in "
                         "(-tolerance, open-tol))")
    ap.add_argument("--tolerance", type=float, default=20.0,
                    help="precursor tolerance on the light side (and both "
                         "sides for exact search)")
    ap.add_argument("--open-tol", type=float, default=200.0,
                    help="how much heavier than a reference an OMS query "
                         "may be (the modification-mass budget)")
    ap.add_argument("--continuous", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="continuous batching: keep --num-slots batches in "
                         "flight and admit queued requests as soon as a "
                         "slot frees, instead of flush-and-wait "
                         "(--flush-ms is inert)")
    ap.add_argument("--num-slots", type=int, default=2,
                    help="in-flight batch slots for --continuous (2: one "
                         "batch's host preparation overlaps the other's "
                         "device search)")
    ap.add_argument("--append", type=float, default=0.0, metavar="FRAC",
                    help="hold this fraction of every bank out of the "
                         "registration and stream it back in with "
                         "server.append() halfway through the run; later "
                         "searches take the exact merged base + delta "
                         "route (0 disables)")
    ap.add_argument("--compact-threshold", type=float, default=None,
                    help="fold a tenant's delta into its packed base once "
                         "the delta exceeds this fraction of its rows "
                         "(default: never compact)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without one)")
    args = ap.parse_args(argv)

    if args.tenants < 1:
        raise SystemExit("--tenants must be >= 1")
    if not 0.0 <= args.append < 1.0:
        raise SystemExit("--append must be in [0, 1)")
    dev = resolve_device(args.device)
    own_group = join_group(dev)
    try:
        # rank 0 alone reports
        quiet = dist.is_initialized() and dist.get_rank() > 0
        with (contextlib.redirect_stdout(io.StringIO()) if quiet
              else contextlib.nullcontext()):
            return _serve(args, dev, executor_cls)
    finally:
        if own_group:
            dist.destroy_process_group()


def _serve(args, dev: torch.device, executor_cls):
    """The launcher's run on this rank (the only one without a process
    group); returns the server summary with the launcher's keys."""
    mesh = make_debug_mesh(device_type=dev.type)
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    # banks row-shard over 'model': the library's rows wait on the host
    sharded = mesh_shape(mesh)["model"] > 1

    if args.reduced:
        dim = args.hd_dim or 512
        n_id = args.identities or 48
        per_id = args.refs_per_identity or 2
        n_q = args.queries or 64
        max_batch = args.max_batch or 16
        num_bins = 256
    else:
        dim = args.hd_dim or 2048
        n_id = args.identities or 256
        per_id = args.refs_per_identity or 4
        n_q = args.queries or 256
        max_batch = args.max_batch or 32
        num_bins = 1024
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {dev} ({name})")
    print(f"mesh: {mesh_shape(mesh)}"
          + (f" over {world} ranks" if world > 1 else ""))

    # SLC (1-bit) encoding keeps the HVs bipolar so the bank can be
    # bit-packed whenever D % 32 == 0.
    cfg = SpecPCMConfig(hd_dim=dim, mlc_bits=1, num_levels=16, ideal=True,
                        seed=args.seed)
    pack = False if args.no_pack else "auto"
    registry = BankRegistry(mesh=mesh, pack=pack, max_banks=args.max_banks,
                            fused=args.fused)

    # OMS traffic: modified queries carry a heavier precursor (a
    # phospho-like mass addition), the case the open window exists for
    oms_cfg = (OMSConfig(tol=args.tolerance, open_tol=args.open_tol)
               if args.oms else None)
    mod_range = (60.0, 0.75 * args.open_tol) if args.oms else (0.0, 0.0)

    datasets, query_pools, precursor_pools = {}, {}, {}
    holdouts = {}  # tenant -> (refs, decoys, precursor) appended mid-run
    t0 = time.perf_counter()
    # on a sharded mesh the ranks generate in turn, each moving its
    # library to the host and freeing the device before the next
    for _ in range(rank if sharded else 0):
        dist.barrier()
    for t in range(args.tenants):
        tenant = f"tenant{t}"
        ms = SyntheticMSConfig(num_identities=n_id,
                               spectra_per_identity=per_id,
                               num_bins=num_bins, seed=args.seed + 31 * t,
                               modification_mass_range=mod_range)
        ds = generate_dataset(ms, device=dev)
        refs_hv = encode_and_pack(ds.spectra, cfg)
        decoys_hv = encode_and_pack(make_decoys(ds.spectra), cfg)
        prec = ds.precursor.cpu().numpy() if args.oms else None
        n_refs = int(refs_hv.shape[0])
        keep = n_refs - int(args.append * n_refs)
        if keep < n_refs:
            # hold out a *suffix* (kept on the device) so the append
            # restores the original row order: the identity arrays keep
            # indexing matches directly
            holdouts[tenant] = (
                refs_hv[keep:].clone(), decoys_hv[keep:].clone(),
                None if prec is None else prec[keep:])
            refs_hv, decoys_hv = refs_hv[:keep], decoys_hv[:keep]
            prec = None if prec is None else prec[:keep]
        if sharded:
            refs_hv, decoys_hv = refs_hv.cpu(), decoys_hv.cpu()
        registry.register(tenant, refs_hv, decoys=decoys_hv, pin=t == 0,
                          precursor=prec)
        qs = generate_query_set(ds, ms, num_queries=n_q,
                                seed=args.seed + 31 * t + 1)
        datasets[tenant] = (ds.identity.cpu().numpy(),
                            qs.identity.cpu().numpy())
        precursor_pools[tenant] = qs.precursor.cpu().numpy()
        if args.fused_e2e:
            # raw quantized spectra: the server encodes on the device
            query_pools[tenant] = quantize_levels(
                qs.spectra, cfg.num_levels).cpu().numpy()
        else:
            query_pools[tenant] = encode_and_pack(qs.spectra,
                                                  cfg).cpu().numpy()
        del ds, qs, refs_hv, decoys_hv
    _sync(dev)
    if sharded:
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        for _ in range(world - 1 - rank):
            dist.barrier()
    library_s = time.perf_counter() - t0
    print(f"libraries: {args.tenants} x {n_id * per_id} spectra (+ as many "
          f"decoys) and their query pools generated and encoded in "
          f"{library_s:.3f} s")
    print(f"{args.tenants} tenant bank(s) registered (lazy; built on first "
          f"request), D={dim}, pack={pack}, fused={args.fused}, "
          f"oms={args.oms}, fused_e2e={args.fused_e2e}, "
          f"mode={'continuous' if args.continuous else 'flush-sync'}"
          + (f", {args.num_slots} slots" if args.continuous else "")
          + (f"; {sum(h[0].shape[0] for h in holdouts.values())} refs (and "
             f"as many decoys) held out to append mid-run"
             if holdouts else ""))

    # every tenant encodes with the same SpecPCMConfig, so one query-side
    # codebook bundle serves the whole fleet
    encoder = (QueryEncoder.from_config(
        dim=dim, num_features=num_bins, num_levels=cfg.num_levels,
        seed=args.seed, device=dev) if args.fused_e2e else None)

    server = DBSearchServer(
        registry, k=args.k, fdr=args.fdr, max_batch_size=max_batch,
        flush_timeout_s=args.flush_ms / 1e3,
        cache_bytes=int(args.cache_mb * 2**20) or None,
        buckets=args.buckets, fairness_cap=args.fairness_cap, oms=oms_cfg,
        encoder=encoder, fused_e2e=args.fused_e2e,
        continuous=args.continuous, num_slots=args.num_slots,
        compact_threshold=args.compact_threshold, executor_cls=executor_cls)

    # build the hot tenant's bank and warm the search + FDR path (and the
    # kernel build) at the largest bucket, so latency measures serving
    _sync(dev)
    t0 = time.perf_counter()
    db0 = registry.get("tenant0")
    _sync(dev)
    bank_build_s = time.perf_counter() - t0
    print(f"bank tenant0: {db0.num_rows} rows ({db0.num_decoys} decoys), "
          f"{db0.data.numel() * db0.data.element_size() / 2**20:.1f} MiB "
          f"on {dev}" + (f" on each of {db0.num_shards} model shards"
                         if db0.mesh is not None else "")
          + f", built in {bank_build_s:.3f} s")
    warm_prec = (np.sort(np.resize(precursor_pools["tenant0"], max_batch))
                 if args.oms else None)
    if args.fused_e2e:
        warm_q = torch.zeros((max_batch, num_bins), dtype=torch.int32,
                             device=dev)
        if args.oms:
            plan = oms_plan(db0, warm_prec, oms_cfg)
            idx, vals = oms_search_levels(db0, encoder, warm_q, plan, args.k,
                                          fused_e2e=True)
            fdr_route(db0, idx, vals, fdr=args.fdr,
                      valid=torch.from_numpy(plan.has_candidate).to(dev))
        else:
            idx, vals = search_database_levels(db0, encoder, warm_q, args.k,
                                               fused_e2e=True)
            fdr_route(db0, idx, vals, fdr=args.fdr)
    elif args.oms:
        oms_search_with_fdr(db0, torch.zeros((max_batch, dim),
                                             dtype=torch.int8, device=dev),
                            warm_prec, k=args.k, fdr=args.fdr, cfg=oms_cfg)
    else:
        search_with_fdr(db0, torch.zeros((max_batch, dim), dtype=torch.int8,
                                         device=dev), k=args.k, fdr=args.fdr)
    _sync(dev)

    # bursty, hot-tenant-skewed traffic; queries drawn WITH replacement so
    # repeats exercise the content-hash cache.
    rng = np.random.default_rng(args.seed)
    tenant_names = list(query_pools)
    probs = np.asarray([2.0] + [1.0] * (args.tenants - 1)
                       if args.tenants > 1 else [1.0])
    probs = probs / probs.sum()
    total = n_q * args.tenants
    meta = {}  # rid -> (tenant, query row)
    done = []
    sent = 0
    sleep_s = 0.0  # the traffic generator's idle gaps
    append_rows, append_s = 0, None
    while sent < total:
        if holdouts and sent >= total // 2:
            # stream the held-out rows back in: every later batch takes
            # the exact merged base + delta route (until compaction)
            t0 = time.perf_counter()
            for tenant, (h_refs, h_dec, h_prec) in holdouts.items():
                server.append(tenant, h_refs, h_dec, precursor=h_prec)
                append_rows += h_refs.shape[0] + h_dec.shape[0]
            _sync(dev)
            append_s = time.perf_counter() - t0
            print(f"appended {append_rows} rows across {len(holdouts)} "
                  f"tenant(s) in {append_s * 1e3:.1f} ms")
            holdouts = {}
        burst = int(rng.integers(1, max_batch + 1))
        for _ in range(min(burst, total - sent)):
            tenant = tenant_names[int(rng.choice(args.tenants, p=probs))]
            qi = int(rng.integers(0, query_pools[tenant].shape[0]))
            rid = server.submit(
                query_pools[tenant][qi], tenant=tenant,
                precursor=(float(precursor_pools[tenant][qi])
                           if args.oms else None))
            meta[rid] = (tenant, qi)
            sent += 1
        done.extend(server.step())
        # continuous mode decouples submission from device completion;
        # unpaced, the generator is an infinite-rate open loop and latency
        # only measures overload depth. Closed-loop backpressure (block on
        # the in-flight slots once a bucket's worth is queued) keeps the
        # run below saturation, so the numbers measure scheduling.
        while args.continuous and len(server.queue) >= max_batch:
            done.extend(server.step(force=True))
        if rng.random() < 0.3:  # idle gap: lets the flush timeout fire
            t0 = time.perf_counter()
            time.sleep(args.flush_ms / 1e3)
            sleep_s += time.perf_counter() - t0
            done.extend(server.step())
    done.extend(server.run_until_drained())
    if len(done) != total:
        raise RuntimeError(f"served {len(done)} of {total} requests")

    accepted = 0
    correct = 0
    for r in done:
        tenant, qi = meta[r.rid]
        if r.result.match >= 0:
            accepted += 1
            ref_ident, q_ident = datasets[tenant]
            correct += int(ref_ident[r.result.match] == q_ident[qi])

    s = server.summary()
    print(f"served {s['count']} queries in {s['batches']} micro-batches "
          f"(mean batch {s['mean_batch']:.1f}; "
          f"bucket usage {s['buckets']})")
    print(f"throughput: {s['qps']:.1f} queries/sec")
    print(f"latency: p50 {s['p50_ms']:.2f} ms, p95 {s['p95_ms']:.2f} ms, "
          f"mean {s['mean_ms']:.2f} ms (queue wait p50 "
          f"{s['queue_wait_p50_ms']:.2f} ms, p95 "
          f"{s['queue_wait_p95_ms']:.2f} ms)")
    sched = s["scheduler"]
    if sched is not None:
        print(f"scheduler: {sched['num_slots']} slots, "
              f"{sched['dispatched_batches']} dispatched / "
              f"{sched['retired_batches']} retired batches, "
              f"{sched['cancellations']} cancellations")
    qc = s["query_cache"]
    if qc is not None:
        print(f"query-HV cache: {qc['hits']} hits / {qc['misses']} misses "
              f"(hit rate {qc['hit_rate']:.1%}), {qc['entries']} entries, "
              f"{qc['bytes'] / 2**20:.2f}/{qc['capacity_bytes'] / 2**20:.0f} "
              f"MiB, {qc['evictions']} evictions")
    b = s["banks"]
    print(f"banks: {b['built']}/{b['registered']} built ({b['builds']} "
          f"builds, {b['evictions']} evictions, {b['pinned']} pinned)")
    if args.append:
        print(f"ingest: {b['appends']} appends, {b['compactions']} "
              f"compactions, {b['delta_rows']} delta rows pending "
              f"(compact threshold {s['ingest']['compact_threshold']})")
    for tenant in sorted(s["tenants"]):
        ts = s["tenants"][tenant]
        print(f"  {tenant}: {ts['count']} reqs, p50 {ts['p50_ms']:.2f} ms, "
              f"p95 {ts['p95_ms']:.2f} ms, "
              f"cache hit rate {ts['cache_hit_rate']:.1%}")
    o = s["oms"]
    if o is not None:
        print(f"oms: window (-{o['tol']:g}, +{o['open_tol']:g}), candidate "
              f"fraction {o['candidate_fraction']:.3f}, scanned fraction "
              f"{o['scanned_fraction']:.3f}, {o['no_candidate']} queries "
              f"with empty windows")
    # the serving span beside the generator's sleeps and the device's busy
    # time; the device idles for the rest of the non-sleep span. In
    # flush-sync mode the host waits for each batch, so that rest is the
    # host's work (batching, cache, copies, FDR, launch overhead); in
    # continuous mode host and device overlap and it is not
    span_s = s["count"] / s["qps"]
    busy_s = s["device_busy_s"]
    idle = (None if busy_s is None
            else 1.0 - busy_s / max(span_s - sleep_s, 1e-12))
    print(f"serving span {span_s:.4f} s: traffic-generator sleep "
          f"{sleep_s:.4f} s, device search "
          + ("not timed (no CUDA device)" if busy_s is None
             else f"{busy_s:.4f} s, device idle {idle:.1%} of the "
             f"non-sleep span"
             + ("" if args.continuous
                else f" (host {span_s - sleep_s - busy_s:.4f} s)")))
    print(f"identified at {args.fdr:.0%} FDR: {accepted}/{total} "
          f"({correct} correct identity)")
    launches = {n: fn.launches for n, fn in KERNELS.items()}
    print("kernel launches: " + ", ".join(f"{n} {c}"
                                          for n, c in launches.items()))
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    if peak is not None:
        print(f"peak device memory: {peak / 2**30:.2f} GiB")
    s.update(identified=accepted, correct=correct, total=total,
             library_s=library_s, bank_build_s=bank_build_s,
             span_s=span_s, sleep_s=sleep_s, device_idle_share=idle,
             append_rows=append_rows, append_s=append_s,
             launches=launches,
             peak_memory_bytes=peak)
    return s


if __name__ == "__main__":
    main()
