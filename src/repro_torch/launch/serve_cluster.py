"""Streaming spectral-clustering serving launcher (the paper's second
task), in PyTorch, on one card.

HD-encodes one synthetic spectrum stream per tenant on the device and
pushes it through the clustering endpoint of
:class:`~repro_torch.serve.DBSearchServer` (``submit_cluster``,
flush-sync, or with ``--continuous`` on ``--num-slots`` scheduler slots
with the same closed-loop backpressure as ``serve_db``; a batch then
scores the centroids of its dispatch, as the reference's continuous
mode does): per-tenant assign-or-spawn against the bit-packed centroid
bank on the device (the ``hamming_pop`` kernel), periodic
complete-linkage re-consolidation. Reports spectra/sec, latency, cluster
counts, the paper's clustering quality metrics against the synthetic
ground truth (clustered-spectra ratio, incorrect-clustering ratio), the
kernel's launch count, and how the serving span splits into the traffic
generator's sleeps, the device's distance steps (CUDA events), the
host's decision loop, the consolidations and the rest of the host's
work (in continuous mode the device's steps overlap the host's work, so
the device's idle share of the non-sleep span is printed instead of the
rest). Runs on CUDA unless ``--device cpu``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve_cluster --reduced
  PYTHONPATH=src python -m repro_torch.launch.serve_cluster --reduced \\
      --device cpu --tenants 2 --consolidate-every 64
  PYTHONPATH=src python -m repro_torch.launch.serve_cluster --reduced \\
      --device cpu --tenants 2 --consolidate-every 64 --continuous
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import SpecPCMConfig, encode_and_pack
from repro_torch.core.hd.clustering import (
    clustered_spectra_ratio,
    incorrect_clustering_ratio,
)
from repro_torch.device import resolve_device
from repro_torch.dist.sharding import mesh_shape
from repro_torch.kernels.hamming_pop import hamming_pop
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.serve import (
    BankRegistry,
    ClusteringConfig,
    DBSearchServer,
    SearchExecutor,
)
from repro_torch.spectra import SyntheticMSConfig, generate_dataset


def main(argv=None, *, executor_cls: type[SearchExecutor] = SearchExecutor):
    """Runs the launcher; returns the server summary with the launcher's
    own keys added. ``executor_cls`` is passed to the server (a subclass
    of :class:`SearchExecutor` observes the served batches)."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--reduced", action="store_true",
                    help="small sizes for CPU smoke runs")
    ap.add_argument("--hd-dim", type=int, default=None)
    ap.add_argument("--identities", type=int, default=None)
    ap.add_argument("--spectra-per-identity", type=int, default=None)
    ap.add_argument("--max-batch", type=int, default=None)
    ap.add_argument("--flush-ms", type=float, default=5.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tenants", type=int, default=1,
                    help="independent cluster streams (per-tenant state)")
    ap.add_argument("--threshold-frac", type=float, default=0.36,
                    help="assign threshold as a fraction of D (Hamming "
                         "distance to the nearest centroid; random HVs sit "
                         "near 0.5D, same-identity synthetic spectra near "
                         "0.3D)")
    ap.add_argument("--consolidate-every", type=int, default=0,
                    help="re-run complete linkage over the centroid bank "
                         "every this many assigned spectra (0 disables)")
    ap.add_argument("--no-pack", action="store_true",
                    help="disable the bit-packed popcount distance kernel")
    ap.add_argument("--continuous", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="continuous batching (scheduler slots shared "
                         "with search)")
    ap.add_argument("--num-slots", type=int, default=2,
                    help="in-flight batch slots for --continuous")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without one)")
    args = ap.parse_args(argv)

    if args.tenants < 1:
        raise SystemExit("--tenants must be >= 1")
    dev = resolve_device(args.device)
    if args.reduced:
        dim = args.hd_dim or 512
        n_id = args.identities or 24
        per_id = args.spectra_per_identity or 6
        max_batch = args.max_batch or 16
        num_bins = 256
    else:
        dim = args.hd_dim or 2048
        n_id = args.identities or 128
        per_id = args.spectra_per_identity or 8
        max_batch = args.max_batch or 32
        num_bins = 1024
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {dev} ({name})")
    # the clustering state has no mesh (as in the reference): one device
    print(f"mesh: {mesh_shape(make_debug_mesh(device_type=dev.type))}")

    cfg = SpecPCMConfig(hd_dim=dim, mlc_bits=1, num_levels=16, ideal=True,
                        seed=args.seed)
    ccfg = ClusteringConfig(
        dim=dim, threshold=args.threshold_frac * dim,
        consolidate_every=args.consolidate_every,
        pack=False if args.no_pack else "auto")

    streams = {}  # tenant -> (hvs (N, D) int8, identity (N,))
    t0 = time.perf_counter()
    for t in range(args.tenants):
        tenant = f"tenant{t}"
        ms = SyntheticMSConfig(num_identities=n_id,
                               spectra_per_identity=per_id,
                               num_bins=num_bins, seed=args.seed + 31 * t)
        ds = generate_dataset(ms, device=dev)
        hvs = encode_and_pack(ds.spectra, cfg).cpu().numpy()
        streams[tenant] = (hvs, ds.identity.cpu().numpy())
        del ds
    library_s = time.perf_counter() - t0
    n_per = n_id * per_id
    print(f"{args.tenants} stream(s) of {n_per} spectra, D={dim}, "
          f"threshold={ccfg.threshold:g} "
          f"({args.threshold_frac:g}*D), packed={ccfg.packed}, "
          f"consolidate_every={args.consolidate_every}, "
          f"mode={'continuous' if args.continuous else 'flush-sync'}; "
          f"generated and encoded in {library_s:.3f} s")

    server = DBSearchServer(
        BankRegistry(), k=1, max_batch_size=max_batch,
        flush_timeout_s=args.flush_ms / 1e3, buckets=4,
        clustering=ccfg, cluster_device=dev, continuous=args.continuous,
        num_slots=args.num_slots, executor_cls=executor_cls)

    # interleaved round-robin streaming in bursts, arrival order shuffled
    # within each tenant's stream
    rng = np.random.default_rng(args.seed)
    orders = {t: rng.permutation(n_per) for t in streams}
    cursors = {t: 0 for t in streams}
    meta = {}  # rid -> (tenant, stream position)
    done = []
    total = n_per * args.tenants
    sent = 0
    sleep_s = 0.0  # the traffic generator's idle gaps
    while sent < total:
        burst = int(rng.integers(1, max_batch + 1))
        for _ in range(min(burst, total - sent)):
            tenant = f"tenant{int(rng.integers(args.tenants))}"
            if cursors[tenant] >= n_per:
                tenant = next(t for t in streams if cursors[t] < n_per)
            pos = orders[tenant][cursors[tenant]]
            cursors[tenant] += 1
            rid = server.submit_cluster(streams[tenant][0][pos],
                                        tenant=tenant)
            meta[rid] = (tenant, int(pos))
            sent += 1
        done.extend(server.step())
        # closed-loop backpressure in continuous mode (see serve_db)
        while args.continuous and len(server.queue) >= max_batch:
            done.extend(server.step(force=True))
        if rng.random() < 0.3:
            t1 = time.perf_counter()
            time.sleep(args.flush_ms / 1e3)
            sleep_s += time.perf_counter() - t1
            done.extend(server.step())
    done.extend(server.run_until_drained())
    if len(done) != total:
        raise RuntimeError(f"served {len(done)} of {total} requests")

    s = server.summary()
    print(f"clustered {s['count']} spectra in {s['batches']} micro-batches "
          f"(mean batch {s['mean_batch']:.1f}; bucket usage {s['buckets']})")
    print(f"throughput: {s['qps']:.1f} spectra/sec")
    print(f"latency: p50 {s['p50_ms']:.2f} ms, p95 {s['p95_ms']:.2f} ms")
    sched = s["scheduler"]
    if sched is not None:
        print(f"scheduler: {sched['num_slots']} slots, "
              f"{sched['dispatched_batches']} dispatched / "
              f"{sched['retired_batches']} retired batches")

    quality = {}
    for tenant, (hvs, identity) in streams.items():
        cl = server.clusterers[tenant]
        # labels in *stream* order; cluster ids are spawn-order ints
        # < n_per, so the paper's quality metrics apply directly
        labels = np.zeros(n_per, np.int64)
        for r in done:
            if meta[r.rid][0] == tenant:
                labels[meta[r.rid][1]] = cl.resolve(r.result.cluster_id)
        lab = torch.from_numpy(labels).to(dev)
        csr = float(clustered_spectra_ratio(lab))
        icr = float(incorrect_clustering_ratio(
            lab, torch.from_numpy(identity).to(dev)))
        cs = cl.summary()
        quality[tenant] = {"clustered_ratio": csr, "incorrect_ratio": icr,
                           **cs}
        print(f"  {tenant}: {cs['clusters']} clusters over {n_per} spectra "
              f"({n_id} true identities), {cs['spawned']} spawned, "
              f"{cs['merges']} merges / {cs['consolidations']} "
              f"consolidations; clustered ratio {csr:.3f}, incorrect "
              f"ratio {icr:.3f}")
    # flush-sync: the host waits for each batch's distances, so the span
    # splits into the generator's sleeps, the device's distance steps, the
    # host's decision loop, the consolidations (their device work included)
    # and the rest (batching, copies, launch overhead, Python); continuous:
    # the device's steps overlap the host's work, so the rest is not host
    span_s = s["count"] / s["qps"]
    busy_s = s["device_busy_s"]
    decide_s = sum(c.decide_s for c in server.clusterers.values())
    consolidate_s = sum(c.consolidate_s for c in server.clusterers.values())
    rest = span_s - sleep_s - decide_s - consolidate_s - (busy_s or 0.0)
    idle = (None if busy_s is None
            else 1.0 - busy_s / max(span_s - sleep_s, 1e-12))
    print(f"serving span {span_s:.4f} s: traffic-generator sleep "
          f"{sleep_s:.4f} s, device distances "
          + ("not timed (no CUDA device)" if busy_s is None
             else f"{busy_s:.4f} s (device idle {idle:.1%} of the "
             f"non-sleep span)")
          + f", host decision loop {decide_s:.4f} s, consolidation "
          f"{consolidate_s:.4f} s"
          + ("" if args.continuous else f", other host {rest:.4f} s"))
    launches = {"hamming_pop": hamming_pop.launches}
    print(f"kernel launches: hamming_pop {hamming_pop.launches}")
    s.update(cluster_quality=quality, total=total, library_s=library_s,
             span_s=span_s, sleep_s=sleep_s, decide_s=decide_s,
             device_idle_share=idle,
             consolidate_s=consolidate_s, launches=launches)
    return s


if __name__ == "__main__":
    main()
