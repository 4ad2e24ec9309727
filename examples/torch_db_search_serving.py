"""Sharded, cached, multi-tenant DB-search serving on the PyTorch port —
the deployment path (the counterpart of ``examples/db_search_serving.py``).

Two client libraries (tenants) are HD-encoded and registered in a lazy
BankRegistry: each reference bank (targets + decoys) is bit-packed and,
over a multi-rank mesh, sharded row-wise over the mesh's 'model' axis
only when its first query arrives, and cold banks LRU-evict while pinned
(hot) tenants stay resident. Queries stream through a tenant-aware
micro-batching queue (flush on max-batch or timeout, per-flush fairness
cap); every query HV is encoded once and memoized in a content-hash LRU
cache, so the second pass over the same stream is served from cache —
bit-identical to the cold pass. Search itself is the per-shard top-k +
global merge that is bit-identical to the unsharded oracle, and merged
hits pass target-decoy FDR filtering. The modeled SpecPCM chip cost for
the same workload is printed alongside.

One process serves on the one-device mesh (``make_debug_mesh`` without a
process group); under ``torchrun`` every rank runs this script and holds
its own block of each bank. The libraries are drawn from explicit
``torch.Generator`` streams (seeded by each ``SyntheticMSConfig``), not
the reference's ``jax.random`` ones, so the identifications differ from
the reference's run; the modeled chip cost does not.

    PYTHONPATH=src python examples/torch_db_search_serving.py
    PYTHONPATH=src python examples/torch_db_search_serving.py --device cpu
"""

import argparse

import torch

from repro_torch.core import SpecPCMConfig, encode_and_pack
from repro_torch.core.imc.energy import db_search_cost
from repro_torch.dist.sharding import set_mesh
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.serve import BankRegistry, DBSearchServer, search_with_fdr
from repro_torch.spectra import SyntheticMSConfig, generate_dataset
from repro_torch.spectra.fdr import make_decoys
from repro_torch.spectra.synthetic import generate_query_set


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without one)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    # 1. two tenant reference libraries: 64 peptides x 2 replicate spectra
    mesh = make_debug_mesh(device_type=dev.type)
    set_mesh(mesh)
    cfg = SpecPCMConfig(hd_dim=1024, mlc_bits=1, num_levels=16, ideal=True)
    registry = BankRegistry(mesh=mesh, max_banks=2)
    tenants = {}
    for t, seed in enumerate((0, 1)):
        ms = SyntheticMSConfig(num_identities=64, spectra_per_identity=2,
                               num_bins=512, seed=seed)
        ds = generate_dataset(ms, device=dev)
        refs_hv = encode_and_pack(ds.spectra, cfg)
        decoys_hv = encode_and_pack(make_decoys(ds.spectra), cfg)
        registry.register(f"lab{t}", refs_hv, decoys=decoys_hv, pin=t == 0)
        qs = generate_query_set(ds, ms, num_queries=32, seed=seed + 10)
        tenants[f"lab{t}"] = (ds.identity.cpu().numpy(),
                              qs.identity.cpu().numpy(),
                              encode_and_pack(qs.spectra, cfg).cpu().numpy())
    print(f"registered {len(registry)} tenant banks (lazy; none built yet: "
          f"{[registry.is_built(t) for t in registry.tenants()]})")

    # 2. the serving stack: micro-batching + query-HV cache + shape buckets
    server = DBSearchServer(registry, k=4, fdr=0.05, max_batch_size=16,
                            flush_timeout_s=0.005, cache_bytes=8 << 20,
                            buckets=3, fairness_cap=8)
    # warm the hot tenant's search path (and, on the card, the kernels'
    # build) so p50/p95 measure serving (lab1 pays its lazy build on first
    # request, by design)
    search_with_fdr(registry.get("lab0"),
                    torch.zeros((16, cfg.hd_dim), dtype=torch.int8,
                                device=dev), k=4, fdr=0.05)

    # 3. two passes over the interleaved query streams: the first pass is
    # cold (encodes + inserts), the second is served from the cache
    done = []
    meta = {}  # rid -> (tenant, query row)
    for _ in range(2):
        for i in range(32):
            for name in tenants:
                meta[server.submit(tenants[name][2][i], tenant=name)] = (
                    name, i)
            done.extend(server.step())
    done.extend(server.run_until_drained())

    # 4. quality + serving stats
    total = len(done)
    accepted = correct = 0
    for r in done:
        if r.result.match >= 0:
            accepted += 1
            name, i = meta[r.rid]
            ref_ident, q_ident, _ = tenants[name]
            correct += int(ref_ident[r.result.match] == q_ident[i])
    s = server.summary()
    print(f"served {s['count']} queries in {s['batches']} micro-batches: "
          f"{s['qps']:.1f} queries/sec, "
          f"p50 {s['p50_ms']:.1f} ms / p95 {s['p95_ms']:.1f} ms")
    qc = s["query_cache"]
    print(f"query-HV cache: hit rate {qc['hit_rate']:.0%} "
          f"({qc['hits']} hits / {qc['misses']} misses, "
          f"{qc['entries']} entries) — pass 2 was served from cache")
    for name in sorted(s["tenants"]):
        ts = s["tenants"][name]
        print(f"  {name}: {ts['count']} reqs, p95 {ts['p95_ms']:.1f} ms, "
              f"cache hit rate {ts['cache_hit_rate']:.0%}")
    print(f"identified at 5% FDR: {accepted}/{total} "
          f"({correct} correct identity)")

    # 5. what would the same scan cost on the SpecPCM chip?
    db = registry.get("lab0")
    cost = db_search_cost(num_queries=total, num_refs=db.num_rows,
                          hd_dim=cfg.hd_dim, candidate_fraction=1.0)
    print(f"modeled chip cost for the same scan: "
          f"{cost.latency_s * 1e6:.1f} us, {cost.energy_j * 1e6:.2f} uJ")
    set_mesh(None)


if __name__ == "__main__":
    main()
