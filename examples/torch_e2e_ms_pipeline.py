"""The end-to-end workflow on the PyTorch port (the counterpart of
``examples/e2e_ms_pipeline.py``): the paper's full MS workflow on
synthetic data.

  raw spectra -> preprocess -> HD encode -> dimension packing
    -> [clustering]  bucketed distance MVMs in PCM + complete linkage
    -> condensed reference library (cluster representatives)
    -> [DB search]   query HVs vs library + decoys -> 1% FDR filter
  with the chip-level latency/energy report for every stage.

The data and the PCM write noise come from explicit ``torch.Generator``
streams (seeded by the configs), not the reference's ``jax.random``
ones, so clusters and identifications differ from the reference's run.

    PYTHONPATH=src python examples/torch_e2e_ms_pipeline.py [--identities 48]
    PYTHONPATH=src python examples/torch_e2e_ms_pipeline.py --device cpu
"""

import argparse

from repro_torch.core import SpecPCMConfig, run_clustering, run_db_search
from repro_torch.spectra import SyntheticMSConfig, generate_dataset
from repro_torch.spectra.synthetic import generate_query_set


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--identities", type=int, default=48)
    ap.add_argument("--replicates", type=int, default=8)
    ap.add_argument("--queries", type=int, default=96)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without one)")
    args = ap.parse_args(argv)
    dev = args.device

    ms = SyntheticMSConfig(num_identities=args.identities,
                           spectra_per_identity=args.replicates,
                           num_bins=1024)
    ds = generate_dataset(ms, device=dev)
    print(f"[1/4] dataset: {ds.num_spectra} spectra "
          f"({args.identities} peptides x {args.replicates})")

    # --- clustering on the write-cheap Sb2Te3 material ---------------------
    c_cfg = SpecPCMConfig(hd_dim=2049, mlc_bits=3, num_levels=16,
                          material="sb2te3", write_verify=0)
    crep = run_clustering(ds.spectra, ds.precursor, ds.identity, c_cfg,
                          device=dev)
    print(f"[2/4] clustering: {crep.num_clusters} clusters, "
          f"clustered-ratio={crep.clustered_ratio:.2%}, "
          f"incorrect={crep.incorrect_ratio:.2%}")
    print(f"      chip model: {crep.cost.latency_s * 1e3:.3f} ms, "
          f"{crep.cost.energy_j * 1e6:.1f} uJ")

    # --- condensed library: one representative per cluster -----------------
    reps = sorted(set(int(label) for label in crep.labels))
    lib = ds.spectra[reps]
    lib_prec = ds.precursor[reps]
    lib_ident = ds.identity[reps]
    print(f"[3/4] condensed library: {len(reps)} representatives "
          f"({len(reps) / ds.num_spectra:.1%} of raw)")

    # --- DB search on the retention-optimized TiTe2 material ----------------
    s_cfg = SpecPCMConfig(hd_dim=8193, mlc_bits=3, num_levels=16,
                          material="tite2", write_verify=3)
    q = generate_query_set(ds, ms, num_queries=args.queries,
                           modification_rate=0.3)
    srep = run_db_search(q.spectra, q.precursor, lib, lib_prec, s_cfg,
                         query_identity=q.identity, ref_identity=lib_ident,
                         device=dev)
    print(f"[4/4] DB search: {srep.num_identified}/{q.spectra.shape[0]} "
          f"identified at 1% FDR, recall={srep.recall:.2%}")
    print(f"      chip model: {srep.cost.latency_s * 1e3:.3f} ms, "
          f"{srep.cost.energy_j * 1e6:.1f} uJ")


if __name__ == "__main__":
    main()
