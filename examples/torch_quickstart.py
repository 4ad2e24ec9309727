"""Quickstart, on the PyTorch port (the counterpart of
``examples/quickstart.py``): encode spectra into hypervectors, pack them
for 3-bit MLC, program a (simulated) PCM bank, and run an in-memory
similarity search.

The analog chain's write noise is drawn from an explicit
``torch.Generator`` (the reference's ``jax.random`` stream cannot be
matched), so the accuracy line differs from the reference's run; the
dataset size, the packed shape and the modeled chip cost do not.

    PYTHONPATH=src python examples/torch_quickstart.py
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""

import argparse

import torch

from repro_torch.core import SpecPCMConfig, encode_and_pack, imc_scores
from repro_torch.core.imc.energy import db_search_cost
from repro_torch.spectra import SyntheticMSConfig, generate_dataset


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without one)")
    args = ap.parse_args(argv)

    # 1. make a small synthetic MS dataset (64 peptides x 4 replicates)
    ms = SyntheticMSConfig(num_identities=64, spectra_per_identity=4,
                           num_bins=1024)
    ds = generate_dataset(ms, device=args.device)
    print(f"dataset: {ds.num_spectra} spectra, {ms.num_bins} m/z bins")

    # 2. HD-encode + dimension-pack (Eq. 1 + §III.B of the paper)
    cfg = SpecPCMConfig(hd_dim=2049, mlc_bits=3, num_levels=16)
    packed = encode_and_pack(ds.spectra, cfg)
    print(f"packed HVs: {tuple(packed.shape)} int8 (D={cfg.hd_dim} -> "
          f"D/n={packed.shape[1]} for {cfg.mlc_bits}-bit MLC)")

    # 3. search the first replicate of each identity against all others
    queries = packed[::4]
    noise = torch.Generator(device=packed.device).manual_seed(0)
    scores = imc_scores(queries, packed, cfg, noise)
    best = torch.argsort(-scores, dim=1)[:, 1]  # skip self
    truth = ds.identity
    acc = (truth[best] == truth[::4]).float().mean().item()
    print(f"nearest-neighbor identity accuracy through the analog chain: "
          f"{acc:.1%}")

    # 4. what would this cost on the SpecPCM chip?
    cost = db_search_cost(num_queries=64, num_refs=256, hd_dim=cfg.hd_dim,
                          candidate_fraction=1.0)
    print(f"modeled chip cost: {cost.latency_s * 1e6:.2f} us, "
          f"{cost.energy_j * 1e9:.1f} nJ")


if __name__ == "__main__":
    main()
