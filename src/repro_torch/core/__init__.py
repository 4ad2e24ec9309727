"""SpecPCM core, in PyTorch: hyperdimensional computing, the PCM
in-memory-compute model and the end-to-end pipelines."""

from repro_torch.core.pipeline import (
    ClusterReport,
    SearchReport,
    SpecPCMConfig,
    encode_and_pack,
    imc_scores,
    run_clustering,
    run_db_search,
)

__all__ = [
    "SpecPCMConfig", "encode_and_pack", "imc_scores",
    "run_clustering", "run_db_search", "ClusterReport", "SearchReport",
]
