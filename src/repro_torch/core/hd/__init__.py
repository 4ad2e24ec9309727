from repro_torch.core.hd.clustering import (
    ClusteringResult,
    clustered_spectra_ratio,
    complete_linkage,
    cross_distances,
    incorrect_clustering_ratio,
    pairwise_distances,
)
from repro_torch.core.hd.encoding import (
    HDEncoderConfig,
    encode_batch,
    encode_levels_batch,
    make_codebooks,
    quantize_levels,
)
from repro_torch.core.hd.packing import pack_dimensions, unpack_dimensions
from repro_torch.core.hd.similarity import (
    INT32_MIN,
    bitpack_bipolar,
    dot_similarity,
    hamming_similarity_packed,
    popcount32,
    topk_search,
    topk_search_packed,
    topk_value_desc_index_asc,
)

__all__ = [
    "INT32_MIN",
    "ClusteringResult",
    "HDEncoderConfig",
    "bitpack_bipolar",
    "clustered_spectra_ratio",
    "complete_linkage",
    "cross_distances",
    "dot_similarity",
    "encode_batch",
    "encode_levels_batch",
    "hamming_similarity_packed",
    "incorrect_clustering_ratio",
    "make_codebooks",
    "pack_dimensions",
    "pairwise_distances",
    "popcount32",
    "quantize_levels",
    "topk_search",
    "topk_search_packed",
    "topk_value_desc_index_asc",
    "unpack_dimensions",
]
