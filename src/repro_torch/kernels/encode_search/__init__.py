from repro_torch.kernels.encode_search.ops import (
    encode_search,
    encode_search_banded,
    encode_search_banded_plain,
    encode_search_plain,
    pack_codebook,
)

__all__ = ["encode_search", "encode_search_banded",
           "encode_search_banded_plain", "encode_search_plain",
           "pack_codebook"]
