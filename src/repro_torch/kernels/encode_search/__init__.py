from repro_torch.kernels.encode_search.ops import (
    encode_search,
    encode_search_plain,
    pack_codebook,
)

__all__ = ["encode_search", "encode_search_plain", "pack_codebook"]
