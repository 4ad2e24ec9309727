from repro_torch.kernels.decode_attention.ops import (
    decode_attention,
    decode_attention_partial,
    decode_attention_partial_plain,
    decode_attention_plain,
)

__all__ = ["decode_attention", "decode_attention_partial",
           "decode_attention_partial_plain", "decode_attention_plain"]
