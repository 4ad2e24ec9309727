from repro_torch.kernels.topk_hamming.ops import (
    canonicalize_overflow_slots,
    topk_hamming,
    topk_hamming_banded,
    topk_hamming_banded_plain,
    topk_hamming_plain,
)

__all__ = ["canonicalize_overflow_slots", "topk_hamming",
           "topk_hamming_banded", "topk_hamming_banded_plain",
           "topk_hamming_plain"]
