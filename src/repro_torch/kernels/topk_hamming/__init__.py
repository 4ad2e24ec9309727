from repro_torch.kernels.topk_hamming.ops import (
    topk_hamming,
    topk_hamming_plain,
)

__all__ = ["topk_hamming", "topk_hamming_plain"]
