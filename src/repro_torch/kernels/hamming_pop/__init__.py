from repro_torch.kernels.hamming_pop.ops import hamming_pop, hamming_pop_plain

__all__ = ["hamming_pop", "hamming_pop_plain"]
