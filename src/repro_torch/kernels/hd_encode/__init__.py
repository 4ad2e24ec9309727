from repro_torch.kernels.hd_encode.ops import hd_encode, hd_encode_plain

__all__ = ["hd_encode", "hd_encode_plain"]
