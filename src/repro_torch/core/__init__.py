"""SpecPCM core, in PyTorch: hyperdimensional encoding and search."""

from repro_torch.core.pipeline import SpecPCMConfig, encode_and_pack

__all__ = ["SpecPCMConfig", "encode_and_pack"]
