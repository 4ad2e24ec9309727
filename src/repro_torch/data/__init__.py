from repro_torch.data.tokens import TokenPipeline, synthetic_batch

__all__ = ["TokenPipeline", "synthetic_batch"]
