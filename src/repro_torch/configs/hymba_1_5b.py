"""Hymba-1.5B [arXiv:2411.13676; hf nvidia/Hymba-1.5B-Base].

32 layers, d_model 1600, 25 heads with head_dim 64 (GQA kv=5), d_ff 5504,
vocab 32001, ssm_state 16. Hybrid-head blocks: attention heads and Mamba
(selective-SSM) heads run in PARALLEL on the same input and their outputs
are combined with learned per-path scales. Most attention is sliding-window
(2048) which, plus the SSM state, bounds decode memory (long_500k eligible)."""

from repro_torch.configs.base import ArchConfig, register


@register("hymba_1_5b")
def config() -> ArchConfig:
    return ArchConfig(
        name="hymba_1_5b",
        family="hybrid",
        num_layers=32,
        d_model=1600,
        num_heads=25,
        num_kv_heads=5,
        head_dim=64,
        d_ff=5504,
        vocab_size=32_001,
        ssm_state=16,
        sliding_window=2048,
        activation="swiglu",
        norm="rmsnorm",
    )
