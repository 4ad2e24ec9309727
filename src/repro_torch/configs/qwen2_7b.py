"""Qwen2-7B [arXiv:2407.10671; hf Qwen/Qwen2-7B].

28 layers, d_model 3584, 28 heads (GQA kv=4), d_ff 18944, vocab 152064,
QKV bias (the Qwen signature), SwiGLU + RMSNorm."""

from repro_torch.configs.base import ArchConfig, register


@register("qwen2_7b")
def config() -> ArchConfig:
    return ArchConfig(
        name="qwen2_7b",
        family="dense",
        num_layers=28,
        d_model=3584,
        num_heads=28,
        num_kv_heads=4,
        d_ff=18_944,
        vocab_size=152_064,
        qkv_bias=True,
        activation="swiglu",
        norm="rmsnorm",
        rope_theta=1_000_000.0,
    )
