"""InternVL2-76B [arXiv:2404.16821; unverified].

LM backbone (Llama-3-70B-style): 80 layers, d_model 8192, 64 heads (GQA
kv=8), d_ff 28672, vocab 128256. The InternViT-6B vision frontend is a STUB
per the assignment: input_specs() provides precomputed patch embeddings for
1/8 of the sequence; the backbone trains with loss on text positions."""

from repro_torch.configs.base import ArchConfig, register


@register("internvl2_76b")
def config() -> ArchConfig:
    return ArchConfig(
        name="internvl2_76b",
        family="vlm",
        num_layers=80,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=28_672,
        vocab_size=128_256,
        vision_frontend=True,
        vision_fraction=8,
        activation="swiglu",
        norm="rmsnorm",
        rope_theta=500_000.0,
    )
