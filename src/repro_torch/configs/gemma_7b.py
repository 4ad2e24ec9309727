"""Gemma-7B [arXiv:2403.08295; hf google/gemma-7b].

28 layers, d_model 3072, 16 heads with head_dim 256 (attention width 4096 >
d_model), full MHA (kv=16), GeGLU FFN with hidden 24576, vocab 256000,
tied embeddings."""

from repro_torch.configs.base import ArchConfig, register


@register("gemma_7b")
def config() -> ArchConfig:
    return ArchConfig(
        name="gemma_7b",
        family="dense",
        num_layers=28,
        d_model=3072,
        num_heads=16,
        num_kv_heads=16,
        head_dim=256,
        d_ff=24_576,
        vocab_size=256_000,
        activation="geglu",
        norm="rmsnorm",
        tie_embeddings=True,
    )
