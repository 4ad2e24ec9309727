"""Llama-4-Scout-17B-16E [hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

48 layers, d_model 5120, 40 heads (GQA kv=8), MoE 16 experts top-1 with a
shared expert, expert FFN width 8192."""

from repro_torch.configs.base import ArchConfig, register


@register("llama4_scout_17b_a16e")
def config() -> ArchConfig:
    return ArchConfig(
        name="llama4_scout_17b_a16e",
        family="moe",
        num_layers=48,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        d_ff=8192,
        expert_d_ff=8192,
        vocab_size=202_048,
        num_experts=16,
        num_shared_experts=1,
        top_k=1,
        activation="swiglu",
        norm="rmsnorm",
        rope_theta=500_000.0,
    )
