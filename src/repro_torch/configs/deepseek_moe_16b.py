"""DeepSeekMoE-16B [arXiv:2401.06066; hf deepseek-ai/deepseek-moe-16b-base].

Fine-grained MoE: 64 routed experts (top-6) + 2 shared experts, expert FFN
width 1408 (= d_ff). 28 layers, d_model 2048, 16 heads (full MHA: kv=16)."""

from repro_torch.configs.base import ArchConfig, register


@register("deepseek_moe_16b")
def config() -> ArchConfig:
    return ArchConfig(
        name="deepseek_moe_16b",
        family="moe",
        num_layers=28,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=1408,            # per-expert FFN width (fine-grained)
        expert_d_ff=1408,
        vocab_size=102_400,
        num_experts=64,
        num_shared_experts=2,
        top_k=6,
        activation="swiglu",
        norm="rmsnorm",
    )
