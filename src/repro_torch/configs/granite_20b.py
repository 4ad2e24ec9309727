"""Granite-20B-Code [arXiv:2405.04324; hf ibm-granite/granite-20b-code-base].

52 layers, d_model 6144, 48 heads with MQA (kv=1), d_ff 24576, vocab 49152,
llama-style blocks (gpt-bigcode lineage -> gelu MLP, layernorm)."""

from repro_torch.configs.base import ArchConfig, register


@register("granite_20b")
def config() -> ArchConfig:
    return ArchConfig(
        name="granite_20b",
        family="dense",
        num_layers=52,
        d_model=6144,
        num_heads=48,
        num_kv_heads=1,
        d_ff=24_576,
        vocab_size=49_152,
        activation="gelu",
        norm="layernorm",
    )
