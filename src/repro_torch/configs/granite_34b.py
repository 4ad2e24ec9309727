"""Granite-34B-Code [arXiv:2405.04324; hf ibm-granite/granite-34b-code-base].

88 layers, d_model 6144, 48 heads MQA (kv=1), d_ff 24576, vocab 49152
(depth-upscaled granite-20b)."""

from repro_torch.configs.base import ArchConfig, register


@register("granite_34b")
def config() -> ArchConfig:
    return ArchConfig(
        name="granite_34b",
        family="dense",
        num_layers=88,
        d_model=6144,
        num_heads=48,
        num_kv_heads=1,
        d_ff=24_576,
        vocab_size=49_152,
        activation="gelu",
        norm="layernorm",
    )
