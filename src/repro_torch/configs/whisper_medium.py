"""Whisper-medium [arXiv:2212.04356; unverified].

Encoder-decoder, d_model 1024, 16 heads (full MHA), d_ff 4096, vocab 51865.
The assignment's 24L maps to whisper-medium's 24 encoder + 24 decoder
layers. The conv audio frontend is a STUB: input_specs() provides
precomputed frame embeddings (post-conv). seq_len splits 50/50 between
encoder frames and decoder tokens (DESIGN.md §4)."""

from repro_torch.configs.base import ArchConfig, register


@register("whisper_medium")
def config() -> ArchConfig:
    return ArchConfig(
        name="whisper_medium",
        family="audio",
        num_layers=24,            # decoder layers
        num_encoder_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        d_ff=4096,
        vocab_size=51_865,
        is_encoder_decoder=True,
        activation="gelu",
        norm="layernorm",
    )
