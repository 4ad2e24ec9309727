"""xLSTM-125M [arXiv:2405.04517; unverified].

12 layers, d_model 768, 4 heads, vocab 50304 (GPT-NeoX tokenizer padding).
d_ff=0: blocks are mLSTM (matrix-memory) with one sLSTM (scalar-memory)
block every 4 layers — the paper's xLSTM[7:1]-style mix. Recurrent state
makes decode O(1) per token (long_500k eligible)."""

from repro_torch.configs.base import ArchConfig, register


@register("xlstm_125m")
def config() -> ArchConfig:
    return ArchConfig(
        name="xlstm_125m",
        family="ssm",
        num_layers=12,
        d_model=768,
        num_heads=4,
        num_kv_heads=4,
        d_ff=0,               # no separate FFN: mLSTM blocks have an
                              # up/down projection (factor 2) built in
        vocab_size=50_304,
        ssm_ratio=4,          # every 4th block is sLSTM
        activation="swiglu",
        norm="rmsnorm",
    )
