"""Architecture configuration (a copy of ``repro.configs.base``).

One ``ArchConfig`` describes any model family of the JAX package (dense /
MoE / SSM / hybrid / enc-dec / VLM backbone). Every one of the ten
architectures has a module in this package registering its published
config and a ``reduced()`` smoke-test variant. Which families the port
can build and run is decided by ``models.transformer.block_kind``.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Callable

_REGISTRY: dict[str, Callable[[], "ArchConfig"]] = {}

ARCH_IDS = [
    "deepseek_moe_16b",
    "llama4_scout_17b_a16e",
    "xlstm_125m",
    "internvl2_76b",
    "gemma_7b",
    "granite_20b",
    "qwen2_7b",
    "granite_34b",
    "whisper_medium",
    "hymba_1_5b",
]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | vlm | audio | hybrid
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // num_heads
    # --- MoE ---
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    capacity_factor: float = 1.25
    moe_group_size: int = 1024
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_ratio: int = 0           # xlstm: one sLSTM block every `ssm_ratio` layers
    # --- attention details ---
    qkv_bias: bool = False       # qwen2
    sliding_window: int = 0      # 0 = full attention
    rope_theta: float = 10000.0
    # --- activation / norm ---
    activation: str = "swiglu"   # swiglu | geglu | gelu
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    # --- structure ---
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    vision_frontend: bool = False
    vision_fraction: int = 8     # 1/8 of seq are patch embeddings (vlm)
    tie_embeddings: bool = False
    # --- numerics ---
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    kv_quant_int8: bool = False  # int8 KV store (SpecPCM MLC insight)
    # --- paper technique hook ---
    imc_linear: bool = False     # route FFN down-proj through the IMC-MVM model
    imc_mlc_bits: int = 3
    imc_adc_bits: int = 6

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_recurrent(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def supports_long_decode(self) -> bool:
        """Sub-quadratic / bounded-state decode (long_500k eligibility)."""
        return self.family in ("ssm", "hybrid")

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 (whisper's 51865 -> 52224)."""
        return -(-self.vocab_size // 256) * 256

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "_reduced",
            num_layers=2,
            num_encoder_layers=2 if self.is_encoder_decoder else 0,
            d_model=64,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2)),
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            num_experts=min(self.num_experts, 8),
            num_shared_experts=min(self.num_shared_experts, 1),
            top_k=min(self.top_k, 2),
            expert_d_ff=64 if self.num_experts else 0,
            moe_group_size=32,
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            sliding_window=min(self.sliding_window, 16) if self.sliding_window else 0,
            dtype="float32",
        )


def register(arch_id: str):
    def deco(fn: Callable[[], ArchConfig]):
        _REGISTRY[arch_id] = fn
        return fn
    return deco


def get_config(arch_id: str) -> ArchConfig:
    arch_id = arch_id.replace("-", "_")
    if arch_id not in _REGISTRY:
        # lazy import of the arch module
        importlib.import_module(f"repro_torch.configs.{arch_id}")
    return _REGISTRY[arch_id]()


def list_archs() -> list[str]:
    for a in ARCH_IDS:
        if a not in _REGISTRY:
            importlib.import_module(f"repro_torch.configs.{a}")
    return sorted(_REGISTRY)
