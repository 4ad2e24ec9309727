from repro_torch.configs.base import (
    ARCH_IDS,
    ArchConfig,
    get_config,
)

__all__ = ["ArchConfig", "get_config", "ARCH_IDS"]
