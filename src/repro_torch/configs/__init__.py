"""Architecture configs (one module per assigned architecture)."""
from .base import ARCH_ALIASES, ARCH_IDS, ModelConfig, all_configs, get_config

__all__ = ["ARCH_ALIASES", "ARCH_IDS", "ModelConfig", "all_configs", "get_config"]
