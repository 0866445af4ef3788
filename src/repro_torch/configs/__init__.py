"""Architecture configs (one module per assigned architecture)."""
from .base import ARCH_IDS, ModelConfig, all_configs, get_config

__all__ = ["ARCH_IDS", "ModelConfig", "all_configs", "get_config"]
