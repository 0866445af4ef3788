"""Zamba2-2.7B [arXiv:2411.15242] — hybrid: Mamba2 backbone + shared
attention blocks applied periodically (weights shared across applications)."""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b",
        arch_type="hybrid",
        n_layers=54,  # 54 Mamba2 layers; shared attn block every 6
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        d_head=80,
        d_ff=10240,
        vocab_size=32000,
        act="gelu",
        ssm_state=64,
        ssm_heads=80,  # d_inner = 2*2560 = 5120, head dim 64
        ssm_expand=2,
        ssm_chunk=64,
        hybrid_attn_every=6,
        rope_theta=10_000.0,
        source="arXiv:2411.15242",
    )
