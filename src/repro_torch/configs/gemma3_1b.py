"""Gemma3-1B [hf:google/gemma-3-1b-pt] — dense, 5 local (sliding-window 512)
per 1 global layer, 128k-class context, GQA 4H/1KV, head_dim 256."""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-1b",
        arch_type="dense",
        n_layers=26,
        d_model=1152,
        n_heads=4,
        n_kv_heads=1,
        d_head=256,
        d_ff=6912,
        vocab_size=262144,
        act="gelu",
        qk_norm=True,
        window=512,
        local_ratio=5,  # 5 local : 1 global
        rope_theta=1_000_000.0,
        source="hf:google/gemma-3-1b-pt",
    )
