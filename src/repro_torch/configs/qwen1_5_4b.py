"""Qwen1.5-4B [hf:Qwen/Qwen1.5-0.5B card family] — dense, QKV bias, SwiGLU."""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-4b",
        arch_type="dense",
        n_layers=40,
        d_model=2560,
        n_heads=20,
        n_kv_heads=20,
        d_head=128,
        d_ff=6912,
        vocab_size=151936,
        act="swiglu",
        qkv_bias=True,
        rope_theta=1_000_000.0,
        source="hf:Qwen/Qwen1.5-0.5B",
    )
