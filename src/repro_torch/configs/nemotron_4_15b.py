"""Nemotron-4 15B [arXiv:2402.16819] — dense, GQA (48H/8KV), squared-ReLU MLP."""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-15b",
        arch_type="dense",
        n_layers=32,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_head=128,
        d_ff=24576,
        vocab_size=256000,
        act="squared_relu",  # Nemotron-4 uses squared ReLU, ungated
        qkv_bias=False,
        rope_theta=10_000.0,
        source="arXiv:2402.16819",
    )
