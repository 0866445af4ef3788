"""Qwen1.5-32B [hf:Qwen/Qwen1.5-0.5B card family] — dense, QKV bias, SwiGLU."""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-32b",
        arch_type="dense",
        n_layers=64,
        d_model=5120,
        n_heads=40,
        n_kv_heads=40,  # per assignment: GQA kv=40 (i.e. MHA)
        d_head=128,
        d_ff=27392,
        vocab_size=152064,
        act="swiglu",
        qkv_bias=True,  # Qwen1.5 attention uses QKV bias
        rope_theta=1_000_000.0,
        source="hf:Qwen/Qwen1.5-0.5B",
    )
