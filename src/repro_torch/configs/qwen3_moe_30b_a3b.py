"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B] — MoE, 128 experts top-8,
per-expert FFN 768, GQA 32H/4KV, qk-norm."""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b",
        arch_type="moe",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=4,
        d_head=128,
        d_ff=768,  # per-expert intermediate size
        vocab_size=151936,
        act="swiglu",
        qk_norm=True,
        n_experts=128,
        top_k=8,
        n_shared_experts=0,
        rope_theta=1_000_000.0,
        source="hf:Qwen/Qwen3-30B-A3B",
    )
