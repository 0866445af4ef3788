"""Kimi K2 (1T total / 32B active) [arXiv:2501.kimi2, paper-table shapes] —
trillion-parameter MoE: 384 experts top-8, per-expert FFN 2048, 61 layers,
GQA 64H/8KV per the assignment table."""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b",
        arch_type="moe",
        n_layers=61,
        d_model=7168,
        n_heads=64,
        n_kv_heads=8,
        d_head=128,
        d_ff=2048,  # per-expert intermediate size
        vocab_size=163840,
        act="swiglu",
        n_experts=384,
        top_k=8,
        n_shared_experts=1,
        rope_theta=50_000.0,
        source="arXiv:2501.kimi2",
    )
