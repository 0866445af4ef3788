"""Chameleon-34B [arXiv:2405.09818] — early-fusion VLM: text + VQ image
tokens share one vocab (65536); decoder-only with qk-norm. The VQ-VAE image
tokenizer is a stub (spec carve-out): image patches arrive as token ids."""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="chameleon-34b",
        arch_type="vlm",
        n_layers=48,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_head=128,
        d_ff=22016,
        vocab_size=65536,
        act="swiglu",
        qk_norm=True,  # Chameleon's QK-norm stability fix
        frontend="vq_stub",
        rope_theta=10_000.0,
        source="arXiv:2405.09818",
    )
