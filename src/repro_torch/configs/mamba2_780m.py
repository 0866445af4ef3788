"""Mamba2-780M [arXiv:2405.21060] — pure SSM (SSD / state-space duality),
attention-free, 48 layers, d_model 1536, state 128."""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m",
        arch_type="ssm",
        n_layers=48,
        d_model=1536,
        n_heads=0,  # attention-free
        n_kv_heads=0,
        d_head=0,
        d_ff=0,  # no MLP; the Mamba2 block is the whole layer
        vocab_size=50280,
        ssm_state=128,
        ssm_heads=48,  # d_inner = 3072, P = 64
        ssm_expand=2,
        ssm_chunk=64,
        ssm_conv=4,
        source="arXiv:2405.21060",
    )
