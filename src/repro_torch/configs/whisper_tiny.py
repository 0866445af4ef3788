"""Whisper-tiny [arXiv:2212.04356] — encoder-decoder audio transformer.
The mel-spectrogram + conv feature extractor is a stub (spec carve-out):
``input_specs()`` supplies precomputed 1500-frame embeddings."""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny",
        arch_type="audio",
        n_layers=4,  # decoder layers
        d_model=384,
        n_heads=6,
        n_kv_heads=6,
        d_head=64,
        d_ff=1536,
        vocab_size=51865,
        act="gelu",
        is_encoder_decoder=True,
        n_enc_layers=4,
        enc_frames=1500,
        frontend="audio_stub",
        rope_theta=0.0,  # learned absolute positions, no RoPE
        source="arXiv:2212.04356",
    )
