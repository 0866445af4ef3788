"""Model substrate of the port: the LMs of the dense (local/global
attention; the early-fusion VLM), MoE, pure-SSM (Mamba2), zamba2-style
hybrid and whisper-style encoder-decoder families, for serving, training
and as the DMTRL heads' backbone."""
from . import attention, common, mlp, ssm, transformer
from .transformer import (
    DecodeCache,
    decode_step,
    encode_audio,
    forward_train,
    init_decode_cache,
    init_params,
    loss_fn,
    make_sharded_decode_step,
    make_sharded_prefill,
    prefill,
)

__all__ = [
    "attention",
    "common",
    "mlp",
    "ssm",
    "transformer",
    "DecodeCache",
    "decode_step",
    "encode_audio",
    "forward_train",
    "init_decode_cache",
    "init_params",
    "loss_fn",
    "make_sharded_decode_step",
    "make_sharded_prefill",
    "prefill",
]
