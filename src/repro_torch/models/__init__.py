"""Model substrate of the port: so far the zamba2-style hybrid (Mamba2 SSD
layers with a shared attention block) for serving."""
from . import attention, common, mlp, ssm, transformer
from .transformer import DecodeCache, decode_step, init_decode_cache, init_params, prefill

__all__ = [
    "attention",
    "common",
    "mlp",
    "ssm",
    "transformer",
    "DecodeCache",
    "decode_step",
    "init_decode_cache",
    "init_params",
    "prefill",
]
