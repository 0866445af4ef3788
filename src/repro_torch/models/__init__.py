"""Model substrate of the port: decoder-only LMs of the dense (local/global
attention), pure-SSM (Mamba2) and zamba2-style hybrid families, for
serving and as the DMTRL heads' backbone."""
from . import attention, common, mlp, ssm, transformer
from .transformer import (
    DecodeCache,
    decode_step,
    forward_train,
    init_decode_cache,
    init_params,
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
    "forward_train",
    "init_decode_cache",
    "init_params",
    "prefill",
]
