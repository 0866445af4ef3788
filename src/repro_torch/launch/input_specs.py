"""Meta-tensor stand-ins for every model input, per (arch x input shape):
the JAX package's ``launch/input_specs.py``, whose ``ShapeDtypeStruct``s
become ``meta`` tensors (shapes and dtypes, no memory). The dry run traces
the port's steps on them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from ..configs.base import ModelConfig

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    """Spec rules: long_500k only for sub-quadratic decode archs."""
    if shape.name == "long_500k" and not cfg.supports_long_decode:
        return False, (
            "pure full-attention arch: 500k dense KV decode skipped per spec "
            "(no sliding-window/SSM variant)"
        )
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def train_inputs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    specs = {
        "tokens": _meta((B, S), torch.int32),
        "labels": _meta((B, S), torch.int32),
        "mask": _meta((B, S), torch.float32),
    }
    if cfg.is_encoder_decoder:
        specs["frames"] = _meta((B, cfg.enc_frames, cfg.d_model), torch.bfloat16)
    return specs


def prefill_inputs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    specs: Dict[str, Any] = {"tokens": _meta((B, S), torch.int32)}
    if cfg.is_encoder_decoder:
        specs["frames"] = _meta((B, cfg.enc_frames, cfg.d_model), torch.bfloat16)
    return specs


def decode_inputs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    """token + cache on meta (a cache of seq_len slots, as if positions up
    to seq_len - 1 were filled: the step appends token #seq_len)."""
    from ..models import init_decode_cache

    B, S = shape.global_batch, shape.seq_len
    return {"token": _meta((B,), torch.int32),
            "cache": init_decode_cache(cfg, B, max_len=S, device=META)}


def input_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    if shape.kind == "train":
        return train_inputs(cfg, shape)
    if shape.kind == "prefill":
        return prefill_inputs(cfg, shape)
    return decode_inputs(cfg, shape)
