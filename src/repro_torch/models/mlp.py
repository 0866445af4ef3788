"""Feed-forward block: dense (SwiGLU / squared-ReLU / GELU). The JAX
package's Mixture-of-Experts is a later slice of the port."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .common import activation, dense_init

Tensor = torch.Tensor


def init_mlp_params(gen: torch.Generator, cfg: ModelConfig, dtype) -> Dict[str, Tensor]:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.act == "swiglu":
        return {
            "w_gate": dense_init(gen, (d, f), dtype),
            "w_up": dense_init(gen, (d, f), dtype),
            "w_down": dense_init(gen, (f, d), dtype),
        }
    return {
        "w_up": dense_init(gen, (d, f), dtype),
        "w_down": dense_init(gen, (f, d), dtype),
    }


def mlp(x: Tensor, p: Dict[str, Tensor], cfg: ModelConfig) -> Tensor:
    if cfg.act == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = activation(cfg.act)(x @ p["w_up"])
    return h @ p["w_down"]


def init_moe_params(*_args, **_kwargs):
    raise NotImplementedError("MoE layers are not ported yet")


def moe_ffn(*_args, **_kwargs):
    raise NotImplementedError("MoE layers are not ported yet")
