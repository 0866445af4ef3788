"""Shared model primitives: norms, activations, RoPE, init helpers.

The JAX package's sharding hints (``maybe_shard``, ``batch_axes``) have no
counterpart: the sharded step splits the compute explicitly
(``sharding.ModelSplit``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def rms_norm(x: Tensor, scale: Tensor, eps: float = 1e-6) -> Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def gated_rms_norm(x: Tensor, gate: Tensor, scale: Tensor, eps: float = 1e-6,
                   split=None) -> Tensor:
    """Mamba2-style: RMSNorm(x * silu(gate)). With ``split`` (a
    ``sharding.ModelSplit``) x, gate and scale are this rank's block of
    channels split over ``model``: the mean of squares is taken over every
    rank's channels (a psum of the sums, whose gradient each rank's block
    shares)."""
    v = x * F.silu(gate.float()).to(x.dtype)
    if split is None or split.size == 1:
        return rms_norm(v, scale, eps)
    vf = v.float()
    ss = split.psum_both(torch.sum(vf * vf, dim=-1, keepdim=True))
    out = vf * torch.rsqrt(ss / (v.shape[-1] * split.size) + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------
def activation(name: str):
    if name == "squared_relu":
        return lambda x: torch.square(F.relu(x))
    if name == "gelu":
        # jax.nn.gelu's default is the tanh approximation, not torch's
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "silu":
        return F.silu
    raise ValueError(f"unknown activation {name}")


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: (..., seq, n_heads, head_dim); positions: (..., seq) int."""
    if theta <= 0.0:
        return x
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].float() * freqs  # (..., seq, half)
    cos = torch.cos(ang)[..., None, :]  # broadcast over heads
    sin = torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# initializers: the JAX package's std rules, drawn from a torch.Generator
# (the draws differ from jax.random's; tests carry JAX params across)
# ---------------------------------------------------------------------------
# fp32 elements drawn at once: a larger leaf is drawn slab by slab along its
# leading axis into the leaf's own dtype, so its init never holds an fp32
# copy of the whole leaf (kimi-k2's (384, 7168, 2048) expert leaves would
# take 22.5 GB in fp32 for an 11.3 GB bf16 leaf)
DRAW_SLAB = 1 << 28


def normal_init(gen: torch.Generator, shape, dtype, std: float) -> Tensor:
    """N(0, std^2) of ``shape`` in ``dtype``, drawn in fp32 on the
    generator's device (in slabs of at most ``DRAW_SLAB`` elements)."""
    shape = tuple(shape)
    if gen.device.type == "meta":  # shapes only (``transformer.param_shapes``)
        return torch.empty(shape, dtype=dtype, device="meta")
    numel = math.prod(shape)
    if numel <= DRAW_SLAB or len(shape) < 2:
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
        return w.mul_(std).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    rows = max(1, DRAW_SLAB // (numel // shape[0]))
    for a in range(0, shape[0], rows):
        b = min(a + rows, shape[0])
        w = torch.randn((b - a,) + shape[1:], generator=gen, dtype=torch.float32,
                        device=gen.device)
        out[a:b] = w.mul_(std)
    return out


def dense_init(gen: torch.Generator, shape, dtype, scale: Optional[float] = None) -> Tensor:
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return normal_init(gen, shape, dtype, std)


def embed_init(gen: torch.Generator, shape, dtype) -> Tensor:
    return normal_init(gen, shape, dtype, 0.02)
