"""Plain PyTorch version of the flash-attention kernel: dense softmax
attention with the same masking (the JAX package's ``attention_ref``)."""
from __future__ import annotations

import math

import torch

Tensor = torch.Tensor
NEG_INF = -1e30


def attention_ref(
    q: Tensor,  # (B, H, S, HD)
    k: Tensor,  # (B, H, Sk, HD)
    v: Tensor,
    causal: bool = True,
    window: int = 0,
) -> Tensor:
    S, HD = q.shape[2], q.shape[3]
    Sk = k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(HD)
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((S, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def attention_ref_bwd(
    q: Tensor,  # (B, H, S, HD)
    k: Tensor,  # (B, H, Sk, HD)
    v: Tensor,
    dout: Tensor,  # (B, H, S, HD): the gradient at attention_ref's output
    causal: bool = True,
    window: int = 0,
):
    """Plain version of the flash backward: (dq, dk, dv) of ``attention_ref``
    by torch autograd, each in its input's dtype."""
    with torch.enable_grad():
        qkv = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = attention_ref(*qkv, causal, window)
        return torch.autograd.grad(out, qkv, dout)
