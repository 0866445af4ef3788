"""Entry points for the flash-attention kernels, by the tensors' device: a
CPU tensor runs the plain version (``ref.attention_ref``), a CUDA tensor
launches the Hopper kernel or raises.

``flash_attention_bshd`` adapts the model layout (B, S, H, HD) to the
kernel's (B, H, S, HD). On CPU tensors it pads the sequence to the block
multiples and makes the transposed copies, as the JAX package's wrapper
does. On CUDA tensors it hands the kernel transposed views of the model's
tensors as they are (the kernel takes strides and masks the ragged edge
itself) and returns the output in the model layout: no pad, no copy.

It is differentiable both ways. On CUDA tensors it goes through
``FlashAttention``, a ``torch.autograd.Function`` whose forward is K3 (with
the rows' log-sum-exp kept only when a gradient is wanted) and whose
backward is K3-bwd; no CUDA path falls back to the plain version. On CPU
tensors autograd differentiates the plain version.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from .flash_kernel import flash_attention as flash_attention_kernel
from .flash_kernel import flash_attention_bwd
from .ref import attention_ref

Tensor = torch.Tensor


def flash_attention(
    q: Tensor,  # (B, H, S, HD), S and Sk multiples of the blocks
    k: Tensor,
    v: Tensor,
    causal: bool = True,
    window: int = 0,
    block_q: int = 128,
    block_k: int = 128,
) -> Tensor:
    S, Sk = q.shape[2], k.shape[2]
    bq, bk = min(block_q, S), min(block_k, Sk)
    if S % bq or Sk % bk:
        raise ValueError("pad seq to block multiples first")
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal, window)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on CPU or CUDA tensors, got {q.device}")
    return flash_attention_kernel(q, k, v, causal, window)


class FlashAttention(torch.autograd.Function):
    """K3 and K3-bwd over CUDA tensors in the model layout (B, S, H, HD)."""

    @staticmethod
    def forward(ctx, q: Tensor, k: Tensor, v: Tensor, causal: bool, window: int) -> Tensor:
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if not any(ctx.needs_input_grad[:3]):
            return flash_attention_kernel(qt, kt, vt, causal, window).transpose(1, 2)
        out, lse = flash_attention_kernel(qt, kt, vt, causal, window, return_lse=True)
        out = out.transpose(1, 2)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout: Tensor):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), out.transpose(1, 2),
            dout.contiguous().transpose(1, 2), lse, ctx.causal, ctx.window,
        )
        return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2), None, None


def flash_attention_bshd(
    q: Tensor,  # (B, S, H, HD): model layout
    k: Tensor,
    v: Tensor,
    causal: bool = True,
    window: int = 0,
    block_q: int = 128,
    block_k: int = 128,
) -> Tensor:
    if q.device.type == "cuda":
        return FlashAttention.apply(q, k, v, causal, window)
    S, Sk = q.shape[1], k.shape[1]
    bq, bk = min(block_q, S), min(block_k, Sk)
    pad_q, pad_k = (-S) % bq, (-Sk) % bk
    qt = q.transpose(1, 2)
    kt = k.transpose(1, 2)
    vt = v.transpose(1, 2)
    if pad_q:
        qt = F.pad(qt, (0, 0, 0, pad_q))
    if pad_k:
        # padded keys sit at positions >= Sk: the causal mask hides them from
        # every real query; non-causal padding would need an explicit mask
        assert causal, "non-causal padding unsupported; pre-pad inputs"
        kt = F.pad(kt, (0, 0, 0, pad_k))
        vt = F.pad(vt, (0, 0, 0, pad_k))
    out = flash_attention(
        qt.contiguous(), kt.contiguous(), vt.contiguous(), causal, window, bq, bk
    )
    return out[:, :, :S].transpose(1, 2)
