"""Entry points for the flash-attention kernels, by the tensors' device: a
CPU tensor runs the plain version (``ref.attention_ref``), a CUDA tensor
launches the Hopper kernel, a ``meta`` tensor (the dry run) takes the
kernel's output shapes, dtypes and layouts, and any other device raises.

``flash_attention_bshd`` adapts the model layout (B, S, H, HD) to the
kernel's (B, H, S, HD). On CPU tensors it pads the sequence to the block
multiples and makes the transposed copies, as the JAX package's wrapper
does. On CUDA tensors it hands the kernel transposed views of the model's
tensors as they are (the kernel takes strides and masks the ragged edge
itself) and returns the output in the model layout: no pad, no copy.

It is differentiable both ways. On CUDA and meta tensors it goes through
``FlashAttention``, a ``torch.autograd.Function`` whose forward is K3 (with
the rows' log-sum-exp kept only when a gradient is wanted) and whose
backward is K3-bwd; no CUDA path falls back to the plain version. On CPU
tensors autograd differentiates the plain version, except under a cost
counter (``roofline.analysis``): there the CPU goes through
``FlashAttention`` too, its plain forward and the plain version's autograd
as the backward, so the kernels are counted once each, by their formulas
(``k3_cost``, ``k3_bwd_cost``), as on the card and on meta.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ...roofline import analysis as _cost
from .flash_kernel import flash_attention as flash_attention_kernel
from .flash_kernel import flash_attention_bwd
from .ref import attention_ref

Tensor = torch.Tensor


def kept_pairs(S: int, Sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs a head keeps: the causal triangle (within the
    window: row i keeps keys i - window + 1 .. i), or all S Sk."""
    if not causal:
        return S * Sk
    w = window if window and window < S else S
    return w * (w + 1) // 2 + (S - w) * w


def k3_cost(B: int, H: int, S: int, Sk: int, HD: int, causal: bool, window: int,
            itemsize: int, lse: bool) -> tuple:
    """(FLOPs, bytes) of one K3 call: 2 products of 2 HD FLOPs per kept
    pair; q, k and v read once, the output (and the fp32 lse) written
    once."""
    flops = 4 * B * H * HD * kept_pairs(S, Sk, causal, window)
    nbytes = (2 * B * H * S * HD + 2 * B * H * Sk * HD) * itemsize + (4 * B * H * S if lse else 0)
    return flops, nbytes


def k3_bwd_cost(B: int, H: int, S: int, Sk: int, HD: int, causal: bool, window: int,
                itemsize: int) -> tuple:
    """(FLOPs, bytes) of one K3-bwd call: the function's 5 products (S, dP,
    dV, dK, dQ) of 2 HD FLOPs per kept pair; q, k, v, the output, its
    gradient and the lse read once, dq, dk and dv written once."""
    flops = 10 * B * H * HD * kept_pairs(S, Sk, causal, window)
    nbytes = (4 * B * H * S * HD + 4 * B * H * Sk * HD) * itemsize + 4 * B * H * S
    return flops, nbytes


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
    c = _cost.ACTIVE
    if c is not None:
        B, H, _, HD = q.shape
        return c.launch("K3", k3_cost(B, H, S, Sk, HD, causal, window, q.element_size(), False),
                        _flash_bhsd, q, k, v, causal, window)
    return _flash_bhsd(q, k, v, causal, window)


def _flash_bhsd(q: Tensor, k: Tensor, v: Tensor, causal: bool, window: int) -> Tensor:
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal, window)
    if q.device.type == "meta":
        return torch.empty_like(q)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on CPU, CUDA or meta tensors, got {q.device}")
    return flash_attention_kernel(q, k, v, causal, window)


class FlashAttention(torch.autograd.Function):
    """K3 and K3-bwd over tensors in the model layout (B, S, H, HD): the
    kernels on CUDA tensors, their output shapes on meta tensors, and on
    CPU tensors (under a cost counter only) the plain version and its
    autograd, returned in the kernels' layouts."""

    @staticmethod
    def forward(ctx, q: Tensor, k: Tensor, v: Tensor, causal: bool, window: int) -> Tensor:
        grad = any(ctx.needs_input_grad[:3])
        c = _cost.ACTIVE
        if c is None:
            out, lse = _k3_forward(q, k, v, causal, window, grad)
        else:
            B, S, H, HD = q.shape
            out, lse = c.launch(
                "K3", k3_cost(B, H, S, k.shape[1], HD, causal, window, q.element_size(), grad),
                _k3_forward, q, k, v, causal, window, grad)
        if grad:
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout: Tensor):
        q, k, v, out, lse = ctx.saved_tensors
        args = (q, k, v, out, lse, dout, ctx.causal, ctx.window)
        c = _cost.ACTIVE
        if c is None:
            dq, dk, dv = _k3_backward(*args)
        else:
            B, S, H, HD = q.shape
            dq, dk, dv = c.launch(
                "K3-bwd", k3_bwd_cost(B, H, S, k.shape[1], HD, ctx.causal, ctx.window,
                                      q.element_size()), _k3_backward, *args)
        return dq, dk, dv, None, None


def _k3_forward(q, k, v, causal: bool, window: int, lse: bool):
    """(out (B, S, H, HD), lse (B, H, S) fp32 or None) by the device."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    dev = q.device.type
    if dev == "cuda":
        if lse:
            out, l = flash_attention_kernel(qt, kt, vt, causal, window, return_lse=True)
            return out.transpose(1, 2), l
        return flash_attention_kernel(qt, kt, vt, causal, window).transpose(1, 2), None
    if dev == "meta":
        l = (torch.empty(qt.shape[:3], dtype=torch.float32, device=q.device) if lse else None)
        return torch.empty_like(qt).transpose(1, 2), l
    if dev != "cpu":
        raise ValueError(f"flash attention runs on CPU, CUDA or meta tensors, got {q.device}")
    # the plain version, in the layout K3 writes (q's); the CPU keeps no lse
    return torch.empty_like(q).copy_(_plain(q, k, v, causal, window)), None


def _k3_backward(q, k, v, out, lse, dout, causal: bool, window: int):
    """(dq, dk, dv) in the layouts of q, k and v, by the device."""
    dev = q.device.type
    if dev == "cuda":
        dq, dk, dv = flash_attention_bwd(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), out.transpose(1, 2),
            dout.contiguous().transpose(1, 2), lse, causal, window,
        )
        return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)
    if dev == "meta":
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # the CPU: autograd of the plain version, recomputed from q, k and v
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        grads = torch.autograd.grad(_plain(*leaves, causal, window), leaves, dout)
    return tuple(torch.empty_like(t).copy_(g) for t, g in zip((q, k, v), grads))


def _plain(q: Tensor, k: Tensor, v: Tensor, causal: bool, window: int) -> Tensor:
    """The CPU's plain attention in the model layout: non-causal at its
    whole length (the keys need no pad), causal as ``flash_attention_bshd``
    runs it."""
    if not causal:
        out = attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), False,
                            window)
        return out.transpose(1, 2)
    return _bshd_plain(q, k, v, True, window, 128, 128)


def flash_attention_bshd(
    q: Tensor,  # (B, S, H, HD): model layout
    k: Tensor,
    v: Tensor,
    causal: bool = True,
    window: int = 0,
    block_q: int = 128,
    block_k: int = 128,
) -> Tensor:
    if q.device.type != "cpu" or _cost.ACTIVE is not None:
        return FlashAttention.apply(q, k, v, causal, window)
    return _bshd_plain(q, k, v, causal, window, block_q, block_k)


def _bshd_plain(q: Tensor, k: Tensor, v: Tensor, causal: bool, window: int, block_q: int,
                block_k: int) -> Tensor:
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
    out = _flash_bhsd(qt.contiguous(), kt.contiguous(), vt.contiguous(), causal, window)
    return out[:, :, :S].transpose(1, 2)
