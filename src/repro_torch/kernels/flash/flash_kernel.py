"""Hopper CUDA kernels for flash attention, forward and backward, bound with ctypes.

``flash_attention`` (K3) — csrc/flash_fwd.cu: causal or sliding-window softmax
attention over (B, H, S, HD) views in one launch (one CTA per 64-row query
block, head and batch); replaces the TPU kernel ``flash_attention`` of
``repro/kernels/flash/flash_kernel.py`` (the source says how they differ).
bf16 calls run the tensor-core kernel (``mma.sync``, bf16 P V), fp32 calls
the fp32-FMA kernel. The tensors may be strided views (the model's
(B, S, H, HD) layout transposed, for one): only the head dim must be
contiguous; for bf16 every other stride must be a multiple of 8 elements
and each base 16-byte aligned. The output has q's layout. With
``return_lse`` it also returns each row's log-sum-exp (B, H, S) fp32, which
the backward needs.

``flash_attention_bwd`` (K3-bwd) — csrc/flash_bwd.cu: dQ, dK and dV of the
same attention from q, k, v, the forward's output and lse, and the output's
gradient, over the same views and masks, on the tensor cores (bf16
``mma.sync``; fp32 in split TF32), with the same bits from call to call.
The JAX package has no such kernel (it differentiates its jnp attention);
the source says how it works. Both sources include csrc/flash_common.cuh.

Each source has a plain C interface and is compiled on first use by
``repro_torch.kernels.nvcc``. Each wrapper checks device, dtype, shape and
layout, allocates its outputs (and K3-bwd's scratch), launches on
PyTorch's current stream, raises if the launch returned a CUDA error, and
only then adds one to its ``launches`` count.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..nvcc import FLOAT, INT, VP, launcher, raise_on

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "flash_fwd.cu", CSRC / "flash_bwd.cu")
_ARGTYPES = [VP] * 4 + [INT] * 7 + [FLOAT, INT, VP, VP, VP]
_BWD_ARGTYPES = [VP] * 10 + [INT] * 7 + [FLOAT, INT, VP, VP]
DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 256
# the bf16 kernel is built per head dim: every multiple of 16 up to 128, and
# 192 and 256 (gemma3's); the fp32 kernel takes any multiple of 16 up to 256
BF16_HEAD_DIMS = tuple(range(16, 129, 16)) + (192, 256)


def flash_attention(
    q: torch.Tensor,  # (B, H, S, HD)
    k: torch.Tensor,  # (B, H, Sk, HD)
    v: torch.Tensor,  # (B, H, Sk, HD)
    causal: bool = True,
    window: int = 0,
    return_lse: bool = False,
):
    """Attention output (B, H, S, HD) in q's dtype; fp32 math inside. With
    ``return_lse``, ``(out, lse)``: lse (B, H, S) fp32 is each row's
    log2-sum-exp2 of the scaled scores (``flash_attention_bwd``'s input).

    The kernel tiles by 64 rows and keys itself and masks the ragged edge,
    so S and Sk need not be multiples of a block. HD must be a multiple of
    16 up to 256, and in bf16 one of ``BF16_HEAD_DIMS``. A causal call
    needs Sk >= S (every row keeps its diagonal key, which lets the kernel
    skip fully masked key blocks)."""
    B, H, S, HD, Sk = _check_call(q, k, v, causal)
    out = torch.empty_like(q)  # q's layout: (B, S, H, HD) memory stays so
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) if return_lse else None
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    err = launcher(SOURCES[0], _ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, S, Sk, HD,
        int(causal), int(window), 1.0 / HD**0.5, int(q.dtype == torch.bfloat16),
        strides, None if lse is None else lse.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    raise_on(err, "flash_fwd")
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0


def flash_attention_bwd(
    q: torch.Tensor,  # (B, H, S, HD)
    k: torch.Tensor,  # (B, H, Sk, HD)
    v: torch.Tensor,  # (B, H, Sk, HD)
    out: torch.Tensor,  # (B, H, S, HD): the forward's output
    dout: torch.Tensor,  # (B, H, S, HD): the loss's gradient at out
    lse: torch.Tensor,  # (B, H, S) fp32: the forward's return_lse
    causal: bool = True,
    window: int = 0,
):
    """(dq, dk, dv) of ``flash_attention(q, k, v, causal, window)``, each in
    the layout and dtype of its input; fp32 accumulation inside. Takes the
    views and head dims the forward takes and raises on the rest; an fp32
    q, k, v or dout whose strides or base are not whole 16-byte units is
    copied to a dense tensor first (bf16 views must be so already)."""
    B, H, S, HD, Sk = _check_call(q, k, v, causal)
    for name, t in (("out", out), ("dout", dout)):
        _check_view(name, t, (B, H, S, HD), q.dtype, q.device)
    if (lse.device != q.device or lse.dtype != torch.float32
            or tuple(lse.shape) != (B, H, S) or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous ({B}, {H}, {S}) fp32 tensor on "
                         f"{q.device}, got {lse.dtype} {tuple(lse.shape)} on {lse.device}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    D = torch.empty((B, H, S), dtype=torch.float32, device=q.device)  # rowsum(dout * out)
    q, k, v, dout = (_staged(t) for t in (q, k, v, dout))
    strides = (ctypes.c_longlong * 24)(
        *(s for t in (q, k, v, out, dout, dq, dk, dv) for s in t.stride()[:3]))
    err = launcher(SOURCES[1], _BWD_ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), D.data_ptr(),
        B, H, S, Sk, HD, int(causal), int(window), 1.0 / HD**0.5,
        int(q.dtype == torch.bfloat16), strides,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    raise_on(err, "flash_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


def _staged(t: torch.Tensor) -> torch.Tensor:
    """``t`` as K3-bwd stages it with cp.async: itself if ``_cp_async_view``,
    else (an fp32 view; ``_check_view`` refused such bf16 ones) a dense copy."""
    return t if _cp_async_view(t) else t.clone(memory_format=torch.contiguous_format)


def _cp_async_view(t: torch.Tensor) -> bool:
    """Whether cp.async (16 bytes a copy) can read ``t`` in place: batch,
    head and row strides in whole 16-byte units from a 16-byte aligned base."""
    return t.data_ptr() % 16 == 0 and all(s * t.element_size() % 16 == 0 for s in t.stride()[:3])


def _check_call(q, k, v, causal: bool):
    """(B, H, S, HD, Sk) of a call both kernels take; raises on the rest."""
    if q.device.type != "cuda":
        raise ValueError(f"the flash kernels run on CUDA tensors, got {q.device}")
    B, H, S, HD = q.shape
    Sk = k.shape[2]
    if q.dtype not in DTYPES:
        raise TypeError(f"kernel takes {DTYPES}, got {q.dtype}")
    if HD % 16 or HD > MAX_HEAD_DIM:
        raise ValueError(f"head dim must be a multiple of 16 up to {MAX_HEAD_DIM}, got {HD}")
    if q.dtype == torch.bfloat16 and HD not in BF16_HEAD_DIMS:
        raise ValueError(f"the bf16 kernel is built for head dims {BF16_HEAD_DIMS}, got {HD}")
    if causal and Sk < S:
        raise ValueError(f"a causal call needs Sk >= S, got Sk={Sk}, S={S}")
    for name, t, shape in (("q", q, (B, H, S, HD)), ("k", k, (B, H, Sk, HD)),
                           ("v", v, (B, H, Sk, HD))):
        _check_view(name, t, shape, q.dtype, q.device)
    return B, H, S, HD, Sk


def _check_view(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    """Raise unless ``t`` is a view the kernel reads in place: the device,
    dtype and shape, a contiguous head dim and, for bf16, ``_cp_async_view``
    (fp32 views that are not are copied by ``flash_attention_bwd`` and read
    as they are by the forward's FMA kernel)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.stride(3) != 1:
        raise ValueError(f"{name} must have a contiguous head dim, strides {t.stride()}")
    if dtype == torch.bfloat16 and not _cp_async_view(t):
        raise ValueError(f"bf16 {name} needs strides in multiples of 8 elements and a "
                         f"16-byte aligned base, got strides {t.stride()}")
