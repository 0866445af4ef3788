"""Hopper CUDA kernel for the Mamba2 SSD chunk-local computation, bound
with ctypes.

``ssd_chunk_kernel`` — csrc/ssd_chunk.cu: Y_intra, S_local and a_tot of
every (batch, head, chunk) in one launch, on the tensor cores (split
TF32); replaces the TPU kernel ``ssd_chunk_kernel`` of
``repro/kernels/ssd/ssd_kernel.py`` (the source says how they differ).
It reads the model's layout in place: x (B, L, H, P), dt (B, L, H) and B,
C per group (B, L, G, N), through strides, fp32 or bf16.

The source has a plain C interface and is compiled on first use by
``repro_torch.kernels.nvcc``. The wrapper checks device, dtype, shape and
strides, allocates the outputs, launches on PyTorch's current stream,
raises if the launch returned a CUDA error, and only then adds one to its
``launches`` count.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from ..nvcc import INT, VP, check_tensor, launcher, raise_on

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "ssd_chunk.cu",)
_ARGTYPES = [VP] * 8 + [INT] * 8 + [ctypes.c_longlong] * 12 + [VP]
MAX_DIM = 128  # Q, P and N
_DTYPES = (torch.float32, torch.bfloat16)


def ssd_chunk_kernel(
    x: torch.Tensor,  # (B, L, H, P) fp32 or bf16, last dim contiguous
    dt: torch.Tensor,  # (B, L, H) fp32
    A: torch.Tensor,  # (H,) fp32
    Bm: torch.Tensor,  # (B, L, G, N), x's dtype, G divides H
    Cm: torch.Tensor,  # (B, L, G, N)
    chunk: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Chunks of Q = min(chunk, L) steps (a ragged last chunk reads as
    zero rows): (Y_intra (B,L,H,P), S_local (B,nc,H,N,P), a_tot (B,nc,H)),
    fp32, nc = ceil(L / Q)."""
    if x.device.type != "cuda":
        raise ValueError(f"the SSD kernel runs on CUDA tensors, got {x.device}")
    B, L, H, P = x.shape
    G, N = Bm.shape[-2:]
    Q = min(chunk, L)
    if max(Q, P, N) > MAX_DIM:
        raise ValueError(f"kernel takes Q, P, N <= {MAX_DIM}, got {Q}, {P}, {N}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"kernel takes x in {_DTYPES}, got {x.dtype}")
    if H % G:
        raise ValueError(f"{G} groups of B and C do not divide {H} heads")
    f32, dev = torch.float32, x.device
    for name, t, shape, dtype, layout in (
        ("x", x, (B, L, H, P), x.dtype, "rows"), ("dt", dt, (B, L, H), f32, "any"),
        ("A", A, (H,), f32, "dense"), ("Bm", Bm, (B, L, G, N), x.dtype, "rows"),
        ("Cm", Cm, (B, L, G, N), x.dtype, "rows"),
    ):
        check_tensor(name, t, shape, dtype, dev, layout)
    nc = -(-L // Q)
    y = torch.empty((B, L, H, P), dtype=f32, device=dev)
    s = torch.empty((B, nc, H, N, P), dtype=f32, device=dev)
    a_tot = torch.empty((B, nc, H), dtype=f32, device=dev)
    err = launcher(SOURCES[0], _ARGTYPES)(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        y.data_ptr(), s.data_ptr(), a_tot.data_ptr(), B, L, H, G, Q, P, N,
        int(x.dtype == torch.bfloat16),
        *x.stride()[:3], *dt.stride(), *Bm.stride()[:3], *Cm.stride()[:3],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    raise_on(err, "ssd_chunk")
    ssd_chunk_kernel.launches += 1
    return y, s, a_tot


ssd_chunk_kernel.launches = 0
