"""Hopper CUDA kernel for the Mamba2 SSD chunk-local computation, bound
with ctypes.

``ssd_chunk_kernel`` — csrc/ssd_chunk.cu: Y_intra, S_local and a_tot of
every (batch, head, chunk) cell in one launch (one CTA per cell); replaces
the TPU kernel ``ssd_chunk_kernel`` of ``repro/kernels/ssd/ssd_kernel.py``
(the source says how they differ).

The source has a plain C interface and is compiled on first use by
``repro_torch.kernels.nvcc``. The wrapper checks device, dtype, shape and
contiguity, allocates the outputs, launches on PyTorch's current stream,
raises if the launch returned a CUDA error, and only then adds one to its
``launches`` count.
"""
from __future__ import annotations

from pathlib import Path
from typing import Tuple

import torch

from ..nvcc import INT, VP, check_tensor, launcher, raise_on

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "ssd_chunk.cu",)
_ARGTYPES = [VP] * 8 + [INT] * 6 + [VP]
MAX_DIM = 128  # Q, P and N


def ssd_chunk_kernel(
    x: torch.Tensor,  # (B, H, nc, Q, P) fp32
    dt: torch.Tensor,  # (B, H, nc, Q)
    A: torch.Tensor,  # (H,)
    Bm: torch.Tensor,  # (B, H, nc, Q, N)
    Cm: torch.Tensor,  # (B, H, nc, Q, N)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(Y_intra (B,H,nc,Q,P), S_local (B,H,nc,N,P), a_tot (B,H,nc)), fp32."""
    if x.device.type != "cuda":
        raise ValueError(f"the SSD kernel runs on CUDA tensors, got {x.device}")
    B, H, nc, Q, P = x.shape
    N = Bm.shape[-1]
    if max(Q, P, N) > MAX_DIM:
        raise ValueError(f"kernel takes Q, P, N <= {MAX_DIM}, got {Q}, {P}, {N}")
    f32, dev = torch.float32, x.device
    for name, t, shape in (
        ("x", x, (B, H, nc, Q, P)), ("dt", dt, (B, H, nc, Q)), ("A", A, (H,)),
        ("Bm", Bm, (B, H, nc, Q, N)), ("Cm", Cm, (B, H, nc, Q, N)),
    ):
        check_tensor(name, t, shape, f32, dev)
    y = torch.empty((B, H, nc, Q, P), dtype=f32, device=dev)
    s = torch.empty((B, H, nc, N, P), dtype=f32, device=dev)
    a_tot = torch.empty((B, H, nc), dtype=f32, device=dev)
    err = launcher(SOURCES[0], _ARGTYPES)(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        y.data_ptr(), s.data_ptr(), a_tot.data_ptr(), B, H, nc, Q, P, N,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    raise_on(err, "ssd_chunk")
    ssd_chunk_kernel.launches += 1
    return y, s, a_tot


ssd_chunk_kernel.launches = 0
