"""Hopper CUDA kernels for the Mamba2 SSD chunk-local computation and its
backward, bound with ctypes.

``ssd_chunk_kernel`` — csrc/ssd_chunk.cu: Y_intra, S_local and a_tot of
every (batch, head, chunk) in one launch, on the tensor cores (split
TF32); replaces the TPU kernel ``ssd_chunk_kernel`` of
``repro/kernels/ssd/ssd_kernel.py`` (the source says how they differ).
It reads the model's layout in place: x (B, L, H, P), dt (B, L, H) and B,
C per group (B, L, G, N), through strides, fp32 or bf16.

``ssd_chunk_bwd_kernel`` — csrc/ssd_chunk_bwd.cu (K4-bwd): dx, d(dt), dA,
dB and dC from the cotangents of K4's three outputs, over the same strided
inputs; the JAX package has no kernel here (it differentiates its jnp
``ssd_chunked``, ``repro/models/ssm.py``). Bit-deterministic: partials are
summed in a fixed order by a second kernel in the same launch call.

Each source has a plain C interface and is compiled on first use by
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
SOURCES = (CSRC / "ssd_chunk.cu", CSRC / "ssd_chunk_bwd.cu")
_ARGTYPES = [VP] * 8 + [INT] * 8 + [ctypes.c_longlong] * 12 + [VP]
_BWD_ARGTYPES = [VP] * 16 + [INT] * 8 + [ctypes.c_longlong] * 12 + [VP]
MAX_DIM = 128  # Q, P and N
MAX_Q_BWD = 64  # the backward's chunk: four 16-row tiles
MAX_SMEM_BYTES = 232448  # dynamic shared memory of one CTA
_DTYPES = (torch.float32, torch.bfloat16)


def _check_inputs(x, dt, A, Bm, Cm, chunk):
    """(B, L, H, G, Q, P, N) of valid kernel inputs, or raise."""
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
    return B, L, H, G, Q, P, N


def _strides(x, dt, Bm, Cm):
    return (*x.stride()[:3], *dt.stride(), *Bm.stride()[:3], *Cm.stride()[:3])


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
    B, L, H, G, Q, P, N = _check_inputs(x, dt, A, Bm, Cm, chunk)
    f32, dev = torch.float32, x.device
    nc = -(-L // Q)
    y = torch.empty((B, L, H, P), dtype=f32, device=dev)
    s = torch.empty((B, nc, H, N, P), dtype=f32, device=dev)
    a_tot = torch.empty((B, nc, H), dtype=f32, device=dev)
    err = launcher(SOURCES[0], _ARGTYPES)(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        y.data_ptr(), s.data_ptr(), a_tot.data_ptr(), B, L, H, G, Q, P, N,
        int(x.dtype == torch.bfloat16), *_strides(x, dt, Bm, Cm),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    raise_on(err, "ssd_chunk")
    ssd_chunk_kernel.launches += 1
    return y, s, a_tot


ssd_chunk_kernel.launches = 0


def bwd_smem_bytes(Q: int, N: int, P: int) -> int:
    """Dynamic shared memory of one K4-bwd CTA: ``BwdPlan`` of
    csrc/ssd_chunk_bwd.cu (B, C, u, dY, dS, G, dG o M and the per-step
    vectors and partials, in floats)."""
    QP, NP, PP = (-(-v // 16) * 16 for v in (Q, N, P))
    MT, NT, PT = QP // 16, NP // 16, PP // 16
    mats = 2 * QP * (NP + 4) + 2 * QP * (PP + 4) + NP * (PP + 4) + 2 * QP * (QP + 4)
    return 4 * (mats + 7 * QP + 2 * MT * MT * 16 + (NT + PT) * QP)


def check_bwd_shape(Q: int, P: int, N: int) -> None:
    """Raise unless K4-bwd takes chunks of Q steps with head dim P and state
    N (Q <= 64, P and N <= 128, the CTA's shared memory within 227 KB)."""
    if Q > MAX_Q_BWD or max(P, N) > MAX_DIM:
        raise ValueError(f"the SSD backward kernel takes Q <= {MAX_Q_BWD} and P, N <= "
                         f"{MAX_DIM}, got Q={Q}, P={P}, N={N}")
    if bwd_smem_bytes(Q, N, P) > MAX_SMEM_BYTES:
        raise ValueError(f"the SSD backward kernel's shared memory at Q={Q}, N={N}, P={P} "
                         f"is {bwd_smem_bytes(Q, N, P)} bytes, over {MAX_SMEM_BYTES}")


def ssd_chunk_bwd_kernel(
    x: torch.Tensor,  # (B, L, H, P) fp32 or bf16, the forward's inputs
    dt: torch.Tensor,
    A: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    dY: torch.Tensor,  # (B, L, H, P) fp32 dense: cotangent of Y_intra
    dS: torch.Tensor,  # (B, nc, H, N, P) fp32 dense: of S_local
    da: torch.Tensor,  # (B, nc, H) fp32 dense: of a_tot
    chunk: int = 64,
) -> Tuple[torch.Tensor, ...]:
    """(dx (B,L,H,P) in x's dtype, d(dt) (B,L,H) fp32, dA (H,) fp32, dB and
    dC (B,L,G,N) in x's dtype, summed over each group's heads)."""
    B, L, H, G, Q, P, N = _check_inputs(x, dt, A, Bm, Cm, chunk)
    check_bwd_shape(Q, P, N)
    f32, dev = torch.float32, x.device
    nc = -(-L // Q)
    for name, t, shape in (("dY", dY, (B, L, H, P)), ("dS", dS, (B, nc, H, N, P)),
                           ("da", da, (B, nc, H))):
        check_tensor(name, t, shape, f32, dev, "dense")
    dx = torch.empty((B, L, H, P), dtype=x.dtype, device=dev)
    ddt = torch.empty((B, L, H), dtype=f32, device=dev)
    dA = torch.empty((H,), dtype=f32, device=dev)
    dB = torch.empty((B, L, G, N), dtype=x.dtype, device=dev)
    dC = torch.empty((B, L, G, N), dtype=x.dtype, device=dev)
    dB_part = torch.empty((B, L, H, N), dtype=f32, device=dev)
    dC_part = torch.empty((B, L, H, N), dtype=f32, device=dev)
    dA_part = torch.empty((B, nc, H), dtype=f32, device=dev)
    err = launcher(SOURCES[1], _BWD_ARGTYPES)(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        dY.data_ptr(), dS.data_ptr(), da.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
        dA.data_ptr(), dB.data_ptr(), dC.data_ptr(), dB_part.data_ptr(), dC_part.data_ptr(),
        dA_part.data_ptr(), B, L, H, G, Q, P, N, int(x.dtype == torch.bfloat16),
        *_strides(x, dt, Bm, Cm), torch.cuda.current_stream(dev).cuda_stream,
    )
    raise_on(err, "ssd_chunk_bwd")
    ssd_chunk_bwd_kernel.launches += 1
    return dx, ddt, dA, dB, dC


ssd_chunk_bwd_kernel.launches = 0
