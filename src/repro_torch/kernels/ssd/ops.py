"""Full SSD forward through the chunk kernel, a drop-in equivalent of
``models.ssm.ssd_chunked``.

The chunk-local work runs by the tensors' device: a CPU tensor takes the
plain version (``ref.chunk_ref``), a CUDA tensor launches the Hopper kernel
or raises. The inter-chunk recurrence over (a_tot, S_local), which the JAX
package leaves to XLA's associative scan, is a plain loop over the chunks
here: nc is the prompt length over 64.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .ref import chunk_ref
from .ssd_kernel import ssd_chunk_kernel

Tensor = torch.Tensor


def ssd_chunk(x: Tensor, dt: Tensor, A: Tensor, Bm: Tensor, Cm: Tensor):
    """Chunk-local (Y_intra, S_local, a_tot) over (B, H, nc, Q, ...) inputs."""
    if x.device.type == "cpu":
        return chunk_ref(x, dt, A, Bm, Cm)
    if x.device.type != "cuda":
        raise ValueError(f"the SSD chunk runs on CPU or CUDA tensors, got {x.device}")
    return ssd_chunk_kernel(x, dt, A, Bm, Cm)


def ssd_forward(
    x: Tensor,  # (B, L, H, P) fp32
    dt: Tensor,  # (B, L, H)
    A: Tensor,  # (H,)
    Bm: Tensor,  # (B, L, H, N)
    Cm: Tensor,
    chunk: int = 64,
) -> Tuple[Tensor, Tensor]:
    """Returns (Y (B,L,H,P), final_state (B,H,P,N)) from a zero state."""
    B_, L, H, P = x.shape
    Q = min(chunk, L)
    pad = (-L) % Q
    if pad:
        x, Bm, Cm = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (x, Bm, Cm))
        dt = F.pad(dt, (0, 0, 0, pad))
    nc = (L + pad) // Q

    def to_chunks(a):  # (B, L, H, ...) -> (B, H, nc, Q, ...)
        a = a.reshape((B_, nc, Q) + tuple(a.shape[2:]))
        return a.movedim(3, 1).contiguous()

    xc, Bc, Cc = to_chunks(x), to_chunks(Bm), to_chunks(Cm)
    dtc = to_chunks(dt[..., None])[..., 0].contiguous()
    Y_intra, S_local, a_tot = ssd_chunk(xc, dtc, A.contiguous(), Bc, Cc)

    # inter-chunk: S_prev[c] is the state entering chunk c
    S_prev = torch.empty_like(S_local)  # (B, H, nc, N, P)
    state = torch.zeros_like(S_local[:, :, 0])
    for c in range(nc):
        S_prev[:, :, c] = state
        state = a_tot[:, :, c, None, None] * state + S_local[:, :, c]

    cum = torch.cumsum(dtc * A[None, :, None, None], dim=-1)
    Y_inter = torch.einsum(
        "bhcqn,bhcnp->bhcqp", Cc * torch.exp(cum)[..., None], S_prev
    )
    Y = Y_intra + Y_inter  # (B, H, nc, Q, P)
    Y = Y.movedim(1, 3).reshape(B_, nc * Q, H, P)[:, :L]
    return Y, state.transpose(-1, -2)  # (B, H, P, N)
