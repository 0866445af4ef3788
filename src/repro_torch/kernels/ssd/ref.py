"""Plain PyTorch versions for the SSD chunk kernel.

``naive_recurrence``: the literal s_t = a_t s_{t-1} + u_t (x) B_t
recurrence, the ground truth for the chunk kernel and ``models.ssm``.
``chunk_ref``: the chunk-local function per (batch, head, chunk) cell, in
the JAX kernel's chunked layout. ``chunk_seq_ref``: the same in the Hopper
kernel's layout (sequence-major inputs, B and C per group), what the
kernel computes.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def naive_recurrence(
    x: Tensor,  # (B, L, H, P) fp32
    dt: Tensor,  # (B, L, H)
    A: Tensor,  # (H,) negative
    Bm: Tensor,  # (B, L, H, N)
    Cm: Tensor,  # (B, L, H, N)
) -> Tuple[Tensor, Tensor]:
    """Returns (Y (B,L,H,P), final_state (B,H,P,N))."""
    B_, L, H, P = x.shape
    N = Bm.shape[-1]
    s = torch.zeros((B_, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(L):
        a = torch.exp(dt[:, t] * A)  # (B, H)
        u = x[:, t] * dt[:, t, :, None]
        s = a[..., None, None] * s + torch.einsum("bhp,bhn->bhpn", u, Bm[:, t])
        ys.append(torch.einsum("bhn,bhpn->bhp", Cm[:, t], s))
    return torch.stack(ys, dim=1), s


def chunk_ref(
    x: Tensor,  # (B, H, nc, Q, P)
    dt: Tensor,  # (B, H, nc, Q)
    A: Tensor,  # (H,)
    Bm: Tensor,  # (B, H, nc, Q, N)
    Cm: Tensor,
) -> Tuple[Tensor, Tensor, Tensor]:
    """(Y_intra (B,H,nc,Q,P), S_local (B,H,nc,N,P), a_tot (B,H,nc))."""
    cum = torch.cumsum(dt * A[None, :, None, None], dim=-1)
    u = x * dt[..., None]
    diff = cum[..., :, None] - cum[..., None, :]
    Q = x.shape[-2]
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    # where() after exp, as the JAX package does: exp(diff) may be inf above
    # the diagonal, and where() never multiplies it by the 0 of the mask
    M = torch.where(tri, torch.exp(diff), torch.zeros((), device=x.device))
    CB = torch.einsum("bhcqn,bhckn->bhcqk", Cm, Bm)
    Y = torch.einsum("bhcqk,bhckp->bhcqp", CB * M, u)
    decay_end = torch.exp(cum[..., -1:] - cum)
    S = torch.einsum("bhcqn,bhcqp->bhcnp", Bm * decay_end[..., None], u)
    a_tot = torch.exp(cum[..., -1])
    return Y, S, a_tot


def chunk_seq_ref(
    x: Tensor,  # (B, L, H, P)
    dt: Tensor,  # (B, L, H)
    A: Tensor,  # (H,)
    Bm: Tensor,  # (B, L, G, N), G divides H
    Cm: Tensor,
    chunk: int,
) -> Tuple[Tensor, Tensor, Tensor]:
    """(Y_intra (B,L,H,P), S_local (B,nc,H,N,P), a_tot (B,nc,H)) in fp32 over
    chunks of Q = min(chunk, L); the last chunk is zero-padded."""
    B_, L, H, P = x.shape
    G = Bm.shape[2]
    Q = min(chunk, L)
    nc = -(-L // Q)
    pad = nc * Q - L

    def to_chunks(a, heads):  # (B, L, heads, ...) -> (B, H, nc, Q, ...)
        a = F.pad(a.float(), (0, 0) * (a.dim() - 2) + (0, pad))
        if heads != H:
            a = torch.repeat_interleave(a, H // heads, dim=2)
        return a.reshape((B_, nc, Q) + tuple(a.shape[2:])).movedim(3, 1)

    Y, S, a_tot = chunk_ref(
        to_chunks(x, H), to_chunks(dt[..., None], H)[..., 0], A.float(),
        to_chunks(Bm, G), to_chunks(Cm, G),
    )
    Y = Y.movedim(1, 3).reshape(B_, nc * Q, H, P)[:, :L]
    return Y, S.transpose(1, 2), a_tot.transpose(1, 2)
