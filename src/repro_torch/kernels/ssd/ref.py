"""Plain PyTorch versions for the SSD chunk kernel.

``naive_recurrence``: the literal s_t = a_t s_{t-1} + u_t (x) B_t
recurrence, the ground truth for the chunk kernel and ``models.ssm``.
``chunk_ref``: the chunk-local function per (batch, head, chunk) cell, in
the JAX kernel's chunked layout. ``chunk_seq_ref``: the same in the Hopper
kernel's layout (sequence-major inputs, B and C per group), what the
kernel computes. ``chunk_bwd_ref``: the closed-form backward of
``chunk_seq_ref``, what the backward kernel computes.
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
    """(Y_intra (B,H,nc,Q,P), S_local (B,H,nc,N,P), a_tot (B,H,nc)).

    Autograd through this forward gives NaN in d(dt) and dA once a chunk's
    decay passes exp's range (RC5); ``chunk_bwd_ref`` is the backward that
    stays finite there."""
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


def chunk_bwd_ref(
    x: Tensor,  # (B, L, H, P)
    dt: Tensor,  # (B, L, H)
    A: Tensor,  # (H,)
    Bm: Tensor,  # (B, L, G, N), G divides H
    Cm: Tensor,
    dY: Tensor,  # (B, L, H, P): cotangent of Y_intra
    dS: Tensor,  # (B, nc, H, N, P): of S_local
    da: Tensor,  # (B, nc, H): of a_tot
    chunk: int,
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """(dx, d(dt), dA, dB, dC) of ``chunk_seq_ref`` in closed form, computed
    in fp32 and returned in the inputs' dtypes; dB and dC are summed over
    the H/G heads of each group. Per (batch, head, chunk), with cum =
    cumsum(dt A), u = dt x, M[t, tau] = exp(cum_t - cum_tau) for tau <= t
    (0 above), d_end = exp(cum_Q - cum) and G = (C B^T) o M:

        dG = dY u^T;  du = G^T dY + d_end o (B dS)
        dC = (dG o M) B;  dB = (dG o M)^T C + d_end o (u dS^T)
        dcum = rowsum(dG o G) - colsum(dG o G) - e, e = rowsum(B o d_end o (u dS^T)),
               plus sum(e) + da a_tot at the chunk's last step
        dla = reverse cumsum of dcum;  d(dt) = A dla + rowsum(x o du)
        dA = sum(dt dla);  dx = dt du

    The exponential is never formed above the diagonal (``diff`` is masked
    to -inf first), so the result stays finite where the decay over a
    chunk passes exp's range, where autograd of ``chunk_ref`` gives NaN."""
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

    def to_seq(a):  # (B, H, nc, Q, K) -> (B, L, H, K)
        return a.movedim(1, 3).reshape(B_, nc * Q, H, a.shape[-1])[:, :L]

    xc, Bc, Cc, dYc = to_chunks(x, H), to_chunks(Bm, G), to_chunks(Cm, G), to_chunks(dY, H)
    dtc = to_chunks(dt[..., None], H)[..., 0]  # (B, H, nc, Q)
    dSc, dac = dS.float().transpose(1, 2), da.float().transpose(1, 2)
    Af = A.float()[None, :, None, None]

    cum = torch.cumsum(dtc * Af, dim=-1)
    u = xc * dtc[..., None]
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    M = torch.exp((cum[..., :, None] - cum[..., None, :]).masked_fill(~tri, float("-inf")))
    d_end = torch.exp(cum[..., -1:] - cum)
    CB = torch.einsum("bhcqn,bhckn->bhcqk", Cc, Bc)
    dGM = torch.einsum("bhcqp,bhckp->bhcqk", dYc, u) * M
    du = (torch.einsum("bhcqk,bhcqp->bhckp", CB * M, dYc)
          + d_end[..., None] * torch.einsum("bhckn,bhcnp->bhckp", Bc, dSc))
    dC = torch.einsum("bhcqk,bhckn->bhcqn", dGM, Bc)
    dB_S = d_end[..., None] * torch.einsum("bhckp,bhcnp->bhckn", u, dSc)
    dB = torch.einsum("bhcqk,bhcqn->bhckn", dGM, Cc) + dB_S

    dGG = dGM * CB  # dG o G
    e = (Bc * dB_S).sum(-1)
    dcum = dGG.sum(-1) - dGG.sum(-2) - e
    dcum[..., -1] += e.sum(-1) + dac * torch.exp(cum[..., -1])
    dla = torch.flip(torch.cumsum(torch.flip(dcum, (-1,)), -1), (-1,))
    ddt = Af * dla + (xc * du).sum(-1)
    dA = (dtc * dla).sum((0, 2, 3))
    dx = dtc[..., None] * du

    def per_group(a):  # (B, L, H, N) -> (B, L, G, N), summed over a group's heads
        return a.reshape(B_, L, G, H // G, a.shape[-1]).sum(3)

    return (to_seq(dx).to(x.dtype), to_seq(ddt[..., None])[..., 0].to(dt.dtype),
            dA.to(A.dtype), per_group(to_seq(dB)).to(Bm.dtype),
            per_group(to_seq(dC)).to(Cm.dtype))
