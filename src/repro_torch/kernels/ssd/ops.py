"""Full SSD forward through the chunk kernel, a drop-in equivalent of
``models.ssm.ssd_chunked`` that also takes B and C per group.

The chunk-local work runs by the tensors' device: a CPU tensor takes the
plain version (``ref.chunk_seq_ref``), a CUDA tensor launches the Hopper
kernel, which reads x, dt, B and C in place, or raises. The inter-chunk
recurrence over (a_tot, S_local), which the JAX package leaves to XLA's
associative scan, is a plain loop over the chunks here: nc is the prompt
length over 64.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .ref import chunk_ref, chunk_seq_ref
from .ssd_kernel import ssd_chunk_kernel

Tensor = torch.Tensor


def _on_card(t: Tensor) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"the SSD chunk runs on CPU or CUDA tensors, got {t.device}")
    return True


def ssd_chunk(x: Tensor, dt: Tensor, A: Tensor, Bm: Tensor, Cm: Tensor):
    """Chunk-local (Y_intra, S_local, a_tot) in the JAX kernel's chunked
    layout: x (B, H, nc, Q, P), dt (B, H, nc, Q), B and C (B, H, nc, Q, N);
    outputs (B,H,nc,Q,P), (B,H,nc,N,P), (B,H,nc). On the card the chunked
    tensors go to the kernel as strided sequence-major views (no copies)
    and its outputs come back as views."""
    if not _on_card(x):
        return chunk_ref(x, dt, A, Bm, Cm)
    Q = x.shape[3]
    xs, dts, Bs, Cs = chunked_as_seq(x, dt, Bm, Cm)
    return seq_out_as_chunked(*ssd_chunk_kernel(xs, dts, A, Bs, Cs, chunk=Q), Q)


def chunked_as_seq(x: Tensor, dt: Tensor, Bm: Tensor, Cm: Tensor):
    """(B, H, nc, Q, ...) chunked inputs as sequence-major (B, nc Q, H, ...)
    views, B and C per head; no copies."""
    def seq(a):
        a = a.movedim(1, 3)
        return a.reshape((a.shape[0], a.shape[1] * a.shape[2]) + tuple(a.shape[3:]))

    return seq(x), seq(dt[..., None])[..., 0], seq(Bm), seq(Cm)


def seq_out_as_chunked(y: Tensor, s: Tensor, a_tot: Tensor, Q: int):
    """The kernel's outputs (B,L,H,P), (B,nc,H,N,P), (B,nc,H) as views in the
    chunked layout (B,H,nc,Q,P), (B,H,nc,N,P), (B,H,nc); L = nc Q."""
    B_, L, H, P = y.shape
    return (y.reshape(B_, L // Q, Q, H, P).movedim(3, 1), s.transpose(1, 2),
            a_tot.transpose(1, 2))


def ssd_forward(
    x: Tensor,  # (B, L, H, P) fp32 or bf16
    dt: Tensor,  # (B, L, H) fp32
    A: Tensor,  # (H,)
    Bm: Tensor,  # (B, L, G, N), G divides H (G = H: per head)
    Cm: Tensor,
    chunk: int = 64,
) -> Tuple[Tensor, Tensor]:
    """Returns (Y (B,L,H,P), final_state (B,H,P,N)) from a zero state, fp32."""
    B_, L, H, P = x.shape
    G, N = Bm.shape[-2:]
    if H % G:
        raise ValueError(f"{G} groups of B and C do not divide {H} heads")
    Q = min(chunk, L)
    nc = -(-L // Q)
    if _on_card(x):
        Y_intra, S_local, a_tot = ssd_chunk_kernel(x, dt, A, Bm, Cm, chunk=Q)
    else:
        Y_intra, S_local, a_tot = chunk_seq_ref(x, dt, A, Bm, Cm, Q)

    # inter-chunk: S_prev[:, c] is the state entering chunk c
    S_prev = torch.empty_like(S_local)  # (B, nc, H, N, P)
    state = torch.zeros_like(S_local[:, 0])
    for c in range(nc):
        S_prev[:, c] = state
        state = a_tot[:, c, :, None, None] * state + S_local[:, c]

    pad = nc * Q - L
    cum = torch.cumsum(F.pad(dt.float(), (0, 0, 0, pad)).reshape(B_, nc, Q, H) * A, dim=2)
    Cc = F.pad(Cm.float(), (0, 0, 0, 0, 0, pad)).reshape(B_, nc, Q, G, N)
    Y_inter = torch.einsum("bcqgn,bcgknp->bcqgkp", Cc, S_prev.view(B_, nc, G, H // G, N, P))
    Y_inter = Y_inter.reshape(B_, nc * Q, H, P) * torch.exp(cum).reshape(B_, nc * Q, H, 1)
    return Y_intra + Y_inter[:, :L], state.transpose(-1, -2)
