"""Full SSD forward through the chunk kernel, a drop-in equivalent of
``models.ssm.ssd_chunked`` that also takes B and C per group.

The chunk-local work is the autograd Function ``SSDChunk`` and runs by the
tensors' device: a CPU tensor takes the plain versions (``ref.chunk_seq_ref``
forward, ``ref.chunk_bwd_ref`` backward), a CUDA tensor launches the Hopper
kernels (K4 forward, K4-bwd backward), which read x, dt, B and C in place,
or raises. The inter-chunk
recurrence over (a_tot, S_local), which the JAX package leaves to XLA's
associative scan, is a plain loop over the chunks here: nc is the prompt
length over 64. It stays under autograd, as does ``Y_inter``.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .ref import chunk_bwd_ref, chunk_ref, chunk_seq_ref
from .ssd_kernel import check_bwd_shape, ssd_chunk_bwd_kernel, ssd_chunk_kernel

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


class SSDChunk(torch.autograd.Function):
    """The chunk-local SSD, (Y_intra, S_local, a_tot) = f(x, dt, A, B, C),
    in the kernel's sequence-major layout: on the card K4 forward and K4-bwd
    backward, on the CPU their plain versions. The inputs are saved as they
    are (x, B and C may be bf16 views of the conv output); the backward
    returns dx, dB and dC in their dtypes, B and C's summed per group."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk: int):
        Q = min(chunk, x.shape[1])
        if _on_card(x):
            if any(ctx.needs_input_grad[:5]):
                check_bwd_shape(Q, x.shape[-1], Bm.shape[-1], x.dtype == torch.bfloat16)
            outs = ssd_chunk_kernel(x, dt, A, Bm, Cm, chunk=Q)
        else:
            outs = chunk_seq_ref(x, dt, A, Bm, Cm, Q)
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.chunk = Q
        return outs

    @staticmethod
    def backward(ctx, dY, dS, da):
        x, dt, A, Bm, Cm = ctx.saved_tensors
        bwd = ssd_chunk_bwd_kernel if _on_card(x) else chunk_bwd_ref
        grads = bwd(x, dt, A, Bm, Cm, dY.contiguous(), dS.contiguous(), da.contiguous(),
                    ctx.chunk)
        return grads + (None,)


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
    Y_intra, S_local, a_tot = SSDChunk.apply(x, dt, A, Bm, Cm, Q)

    # inter-chunk: S_prev[:, c] is the state entering chunk c. unbind and
    # stack, not slices and slice assignment: their backward passes are one
    # stack and one unbind, where a slice's would add a zero-filled copy of
    # all of S_local per chunk
    states = [torch.zeros_like(S_local[:, 0])]
    for a_c, s_c in zip(a_tot.unbind(1), S_local.unbind(1)):
        states.append(a_c[..., None, None] * states[-1] + s_c)
    S_prev = torch.stack(states[:-1], dim=1)  # (B, nc, H, N, P)
    state = states[-1]

    pad = nc * Q - L
    cum = torch.cumsum(F.pad(dt.float(), (0, 0, 0, pad)).reshape(B_, nc, Q, H) * A, dim=2)
    Cc = F.pad(Cm.float(), (0, 0, 0, 0, 0, pad)).reshape(B_, nc, Q, G, N)
    Y_inter = torch.einsum("bcqgn,bcgknp->bcqgkp", Cc, S_prev.view(B_, nc, G, H // G, N, P))
    Y_inter = Y_inter.reshape(B_, nc * Q, H, P) * torch.exp(cum).reshape(B_, nc * Q, H, 1)
    return Y_intra + Y_inter[:, :L], state.transpose(-1, -2)
