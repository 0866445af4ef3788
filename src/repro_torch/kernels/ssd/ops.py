"""Full SSD forward through the chunk kernel, a drop-in equivalent of
``models.ssm.ssd_chunked`` that also takes B and C per group.

The chunk-local work is the autograd Function ``SSDChunk`` and runs by the
tensors' device: a CPU tensor takes the plain versions (``ref.chunk_seq_ref``
forward, ``ref.chunk_bwd_ref`` backward), a CUDA tensor launches the Hopper
kernels (K4 forward, K4-bwd backward), which read x, dt, B and C in place,
a ``meta`` tensor (the dry run) takes the kernels' output shapes, and any
other device raises. Under a cost counter (``roofline.analysis``) each
kernel is counted once by its formula (``k4_cost``, ``k4_bwd_cost``) and
the CPU's plain outputs come back in the kernels' layouts. The inter-chunk
recurrence over (a_tot, S_local), which the JAX package leaves to XLA's
associative scan, is a plain loop over the chunks here: nc is the prompt
length over 64. It stays under autograd, as does ``Y_inter``.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ...roofline import analysis as _cost
from .ref import chunk_bwd_ref, chunk_ref, chunk_seq_ref
from .ssd_kernel import check_bwd_shape, ssd_chunk_bwd_kernel, ssd_chunk_kernel

Tensor = torch.Tensor


def _device(t: Tensor) -> str:
    if t.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"the SSD chunk runs on CPU, CUDA or meta tensors, got {t.device}")
    return t.device.type


def k4_cost(B: int, L: int, H: int, G: int, P: int, N: int, Q: int, itemsize: int) -> tuple:
    """(FLOPs, bytes) of one K4 call over nc = ceil(L / Q) chunks: C B^T per
    group over the causal triangle, Y and S per head; x, B and C (in
    ``itemsize``), dt and A read once, Y, S and a_tot (fp32) written once."""
    nc, tri = -(-L // Q), Q * (Q + 1) // 2
    flops = B * nc * (G * 2 * tri * N + H * (2 * tri * P + 2 * Q * N * P))
    nbytes = (B * (L * H * P * itemsize + 2 * L * G * N * itemsize + 4 * L * H) + 4 * H
              + 4 * B * (L * H * P + nc * H * N * P + nc * H))
    return flops, nbytes


def k4_bwd_cost(B: int, L: int, H: int, G: int, P: int, N: int, Q: int,
                itemsize: int) -> tuple:
    """(FLOPs, bytes) of one K4-bwd call: C B^T and the (dG o M) terms of dC
    and dB once per group, dY u^T and G^T dY per head over the causal
    triangle, u dS^T and B dS per head over the chunk; x, dt, A, B, C, dY,
    dS and da read once, dx, d(dt), dA, dB and dC written once."""
    nc, tri = -(-L // Q), Q * (Q + 1) // 2
    flops = B * nc * (G * 3 * 2 * tri * N + H * (2 * 2 * tri * P + 2 * 2 * Q * N * P))
    nbytes = (2 * B * L * H * P * itemsize + 4 * B * L * G * N * itemsize + 2 * B * L * H * 4
              + 2 * H * 4 + 4 * B * L * H * P + 4 * B * nc * H * N * P + 4 * B * nc * H)
    return flops, nbytes


def ssd_chunk(x: Tensor, dt: Tensor, A: Tensor, Bm: Tensor, Cm: Tensor):
    """Chunk-local (Y_intra, S_local, a_tot) in the JAX kernel's chunked
    layout: x (B, H, nc, Q, P), dt (B, H, nc, Q), B and C (B, H, nc, Q, N);
    outputs (B,H,nc,Q,P), (B,H,nc,N,P), (B,H,nc). On the card the chunked
    tensors go to the kernel as strided sequence-major views (no copies)
    and its outputs come back as views."""
    c = _cost.ACTIVE
    if c is not None:
        B, H, nc, Q, P = x.shape
        return c.launch("K4", k4_cost(B, nc * Q, H, H, P, Bm.shape[-1], Q, x.element_size()),
                        _ssd_chunk, x, dt, A, Bm, Cm)
    return _ssd_chunk(x, dt, A, Bm, Cm)


def _ssd_chunk(x: Tensor, dt: Tensor, A: Tensor, Bm: Tensor, Cm: Tensor):
    dev = _device(x)
    if dev == "cpu":
        return chunk_ref(x, dt, A, Bm, Cm)
    Q = x.shape[3]
    xs, dts, Bs, Cs = chunked_as_seq(x, dt, Bm, Cm)
    if dev == "meta":
        return seq_out_as_chunked(*_k4_outputs(xs, Bs, Q), Q)
    return seq_out_as_chunked(*ssd_chunk_kernel(xs, dts, A, Bs, Cs, chunk=Q), Q)


def _k4_outputs(x: Tensor, Bm: Tensor, Q: int):
    """Empty (Y_intra, S_local, a_tot) as K4 allocates them, fp32 and dense:
    (B, L, H, P), (B, nc, H, N, P), (B, nc, H)."""
    B, L, H, P = x.shape
    N, nc = Bm.shape[-1], -(-L // Q)
    f32, dev = torch.float32, x.device
    return (torch.empty((B, L, H, P), dtype=f32, device=dev),
            torch.empty((B, nc, H, N, P), dtype=f32, device=dev),
            torch.empty((B, nc, H), dtype=f32, device=dev))


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
    backward, on meta their output shapes, on the CPU their plain versions.
    The inputs are saved as they are (x, B and C may be bf16 views of the
    conv output); the backward returns dx, dB and dC in their dtypes, B and
    C's summed per group."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk: int):
        Q = min(chunk, x.shape[1])
        grad = any(ctx.needs_input_grad[:5])
        c = _cost.ACTIVE
        if c is None:
            outs = _k4_forward(x, dt, A, Bm, Cm, Q, grad, False)
        else:
            B, L, H, P = x.shape
            G, N = Bm.shape[-2:]
            outs = c.launch("K4", k4_cost(B, L, H, G, P, N, Q, x.element_size()),
                            _k4_forward, x, dt, A, Bm, Cm, Q, grad, True)
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.chunk = Q
        return outs

    @staticmethod
    def backward(ctx, dY, dS, da):
        x, dt, A, Bm, Cm = ctx.saved_tensors
        args = (x, dt, A, Bm, Cm, dY, dS, da, ctx.chunk)
        c = _cost.ACTIVE
        if c is None:
            grads = _k4_backward(*args, False)
        else:
            B, L, H, P = x.shape
            G, N = Bm.shape[-2:]
            grads = c.launch("K4-bwd", k4_bwd_cost(B, L, H, G, P, N, ctx.chunk, x.element_size()),
                             _k4_backward, *args, True)
        return grads + (None,)


def _k4_forward(x, dt, A, Bm, Cm, Q: int, grad: bool, dense: bool):
    """K4's outputs by the device; ``dense``: the CPU's in K4's layouts."""
    dev = _device(x)
    if dev != "cpu" and grad:
        check_bwd_shape(Q, x.shape[-1], Bm.shape[-1], x.dtype == torch.bfloat16)
    if dev == "cuda":
        return ssd_chunk_kernel(x, dt, A, Bm, Cm, chunk=Q)
    if dev == "meta":
        return _k4_outputs(x, Bm, Q)
    outs = chunk_seq_ref(x, dt, A, Bm, Cm, Q)
    return tuple(o.contiguous() for o in outs) if dense else outs


def _k4_backward(x, dt, A, Bm, Cm, dY, dS, da, chunk: int, dense: bool):
    """K4-bwd's (dx, d(dt), dA, dB, dC) by the device; ``dense``: the CPU's
    in K4-bwd's layouts and dtypes."""
    dev = _device(x)
    if dev == "meta":
        B, L, H, P = x.shape
        G, N = Bm.shape[-2:]
        f32 = torch.float32
        return (torch.empty((B, L, H, P), dtype=x.dtype, device=x.device),
                torch.empty((B, L, H), dtype=f32, device=x.device),
                torch.empty((H,), dtype=f32, device=x.device),
                torch.empty((B, L, G, N), dtype=x.dtype, device=x.device),
                torch.empty((B, L, G, N), dtype=x.dtype, device=x.device))
    bwd = ssd_chunk_bwd_kernel if dev == "cuda" else chunk_bwd_ref
    grads = bwd(x, dt, A, Bm, Cm, dY.contiguous(), dS.contiguous(), da.contiguous(), chunk)
    if dense and dev == "cpu":
        dtypes = (x.dtype, torch.float32, torch.float32, x.dtype, x.dtype)
        grads = tuple(g.to(dt_, memory_format=torch.contiguous_format)
                      for g, dt_ in zip(grads, dtypes))
    return grads


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
