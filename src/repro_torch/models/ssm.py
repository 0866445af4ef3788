"""Mamba2 (SSD — state-space duality) block: chunked prefill forward through
the SSD chunk kernel, and O(1)-state single-token decode.

Chunked SSD (Dao & Gu 2024): for per-step decay a_t = exp(dt_t * A_h) and
input u_t = dt_t * x_t, the state recurrence s_t = a_t s_{t-1} + u_t (x) B_t
is evaluated per chunk of Q steps:
    intra:  Y[t] += sum_{tau<=t} (C_t . B_tau) exp(l_t - l_tau) u_tau
    states: S_c   = sum_tau exp(l_Q - l_tau) u_tau (x) B_tau
    inter:  S_c_prev by the recurrence over chunks
    Y[t]  += C_t . (exp(l_t) * S_prev)
where l_t is the within-chunk cumulative log-decay. All in fp32.

``ssm_block_train`` runs ``kernels.ssd.ops.ssd_forward`` (the Hopper chunk
kernel on CUDA tensors, its plain version on CPU tensors); ``ssd_chunked``
is the JAX package's all-torch form of the same function, kept as a
second reference.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.ssd.ops import ssd_forward
from .common import dense_init, gated_rms_norm
from .sharding import NO_SPLIT, model_split

Tensor = torch.Tensor


def init_ssm_params(gen: torch.Generator, cfg: ModelConfig, dtype) -> Dict[str, Tensor]:
    """Separate projections (w_z/w_x/w_B/w_C/w_dt), as in the JAX package."""
    d, di = cfg.d_model, cfg.d_inner
    g, n, h = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    conv_ch = di + 2 * g * n
    dev = gen.device
    f32 = torch.float32
    # A = -exp(A_log) in [-16, -1]
    a_init = torch.log(torch.linspace(1.0, 16.0, h, dtype=f32, device=dev))
    # dt bias: softplus^-1 of dt0 in [1e-3, 1e-1], log-spaced
    dt0 = torch.exp(torch.linspace(math.log(1e-3), math.log(1e-1), h, dtype=f32, device=dev))
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))
    return {
        "w_z": dense_init(gen, (d, di), dtype),
        "w_x": dense_init(gen, (d, di), dtype),
        "w_B": dense_init(gen, (d, g * n), dtype),
        "w_C": dense_init(gen, (d, g * n), dtype),
        "w_dt": dense_init(gen, (d, h), dtype),
        "conv_w": dense_init(gen, (cfg.ssm_conv, conv_ch), dtype, scale=0.5),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=dev),
        "A_log": a_init,
        "D": torch.ones((h,), dtype=f32, device=dev),
        "dt_bias": dt_bias,
        "norm": torch.zeros((di,), dtype=dtype, device=dev),
        "out_proj": dense_init(gen, (di, d), dtype),
    }


def _project(x: Tensor, p: Dict[str, Tensor], cfg: ModelConfig, split=NO_SPLIT):
    """Returns (z, xbc_preconv, dt_raw) with xbc = concat(x, B, C). Under a
    split over heads, x enters it and so do the replicated ``w_B`` and
    ``w_C`` (every head reads B and C)."""
    x = split.enter(x)
    z = x @ p["w_z"]
    xbc = torch.cat([x @ p["w_x"], x @ split.enter(p["w_B"]), x @ split.enter(p["w_C"])], dim=-1)
    dt_raw = x @ p["w_dt"]
    return z, xbc, dt_raw


def _causal_conv(xbc: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """Depthwise causal conv along seq: xbc (B, L, ch), w (K, ch)."""
    K, L = w.shape[0], xbc.shape[1]
    out = xbc * w[-1]
    for k in range(1, K):
        shifted = F.pad(xbc, (0, 0, k, 0))[:, :L]
        out = out + shifted * w[K - 1 - k]
    return F.silu(out + b)


def ssd_chunked(
    x: Tensor,  # (B, L, H, P) fp32
    dt: Tensor,  # (B, L, H)    fp32 (post-softplus)
    A: Tensor,  # (H,)         fp32 (negative)
    Bm: Tensor,  # (B, L, H, N) fp32
    Cm: Tensor,  # (B, L, H, N) fp32
    chunk: int,
) -> Tuple[Tensor, Tensor]:
    """All-torch chunked SSD from a zero state, the JAX package's
    ``models/ssm.ssd_chunked``: (Y (B,L,H,P), final_state (B,H,P,N))."""
    B_, L, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, L)
    pad = (-L) % Q
    if pad:
        x, Bm, Cm = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (x, Bm, Cm))
        dt = F.pad(dt, (0, 0, 0, pad))
    Lp = L + pad
    nc = Lp // Q

    xc = x.reshape(B_, nc, Q, H, P)
    dtc = dt.reshape(B_, nc, Q, H)
    Bc = Bm.reshape(B_, nc, Q, H, N)
    Cc = Cm.reshape(B_, nc, Q, H, N)

    cum = torch.cumsum(dtc * A, dim=2)  # (B, nc, Q, H) inclusive
    u = xc * dtc[..., None]

    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,Qt,Qtau,H)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    M = torch.where(tri[None, None, :, :, None], torch.exp(diff), torch.zeros((), device=x.device))
    CB = torch.einsum("bcqhn,bckhn->bcqkh", Cc, Bc)
    Y = torch.einsum("bcqkh,bckhp->bcqhp", CB * M, u)

    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)  # (B,nc,Q,H)
    S_local = torch.einsum("bcqhn,bcqhp->bchpn", Bc * decay_to_end[..., None], u)
    a_tot = torch.exp(cum[:, :, -1, :])  # (B, nc, H)

    S_prev = torch.empty_like(S_local)
    state = torch.zeros_like(S_local[:, 0])
    for c in range(nc):
        S_prev[:, c] = state
        state = a_tot[:, c, :, None, None] * state + S_local[:, c]

    Y = Y + torch.einsum("bcqhn,bchpn->bcqhp", Cc * torch.exp(cum)[..., None], S_prev)
    return Y.reshape(B_, Lp, H, P)[:, :L], state


def ssm_block_train(
    x: Tensor,  # (B, L, d_model)
    p: Dict[str, Tensor],
    cfg: ModelConfig,
    shard=None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Returns (out (B,L,d), final_state (B,H,P,N), final_conv_window).

    Under the sharded step (``shard``) heads split over ``model`` (``w_z``,
    ``w_x``, ``w_dt`` by columns, ``A_log``, ``D``, ``dt_bias`` and
    ``norm`` by heads, ``out_proj`` by rows) run this rank's heads: the
    replicated ``w_B``, ``w_C``, ``conv_w`` and ``conv_b`` enter the split
    block (every head reads B and C, and each rank convolves its own x
    channels, so their gradients are this rank's parts), the gated norm
    takes its mean of squares over every rank's channels, and one psum
    closes the block. The final state and conv window are this rank's
    heads' and channels'."""
    B, L, _ = x.shape
    h, n, g, di = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_groups, cfg.d_inner
    P = cfg.ssm_head_dim
    hl = p["A_log"].shape[0]
    split = model_split(shard) if hl < h else NO_SPLIT
    z, xbc, dt_raw = _project(x, p, cfg, split)
    conv_w, conv_b = split.enter(p["conv_w"]), split.enter(p["conv_b"])
    if hl < h:  # this rank's x channels of the conv, and all of B's and C's
        c0, dl = split.coord * hl * P, hl * P
        conv_w = torch.cat([conv_w[:, c0:c0 + dl], conv_w[:, di:]], dim=-1)
        conv_b = torch.cat([conv_b[c0:c0 + dl], conv_b[di:]], dim=-1)
        di = dl
    xbc = _causal_conv(xbc, conv_w, conv_b)
    # views of xbc in the model's dtype, B and C per group: the chunk kernel
    # reads them in place and widens them to fp32 itself
    xs = xbc[..., :di].reshape(B, L, hl, P)
    Bm = xbc[..., di : di + g * n].reshape(B, L, g, n)
    Cm = xbc[..., di + g * n :].reshape(B, L, g, n)
    Bm, Cm = _local_groups(Bm, h, hl, split.coord), _local_groups(Cm, h, hl, split.coord)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])

    Y, state = ssd_forward(xs, dt, A, Bm, Cm, cfg.ssm_chunk)
    Y = Y + xs * p["D"][None, None, :, None]  # fp32: D is fp32
    y = Y.reshape(B, L, di).to(x.dtype)
    y = gated_rms_norm(y, z, p["norm"], cfg.norm_eps, split)
    out = split.leave(y @ p["out_proj"])
    conv_window = xbc_raw_tail(x, p, cfg)  # last K-1 pre-activation inputs
    return out, state, conv_window


def _local_groups(m: Tensor, h: int, hl: int, coord: int) -> Tensor:
    """B or C (B, L, G, N) for this rank's heads [coord hl, (coord + 1) hl):
    the groups they read, one group per head where they straddle groups."""
    if hl == h:
        return m
    G = m.shape[2]
    hg = h // G
    h0 = coord * hl
    g0, g1 = h0 // hg, (h0 + hl - 1) // hg + 1
    if hl == (g1 - g0) * hg or g1 - g0 == 1:
        return m[:, :, g0:g1]
    per_head = torch.repeat_interleave(m[:, :, g0:g1], hg, dim=2)
    return per_head.narrow(2, h0 - g0 * hg, hl)


def xbc_raw_tail(x: Tensor, p: Dict[str, Tensor], cfg: ModelConfig) -> Tensor:
    """Last (K-1) pre-conv xbc inputs — the decode conv state. Prompts
    shorter than K-1 are left-padded with zeros (the projections are
    bias-free, so zero inputs give zero xbc rows)."""
    K = cfg.ssm_conv
    L = x.shape[1]
    if L < K - 1:
        x = F.pad(x, (0, 0, K - 1 - L, 0))
    _, xbc, _ = _project(x[:, -(K - 1):], p, cfg)
    return xbc  # (B, K-1, conv_ch)


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype, device) -> Dict[str, Tensor]:
    h, n = cfg.ssm_heads, cfg.ssm_state
    P = cfg.ssm_head_dim
    conv_ch = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return {
        "state": torch.zeros((batch, h, P, n), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_ch), dtype=dtype, device=device),
    }


def full_conv_window(conv: Tensor, cfg: ModelConfig, split=NO_SPLIT) -> Tensor:
    """A conv window (B, K-1, ch) whole over ``model``: under a split of the
    heads a rank computes only its own x channels (``w_x`` by columns), so
    their block is gathered over ``model`` (B and C are every rank's);
    without one, the window as it is."""
    bc = 2 * cfg.ssm_groups * cfg.ssm_state
    dl = conv.shape[-1] - bc
    if dl == cfg.d_inner:
        return conv
    return torch.cat([split.gather(conv[..., :dl], -1), conv[..., dl:]], dim=-1)


def ssm_block_decode(
    x: Tensor,  # (B, 1, d_model)
    cache: Dict[str, Tensor],
    p: Dict[str, Tensor],
    cfg: ModelConfig,
    shard=None,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One-token step. The state and the conv window are updated IN PLACE
    in ``cache`` (the JAX package returns new arrays); the same dict comes
    back.

    Under the serving step (``shard``) heads split over ``model`` run this
    rank's heads: the state is this rank's heads' (``P(b, model, None,
    None)``); the conv window is whole on every rank, as JAX's spec keeps
    it (``P(b, None, None)``), so the new column's x channels, which each
    rank computes for its own heads, are gathered over ``model`` before
    the window moves, and each rank convolves its own x channels and all
    of B's and C's. The gated norm's mean of squares is summed over
    ``model`` and one psum closes ``out_proj``'s rows, as in prefill."""
    B = x.shape[0]
    h, n, g, di = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_groups, cfg.d_inner
    P = cfg.ssm_head_dim
    hl = p["A_log"].shape[0]
    split = model_split(shard) if hl < h else NO_SPLIT

    z, xbc_t, dt_raw = _project(x[:, 0], p, cfg, split)
    xbc_t = full_conv_window(xbc_t, cfg, split)
    window = torch.cat([cache["conv"], xbc_t[:, None]], dim=1)  # (B, K, ch)
    conv_w, conv_b, win = p["conv_w"], p["conv_b"], window
    if hl < h:  # this rank's x channels of the conv, and all of B's and C's
        c0, dl = split.coord * hl * P, hl * P
        conv_w = torch.cat([conv_w[:, c0:c0 + dl], conv_w[:, di:]], dim=-1)
        conv_b = torch.cat([conv_b[c0:c0 + dl], conv_b[di:]], dim=-1)
        win = torch.cat([window[..., c0:c0 + dl], window[..., di:]], dim=-1)
        di = dl
    conv_out = torch.einsum("bkc,kc->bc", win, conv_w) + conv_b
    xbc = F.silu(conv_out)

    xs = xbc[..., :di].float().reshape(B, hl, P)
    Bm = xbc[..., di : di + g * n].float().reshape(B, 1, g, n)
    Cm = xbc[..., di + g * n :].float().reshape(B, 1, g, n)
    Bm = _local_groups(Bm, h, hl, split.coord)[:, 0]
    Cm = _local_groups(Cm, h, hl, split.coord)[:, 0]
    if Bm.shape[1] != hl:
        Bm = torch.repeat_interleave(Bm, hl // Bm.shape[1], dim=1)
        Cm = torch.repeat_interleave(Cm, hl // Cm.shape[1], dim=1)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])  # (B, hl)
    A = -torch.exp(p["A_log"])
    a = torch.exp(dt * A)  # (B, hl)

    u = xs * dt[..., None]  # (B, hl, P)
    s = cache["state"]
    s.mul_(a[..., None, None]).add_(torch.einsum("bhp,bhn->bhpn", u, Bm))
    y = torch.einsum("bhn,bhpn->bhp", Cm, s) + xs * p["D"][None, :, None]
    y = y.reshape(B, 1, di).to(x.dtype)
    y = gated_rms_norm(y, z[:, None], p["norm"], cfg.norm_eps, split)
    cache["conv"].copy_(window[:, 1:])
    return split.leave(y @ p["out_proj"]), cache
