"""Local SDCA (paper Algorithm 2) — naive, block-Gram and full-Gram forms.

Every function acts on ALL tasks at once: the task axis is an explicit
leading dimension m (the JAX package vmaps one-task functions instead).
Given the current dual blocks ``alpha`` (m, n_max) and weight rows ``w``
(m, d), they produce the approximate subproblem solutions ``dalpha`` and
the un-normalized update directions ``r = X_i^T dalpha_i`` (so that
``delta_b_i = eta * r_i / n_i``).

naive      : literal Algorithm 2 — one coordinate per step, each step does a
             d-dim inner product + axpy. Reference semantics.
block_gram : H steps are processed in blocks of B sampled coordinates: the
             d-dim work becomes three batched matmuls per block
             (q = X_blk w, G = X_blk X_blk^T, r += X_blk^T delta) and the
             sequential part runs on the B x B Gram block only. Same iterate
             sequence as naive for the same sampled coordinate order
             (duplicates within a block included), because inner products
             are corrected incrementally through G.

Updates of ``dalpha`` go through ``scatter_add_``, so a coordinate drawn
twice accumulates both deltas (``dalpha[idx] += v`` would keep only one).

Engines do not call these functions directly: they resolve a named backend
through ``repro_torch.core.solver_backends``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .. import prng
from .losses import Loss

Tensor = torch.Tensor


def sample_coords(key: Tensor, H: int, n_i: Tensor, n_max: int) -> Tensor:
    """H coordinate indices uniform in [0, n_i) (paper: with replacement).

    ``key`` (..., 2) and ``n_i`` (...) carry the same leading task shape;
    returns int64 (..., H) on ``n_i``'s device. A task with no samples
    draws row ``n_max - 1`` (see ``coords_from_uniform``)."""
    return coords_from_uniform(prng.uniform(key, (H,), device=n_i.device), n_i, n_max)


def coords_from_uniform(u: Tensor, n_i: Tensor, n_max: int) -> Tensor:
    """min(int(u * n_i), n_i - 1) with the product rounded in float32 (the
    mapping every backend and both kernels share, so draws are bit-equal).
    u (..., H), n_i (...) -> int64 (..., H) in [0, n_max).

    A task with n_i = 0 (a padded task, or a pod slice past the task's
    samples) gets -1, which wraps to row n_max - 1 of its own block: the
    JAX package's gathers and scatters normalize a negative index so, and
    the round kernel applies the same rule on the device."""
    n = n_i.to(torch.int32).unsqueeze(-1)
    j = torch.minimum((u * n.to(u.dtype)).to(torch.int32), n - 1).long()
    return torch.where(j < 0, j + n_max, j)


def kappa_of(rho: float, lam: float, n_i: Tensor, sigma_ii: Tensor) -> Tensor:
    """kappa = rho * sigma_ii / (lambda * max(n_i, 1)), per task, float32."""
    nf = torch.clamp(n_i.to(sigma_ii.dtype), min=1.0)
    return rho * sigma_ii / (lam * nf)


def _take(a: Tensor, idx: Tensor) -> Tensor:
    """a[t, idx[t, ...]] per task t: (m, n) x (m, k) -> (m, k)."""
    return torch.gather(a, 1, idx)


def gather_rows(x: Tensor, idx: Tensor) -> Tensor:
    """x[t, idx[t, k], :] per task: (m, n_max, d) x (m, B) -> (m, B, d)."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def naive_steps(
    x: Tensor,  # (m, n_max, d)
    y: Tensor,  # (m, n_max)
    alpha: Tensor,  # (m, n_max)
    w: Tensor,  # (m, d)
    kappa: Tensor,  # (m,)
    coords: Tensor,  # (m, H) int64
    loss: Loss,
) -> Tuple[Tensor, Tensor]:
    """The H coordinate steps of Algorithm 2, each with its own d-dim inner
    products and axpy. Returns (dalpha, r)."""
    dalpha = torch.zeros_like(alpha)
    r = torch.zeros_like(w)
    for h in range(coords.shape[1]):
        j = coords[:, h : h + 1]  # (m, 1)
        xj = gather_rows(x, j)[:, 0]  # (m, d)
        c = (xj * w).sum(-1) + kappa * (xj * r).sum(-1)
        a = kappa * (xj * xj).sum(-1)
        atilde = (_take(alpha, j) + _take(dalpha, j))[:, 0]
        delta = loss.sdca_delta(atilde, c, a, _take(y, j)[:, 0])
        dalpha.scatter_add_(1, j, delta[:, None])
        r = r + delta[:, None] * xj
    return dalpha, r


def local_sdca_naive(
    x: Tensor,
    y: Tensor,
    alpha: Tensor,
    w: Tensor,
    n_i: Tensor,  # (m,) int
    sigma_ii: Tensor,  # (m,)
    coords: Tensor,  # (m, H) int64
    rho: float,
    lam: float,
    loss: Loss,
) -> Tuple[Tensor, Tensor]:
    """Algorithm 2, one coordinate at a time. Returns (dalpha, r)."""
    kappa = kappa_of(rho, lam, n_i, sigma_ii)
    return naive_steps(x, y, alpha, w, kappa, coords, loss)


def sdca_block_solve(
    G: Tensor,  # (m, B, B) Gram of this block's rows
    q: Tensor,  # (m, B)   X_blk @ w
    xr: Tensor,  # (m, B)   X_blk @ r_prev
    dalpha: Tensor,  # (m, n_max), updated in place
    alpha: Tensor,
    y: Tensor,
    cb: Tensor,  # (m, B) coords of this block
    kappa: Tensor,  # (m,)
    loss: Loss,
) -> Tuple[Tensor, Tensor]:
    """The scalar recursion for ONE block on its Gram matrix.
    Returns (dalpha, deltas)."""
    B = cb.shape[1]
    deltas = torch.zeros_like(q)
    for k in range(B):
        j = cb[:, k : k + 1]
        corr = (G[:, k] * deltas).sum(-1)  # deltas[k:] are still 0
        c = q[:, k] + kappa * (xr[:, k] + corr)
        a = kappa * G[:, k, k]
        atilde = (_take(alpha, j) + _take(dalpha, j))[:, 0]
        delta = loss.sdca_delta(atilde, c, a, _take(y, j)[:, 0])
        dalpha.scatter_add_(1, j, delta[:, None])
        deltas[:, k] = delta
    return dalpha, deltas


def local_sdca_block(
    x: Tensor,
    y: Tensor,
    alpha: Tensor,
    w: Tensor,
    n_i: Tensor,
    sigma_ii: Tensor,
    coords: Tensor,  # (m, H); H must be a multiple of block
    rho: float,
    lam: float,
    loss: Loss,
    block: int = 64,
) -> Tuple[Tensor, Tensor]:
    """Block-Gram Local SDCA. Same iterates as naive, in batched matmuls."""
    H = coords.shape[1]
    if H % block:
        raise ValueError(f"H={H} must be a multiple of block={block}")
    kappa = kappa_of(rho, lam, n_i, sigma_ii)
    dalpha = torch.zeros_like(alpha)
    r = torch.zeros_like(w)
    for b in range(H // block):
        cb = coords[:, b * block : (b + 1) * block]
        xb = gather_rows(x, cb)  # (m, B, d)
        q = torch.bmm(xb, w[:, :, None])[..., 0]
        xr = torch.bmm(xb, r[:, :, None])[..., 0]
        G = torch.bmm(xb, xb.transpose(1, 2))
        dalpha, deltas = sdca_block_solve(G, q, xr, dalpha, alpha, y, cb, kappa, loss)
        r = r + torch.bmm(xb.transpose(1, 2), deltas[:, :, None])[..., 0]
    return dalpha, r


def sdca_gram_solve(
    G: Tensor,  # (m, H, H) full Gram of sampled rows
    q: Tensor,  # (m, H)    X_H @ w
    alpha: Tensor,
    y: Tensor,
    coords: Tensor,
    n_i: Tensor,
    sigma_ii: Tensor,
    rho: float,
    lam: float,
    loss: Loss,
) -> Tuple[Tensor, Tensor]:
    """The scalar recursion of full-Gram SDCA over all H draws.

    Returns (dalpha, deltas); r = X_H^T deltas is computed by the caller."""
    kappa = kappa_of(rho, lam, n_i, sigma_ii)
    dalpha = torch.zeros_like(alpha)
    return sdca_block_solve(
        G, q, torch.zeros_like(q), dalpha, alpha, y, coords, kappa, loss
    )


def local_sdca_gram(
    x: Tensor,
    y: Tensor,
    alpha: Tensor,
    w: Tensor,
    n_i: Tensor,
    sigma_ii: Tensor,
    coords: Tensor,  # (m, H)
    rho: float,
    lam: float,
    loss: Loss,
) -> Tuple[Tensor, Tensor]:
    """Full-Gram Local SDCA: same iterate sequence as naive/block, with ALL
    d-contractions hoisted out of the sequential loop:

        q = X_H @ w,  G = X_H X_H^T     (two batched matmuls)
        H scalar steps on the H x H Gram
        r = X_H^T deltas
    """
    Xs = gather_rows(x, coords)  # (m, H, d)
    q = torch.bmm(Xs, w[:, :, None])[..., 0]
    G = torch.bmm(Xs, Xs.transpose(1, 2))
    dalpha, deltas = sdca_gram_solve(
        G, q, alpha, y, coords, n_i, sigma_ii, rho, lam, loss
    )
    r = torch.bmm(Xs.transpose(1, 2), deltas[:, :, None])[..., 0]
    return dalpha, r
