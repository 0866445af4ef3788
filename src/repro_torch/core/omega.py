"""Omega-step: closed-form update of the task precision matrix.

Zhang & Yeung (2010) show that with W fixed, the minimizer of
    tr(W Omega W^T)  s.t.  Omega^{-1} >= 0, tr(Omega^{-1}) = 1
is
    Sigma = Omega^{-1} = (W^T W)^{1/2} / tr((W^T W)^{1/2}).

We compute it via the m x m eigendecomposition. A jitter keeps Sigma
invertible when W is rank-deficient (e.g. the very first alternation where
W may be near 0); trace is renormalized to 1 so the constraint still holds
exactly. The eigenvectors' signs are arbitrary, but Sigma = V diag V^T is
not: compare Sigma and Omega, never the eigenvectors.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .. import prng

Tensor = torch.Tensor


def omega_step(W: Tensor, jitter: float = 1e-6) -> Tuple[Tensor, Tensor]:
    """W: (m, d) rows = task weight vectors. Returns (sigma, omega).

    sigma = Omega^{-1} (covariance), omega = precision; both (m, m),
    symmetric PD, tr(sigma) == 1.
    """
    m = W.shape[0]
    M = W @ W.T  # (m, m) = W^T W in the paper's (d, m) column convention
    M = 0.5 * (M + M.T)
    evals, evecs = torch.linalg.eigh(M)
    s = torch.sqrt(torch.clamp(evals, min=0.0))
    tr = torch.sum(s)
    # degenerate W (all zeros) -> fall back to Sigma = I/m (the init).
    safe = tr > 1e-30
    s_n = torch.where(safe, s / torch.clamp(tr, min=1e-30), torch.ones_like(s) / m)
    s_n = s_n + jitter
    s_n = s_n / torch.sum(s_n)  # renormalize trace to exactly 1
    sigma = (evecs * s_n) @ evecs.T
    omega = (evecs * (1.0 / s_n)) @ evecs.T
    sigma = 0.5 * (sigma + sigma.T)
    omega = 0.5 * (omega + omega.T)
    return sigma, omega


def omega_step_lowrank(
    W: Tensor, rank: int, iters: int = 8, jitter: float = 1e-6
) -> Tuple[Tensor, Tensor, Tensor]:
    """Rank-r Zhang-Yeung Omega-step without ever forming M = W W^T.

    Subspace iteration with W-matvecs only (V <- W (W^T V), QR) followed by
    Rayleigh-Ritz on the r-dimensional subspace gives the top-r eigenpairs
    of M; sqrt of the Ritz values are the leading singular values of the
    paper's (W^T W)^{1/2}. The trailing spectral mass is folded into a
    per-task residual diagonal d_i = sqrt(max(M_ii - sum_k lam_k U_ik^2, 0))
    so the trace constraint still holds exactly after normalization.

    The start block is the JAX package's, ``normal(PRNGKey(17), (m, r))``
    (to float32 rounding). QR column signs and Ritz vectors inside
    near-equal eigenvalues may differ from JAX's, but Sigma = U diag(s)
    U^T + diag(d) does not: compare Sigma, never U.

    Cost: O(m d r) per iteration + an r x r eigh — no m x m anything.
    Exact at r >= rank(M) (in particular r = m), where it reproduces
    ``omega_step``'s Sigma.

    Returns ``(U, s, d)`` with U (m, r) orthonormal, s (r,) >= 0 Ritz-sqrt
    weights and d (m,) > 0: Sigma = U diag(s) U^T + diag(d), tr == 1.
    """
    m = W.shape[0]
    r = min(rank, m)
    V = prng.normal(prng.PRNGKey(17), (m, r), device=W.device).to(W.dtype)
    V, _ = torch.linalg.qr(V)
    for _ in range(iters):
        V, _ = torch.linalg.qr(W @ (W.T @ V))
    T = V.T @ (W @ (W.T @ V))
    evals, S = torch.linalg.eigh(0.5 * (T + T.T))
    U = V @ S
    lam = torch.clamp(evals, min=0.0)
    s = torch.sqrt(lam)
    # residual diagonal: spectral mass M_ii not captured by the subspace
    M_diag = torch.sum(W * W, dim=1)
    captured = torch.sum((U * U) * lam[None, :], dim=1)
    d_raw = torch.sqrt(torch.clamp(M_diag - captured, min=0.0))
    tr = torch.sum(s) + torch.sum(d_raw)
    safe = tr > 1e-30
    s_n = torch.where(safe, s / torch.clamp(tr, min=1e-30), torch.zeros_like(s))
    d_n = torch.where(
        safe, d_raw / torch.clamp(tr, min=1e-30), torch.ones_like(d_raw) / m
    )
    d_n = d_n + jitter
    renorm = torch.sum(s_n) + torch.sum(d_n)
    return U, s_n / renorm, d_n / renorm


def init_sigma(
    m: int, dtype: torch.dtype = torch.float32, device=None
) -> Tuple[Tensor, Tensor]:
    """Paper's Algorithm 1 init: Omega = m I, Sigma = I/m."""
    eye = torch.eye(m, dtype=dtype, device=device)
    return eye / m, eye * m


def correlation_from_sigma(sigma: Tensor) -> Tensor:
    """Task correlation matrix from the covariance Sigma (for Fig. 2)."""
    dd = torch.sqrt(torch.clamp(torch.diagonal(sigma), min=1e-30))
    return sigma / (dd[:, None] * dd[None, :])


def rho_lemma10(sigma: Tensor, eta: float = 1.0) -> Tensor:
    """Paper Lemma 10 upper bound: eta * max_i sum_i' |sigma_ii'| / sigma_ii.

    This is what the paper's experiments use for rho (Section 7.1).
    """
    dd = torch.clamp(torch.diagonal(sigma), min=1e-30)
    return eta * torch.max(torch.sum(torch.abs(sigma), dim=1) / dd)


def rho_spectral(sigma: Tensor, eta: float = 1.0) -> Tensor:
    """Tighter bound: eta * lambda_max(D^{-1/2} Sigma D^{-1/2}), D = diag(Sigma).

    Always <= Lemma 10's bound; still an upper bound on rho_min of Eq. (5).
    """
    S = correlation_from_sigma(sigma)
    ev = torch.linalg.eigvalsh(0.5 * (S + S.T))
    return eta * ev[-1]
