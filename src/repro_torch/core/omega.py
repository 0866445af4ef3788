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
