"""Dual/primal objectives, the primal-dual map W(alpha), and the duality gap.

Notation (paper Thm. 1):
    b_i        = (1/n_i) X_i^T alpha_[i]                      (d,)
    B          = [b_1 ... b_m]                                (d, m)
    w_i(alpha) = (1/lambda) sum_i' b_i' sigma_ii'  =>  W = (1/lambda) B Sigma
    alpha^T K alpha = tr(Sigma B^T B)
    D(alpha) = -(1/2 lambda) tr(Sigma B^T B) - sum_i (1/n_i) sum_j l*(-alpha_j^i)
    P(W)     = sum_i (1/n_i) sum_j l(w_i^T x_j^i) + (lambda/2) tr(W Omega W^T)

For W = W(alpha) the regularizer simplifies:
    tr(W Omega W^T) = (1/lambda^2) tr(Sigma B^T B)     (since Sigma Omega Sigma = Sigma)
so the duality gap never needs Omega explicitly.
"""
from __future__ import annotations

import torch

from .losses import Loss
from .mtl_data import MTLData
from .sigma_view import SigmaView

Tensor = torch.Tensor


def row_divisor(data: MTLData, dtype: torch.dtype) -> Tensor:
    """Each task's n_i, at least 1 (an empty task adds 0), as (m, 1) ``dtype``."""
    return torch.clamp(data.n, min=1)[:, None].to(dtype)


def compute_B(data: MTLData, alpha: Tensor) -> Tensor:
    """B matrix, columns b_i = (1/n_i) X_i^T alpha_[i].  alpha: (m, n_max)."""
    masked = alpha * data.mask  # safety: padding contributes nothing
    b = torch.einsum("mnd,mn->md", data.x, masked) / row_divisor(data, data.x.dtype)
    return b.T  # (d, m)


def weights_from_alpha(data: MTLData, alpha: Tensor, sigma, lam: float) -> Tensor:
    """W(alpha) = (1/lambda) B Sigma, returned as (m, d) rows = tasks.
    ``sigma`` may be a dense (m, m) tensor or a SigmaView."""
    B = compute_B(data, alpha)  # (d, m)
    if isinstance(sigma, SigmaView):
        return sigma.matvec(B.T) / lam  # Sigma symmetric: (B Sigma)^T = Sigma B^T
    return (B @ sigma).T / lam  # (m, d)


def quad_term(data: MTLData, alpha: Tensor, sigma) -> Tensor:
    """alpha^T K alpha = tr(Sigma B^T B)."""
    B = compute_B(data, alpha)
    if isinstance(sigma, SigmaView):
        Bt = B.T  # (m, d)
        return torch.sum(Bt * sigma.matvec(Bt))
    return torch.einsum("ij,ji->", sigma, B.T @ B)


def dual_objective(
    data: MTLData, alpha: Tensor, sigma, lam: float, loss: Loss
) -> Tensor:
    """D(alpha) of Eq. (2)."""
    quad = quad_term(data, alpha, sigma)
    conj = loss.conjugate(-alpha, data.y) * data.mask
    conj_term = torch.sum(conj / row_divisor(data, conj.dtype))
    return -quad / (2.0 * lam) - conj_term


def _empirical_risk(data: MTLData, W: Tensor, loss: Loss) -> Tensor:
    z = predictions(data, W)
    return torch.sum(loss.value(z, data.y) * data.mask / row_divisor(data, z.dtype))


def primal_objective(
    data: MTLData, W: Tensor, omega: Tensor, lam: float, loss: Loss
) -> Tensor:
    """P(W) of Eq. (1) with explicit Omega (precision matrix). W: (m, d)."""
    reg = 0.5 * lam * torch.einsum("id,ij,jd->", W, omega, W)
    return _empirical_risk(data, W, loss) + reg


def primal_objective_from_alpha(
    data: MTLData, alpha: Tensor, sigma, lam: float, loss: Loss
) -> Tensor:
    """P(W(alpha)) using tr(W Omega W^T) = tr(Sigma B^T B)/lambda^2."""
    W = weights_from_alpha(data, alpha, sigma, lam)
    reg = quad_term(data, alpha, sigma) / (2.0 * lam)
    return _empirical_risk(data, W, loss) + reg


def duality_gap(
    data: MTLData, alpha: Tensor, sigma, lam: float, loss: Loss
) -> Tensor:
    """G(alpha) = P(W(alpha)) - D(alpha) >= 0 (weak duality)."""
    return primal_objective_from_alpha(data, alpha, sigma, lam, loss) - dual_objective(
        data, alpha, sigma, lam, loss
    )


def local_subproblem_objective(
    data: MTLData,
    i: int,
    dalpha_i: Tensor,
    alpha: Tensor,
    w_i: Tensor,
    sigma_ii,
    rho: float,
    lam: float,
    loss: Loss,
    m: int,
) -> Tensor:
    """D_i^rho of Eq. (4) for one task, without its constant term (used in
    tests and the Theta measurement):

    D_i^rho = -(1/n_i) sum_j l*(-(alpha_j + dalpha_j))
              -(1/n_i) sum_j dalpha_j w_i^T x_j
              -(rho/(2 lam)) dalpha^T K_[ii] dalpha
    with K_[ii] = (sigma_ii/n_i^2) X_i X_i^T. The constant
    -(1/(2 lam m)) alpha^T K alpha does not move the argmax;
    ``local_subproblem_objective_full`` adds it. ``m`` is kept for the
    JAX package's signature."""
    xi, yi, mi = data.x[i], data.y[i], data.mask[i]
    ni = data.n[i].to(xi.dtype)
    conj = loss.conjugate(-(alpha[i] + dalpha_i), yi) * mi
    t1 = -torch.sum(conj) / ni
    t2 = -torch.sum(dalpha_i * (xi @ w_i) * mi) / ni
    r = xi.T @ (dalpha_i * mi)
    t3 = -(rho * sigma_ii / (2.0 * lam * ni**2)) * torch.sum(r * r)
    return t1 + t2 + t3


def local_subproblem_objective_full(
    data: MTLData,
    i: int,
    dalpha_i: Tensor,
    alpha: Tensor,
    w_i: Tensor,
    sigma: Tensor,
    rho: float,
    lam: float,
    loss: Loss,
) -> Tensor:
    """D_i^rho including the constant -(1/(2 lam m)) alpha^T K alpha term."""
    base = local_subproblem_objective(
        data, i, dalpha_i, alpha, w_i, sigma[i, i], rho, lam, loss, data.m
    )
    const = -quad_term(data, alpha, sigma) / (2.0 * lam * data.m)
    return base + const


def predictions(data: MTLData, W: Tensor) -> Tensor:
    """z_j^i = w_i^T x_j^i, (m, n_max)."""
    return torch.einsum("mnd,md->mn", data.x, W)


def task_scores(W: Tensor, X: Tensor, tasks: Tensor) -> Tensor:
    """Per-row scores z_n = w_{tasks[n]}^T x_n for flat request batches:
    W (m, d), X (n, d), tasks (n,) int -> (n,)."""
    return torch.einsum("nd,nd->n", X, W[tasks])


def error_rate(data: MTLData, W: Tensor) -> Tensor:
    """Masked averaged-over-tasks classification error (paper's metric)."""
    z = predictions(data, W)
    wrong = (torch.sign(z) != torch.sign(data.y)).to(torch.float32) * data.mask
    per_task = torch.sum(wrong, dim=1) / torch.clamp(torch.sum(data.mask, dim=1), min=1.0)
    return torch.mean(per_task)


def rmse(data: MTLData, W: Tensor) -> Tensor:
    """Masked global RMSE over all test points (School metric)."""
    z = predictions(data, W)
    se = (z - data.y) ** 2 * data.mask
    return torch.sqrt(torch.sum(se) / torch.clamp(torch.sum(data.mask), min=1.0))


def explained_variance(data: MTLData, W: Tensor) -> Tensor:
    """Explained variance as in Argyriou et al. (School): 1 - SSE/Var(y)."""
    z = predictions(data, W)
    msk = data.mask
    tot = torch.clamp(torch.sum(msk), min=1.0)
    ybar = torch.sum(data.y * msk) / tot
    sse = torch.sum((z - data.y) ** 2 * msk)
    svar = torch.sum((data.y - ybar) ** 2 * msk)
    return 1.0 - sse / torch.clamp(svar, min=1e-12)
