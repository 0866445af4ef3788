"""Convergence-theory quantities (paper Section 6).

These are *measurable* implementations of the theorem quantities so the
theory can be checked against observed behaviour:

 * Theta (Assumption 1): observed local-subproblem approximation quality.
 * H bounds: Thm 4 (smooth) and Thm 5 (Lipschitz) lower bounds on local
   SDCA iterations for a target Theta.
 * T bounds: Thm 8 (smooth, linear rate) / Thm 9 (Lipschitz, O(1/T)).
 * rho_min estimation by power iteration on the generalized Rayleigh
   quotient of Eq. (5) (exact up to iteration tolerance, vs the Lemma 10
   closed-form upper bound).
 * the staleness summaries of the transports' event histories.

Tensor inputs may live on any device; the results are Python floats or
numpy arrays.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from .. import prng
from . import dual as dual_mod
from .losses import get_loss
from .mtl_data import MTLData

Tensor = torch.Tensor


def q_max(data: MTLData) -> float:
    """max_j ||phi(x_j)||^2 over real (unmasked) samples."""
    sq = torch.sum(data.x**2, dim=-1) * data.mask
    return float(torch.max(sq))


def h_bound_smooth(
    theta: float, rho: float, sigma_ii: float, qmax: float, mu: float, lam: float, n_i: int
) -> float:
    """Theorem 4: H >= log(1/Theta) (rho sigma_ii q_max + mu lam n_i)/(mu lam)."""
    return math.log(1.0 / theta) * (rho * sigma_ii * qmax + mu * lam * n_i) / (mu * lam)


def t_bound_smooth(
    eps_d: float,
    eta: float,
    theta: float,
    lam: float,
    mu: float,
    rho: float,
    n_star: int,
    pi_star: float,
    m: int,
) -> float:
    """Theorem 8 dual-suboptimality bound on communication rounds."""
    k = (lam * mu + rho * n_star * pi_star) / (lam * mu)
    return k / (eta * (1.0 - theta)) * math.log(m / eps_d)


def t_bound_lipschitz(
    eps_g: float, eta: float, theta: float, lam: float, rho: float, L: float, pi_sum: float, m: int
) -> float:
    """Theorem 9 (leading term): T >= T0 + max(ceil(1/(eta(1-Theta))),
    4 L^2 pi rho / (lam eps_G eta (1-Theta)))."""
    lead = 4.0 * L**2 * pi_sum * rho / (lam * eps_g * eta * (1.0 - theta))
    t0 = max(
        0.0,
        math.ceil(1.0 / (eta * (1.0 - theta)) * math.log(max(2.0 * lam * m / max(4.0 * L**2 * pi_sum * rho, 1e-30), 1.0))),
    )
    T0 = t0 + max(0.0, 2.0 / (eta * (1.0 - theta)) * (8.0 * L**2 * pi_sum * rho / (lam * eps_g) - 1.0))
    return T0 + max(math.ceil(1.0 / (eta * (1.0 - theta))), lead)


def pi_i(data: MTLData, sigma_ii: Tensor) -> Tensor:
    """pi_i = max_alpha (alpha^T K_[ii] alpha)/||alpha||^2
            = (sigma_ii/n_i^2) ||X_i||_2^2 (spectral norm squared of rows).

    Lemma 7 bounds it by sigma_ii / n_i for normalized features; this is
    the exact value per task from each task's (masked) data block. (m,)."""
    xm = data.x * data.mask[..., None]
    s = torch.linalg.matrix_norm(xm, ord=2)  # largest singular value per task
    nf = torch.clamp(data.n.to(data.x.dtype), min=1.0)
    return sigma_ii * s**2 / nf**2


def rho_min_power_iteration(
    data: MTLData, sigma: Tensor, eta: float = 1.0, iters: int = 50, seed: int = 0
) -> float:
    """Estimate rho_min of Eq. (5) by power iteration on the generalized
    eigenproblem  K alpha = nu * Kblock alpha  restricted to range(Kblock).

    In b-space, with b_i = (1/n_i) X_i^T alpha_[i],
        alpha^T K alpha        = sum_{ii'} sigma_ii' b_i . b_i'
        sum_i alpha^T Kblk alpha = sum_i sigma_ii ||b_i||^2.
    The sup over alpha equals the sup over b in the product of task column
    spaces: projected power iteration in b-space, the projection onto each
    task's column space through an orthonormal basis of its data. QR's
    column signs are the library's own, but the projector Q Q^T does not
    depend on them, nor does the value returned.
    """
    m, d = data.m, data.d
    dd = torch.sqrt(torch.clamp(torch.diagonal(sigma), min=1e-30))

    # orthonormal bases of each task's column space (masked rows): (m, d, k)
    xm = data.x * data.mask[..., None]
    Q, R = torch.linalg.qr(xm.transpose(1, 2), mode="reduced")
    keep = (torch.abs(torch.diagonal(R, dim1=1, dim2=2)) > 1e-7).to(data.x.dtype)
    Q = Q * keep[:, None, :]

    def project(b):  # (m, d) -> (m, d), task-wise projection onto col spaces
        return torch.einsum("mdk,mk->md", Q, torch.einsum("mdk,md->mk", Q, b))

    b = prng.normal(prng.PRNGKey(seed), (m, d), device=data.x.device)
    b = project(b)

    # generalized power iteration: maximize (b^T S b)/(b^T D b) with
    # S = sigma (x) I on task blocks, D = diag(sigma_ii) (x) I
    val = 0.0
    for _ in range(iters):
        # whitened operator: A = D^{-1/2} S D^{-1/2}, then project
        num = sigma @ b
        b_new = project(num / (dd**2)[:, None])
        nrm = torch.sqrt(torch.sum((b_new * dd[:, None]) ** 2))
        b = b_new / torch.clamp(nrm, min=1e-30)
        num_v = torch.einsum("id,ij,jd->", b, sigma, b)
        den_v = torch.sum((b * dd[:, None]) ** 2)
        val = num_v / torch.clamp(den_v, min=1e-30)
    return float(eta * val)


def staleness_summary(history: Dict[str, np.ndarray]) -> Dict[str, object]:
    """Summarize per-commit staleness events (``w_*`` keys).

    The single sink of the ``transport.CommitReceipt`` accounting path:
    every transport member records through ``transport.record_receipt``
    into the same history keys.

    Gossip histories additionally carry per-EDGE staleness events
    (``e_src/e_dst/e_stal/e_tick``: at each neighbor exchange, how many
    completed rounds the two endpoints disagreed by); when present the
    summary gains ``n_exchanges`` / ``max_edge_staleness`` /
    ``mean_edge_staleness`` / ``per_edge_mean`` keyed by ``(src, dst)``.

    Staleness of a contribution = server commits between its snapshot and
    its application; lag = rounds it ran ahead of the slowest worker. Under
    tau=0 with homogeneous delays both are 0 for every commit (the bulk-
    synchronous anchor). With heterogeneous delays, tau=0 still barriers
    round *starts* but a fast worker's commit can land between a slow
    worker's snapshot and its apply, so staleness up to G-1 is expected
    even at tau=0; lag stays 0.
    """
    stal = np.asarray(history.get("w_staleness", []), np.float64)
    lag = np.asarray(history.get("w_lag", []), np.float64)
    workers = np.asarray(history.get("w_worker", []), np.int64)
    if stal.size == 0:
        return {"n_commits": 0, "max_staleness": 0.0, "mean_staleness": 0.0,
                "p95_staleness": 0.0, "max_lag": 0.0, "per_worker_mean": {}}
    per_worker = {
        int(g): float(stal[workers == g].mean()) for g in np.unique(workers)
    }
    out = {
        "n_commits": int(stal.size),
        "max_staleness": float(stal.max()),
        "mean_staleness": float(stal.mean()),
        "p95_staleness": float(np.percentile(stal, 95)),
        "max_lag": float(lag.max()),
        "per_worker_mean": per_worker,
    }
    e_stal = np.asarray(history.get("e_stal", []), np.float64)
    if e_stal.size:
        e_src = np.asarray(history["e_src"], np.int64)
        e_dst = np.asarray(history["e_dst"], np.int64)
        edges = np.stack([e_src, e_dst], axis=1)
        per_edge = {
            (int(s), int(d)): float(e_stal[(e_src == s) & (e_dst == d)].mean())
            for s, d in np.unique(edges, axis=0)
        }
        out.update(
            n_exchanges=int(e_stal.size),
            max_edge_staleness=float(e_stal.max()),
            mean_edge_staleness=float(e_stal.mean()),
            per_edge_mean=per_edge,
        )
    return out


def effective_gap_curve(
    history: Dict[str, np.ndarray]
) -> Tuple[np.ndarray, np.ndarray]:
    """Duality gap against the *transport clock*, not rounds.

    The x-axis is the tick of each objective sample: wall seconds for the
    host transports, the round index for synchronous histories; a history
    without ticks falls back to round numbering. The gaps are NOT made
    monotone (stale commits can make them oscillate): use ``ticks_to_gap``'s
    first-crossing scan rather than a binary search.
    """
    gaps = np.asarray(history["gap"], np.float64)
    if "tick" in history and len(history["tick"]):
        ticks = np.asarray(history["tick"], np.float64)
    else:
        ticks = np.arange(1, gaps.size + 1, dtype=np.float64)
    return ticks, gaps


def sync_effective_ticks(history: Dict[str, np.ndarray], delays) -> np.ndarray:
    """Map a synchronous history's rounds onto the simulated clock: a BSP
    round barriers on the slowest worker, so it costs max(delays) ticks."""
    rounds = np.asarray(history["round"], np.float64)
    return rounds * float(max(delays))


def ticks_to_gap(ticks: np.ndarray, gaps: np.ndarray, target: float) -> float:
    """First tick at which the gap falls to ``target`` (inf if never)."""
    hit = np.nonzero(np.asarray(gaps) <= target)[0]
    return float(np.asarray(ticks)[hit[0]]) if hit.size else float("inf")


def measure_theta(
    data: MTLData,
    i: int,
    alpha: Tensor,
    W: Tensor,
    sigma: Tensor,
    rho: float,
    lam: float,
    loss_name: str,
    dalpha_i: Tensor,
    ref_steps: int = 20000,
    seed: int = 1234,
) -> Dict[str, float]:
    """Empirically measure Theta of Assumption 1 for one task: run a very
    long SDCA to approximate the local optimum D*, then
      Theta_hat = (D* - D(dalpha)) / (D* - D(0)).
    """
    from .sdca import local_sdca_naive, sample_coords

    loss = get_loss(loss_name)
    one = slice(i, i + 1)  # the port's solvers take a leading task axis
    coords = sample_coords(prng.PRNGKey(seed), ref_steps, data.n[i], data.n_max)
    dstar, _ = local_sdca_naive(
        data.x[one],
        data.y[one],
        alpha[one],
        W[one],
        data.n[one],
        sigma[i, i].reshape(1),
        coords[None],
        rho,
        lam,
        loss,
    )

    def obj(da):
        return dual_mod.local_subproblem_objective(
            data, i, da, alpha, W[i], sigma[i, i], rho, lam, loss, data.m
        )

    d_star = float(obj(dstar[0]))
    d_cur = float(obj(dalpha_i))
    d_zero = float(obj(torch.zeros_like(dalpha_i)))
    denom = d_star - d_zero
    theta = (d_star - d_cur) / denom if abs(denom) > 1e-12 else 0.0
    return {"theta": theta, "d_star": d_star, "d_cur": d_cur, "d_zero": d_zero}
