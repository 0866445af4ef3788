"""Baselines from the paper's experiments section.

 * STL              -- each task an independent regularized ERM. Realized as
                       DMTRL with Sigma fixed at I/m and no Omega-step
                       (regularizer (lambda m/2)||w_i||^2, exactly the
                       paper's Omega = m I init held fixed).
 * Centralized MTRL -- Zhang & Yeung (2010) alternating optimization run on
                       one machine: full-batch accelerated gradient descent
                       on the primal W-step (+ closed-form Omega-step). The
                       paper's "gold standard".
 * SSDCA            -- single-machine SDCA over ALL dual coordinates with
                       exact (not block-approximated) global updates. The
                       paper's scalable single-machine solution.

Each runs on ``device`` (the card unless the caller passes "cpu"). The
JAX package runs FISTA under ``lax.scan`` and SSDCA's pass under
``fori_loop``; here both are plain Python loops of eager operations, so
on the card they are bound by launches, not by the device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from .. import prng
from . import dual as dual_mod
from . import omega as omega_mod
from .dmtrl import DMTRLConfig, DMTRLResult, fit as dmtrl_fit, resolve_device
from .losses import get_loss
from .mtl_data import MTLData

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# STL
# ---------------------------------------------------------------------------
def fit_stl(cfg: DMTRLConfig, data: MTLData, device="cuda") -> DMTRLResult:
    stl_cfg = dataclasses.replace(cfg, learn_omega=False)
    return dmtrl_fit(stl_cfg, data, device=device)


# ---------------------------------------------------------------------------
# Centralized MTRL (primal FISTA W-step + closed-form Omega-step)
# ---------------------------------------------------------------------------
def _primal_grad(data: MTLData, W: Tensor, omega: Tensor, lam: float, loss):
    z = torch.einsum("mnd,md->mn", data.x, W)
    g = loss.subgradient(z, data.y) * data.mask / data.n[:, None].to(z.dtype)
    grad_emp = torch.einsum("mn,mnd->md", g, data.x)
    grad_reg = lam * (omega @ W)
    return grad_emp + grad_reg


def fit_centralized_mtrl(
    cfg: DMTRLConfig,
    data: MTLData,
    inner_steps: int = 300,
    lr: float = 0.0,
    device="cuda",
) -> Tuple[Tensor, Tensor, Dict[str, np.ndarray]]:
    """Alternating primal optimization; smooth losses (use smoothed_hinge in
    place of hinge for the central baseline, as subgradient FISTA has no
    guarantee). Returns (W, sigma, history)."""
    data = data.to(resolve_device(device))
    loss = get_loss(cfg.loss)
    m, d = data.m, data.d
    W = torch.zeros((m, d), dtype=data.x.dtype, device=data.device)
    sigma, omega = omega_mod.init_sigma(m, data.x.dtype, data.device)

    # Lipschitz estimate for the gradient: L <= max_i (q_max) + lam*||Omega||;
    # q_max = max row-norm^2 (features), conservative and cheap.
    qmax = float(torch.max(torch.sum(data.x**2, dim=-1)))

    hist = {"outer": [], "primal": []}
    for p in range(cfg.outer_iters):
        om_norm = float(torch.linalg.matrix_norm(omega, ord=2))
        L = qmax + cfg.lam * om_norm
        step = lr if lr > 0 else 1.0 / max(L, 1e-12)
        # FISTA; the momentum scalar is carried in float32, as the JAX
        # package's scan carries it
        Wk, Vk, tk = W, W, np.float32(1.0)
        for _ in range(inner_steps):
            g = _primal_grad(data, Vk, omega, cfg.lam, loss)
            Wn = Vk - step * g
            tn = np.float32(0.5) * (np.float32(1.0) + np.sqrt(np.float32(1.0) + np.float32(4.0) * tk**2))
            Vk = Wn + float((tk - np.float32(1.0)) / tn) * (Wn - Wk)
            Wk, tk = Wn, tn
        W = Wk
        hist["outer"].append(p)
        hist["primal"].append(
            float(dual_mod.primal_objective(data, W, omega, cfg.lam, loss))
        )
        if cfg.learn_omega:
            sigma, omega = omega_mod.omega_step(W, cfg.omega_jitter)
    return W, sigma, {k: np.asarray(v) for k, v in hist.items()}


# ---------------------------------------------------------------------------
# Single-machine SDCA (exact global coordinate updates over all tasks)
# ---------------------------------------------------------------------------
def fit_ssdca(
    cfg: DMTRLConfig,
    data: MTLData,
    passes: int | None = None,
    track_every_pass: bool = True,
    device="cuda",
) -> Tuple[Tensor, Tensor, Dict[str, np.ndarray]]:
    """SDCA over all n = sum n_i coordinates with exact updates.

    For a sampled coordinate (i, j):
        c = w_i(alpha)^T x_j^i          (exact current margin)
        a = sigma_ii ||x_j||^2 / (lam n_i)
    and the same per-loss closed-form delta as Local SDCA. B (d, m) is
    maintained incrementally; w_i = (1/lam) B sigma[:, i].

    One "pass" = n_max coordinate updates per task (m * n_max total),
    comparable compute to one DMTRL round with H = n_max. Omega-steps happen
    every cfg.rounds passes to mirror Algorithm 1's schedule. The draws
    (task by ``randint``, row by ``uniform``) are the JAX package's; the
    steps run one after another, each a handful of eager operations.
    """
    data = data.to(resolve_device(device))
    loss = get_loss(cfg.loss)
    m, n_max, d = data.m, data.n_max, data.d
    passes = passes if passes is not None else cfg.outer_iters * cfg.rounds
    alpha = torch.zeros((m, n_max), dtype=data.x.dtype, device=data.device)
    B = torch.zeros((d, m), dtype=data.x.dtype, device=data.device)
    sigma, omega = omega_mod.init_sigma(m, data.x.dtype, data.device)
    key = prng.PRNGKey(cfg.seed + 17)
    steps_per_pass = m * n_max
    n_host = data.n.cpu().numpy().astype(np.int32)
    nf = data.n.to(data.x.dtype)

    def one_pass(alpha, B, key):
        ki, kj = prng.split(key)
        # the sampled (task, row) pairs, mapped on the host as the JAX
        # pass maps them: j = min(int32(u * float32(n_i)), n_i - 1)
        tis = prng.randint(ki, (steps_per_pass,), 0, m).numpy()
        us = prng.uniform(kj, (steps_per_pass,)).numpy()
        ni = n_host[tis]
        js = np.minimum((us * ni.astype(np.float32)).astype(np.int32), ni - 1)
        for i, j in zip(tis.tolist(), js.tolist()):
            xj = data.x[i, j]
            w_i = (B @ sigma[:, i]) / cfg.lam
            c = torch.dot(xj, w_i)
            a = sigma[i, i] * torch.dot(xj, xj) / (cfg.lam * nf[i])
            delta = loss.sdca_delta(alpha[i, j], c, a, data.y[i, j])
            alpha[i, j] += delta
            B[:, i] += delta * xj / nf[i]
        return alpha, B

    hist = {"pass": [], "dual": [], "primal": [], "gap": []}
    for t in range(passes):
        key, sub = prng.split(key)
        alpha, B = one_pass(alpha, B, sub)
        if track_every_pass:
            dd = dual_mod.dual_objective(data, alpha, sigma, cfg.lam, loss)
            pp = dual_mod.primal_objective_from_alpha(data, alpha, sigma, cfg.lam, loss)
            hist["pass"].append(t + 1)
            hist["dual"].append(float(dd))
            hist["primal"].append(float(pp))
            hist["gap"].append(float(pp - dd))
        if cfg.learn_omega and (t + 1) % cfg.rounds == 0:
            W = (B @ sigma).T / cfg.lam
            sigma, omega = omega_mod.omega_step(W, cfg.omega_jitter)

    W = (B @ sigma).T / cfg.lam
    return W, sigma, {k: np.asarray(v) for k, v in hist.items()}
