"""DMTRL Algorithm 1 — single-process reference driver.

Implements the alternating procedure exactly as in the paper:

  for p in 1..P:                      (alternating iterations)
    for t in 1..T:                    (W-step rounds == communication rounds)
      for each task i in parallel:    (the task dimension == the paper's workers)
        dalpha_[i] <- LocalSDCA(alpha_[i], w_i, sigma_ii)     (H inner iters)
        alpha_[i] += eta * dalpha_[i]
        delta_b_i  = (eta/n_i) X_i^T dalpha_[i]
      server: w_i += (1/lambda) sum_i' delta_b_i' sigma_ii'   (the reduce)
    server: Sigma, Omega <- omega_step(W)
    rho <- Lemma-10 bound on the new Sigma (paper Section 7.1)

Keys, coordinate draws and the order of every step follow the JAX
package's ``repro.core.dmtrl`` so both walk the same iterate sequence from
one seed. The entry point ``fit`` runs on the CUDA card unless the caller
passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from .. import prng
from . import dual as dual_mod
from . import omega_regularizers as omega_reg
from . import sigma_view as sigma_view_mod
from .losses import get_loss
from .mtl_data import MTLData
from .sigma_view import SigmaView, as_view
from .solver_backends import get_backend

Tensor = torch.Tensor


def resolve_device(device="cuda") -> torch.device:
    """The device a run uses. A CUDA device with no card present raises:
    nothing falls back to the CPU unless the caller asks for it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return device


@dataclasses.dataclass(frozen=True)
class DMTRLConfig:
    """Core algorithm config, field for field the JAX package's.

    The per-engine knobs at the bottom (async staleness, distributed gram
    options) belong to engines this package does not have yet; they are
    kept, unchecked and unread, so that a JAX config carries over
    unchanged.
    """

    loss: str = "hinge"
    lam: float = 1e-3  # lambda in Eq. (1)
    eta: float = 1.0  # aggregation parameter (paper uses 1.0)
    outer_iters: int = 5  # P
    rounds: int = 20  # T (communication rounds per W-step)
    local_iters: int = 0  # H; 0 => n_max (one local epoch per round)
    solver: str = "block_gram"  # local-SDCA backend name, resolved through
    #               core.solver_backends: "naive" | "block_gram" |
    #               "pallas_block" | "pallas_round"
    block_size: int = 64
    rho_mode: str = "lemma10"  # "lemma10" | "spectral" | "fixed"
    rho_fixed: float = 1.0
    omega_jitter: float = 1e-6
    learn_omega: bool = True  # False => STL-style fixed Sigma (legacy alias
    #               for omega_regularizer="identity_stl")
    omega_regularizer: str = "trace_constraint"  # family member name,
    #               resolved through core.omega_regularizers
    seed: int = 0
    gram_bf16: bool = False  # distributed engine (not ported yet)
    dist_block_hoisted: bool = False  # distributed engine (not ported yet)
    track_every: int = 1  # record objectives every k rounds
    # --- async engine (legacy; not ported yet) ------------------------------
    tau: Union[int, str] = 0
    tau_max: int = 8
    async_delays: Optional[tuple] = None
    omega_delay: int = 0
    transport: str = "simulated"
    n_workers: Optional[int] = None
    staleness_budget: Optional[float] = None
    topology: Union[str, tuple] = "complete"
    codec: str = "none"

    def __post_init__(self):
        if self.omega_regularizer not in omega_reg.available_regularizers():
            raise ValueError(
                f"unknown omega_regularizer {self.omega_regularizer!r}; "
                f"have {sorted(omega_reg.available_regularizers())}"
            )


@dataclasses.dataclass(frozen=True)
class WarmStart:
    """Prior state to continue training from (estimator.partial_fit).

    ``alpha``: (m, n_max) dual variables, ``sigma``/``omega``: (m, m) task
    covariance/precision. W is always rederived as W(alpha) under sigma,
    never carried separately. Tensors or numpy arrays; structured runs
    carry a SigmaView (its factors) for ``sigma`` and None (or a view) for
    ``omega``.
    """

    alpha: Tensor
    sigma: Tensor
    omega: Optional[Tensor] = None


@dataclasses.dataclass
class DMTRLResult:
    W: Tensor  # (m, d)
    alpha: Tensor  # (m, n_max)
    sigma: Tensor  # (m, m) dense, or a SigmaView when m is huge
    omega: Optional[Tensor]  # (m, m); None for structured members w/o inverse
    history: Dict[str, np.ndarray]
    rho_per_outer: List[float]
    # the structured representation itself, when the run used one
    sigma_view: Optional[SigmaView] = None


def _rho_value(
    cfg: DMTRLConfig,
    sigma,
    n_blocks_scale: float = 1.0,
    reg: Optional[omega_reg.OmegaRegularizer] = None,
) -> float:
    """rho safety bound for the current Sigma, via the regularizer family."""
    if reg is None:
        reg = omega_reg.resolve_regularizer(cfg)
    rho = reg.rho(sigma, cfg.eta, cfg.rho_mode, cfg.rho_fixed)
    if cfg.rho_mode == "fixed":
        return float(rho)
    return float(rho) * n_blocks_scale


def make_w_step_round(cfg: DMTRLConfig, data: MTLData, rho: float):
    """One communication round: local updates of every task + reduce.

    Returns round(alpha, W, sigma, key) -> (alpha, W)."""
    loss = get_loss(cfg.loss)
    backend = get_backend(cfg.solver)
    H = backend.round_local_iters(cfg.local_iters or data.n_max, cfg.block_size)
    solver = backend.make(loss, rho, cfg.lam, H, block=cfg.block_size)
    tids = torch.arange(data.m, dtype=torch.int64)

    def round_fn(alpha, W, sigma, key):
        # the JAX package's per-(task, pod=0) key derivation, so both
        # packages draw the same coordinates
        keys = prng.fold_in(prng.fold_in(key, tids), 0)  # (m, 2)
        sv = as_view(sigma)
        dalpha, r = solver(data.x, data.y, alpha, W, data.n, sv.diag(), keys)
        alpha = alpha + cfg.eta * dalpha
        # delta_b rows: (m, d); server reduce: W += (1/lam) Sigma @ dB,
        # from the factors for a structured Sigma (no dense (m, m))
        db = cfg.eta * r / data.n[:, None].to(r.dtype)
        W = W + sv.matvec(db) / cfg.lam
        return alpha, W

    return round_fn


def w_step(
    cfg: DMTRLConfig,
    data: MTLData,
    alpha: Tensor,
    W: Tensor,
    sigma,
    rho: float,
    key: Tensor,
    track: bool = True,
) -> tuple[Tensor, Tensor, Dict[str, np.ndarray]]:
    """Run cfg.rounds communication rounds; returns updated alpha, W, history."""
    loss = get_loss(cfg.loss)
    round_fn = make_w_step_round(cfg, data, rho)
    hist = {"round": [], "dual": [], "primal": [], "gap": []}
    keys = prng.split(key, cfg.rounds)
    for t in range(cfg.rounds):
        alpha, W = round_fn(alpha, W, sigma, keys[t])
        if track and (t % cfg.track_every == 0 or t == cfg.rounds - 1):
            d = dual_mod.dual_objective(data, alpha, sigma, cfg.lam, loss)
            p = dual_mod.primal_objective_from_alpha(data, alpha, sigma, cfg.lam, loss)
            hist["round"].append(t + 1)
            hist["dual"].append(float(d))
            hist["primal"].append(float(p))
            hist["gap"].append(float(p - d))
    return alpha, W, {k: np.asarray(v) for k, v in hist.items()}


def fit(
    cfg: DMTRLConfig,
    data: MTLData,
    track: bool = True,
    *,
    init: Optional[WarmStart] = None,
    regularizer=None,
    device="cuda",
) -> DMTRLResult:
    """Full Algorithm 1: P alternations of (W-step, Omega-step).

    ``init`` warm-starts from a prior (alpha, sigma, omega) — W is rederived
    as W(alpha); ``regularizer`` overrides the Omega family member resolved
    from the config (an ``OmegaRegularizer`` instance or name). The run and
    its result tensors live on ``device`` (the CUDA card by default).
    """
    device = resolve_device(device)
    data = data.to(device)
    reg = omega_reg.resolve_regularizer(cfg, regularizer, m=data.m)
    key = prng.PRNGKey(cfg.seed)
    m, n_max = data.m, data.n_max
    dtype = data.x.dtype

    def tensor(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    if init is not None:
        # a structured warm start keeps its factors: no dense (m, m)
        alpha = tensor(init.alpha)
        sigma = init.sigma if isinstance(init.sigma, SigmaView) else tensor(init.sigma)
        omega = init.omega
        if omega is not None and not isinstance(omega, SigmaView):
            omega = tensor(omega)
        W = dual_mod.weights_from_alpha(data, alpha, sigma, cfg.lam)
    else:
        alpha = torch.zeros((m, n_max), dtype=dtype, device=device)
        W = torch.zeros((m, data.d), dtype=dtype, device=device)
        sigma, omega = reg.init(m, dtype, device)

    history: Dict[str, List[np.ndarray]] = {
        "round": [], "dual": [], "primal": [], "gap": [], "outer": [],
    }
    rhos: List[float] = []
    rounds_seen = 0
    for p in range(cfg.outer_iters):
        rho = _rho_value(cfg, sigma, reg=reg)
        rhos.append(rho)
        key, sub = prng.split(key)
        alpha, W, hist = w_step(cfg, data, alpha, W, sigma, rho, sub, track=track)
        if track:
            history["round"].append(hist["round"] + rounds_seen)
            history["dual"].append(hist["dual"])
            history["primal"].append(hist["primal"])
            history["gap"].append(hist["gap"])
            history["outer"].append(np.full_like(hist["round"], p))
        rounds_seen += cfg.rounds
        if reg.learns:
            # Algorithm 1 row 11 runs after every W-step, including the last.
            sigma, omega = reg.step(W, cfg.omega_jitter)
            # Sigma changed => the dual problem (K) changed; W(alpha) must be
            # recomputed under the new Sigma (B is Sigma-independent).
            W = dual_mod.weights_from_alpha(data, alpha, sigma, cfg.lam)

    hist_np = {
        k: (np.concatenate(v) if v else np.zeros((0,))) for k, v in history.items()
    }
    sigma_out, omega_out, sv = sigma_view_mod.result_sigma_omega(sigma, omega)
    return DMTRLResult(
        W=W,
        alpha=alpha,
        sigma=sigma_out,
        omega=omega_out,
        history=hist_np,
        rho_per_outer=rhos,
        sigma_view=sv,
    )
