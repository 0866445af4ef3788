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

With ``obs.enable()`` a fit records spans (cat ``driver``), nested by time
under the engine's ``engine_run``: per outer iteration ``rho``, ``w_step``,
``omega_step`` and ``w_from_alpha``; per round ``w_round`` holding
``coords`` (the per-task keys and the uniform draw, one kernel launch on
the card), ``local_sdca`` (the solver; labelled with what it launches, for
K1 its stage-2 path and cluster) and ``reduce``; per tracked evaluation
``objectives``; and ``host_read`` where the host waits for a device value
(rho, the objectives). The labels are worked out once a W-step, so with
tracing off each per-round span costs one flag check.
"""
from __future__ import annotations

import dataclasses
import numbers
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from .. import prng
from ..obs.trace import span
from . import dual as dual_mod
from . import omega_regularizers as omega_reg
from . import sigma_view as sigma_view_mod
from .losses import get_loss
from .mtl_data import MTLData
from .sigma_view import SigmaView, as_view
from .solver_backends import draw_task_uniform, get_backend

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


def validate_tau(tau) -> None:
    """Eagerly reject malformed staleness bounds (e.g. tau="fast") so the
    error surfaces at config/option construction, not mid-fit."""
    if tau == "auto":
        return
    if not isinstance(tau, int) or isinstance(tau, bool):
        raise ValueError(f'tau must be an int >= 0 or "auto", got {tau!r}')
    if tau < 0:
        raise ValueError(f"tau must be >= 0, got {tau}")


def validate_topology(topology) -> None:
    """Eagerly reject malformed gossip topologies. Named topologies are
    checked against the known set; an explicit adjacency must be a square
    symmetric 0/1 matrix (connectivity is checked at transport setup,
    where the worker count is known)."""
    if isinstance(topology, str):
        if topology not in ("ring", "torus", "complete"):
            raise ValueError(
                f"topology must be 'ring' | 'torus' | 'complete' or an "
                f"explicit adjacency matrix, got {topology!r}"
            )
        return
    adj = np.asarray(topology)
    if adj.ndim != 2 or adj.shape[0] != adj.shape[1] or adj.shape[0] < 1:
        raise ValueError(
            f"adjacency topology must be a square matrix, got shape {adj.shape}"
        )
    if not np.array_equal(adj, adj.T):
        raise ValueError("adjacency topology must be symmetric")
    if not np.isin(adj, (0, 1)).all():
        raise ValueError("adjacency topology entries must be 0/1")


def validate_async_fields(
    tau,
    tau_max,
    async_delays,
    omega_delay,
    transport="simulated",
    n_workers=None,
    staleness_budget=None,
    topology="complete",
    codec="none",
) -> None:
    """Shared eager validation for DMTRLConfig and AsyncOptions."""
    validate_tau(tau)
    if not isinstance(transport, str):
        raise ValueError(
            f"transport must be a core.transport member name, got {transport!r}"
        )
    validate_topology(topology)
    if not isinstance(codec, str):
        raise ValueError(f"codec must be a core.wire codec name, got {codec!r}")
    from .wire import available_codecs  # local: wire is numpy-only

    if codec not in available_codecs():
        raise ValueError(
            f"unknown wire codec {codec!r}; have {sorted(available_codecs())}"
        )
    if n_workers is not None and (
        not isinstance(n_workers, numbers.Integral)
        or isinstance(n_workers, bool)
        or n_workers < 1
    ):
        raise ValueError(f"n_workers must be an int >= 1 or None, got {n_workers!r}")
    if staleness_budget is not None and (
        isinstance(staleness_budget, bool)
        or not isinstance(staleness_budget, numbers.Real)
        or staleness_budget < 0
    ):
        raise ValueError(
            f"staleness_budget must be a float >= 0 or None, got {staleness_budget!r}"
        )
    if staleness_budget is not None and tau != "auto":
        raise ValueError(
            f'staleness_budget only drives the tau="auto" controller; it '
            f"would be silently ignored with tau={tau!r}"
        )
    if not isinstance(tau_max, int) or isinstance(tau_max, bool) or tau_max < 0:
        raise ValueError(f"tau_max must be an int >= 0, got {tau_max!r}")
    if not isinstance(omega_delay, int) or isinstance(omega_delay, bool) or omega_delay < 0:
        raise ValueError(f"omega_delay must be an int >= 0, got {omega_delay!r}")
    if async_delays is not None:
        # numbers.Integral admits numpy ints (delay schedules are often
        # built from numpy arrays); _worker_delays coerces them with int()
        bad = [
            v
            for v in async_delays
            if not isinstance(v, numbers.Integral) or isinstance(v, bool) or v < 1
        ]
        if bad:
            raise ValueError(
                f"async_delays entries must be ints >= 1, got {async_delays!r}"
            )


@dataclasses.dataclass(frozen=True)
class DMTRLConfig:
    """Core algorithm config, field for field the JAX package's.

    The per-engine knobs at the bottom are the legacy surface of the async
    engine (``core/async_dmtrl.py``; the estimator takes them as typed
    ``AsyncOptions`` instead) and of the mesh engine
    (``core/distributed.py``; ``DistributedOptions``).
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
    gram_bf16: bool = False  # mesh engine, model axis: X in bf16 for the Gram
    dist_block_hoisted: bool = False  # mesh engine, model axis: block Gram
    track_every: int = 1  # record objectives every k rounds
    # --- async engine (legacy; see async_dmtrl.AsyncOptions) ---------------
    tau: Union[int, str] = 0  # staleness bound: a worker may run at most tau
    #               rounds ahead of the slowest worker (0 == bulk-
    #               synchronous); "auto" adapts it online (transport._adapt_tau)
    tau_max: int = 8  # upper bound for the tau="auto" adaptation
    async_delays: Optional[tuple] = None  # per-worker solve duration in
    #               ticks (host transports: sleep pacing); None == all 1
    omega_delay: int = 0  # server commits the Omega-step install waits for
    transport: str = "simulated"  # snapshot/commit substrate, resolved
    #               through core.transport: "simulated" (over a mesh) |
    #               "threaded" | "multiprocess" | "gossip"
    n_workers: Optional[int] = None  # host-transport worker count; None == 1
    staleness_budget: Optional[float] = None  # tau="auto" cost target
    topology: Union[str, tuple] = "complete"  # gossip neighbor graph:
    #               "ring" | "torus" | "complete" or an explicit symmetric
    #               0/1 adjacency (nested tuples); gossip transport only
    codec: str = "none"  # wire codec for (delta_w, Sigma) messages,
    #               resolved through core.wire: "none" | "bf16" | "int8"

    def __post_init__(self):
        validate_async_fields(
            self.tau,
            self.tau_max,
            self.async_delays,
            self.omega_delay,
            transport=self.transport,
            n_workers=self.n_workers,
            staleness_budget=self.staleness_budget,
            topology=self.topology,
            codec=self.codec,
        )
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
    solver = backend.make_from_uniform(loss, rho, cfg.lam, H, block=cfg.block_size)
    tids = torch.arange(data.m, dtype=torch.int32, device=data.x.device)
    n_div = dual_mod.row_divisor(data, data.x.dtype)  # delta_b's n_i
    # what the solve launches (K1's stage-2 path and cluster), fixed by the
    # data's shape: the local_sdca span's labels
    labels = backend.span_args(data.x, cfg.loss, cfg.block_size)

    def round_fn(alpha, W, sigma, key):
        with span("coords", cat="driver"):
            # the JAX package's per-(task, pod=0) keys and their draws, so
            # both packages draw the same coordinates
            u = draw_task_uniform(key, tids, 0, H, data.x.device)  # (m, H)
        sv = as_view(sigma)
        with span("local_sdca", cat="driver", **labels):
            dalpha, r = solver(data.x, data.y, alpha, W, data.n, sv.diag(), u)
        with span("reduce", cat="driver"):
            alpha = alpha + cfg.eta * dalpha
            # delta_b rows: (m, d); server reduce: W += (1/lam) Sigma @ dB,
            # from the factors for a structured Sigma (no dense (m, m))
            db = cfg.eta * r / n_div
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
        with span("w_round", cat="driver"):
            alpha, W = round_fn(alpha, W, sigma, keys[t])
        if track and (t % cfg.track_every == 0 or t == cfg.rounds - 1):
            with span("objectives", cat="driver"):
                d = dual_mod.dual_objective(data, alpha, sigma, cfg.lam, loss)
                p = dual_mod.primal_objective_from_alpha(data, alpha, sigma, cfg.lam, loss)
                with span("host_read", cat="driver"):
                    dual, primal, gap = float(d), float(p), float(p - d)
            hist["round"].append(t + 1)
            hist["dual"].append(dual)
            hist["primal"].append(primal)
            hist["gap"].append(gap)
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
        with span("rho", cat="driver"):
            rho = _rho_value(cfg, sigma, reg=reg)
        rhos.append(rho)
        key, sub = prng.split(key)
        with span("w_step", cat="driver", outer=p):
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
            with span("omega_step", cat="driver", outer=p):
                sigma, omega = reg.step(W, cfg.omega_jitter)
            # Sigma changed => the dual problem (K) changed; W(alpha) must be
            # recomputed under the new Sigma (B is Sigma-independent).
            with span("w_from_alpha", cat="driver"):
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
