"""Pluggable Omega-regularizer family (the paper's general dual form).

The paper's dual derivation (Thm. 1) never uses the *specific* Zhang-Yeung
trace-constrained Omega: any symmetric PD task-coupling Sigma yields the
same dual problem, local subproblems, and rho-bounded aggregation. What
distinguishes family members is only

  * how Sigma is INITIALIZED,
  * whether/how Sigma is UPDATED after each W-step (Algorithm 1 row 11),
  * the rho upper bound fed to the local subproblems (Lemma 10 / spectral
    both apply to any PD Sigma, so the default bound is shared).

Registered members (the JAX package's ``repro.core.omega_regularizers``):

  trace_constraint  the paper / Zhang & Yeung (2010): closed-form
                    Sigma = (W^T W)^{1/2} / tr((W^T W)^{1/2}) after every
                    W-step (core/omega.py:omega_step). The default.
  graph_laplacian   fixed task-graph coupling (Wang et al.,
                    arXiv:1802.03830): Omega = coupling * L + eps I from a
                    known task graph; Sigma never updates.
  identity_stl      Sigma fixed at I/m — independent ridge-regularized
                    tasks; subsumes ``DMTRLConfig.learn_omega=False``.
  frobenius_shrunk  trace_constraint update shrunk toward I/m:
                    Sigma = (1-g) Sigma_ZY + g I/m (trace stays 1).
  low_rank_diag     structured Zhang-Yeung, Sigma = U diag(s) U^T + diag(d)
                    (core/omega.py:omega_step_lowrank): O(m r) storage,
                    no m x m anything.
  graphical_lasso   a learned sparse task graph (SparseSigma), built on
                    the host in float64 numpy as the JAX package builds it.

Usage:

    reg = get_regularizer("graph_laplacian", adjacency=A)
    est = DMTRLEstimator(regularizer="low_rank_diag",
                         regularizer_params={"rank": 32})
"""
from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from . import omega as omega_mod
from .sigma_view import LowRankDiagSigma, SigmaView, SparseSigma

Tensor = torch.Tensor


def default_rho_bound(
    sigma, eta: float = 1.0, mode: str = "lemma10", fixed: float = 1.0
) -> float:
    """The paper's rho bounds; valid for ANY symmetric PD Sigma, so every
    family member shares it unless it can prove something tighter.
    Accepts a dense (m, m) tensor or any SigmaView."""
    if mode == "fixed":
        return float(fixed)
    if isinstance(sigma, SigmaView):
        if mode == "spectral":
            return float(sigma.rho_spectral(eta))
        return float(sigma.rho_lemma10(eta))
    if mode == "spectral":
        return float(omega_mod.rho_spectral(sigma, eta))
    return float(omega_mod.rho_lemma10(sigma, eta))


def _check_finite_w(W, name: str) -> None:
    """Raise before a NaN/inf W can flow through an Omega-step into Sigma
    (eigh on non-finite input silently yields NaN eigenvectors)."""
    if not bool(torch.all(torch.isfinite(W))):
        raise ValueError(
            f"omega regularizer {name!r}: step() received a non-finite W "
            "(NaN/inf) — refusing to produce a corrupt Sigma. Check the "
            "W-step inputs (labels/features) or lower eta/rho."
        )


@dataclasses.dataclass(frozen=True)
class OmegaRegularizer:
    """One named member of the regularizer family.

    ``init(m, dtype, device) -> (sigma, omega)`` supplies the starting
    coupling; ``step(W, jitter) -> (sigma, omega)`` is the post-W-step
    update (only when ``learns``); ``rho(sigma, eta, mode, fixed)`` the
    aggregation safety bound matching this member's Sigma.
    """

    name: str
    description: str
    # Sigma updates after each W-step (Algorithm 1 row 11); False => the
    # coupling is fixed for the whole run and the trainer skips the step.
    learns: bool
    init: Callable[..., Tuple[Tensor, Tensor]]
    step: Optional[Callable[..., Tuple[Tensor, Tensor]]] = None
    rho: Callable[..., float] = default_rho_bound
    # init differs from the paper's I/m (a padded run must pad this
    # member's true-task Sigma instead of initializing at the padded size)
    custom_init: bool = False
    # init/step produce SigmaViews (low_rank_diag / graphical_lasso)
    # instead of dense (m, m) tensors; the trainer keeps the factors
    structured: bool = False

    def __post_init__(self):
        if self.learns and self.step is None:
            raise ValueError(f"regularizer {self.name!r}: learns=True needs a step")
        if self.step is not None and not getattr(self.step, "_finite_w_guarded", False):
            base_step, name = self.step, self.name

            def guarded_step(W, jitter: float = 1e-6):
                _check_finite_w(W, name)
                return base_step(W, jitter)

            guarded_step._finite_w_guarded = True
            object.__setattr__(self, "step", guarded_step)


# factory(**params) -> OmegaRegularizer; params are member-specific
_REGISTRY: Dict[str, Callable[..., OmegaRegularizer]] = {}
_DESCRIPTIONS: Dict[str, str] = {}


def register_regularizer(
    name: str, factory: Callable[..., OmegaRegularizer], description: str
) -> None:
    _REGISTRY[name] = factory
    _DESCRIPTIONS[name] = description


def get_regularizer(name: str, **params) -> OmegaRegularizer:
    """Resolve a family member by name, configured with member params
    (e.g. ``adjacency=`` for graph_laplacian, ``shrinkage=`` for
    frobenius_shrunk, ``rank=`` for low_rank_diag)."""
    try:
        factory = _REGISTRY[name]
    except KeyError as e:
        raise KeyError(
            f"unknown omega regularizer {name!r}; have {sorted(_REGISTRY)}"
        ) from e
    return factory(**params)


def available_regularizers() -> Dict[str, str]:
    return dict(sorted(_DESCRIPTIONS.items()))


# dense-Sigma members above this many tasks get a one-time nudge toward the
# structured members (m^2 floats + O(m^3) eigh stop being cheap)
DENSE_SIGMA_WARN_THRESHOLD = int(os.environ.get("REPRO_DENSE_SIGMA_WARN_M", "2048"))
_dense_scale_warned: set = set()


def _warn_if_dense_at_scale(reg: OmegaRegularizer, m, threshold) -> None:
    if m is None or reg.structured:
        return
    limit = DENSE_SIGMA_WARN_THRESHOLD if threshold is None else int(threshold)
    if m <= limit or reg.name in _dense_scale_warned:
        return
    _dense_scale_warned.add(reg.name)
    warnings.warn(
        f"omega regularizer {reg.name!r} materializes a dense {m}x{m} Sigma "
        f"(m > {limit}): storage is m^2 floats and the Omega-step is O(m^3). "
        "Consider the structured members 'low_rank_diag' (Sigma ~ U U^T + D) "
        "or 'graphical_lasso' (sparse coupling) which scale to huge m. "
        "Raise REPRO_DENSE_SIGMA_WARN_M to silence.",
        stacklevel=3,
    )


def resolve_regularizer(
    cfg, regularizer=None, m=None, dense_warn_threshold=None
) -> OmegaRegularizer:
    """Resolve the regularizer a run should use.

    Precedence: an explicit ``regularizer`` argument (instance or name) >
    legacy ``cfg.learn_omega=False`` (maps to identity_stl) >
    ``cfg.omega_regularizer``. ``cfg`` is duck-typed: only
    ``learn_omega`` / ``omega_regularizer`` are read. When the caller
    knows the task count it passes ``m`` so a dense member requested at
    scale gets a one-time structured-member warning.
    """
    if regularizer is not None:
        if isinstance(regularizer, str):
            regularizer = get_regularizer(regularizer)
        if not isinstance(regularizer, OmegaRegularizer):
            raise TypeError(
                f"regularizer must be a name or OmegaRegularizer instance, "
                f"got {type(regularizer).__name__}; parameterized members "
                "are built via get_regularizer(name, **params)"
            )
        if not getattr(cfg, "learn_omega", True) and regularizer.learns:
            raise ValueError(
                f"learn_omega=False conflicts with the learning regularizer "
                f"{regularizer.name!r}; drop learn_omega or pick a fixed member"
            )
        _warn_if_dense_at_scale(regularizer, m, dense_warn_threshold)
        return regularizer
    if not getattr(cfg, "learn_omega", True):
        return get_regularizer("identity_stl")
    name = getattr(cfg, "omega_regularizer", "trace_constraint")
    try:
        reg = get_regularizer(name)
        _warn_if_dense_at_scale(reg, m, dense_warn_threshold)
        return reg
    except ValueError as e:
        # members needing parameters (graph_laplacian's task graph) cannot
        # be named through the bare config — point at the working route
        raise ValueError(
            f"omega_regularizer={name!r} needs member parameters that the "
            "config cannot carry; pass the member explicitly, e.g. "
            f"DMTRLEstimator(regularizer={name!r}, "
            "regularizer_params={...}) or regularizer=get_regularizer("
            f"{name!r}, ...)"
        ) from e


def _trace_constraint() -> OmegaRegularizer:
    return OmegaRegularizer(
        name="trace_constraint",
        description=_DESCRIPTIONS["trace_constraint"],
        learns=True,
        init=omega_mod.init_sigma,
        step=omega_mod.omega_step,
    )


def _identity_stl() -> OmegaRegularizer:
    return OmegaRegularizer(
        name="identity_stl",
        description=_DESCRIPTIONS["identity_stl"],
        learns=False,
        init=omega_mod.init_sigma,
    )


# ---------------------------------------------------------------------------
# graph_laplacian — fixed Sigma from a known task graph (arXiv:1802.03830)
# ---------------------------------------------------------------------------
def _graph_laplacian(
    adjacency=None,
    laplacian=None,
    coupling: float = 1.0,
    eps: float = 1e-3,
) -> OmegaRegularizer:
    """Omega = coupling * L + eps I, Sigma = Omega^{-1}, trace-normalized to 1
    so rho and lambda stay on the same scale as the learned members.

    Pass either ``adjacency`` (symmetric non-negative weights; L = D - A) or
    ``laplacian`` directly. Built once on the host in float64.
    """
    if (adjacency is None) == (laplacian is None):
        raise ValueError(
            "graph_laplacian needs exactly one of adjacency= or laplacian="
        )
    if laplacian is None:
        A = np.asarray(adjacency, np.float64)
        if A.ndim != 2 or A.shape[0] != A.shape[1]:
            raise ValueError(f"adjacency must be square, got {A.shape}")
        if not np.allclose(A, A.T):
            raise ValueError("adjacency must be symmetric")
        if A.min() < 0:
            raise ValueError("adjacency weights must be non-negative")
        L = np.diag(A.sum(axis=1)) - A
    else:
        L = np.asarray(laplacian, np.float64)
        if L.ndim != 2 or L.shape[0] != L.shape[1]:
            raise ValueError(f"laplacian must be square, got {L.shape}")
    if eps <= 0 or coupling <= 0:
        raise ValueError("graph_laplacian needs eps > 0 and coupling > 0")
    m_graph = L.shape[0]
    omega0 = coupling * L + eps * np.eye(m_graph)
    omega0 = 0.5 * (omega0 + omega0.T)
    sigma0 = np.linalg.inv(omega0)
    sigma0 = 0.5 * (sigma0 + sigma0.T)
    tr = float(np.trace(sigma0))
    sigma0 /= tr
    omega0 *= tr  # keep Sigma @ Omega = I after the trace normalization

    def init(m: int, dtype=torch.float32, device=None) -> Tuple[Tensor, Tensor]:
        if m != m_graph:
            raise ValueError(
                f"graph_laplacian was built for {m_graph} tasks but the "
                f"dataset has {m}"
            )
        return (torch.as_tensor(sigma0, dtype=dtype, device=device),
                torch.as_tensor(omega0, dtype=dtype, device=device))

    return OmegaRegularizer(
        name="graph_laplacian",
        description=_DESCRIPTIONS["graph_laplacian"],
        learns=False,
        init=init,
        custom_init=True,
    )


# ---------------------------------------------------------------------------
# frobenius_shrunk — ZY update shrunk toward I/m (trace preserved)
# ---------------------------------------------------------------------------
def _frobenius_shrunk(shrinkage: float = 0.5) -> OmegaRegularizer:
    if not 0.0 <= shrinkage <= 1.0:
        raise ValueError(f"shrinkage must be in [0, 1], got {shrinkage}")

    def step(W: Tensor, jitter: float = 1e-6) -> Tuple[Tensor, Tensor]:
        sigma_zy, _ = omega_mod.omega_step(W, jitter)
        m = W.shape[0]
        eye = torch.eye(m, dtype=sigma_zy.dtype, device=sigma_zy.device)
        sigma = (1.0 - shrinkage) * sigma_zy + shrinkage * eye / m
        sigma = 0.5 * (sigma + sigma.T)
        evals, evecs = torch.linalg.eigh(sigma)
        evals = torch.clamp(evals, min=1e-30)
        omega = (evecs * (1.0 / evals)) @ evecs.T
        return sigma, 0.5 * (omega + omega.T)

    return OmegaRegularizer(
        name="frobenius_shrunk",
        description=_DESCRIPTIONS["frobenius_shrunk"],
        learns=True,
        init=omega_mod.init_sigma,
        step=step,
    )


# ---------------------------------------------------------------------------
# low_rank_diag — structured Zhang-Yeung: Sigma = U diag(s) U^T + diag(d)
# ---------------------------------------------------------------------------
def _low_rank_diag(rank: int = 32, iters: int = 8) -> OmegaRegularizer:
    """Rank-r subspace-iteration Omega-step (core/omega.py:
    omega_step_lowrank): O(m*r) storage, O(m*d*r) step, no m x m ever.
    Exact Zhang-Yeung at r >= rank(W W^T) (in particular r = m)."""
    if rank < 1:
        raise ValueError(f"low_rank_diag needs rank >= 1, got {rank}")
    if iters < 1:
        raise ValueError(f"low_rank_diag needs iters >= 1, got {iters}")

    def init(m: int, dtype=torch.float32, device=None):
        r = min(rank, m)

        def view(diag_value: float) -> LowRankDiagSigma:
            # Sigma = I/m: empty factor + uniform diagonal (Algorithm 1 init)
            return LowRankDiagSigma(
                U=torch.zeros((m, r), dtype=dtype, device=device),
                core=torch.zeros((r, r), dtype=dtype, device=device),
                d=torch.full((m,), diag_value, dtype=dtype, device=device),
            )

        return view(1.0 / m), view(float(m))

    def step(W: Tensor, jitter: float = 1e-6):
        U, s, d = omega_mod.omega_step_lowrank(W, rank, iters, jitter)
        sigma = LowRankDiagSigma(U=U, core=torch.diag(s), d=d)
        return sigma, sigma.precision()

    return OmegaRegularizer(
        name="low_rank_diag",
        description=_DESCRIPTIONS["low_rank_diag"],
        learns=True,
        init=init,
        step=step,
        structured=True,
    )


# ---------------------------------------------------------------------------
# graphical_lasso — soft-thresholded sparse task coupling (arXiv:1802.03830)
# ---------------------------------------------------------------------------
def _graphical_lasso(
    penalty: float = 0.5, block: int = 2048, max_nnz: Optional[int] = None
) -> OmegaRegularizer:
    """Learned sparse task graph: the normalized coupling S = W W^T / tr is
    soft-thresholded off-diagonally at lambda = penalty/m (i.e. ``penalty``
    in units of the mean diagonal), one coordinate at a time, then stored
    as diagonal + ELL sparse rows (SparseSigma).

    PSD is preserved analytically: thresholding removes a symmetric error
    matrix E with ||E||_2 <= ||E||_inf = max_i sum_j min(|s_ij|, lambda),
    and that bound is added back onto the diagonal before trace
    renormalization — so Sigma stays PD for any penalty, and at penalty=0
    the boost is zero and Sigma equals the dense trace-normalized coupling.

    The coupling is built blockwise on the host in float64 numpy (O(block
    * m) peak, never m x m), as the JAX package builds it; the factors then
    go to W's device. ``max_nnz`` optionally caps per-row off-diagonal
    entries (keeping the largest-magnitude ones).
    """
    if penalty < 0:
        raise ValueError(f"graphical_lasso needs penalty >= 0, got {penalty}")
    if block < 1:
        raise ValueError(f"graphical_lasso needs block >= 1, got {block}")

    def init(m: int, dtype=torch.float32, device=None):
        def view(diag_value: float) -> SparseSigma:
            return SparseSigma(
                diag_v=torch.full((m,), diag_value, dtype=dtype, device=device),
                cols=torch.zeros((m, 0), dtype=torch.int32, device=device),
                vals=torch.zeros((m, 0), dtype=dtype, device=device),
            )

        return view(1.0 / m), view(float(m))

    def step(W: Tensor, jitter: float = 1e-6):
        Wn = W.detach().cpu().double().numpy()
        m = Wn.shape[0]
        tr = float((Wn * Wn).sum())  # tr(W W^T)
        if tr <= 1e-30:  # degenerate W -> fall back to Sigma = I/m
            return init(m, W.dtype, W.device)
        lam_abs = penalty / m
        diag_s = (Wn * Wn).sum(axis=1) / tr
        row_cols: list = []
        row_vals: list = []
        boost = 0.0
        for lo in range(0, m, block):
            hi = min(lo + block, m)
            S_blk = (Wn[lo:hi] @ Wn.T) / tr  # (b, m) coupling rows
            for i in range(lo, hi):
                row = S_blk[i - lo].copy()
                row[i] = 0.0  # off-diagonal only
                removed = np.minimum(np.abs(row), lam_abs).sum()
                boost = max(boost, removed)
                keep = np.nonzero(np.abs(row) > lam_abs)[0]
                v = np.sign(row[keep]) * (np.abs(row[keep]) - lam_abs)
                if max_nnz is not None and keep.size > max_nnz:
                    top = np.argsort(-np.abs(v))[:max_nnz]
                    keep, v = keep[top], v[top]
                row_cols.append(keep.astype(np.int32))
                row_vals.append(v)
        k_max = max((c.size for c in row_cols), default=0)
        cols = np.zeros((m, k_max), np.int32)
        vals = np.zeros((m, k_max), np.float64)
        for i, (c, v) in enumerate(zip(row_cols, row_vals)):
            cols[i, : c.size] = c
            vals[i, : v.size] = v
        diag_f = diag_s + boost + jitter
        total = diag_f.sum()  # off-diagonals don't contribute to the trace
        sigma = SparseSigma(
            diag_v=torch.as_tensor(diag_f / total, dtype=W.dtype, device=W.device),
            cols=torch.as_tensor(cols, device=W.device),
            vals=torch.as_tensor(vals / total, dtype=W.dtype, device=W.device),
        )
        return sigma, None  # sparse Sigma has no cheap structured inverse

    return OmegaRegularizer(
        name="graphical_lasso",
        description=_DESCRIPTIONS["graphical_lasso"],
        learns=True,
        init=init,
        step=step,
        structured=True,
    )


register_regularizer(
    "trace_constraint",
    _trace_constraint,
    "paper / Zhang-Yeung closed form: Sigma = (W^T W)^{1/2} trace-normalized "
    "to 1, recomputed after every W-step (the default)",
)
register_regularizer(
    "identity_stl",
    _identity_stl,
    "fixed Sigma = I/m: independent ridge-regularized tasks (subsumes "
    "learn_omega=False)",
)
register_regularizer(
    "graph_laplacian",
    _graph_laplacian,
    "fixed Sigma = (coupling*L + eps I)^{-1} from a known task graph "
    "(arXiv:1802.03830), trace-normalized to 1",
)
register_regularizer(
    "frobenius_shrunk",
    _frobenius_shrunk,
    "Zhang-Yeung update shrunk toward I/m by a shrinkage factor in [0, 1] "
    "(trace stays 1; couplings bounded away from rank collapse)",
)
register_regularizer(
    "low_rank_diag",
    _low_rank_diag,
    "structured Zhang-Yeung: Sigma = U diag(s) U^T + diag(d) via rank-r "
    "subspace iteration — O(m*r) storage, no m x m eigh; exact at r = m",
)
register_regularizer(
    "graphical_lasso",
    _graphical_lasso,
    "learned sparse task graph (arXiv:1802.03830): soft-thresholded "
    "coupling stored as diagonal + ELL sparse rows; PSD by diagonal "
    "compensation, dense-equal at penalty=0",
)
