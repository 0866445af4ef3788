"""Pluggable Omega-regularizer family (the paper's general dual form).

The paper's dual derivation (Thm. 1) never uses the *specific* Zhang-Yeung
trace-constrained Omega: any symmetric PD task-coupling Sigma yields the
same dual problem, local subproblems, and rho-bounded aggregation. What
distinguishes family members is only

  * how Sigma is INITIALIZED,
  * whether/how Sigma is UPDATED after each W-step (Algorithm 1 row 11),
  * the rho upper bound fed to the local subproblems (Lemma 10 / spectral
    both apply to any PD Sigma, so the default bound is shared).

Registered members:

  trace_constraint  the paper / Zhang & Yeung (2010): closed-form
                    Sigma = (W^T W)^{1/2} / tr((W^T W)^{1/2}) after every
                    W-step (core/omega.py:omega_step). The default.
  identity_stl      Sigma fixed at I/m — independent ridge-regularized
                    tasks; subsumes ``DMTRLConfig.learn_omega=False``.

The JAX package's other members (graph_laplacian, frobenius_shrunk,
low_rank_diag, graphical_lasso) are not ported yet; naming one raises.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from . import omega as omega_mod
from .sigma_view import SigmaView

Tensor = torch.Tensor

_NOT_PORTED = ("graph_laplacian", "frobenius_shrunk", "low_rank_diag", "graphical_lasso")


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
    """Resolve a family member by name, configured with member params."""
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"omega regularizer {name!r} is not ported yet; have {sorted(_REGISTRY)}"
        )
    try:
        factory = _REGISTRY[name]
    except KeyError as e:
        raise KeyError(
            f"unknown omega regularizer {name!r}; have {sorted(_REGISTRY)}"
        ) from e
    return factory(**params)


def available_regularizers() -> Dict[str, str]:
    return dict(sorted(_DESCRIPTIONS.items()))


def resolve_regularizer(cfg, regularizer=None) -> OmegaRegularizer:
    """Resolve the regularizer a run should use.

    Precedence: an explicit ``regularizer`` argument (instance or name) >
    legacy ``cfg.learn_omega=False`` (maps to identity_stl) >
    ``cfg.omega_regularizer``. ``cfg`` is duck-typed: only
    ``learn_omega`` / ``omega_regularizer`` are read.
    """
    if regularizer is not None:
        if isinstance(regularizer, str):
            regularizer = get_regularizer(regularizer)
        if not isinstance(regularizer, OmegaRegularizer):
            raise TypeError(
                f"regularizer must be a name or OmegaRegularizer instance, "
                f"got {type(regularizer).__name__}"
            )
        if not getattr(cfg, "learn_omega", True) and regularizer.learns:
            raise ValueError(
                f"learn_omega=False conflicts with the learning regularizer "
                f"{regularizer.name!r}; drop learn_omega or pick a fixed member"
            )
        return regularizer
    if not getattr(cfg, "learn_omega", True):
        return get_regularizer("identity_stl")
    return get_regularizer(getattr(cfg, "omega_regularizer", "trace_constraint"))


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
