"""Convex losses, their conjugates, and closed-form SDCA coordinate updates.

The paper (Thm. 1) derives the dual of the MTRL W-step for *any* convex loss
``l(z, y)`` with conjugate ``l*(u, y) = sup_z (u z - l(z, y))``.  Local SDCA
(Algorithm 2) maximizes, per sampled coordinate j of task i, the scalar
concave function (after multiplying the local subproblem by ``n_i``):

    f(delta) = -l*(-(atilde + delta)) - c * delta - (a / 2) * delta**2

with
    atilde = alpha_j + dalpha_j                (current dual value)
    c      = w_i^T x_j + kappa * x_j^T r       (current "margin")
    a      = kappa * ||x_j||^2                 (curvature)
    kappa  = rho * sigma_ii / (lambda * n_i)
    r      = X_i^T dalpha_[i]                  (running block correction)

Every loss below supplies the closed-form (or Newton) argmax ``delta``.
All functions are elementwise on tensors, so one call updates a coordinate
of every task at once.

Losses are registered by name so configs stay declarative. Conventions:
 - classification labels y in {-1, +1}; regression y real.
 - ``smoothness mu``: l is (1/mu)-smooth (None => non-smooth).
 - ``lipschitz L``: l is L-Lipschitz (None => not globally Lipschitz).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

Tensor = torch.Tensor

_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class Loss:
    """A convex loss with everything SDCA / duality-gap evaluation needs."""

    name: str
    value: Callable[[Tensor, Tensor], Tensor]          # l(z, y)
    conjugate: Callable[[Tensor, Tensor], Tensor]      # l*(u, y)
    sdca_delta: Callable[[Tensor, Tensor, Tensor, Tensor], Tensor]
    #   sdca_delta(atilde, c, a, y) -> delta maximizing f above.
    dual_feasible: Callable[[Tensor, Tensor], Tensor]  # project alpha into dom(l*(-.))
    subgradient: Callable[[Tensor, Tensor], Tensor]    # an element of dl/dz at z
    smoothness_mu: Optional[float] = None              # l is (1/mu)-smooth
    lipschitz: Optional[float] = None                  # l is L-Lipschitz
    is_classification: bool = True


_REGISTRY: Dict[str, Loss] = {}


def register(loss: Loss) -> Loss:
    _REGISTRY[loss.name] = loss
    return loss


def get_loss(name: str) -> Loss:
    try:
        return _REGISTRY[name]
    except KeyError as e:
        raise KeyError(f"unknown loss {name!r}; have {sorted(_REGISTRY)}") from e


def registered_losses():
    return dict(_REGISTRY)


def _clip(x: Tensor, lo: float, hi: float) -> Tensor:
    return torch.clamp(x, lo, hi)


# ---------------------------------------------------------------------------
# hinge:  l(z) = max(0, 1 - y z).        L = 1 Lipschitz, non-smooth.
#   l*(u) = y u   for  y u in [-1, 0], +inf otherwise
#   => -l*(-alpha) = y alpha, feasible iff y alpha in [0, 1].
# closed form: unconstrained max of  y(atilde+delta) - c delta - a/2 delta^2
#   delta_u = (y - c) / a ; project alpha_new into y*alpha in [0,1].
# ---------------------------------------------------------------------------
def _hinge_value(z, y):
    return torch.clamp(1.0 - y * z, min=0.0)


def _hinge_conj(u, y):
    # l*(u) = u*y on the feasible set; caller is responsible for feasibility
    # (dual iterates produced by _hinge_delta always are).
    return u * y


def _hinge_delta(atilde, c, a, y):
    a = torch.clamp(a, min=_EPS)
    anew = y * _clip(y * (atilde + (y - c) / a), 0.0, 1.0)
    return anew - atilde


def _hinge_feasible(alpha, y):
    return y * _clip(y * alpha, 0.0, 1.0)


def _hinge_subgrad(z, y):
    return torch.where(y * z < 1.0, -y, torch.zeros_like(y))


register(
    Loss(
        name="hinge",
        value=_hinge_value,
        conjugate=_hinge_conj,
        sdca_delta=_hinge_delta,
        dual_feasible=_hinge_feasible,
        subgradient=_hinge_subgrad,
        smoothness_mu=None,
        lipschitz=1.0,
        is_classification=True,
    )
)


# ---------------------------------------------------------------------------
# squared:  l(z) = 0.5 (z - y)^2.   (1/mu)-smooth with mu = 1.
#   l*(u) = 0.5 u^2 + u y   =>  -l*(-alpha) = -0.5 alpha^2 + alpha y
#   delta = (y - c - atilde) / (1 + a)
# ---------------------------------------------------------------------------
def _sq_value(z, y):
    return 0.5 * (z - y) ** 2


def _sq_conj(u, y):
    return 0.5 * u**2 + u * y


def _sq_delta(atilde, c, a, y):
    return (y - c - atilde) / (1.0 + a)


def _sq_feasible(alpha, y):
    return alpha


def _sq_subgrad(z, y):
    return z - y


register(
    Loss(
        name="squared",
        value=_sq_value,
        conjugate=_sq_conj,
        sdca_delta=_sq_delta,
        dual_feasible=_sq_feasible,
        subgradient=_sq_subgrad,
        smoothness_mu=1.0,
        lipschitz=None,
        is_classification=False,
    )
)


# ---------------------------------------------------------------------------
# smoothed hinge (gamma = 0.5):
#   l(z) = 0                      if y z >= 1
#        = 1 - y z - gamma/2      if y z <= 1 - gamma
#        = (1 - y z)^2 / (2 gamma) otherwise
#   (1/gamma)-smooth and 1-Lipschitz.
#   l*(u) = y u + gamma/2 u^2  for y u in [-1, 0]
#   delta_u = (y - c - gamma atilde) / (gamma + a); project y alpha in [0,1].
# ---------------------------------------------------------------------------
_GAMMA = 0.5


def _sh_value(z, y):
    m = 1.0 - y * z
    return torch.where(
        m <= 0.0,
        torch.zeros_like(m),
        torch.where(m >= _GAMMA, m - _GAMMA / 2.0, m**2 / (2.0 * _GAMMA)),
    )


def _sh_conj(u, y):
    return u * y + _GAMMA / 2.0 * u**2


def _sh_delta(atilde, c, a, y):
    anew_u = atilde + (y - c - _GAMMA * atilde) / (_GAMMA + a)
    anew = y * _clip(y * anew_u, 0.0, 1.0)
    return anew - atilde


def _sh_feasible(alpha, y):
    return y * _clip(y * alpha, 0.0, 1.0)


def _sh_subgrad(z, y):
    m = 1.0 - y * z
    return torch.where(
        m <= 0.0,
        torch.zeros_like(m),
        torch.where(m >= _GAMMA, -y, -y * m / _GAMMA),
    )


register(
    Loss(
        name="smoothed_hinge",
        value=_sh_value,
        conjugate=_sh_conj,
        sdca_delta=_sh_delta,
        dual_feasible=_sh_feasible,
        subgradient=_sh_subgrad,
        smoothness_mu=_GAMMA,
        lipschitz=1.0,
        is_classification=True,
    )
)


# ---------------------------------------------------------------------------
# logistic:  l(z) = log(1 + exp(-y z)).  (1/4)-smooth... precisely 4-smooth:
# l'' <= 1/4 so it is (1/mu)-smooth with mu = 4. Also 1-Lipschitz.
#   l*(u): with s = -u y in (0,1):  s log s + (1-s) log(1-s)
#   => -l*(-alpha), s = y alpha in (0,1): binary entropy (negative).
# No closed form => a few guarded Newton steps on
#   f(delta) = -[s log s + (1-s)log(1-s)] - c delta - a/2 delta^2,  s=y(atilde+delta)
#   f'(delta) = -y log(s/(1-s)) - c - a delta
#   f''(delta) = -1/(s(1-s)) - a
# ---------------------------------------------------------------------------
_NEWTON_STEPS = 12
_S_EPS = 1e-6


def _log_value(z, y):
    # numerically stable log(1 + exp(-yz))
    m = -y * z
    return torch.logaddexp(torch.zeros_like(m), m)


def _xlogx(s):
    return torch.where(s > 0.0, s * torch.log(torch.clamp(s, min=_EPS)), torch.zeros_like(s))


def _log_conj(u, y):
    s = _clip(-u * y, 0.0, 1.0)
    return _xlogx(s) + _xlogx(1.0 - s)


def _log_delta(atilde, c, a, y):
    # start from a feasible point (pull atilde inside the open interval)
    a0 = y * _clip(y * atilde, _S_EPS, 1.0 - _S_EPS)
    delta = a0 - atilde
    for _ in range(_NEWTON_STEPS):
        s = _clip(y * (atilde + delta), _S_EPS, 1.0 - _S_EPS)
        g = -y * (torch.log(s) - torch.log1p(-s)) - c - a * delta
        h = -1.0 / (s * (1.0 - s)) - a
        delta_new = delta - g / h
        # keep iterate strictly feasible: y * alpha_new in (0, 1)
        anew = y * _clip(y * (atilde + delta_new), _S_EPS, 1.0 - _S_EPS)
        delta = anew - atilde
    return delta


def _log_feasible(alpha, y):
    return y * _clip(y * alpha, _S_EPS, 1.0 - _S_EPS)


def _log_subgrad(z, y):
    return -y * torch.sigmoid(-y * z)


register(
    Loss(
        name="logistic",
        value=_log_value,
        conjugate=_log_conj,
        sdca_delta=_log_delta,
        dual_feasible=_log_feasible,
        subgradient=_log_subgrad,
        smoothness_mu=4.0,
        lipschitz=1.0,
        is_classification=True,
    )
)


# ---------------------------------------------------------------------------
# epsilon-insensitive:  l(z) = max(0, |z - y| - eps).  1-Lipschitz, non-smooth.
# (used by the paper's PMTL comparison; provided for completeness)
#   l*(u) = u y + eps |u|  for |u| <= 1
#   f(delta) = (atilde+delta) y - eps|atilde+delta| - c delta - a/2 delta^2
# piecewise quadratic in alpha_new = atilde + delta over [-1, 1]:
#   on alpha_new > 0:  opt at (y - eps - c + a atilde)/a
#   on alpha_new < 0:  opt at (y + eps - c + a atilde)/a
# evaluate both candidates (clipped to their half-interval) plus 0, pick best.
# ---------------------------------------------------------------------------
_EPS_TUBE = 0.1


def _ei_value(z, y):
    return torch.clamp(torch.abs(z - y) - _EPS_TUBE, min=0.0)


def _ei_conj(u, y):
    return u * y + _EPS_TUBE * torch.abs(u)


def _ei_obj(anew, atilde, c, a, y):
    delta = anew - atilde
    return anew * y - _EPS_TUBE * torch.abs(anew) - c * delta - 0.5 * a * delta**2


def _ei_delta(atilde, c, a, y):
    atilde, c, a, y = torch.broadcast_tensors(atilde, c, a, y)
    a_ = torch.clamp(a, min=_EPS)
    cand_pos = _clip((y - _EPS_TUBE - c + a_ * atilde) / a_, 0.0, 1.0)
    cand_neg = _clip((y + _EPS_TUBE - c + a_ * atilde) / a_, -1.0, 0.0)
    cands = torch.stack([cand_pos, cand_neg, torch.zeros_like(cand_pos)])
    vals = _ei_obj(cands, atilde, c, a, y)
    # first maximum wins ties, as jnp.argmax
    best = torch.argmax(vals, dim=0, keepdim=True)
    anew = torch.gather(cands, 0, best)[0]
    return anew - atilde


def _ei_feasible(alpha, y):
    return _clip(alpha, -1.0, 1.0)


def _ei_subgrad(z, y):
    d = z - y
    one = torch.ones_like(d)
    return torch.where(d > _EPS_TUBE, one, torch.where(d < -_EPS_TUBE, -one, 0.0 * one))


register(
    Loss(
        name="eps_insensitive",
        value=_ei_value,
        conjugate=_ei_conj,
        sdca_delta=_ei_delta,
        dual_feasible=_ei_feasible,
        subgradient=_ei_subgrad,
        smoothness_mu=None,
        lipschitz=1.0,
        is_classification=False,
    )
)
