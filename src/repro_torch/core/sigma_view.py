"""SigmaView — the task-covariance interface the trainer consumes.

The trainer and the objectives never need more of Sigma than

    diag()           per-task sigma_ii for the local SDCA subproblems
    matvec(V)        Sigma @ V — the server reduce (W += Sigma dB / lam),
                     weights_from_alpha and the duality-gap quad term
    dense()          the (m, m) matrix, for results
    rho bounds       Lemma 10 / spectral aggregation safety bounds

``SigmaView`` names that contract. This package has its dense member,
``DenseSigma``; the structured members (low-rank + diagonal, sparse) come
with their regularizers in a later part of the port.
"""
from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor


class SigmaView:
    """Contract every Sigma representation implements."""

    kind: str = "?"

    @property
    def m(self) -> int:
        raise NotImplementedError

    def diag(self) -> Tensor:
        raise NotImplementedError

    def matvec(self, v: Tensor) -> Tensor:
        """Sigma @ v for v of shape (m,) or (m, k)."""
        raise NotImplementedError

    def dense(self) -> Tensor:
        raise NotImplementedError

    # -- rho safety bounds (must be UPPER bounds; see core/omega.py) --------
    def rho_lemma10(self, eta: float = 1.0) -> Tensor:
        raise NotImplementedError

    def rho_spectral(self, eta: float = 1.0) -> Tensor:
        """eta * lambda_max(D^-1/2 Sigma D^-1/2), exact (dense eigvalsh)."""
        dd = torch.sqrt(torch.clamp(self.diag(), min=1e-30))
        S = self.dense() / (dd[:, None] * dd[None, :])
        ev = torch.linalg.eigvalsh(0.5 * (S + S.T))
        return eta * ev[-1]


@dataclasses.dataclass(frozen=True)
class DenseSigma(SigmaView):
    """A dense (m, m) tensor behind the shared interface."""

    sigma: Tensor
    kind = "dense"

    @property
    def m(self) -> int:
        return int(self.sigma.shape[0])

    def diag(self) -> Tensor:
        return torch.diagonal(self.sigma)

    def matvec(self, v: Tensor) -> Tensor:
        return self.sigma @ v

    def dense(self) -> Tensor:
        return self.sigma

    def rho_lemma10(self, eta: float = 1.0) -> Tensor:
        dd = torch.clamp(self.diag(), min=1e-30)
        return eta * torch.max(torch.sum(torch.abs(self.sigma), dim=1) / dd)


def as_view(sigma) -> SigmaView:
    """Wrap a raw (m, m) tensor or array; pass views through unchanged."""
    if isinstance(sigma, SigmaView):
        return sigma
    return DenseSigma(torch.as_tensor(sigma))


def maybe_dense(sigma):
    """A dense tensor for a view, tensor or array; None passes through."""
    if sigma is None:
        return None
    if isinstance(sigma, SigmaView):
        return sigma.dense()
    return torch.as_tensor(sigma)


def result_sigma_omega(sigma, omega):
    """Normalize a run's final (sigma, omega) for its result object:
    returns (sigma_out, omega_out, sigma_view). Dense tensors pass through;
    a view is materialized and returned beside the dense pair."""
    if not isinstance(sigma, SigmaView):
        return sigma, omega, None
    return sigma.dense(), maybe_dense(omega), sigma
