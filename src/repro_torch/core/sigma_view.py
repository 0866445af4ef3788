"""SigmaView — structured task-covariance representations.

At m=16 tasks the m x m Sigma is trivial; at thousands of tasks (one task
per cohort or tenant) a dense Sigma is 4 bytes * m^2 and the
eigendecomposition behind the Zhang-Yeung Omega-step is O(m^3). The
trainer and the serve path never need the dense matrix though: between
them they consume exactly

    diag()           per-task sigma_ii for the local SDCA subproblems
    matvec(V)        Sigma @ V — the server reduce (W += Sigma dB / lam),
                     weights_from_alpha and the duality-gap quad term
    rows(idx)        a few gathered rows (serve tiles)
    logdet_bound()   a cheap upper bound for diagnostics
    rho bounds       Lemma 10 / spectral aggregation safety bounds

``SigmaView`` names that contract. Three members, the JAX package's
``repro.core.sigma_view`` in torch:

  DenseSigma        wraps an (m, m) tensor — the small-m member.
  LowRankDiagSigma  Sigma = U C U^T + diag(d) with U (m, r), C (r, r),
                    d (m,): O(m r) storage, O(m r) matvec. Produced by the
                    ``low_rank_diag`` regularizer's subspace-iteration
                    Omega-step; the matrix-determinant lemma gives an exact
                    logdet and Woodbury an (approximate) precision.
  SparseSigma       diagonal + ELL-packed sparse off-diagonal coupling
                    (cols/vals (m, k_max), zero-padded rows): the
                    graph-sparse member of arXiv:1802.03830 with O(nnz)
                    storage/matvec and exact Lemma-10 row sums.

``factors()``/``view_from_factors`` define the structured snapshot wire
format (numpy leaves + a ``kind`` tag), the same dicts the JAX package
writes — so a view fitted there crosses over as its factors.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

Tensor = torch.Tensor

# results materialize dense (sigma, omega) tensors only up to this many
# tasks; above it they carry the structured view itself
MATERIALIZE_LIMIT = 4096
# SparseSigma.precision() densifies; refuse beyond this
_PRECISION_DENSE_LIMIT = 4096


def _arange(n: int, like: Tensor) -> Tensor:
    return torch.arange(n, dtype=torch.int64, device=like.device)


class SigmaView:
    """Contract every Sigma representation implements. Members are frozen
    dataclasses whose fields are their tensors."""

    kind: str = "?"

    @property
    def m(self) -> int:
        raise NotImplementedError

    def diag(self) -> Tensor:
        raise NotImplementedError

    def matvec(self, v: Tensor) -> Tensor:
        """Sigma @ v for v of shape (m,) or (m, k)."""
        raise NotImplementedError

    def rows(self, idx: Tensor) -> Tensor:
        """Dense gathered rows Sigma[idx, :], shape (len(idx), m)."""
        raise NotImplementedError

    def dense(self) -> Tensor:
        return self.rows(_arange(self.m, self.diag()))

    def trace(self) -> Tensor:
        return torch.sum(self.diag())

    def nbytes(self) -> int:
        """Persistent storage of the representation (the factors)."""
        return int(sum(
            getattr(self, f.name).nbytes for f in dataclasses.fields(self)
        ))

    def logdet_bound(self) -> float:
        """An upper bound on logdet(Sigma) (exact where cheap)."""
        raise NotImplementedError

    def col_block_matvec(self, lo: int, db: Tensor) -> Tensor:
        """Sigma[:, lo:lo+k] @ db for db (k, d) — one worker's commit
        reduce (Sigma symmetric => equals Sigma[lo:lo+k, :].T @ db)."""
        raise NotImplementedError

    def pad(self, m_new: int, jitter: float) -> "SigmaView":
        """Embed into m_new >= m tasks; padded tasks get an inert
        jitter-scaled diagonal."""
        raise NotImplementedError

    def unpad(self, m_true: int) -> "SigmaView":
        """Drop padded tasks again (rows [m_true:] must be decoupled)."""
        raise NotImplementedError

    def precision(self) -> Optional["SigmaView"]:
        """Sigma^{-1} where representable, else None."""
        return None

    # -- rho safety bounds (must be UPPER bounds; see core/omega.py) --------
    def rho_lemma10(self, eta: float = 1.0) -> Tensor:
        raise NotImplementedError

    # exact spectral rho densifies + eighs; do that only up to this size
    _SPECTRAL_EXACT_LIMIT = 2048

    def rho_spectral(self, eta: float = 1.0, iters: int = 24) -> Tensor:
        """eta * lambda_max(D^-1/2 Sigma D^-1/2): exact (dense eigvalsh) at
        small m; beyond that a power-iteration estimate with a safety
        factor, clamped into [eta, rho_lemma10] so it stays a valid upper
        bound (Lemma 10 always is; the rescaled lambda_max is always >= 1
        for PSD Sigma with positive diagonal)."""
        dd = torch.sqrt(torch.clamp(self.diag(), min=1e-30))
        if self.m <= self._SPECTRAL_EXACT_LIMIT:
            S = self.dense() / (dd[:, None] * dd[None, :])
            ev = torch.linalg.eigvalsh(0.5 * (S + S.T))
            return eta * ev[-1]
        v = torch.ones((self.m,), dtype=dd.dtype, device=dd.device) / float(self.m) ** 0.5
        for _ in range(iters):
            v = self.matvec(v / dd) / dd
            v = v / torch.clamp(torch.linalg.norm(v), min=1e-30)
        lam = torch.dot(v, self.matvec(v / dd) / dd)
        est = eta * lam * 1.05  # power iteration under-estimates from below
        hi = self.rho_lemma10(eta)
        return torch.clamp(est, min=torch.full_like(hi, eta), max=hi)

    def factors(self) -> Dict[str, object]:
        """Wire format: numpy leaves + the member tag."""
        out = {"kind": self.kind}
        for f in dataclasses.fields(self):
            out[f.name] = getattr(self, f.name).detach().cpu().numpy()
        return out


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

    def rows(self, idx: Tensor) -> Tensor:
        return self.sigma[idx]

    def dense(self) -> Tensor:
        return self.sigma

    def col_block_matvec(self, lo: int, db: Tensor) -> Tensor:
        return self.sigma[lo : lo + db.shape[0]].T @ db

    def logdet_bound(self) -> float:
        ev = torch.linalg.eigvalsh(self.sigma)
        return float(torch.sum(torch.log(torch.clamp(ev, min=1e-30))))

    def pad(self, m_new: int, jitter: float) -> "DenseSigma":
        padn = m_new - self.m
        if not padn:
            return self
        s = self.sigma.new_zeros((m_new, m_new))
        s[: self.m, : self.m] = self.sigma
        s[self.m :, self.m :] = torch.eye(padn, dtype=s.dtype, device=s.device) * jitter
        return DenseSigma(s)

    def unpad(self, m_true: int) -> "DenseSigma":
        return DenseSigma(self.sigma[:m_true, :m_true])

    def precision(self) -> "DenseSigma":
        ev, Q = torch.linalg.eigh(0.5 * (self.sigma + self.sigma.T))
        ev = torch.clamp(ev, min=1e-30)
        om = (Q * (1.0 / ev)) @ Q.T
        return DenseSigma(0.5 * (om + om.T))

    def rho_lemma10(self, eta: float = 1.0) -> Tensor:
        dd = torch.clamp(self.diag(), min=1e-30)
        return eta * torch.max(torch.sum(torch.abs(self.sigma), dim=1) / dd)


@dataclasses.dataclass(frozen=True)
class LowRankDiagSigma(SigmaView):
    """Sigma = U C U^T + diag(d): O(m r) storage, O(m r) matvec.

    ``C`` is a small (r, r) symmetric core (a diagonal eigenvalue core for
    the low_rank_diag Omega-step; a full negative-definite correction for
    the Woodbury precision).
    """

    U: Tensor  # (m, r)
    core: Tensor  # (r, r)
    d: Tensor  # (m,)
    kind = "low_rank_diag"

    @property
    def m(self) -> int:
        return int(self.U.shape[0])

    @property
    def rank(self) -> int:
        return int(self.U.shape[1])

    def diag(self) -> Tensor:
        return torch.sum((self.U @ self.core) * self.U, dim=1) + self.d

    def matvec(self, v: Tensor) -> Tensor:
        proj = self.core @ (self.U.T @ v)
        if v.ndim == 1:
            return self.U @ proj + self.d * v
        return self.U @ proj + self.d[:, None] * v

    def rows(self, idx: Tensor) -> Tensor:
        out = (self.U[idx] @ self.core) @ self.U.T
        out[_arange(idx.shape[0], out), idx] += self.d[idx]
        return out

    def col_block_matvec(self, lo: int, db: Tensor) -> Tensor:
        hi = lo + db.shape[0]
        out = self.U @ (self.core @ (self.U[lo:hi].T @ db))
        out[lo:hi] += self.d[lo:hi, None] * db
        return out

    def logdet_bound(self) -> float:
        # matrix determinant lemma: logdet(D) + logdet(I_r + C U^T D^-1 U)
        d = torch.clamp(self.d, min=1e-30)
        eye = torch.eye(self.rank, dtype=self.U.dtype, device=self.U.device)
        inner = eye + self.core @ (self.U.T @ (self.U / d[:, None]))
        _, ld = torch.linalg.slogdet(inner)
        return float(torch.sum(torch.log(d)) + ld)

    def pad(self, m_new: int, jitter: float) -> "LowRankDiagSigma":
        padn = m_new - self.m
        if not padn:
            return self
        U = self.U.new_zeros((m_new, self.rank))
        U[: self.m] = self.U
        d = self.d.new_full((m_new,), jitter)
        d[: self.m] = self.d
        return LowRankDiagSigma(U, self.core, d)

    def unpad(self, m_true: int) -> "LowRankDiagSigma":
        return LowRankDiagSigma(self.U[:m_true], self.core, self.d[:m_true])

    def precision(self) -> "LowRankDiagSigma":
        """Woodbury: (U C U^T + D)^-1 = D^-1 - D^-1 U (C^-1 + U^T D^-1 U)^-1
        U^T D^-1. Exact when the factorization is exact (r = m); directions
        with (near-)zero core eigenvalues degrade gracefully to D^-1."""
        d = torch.clamp(self.d, min=1e-30)
        Ud = self.U / d[:, None]
        eye = torch.eye(self.rank, dtype=self.core.dtype, device=self.core.device)
        inner = torch.linalg.inv(self.core + eye * 1e-30) + self.U.T @ Ud
        corr = -torch.linalg.inv(0.5 * (inner + inner.T))
        return LowRankDiagSigma(Ud, 0.5 * (corr + corr.T), 1.0 / d)

    # exact Lemma-10 row sums are O(m^2 r) flops; compute them (blockwise,
    # never materializing (m, m)) up to this many tasks, fall back to the
    # O(m r) factored over-bound beyond it (looser rho = smaller, still
    # safe, aggregation steps)
    _RHO_EXACT_LIMIT = 8192

    def rho_lemma10(self, eta: float = 1.0) -> Tensor:
        dd = torch.clamp(self.diag(), min=1e-30)
        if self.m <= self._RHO_EXACT_LIMIT:
            best = None
            for lo in range(0, self.m, 1024):
                idx = torch.arange(lo, min(lo + 1024, self.m), device=dd.device)
                ratio = torch.max(torch.sum(torch.abs(self.rows(idx)), dim=1) / dd[idx])
                best = ratio if best is None else torch.maximum(best, ratio)
            return eta * best
        # triangle inequality on the factored rows: sum_j |sigma_ij| <=
        # sum_k |(UC)_ik| * sum_j |U_jk| + d_i  — always >= the exact
        # Lemma-10 value, so still a safe aggregation bound
        UC = torch.abs(self.U @ self.core)
        colabs = torch.sum(torch.abs(self.U), dim=0)
        rowbound = UC @ colabs + self.d
        return eta * torch.max(rowbound / dd)


@dataclasses.dataclass(frozen=True)
class SparseSigma(SigmaView):
    """Diagonal + ELL-packed sparse off-diagonal coupling.

    ``cols``/``vals`` are (m, k_max) with per-row zero padding (val 0,
    col 0): row i couples to tasks cols[i, :nnz_i]. Storage and matvec are
    O(m k_max); the Lemma-10 row sums are exact. Produced by the
    ``graphical_lasso`` member's soft-thresholded coupling estimate
    (arXiv:1802.03830's sparse task graph).
    """

    diag_v: Tensor  # (m,)
    cols: Tensor  # (m, k_max) int32
    vals: Tensor  # (m, k_max)
    kind = "sparse"

    @property
    def m(self) -> int:
        return int(self.diag_v.shape[0])

    @property
    def k_max(self) -> int:
        return int(self.cols.shape[1])

    def diag(self) -> Tensor:
        return self.diag_v

    def matvec(self, v: Tensor) -> Tensor:
        cols = self.cols.long()
        if v.ndim == 1:
            off = torch.einsum("mk,mk->m", self.vals, v[cols])
            return self.diag_v * v + off
        off = torch.einsum("mk,mkj->mj", self.vals, v[cols])
        return self.diag_v[:, None] * v + off

    def rows(self, idx: Tensor) -> Tensor:
        k = idx.shape[0]
        out = self.vals.new_zeros((k, self.m))
        cols = self.cols[idx].long()
        # padding slots are (col 0, val 0): accumulate, never overwrite
        out.index_put_(
            (_arange(k, out)[:, None].expand_as(cols), cols), self.vals[idx],
            accumulate=True,
        )
        out[_arange(k, out), idx] += self.diag_v[idx]
        return out

    def col_block_matvec(self, lo: int, db: Tensor) -> Tensor:
        hi = lo + db.shape[0]
        sub_cols = self.cols[lo:hi].reshape(-1).long()
        contrib = (self.vals[lo:hi, :, None] * db[:, None, :]).reshape(-1, db.shape[1])
        out = db.new_zeros((self.m, db.shape[1])).index_add_(0, sub_cols, contrib)
        out[lo:hi] += self.diag_v[lo:hi, None] * db
        return out

    def logdet_bound(self) -> float:
        # Hadamard's inequality for PSD matrices: det <= prod(diag)
        return float(torch.sum(torch.log(torch.clamp(self.diag_v, min=1e-30))))

    def pad(self, m_new: int, jitter: float) -> "SparseSigma":
        padn = m_new - self.m
        if not padn:
            return self
        dg = self.diag_v.new_full((m_new,), jitter)
        dg[: self.m] = self.diag_v
        cols = self.cols.new_zeros((m_new, self.k_max))
        cols[: self.m] = self.cols
        vals = self.vals.new_zeros((m_new, self.k_max))
        vals[: self.m] = self.vals
        return SparseSigma(dg, cols, vals)

    def unpad(self, m_true: int) -> "SparseSigma":
        return SparseSigma(self.diag_v[:m_true], self.cols[:m_true], self.vals[:m_true])

    def precision(self) -> Optional[DenseSigma]:
        if self.m > _PRECISION_DENSE_LIMIT:
            return None
        return DenseSigma(self.dense()).precision()

    def rho_lemma10(self, eta: float = 1.0) -> Tensor:
        dd = torch.clamp(self.diag_v, min=1e-30)
        rowsum = dd + torch.sum(torch.abs(self.vals), dim=1)
        return eta * torch.max(rowsum / dd)


_KINDS = {
    "dense": DenseSigma,
    "low_rank_diag": LowRankDiagSigma,
    "sparse": SparseSigma,
}


def as_view(sigma) -> SigmaView:
    """Wrap a raw (m, m) tensor or array; pass views through unchanged."""
    if isinstance(sigma, SigmaView):
        return sigma
    return DenseSigma(torch.as_tensor(sigma))


def view_from_factors(factors: Dict[str, object], device=None) -> SigmaView:
    """Decode the ``SigmaView.factors()`` wire format (this package's or the
    JAX package's: the same dicts) into tensors on ``device``."""
    kind = factors["kind"]
    try:
        cls = _KINDS[kind]
    except KeyError as e:
        raise ValueError(f"unknown SigmaView kind {kind!r}") from e
    return cls(**{
        f.name: torch.tensor(np.asarray(factors[f.name]), device=device)
        for f in dataclasses.fields(cls)
    })


def maybe_dense(sigma, limit: int = MATERIALIZE_LIMIT):
    """Materialize a view to a dense tensor when small enough; large views
    (and None) pass through so huge-m results never densify. Tensors and
    arrays come back as tensors."""
    if sigma is None:
        return None
    if isinstance(sigma, SigmaView):
        return sigma.dense() if sigma.m <= limit else sigma
    return torch.as_tensor(sigma)


def result_sigma_omega(sigma, omega, limit: int = MATERIALIZE_LIMIT):
    """Normalize a run's final (sigma, omega) for its result object:
    returns (sigma_out, omega_out, sigma_view). Dense tensors pass through;
    small views materialize (deriving a missing omega from the view's
    precision); huge views stay structured with omega possibly None."""
    if not isinstance(sigma, SigmaView):
        return sigma, omega, None
    view = sigma
    if omega is None and view.m <= limit:
        omega = view.precision()
    return maybe_dense(view, limit), maybe_dense(omega, limit), view
