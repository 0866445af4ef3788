"""Pluggable local-SDCA solver backends.

Every engine reaches the local subproblem (paper Algorithm 2) through this
registry: a config names a backend (``DMTRLConfig.solver``), the engine
resolves it with ``get_backend`` and builds a solver with
``backend.make_from_uniform``. All backends share the contract

    solve(x, y, alpha, W, n, sigma_diag, u) -> (dalpha, r)

acting on ALL tasks at once (x (m, n_max, d), alpha (m, n_max), W (m, d),
n and sigma_diag (m,), u (m, H)). Every engine draws u, each task's H
uniforms of the round, with ``draw_task_uniform``, and every backend maps
them to coordinates as ``sdca.coords_from_uniform`` does: the same
coordinates in every engine and backend, and (up to float-op ordering)
the same iterates as the JAX package's backend of the same name.

Registered backends (the names are the JAX package's, so its configs run
unchanged):

  naive        literal Algorithm 2, one coordinate per step (oracle).
  block_gram   torch block-Gram form: same iterates, batched matmuls.
  pallas_block the per-block Hopper kernel (csrc/sdca_block.cu): one launch
               per H-block for all tasks; rows gathered, deltas scattered
               and ``r`` updated in torch around it.
  pallas_round the Hopper round kernel (csrc/sdca_round.cu): ALL H/B blocks
               of every task in one launch: the Gram triangles over the
               card, then each task's chain on its rows held in shared
               memory (streamed past d = 3008).

The kernel backends run the kernels' plain versions on CPU tensors and for
losses without a closed-form kernel delta (see ``kernels.sdca.ops``), so
every backend is total over the loss registry.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Tuple

import torch

from .. import prng
from ..roofline import analysis as _cost
from .losses import Loss
from .sdca import (
    coords_from_uniform,
    gather_rows,
    kappa_of,
    local_sdca_block,
    local_sdca_naive,
)

Tensor = torch.Tensor

# solve(x, y, alpha, W, n, sigma_diag, u) -> (dalpha, r)
Solver = Callable[..., Tuple[Tensor, Tensor]]


def draw_task_uniform(key: Tensor, tids: Tensor, pod: int, H: int, device) -> Tensor:
    """Each task's H uniforms of one round from the round key (2,): task t
    draws from ``fold_in(fold_in(key, tids[t]), pod)``, the JAX package's
    per-task keys -> (m, H). On a CUDA device K5 (``kernels.prng``) derives
    the keys and draws in one launch, bit-equal to ``prng``'s torch ops,
    which draw elsewhere; ``meta`` gets K5's output shape. A cost counter
    (``roofline.analysis``) counts one K5 by its formula on every device."""
    dev = torch.device(device)

    def draw():
        if dev.type == "cuda":
            from ..kernels.prng import threefry_draw  # lazy: kernel layer

            return threefry_draw(key, tids.to(device=dev, dtype=torch.int32), pod, H)
        if dev.type == "meta":
            return torch.empty((tids.shape[0], H), dtype=torch.float32, device=dev)
        keys = prng.fold_in(prng.fold_in(key.to(tids.device), tids), pod)
        return prng.uniform(keys, (H,), device=dev)

    if _cost.ACTIVE is None:
        return draw()
    from ..kernels.prng import threefry_cost  # lazy: kernel layer

    return _cost.ACTIVE.launch("K5", threefry_cost(tids.shape[0], H), draw)


@dataclasses.dataclass(frozen=True)
class SolverBackend:
    """A named way to run every task's local SDCA round."""

    name: str
    description: str
    # H must be rounded up to a multiple of the block size
    block_aligned: bool
    # make_from_uniform(loss, rho, lam, H, block=...) -> Solver on uniforms
    make_from_uniform: Callable[..., Solver]
    # the solve body launches a hand-written kernel
    uses_pallas: bool = False
    # span_args(x, loss_name, block) -> labels of the solve's span: what the
    # solve launches on these rows (``local_sdca``)
    span_args: Callable[[Tensor, str, int], dict] = lambda x, loss_name, block: {}

    def round_local_iters(self, H: int, block: int) -> int:
        """Round H up to this backend's alignment requirement."""
        if self.block_aligned:
            return int(math.ceil(H / block)) * block
        return H


_REGISTRY: Dict[str, SolverBackend] = {}


def register_backend(backend: SolverBackend) -> SolverBackend:
    _REGISTRY[backend.name] = backend
    return backend


def get_backend(name: str) -> SolverBackend:
    try:
        return _REGISTRY[name]
    except KeyError as e:
        raise KeyError(
            f"unknown solver backend {name!r}; have {sorted(_REGISTRY)}"
        ) from e


def available_backends() -> Dict[str, SolverBackend]:
    return dict(sorted(_REGISTRY.items()))


# ---------------------------------------------------------------------------
# naive — literal Algorithm 2 (reference semantics)
# ---------------------------------------------------------------------------
def _make_naive(
    loss: Loss,
    rho: float,
    lam: float,
    H: int,
    block: int = 64,
) -> Solver:

    def solve(x, y, alpha, W, n, sigma_diag, u):
        coords = coords_from_uniform(u, n, x.shape[1])
        return local_sdca_naive(x, y, alpha, W, n, sigma_diag, coords, rho, lam, loss)

    return solve


# ---------------------------------------------------------------------------
# block_gram — torch block-Gram form
# ---------------------------------------------------------------------------
def _make_block_gram(
    loss: Loss,
    rho: float,
    lam: float,
    H: int,
    block: int = 64,
) -> Solver:

    def solve(x, y, alpha, W, n, sigma_diag, u):
        coords = coords_from_uniform(u, n, x.shape[1])
        return local_sdca_block(
            x, y, alpha, W, n, sigma_diag, coords, rho, lam, loss, block=block
        )

    return solve


# ---------------------------------------------------------------------------
# pallas_block — per-block Hopper kernel (one launch per H-block)
# ---------------------------------------------------------------------------
def _make_pallas_block(
    loss: Loss,
    rho: float,
    lam: float,
    H: int,
    block: int = 64,
) -> Solver:
    from ..kernels.sdca import ops as sdca_ops  # lazy: kernel layer

    def solve(x, y, alpha, W, n, sigma_diag, u):
        coords = coords_from_uniform(u, n, x.shape[1])
        kappa = kappa_of(rho, lam, n, sigma_diag)
        dalpha = torch.zeros_like(alpha)
        r = torch.zeros_like(W)
        for b in range(H // block):
            cb = coords[:, b * block : (b + 1) * block]
            xb = gather_rows(x, cb)  # (m, B, d)
            at0 = torch.gather(alpha, 1, cb) + torch.gather(dalpha, 1, cb)
            deltas = sdca_ops.sdca_block_apply(
                xb, W, r, at0, torch.gather(y, 1, cb), cb, kappa, loss.name
            )
            dalpha.scatter_add_(1, cb, deltas)  # duplicates accumulate
            r = r + torch.bmm(xb.transpose(1, 2), deltas[:, :, None])[..., 0]
        return dalpha, r

    return solve


# ---------------------------------------------------------------------------
# pallas_round — fused whole-round Hopper kernel (ONE launch)
# ---------------------------------------------------------------------------
def _make_pallas_round(
    loss: Loss,
    rho: float,
    lam: float,
    H: int,
    block: int = 64,
) -> Solver:
    from ..kernels.sdca import ops as sdca_ops  # lazy: kernel layer

    def solve(x, y, alpha, W, n, sigma_diag, u):
        # the kernel maps the uniforms to coordinates on the device with
        # coords_from_uniform's exact arithmetic
        kappa = kappa_of(rho, lam, n, sigma_diag)
        return sdca_ops.sdca_round(
            x, y, alpha, W, u, n, kappa, loss.name, block=block
        )

    return solve


def _pallas_round_span_args(x: Tensor, loss_name: str, block: int) -> dict:
    from ..kernels.sdca import ops as sdca_ops  # lazy: kernel layer

    return sdca_ops.round_span_args(x, loss_name, block)


register_backend(
    SolverBackend(
        name="naive",
        description="literal Algorithm 2: one coordinate per step, d-dim "
        "inner product + axpy each (reference semantics)",
        block_aligned=False,
        make_from_uniform=_make_naive,
    )
)
register_backend(
    SolverBackend(
        name="block_gram",
        description="torch block-Gram form: three batched matmuls per "
        "B-block plus a B-step scalar recursion on the Gram block; same "
        "iterates as naive",
        block_aligned=True,
        make_from_uniform=_make_block_gram,
    )
)
register_backend(
    SolverBackend(
        name="pallas_block",
        description="per-block Hopper kernel: one launch per H-block for all "
        "tasks, w/r read from device memory each block",
        block_aligned=True,
        make_from_uniform=_make_pallas_block,
        uses_pallas=True,
    )
)
register_backend(
    SolverBackend(
        name="pallas_round",
        description="Hopper round kernel: all H/B blocks of every task in one "
        "launch, the Gram triangles over the card, then each task's chain on "
        "its rows held in shared memory (streamed past d = 3008)",
        block_aligned=True,
        make_from_uniform=_make_pallas_round,
        uses_pallas=True,
        span_args=_pallas_round_span_args,
    )
)
