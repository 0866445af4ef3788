"""Pluggable local-SDCA solver backends.

The trainer (core/dmtrl.py) reaches the local subproblem (paper
Algorithm 2) through this registry: a config names a backend
(``DMTRLConfig.solver``), the trainer resolves it with ``get_backend`` and
builds a solver with ``backend.make``. All backends share the contract

    solve(x, y, alpha, W, n, sigma_diag, keys) -> (dalpha, r)

acting on ALL tasks at once (x (m, n_max, d), alpha (m, n_max), W (m, d),
n and sigma_diag (m,), keys (m, 2)), with each task's H coordinate draws
derived from its key exactly as ``sdca.sample_coords`` does — so every
backend produces the SAME sampled coordinate order and (up to float-op
ordering) the same iterate sequence, and the same as the JAX package's
backend of the same name. ``make`` is the draw (``draw_uniform``: each
task's H uniforms from its key) followed by ``backend.make_from_uniform``'s
solve, which takes those uniforms (m, H) in place of the keys; the
single-process trainer calls the two apart, deriving the keys and drawing
in one step (``draw_task_uniform``: one kernel launch on the card), so its
trace times the draw on its own.

Registered backends (the names are the JAX package's, so its configs run
unchanged):

  naive        literal Algorithm 2, one coordinate per step (oracle).
  block_gram   torch block-Gram form: same iterates, batched matmuls.
  pallas_block the per-block Hopper kernel (csrc/sdca_block.cu): one launch
               per H-block for all tasks; rows gathered, deltas scattered
               and ``r`` updated in torch around it.
  pallas_round the fused Hopper round kernel (csrc/sdca_round.cu): ALL H/B
               blocks of every task in one launch, ``w``/``r`` resident in
               shared memory, coordinate sampling on the device.

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
from .losses import Loss
from .sdca import (
    coords_from_uniform,
    gather_rows,
    kappa_of,
    local_sdca_block,
    local_sdca_naive,
)

Tensor = torch.Tensor

# solve(x, y, alpha, W, n, sigma_diag, keys) -> (dalpha, r); the solvers of
# make_from_uniform take the (m, H) uniforms u in place of the keys
Solver = Callable[..., Tuple[Tensor, Tensor]]


def draw_uniform(keys: Tensor, H: int, device) -> Tensor:
    """Each task's H uniforms in [0, 1) from its key (m, 2) -> (m, H): the
    stream ``sdca.sample_coords`` maps to coordinates."""
    return prng.uniform(keys, (H,), device=device)


def draw_task_uniform(key: Tensor, tids: Tensor, pod: int, H: int, device) -> Tensor:
    """Each task's H uniforms of one round from the round key (2,): task t
    draws from ``fold_in(fold_in(key, tids[t]), pod)``, the JAX package's
    per-task keys -> (m, H). On a CUDA device one kernel launch derives the
    keys and draws (``kernels.prng.threefry_draw``, bit-equal); elsewhere
    ``prng``'s torch ops do, on ``tids``' device."""
    if torch.device(device).type == "cuda":
        from ..kernels.prng import threefry_draw  # lazy: kernel layer

        return threefry_draw(key, tids.to(device=device, dtype=torch.int32), pod, H)
    keys = prng.fold_in(prng.fold_in(key.to(tids.device), tids), pod)  # (m, 2)
    return draw_uniform(keys, H, device)


@dataclasses.dataclass(frozen=True)
class SolverBackend:
    """A named way to run every task's local SDCA round."""

    name: str
    description: str
    # H must be rounded up to a multiple of the block size
    block_aligned: bool
    # make_from_uniform(loss, rho, lam, H, block=...) -> Solver on uniforms
    make_from_uniform: Callable[..., Solver]
    # kernel launches per local round for given (H, block); the JAX name
    # is kept because configs and benches read it
    pallas_calls: Callable[[int, int], int] = lambda H, block: 0
    # the solve body launches a hand-written kernel
    uses_pallas: bool = False
    # span_args(x, loss_name, block) -> labels of the solve's span: what the
    # solve launches on these rows (``local_sdca``)
    span_args: Callable[[Tensor, str, int], dict] = lambda x, loss_name, block: {}

    def make(self, loss: Loss, rho: float, lam: float, H: int, block: int = 64) -> Solver:
        """The solver on per-task keys: the draw, then the solve."""
        solve_u = self.make_from_uniform(loss, rho, lam, H, block=block)

        def solve(x, y, alpha, W, n, sigma_diag, keys):
            return solve_u(x, y, alpha, W, n, sigma_diag, draw_uniform(keys, H, x.device))

        return solve

    def round_local_iters(self, H: int, block: int) -> int:
        """Round H up to this backend's alignment requirement."""
        if self.block_aligned:
            return int(math.ceil(H / block)) * block
        return H

    def pallas_calls_per_round(self, H: int, block: int) -> int:
        return self.pallas_calls(self.round_local_iters(H, block), block)


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
        # the kernel maps the key-derived uniform stream to coordinates
        # on the device with sample_coords' exact arithmetic
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
        pallas_calls=lambda H, block: H // block,
        uses_pallas=True,
    )
)
register_backend(
    SolverBackend(
        name="pallas_round",
        description="fused Hopper round kernel: all H/B blocks of every task "
        "in one launch, w/r in shared memory, on-device coordinate sampling",
        block_aligned=True,
        make_from_uniform=_make_pallas_round,
        pallas_calls=lambda H, block: 1,
        uses_pallas=True,
        span_args=_pallas_round_span_args,
    )
)
