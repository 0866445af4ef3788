"""Entry points for the SDCA kernels, used by the solver-backend registry
(repro_torch.core.solver_backends):

  * ``sdca_block_apply``  — one H-block of sampled coordinates for all
    tasks; backs the ``pallas_block`` backend (one launch per block).
  * ``sdca_round``        — one fused local round for all tasks (all H/B
    blocks in a single launch); backs the ``pallas_round`` backend.

Routing, by loss and by the tensors' device:
  * a loss outside ``SUPPORTED_LOSSES`` (no closed-form delta in the
    kernel: logistic, eps_insensitive) runs the plain version on any device;
  * a kernel loss on CUDA tensors launches the Hopper kernel, or raises;
  * a kernel loss on CPU tensors runs the plain version.
"""
from __future__ import annotations

import torch

from .ref import sdca_block_ref, sdca_round_ref
from .sdca_kernel import SUPPORTED_LOSSES, sdca_block_kernel, sdca_round_kernel

Tensor = torch.Tensor


def _use_kernel(loss_name: str, t: Tensor) -> bool:
    if loss_name not in SUPPORTED_LOSSES or t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"the SDCA kernels run on CPU or CUDA tensors, got {t.device}")
    return True


def _dense(*tensors: Tensor):
    """The kernels take dense row-major tensors (W(alpha) is a transposed
    view, for one); copy only what is not."""
    return [t.contiguous() for t in tensors]


def sdca_block_apply(
    xb: Tensor,  # (m, B, d) sampled rows
    w: Tensor,  # (m, d)
    r: Tensor,  # (m, d) running block correction
    at0: Tensor,  # (m, B) initial alpha~ per slot
    y: Tensor,  # (m, B)
    cb: Tensor,  # (m, B) coordinate ids (duplicate detection)
    kappa: Tensor,  # (m,)
    loss_name: str,
) -> Tensor:
    """Deltas (m, B) for ONE block; the caller scatters them and updates r."""
    if _use_kernel(loss_name, xb):
        return sdca_block_kernel(
            *_dense(xb, w, r, at0, y, cb.to(torch.int32), kappa), loss_name
        )
    return sdca_block_ref(xb, w, r, at0, y, cb, kappa, loss_name)


def sdca_round(
    x: Tensor,  # (m, n_max, d) task blocks
    y: Tensor,  # (m, n_max)
    alpha: Tensor,  # (m, n_max)
    w: Tensor,  # (m, d)
    u: Tensor,  # (m, H) per-round uniform streams
    n_i: Tensor,  # (m,) int
    kappa: Tensor,  # (m,)
    loss_name: str,
    block: int = 64,
):
    """(dalpha, r) of one fused local round for every task."""
    if _use_kernel(loss_name, x):
        return sdca_round_kernel(
            *_dense(x, y, alpha, w, u, n_i.to(torch.int32), kappa), loss_name,
            block=block,
        )
    return sdca_round_ref(x, y, alpha, w, u, n_i, kappa, loss_name)
