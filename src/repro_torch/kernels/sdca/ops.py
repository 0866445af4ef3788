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
  * a kernel loss on CPU tensors runs the plain version;
  * a kernel loss on ``meta`` tensors (the dry run) takes the kernel's
    output shapes; any other device raises.

Under a cost counter (``roofline.analysis``) a kernel loss counts the
kernel once, by its formula (``k1_cost``, ``k2_cost``), on every device.
"""
from __future__ import annotations

import torch

from ...roofline import analysis as _cost
from .ref import sdca_block_ref, sdca_round_ref
from .sdca_kernel import SUPPORTED_LOSSES, sdca_block_kernel, sdca_round_kernel

Tensor = torch.Tensor


def _use_kernel(loss_name: str, t: Tensor) -> bool:
    """Whether a call launches the Hopper kernel: a kernel loss on CUDA
    tensors (CPU and meta tensors take the plain version and the shape
    rule)."""
    if loss_name not in SUPPORTED_LOSSES or t.device.type in ("cpu", "meta"):
        return False
    if t.device.type != "cuda":
        raise ValueError(f"the SDCA kernels run on CPU, CUDA or meta tensors, got {t.device}")
    return True


def _gram_flops(m: int, B: int, d: int, dots: int) -> int:
    """A block's work for every task: the triangle of its B x B Gram the
    recursion reads and ``dots`` B dot products of length d."""
    return 2 * m * (B * (B + 1) // 2 + dots * B) * d


def k1_cost(m: int, n_max: int, d: int, H: int, B: int, itemsize: int) -> tuple:
    """(FLOPs, bytes) of one K1 round: per H-block the Gram triangle, q, xr
    and r; each drawn row (with its alpha and y) read once, as if the H
    draws of a task were distinct (the distinct ones depend on the data),
    w, the uniforms, n and kappa read once, dalpha and r written once."""
    flops = (H // B) * _gram_flops(m, B, d, 3)
    nbytes = m * H * (d * itemsize + 8) + (m * d * 4 + m * H * 4 + m * 8) \
        + (m * n_max * 4 + m * d * 4)
    return flops, nbytes


def k2_cost(m: int, B: int, d: int, itemsize: int) -> tuple:
    """(FLOPs, bytes) of one K2 block: the Gram triangle, q and xr; the
    block's rows, w and r read once, the initial alphas, labels and
    coordinate ids read and the deltas written once, kappa read once."""
    nbytes = m * B * d * itemsize + 2 * m * d * 4 + 4 * m * B * 4 + m * 4
    return _gram_flops(m, B, d, 2), nbytes


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
    args = (xb, w, r, at0, y, cb, kappa, loss_name)
    if loss_name not in SUPPORTED_LOSSES:
        return sdca_block_ref(*args)
    c = _cost.ACTIVE
    if c is not None:
        m, B, d = xb.shape
        return c.launch("K2", k2_cost(m, B, d, xb.element_size()), _block, *args)
    return _block(*args)


def _block(xb, w, r, at0, y, cb, kappa, loss_name):
    if _use_kernel(loss_name, xb):
        return sdca_block_kernel(
            *_dense(xb, w, r, at0, y, cb.to(torch.int32), kappa), loss_name
        )
    if xb.device.type == "meta":
        return torch.empty(at0.shape, dtype=torch.float32, device=xb.device)
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
    args = (x, y, alpha, w, u, n_i, kappa, loss_name, block)
    if loss_name not in SUPPORTED_LOSSES:
        return sdca_round_ref(*args[:8])
    c = _cost.ACTIVE
    if c is not None:
        m, n_max, d = x.shape
        return c.launch("K1", k1_cost(m, n_max, d, u.shape[1], block, x.element_size()),
                        _round, *args)
    return _round(*args)


def _round(x, y, alpha, w, u, n_i, kappa, loss_name, block):
    if _use_kernel(loss_name, x):
        return sdca_round_kernel(
            *_dense(x, y, alpha, w, u, n_i.to(torch.int32), kappa), loss_name,
            block=block,
        )
    if x.device.type == "meta":
        m, n_max, d = x.shape
        f32 = torch.float32
        return (torch.zeros((m, n_max), dtype=f32, device=x.device),
                torch.zeros((m, d), dtype=f32, device=x.device))
    return sdca_round_ref(x, y, alpha, w, u, n_i, kappa, loss_name)
