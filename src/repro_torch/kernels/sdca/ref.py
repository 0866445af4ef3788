"""Plain PyTorch versions of the two SDCA kernels: literal sequential updates.

Both take the task axis as a leading dimension m and recompute the exact
inner products at every step (no Gram shortcut), so they are independent of
the kernels' block-Gram arithmetic. The CPU path runs them, and the card
holds each kernel against them.
"""
from __future__ import annotations

import torch

from ...core.losses import get_loss
from ...core.sdca import coords_from_uniform, naive_steps

Tensor = torch.Tensor


def sdca_block_ref(
    xb: Tensor,  # (m, B, d)
    w: Tensor,  # (m, d)
    r: Tensor,  # (m, d)
    at0: Tensor,  # (m, B)
    y: Tensor,  # (m, B)
    cb: Tensor,  # (m, B) coordinate ids
    kappa: Tensor,  # (m,)
    loss_name: str,
) -> Tensor:
    """Deltas (m, B) of one H-block, one coordinate at a time. A coordinate
    drawn twice in the block sees its own earlier delta through the
    equality mask on ``cb``."""
    loss = get_loss(loss_name)
    xb, w, r_cur = xb.float(), w.float(), r.float()
    deltas = torch.zeros(at0.shape, dtype=torch.float32, device=xb.device)
    for k in range(xb.shape[1]):
        xj = xb[:, k]
        c = (xj * w).sum(-1) + kappa * (xj * r_cur).sum(-1)
        a = kappa * (xj * xj).sum(-1)
        dup = torch.where(cb == cb[:, k : k + 1], deltas, 0.0).sum(-1)
        d = loss.sdca_delta(at0[:, k] + dup, c, a, y[:, k])
        deltas[:, k] = d
        r_cur = r_cur + d[:, None] * xj
    return deltas


def sdca_round_ref(
    x: Tensor,  # (m, n_max, d)
    y: Tensor,  # (m, n_max)
    alpha: Tensor,  # (m, n_max)
    w: Tensor,  # (m, d)
    u: Tensor,  # (m, H) per-round uniform stream
    n_i: Tensor,  # (m,) int
    kappa: Tensor,  # (m,)
    loss_name: str,
):
    """One local round, one coordinate at a time: coordinates
    min(floor(u * n), n - 1) in float32 (row n_max - 1 where n = 0),
    literal Algorithm-2 updates. Returns (dalpha, r) in float32."""
    return naive_steps(
        x.float(), y.float(), alpha.float(), w.float(), kappa,
        coords_from_uniform(u, n_i, x.shape[1]), get_loss(loss_name),
    )
