"""Host-side helpers of the JAX package's mesh engines that the host
transports share (``core/transport.py``, ``core/gossip.py``).

The mesh engines themselves (``fit_distributed``: the data, model and pod
axes, the hoisted Gram, ``gram_bf16``) are not ported; what is here is the
part the threaded, multiprocess and gossip transports need: the axis names,
padding the task count to a multiple of the worker count, and embedding the
real tasks' Sigma/Omega into the padded size.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .sigma_view import SigmaView

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    data: str = "data"  # tasks
    model: Optional[str] = None  # feature dim
    pod: Optional[str] = None  # intra-task samples


@dataclasses.dataclass
class DistributedState:
    """The server state a transport hands back: padded to its task count."""

    alpha: Tensor
    W: Tensor
    # dense (m, m) tensor or a SigmaView
    sigma: object
    # precision; None for structured members without a cheap inverse
    omega: Optional[object]


def _axis_size(mesh, name: Optional[str]) -> int:
    """Size of the mesh axis ``name`` (1 for no axis). ``mesh`` is any
    object with a ``shape`` mapping from axis names to sizes."""
    return mesh.shape[name] if name is not None else 1


def pad_to_multiple(x: int, k: int) -> int:
    return ((x + k - 1) // k) * k


def pad_sigma_blocks(sigma_t: Tensor, omega_t: Tensor, m: int, m_true: int, jitter: float):
    """Embed the real-task Sigma/Omega into padded (m, m) matrices. Padded
    tasks get an inert jitter-scaled identity block so they stay
    decoupled."""
    pad = m - m_true
    if not pad:
        return sigma_t, omega_t
    eye = torch.eye(pad, dtype=sigma_t.dtype, device=sigma_t.device)
    sigma = sigma_t.new_zeros((m, m))
    sigma[:m_true, :m_true] = sigma_t
    sigma[m_true:, m_true:] = eye * jitter
    omega = omega_t.new_zeros((m, m))
    omega[:m_true, :m_true] = omega_t
    omega[m_true:, m_true:] = eye / jitter
    return sigma, omega


def pad_sigma_any(sigma_t, omega_t, m: int, m_true: int, jitter: float):
    """pad_sigma_blocks generalized to SigmaView / missing-omega inputs:
    dense pairs go through pad_sigma_blocks, views pad via their own
    factor-level embedding."""
    if isinstance(sigma_t, SigmaView):
        sigma = sigma_t.pad(m, jitter)
        omega = omega_t.pad(m, 1.0 / jitter) if isinstance(omega_t, SigmaView) else None
        return sigma, omega
    if omega_t is None:
        sigma, _ = pad_sigma_blocks(sigma_t, sigma_t, m, m_true, jitter)
        return sigma, None
    return pad_sigma_blocks(sigma_t, omega_t, m, m_true, jitter)
