"""Explicit feature maps phi(.) (paper Section 4).

The paper recommends explicit feature maps over implicit kernels in the
distributed setting (the n x n multi-task kernel matrix K is never
materializable across workers). Provided maps:

 * linear          -- identity (the paper's experimental choice)
 * rff             -- random Fourier features approximating the RBF kernel
                      (Rahimi & Recht 2007), drawn with a shared seed so all
                      workers use the SAME map without communication; the
                      draws are the JAX package's (``prng``).
 * backbone        -- final-hidden-state features of a backbone model.

A map's ``apply`` runs on the device of the tensor it is given.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List

import numpy as np
import torch

from .. import prng
from .dmtrl import resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class FeatureMap:
    name: str
    dim_out: int
    apply: Callable[[Tensor], Tensor]  # (n, d_in) -> (n, dim_out)


def linear_map(d_in: int) -> FeatureMap:
    return FeatureMap("linear", d_in, lambda x: x)


def rff_map(
    d_in: int, d_out: int, gamma: float = 1.0, seed: int = 0, dtype=torch.float32
) -> FeatureMap:
    """phi(x) = sqrt(2/D) cos(x @ Omega + b), Omega ~ N(0, 2*gamma I).

    Unbiased approximation of k(x,x') = exp(-gamma ||x - x'||^2); the map is
    deterministic given the seed, so geo-distributed workers construct it
    locally with zero communication. Omega and b are drawn on the host
    and moved to each device that ``apply`` sees, once.
    """
    k1, k2 = prng.split(prng.PRNGKey(seed))
    Wm = prng.normal(k1, (d_in, d_out), dtype) * math.sqrt(2.0 * gamma)
    b = prng.uniform(k2, (d_out,), dtype, 0.0, 2.0 * math.pi)
    scale = torch.tensor(math.sqrt(2.0 / d_out), dtype=dtype)
    on_device = {}

    def apply(x):
        dev = x.device
        if dev not in on_device:
            on_device[dev] = tuple(t.to(dev) for t in (Wm, b, scale))
        Wd, bd, sd = on_device[dev]
        return sd * torch.cos(x @ Wd + bd)

    return FeatureMap("rff", d_out, apply)


def backbone_map(forward_fn: Callable[[Tensor], Tensor], dim_out: int) -> FeatureMap:
    """Wrap a backbone's pooled final hidden state as phi."""
    return FeatureMap("backbone", dim_out, forward_fn)


def apply_to_tasks(
    fmap: FeatureMap, xs: List[np.ndarray], device="cuda"
) -> List[np.ndarray]:
    """phi of every task's (n_i, d_in) rows, computed on ``device`` (the
    card unless the caller passes "cpu"), returned as numpy arrays."""
    dev = resolve_device(device)
    return [
        fmap.apply(torch.as_tensor(np.asarray(x), device=dev)).cpu().numpy()
        for x in xs
    ]
