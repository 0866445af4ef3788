"""Meshes for the LM zoo's sharded train step, and the H100's constants
(the JAX package's ``launch/mesh.py``). Functions, not module constants:
importing this module touches no device and no process group."""
from __future__ import annotations

import math

import torch.distributed as dist

from ..core.distributed import Mesh, make_mesh


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    """The (16, 16) ``data`` x ``model`` mesh, or (2, 16, 16) ``pod`` x
    ``data`` x ``model`` when ``multi_pod``, over an initialised
    ``torch.distributed`` world of that many ranks (one per card, e.g. from
    ``torchrun``). Any other world raises and names the size it needs."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else None
    if world != need:
        raise RuntimeError(
            f"the production mesh {dict(zip(axes, shape))} needs a torch.distributed world "
            f"of {need} ranks; "
            + ("none is initialised" if world is None else f"this one has {world}")
        )
    return make_mesh(shape, axes, device=device)


def make_host_mesh(data: int = 1, model: int = 1, device="cuda") -> Mesh:
    """A ``data`` x ``model`` mesh: the local one-device mesh at (1, 1), else
    over an initialised world of ``data * model`` ranks (tests, examples)."""
    return make_mesh((data, model), ("data", "model"), device=device)


# NVIDIA H100 SXM5 data sheet figures, per card: dense bf16 tensor-core
# FLOP/s (no sparsity), HBM3 bytes/s, and NVLink 4's bytes/s in one
# direction over its 18 links (900 GB/s both ways): the counterpart of the
# JAX package's ICI_BW. The card's power limit lowers what it sustains.
PEAK_FLOPS_BF16 = 989e12
HBM_BW = 3.35e12
NVLINK_BW = 450e9
