"""Meshes for the LM zoo's sharded train step and the dry run, and the
H100's constants (the JAX package's ``launch/mesh.py``). Functions, not
module constants: importing this module touches no device and no process
group."""
from __future__ import annotations

import contextlib
import math
from typing import Tuple

import torch.distributed as dist

from ..core.distributed import Mesh, make_mesh


def production_layout(multi_pod: bool = False) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(shape, axis names) of the production mesh: (16, 16) ``data`` x
    ``model``, or (2, 16, 16) ``pod`` x ``data`` x ``model``."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    """The (16, 16) ``data`` x ``model`` mesh, or (2, 16, 16) ``pod`` x
    ``data`` x ``model`` when ``multi_pod``, over an initialised
    ``torch.distributed`` world of that many ranks (one per card, e.g. from
    ``torchrun``). Any other world raises and names the size it needs."""
    shape, axes = production_layout(multi_pod)
    need = math.prod(shape)
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else None
    if world != need:
        raise RuntimeError(
            f"the production mesh {dict(zip(axes, shape))} needs a torch.distributed world "
            f"of {need} ranks; "
            + ("none is initialised" if world is None else f"this one has {world}")
        )
    return make_mesh(shape, axes, device=device)


@contextlib.contextmanager
def fake_world(size: int):
    """A ``torch.distributed`` default group of ``size`` ranks on the
    ``fake`` backend, this process its rank 0, for the dry run: every
    collective returns at once and moves nothing. Torch ships the backend
    in ``torch.testing._internal.distributed.fake_pg``. The process must
    have no default group; the fake one is destroyed on exit."""
    if dist.is_initialized():
        raise RuntimeError(f"a default group ({dist.get_backend()}) is initialised: the fake "
                           "world needs a process without one")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_dryrun_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production mesh at rank 0 of the fake world of its size (256,
    or 512 with ``multi_pod``; ``fake_world``): position (0, 0) or (0, 0,
    0), a group per axis over that rank's slice, tensors on ``meta``."""
    shape, axes = production_layout(multi_pod)
    return make_mesh(shape, axes, device="meta")


def make_host_mesh(data: int = 1, model: int = 1, device="cuda") -> Mesh:
    """A ``data`` x ``model`` mesh: the local one-device mesh at (1, 1), else
    over an initialised world of ``data * model`` ranks (tests, examples)."""
    return make_mesh((data, model), ("data", "model"), device=device)


# NVIDIA H100 SXM5 data sheet figures, per card: dense bf16 tensor-core
# FLOP/s (no sparsity), HBM3 bytes/s, and NVLink 4's bytes/s in one
# direction over its 18 links (900 GB/s both ways): the counterpart of the
# JAX package's ICI_BW. The card's power limit lowers what it sustains.
PEAK_FLOPS_BF16 = 989e12
HBM_BYTES = 80e9  # device memory: an H100 SXM's 80 GB of HBM3
HBM_BW = 3.35e12
NVLINK_BW = 450e9
