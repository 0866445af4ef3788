"""What the port's examples share: the ``--device`` flag, the data mesh of
a ``torchrun`` world, the LM kernels' launch counts, and the JSON line an
example prints last (its ``main``'s dict).

Not an example itself; the examples import it from their own directory.
"""
import contextlib
import json
import os

import torch.distributed as dist


def add_device(ap):
    """``--device``: the card unless the caller asks for the CPU. Without a
    card, "cuda" raises (``resolve_device``); nothing falls back."""
    ap.add_argument("--device", default="cuda",
                    help='"cuda" (the default: the card) or "cpu"')
    return ap


@contextlib.contextmanager
def data_mesh(device):
    """Yield ``(mesh, rank)``: the ``data`` axis over every rank of a
    ``torch.distributed`` world, else the local one-position mesh.

    Under ``torchrun`` (``WORLD_SIZE`` in the environment) the group is
    made here, nccl on the card and gloo on the CPU, and destroyed on
    exit; a world the caller already made is used as it is.
    """
    from repro_torch.core import local_mesh, make_mesh

    owned = not dist.is_initialized() and "WORLD_SIZE" in os.environ
    if owned:
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    try:
        if dist.is_initialized():
            world = dist.get_world_size()
            yield make_mesh((world,), ("data",), device=device.type), dist.get_rank()
        else:
            yield local_mesh(device=device), 0
    finally:
        if owned:
            dist.destroy_process_group()


def kernel_launches() -> dict:
    """Launches of the LM kernels in this process so far (each wrapper
    counts where it launches its CUDA kernel: 0 on the CPU)."""
    from repro_torch.kernels.flash import flash_kernel
    from repro_torch.kernels.ssd import ssd_kernel

    return {"K3": flash_kernel.flash_attention.launches,
            "K3-bwd": flash_kernel.flash_attention_bwd.launches,
            "K4": ssd_kernel.ssd_chunk_kernel.launches,
            "K4-bwd": ssd_kernel.ssd_chunk_bwd_kernel.launches}


def emit(out: dict) -> None:
    """Print ``main``'s dict as the last line (rank 0 only)."""
    if out.get("rank", 0) == 0:
        print(json.dumps(out), flush=True)

