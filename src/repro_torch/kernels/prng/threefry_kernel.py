"""A round's coordinate uniforms on the card in one launch, bound with ctypes.

``threefry_draw`` — csrc/threefry_draw.cu: every task's key
``fold_in(fold_in(key, tids[t]), pod)`` and its H uniforms in [0, 1), bit-equal
to ``prng.uniform(prng.fold_in(prng.fold_in(key, tids), pod), (H,))``. It
replaces no TPU kernel (the JAX package draws with ``jax.random`` inside its
jitted round); it replaces the port's int64 torch emulation of that hash,
some 300 host operations a round.

The ``.cu`` file has a plain C interface and is compiled on first use by
``repro_torch.kernels.nvcc``. The wrapper checks its inputs, allocates the
output, launches on PyTorch's current stream, raises if the launch returned
a CUDA error, and only then adds one to ``threefry_draw.launches``. The
plain version is ``prng``'s composition above, which
``core.solver_backends.draw_task_uniform`` takes off the card.
"""
from __future__ import annotations

import threading
from pathlib import Path

import torch

from ..nvcc import INT, U32, VP, check_tensor, launcher, raise_on

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "threefry_draw.cu",)
_ARGTYPES = [U32, U32, VP, U32, VP, INT, INT, VP]
_MASK = 0xFFFFFFFF
_COUNT_LOCK = threading.Lock()


def threefry_cost(m: int, H: int) -> tuple:
    """(FLOPs, bytes) of one launch: integer hashing only, so no FLOPs; the
    task ids read and the (m, H) float32 uniforms written once."""
    return 0, m * H * 4 + m * 4


def threefry_draw(key: torch.Tensor, tids: torch.Tensor, pod: int, H: int) -> torch.Tensor:
    """(m, H) float32 uniforms on ``tids``' CUDA device: row t from the key
    ``fold_in(fold_in(key, tids[t]), pod)``. ``key`` (2,) int64 lies on the
    CPU, so reading its words costs no device sync; ``tids`` (m,) int32."""
    if tids.device.type != "cuda":
        raise ValueError(f"threefry_draw runs on CUDA tensors, got tids on {tids.device}")
    if key.device.type != "cpu" or tuple(key.shape) != (2,):
        raise ValueError(f"the key must be one (2,) key on the CPU, got {tuple(key.shape)} "
                         f"on {key.device}")
    m, dev = tids.shape[0], tids.device
    check_tensor("tids", tids, (m,), torch.int32, dev)
    if m < 1 or H < 1:
        raise ValueError(f"threefry_draw needs m >= 1 and H >= 1, got m={m}, H={H}")
    k0, k1 = (int(w) & _MASK for w in key.tolist())
    u = torch.empty((m, H), dtype=torch.float32, device=dev)
    err = launcher(SOURCES[0], _ARGTYPES)(
        k0, k1, tids.data_ptr(), int(pod) & _MASK, u.data_ptr(), m, H,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    raise_on(err, "threefry_draw")
    with _COUNT_LOCK:
        threefry_draw.launches += 1
    return u


threefry_draw.launches = 0
