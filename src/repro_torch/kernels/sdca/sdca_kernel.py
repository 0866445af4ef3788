"""Hopper CUDA kernels for the block-Gram SDCA inner update, bound with ctypes.

Two kernels, each the port of one TPU kernel of
``repro/kernels/sdca/sdca_kernel.py`` (the sources say how they differ):

``sdca_round_kernel`` — csrc/sdca_round.cu: one fused local round for all
    m tasks in ONE launch (one CTA per task); replaces ``sdca_round_kernel``.
``sdca_block_kernel`` — csrc/sdca_block.cu: the deltas of one H-block for
    all m tasks in one launch; replaces ``sdca_block_kernel``.

Each ``.cu`` file has a plain C interface and is compiled on first use by
``repro_torch.kernels.nvcc`` (nvcc into ``build/``, bound with ctypes).

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs, launches on PyTorch's current stream, raises if the launch returned
a CUDA error, and only then adds one to its ``launches`` count.
"""
from __future__ import annotations

from pathlib import Path
from typing import Tuple

import torch

from ..nvcc import INT, VP, check_tensor, launcher, raise_on

SUPPORTED_LOSSES = ("hinge", "squared", "smoothed_hinge")
SUPPORTED_BLOCKS = (16, 32, 64)
_LOSS_IDS = {name: i for i, name in enumerate(SUPPORTED_LOSSES)}

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "sdca_round.cu", CSRC / "sdca_block.cu")
_ARGTYPES = {
    "sdca_round": [VP] * 9 + [INT] * 6 + [VP],
    "sdca_block": [VP] * 8 + [INT] * 4 + [VP],
}


def _lib(name: str):
    return launcher(CSRC / f"{name}.cu", _ARGTYPES[name])


def _setup(loss: str, block: int, x: torch.Tensor):
    if x.device.type != "cuda":
        raise ValueError(f"the SDCA kernels run on CUDA tensors, got {x.device}")
    if loss not in _LOSS_IDS:
        raise ValueError(f"kernel supports {SUPPORTED_LOSSES}, got {loss!r}")
    if block not in SUPPORTED_BLOCKS:
        raise ValueError(f"kernel supports block sizes {SUPPORTED_BLOCKS}, got {block}")


def sdca_round_kernel(
    x: torch.Tensor,  # (m, n_max, d) float32
    y: torch.Tensor,  # (m, n_max)
    alpha: torch.Tensor,  # (m, n_max)
    w: torch.Tensor,  # (m, d)
    u: torch.Tensor,  # (m, H) uniforms in [0, 1)
    n: torch.Tensor,  # (m,) int32 valid sample counts
    kappa: torch.Tensor,  # (m,) rho * sigma_ii / (lambda * n_i)
    loss: str,
    block: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One fused local round for every task: (dalpha (m, n_max), r (m, d))."""
    _setup(loss, block, x)
    m, n_max, d = x.shape
    H = u.shape[1]
    if H % block:
        raise ValueError(f"H={H} must be a multiple of block={block}")
    f32, dev = torch.float32, x.device
    for name, t, shape, dt in (
        ("x", x, (m, n_max, d), f32), ("y", y, (m, n_max), f32),
        ("alpha", alpha, (m, n_max), f32), ("w", w, (m, d), f32),
        ("u", u, (m, H), f32), ("n", n, (m,), torch.int32),
        ("kappa", kappa, (m,), f32),
    ):
        check_tensor(name, t, shape, dt, dev)
    dalpha = torch.zeros((m, n_max), dtype=f32, device=dev)
    r = torch.empty((m, d), dtype=f32, device=dev)
    err = _lib("sdca_round")(
        x.data_ptr(), y.data_ptr(), alpha.data_ptr(), w.data_ptr(),
        u.data_ptr(), n.data_ptr(), kappa.data_ptr(), dalpha.data_ptr(),
        r.data_ptr(), m, n_max, d, H, block, _LOSS_IDS[loss],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    raise_on(err, "sdca_round")
    sdca_round_kernel.launches += 1
    return dalpha, r


def sdca_block_kernel(
    xb: torch.Tensor,  # (m, B, d) gathered rows
    w: torch.Tensor,  # (m, d)
    r: torch.Tensor,  # (m, d) running block correction
    at0: torch.Tensor,  # (m, B) initial alpha~ per slot
    y: torch.Tensor,  # (m, B)
    cb: torch.Tensor,  # (m, B) int32 coordinate ids
    kappa: torch.Tensor,  # (m,)
    loss: str,
) -> torch.Tensor:
    """Deltas (m, B) of one H-block for every task."""
    m, B, d = xb.shape
    _setup(loss, B, xb)
    f32, dev = torch.float32, xb.device
    for name, t, shape, dt in (
        ("xb", xb, (m, B, d), f32), ("w", w, (m, d), f32), ("r", r, (m, d), f32),
        ("at0", at0, (m, B), f32), ("y", y, (m, B), f32),
        ("cb", cb, (m, B), torch.int32), ("kappa", kappa, (m,), f32),
    ):
        check_tensor(name, t, shape, dt, dev)
    deltas = torch.empty((m, B), dtype=f32, device=dev)
    err = _lib("sdca_block")(
        xb.data_ptr(), w.data_ptr(), r.data_ptr(), at0.data_ptr(),
        y.data_ptr(), cb.data_ptr(), kappa.data_ptr(), deltas.data_ptr(),
        m, B, d, _LOSS_IDS[loss], torch.cuda.current_stream(dev).cuda_stream,
    )
    raise_on(err, "sdca_block")
    sdca_block_kernel.launches += 1
    return deltas


sdca_round_kernel.launches = 0
sdca_block_kernel.launches = 0


def reset_launch_counts() -> None:
    sdca_round_kernel.launches = 0
    sdca_block_kernel.launches = 0
