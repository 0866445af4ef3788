"""Hopper CUDA kernels for the block-Gram SDCA inner update, bound with ctypes.

Two kernels, each the port of one TPU kernel of
``repro/kernels/sdca/sdca_kernel.py`` (the sources say how they differ):

``sdca_round_kernel`` — csrc/sdca_round.cu: one fused local round for all
    m tasks in ONE launch (one CTA per task); replaces ``sdca_round_kernel``.
``sdca_block_kernel`` — csrc/sdca_block.cu: the deltas of one H-block for
    all m tasks in one launch; replaces ``sdca_block_kernel``.

Each ``.cu`` file has a plain C interface and is compiled on first use, on
a machine with ``nvcc``, into ``build/`` at the repository root:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/<name>-<hash>.so csrc/<name>.cu

The file name carries a hash of the sources, so an edited kernel is rebuilt.
``build_all()`` compiles both at once (one ``nvcc`` per source, started
together). Nothing is built or loaded at import time.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs, launches on PyTorch's current stream, raises if the launch returned
a CUDA error, and only then adds one to its ``launches`` count.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

import torch

SUPPORTED_LOSSES = ("hinge", "squared", "smoothed_hinge")
SUPPORTED_BLOCKS = (16, 32, 64)
_LOSS_IDS = {name: i for i, name in enumerate(SUPPORTED_LOSSES)}

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_SOURCES = ("sdca_round", "sdca_block")
_VP, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "sdca_round": [_VP] * 9 + [_I] * 6 + [_VP],
    "sdca_block": [_VP] * 8 + [_I] * 4 + [_VP],
}
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the SDCA kernels build on a CUDA machine")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build_all(names: Iterable[str] = _SOURCES) -> Dict[str, float]:
    """Compile the named kernels that are not built yet, one ``nvcc`` per
    source, all started together. Returns the seconds each build took (0
    for a library already built); raises with nvcc's output on failure.
    ``nvcc``'s ``-Xptxas -v`` report (registers, shared memory, spills)
    goes to ``build/<name>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    seconds = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
            tmp, out, time.perf_counter(),
        )
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        (BUILD_DIR / f"{name}.log").write_bytes(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log.decode(errors='replace')}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def _lib(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        fn = getattr(lib, f"{name}_launch")
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def _check(name: str, t: torch.Tensor, shape: Tuple[int, ...], dtype, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _setup(loss: str, block: int, x: torch.Tensor):
    if x.device.type != "cuda":
        raise ValueError(f"the SDCA kernels run on CUDA tensors, got {x.device}")
    if loss not in _LOSS_IDS:
        raise ValueError(f"kernel supports {SUPPORTED_LOSSES}, got {loss!r}")
    if block not in SUPPORTED_BLOCKS:
        raise ValueError(f"kernel supports block sizes {SUPPORTED_BLOCKS}, got {block}")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


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
        _check(name, t, shape, dt, dev)
    dalpha = torch.zeros((m, n_max), dtype=f32, device=dev)
    r = torch.empty((m, d), dtype=f32, device=dev)
    err = _lib("sdca_round").sdca_round_launch(
        x.data_ptr(), y.data_ptr(), alpha.data_ptr(), w.data_ptr(),
        u.data_ptr(), n.data_ptr(), kappa.data_ptr(), dalpha.data_ptr(),
        r.data_ptr(), m, n_max, d, H, block, _LOSS_IDS[loss],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(err, "sdca_round")
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
        _check(name, t, shape, dt, dev)
    deltas = torch.empty((m, B), dtype=f32, device=dev)
    err = _lib("sdca_block").sdca_block_launch(
        xb.data_ptr(), w.data_ptr(), r.data_ptr(), at0.data_ptr(),
        y.data_ptr(), cb.data_ptr(), kappa.data_ptr(), deltas.data_ptr(),
        m, B, d, _LOSS_IDS[loss], torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(err, "sdca_block")
    sdca_block_kernel.launches += 1
    return deltas


sdca_round_kernel.launches = 0
sdca_block_kernel.launches = 0


def reset_launch_counts() -> None:
    sdca_round_kernel.launches = 0
    sdca_block_kernel.launches = 0
