"""Build and load the port's CUDA kernels: nvcc into ``build/``, bound with ctypes.

Every kernel package keeps its sources in its own ``csrc/`` directory, one
``<name>.cu`` per library, each with a plain C entry point
``int <name>_launch(...)`` that returns the launch's ``cudaError_t``. On
first use a source is compiled, on a machine with ``nvcc``, into
``build/`` at the repository root:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/<name>-<hash>.so csrc/<name>.cu

The file name carries a hash of every source in that ``csrc/`` directory
and of the flags, so an edited kernel is rebuilt. ``build_all`` compiles
many sources at once (one ``nvcc`` per source, all started together);
nothing is built or loaded at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Sequence, Tuple

BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
VP, INT, FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
U32 = ctypes.c_uint32
_FUNCS: Dict[Tuple[Path, str], ctypes._CFuncPtr] = {}
# held while a library is built and loaded: worker threads of a transport
# may launch a kernel for the first time together
_FUNCS_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build on a CUDA machine")
    return found


def lib_path(src: Path) -> Path:
    h = hashlib.sha256()
    for f in sorted(src.parent.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:12]}.so"


def build_all(sources: Iterable[Path]) -> Dict[str, float]:
    """Compile the sources that are not built yet, one ``nvcc`` per source,
    all started together. Returns the seconds each build took (0 for a
    library already built); raises with nvcc's output on failure. nvcc's
    ``-Xptxas -v`` report (registers, shared memory, spills) goes to
    ``build/<name>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    seconds = {}
    for src in sources:
        out = lib_path(src)
        if out.exists():
            seconds[src.stem] = 0.0
            continue
        # one temporary name per process and thread: concurrent builds of
        # one source each write their own file, and os.replace is atomic
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[src.stem] = (
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


def launcher(src: Path, argtypes: Sequence, entry: str = "launch") -> ctypes._CFuncPtr:
    """The C entry point ``<name>_<entry>`` of ``src`` (``<name>_launch`` by
    default), built on first use. Safe from several threads: the first
    caller builds and loads while the others wait for it."""
    key = (src, entry)
    fn = _FUNCS.get(key)
    if fn is None:
        with _FUNCS_LOCK:
            fn = _FUNCS.get(key)
            if fn is None:
                build_all([src])
                fn = getattr(ctypes.CDLL(str(lib_path(src))), f"{src.stem}_{entry}")
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
                _FUNCS[key] = fn
    return fn


def raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


def check_tensor(name: str, t, shape, dtype, device, layout: str = "dense") -> None:
    """Raise unless ``t`` has the device, dtype and shape a kernel takes, and
    its layout: "dense" (row-major), "rows" (the last dimension contiguous,
    for a kernel that takes the other strides) or "any" (every stride)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if layout == "dense" and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if layout == "rows" and t.stride(-1) != 1:
        raise ValueError(f"{name}'s last dimension must be contiguous")
