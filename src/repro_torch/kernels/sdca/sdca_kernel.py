"""Hopper CUDA kernels for the block-Gram SDCA inner update, bound with ctypes.

Two kernels, each the port of one TPU kernel of
``repro/kernels/sdca/sdca_kernel.py`` (the sources say how they differ):

``sdca_round_kernel`` — csrc/sdca_round.cu: one fused local round for all
    m tasks in ONE call: stage 1 forms every block's Gram and q over the
    whole card, stage 2 runs each task's chain of blocks on a cluster of
    CTAs; replaces ``sdca_round_kernel``.
``sdca_block_kernel`` — csrc/sdca_block.cu: the deltas of one H-block for
    all m tasks in one launch, a cluster of CTAs per task splitting d;
    replaces ``sdca_block_kernel``.

Each ``.cu`` file has a plain C interface and is compiled on first use by
``repro_torch.kernels.nvcc`` (nvcc into ``build/``, bound with ctypes).

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs, launches on PyTorch's current stream, raises if the launch returned
a CUDA error, and only then adds one to its ``launches`` count.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import torch

from ..nvcc import INT, VP, check_tensor, launcher, raise_on

SUPPORTED_LOSSES = ("hinge", "squared", "smoothed_hinge")
SUPPORTED_BLOCKS = (16, 32, 64)
SUPPORTED_CLUSTERS = (2, 4, 8)
CLUSTER = 4  # CTAs per task in stage 2 while the tasks are few (``round_cluster``)
# the block kernel's cluster sizes, and the narrowest column slab its
# default cluster gives one CTA (chosen by measurement, chip_smoke.py phase
# 2: at d = 100 four CTAs of 25 columns beat one, two and eight; at d = 784
# eight of 98 beat fewer)
SUPPORTED_BLOCK_CLUSTERS = (1, 2, 4, 8)
BLOCK_SLAB_MIN_COLS = 24
# scratch of stage 1 (every block's Gram, q and metadata); a round with more
# blocks than this holds runs in groups of blocks
SCRATCH_CAP_BYTES = 256 << 20
MAX_SMEM_BYTES = 232448  # shared memory one Hopper CTA can use
_LOSS_IDS = {name: i for i, name in enumerate(SUPPORTED_LOSSES)}

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "sdca_round.cu", CSRC / "sdca_block.cu")
_ARGTYPES = {
    "sdca_round": [VP] * 10 + [INT] * 9 + [VP],
    "sdca_block": [VP] * 8 + [INT] * 5 + [VP],
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


def _scratch_floats(block: int) -> int:
    return block * block + 4 * block  # G, q, labels, alphas, coordinate ids


def chain_smem_bytes(block: int, d: int, cluster: int) -> int:
    """Shared memory of one stage-2 CTA (the layout of ``ChainSmem`` in
    csrc/sdca_round.cu): two buffers of the block's rows over the CTA's
    column slab and of its scratch, the slab of r, and per-block vectors."""
    slab = (-(-d // cluster) + 3) // 4 * 4
    return 4 * (2 * block * slab + 2 * _scratch_floats(block) + slab + 8 * block)


def round_cluster(m: int, d: int, block: int, sms: int) -> int:
    """Stage 2's default cluster for m tasks on a card of ``sms`` SMs.

    While the tasks are fewer than the SMs, ``CLUSTER`` CTAs split each
    task's chain (at MNIST width, 10 tasks, 4 and 8 measured equal and 2
    does not fit d = 784). Once the tasks alone fill every SM, the fewest
    CTAs per task that fit d run more chains per wave: at 4096 tasks and
    d = 100 a round took 1.025 ms at 2, 1.590 at 4 and 2.802 at 8 (H100,
    ``chip_smoke.py`` phase 2)."""
    if m < sms:
        return CLUSTER
    fits = [c for c in SUPPORTED_CLUSTERS if chain_smem_bytes(block, d, c) <= MAX_SMEM_BYTES]
    return min(fits, default=CLUSTER)


def _cluster_for(x: torch.Tensor, block: int) -> int:
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count \
        if x.device.type == "cuda" else 0
    return round_cluster(x.shape[0], x.shape[2], block, sms)


def _round_checks(x, y, alpha, w, u, n, kappa, loss, block, cluster):
    """Validate a round's inputs; return (m, n_max, d, H)."""
    _setup(loss, block, x)
    m, n_max, d = x.shape
    H = u.shape[1]
    if H % block:
        raise ValueError(f"H={H} must be a multiple of block={block}")
    if cluster not in SUPPORTED_CLUSTERS:
        raise ValueError(f"kernel supports clusters of {SUPPORTED_CLUSTERS}, got {cluster}")
    smem = chain_smem_bytes(block, d, cluster)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"d={d} does not fit a cluster of {cluster} CTAs at block={block}: "
                         f"{smem} bytes of shared memory a CTA")
    f32, dev = torch.float32, x.device
    for name, t, shape, dt in (
        ("x", x, (m, n_max, d), f32), ("y", y, (m, n_max), f32),
        ("alpha", alpha, (m, n_max), f32), ("w", w, (m, d), f32),
        ("u", u, (m, H), f32), ("n", n, (m,), torch.int32),
        ("kappa", kappa, (m,), f32),
    ):
        check_tensor(name, t, shape, dt, dev)
    return m, n_max, d, H


def _launch_round(x, y, alpha, w, u, n, kappa, loss, block, cluster, scratch, group,
                  dalpha, r, stages):
    m, n_max, d = x.shape
    err = _lib("sdca_round")(
        x.data_ptr(), y.data_ptr(), alpha.data_ptr(), w.data_ptr(),
        u.data_ptr(), n.data_ptr(), kappa.data_ptr(), dalpha.data_ptr(),
        r.data_ptr(), scratch.data_ptr(), m, n_max, d, u.shape[1], block,
        _LOSS_IDS[loss], group, cluster, stages,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    raise_on(err, "sdca_round")


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
    cluster: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One fused local round for every task: (dalpha (m, n_max), r (m, d)).
    ``cluster`` is the number of CTAs that share a task's chain (stage 2;
    default: ``round_cluster``)."""
    cluster = _cluster_for(x, block) if cluster is None else cluster
    m, n_max, d, H = _round_checks(x, y, alpha, w, u, n, kappa, loss, block, cluster)
    f32, dev = torch.float32, x.device
    n_blocks = H // block
    group = max(1, min(n_blocks, SCRATCH_CAP_BYTES // (4 * m * _scratch_floats(block))))
    scratch = torch.empty((m * group * _scratch_floats(block),), dtype=f32, device=dev)
    dalpha = torch.zeros((m, n_max), dtype=f32, device=dev)
    r = torch.zeros((m, d), dtype=f32, device=dev)
    _launch_round(x, y, alpha, w, u, n, kappa, loss, block, cluster, scratch, group,
                  dalpha, r, stages=3)
    sdca_round_kernel.launches += 1
    return dalpha, r


def sdca_round_stage(
    stage: int, x, y, alpha, w, u, n, kappa, loss: str,
    scratch: torch.Tensor,  # (m * H/block * (block^2 + 4 block),) float32
    dalpha: torch.Tensor,  # (m, n_max), updated in place by stage 2
    r: torch.Tensor,  # (m, d), updated in place by stage 2
    block: int = 64,
    cluster: Optional[int] = None,
) -> None:
    """Launch one stage of the round alone on the caller's buffers, to time
    the two apart: stage 1 writes every block's Gram, q and metadata into
    ``scratch``; stage 2 reads them and runs the chains into ``dalpha`` and
    ``r``. Not counted in ``sdca_round_kernel.launches``."""
    cluster = _cluster_for(x, block) if cluster is None else cluster
    m, n_max, d, H = _round_checks(x, y, alpha, w, u, n, kappa, loss, block, cluster)
    if stage not in (1, 2):
        raise ValueError(f"stage must be 1 or 2, got {stage}")
    n_blocks = H // block
    check_tensor("scratch", scratch, (m * n_blocks * _scratch_floats(block),),
                 torch.float32, x.device)
    check_tensor("dalpha", dalpha, (m, n_max), torch.float32, x.device)
    check_tensor("r", r, (m, d), torch.float32, x.device)
    _launch_round(x, y, alpha, w, u, n, kappa, loss, block, cluster, scratch,
                  max(1, n_blocks), dalpha, r, stages=stage)


def sdca_block_kernel(
    xb: torch.Tensor,  # (m, B, d) gathered rows
    w: torch.Tensor,  # (m, d)
    r: torch.Tensor,  # (m, d) running block correction
    at0: torch.Tensor,  # (m, B) initial alpha~ per slot
    y: torch.Tensor,  # (m, B)
    cb: torch.Tensor,  # (m, B) int32 coordinate ids
    kappa: torch.Tensor,  # (m,)
    loss: str,
    cluster: Optional[int] = None,
) -> torch.Tensor:
    """Deltas (m, B) of one H-block for every task. ``cluster``: CTAs per
    task, each taking a slab of d (default: ``block_cluster(d)``)."""
    m, B, d = xb.shape
    _setup(loss, B, xb)
    cluster = block_cluster(d) if cluster is None else cluster
    if cluster not in SUPPORTED_BLOCK_CLUSTERS:
        raise ValueError(f"kernel supports clusters of {SUPPORTED_BLOCK_CLUSTERS}, got {cluster}")
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
        m, B, d, _LOSS_IDS[loss], cluster, torch.cuda.current_stream(dev).cuda_stream,
    )
    raise_on(err, "sdca_block")
    sdca_block_kernel.launches += 1
    return deltas


def block_cluster(d: int) -> int:
    """The block kernel's default cluster: the most CTAs per task whose
    column slabs still hold ``BLOCK_SLAB_MIN_COLS`` columns (one CTA below
    that width)."""
    fits = [c for c in SUPPORTED_BLOCK_CLUSTERS if -(-d // c) >= BLOCK_SLAB_MIN_COLS]
    return max(fits, default=1)


sdca_round_kernel.launches = 0
sdca_block_kernel.launches = 0


def reset_launch_counts() -> None:
    sdca_round_kernel.launches = 0
    sdca_block_kernel.launches = 0
