"""Hopper CUDA kernels for the block-Gram SDCA inner update, bound with ctypes.

Two kernels, each the port of one TPU kernel of
``repro/kernels/sdca/sdca_kernel.py`` (the sources say how they differ):

``sdca_round_kernel`` — csrc/sdca_round.cu: one fused local round for all
    m tasks in ONE call; replaces ``sdca_round_kernel``. Where a supported
    cluster fits d in shared memory it is two kernels: stage 1 forms every
    block's Gram and q over the whole card, stage 2 (``chain_kernel``) runs
    each task's chain of blocks on a cluster of CTAs holding the block's
    rows. Where none does it is one kernel (``chain_stream_kernel``,
    csrc/sdca_stream.cuh) that streams the rows twice a round and forms
    the Gram and q in its first read (``round_plan``).
``sdca_block_kernel`` — csrc/sdca_block.cu: the deltas of one H-block for
    all m tasks in one launch, a cluster of CTAs per task splitting d;
    replaces ``sdca_block_kernel``.

Each ``.cu`` file has a plain C interface and is compiled on first use by
``repro_torch.kernels.nvcc`` (nvcc into ``build/``, bound with ctypes).

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs, launches on PyTorch's current stream, raises if the launch returned
a CUDA error, and only then adds one to its ``launches`` count (and a
streamed round to ``sdca_round_kernel.stream_launches``, a round that
launched stage 1 to ``sdca_round_kernel.gram_launches``).
"""
from __future__ import annotations

import dataclasses
import threading
from pathlib import Path
from typing import Optional, Tuple

import torch

from ..nvcc import INT, VP, check_tensor, launcher, raise_on

SUPPORTED_LOSSES = ("hinge", "squared", "smoothed_hinge")
SUPPORTED_BLOCKS = (16, 32, 64)
SUPPORTED_CLUSTERS = (2, 4, 8)
CLUSTER = 4  # CTAs per task in stage 2 while the tasks are few (``round_cluster``)
# the streamed round: at most STREAM_MAX_CTAS CTAs a task, each of 2 or 4
# warps, all resident at once (at most 64K registers of 255 a thread an SM).
# At the MDS width (22 tasks, d = 10 000) a round took 13.43 ms at 12 CTAs
# of 4 warps (two an SM), 14.48 at 11, 16.08 at 6, 17.70 at 8 and 16.91 at
# 16 CTAs of 2 warps (H100, chip_smoke.py phase 2)
STREAM_MAX_CTAS = 16
STREAM_WARP_COUNTS = (2, 4)
STREAM_WARPS = 4
SM_REGISTERS = 65536
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
SM_SMEM_BYTES = 233472  # shared memory of one Hopper SM, 1 KB of it reserved per CTA
_LOSS_IDS = {name: i for i, name in enumerate(SUPPORTED_LOSSES)}
# the transports' worker threads launch both kernels concurrently
_COUNT_LOCK = threading.Lock()

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "sdca_round.cu", CSRC / "sdca_block.cu")
_ARGTYPES = {
    "sdca_round": [VP] * 10 + [INT] * 10 + [VP],
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


def _slab(d: int, cluster: int) -> int:
    """Columns of d per stage-2 CTA (``slab`` in csrc/sdca_round.cu): a
    multiple of 4."""
    return (-(-d // cluster) + 3) // 4 * 4


def chain_smem_bytes(block: int, d: int, cluster: int) -> int:
    """Shared memory of one stage-2 CTA (the layout of ``ChainSmem`` in
    csrc/sdca_round.cu): two buffers of the block's rows over the CTA's
    column slab and of its scratch, the slab of r, and per-block vectors."""
    slab = _slab(d, cluster)
    return 4 * (2 * block * slab + 2 * _scratch_floats(block) + slab + 8 * block)


def _exchange_floats(block: int) -> int:
    """Floats of one CTA's partial Gram, q and xr as the streamed round's
    CTAs exchange them (``exchange_floats`` in csrc/sdca_stream.cuh): a
    68-float tile for each of the first 32 of the triangle's 8 x 8 tiles,
    then the diagonal blocks past them (below their diagonal, then the
    diagonal), q and xr."""
    r = block // 8
    tiles = r * (r + 1) // 2
    rest = tiles - min(tiles, 32)
    return 68 * min(tiles, 32) + 36 * rest + 2 * block


def stream_scratch_floats(block: int, m: int, ctas: int) -> int:
    """Floats of the streamed round's global scratch (``stream_scratch_floats``
    in csrc/sdca_stream.cuh): every CTA's partials, each task's sum, rank
    0's alpha~ twice and a counter."""
    return m * ((ctas + 1) * _exchange_floats(block) + 2 * block + 1)


def stream_ctas(m: int, d: int, block: int, sms: int, warps: int = STREAM_WARPS) -> int:
    """CTAs a task for the streamed round: the most, up to ``STREAM_MAX_CTAS``,
    whose m * C CTAs are resident at once on ``sms`` SMs (as many an SM as
    registers and shared memory allow), since a task's CTAs wait for each
    other; 1, which waits for none, where even 2 a task are not."""
    for c in range(STREAM_MAX_CTAS, 1, -1):
        smem = stream_smem_bytes(block, d, c, warps)
        per_sm = min(SM_REGISTERS // (256 * 32 * warps), SM_SMEM_BYTES // (smem + 1024))
        if smem <= MAX_SMEM_BYTES and m * c <= sms * per_sm:
            return c
    return 1


def stream_smem_bytes(block: int, d: int, cluster: int, warps: int) -> int:
    """Shared memory of one CTA of the streamed round (``StreamSmem`` in
    csrc/sdca_stream.cuh): each warp's ring of two stages of the block's
    rows and w over 32 columns, the slab of r, the exchange buffer, the
    summed Gram, and per-block vectors and row offsets."""
    ring = warps * 2 * (block + 1) * 32
    return 4 * (ring + _slab(d, cluster) + _exchange_floats(block) + block * block + 17 * block)


@dataclasses.dataclass(frozen=True)
class RoundPlan:
    """How the round runs: ``path`` "chain" (``gram_kernel``, then
    ``chain_kernel`` holding the rows in shared memory, ``cluster`` CTAs a
    task in a thread-block cluster) or "stream" (``chain_stream_kernel``
    alone, ``cluster`` CTAs a task in a cooperative launch), ``warps`` a
    streaming CTA (-1 on the chain path)."""

    path: str
    cluster: int
    warps: int = -1


def round_plan(m: int, d: int, block: int, sms: int) -> RoundPlan:
    """Stage 2's default for m tasks of width d on a card of ``sms`` SMs.

    While the tasks are fewer than the SMs, the smallest supported cluster
    of at least ``CLUSTER`` CTAs that fits d splits each task's chain (at
    MNIST width, 10 tasks, 4 and 8 measured equal and 2 does not fit d =
    784). Once the tasks alone fill every SM, the fewest CTAs per task that
    fit d run more chains per wave: at 4096 tasks and d = 100 a round took
    1.025 ms at 2, 1.590 at 4 and 2.802 at 8 (H100, ``chip_smoke.py`` phase
    2). Where no supported cluster fits d, the round streams the rows in
    ``stream_ctas`` CTAs a task of ``STREAM_WARPS`` warps."""
    fits = [c for c in SUPPORTED_CLUSTERS if chain_smem_bytes(block, d, c) <= MAX_SMEM_BYTES]
    if m < sms:
        fits = [c for c in fits if c >= CLUSTER]
    if fits:
        return RoundPlan("chain", min(fits))
    return RoundPlan("stream", stream_ctas(m, d, block, sms), STREAM_WARPS)


def round_cluster(m: int, d: int, block: int, sms: int) -> int:
    """Stage 2's default cluster (``round_plan``)."""
    return round_plan(m, d, block, sms).cluster


def _sms(x: torch.Tensor) -> int:
    return torch.cuda.get_device_properties(x.device).multi_processor_count \
        if x.device.type == "cuda" else 0


def plan_for(x: torch.Tensor, block: int, cluster: Optional[int] = None,
             warps: Optional[int] = None) -> RoundPlan:
    """The plan a round on ``x`` (m, n_max, d) runs: ``round_plan`` by
    default; a ``cluster`` alone asks for the chain path at that size;
    ``warps`` (``sdca_round_stage`` only) asks for the streamed round at
    ``cluster`` CTAs a task, default ``stream_ctas``."""
    m, _, d = x.shape
    if cluster is None and warps is None:
        return round_plan(m, d, block, _sms(x))
    if warps is None:
        return RoundPlan("chain", cluster)
    if cluster is None:
        cluster = stream_ctas(m, d, block, _sms(x), warps)
    return RoundPlan("stream", cluster, warps)


def _round_checks(x, y, alpha, w, u, n, kappa, loss, block, plan: RoundPlan):
    """Validate a round's inputs and its stage-2 plan; return (m, n_max, d,
    H)."""
    _setup(loss, block, x)
    m, n_max, d = x.shape
    H = u.shape[1]
    if H % block:
        raise ValueError(f"H={H} must be a multiple of block={block}")
    if plan.path == "chain":
        if plan.cluster not in SUPPORTED_CLUSTERS:
            raise ValueError(f"kernel supports clusters of {SUPPORTED_CLUSTERS}, "
                             f"got {plan.cluster}")
        smem = chain_smem_bytes(block, d, plan.cluster)
    else:
        if not 1 <= plan.cluster <= STREAM_MAX_CTAS:
            raise ValueError(f"the streamed round supports clusters of 1 to {STREAM_MAX_CTAS} "
                             f"CTAs, got {plan.cluster}")
        if plan.warps not in STREAM_WARP_COUNTS:
            raise ValueError(f"the streamed round runs {STREAM_WARP_COUNTS} warps a CTA, "
                             f"got {plan.warps}")
        smem = stream_smem_bytes(block, d, plan.cluster, plan.warps)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"d={d} does not fit a cluster of {plan.cluster} CTAs at "
                         f"block={block} on the {plan.path} path: {smem} bytes of shared "
                         f"memory a CTA")
    f32, dev = torch.float32, x.device
    for name, t, shape, dt in (
        ("x", x, (m, n_max, d), f32), ("y", y, (m, n_max), f32),
        ("alpha", alpha, (m, n_max), f32), ("w", w, (m, d), f32),
        ("u", u, (m, H), f32), ("n", n, (m,), torch.int32),
        ("kappa", kappa, (m,), f32),
    ):
        check_tensor(name, t, shape, dt, dev)
    return m, n_max, d, H


def _launch_round(x, y, alpha, w, u, n, kappa, loss, block, plan, scratch, group,
                  dalpha, r, stages):
    m, n_max, d = x.shape
    err = _lib("sdca_round")(
        x.data_ptr(), y.data_ptr(), alpha.data_ptr(), w.data_ptr(),
        u.data_ptr(), n.data_ptr(), kappa.data_ptr(), dalpha.data_ptr(),
        r.data_ptr(), scratch.data_ptr(), m, n_max, d, u.shape[1], block,
        _LOSS_IDS[loss], group, plan.cluster, stages, plan.warps,
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
    ``cluster`` is the number of CTAs that share a task's chain on the
    chain path (stage 2; default: ``round_plan``, which streams where no
    cluster holds d). ``launches`` counts every round, ``stream_launches``
    those that streamed, ``gram_launches`` those that launched stage 1."""
    plan = plan_for(x, block, cluster)
    m, n_max, d, H = _round_checks(x, y, alpha, w, u, n, kappa, loss, block, plan)
    f32, dev = torch.float32, x.device
    streamed = plan.path == "stream"
    group = 1 if streamed else max(1, min(H // block, SCRATCH_CAP_BYTES
                                          // (4 * m * _scratch_floats(block))))
    # the streamed round draws its blocks itself; its scratch holds only what
    # a task's CTAs exchange
    scratch = torch.empty((stream_scratch_floats(block, m, plan.cluster) if streamed
                           else m * group * _scratch_floats(block),), dtype=f32, device=dev)
    dalpha = torch.zeros((m, n_max), dtype=f32, device=dev)
    r = torch.zeros((m, d), dtype=f32, device=dev)
    _launch_round(x, y, alpha, w, u, n, kappa, loss, block, plan, scratch, group,
                  dalpha, r, stages=2 if streamed else 3)
    _count(sdca_round_kernel, plan.path)
    return dalpha, r


def sdca_round_stage(
    stage: int, x, y, alpha, w, u, n, kappa, loss: str,
    scratch: Optional[torch.Tensor],  # (m * H/block * (block^2 + 4 block),) float32
    dalpha: torch.Tensor,  # (m, n_max), updated in place by stage 2
    r: torch.Tensor,  # (m, d), updated in place by stage 2
    block: int = 64,
    cluster: Optional[int] = None,
    warps: Optional[int] = None,
) -> None:
    """Launch one stage of the round alone on the caller's buffers, to time
    the two apart: on the chain path stage 1 writes every block's Gram, q
    and metadata into ``scratch`` and stage 2 reads them and runs the chains
    into ``dalpha`` and ``r``. The streamed round is one kernel: there
    stage 2 is the whole round, ``scratch`` is not read (it brings its
    own), and stage 1 is refused. ``warps`` asks for the streamed round (``plan_for``). Not
    counted in ``sdca_round_kernel``'s counters."""
    if stage not in (1, 2):
        raise ValueError(f"stage must be 1 or 2, got {stage}")
    plan = plan_for(x, block, cluster, warps)
    if plan.path == "stream" and stage == 1:
        raise ValueError("the streamed round has no stage 1: chain_stream_kernel forms the "
                         "Gram and q in its own first read of the rows (launch stage 2)")
    m, n_max, d, H = _round_checks(x, y, alpha, w, u, n, kappa, loss, block, plan)
    n_blocks = H // block
    if plan.path == "chain":
        check_tensor("scratch", scratch, (m * n_blocks * _scratch_floats(block),),
                     torch.float32, x.device)
    else:
        scratch = torch.empty((stream_scratch_floats(block, m, plan.cluster),),
                              dtype=torch.float32, device=x.device)
    check_tensor("dalpha", dalpha, (m, n_max), torch.float32, x.device)
    check_tensor("r", r, (m, d), torch.float32, x.device)
    _launch_round(x, y, alpha, w, u, n, kappa, loss, block, plan, scratch,
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
    _count(sdca_block_kernel)
    return deltas


def block_cluster(d: int) -> int:
    """The block kernel's default cluster: the most CTAs per task whose
    column slabs still hold ``BLOCK_SLAB_MIN_COLS`` columns (one CTA below
    that width)."""
    fits = [c for c in SUPPORTED_BLOCK_CLUSTERS if -(-d // c) >= BLOCK_SLAB_MIN_COLS]
    return max(fits, default=1)


def _count(wrapper, path: Optional[str] = None) -> None:
    with _COUNT_LOCK:
        wrapper.launches += 1
        if path == "stream":
            wrapper.stream_launches += 1
        elif path == "chain":
            wrapper.gram_launches += 1


sdca_round_kernel.launches = 0
sdca_round_kernel.stream_launches = 0
sdca_round_kernel.gram_launches = 0
sdca_block_kernel.launches = 0


def reset_launch_counts() -> None:
    sdca_round_kernel.launches = 0
    sdca_round_kernel.stream_launches = 0
    sdca_round_kernel.gram_launches = 0
    sdca_block_kernel.launches = 0
