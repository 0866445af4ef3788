"""Hopper CUDA kernels for the Mamba2 SSD chunk-local computation and its
backward, bound with ctypes.

``ssd_chunk_kernel`` — csrc/ssd_chunk.cu: Y_intra, S_local and a_tot of
every (batch, head, chunk) in one launch, on the tensor cores (split
TF32); replaces the TPU kernel ``ssd_chunk_kernel`` of
``repro/kernels/ssd/ssd_kernel.py`` (the source says how they differ).
It reads the model's layout in place: x (B, L, H, P), dt (B, L, H) and B,
C per group (B, L, G, N), through strides, fp32 or bf16.

``ssd_chunk_bwd_kernel`` — csrc/ssd_chunk_bwd.cu (K4-bwd): dx, d(dt), dA,
dB and dC from the cotangents of K4's three outputs, over the same strided
inputs; the JAX package has no kernel here (it differentiates its jnp
``ssd_chunked``, ``repro/models/ssm.py``). One CTA per (batch, chunk,
group) and block of the group's heads, a cluster of such CTAs per (batch,
chunk, group) summing dB and dC on chip (``bwd_plan``); dA's per-chunk
terms are summed by a second, small kernel. Bit-deterministic: every sum
runs in a fixed order, with no float atomics.

Each source has a plain C interface and is compiled on first use by
``repro_torch.kernels.nvcc``. The wrapper checks device, dtype, shape and
strides, allocates the outputs, launches on PyTorch's current stream,
raises if the launch returned a CUDA error, and only then adds one to its
``launches`` count.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..nvcc import INT, VP, check_tensor, launcher, raise_on

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "ssd_chunk.cu", CSRC / "ssd_chunk_bwd.cu")
_ARGTYPES = [VP] * 8 + [INT] * 8 + [ctypes.c_longlong] * 12 + [VP]
_BWD_ARGTYPES = [VP] * 14 + [INT] * 9 + [ctypes.c_longlong] * 12 + [VP]
MAX_DIM = 128  # Q, P and N
MAX_Q_BWD = 64  # the backward's chunk: four 16-row tiles
MAX_SMEM_BYTES = 232448  # dynamic shared memory of one CTA
MAX_CLUSTER = 16  # the H100's largest thread-block cluster (8 is the portable size)
_DTYPES = (torch.float32, torch.bfloat16)


def _check_inputs(x, dt, A, Bm, Cm, chunk):
    """(B, L, H, G, Q, P, N) of valid kernel inputs, or raise."""
    if x.device.type != "cuda":
        raise ValueError(f"the SSD kernel runs on CUDA tensors, got {x.device}")
    B, L, H, P = x.shape
    G, N = Bm.shape[-2:]
    Q = min(chunk, L)
    if max(Q, P, N) > MAX_DIM:
        raise ValueError(f"kernel takes Q, P, N <= {MAX_DIM}, got {Q}, {P}, {N}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"kernel takes x in {_DTYPES}, got {x.dtype}")
    if H % G:
        raise ValueError(f"{G} groups of B and C do not divide {H} heads")
    f32, dev = torch.float32, x.device
    for name, t, shape, dtype, layout in (
        ("x", x, (B, L, H, P), x.dtype, "rows"), ("dt", dt, (B, L, H), f32, "any"),
        ("A", A, (H,), f32, "dense"), ("Bm", Bm, (B, L, G, N), x.dtype, "rows"),
        ("Cm", Cm, (B, L, G, N), x.dtype, "rows"),
    ):
        check_tensor(name, t, shape, dtype, dev, layout)
    return B, L, H, G, Q, P, N


def _strides(x, dt, Bm, Cm):
    return (*x.stride()[:3], *dt.stride(), *Bm.stride()[:3], *Cm.stride()[:3])


def ssd_chunk_kernel(
    x: torch.Tensor,  # (B, L, H, P) fp32 or bf16, last dim contiguous
    dt: torch.Tensor,  # (B, L, H) fp32
    A: torch.Tensor,  # (H,) fp32
    Bm: torch.Tensor,  # (B, L, G, N), x's dtype, G divides H
    Cm: torch.Tensor,  # (B, L, G, N)
    chunk: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Chunks of Q = min(chunk, L) steps (a ragged last chunk reads as
    zero rows): (Y_intra (B,L,H,P), S_local (B,nc,H,N,P), a_tot (B,nc,H)),
    fp32, nc = ceil(L / Q)."""
    B, L, H, G, Q, P, N = _check_inputs(x, dt, A, Bm, Cm, chunk)
    f32, dev = torch.float32, x.device
    nc = -(-L // Q)
    y = torch.empty((B, L, H, P), dtype=f32, device=dev)
    s = torch.empty((B, nc, H, N, P), dtype=f32, device=dev)
    a_tot = torch.empty((B, nc, H), dtype=f32, device=dev)
    err = launcher(SOURCES[0], _ARGTYPES)(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        y.data_ptr(), s.data_ptr(), a_tot.data_ptr(), B, L, H, G, Q, P, N,
        int(x.dtype == torch.bfloat16), *_strides(x, dt, Bm, Cm),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    raise_on(err, "ssd_chunk")
    ssd_chunk_kernel.launches += 1
    return y, s, a_tot


ssd_chunk_kernel.launches = 0


class BwdPlan(NamedTuple):
    """K4-bwd's launch plan (``BwdPlan`` of csrc/ssd_chunk_bwd.cu): heads a
    CTA takes, CTAs a cluster holds (one cluster per (batch, chunk, group)),
    head stage buffers (2: the next head loads while one computes) and the
    dynamic shared memory of one CTA in bytes."""

    head_block: int
    cluster: int
    stages: int
    smem_bytes: int


def bwd_plan(Q: int, P: int, N: int, heads_per_group: int = 1, bf16: bool = False,
             cluster: int = MAX_CLUSTER) -> BwdPlan:
    """The plan the kernel computes for chunks of Q steps, head dim P, state
    N, H/G heads per group shared by up to ``cluster`` CTAs (none of them
    empty) and x, B, C in bf16 or fp32."""
    def up(v, m):
        return -(-v // m) * m

    QP, NP, PP = up(Q, 16), up(N, 16), up(P, 16)
    MT, NT, PT = QP // 16, NP // 16, PP // 16
    es = 2 if bf16 else 4
    HB = -(-heads_per_group // cluster)
    CL = -(-heads_per_group // HB)
    ldbc, ldx, ldy, ldg = NP + 16 // es, PP + 16 // es, PP + 4, QP + 8
    # B, C and G; three ring slots of cum (fp64), dt and d_end; the partials
    # of dcum and d(dt) (row and column sums and e by head parity, rowsum(x o du))
    scratch = (2 * QP * ldbc * es + QP * ldg * 4 + 3 * QP * (8 + 4 + 4)
               + 2 * 2 * MT * MT * 16 * 4 + 2 * NT * QP * 4 + PT * QP * 4)
    stage = QP * ldx * es + QP * ldy * 4 + NP * ldy * 4  # x, dY, dS of one head
    out = 2 * QP * NP * 4  # the CTA's dB and dC tiles
    stages = 2 if scratch + max(2 * stage, out) <= MAX_SMEM_BYTES else 1
    return BwdPlan(HB, CL, stages, scratch + max(stages * stage, out))


def bwd_smem_bytes(Q: int, N: int, P: int, bf16: bool = False) -> int:
    """Dynamic shared memory of one K4-bwd CTA (``bwd_plan``; it does not
    depend on the head block)."""
    return bwd_plan(Q, P, N, 1, bf16).smem_bytes


def check_bwd_shape(Q: int, P: int, N: int, bf16: bool = False) -> None:
    """Raise unless K4-bwd takes chunks of Q steps with head dim P and state
    N in that dtype (Q <= 64, P and N <= 128, the CTA's shared memory within
    227 KB)."""
    if Q > MAX_Q_BWD or max(P, N) > MAX_DIM:
        raise ValueError(f"the SSD backward kernel takes Q <= {MAX_Q_BWD} and P, N <= "
                         f"{MAX_DIM}, got Q={Q}, P={P}, N={N}")
    smem = bwd_smem_bytes(Q, N, P, bf16)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"the SSD backward kernel's shared memory at Q={Q}, N={N}, P={P}, "
                         f"{'bf16' if bf16 else 'fp32'} is {smem} bytes, over {MAX_SMEM_BYTES}")


# a CTA's own work beside its heads' (B and C, C B^T, dB and dC, the
# cluster's sums), counted in heads; chip_smoke.py phase 2 times every
# cluster size beside the one the rule picks
BWD_CTA_HEADS = 2


def bwd_cluster(units: int, heads_per_group: int, active: Callable[[int], int]) -> int:
    """CTAs that share a group's heads: of 1 .. 16, the one that takes the
    least time for ``units`` = B nc G clusters, counted as waves (``active(c)``
    clusters of c CTAs run at once; a size the card cannot hold is skipped)
    times the heads a CTA takes plus ``BWD_CTA_HEADS`` (on a tie, fewer
    waves). More CTAs a group take fewer heads each but need more room on
    the card at once."""
    best = None
    for c in range(min(MAX_CLUSTER, heads_per_group), 0, -1):
        hb = -(-heads_per_group // c)
        cl = -(-heads_per_group // hb)  # no CTA without a head
        held = active(cl)
        if held < 1:
            continue
        waves = -(-units // held)
        key = (waves * (hb + BWD_CTA_HEADS), waves)
        if best is None or key < best[0]:
            best = (key, cl)
    return 1 if best is None else best[1]


@functools.lru_cache(maxsize=None)
def _active_clusters(device: int, Q: int, N: int, P: int, cluster: int, bf16: bool) -> int:
    """Clusters of ``cluster`` K4-bwd CTAs that card ``device`` holds at once
    (cudaOccupancyMaxActiveClusters for the plan's shared memory)."""
    with torch.cuda.device(device):
        n = ctypes.c_int(0)
        err = launcher(SOURCES[1], [INT] * 6 + [VP], "clusters")(
            Q, N, P, cluster, cluster, int(bf16), ctypes.addressof(n))
        raise_on(err, "ssd_chunk_bwd_clusters")
        return n.value


def bwd_launch_plan(B: int, L: int, H: int, G: int, Q: int, P: int, N: int, bf16: bool,
                    device: torch.device) -> BwdPlan:
    """The plan ``ssd_chunk_bwd_kernel`` launches on a CUDA ``device`` for
    these shapes: the cluster size from the card's residency
    (``bwd_cluster``), worked out once per shape and card."""
    card = device.index if device.index is not None else torch.cuda.current_device()
    return _launch_plan(B, -(-L // Q), H, G, Q, P, N, bf16, card)


@functools.lru_cache(maxsize=None)
def _launch_plan(B, nc, H, G, Q, P, N, bf16, card) -> BwdPlan:
    cluster = bwd_cluster(B * nc * G, H // G,
                          lambda c: _active_clusters(card, Q, N, P, c, bf16))
    return bwd_plan(Q, P, N, H // G, bf16, cluster)


def ssd_chunk_bwd_kernel(
    x: torch.Tensor,  # (B, L, H, P) fp32 or bf16, the forward's inputs
    dt: torch.Tensor,
    A: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    dY: torch.Tensor,  # (B, L, H, P) fp32 dense: cotangent of Y_intra
    dS: torch.Tensor,  # (B, nc, H, N, P) fp32 dense: of S_local
    da: torch.Tensor,  # (B, nc, H) fp32 dense: of a_tot
    chunk: int = 64,
    cluster: Optional[int] = None,
) -> Tuple[torch.Tensor, ...]:
    """(dx (B,L,H,P) in x's dtype, d(dt) (B,L,H) fp32, dA (H,) fp32, dB and
    dC (B,L,G,N) in x's dtype, summed over each group's heads). ``cluster``
    CTAs (1 .. 16) share a group's heads; None takes ``bwd_launch_plan``'s."""
    B, L, H, G, Q, P, N = _check_inputs(x, dt, A, Bm, Cm, chunk)
    bf16 = x.dtype == torch.bfloat16
    check_bwd_shape(Q, P, N, bf16)
    f32, dev = torch.float32, x.device
    nc = -(-L // Q)
    for name, t, shape in (("dY", dY, (B, L, H, P)), ("dS", dS, (B, nc, H, N, P)),
                           ("da", da, (B, nc, H))):
        check_tensor(name, t, shape, f32, dev, "dense")
    dx = torch.empty((B, L, H, P), dtype=x.dtype, device=dev)
    ddt = torch.empty((B, L, H), dtype=f32, device=dev)
    dA = torch.empty((H,), dtype=f32, device=dev)
    dB = torch.empty((B, L, G, N), dtype=x.dtype, device=dev)
    dC = torch.empty((B, L, G, N), dtype=x.dtype, device=dev)
    dA_part = torch.empty((B, nc, H), dtype=torch.float64, device=dev)
    if cluster is None:
        cluster = bwd_launch_plan(B, L, H, G, Q, P, N, bf16, dev).cluster
    elif not 1 <= cluster <= MAX_CLUSTER:
        raise ValueError(f"clusters of 1 .. {MAX_CLUSTER} CTAs, got {cluster}")
    err = launcher(SOURCES[1], _BWD_ARGTYPES)(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        dY.data_ptr(), dS.data_ptr(), da.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
        dA.data_ptr(), dB.data_ptr(), dC.data_ptr(), dA_part.data_ptr(), B, L, H, G, Q, P, N,
        int(bf16), cluster,
        *_strides(x, dt, Bm, Cm), torch.cuda.current_stream(dev).cuda_stream,
    )
    raise_on(err, "ssd_chunk_bwd")
    ssd_chunk_bwd_kernel.launches += 1
    return dx, ddt, dA, dB, dC


ssd_chunk_bwd_kernel.launches = 0
