"""sdca_stream_roofline: the share of its least time that K1's streaming
stage 2 (``sdca::chain_stream_kernel``, ``kernels/sdca/csrc/sdca_stream.cuh``)
reaches, over its device time a profiled round, in percent. Nothing where
that kernel did not run.

The least time of the stage-2 work of one round on an H100 is the larger
of two terms, counted from the shapes (m tasks, H steps of blocks of B, d
features):
  * bytes: every drawn row read once (m H 4 d), every block's scratch of
    stage 1 read once (m (H / B) (B^2 + 4 B) 4: the Gram, q, the labels,
    alphas and ids) and r written once (4 m d); at the HBM peak;
  * operations: per step the dot product x . r and the axpy r += delta x,
    and per block the B x B recursion's share is not counted: 4 m H d at
    the float32 peak (the fit runs with TF32 off).
This formula is frozen here: it reads the same work for any design of the
streaming stage 2.
"""
from perfbench import peaks

KERNEL = "sdca::chain_stream_kernel"


def least_seconds(m: int, H: int, d: int, B: int) -> float:
    nbytes = m * H * 4.0 * d + m * (H // B) * (B * B + 4.0 * B) * 4.0 + 4.0 * m * d
    flops = 4.0 * m * H * d
    return max(nbytes / peaks.HBM_BYTES_PER_S, flops / peaks.FP32_FLOPS)


def read(record):
    rounds = record.get("counters", {}).get("rounds_profiled")
    busy = sum(e - s for name, s, e in record.get("kernels", []) if KERNEL in name) * 1e-6
    if not rounds or busy <= 0.0:
        return None
    sh = record["shapes"]
    return 100.0 * least_seconds(sh["m"], sh["H"], sh["d"], sh["B"]) / (busy / rounds)
