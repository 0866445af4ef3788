"""sdca_roofline: the least time one local SDCA round needs on an H100,
over the device time of the ``sdca::`` kernels (K1, ``kernels/sdca``) a
round in the profiled fits, in percent.

The least time is the larger of two terms, counted from the shapes as the
algorithm needs them, whatever implements the round:
  * operations: each of the H coordinate steps of each of the m tasks takes
    two dot products of length d (x . w and x . r) and one axpy of length d
    (r += delta x), 4 m H d in all (||x||^2 is a property of the data); at
    the float32 peak (the fit runs with TF32 off);
  * bytes: each drawn row (d floats), its alpha and its label read once,
    each drawn coordinate's delta written once, w read once and r written
    once, m H (4 d + 12) + 8 m d; at the HBM peak.
This formula is frozen here: it reads the same work for any design of K1.
It is the benchmark's own; the port's count (``kernels/sdca/ops.py``
``k1_cost`` at commit 80b0bbf) counts K1's block-Gram design instead.
"""
from perfbench import peaks


def least_seconds(m: int, H: int, d: int) -> float:
    flops = 4.0 * m * H * d
    nbytes = m * H * (4.0 * d + 12.0) + 8.0 * m * d
    return max(flops / peaks.FP32_FLOPS, nbytes / peaks.HBM_BYTES_PER_S)


def read(record):
    rounds = record.get("counters", {}).get("rounds_profiled")
    sdca = sum(e - s for name, s, e in record.get("kernels", []) if "sdca::" in name) * 1e-6
    if not rounds or sdca <= 0.0:
        return None
    sh = record["shapes"]
    return 100.0 * least_seconds(sh["m"], sh["H"], sh["d"]) / (sdca / rounds)
