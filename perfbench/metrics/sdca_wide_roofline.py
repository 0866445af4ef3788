"""sdca_wide_roofline: K1's share of its least time at large d, where stage
2 streams the block's rows (``mds.fit``): the least time of one local SDCA
round, ``least_seconds(m, H, d)`` of ``metrics/sdca_roofline.py`` (loaded
from that file, not copied), over the device time of every ``sdca::``
kernel a profiled round, in percent. Nothing where no ``sdca::`` kernel
ran."""
from perfbench import spec

least_seconds = spec.metric_module("sdca_roofline").least_seconds


def read(record):
    rounds = record.get("counters", {}).get("rounds_profiled")
    sdca = sum(e - s for name, s, e in record.get("kernels", []) if "sdca::" in name) * 1e-6
    if not rounds or sdca <= 0.0:
        return None
    sh = record["shapes"]
    return 100.0 * least_seconds(sh["m"], sh["H"], sh["d"]) / (sdca / rounds)
