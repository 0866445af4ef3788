"""Probe (not a test): the final duality gap of a threaded fit at tau = 1
with a straggler, the JAX package's host server (snapshots serve the round
boundary alone) against the port's (the boundary plus the worker's own
commits since), beside tau = 0. Thread arrival order varies from run to
run, so each runs several times. On the CPU:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/probe_read_your_writes.py [runs]
"""
import sys

import numpy as np

from repro.core import AsyncOptions as JOptions
from repro.core import DMTRLConfig as JConfig
from repro.core import MeshAxes
from repro.core.async_dmtrl import fit_async as jfit_async
from repro.data.synthetic import mnist_like as jmnist
from repro_torch.core import AsyncOptions, DMTRLConfig, fit_async
from repro_torch.data.synthetic import mnist_like

CFG = dict(solver="block_gram", loss="hinge", lam=1e-4, outer_iters=2, rounds=3, block_size=64)
SCALE, DELAYS = 0.1, (1, 4)


def main(runs: int) -> None:
    jtrain, ttrain = jmnist(scale=SCALE, seed=0).train, mnist_like(scale=SCALE, seed=0).train
    print(f"mnist_like(scale={SCALE}) x {tuple(ttrain.x.shape)}, {CFG}, 2 workers, "
          f"delays {DELAYS} at tau 1")

    def jax_gap(**kw):
        opts = JOptions(transport="threaded", n_workers=2, **kw)
        h = jfit_async(JConfig(**CFG), jtrain, None, MeshAxes(data="data"), options=opts)[3]
        return float(h["gap"][-1])

    def port_gap(**kw):
        opts = AsyncOptions(transport="threaded", n_workers=2, **kw)
        h = fit_async(DMTRLConfig(**CFG), ttrain, options=opts, device="cpu")[3]
        return float(h["gap"][-1])

    for name, gap in (("JAX (boundary)", jax_gap), ("port (own writes)", port_gap)):
        tau0 = gap()
        tau1 = [gap(tau=1, async_delays=DELAYS) for _ in range(runs)]
        print(f"{name}: final gap at tau 0 {tau0:.4f}; at tau 1 "
              f"{np.array2string(np.asarray(tau1), precision=4)} "
              f"(max {max(tau1) / tau0:.2f}x tau 0)")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 6)
