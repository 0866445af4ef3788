#!/usr/bin/env python3
"""The readings that the limits of ``limits/<cell>.json`` are set from.

    python3 perfbench/control.py --workload <cell> --seeds 1 2 3 [--no-control] [--faults]

For each seed, in one process: the cell's data, one fit of the program as
the timed path runs it, the float64 reference, the control (the reference
in TF32, in the program's place) and, with ``--faults``, one fit of the
program with each fault of ``faults.py`` planted. Prints one JSON line a
seed with the compared numbers of each against the reference; the
program's give each limit its lower reading, the control's and the
faults' its upper one. The benchmark's own runs do not run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, seed: int, device: str, control: bool = True, faults=()) -> dict:
    import numpy as np
    import torch

    from perfbench import check, spec
    from perfbench.faults import planted
    from perfbench.program import Program
    from perfbench.reference import algorithm1
    from perfbench.run import data_seed

    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    conf = cell.config
    arrays = spec.make_data(conf, data_seed(seed))

    def program():
        prog = Program(arrays, conf, cell.traffic, seed, device)
        prog.fit()
        out = prog.outputs()
        prog.close()
        return out

    outs = {"program": program()}
    for name in faults:
        with planted(name):
            outs[name] = program()
    job = algorithm1.job_from(cell.traffic, conf)
    args = (arrays.xtr, arrays.ytr, arrays.xte, arrays.yte, job, seed)
    t0 = time.perf_counter()
    ref = algorithm1.fit(*args, device=device)
    line = dict(seed=seed, reference_s=time.perf_counter() - t0)
    for name, out in outs.items():
        line[name] = check.numbers(out, ref)
    if control:
        ctl = algorithm1.fit(*args, device=device, precision="tf32")
        as_out = dict(W=ctl.W, alpha=ctl.alpha, sigma=ctl.sigma, rho=np.asarray(ctl.rho),
                      dual=np.asarray(ctl.dual), primal=np.asarray(ctl.primal),
                      scores=ctl.scores)
        line["control"] = check.numbers(as_out, ref)
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--no-control", action="store_true")
    ap.add_argument("--faults", action="store_true")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench import faults, spec
    from perfbench.run import cache_env

    cache_env()
    import torch

    if not torch.cuda.is_available():
        print("perfbench control: no CUDA card", file=sys.stderr)
        return 3
    cell = spec.cell(args.workload)
    for seed in args.seeds:
        print(json.dumps(readings(cell, seed, "cuda", not args.no_control,
                                  faults.NAMES if args.faults else ())), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
