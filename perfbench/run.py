#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result as one JSON line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``) names a configuration (``configs/``) and a
traffic mix (``traffic/``). The run makes the configuration's data from
the seed, builds ``repro_torch.core.DMTRLEstimator`` on the card, fits once
to warm up (set-up ends there), then fits again and again from scratch,
each fit one job a trainer submits, until ``--seconds`` have passed; the
window ends at the first fit boundary after that.

``--trace 0`` reports the end-to-end metrics: ``fit_s`` (the window over
the fits it finished), ``peak_gb`` (the window's peak of allocated device
memory) and ``setup_s`` (process start to the first timed fit).
``--trace 1`` runs the same window, then profiles a few more fits, times
one communication round and one Omega-step on the fitted state, and reports the
per-layer metrics that ``metrics/<name>.py`` read from that record.

After the window the last fit's outputs are compared with the plain
reference (``reference/algorithm1.py``), each number beside its limit
(``limits/<cell>.json``); the numbers close standard error and the result
line. The run fails without a card, with fewer cards than the cell asks
for, and when ``jax``, ``jaxlib``, ``flax`` or ``repro`` was imported.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def cache_env(root: Path = ROOT) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (``build/`` is where the port's nvcc builds go already), and one host
    thread for torch's and numpy's own work: the fit's host side is a
    single Python thread launching kernels, and idle worker threads of an
    OpenMP pool only compete with it for the host's shared cores."""
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["MKL_NUM_THREADS"] = "1"
    build = root / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the run may not hold."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & FORBIDDEN)


def data_seed(seed: int) -> int:
    """numpy's RandomState takes seeds below 2**32 (mnist_like adds 2)."""
    return seed % 2**31


def _trace_record(prog, fit_s: float) -> tuple:
    """Profile a few more fits (about a second), time one communication
    round and the Omega-step; the record the metric readers read, and the
    trace."""
    from perfbench import trace

    k = max(1, min(5, math.ceil(1.0 / max(fit_s, 1e-9))))

    def fits():
        for _ in range(k):
            prog.fit()

    tr = trace.profile(fits)
    shapes = prog.shapes()
    spans = {"round": prog.time_round(), "omega_step": prog.time_omega()}
    record = dict(
        shapes=shapes, fit_s=fit_s, device=dict(busy_s=tr["busy_s"], window_s=tr["window_s"]),
        kernels=tr["device"], spans=spans,
        counters=dict(fits_profiled=k, rounds_profiled=k * shapes["outer_iters"] * shapes["rounds"]),
    )
    return record, tr


def run(cell, seed: int, seconds: float, traced: bool, device: str = "cuda",
        t_start: float = T_START, log=sys.stderr) -> dict:
    """One run of ``cell`` (a ``spec.Cell``); the result line as a dict."""
    import numpy as np
    import torch

    from perfbench import check, spec, trace
    from perfbench.program import Program
    from perfbench.reference import algorithm1

    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    conf = cell.config
    job = algorithm1.job_from(cell.traffic, conf)  # refuses what the reference cannot judge
    marks = [("start", t_start), ("torch", time.perf_counter())]
    arrays = spec.make_data(conf, data_seed(seed))
    marks.append(("data", time.perf_counter()))
    prog = Program(arrays, conf, cell.traffic, seed, device)
    marks.append(("on_device", time.perf_counter()))
    prog.fit()  # the warm fit: K1 built or loaded, the libraries set up
    setup_s = time.perf_counter() - t_start
    marks.append(("warm_fit", t_start + setup_s))
    print("[setup] " + ", ".join(f"{b[0]} {b[1] - a[1]:.3f} s" for a, b in zip(marks, marks[1:])),
          file=log)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    fits, t0, each = 0, time.perf_counter(), []
    while True:
        prog.fit()
        fits += 1
        each.append(time.perf_counter())
        if each[-1] - t0 >= seconds:
            break
    window = each[-1] - t0
    fit_s = window / fits
    q = np.percentile(np.diff([t0] + each), [10, 50, 90])
    print(f"[fits] p10 {q[0]:.4f} p50 {q[1]:.4f} p90 {q[2]:.4f} s", file=log)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    print(f"[window] {fits} fits in {window:.3f} s, setup {setup_s:.3f} s, "
          f"peak {peak} bytes", file=log)
    dev = dict(platform="gpu" if on_card else "cpu",
               kind=torch.cuda.get_device_name(0) if on_card else "cpu",
               count=cell.chips, memory_peak_bytes=int(peak))
    breakdown = None
    if traced:
        record, tr = _trace_record(prog, fit_s)
        dev.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        metrics = {}
        for m in cell.per_layer:
            value = spec.reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = dict(value=value, unit=m["unit"])
        breakdown = trace.breakdown(tr)
    else:
        values = dict(fit_s=fit_s, peak_gb=peak / 1e9, setup_s=setup_s)
        metrics = {m["name"]: dict(value=values[m["name"]], unit=m["unit"])
                   for m in cell.end_to_end}
    outputs = prog.outputs()
    prog.close()
    t_ref = time.perf_counter()
    ref = algorithm1.fit(arrays.xtr, arrays.ytr, arrays.xte, arrays.yte, job, seed,
                         device=device)
    verdict = check.judge(check.numbers(outputs, ref), cell.limits)
    print(f"[reference] {time.perf_counter() - t_ref:.3f} s", file=log)
    result = dict(correct=all(v["ok"] for v in verdict.values()), attempted=fits, failed=0,
                  metrics=metrics, device=dev)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: dict(value=v["value"], limit=v["limit"]) for k, v in verdict.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench import spec

    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA card(s), found {have}",
              file=sys.stderr)
        return 3
    result = run(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"perfbench: the run imported {found}", file=sys.stderr)
        return 4
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
