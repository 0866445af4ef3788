#!/usr/bin/env python3
"""The program's own spans inside whole fits: how long each layer of the
fit takes, and what the program was doing while the device idled.

    python3 perfbench/spans.py --workload <cell> --seed <n> [--seconds <s>] [--fits <k>]

The run builds the cell's program as ``run.py`` does, fits once to warm up,
then fits with tracing off for ``--seconds`` (the reference ``fit_s`` of
the overhead), then makes two passes of k more fits:

  (a) the span pass: ``obs`` on, no profiler. Per span name of the fit
      (``core/dmtrl.py``: ``w_round``, ``coords``, ``local_sdca``,
      ``reduce``, ``objectives``, ``host_read``, ``rho``, ``w_step``,
      ``omega_step``, ``w_from_alpha``, under the engine's ``engine_run``)
      its count, total and self seconds: the ``program`` record that
      ``READINGS`` read.
  (b) the attribution pass: ``obs`` on ``obs.wall_clock``, the timeline of
      ``torch.profiler``'s events, under the profiler. Each stretch in
      which nothing ran on the device is put down to the innermost span
      covering it, by path (``w_step/w_round/coords``); what no span
      covers reads ``(no span)``. The profiler slows the host, so these
      fits are longer than the others.

Last come k fits with tracing off and k with it on, in turns, five times.
Standard error gets the tables: for each span name its count a fit, ms a
call, self ms a fit and the device-idle ms a fit of which it is the
innermost span; the idle by path; the ten longest idle stretches inside a
fit; and the overhead, as pass (a)'s mean fit against the untraced
``fit_s`` and as the median on against off of the turns. Standard output
gets one JSON line of all of it. A card is needed.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

ROOT = Path(__file__).resolve().parents[1]
NO_SPAN = "(no span)"
ROOT_SPAN = "engine_run"


# -- the readings of the program record -------------------------------------
def _per_call_ms(name: str) -> Callable[[Dict], Optional[float]]:
    def read(program: Dict) -> Optional[float]:
        row = program.get("spans", {}).get(name)
        return row["total_s"] / row["count"] * 1e3 if row and row["count"] else None
    return read


def _sync_wait_ms(program: Dict) -> Optional[float]:
    row = program.get("spans", {}).get("host_read")
    return row["total_s"] / program["fits"] * 1e3 if row and program.get("fits") else None


# per-layer readings of the span pass's record, each in ms: a call of the
# named span, or (sync_wait_ms) the host's waits for device values a fit
READINGS: Dict[str, Callable[[Dict], Optional[float]]] = {
    "fit_round_ms": _per_call_ms("w_round"),
    "fit_omega_ms": _per_call_ms("omega_step"),
    "coords_ms": _per_call_ms("coords"),
    "objectives_ms": _per_call_ms("objectives"),
    "sync_wait_ms": _sync_wait_ms,
}


def readings(program: Dict) -> Dict[str, Optional[float]]:
    return {name: read(program) for name, read in READINGS.items()}


# -- idle stretches put down to spans --------------------------------------
def self_segments(events: List[Dict]) -> List[Tuple[float, float, str]]:
    """The spans of one thread cut into (start_us, end_us, path): the
    stretches in which each span is the innermost one open, its path the
    names from the outermost down, ``engine_run/`` left off."""
    segs: List[Tuple[float, float, str]] = []
    stack: List[list] = []  # [end, path, emitted_until] of the open spans

    def close_until(t: float) -> None:
        while stack and stack[-1][0] <= t:
            end, path, cur = stack.pop()
            if end > cur:
                segs.append((cur, end, path))
            if stack:
                stack[-1][2] = max(stack[-1][2], min(end, stack[-1][0]))

    for ev in sorted(events, key=lambda e: (e["ts"], -e["dur"])):
        t0, t1 = ev["ts"], ev["ts"] + ev["dur"]
        close_until(t0)
        if stack:
            parent = stack[-1]
            if t0 > parent[2]:
                segs.append((parent[2], t0, parent[1]))
            parent[2] = max(parent[2], t0)
            path = ev["name"] if parent[1] == ROOT_SPAN else f"{parent[1]}/{ev['name']}"
        else:
            path = ev["name"]
        stack.append([t1, path, t0])
    close_until(math.inf)
    return sorted(segs)


def idle_by_span(gaps: List[Tuple[float, float]], segs: List[Tuple[float, float, str]],
                 top: int = 10) -> Dict:
    """Each gap's microseconds put down to the paths of the segments that
    cover it (``(no span)`` for the rest): the seconds by path, and the
    ``top`` longest gaps inside a fit, each named by the path covering most
    of it: [path, seconds, that path's share of the gap, {path: share} of
    every path in it]. A gap that no span covers most of lies between fits
    and is not among them."""
    by_path: Dict[str, float] = {}
    named = []
    j = 0
    for g0, g1 in sorted(gaps):
        while j < len(segs) and segs[j][1] <= g0:
            j += 1
        here: Dict[str, float] = {}
        k = j
        while k < len(segs) and segs[k][0] < g1:
            s0, s1, path = segs[k]
            cover = min(g1, s1) - max(g0, s0)
            if cover > 0:
                here[path] = here.get(path, 0.0) + cover
            k += 1
        rest = (g1 - g0) - sum(here.values())
        if rest > 1e-9:
            here[NO_SPAN] = rest
        for path, us in here.items():
            by_path[path] = by_path.get(path, 0.0) + us * 1e-6
        path, us = max(here.items(), key=lambda kv: kv[1])
        if path != NO_SPAN:
            parts = {p: v / (g1 - g0) for p, v in here.items()}
            named.append([path, (g1 - g0) * 1e-6, us / (g1 - g0), parts])
    named.sort(key=lambda row: -row[1])
    return dict(by_path=by_path, longest=named[:top])


# -- the two passes ---------------------------------------------------------
def _enable(clock: Callable[[], float]):
    """The tracer on, empty, with room for every span of a pass."""
    from repro_torch import obs
    from repro_torch.obs.trace import DEFAULT_CAPACITY

    return obs.enable(clear=True, capacity=DEFAULT_CAPACITY, clock=clock)


def _driver_events(tracer) -> List[Dict]:
    """The fit's spans: cat ``driver``, on the thread that ran the fit."""
    if tracer.dropped:
        raise RuntimeError(f"{tracer.dropped} spans fell off the tracer's ring buffer")
    events = [e for e in tracer.events() if e.get("cat") == "driver"]
    tids = {e["tid"] for e in events if e["name"] == ROOT_SPAN}
    return [e for e in events if not tids or e["tid"] in tids]


def span_pass(fit: Callable[[], None], k: int) -> Dict:
    """(a): k fits with ``obs`` on and no profiler; the program record,
    with K1's launches over the pass (``sdca_round_kernel.launches``)."""
    from repro_torch import obs
    from repro_torch.kernels.sdca.sdca_kernel import sdca_round_kernel
    from repro_torch.obs.trace import self_times

    tracer = _enable(time.perf_counter)
    launches, t0 = sdca_round_kernel.launches, time.perf_counter()
    for _ in range(k):
        fit()
    seconds = time.perf_counter() - t0
    obs.disable()
    events = _driver_events(tracer)
    tracer.clear()
    return dict(fits=k, fit_s=seconds / k, spans=self_times(events),
                k1_launches=sdca_round_kernel.launches - launches)


def attribution_pass(fit: Callable[[], None], k: int) -> Dict:
    """(b): k fits under ``torch.profiler`` with ``obs`` on the profiler's
    clock; the device's idle stretches put down to the spans."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from perfbench import trace
    from repro_torch import obs

    tracer = _enable(obs.wall_clock)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(k):
            fit()
        seconds = time.perf_counter() - t0
    obs.disable()
    events = _driver_events(tracer)
    tracer.clear()
    base_us = prof.profiler.kineto_results.trace_start_ns() / 1e3
    device = [(e.name, float(e.time_range.start), float(e.time_range.end))
              for e in prof.events() if e.device_type != DeviceType.CPU]
    for ev in events:  # onto the profiler's own microseconds
        ev["ts"] -= base_us
    gaps = trace.gaps(device)
    out = idle_by_span(gaps, self_segments(events))
    out.update(fits=k, fit_s=seconds / k, idle_s=sum(b - a for a, b in gaps) * 1e-6,
               busy_s=trace.busy_seconds(device))
    return out


def overhead(fit: Callable[[], None], k: int, turns: int = 5) -> Dict:
    """Mean fit seconds with tracing off and on, k fits a side, the sides
    in turns (off, on) ``turns`` times: the medians over the turns."""
    from repro_torch import obs

    sides: Dict[str, List[float]] = {"off_s": [], "on_s": []}
    for _ in range(turns):
        for side in sides:
            if side == "on_s":
                _enable(time.perf_counter)
            t0 = time.perf_counter()
            for _ in range(k):
                fit()
            sides[side].append((time.perf_counter() - t0) / k)
            obs.disable()
    out = {side: statistics.median(v) for side, v in sides.items()}
    out["span_s"] = span_cost()
    return out


def span_cost(n: int = 20000) -> float:
    """Seconds one recorded span adds on this host (enter, clock reads,
    record at exit), over the disabled span's cost."""
    from repro_torch import obs

    def loop() -> float:
        t0 = time.perf_counter()
        for _ in range(n):
            with obs.span("cost", cat="driver"):
                pass
        return time.perf_counter() - t0

    off = loop()
    _enable(time.perf_counter)
    on = loop()
    obs.disable()
    obs.get_tracer().clear()
    return (on - off) / n


# -- the report -------------------------------------------------------------
def by_name(by_path: Dict[str, float]) -> Dict[str, float]:
    """Idle seconds by the innermost span's name (a path's last part)."""
    out: Dict[str, float] = {}
    for path, s in by_path.items():
        name = path if path == NO_SPAN else path.rsplit("/", 1)[-1]
        out[name] = out.get(name, 0.0) + s
    return out


def report(program: Dict, idle: Dict, fit_s: float, turns: Dict, log=sys.stderr) -> None:
    k, ki = program["fits"], idle["fits"]
    spans_a_fit = sum(row["count"] for row in program["spans"].values()) / k
    idle_name = by_name(idle["by_path"])
    print(f"[spans] {'span':14s} {'n/fit':>7s} {'ms/call':>9s} {'self ms/fit':>12s} "
          f"{'idle ms/fit':>12s}", file=log)
    for name, row in sorted(program["spans"].items(), key=lambda kv: -kv[1]["total_s"]):
        print(f"[spans] {name:14s} {row['count'] / k:7.1f} "
              f"{row['total_s'] / row['count'] * 1e3:9.4f} {row['self_s'] / k * 1e3:12.4f} "
              f"{idle_name.get(name, 0.0) / ki * 1e3:12.4f}", file=log)
    if NO_SPAN in idle_name:
        print(f"[spans] {NO_SPAN:14s} {'':7s} {'':9s} {'':12s} "
              f"{idle_name[NO_SPAN] / ki * 1e3:12.4f}", file=log)
    total = idle["idle_s"] or 1.0
    for path, s in sorted(idle["by_path"].items(), key=lambda kv: -kv[1]):
        print(f"[idle] {path:40s} {s / ki * 1e3:9.4f} ms/fit {100 * s / total:6.2f} %",
              file=log)
    for path, s, share, parts in idle["longest"]:
        rest = ", ".join(f"{p} {100 * v:.1f} %" for p, v in
                         sorted(parts.items(), key=lambda kv: -kv[1])[1:4])
        print(f"[gap] {s * 1e3:8.4f} ms {path} ({100 * share:.1f} % of it; {rest})", file=log)
    for name, value in readings(program).items():
        print(f"[reading] {name} {value!r}", file=log)
    sp = program["spans"]
    if "w_round" in sp and "host_read" in sp:
        print(f"[counts] K1 launches a round {program['k1_launches'] / sp['w_round']['count']:.2f}, "
              f"host reads a fit {sp['host_read']['count'] / k:.1f}", file=log)
    print(f"[overhead] traced fit {program['fit_s']:.5f} s against fit_s {fit_s:.5f} s: "
          f"{100 * (program['fit_s'] / fit_s - 1):+.2f} %; in turns, on {turns['on_s']:.5f} s "
          f"against off {turns['off_s']:.5f} s: {100 * (turns['on_s'] / turns['off_s'] - 1):+.2f} %; "
          f"{spans_a_fit:.0f} spans a fit at {turns['span_s'] * 1e6:.2f} us a span: "
          f"{spans_a_fit * turns['span_s'] * 1e3:.3f} ms a fit; "
          f"profiled fit {idle['fit_s']:.5f} s, idle {idle['idle_s'] / idle['fits'] * 1e3:.2f} "
          f"ms and busy {idle['busy_s'] / idle['fits'] * 1e3:.2f} ms a profiled fit", file=log)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--fits", type=int, default=0, help="k; 0: as run.py, about a second")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench.run import cache_env, data_seed

    cache_env()
    from perfbench import spec

    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print(f"perfbench: {args.workload} needs a CUDA card", file=sys.stderr)
        return 3
    from perfbench.program import Program

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prog = Program(spec.make_data(cell.config, data_seed(args.seed)), cell.config,
                   cell.traffic, args.seed, "cuda")
    prog.fit()
    each, t0 = [], time.perf_counter()
    while not each or each[-1] - t0 < args.seconds:
        prog.fit()
        each.append(time.perf_counter())
    fit_s = (each[-1] - t0) / len(each)
    k = args.fits or max(1, min(5, math.ceil(1.0 / fit_s)))
    program = span_pass(prog.fit, k)
    idle = attribution_pass(prog.fit, k)
    turns = overhead(prog.fit, k)
    report(program, idle, fit_s, turns)
    print(json.dumps(dict(workload=args.workload, seed=args.seed,
                          device=torch.cuda.get_device_name(0), fit_s=fit_s,
                          fit_each_s=[b - a for a, b in zip([t0] + each, each)],
                          program=program, readings=readings(program), idle=idle,
                          turns=turns)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
