"""The device trace of a traced run, from ``torch.profiler``.

``profile(fn)`` runs ``fn`` under the profiler and returns the device's
entries (kernels, copies, memsets) and the host's operators as plain
tuples, the seconds the host spent, and the union of the device's busy
intervals. ``breakdown`` names where the device's time went and, for the
longest stretches in which nothing ran on it, what the host was doing.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Tuple

# (name, start_us, end_us)
Interval = Tuple[str, float, float]


def profile(fn: Callable[[], None]) -> Dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        window_s = time.perf_counter() - t0
    device: List[Interval] = []
    host: List[Interval] = []
    for e in prof.events():
        iv = (e.name, float(e.time_range.start), float(e.time_range.end))
        (host if e.device_type == DeviceType.CPU else device).append(iv)
    return dict(device=device, host=host, window_s=window_s, busy_s=busy_seconds(device))


def busy_seconds(device: List[Interval]) -> float:
    """Length of the union of the device's intervals."""
    busy, end = 0.0, float("-inf")
    for _, s, e in sorted(device, key=lambda iv: iv[1]):
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy * 1e-6


def gaps(device: List[Interval]) -> List[Tuple[float, float]]:
    """Stretches (start_us, end_us) in which nothing ran on the device,
    between its first and its last entry."""
    out, end = [], None
    for _, s, e in sorted(device, key=lambda iv: iv[1]):
        if end is not None and s > end:
            out.append((end, s))
        end = e if end is None else max(end, e)
    return out


def breakdown(tr: Dict, top: int = 10) -> Dict:
    """The device operations that took most time, and the longest idle
    gaps, each named by the innermost host operator running through it."""
    by_name: Dict[str, float] = {}
    for name, s, e in tr["device"]:
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(gaps(tr["device"]), key=lambda g: g[0] - g[1])[:top]
    named = []
    for s, e in idle:
        mid = 0.5 * (s + e)
        around = [iv for iv in tr["host"] if iv[1] <= mid <= iv[2]]
        inner = min(around, key=lambda iv: iv[2] - iv[1])[0] if around else "host"
        named.append([inner, (e - s) * 1e-6])
    return dict(device_ops=[[n, v] for n, v in ops], idle_gaps=named)
