"""Span tracer: thread-safe, nestable, ring-buffered, Chrome-trace export.

The tracer answers "where does wall-clock go?" for an async training run
or a fleet simulation: every instrumented site wraps its work in

    with span("commit", worker=g, round=r):
        ...

and the closed span lands as one record in a process-wide ring buffer
(bounded memory — old spans fall off, recent history survives).  Spans
nest per thread automatically: Chrome's trace viewer reconstructs the
nesting from time containment of complete ("ph": "X") events on one
thread track, so a worker thread's ``round`` span visually contains its
``gate`` / ``solve`` / ``commit`` children with no explicit parent ids.

Design constraints (the JAX package's ``benchmarks/bench_obs.py``
measures them on its copy of this module):

  * **nearly free when disabled** — ``span()`` is one module-global flag
    check returning a shared no-op context manager; no allocation, no
    lock, no clock read.  ``obs.disable()`` is the production default.
  * **injectable clock** — ``set_clock`` swaps ``time.perf_counter`` for
    a virtual clock so deterministic fleet sims trace in virtual time, or
    for ``wall_clock``, the epoch timeline ``torch.profiler`` stamps its
    host and device events on, so spans and a device trace line up.
  * **thread-safe** — the only shared mutation is the ring-buffer append
    and the thread-id table, both under one small lock taken at span
    EXIT (never while a caller's own lock ordering matters: the tracer
    never calls back out).

Export is the Chrome trace-event JSON format (``ph: "X"`` complete
events, microsecond timestamps, per-thread tracks with ``M`` metadata
names) — loadable in ``chrome://tracing`` and Perfetto.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

__all__ = [
    "Tracer",
    "span",
    "enable",
    "disable",
    "enabled",
    "set_clock",
    "wall_clock",
    "get_tracer",
    "export_chrome",
    "phase_breakdown",
    "self_time_breakdown",
    "self_times",
]

DEFAULT_CAPACITY = 262_144  # ring-buffer slots (one dict per closed span)


class Tracer:
    """Process-wide span sink: ring buffer + thread-id table + export."""

    def __init__(
        self,
        capacity: int = DEFAULT_CAPACITY,
        clock: Callable[[], float] = time.perf_counter,
    ):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.clock = clock
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=self.capacity)
        self._dropped = 0
        self._tids: Dict[int, int] = {}  # thread ident -> small stable tid
        self._tid_names: Dict[int, str] = {}
        self._pid = os.getpid()

    # -- recording ----------------------------------------------------------
    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            tid = len(self._tids)
            self._tids[ident] = tid
            self._tid_names[tid] = threading.current_thread().name
        return tid

    def record(
        self, name: str, cat: str, t0: float, dur: float, args: Optional[dict]
    ) -> None:
        ev = {
            "name": name,
            "cat": cat,
            "ph": "X",
            "ts": t0 * 1e6,  # Chrome wants microseconds
            "dur": dur * 1e6,
            "pid": self._pid,
        }
        if args:
            ev["args"] = args
        with self._lock:
            ev["tid"] = self._tid()
            if len(self._events) == self.capacity:
                self._dropped += 1
            self._events.append(ev)

    # -- introspection ------------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    @property
    def dropped(self) -> int:
        """Spans that fell off the ring buffer (capacity exceeded)."""
        with self._lock:
            return self._dropped

    def events(self) -> List[dict]:
        """A snapshot copy of the buffered span records (ts order within
        each thread; cross-thread order is append order)."""
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._dropped = 0

    def set_clock(self, clock: Callable[[], float]) -> None:
        self.clock = clock

    # -- export -------------------------------------------------------------
    def export_chrome(self, path: str) -> int:
        """Write the buffer as Chrome trace-event JSON; returns the number
        of span events written.  Thread tracks are named with ``M``
        metadata events so worker threads read as ``dmtrl-worker-3`` in
        the viewer, not bare integers."""
        with self._lock:
            events = list(self._events)
            names = dict(self._tid_names)
        meta = [
            {
                "name": "thread_name",
                "ph": "M",
                "pid": self._pid,
                "tid": tid,
                "args": {"name": tname},
            }
            for tid, tname in sorted(names.items())
        ]
        doc = {
            "traceEvents": meta + events,
            "displayTimeUnit": "ms",
        }
        with open(path, "w") as f:
            json.dump(doc, f)
        return len(events)

    def phase_breakdown(self, cat: Optional[str] = None) -> Dict[str, dict]:
        """Wall-clock totals by span name: ``{name: {count, total_s,
        mean_s, max_s}}``.  Nested spans each count their own full
        duration (this is an inclusive-time breakdown: compare siblings,
        not a parent against its children)."""
        out: Dict[str, dict] = {}
        for ev in self.events():
            if cat is not None and ev.get("cat") != cat:
                continue
            row = out.setdefault(
                ev["name"], {"count": 0, "total_s": 0.0, "max_s": 0.0}
            )
            d = ev["dur"] / 1e6
            row["count"] += 1
            row["total_s"] += d
            row["max_s"] = max(row["max_s"], d)
        for row in out.values():
            row["mean_s"] = row["total_s"] / row["count"]
        return out


def self_times(events: List[dict]) -> Dict[str, dict]:
    """Totals by span name of Chrome complete events: ``{name: {count,
    total_s, self_s}}``. A span's self time is its duration minus the part
    of it that its children cover: the spans on the same (pid, tid) track
    whose interval lies inside it with no span between (time containment,
    as the trace viewer nests them). Summed over the names, self time is
    the wall time the outermost spans cover."""
    out: Dict[str, dict] = {}
    tracks: Dict[tuple, List[dict]] = {}
    for ev in events:
        tracks.setdefault((ev.get("pid"), ev.get("tid")), []).append(ev)
    for track in tracks.values():
        # parents first: by start, the longer of two that start together
        track.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack: List[list] = []  # [end_us, row] of the open ancestors
        for ev in track:
            t0, t1 = ev["ts"], ev["ts"] + ev["dur"]
            while stack and stack[-1][0] <= t0:
                stack.pop()
            row = out.setdefault(ev["name"], {"count": 0, "total_s": 0.0, "self_s": 0.0})
            row["count"] += 1
            row["total_s"] += ev["dur"] / 1e6
            row["self_s"] += ev["dur"] / 1e6
            if stack:  # the parent loses the part of it this child covers
                stack[-1][1]["self_s"] -= (min(t1, stack[-1][0]) - t0) / 1e6
            stack.append([t1, row])
    return out


class _Span:
    """One live span: clock at enter, record at exit."""

    __slots__ = ("_tracer", "_name", "_cat", "_args", "_t0")

    def __init__(self, tracer: Tracer, name: str, cat: str, args: dict):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._args = args

    def __enter__(self) -> "_Span":
        self._t0 = self._tracer.clock()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = self._tracer.clock()
        self._tracer.record(
            self._name, self._cat, self._t0, t1 - self._t0, self._args
        )
        return False


class _NullSpan:
    """The disabled path: a shared, allocation-free no-op context manager."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_NULL_SPAN = _NullSpan()
_TRACER = Tracer()
_ENABLED = False


def span(name: str, cat: str = "repro", **args):
    """Context manager timing one phase; a no-op unless ``obs.enable()``
    ran.  Keyword labels land in the Chrome-trace ``args`` pane."""
    if not _ENABLED:
        return _NULL_SPAN
    return _Span(_TRACER, name, cat, args)


def enable(
    *,
    capacity: Optional[int] = None,
    clock: Optional[Callable[[], float]] = None,
    clear: bool = False,
) -> Tracer:
    """Turn span recording on (idempotent); optionally resize the ring
    buffer, swap the clock, or clear prior history.  Returns the tracer."""
    global _ENABLED, _TRACER
    if capacity is not None and capacity != _TRACER.capacity:
        _TRACER = Tracer(capacity=capacity, clock=clock or _TRACER.clock)
    elif clock is not None:
        _TRACER.set_clock(clock)
    if clear:
        _TRACER.clear()
    _ENABLED = True
    return _TRACER


def disable() -> None:
    """Turn span recording off: every ``span()`` call collapses to the
    shared no-op (the nearly-free path).  Buffered
    spans stay exportable."""
    global _ENABLED
    _ENABLED = False


def enabled() -> bool:
    return _ENABLED


def wall_clock() -> float:
    """The host's wall clock in seconds since the epoch (``time.time_ns``):
    the timeline of ``torch.profiler``'s events, which sit at
    ``kineto_results.trace_start_ns()`` plus their ``time_range`` in
    microseconds."""
    return time.time_ns() * 1e-9


def set_clock(clock: Callable[[], float]) -> None:
    _TRACER.set_clock(clock)


def get_tracer() -> Tracer:
    return _TRACER


def export_chrome(path: str) -> int:
    return _TRACER.export_chrome(path)


def phase_breakdown(cat: Optional[str] = None) -> Dict[str, dict]:
    return _TRACER.phase_breakdown(cat)


def self_time_breakdown(cat: Optional[str] = None) -> Dict[str, dict]:
    """Exclusive-time totals by span name of the buffered spans,
    ``{name: {count, total_s, self_s}}`` (see ``self_times``)."""
    return self_times([e for e in _TRACER.events() if cat is None or e.get("cat") == cat])
