"""Metrics registry: named counters / gauges / histograms with label sets.

One process-wide ``MetricsRegistry`` (``get_registry()``) holds every
metric the instrumented layers emit.  Naming convention (DESIGN.md §14):

    repro_<layer>_<name>[_total|_bytes|_seconds]

where ``<layer>`` is ``transport`` / ``gossip`` / ``engine`` / ``serve``
/ ``fleet`` / ``obs``.  Metrics are cheap plain-dict state behind one
registry lock — hot paths that cannot afford even that go through the
span tracer (guarded by ``obs.enable``) or batch-publish via the bridge
functions below.

Bridges absorb the pre-existing ad-hoc telemetry into this schema:

  * ``publish_wire_stats(ws, transport=...)`` — a transport's
    ``wire_stats`` dict (the unified cross-transport schema of
    ``core.transport.WIRE_STATS_SCHEMA``) lands as
    ``repro_transport_*`` gauges labeled by transport/codec/topology.
  * ``publish_serving_metrics(sm, ...)`` — a
    ``serve.metrics.ServingMetrics`` summary lands as ``repro_serve_*``
    gauges (the machine-readable signals the ROADMAP's autoscaling item
    needs: shed/queue depth/tile fill/latency quantiles).
  * ``publish_staleness(summary, ...)`` — a
    ``convergence.staleness_summary`` dict lands as
    ``repro_transport_staleness_*`` gauges.

Everything here is exportable via ``obs.export`` (Prometheus text
format, JSONL snapshots).
"""
from __future__ import annotations

import re
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "get_registry",
    "publish_wire_stats",
    "publish_serving_metrics",
    "publish_staleness",
]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# default histogram bucket upper bounds: 1us .. 100s, log-spaced
DEFAULT_BUCKETS = tuple(10.0 ** (e / 4.0) for e in range(-24, 9))

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(
    allowed: Tuple[str, ...], labels: Dict[str, object]
) -> LabelKey:
    extra = set(labels) - set(allowed)
    if extra:
        raise ValueError(
            f"unknown label(s) {sorted(extra)}; declared labels are "
            f"{list(allowed)}"
        )
    return tuple((k, str(labels.get(k, ""))) for k in allowed)


class _Metric:
    """Shared label plumbing of the three metric kinds."""

    kind = "?"

    def __init__(self, name: str, help: str, labels: Sequence[str]):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for lbl in labels:
            if not _LABEL_RE.match(lbl):
                raise ValueError(f"invalid label name {lbl!r}")
        self.name = name
        self.help = help
        self.labels = tuple(labels)
        self._lock = threading.Lock()
        self._series: Dict[LabelKey, object] = {}

    def series(self) -> List[Tuple[Dict[str, str], object]]:
        """[(labels_dict, value)] snapshot of every labeled series."""
        with self._lock:
            return [(dict(k), v) for k, v in self._series.items()]


class Counter(_Metric):
    """Monotonically increasing count (``inc`` rejects negative deltas)."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter increments must be >= 0, got {amount}")
        key = _label_key(self.labels, labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        key = _label_key(self.labels, labels)
        with self._lock:
            return float(self._series.get(key, 0.0))


class Gauge(_Metric):
    """A value that can go anywhere (``set``/``add``)."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        key = _label_key(self.labels, labels)
        with self._lock:
            self._series[key] = float(value)

    def add(self, amount: float, **labels) -> None:
        key = _label_key(self.labels, labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        key = _label_key(self.labels, labels)
        with self._lock:
            return float(self._series.get(key, 0.0))


class _HistState:
    __slots__ = ("counts", "count", "sum")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)  # +inf bucket last
        self.count = 0
        self.sum = 0.0


class Histogram(_Metric):
    """Bucketed distribution (cumulative ``le`` buckets on export, like
    Prometheus); exact count/sum alongside."""

    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str,
        labels: Sequence[str],
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ):
        super().__init__(name, help, labels)
        bs = tuple(float(b) for b in buckets)
        if list(bs) != sorted(bs) or len(set(bs)) != len(bs):
            raise ValueError("histogram buckets must be strictly increasing")
        self.buckets = bs

    def observe(self, value: float, **labels) -> None:
        v = float(value)
        key = _label_key(self.labels, labels)
        with self._lock:
            st = self._series.get(key)
            if st is None:
                st = self._series[key] = _HistState(len(self.buckets))
            i = 0
            for i, b in enumerate(self.buckets):
                if v <= b:
                    break
            else:
                i = len(self.buckets)
            st.counts[i] += 1
            st.count += 1
            st.sum += v


class MetricsRegistry:
    """Get-or-create home of every named metric (one per process by
    default; tests build private ones)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name, help, labels, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, tuple(labels), **kwargs)
                self._metrics[name] = m
                return m
        if not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as {m.kind}, "
                f"not {cls.kind}"
            )
        if tuple(labels) and m.labels != tuple(labels):
            raise ValueError(
                f"metric {name!r} declared with labels {m.labels}, "
                f"got {tuple(labels)}"
            )
        return m

    def counter(
        self, name: str, help: str = "", labels: Sequence[str] = ()
    ) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(
        self, name: str, help: str = "", labels: Sequence[str] = ()
    ) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(
        self,
        name: str,
        help: str = "",
        labels: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ) -> Histogram:
        return self._get_or_create(
            Histogram, name, help, labels, buckets=buckets
        )

    def collect(self) -> Iterable[_Metric]:
        with self._lock:
            return sorted(self._metrics.values(), key=lambda m: m.name)

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()

    def as_dict(self) -> Dict[str, object]:
        """JSON-ready snapshot (the JSONL exporter's record shape)."""
        out: Dict[str, object] = {}
        for m in self.collect():
            rows = []
            for labels, v in m.series():
                if isinstance(v, _HistState):
                    rows.append(
                        {
                            "labels": labels,
                            "count": v.count,
                            "sum": v.sum,
                            "buckets": list(v.counts),
                        }
                    )
                else:
                    rows.append({"labels": labels, "value": v})
            out[m.name] = {"type": m.kind, "series": rows}
        return out


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _REGISTRY


# ---------------------------------------------------------------------------
# bridges: absorb the pre-existing ad-hoc telemetry into the registry
# ---------------------------------------------------------------------------
def publish_wire_stats(
    wire_stats: Dict[str, object],
    *,
    transport: str,
    registry: Optional[MetricsRegistry] = None,
) -> None:
    """Publish one transport's ``wire_stats`` dict (the unified schema of
    ``core.transport.WIRE_STATS_SCHEMA``) as ``repro_transport_*`` gauges.

    Gauges, not counters: ``wire_stats`` values are already cumulative
    per transport instance, so re-publishing is idempotent (set, not
    add).  String-valued keys (``codec`` / ``topology``) become labels on
    every series."""
    reg = registry if registry is not None else _REGISTRY
    labels = {
        "transport": transport,
        "codec": str(wire_stats.get("codec", "none")),
        "topology": str(wire_stats.get("topology", "star")),
    }
    for key, value in wire_stats.items():
        if isinstance(value, str):
            continue
        reg.gauge(
            f"repro_transport_{key}",
            f"transport wire_stats[{key}] (cumulative per run)",
            labels=("transport", "codec", "topology"),
        ).set(float(value), **labels)


def publish_staleness(
    summary: Dict[str, object],
    *,
    transport: str,
    registry: Optional[MetricsRegistry] = None,
) -> None:
    """Publish a ``convergence.staleness_summary`` dict as
    ``repro_transport_staleness_*`` gauges (per-worker/per-edge breakdown
    dicts are skipped — those stay in the history/trace)."""
    reg = registry if registry is not None else _REGISTRY
    for key, value in summary.items():
        if isinstance(value, dict):
            continue
        reg.gauge(
            f"repro_transport_staleness_{key}",
            f"staleness_summary[{key}] of the latest run",
            labels=("transport",),
        ).set(float(value), transport=transport)


# ServingMetrics.summary() scalar keys -> gauge suffixes; latency/ttft
# sub-dicts are flattened below
_SERVE_SCALARS = (
    "submitted",
    "completed",
    "rejected",
    "expired",
    "slo_violations",
    "swaps",
    "elapsed_s",
    "throughput_rps",
    "queue_depth_max",
    "tiles",
    "tile_fill",
    "decode_steps",
    "slot_occupancy",
)


def publish_serving_metrics(
    metrics,
    *,
    replica: str = "all",
    registry: Optional[MetricsRegistry] = None,
) -> None:
    """Publish a ``serve.metrics.ServingMetrics`` object as
    ``repro_serve_*`` gauges labeled by replica ("all" for a fleet
    rollup).  These are the autoscaling signals the ROADMAP names:
    queue depth, tile fill, shed/violation counts, latency quantiles."""
    reg = registry if registry is not None else _REGISTRY
    s = metrics.summary()
    for key in _SERVE_SCALARS:
        v = s.get(key)
        if v is None:
            continue
        reg.gauge(
            f"repro_serve_{key}",
            f"ServingMetrics summary[{key}]",
            labels=("replica",),
        ).set(float(v), replica=replica)
    for hist_key in ("latency", "ttft"):
        for q, v in s.get(hist_key, {}).items():
            reg.gauge(
                f"repro_serve_{hist_key}_{q}",
                f"ServingMetrics {hist_key} {q}",
                labels=("replica",),
            ).set(float(v), replica=replica)
