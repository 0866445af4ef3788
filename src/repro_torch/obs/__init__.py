"""Observability: span tracing, metrics registry, exporters.

A stdlib-only copy of the JAX package's ``repro.obs`` (same names, same
``repro_<layer>_<name>`` metric schema, same Chrome-trace format), so the
port's serving stack reports exactly what the reference's does:

  * ``obs.trace`` — a low-overhead, thread-safe span tracer.
    ``span("run_tile", cat="serve")`` context managers nest per thread,
    land in a process-wide ring buffer, and export as Chrome-trace JSON
    (``export_chrome``), loadable in ``chrome://tracing`` / Perfetto.
  * ``obs.metrics`` — named counters / gauges / histograms with label
    sets behind one process-wide registry, plus the bridges that publish
    ``serve.metrics.ServingMetrics`` (and transport ``wire_stats`` /
    staleness dicts) into it.
  * ``obs.export`` — Prometheus text format (optionally served by a tiny
    stdlib HTTP handler) and periodic JSONL snapshots.

Tracing is OFF by default: ``span`` then costs one global flag check and
a shared no-op context manager.

    from repro_torch import obs

    obs.enable()
    ... run something instrumented ...
    obs.export_chrome("trace.json")       # load in chrome://tracing
    print(obs.to_prometheus())            # scrapeable text format
    obs.disable()
"""
from .trace import (  # noqa: F401
    Tracer,
    disable,
    enable,
    enabled,
    export_chrome,
    get_tracer,
    phase_breakdown,
    self_time_breakdown,
    set_clock,
    span,
    wall_clock,
)
from .metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    publish_serving_metrics,
    publish_staleness,
    publish_wire_stats,
)
from .export import (  # noqa: F401
    JsonlExporter,
    MetricsHTTPServer,
    to_prometheus,
)

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
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "get_registry",
    "publish_wire_stats",
    "publish_serving_metrics",
    "publish_staleness",
    "to_prometheus",
    "MetricsHTTPServer",
    "JsonlExporter",
]
