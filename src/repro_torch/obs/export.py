"""Exporters for the metrics registry: Prometheus text + JSONL snapshots.

Two consumption paths (DESIGN.md §14):

  * ``to_prometheus(registry)`` renders the standard text exposition
    format (``# HELP`` / ``# TYPE`` / labeled series; histograms as
    cumulative ``_bucket{le=...}`` plus ``_sum`` / ``_count``), and
    ``MetricsHTTPServer`` serves it at ``/metrics`` from a stdlib
    ``http.server`` daemon thread — enough for a local Prometheus scrape
    or a ``curl`` during a long run; no third-party client library.
  * ``JsonlExporter`` appends full registry snapshots (the
    ``MetricsRegistry.as_dict`` shape plus a timestamp) to a ``.jsonl``
    file — one line per snapshot, either on demand (``snapshot()``) or
    periodically from a background thread (``start(interval_s)``).
"""
from __future__ import annotations

import json
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .metrics import Histogram, MetricsRegistry, get_registry

__all__ = ["to_prometheus", "MetricsHTTPServer", "JsonlExporter"]


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _escape(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _label_str(labels: dict, extra: Optional[dict] = None) -> str:
    items = dict(labels)
    if extra:
        items.update(extra)
    if not items:
        return ""
    inner = ",".join(f'{k}="{_escape(str(v))}"' for k, v in items.items())
    return "{" + inner + "}"


def to_prometheus(registry: Optional[MetricsRegistry] = None) -> str:
    """Render the registry in the Prometheus text exposition format."""
    reg = registry if registry is not None else get_registry()
    lines = []
    for m in reg.collect():
        if m.help:
            lines.append(f"# HELP {m.name} {_escape(m.help)}")
        lines.append(f"# TYPE {m.name} {m.kind}")
        if isinstance(m, Histogram):
            bounds = list(m.buckets) + [math.inf]
            for labels, st in m.series():
                cum = 0
                for bound, c in zip(bounds, st.counts):
                    cum += c
                    le = _label_str(labels, {"le": _fmt_value(bound)})
                    lines.append(f"{m.name}_bucket{le} {cum}")
                lines.append(
                    f"{m.name}_sum{_label_str(labels)} {_fmt_value(st.sum)}"
                )
                lines.append(
                    f"{m.name}_count{_label_str(labels)} {st.count}"
                )
        else:
            for labels, v in m.series():
                lines.append(
                    f"{m.name}{_label_str(labels)} {_fmt_value(float(v))}"
                )
    return "\n".join(lines) + "\n"


class MetricsHTTPServer:
    """Tiny stdlib HTTP endpoint serving ``to_prometheus`` at ``/metrics``.

        srv = MetricsHTTPServer(port=0)   # 0 = pick a free port
        srv.start()
        ... curl http://localhost:{srv.port}/metrics ...
        srv.stop()
    """

    def __init__(
        self,
        port: int = 9464,
        host: str = "127.0.0.1",
        registry: Optional[MetricsRegistry] = None,
    ):
        self._registry = registry
        self._addr = (host, port)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        if self._httpd is None:
            raise RuntimeError("server not started")
        return self._httpd.server_address[1]

    def start(self) -> "MetricsHTTPServer":
        registry = self._registry

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib handler name)
                if self.path.rstrip("/") not in ("", "/metrics"):
                    self.send_error(404)
                    return
                body = to_prometheus(registry).encode()
                self.send_response(200)
                self.send_header(
                    "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
                )
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # keep scrapes out of stderr
                pass

        self._httpd = ThreadingHTTPServer(self._addr, _Handler)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="obs-metrics-http",
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "MetricsHTTPServer":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop()


class JsonlExporter:
    """Append registry snapshots to a JSONL file, one JSON object per
    line: ``{"t": <unix seconds>, "metrics": <registry.as_dict()>}``."""

    def __init__(
        self,
        path: str,
        registry: Optional[MetricsRegistry] = None,
        clock=time.time,
    ):
        self.path = path
        self._registry = registry
        self._clock = clock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.n_snapshots = 0

    def snapshot(self) -> dict:
        reg = self._registry if self._registry is not None else get_registry()
        rec = {"t": self._clock(), "metrics": reg.as_dict()}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        self.n_snapshots += 1
        return rec

    def start(self, interval_s: float = 15.0) -> "JsonlExporter":
        if self._thread is not None:
            raise RuntimeError("exporter already started")
        self._stop.clear()

        def _loop():
            while not self._stop.wait(interval_s):
                self.snapshot()

        self._thread = threading.Thread(
            target=_loop, name="obs-jsonl-exporter", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, final_snapshot: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if final_snapshot:
            self.snapshot()
