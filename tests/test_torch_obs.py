"""The port's observability layer (repro_torch/obs, a stdlib copy of the
JAX package's repro.obs) on the scenarios of tests/test_obs.py, except
those that need transports (not ported yet): span tracer, metrics
registry, exporters, and the ServingMetrics bridge. The last cases hold
the port's registry and exporters against the JAX package's on the same
operations: identical Prometheus text and JSON snapshots.

Tracing and the global registry are process-wide state, so every test that
touches them goes through the ``clean_obs`` fixture (tracer disabled and
cleared on exit, global registry untouched — tests build their own).
"""
import json
import threading
import urllib.request

import pytest

from repro_torch import obs
from repro_torch.obs.export import JsonlExporter, MetricsHTTPServer, to_prometheus
from repro_torch.obs.metrics import MetricsRegistry, publish_serving_metrics


@pytest.fixture
def clean_obs():
    obs.disable()
    obs.get_tracer().clear()
    yield
    obs.disable()
    obs.get_tracer().clear()


class FakeClock:
    """Deterministic monotone clock: each tick() advances by ``step``."""

    def __init__(self, step=1.0):
        self.t = 0.0
        self.step = step

    def __call__(self):
        return self.t

    def tick(self, dt=None):
        self.t += self.step if dt is None else dt
        return self.t


# ---------------------------------------------------------------------------
# span tracer
# ---------------------------------------------------------------------------
def test_span_disabled_is_noop(clean_obs):
    assert not obs.enabled()
    with obs.span("gate", cat="transport", worker=0):
        pass
    assert obs.get_tracer().events() == []
    # the disabled path hands back one shared object — no per-call alloc
    assert obs.span("a") is obs.span("b", cat="x", k=1)


def test_span_records_chrome_complete_events(clean_obs):
    clk = FakeClock()
    tracer = obs.enable(clear=True, clock=clk)
    with obs.span("commit", cat="transport", worker=3, round=7):
        clk.tick(0.25)
    obs.disable()
    (e,) = tracer.events()
    assert e["name"] == "commit" and e["cat"] == "transport"
    assert e["ph"] == "X"
    assert e["dur"] == pytest.approx(0.25e6)  # microseconds
    assert e["args"] == {"worker": 3, "round": 7}


def test_span_nesting_and_breakdown(clean_obs):
    clk = FakeClock()
    obs.enable(clear=True, clock=clk)
    with obs.span("round", cat="transport"):
        with obs.span("solve", cat="transport"):
            clk.tick(1.0)
        with obs.span("solve", cat="transport"):
            clk.tick(2.0)
    obs.disable()
    bd = obs.phase_breakdown()
    assert bd["solve"]["count"] == 2
    assert bd["solve"]["total_s"] == pytest.approx(3.0)
    assert bd["solve"]["max_s"] == pytest.approx(2.0)
    assert bd["round"]["total_s"] == pytest.approx(3.0)
    # the inner spans lie inside the outer one on the same thread
    evs = sorted(obs.get_tracer().events(), key=lambda e: e["dur"])
    outer = evs[-1]
    for inner in evs[:-1]:
        assert outer["ts"] <= inner["ts"]
        assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def test_ring_buffer_caps_and_counts_drops(clean_obs):
    tracer = obs.enable(capacity=4, clear=True)
    for i in range(10):
        with obs.span(f"s{i}"):
            pass
    obs.disable()
    evs = tracer.events()
    assert len(evs) == 4
    assert tracer.dropped == 6
    # ring keeps the NEWEST spans
    assert [e["name"] for e in evs] == ["s6", "s7", "s8", "s9"]


def test_export_chrome_trace(tmp_path, clean_obs):
    obs.enable(clear=True)
    with obs.span("fit_async", cat="train"):
        with obs.span("w_step", cat="train", outer=0):
            pass
    obs.disable()
    path = tmp_path / "trace.json"
    n = obs.export_chrome(str(path))
    assert n == 2
    doc = json.loads(path.read_text())
    evs = doc["traceEvents"]
    xs = [e for e in evs if e["ph"] == "X"]
    assert {e["name"] for e in xs} == {"fit_async", "w_step"}
    # thread-name metadata rows so chrome://tracing labels the lanes
    assert any(e["ph"] == "M" and e["name"] == "thread_name" for e in evs)


def test_concurrent_spans_stay_well_formed(clean_obs):
    """4 threads emit nested spans concurrently; every thread's events
    must form a proper per-thread nesting with no cross-thread bleed."""
    n_threads, n_outer = 4, 25
    tracer = obs.enable(capacity=4096, clear=True)
    barrier = threading.Barrier(n_threads)

    def worker(w):
        barrier.wait()
        for r in range(n_outer):
            with obs.span("round", cat="t", worker=w, round=r):
                for _ in range(3):
                    with obs.span("inner", cat="t", worker=w):
                        pass

    threads = [
        threading.Thread(target=worker, args=(w,)) for w in range(n_threads)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    obs.disable()

    evs = tracer.events()
    assert tracer.dropped == 0
    assert len(evs) == n_threads * n_outer * 4
    by_tid = {}
    for e in evs:
        by_tid.setdefault(e["tid"], []).append(e)
    assert len(by_tid) == n_threads
    for tid, tevs in by_tid.items():
        # one worker id per thread: no event landed on the wrong lane
        assert len({e["args"]["worker"] for e in tevs}) == 1
        assert sum(e["name"] == "round" for e in tevs) == n_outer
        # proper nesting: sorted by start (ties: longest first), each span
        # must close before every still-open ancestor does
        tevs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack = []
        for e in tevs:
            t0, t1 = e["ts"], e["ts"] + e["dur"]
            while stack and stack[-1] <= t0:
                stack.pop()
            if stack:
                assert t1 <= stack[-1] + 1e-6
            stack.append(t1)


def test_enable_capacity_change_rebuilds_ring(clean_obs):
    t1 = obs.enable(capacity=8, clear=True)
    t2 = obs.enable(capacity=8)  # same capacity: same tracer
    assert t1 is t2
    t3 = obs.enable(capacity=16)
    assert t3 is not t1
    obs.disable()


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------
def test_counter_gauge_histogram_basics():
    reg = MetricsRegistry()
    c = reg.counter("repro_test_commits", "commits", labels=("worker",))
    c.inc(worker=0)
    c.inc(2.0, worker=0)
    c.inc(worker=1)
    series = {d["worker"]: v for d, v in c.series()}
    assert series == {"0": 3.0, "1": 1.0}  # label values stringify
    with pytest.raises(ValueError):
        c.inc(-1.0, worker=0)  # counters only go up

    g = reg.gauge("repro_test_depth", "queue depth")
    g.set(5.0)
    g.add(-2.0)
    assert g.value() == 3.0

    h = reg.histogram(
        "repro_test_latency", "s", buckets=(0.1, 1.0, 10.0)
    )
    for v in (0.05, 0.5, 5.0, 50.0):
        h.observe(v)
    ((_, state),) = h.series()
    assert state.count == 4
    assert state.sum == pytest.approx(55.55)
    assert state.counts == [1, 1, 1, 1]  # per-bucket + overflow


def test_metric_label_and_name_validation():
    reg = MetricsRegistry()
    with pytest.raises(ValueError):
        reg.counter("bad name!", "x")
    c = reg.counter("repro_test_c", "x", labels=("worker",))
    with pytest.raises(ValueError):
        c.inc(replica=0)  # undeclared label
    c.inc()  # omitted declared label defaults to "" (one catch-all series)
    ((labels, v),) = c.series()
    assert labels == {"worker": ""} and v == 1.0


def test_registry_get_or_create_conflicts():
    reg = MetricsRegistry()
    c1 = reg.counter("repro_test_x", "x", labels=("a",))
    assert reg.counter("repro_test_x", "x", labels=("a",)) is c1
    with pytest.raises(TypeError):
        reg.gauge("repro_test_x", "x")  # kind conflict
    with pytest.raises(ValueError):
        reg.counter("repro_test_x", "x", labels=("b",))  # label conflict


def test_registry_as_dict_is_json_ready():
    reg = MetricsRegistry()
    reg.counter("repro_test_n", "n").inc()
    reg.histogram("repro_test_h", "h", buckets=(1.0,)).observe(0.5)
    json.dumps(reg.as_dict())  # must not raise


# ---------------------------------------------------------------------------
# exporters
# ---------------------------------------------------------------------------
def test_prometheus_text_format():
    reg = MetricsRegistry()
    reg.counter(
        "repro_transport_n_commits", "commits", labels=("transport",)
    ).inc(3, transport="threaded")
    reg.histogram("repro_serve_lat", "s", buckets=(0.5, 1.0)).observe(0.7)
    text = to_prometheus(reg)
    assert "# TYPE repro_transport_n_commits counter" in text
    assert 'repro_transport_n_commits{transport="threaded"} 3' in text
    # histograms expose CUMULATIVE buckets plus _sum/_count
    assert 'repro_serve_lat_bucket{le="0.5"} 0' in text
    assert 'repro_serve_lat_bucket{le="1"} 1' in text  # integral le: no .0
    assert 'repro_serve_lat_bucket{le="+Inf"} 1' in text
    assert "repro_serve_lat_count 1" in text


def test_jsonl_exporter(tmp_path):
    reg = MetricsRegistry()
    g = reg.gauge("repro_test_g", "g")
    path = tmp_path / "metrics.jsonl"
    clk = FakeClock()
    exp = JsonlExporter(str(path), registry=reg, clock=clk)
    g.set(1.0)
    exp.snapshot()
    clk.tick()
    g.set(2.0)
    exp.snapshot()
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert len(lines) == 2
    assert lines[0]["t"] == 0.0 and lines[1]["t"] == 1.0
    assert "metrics" in lines[0]


def test_metrics_http_server_serves_prometheus():
    reg = MetricsRegistry()
    reg.counter("repro_test_hits", "hits").inc(7)
    with MetricsHTTPServer(port=0, registry=reg) as srv:
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/metrics", timeout=5
        ).read().decode()
    assert "repro_test_hits 7" in body


# ---------------------------------------------------------------------------
# ServingMetrics: merge idempotence + summary schema
# ---------------------------------------------------------------------------
_SUMMARY_KEYS = {
    "submitted", "completed", "rejected", "expired", "slo_s",
    "slo_violations", "swaps", "last_version", "elapsed_s",
    "throughput_rps", "queue_depth_max", "tiles", "tile_fill",
    "decode_steps", "slot_occupancy", "ttft", "latency",
    "latency_buckets", "per_task",
}


def _loaded_metrics(clock):
    from repro_torch.serve.metrics import ServingMetrics

    m = ServingMetrics(slo_s=1.0, clock=clock)
    m.on_submit(task=0)
    m.on_submit(task=1)
    m.on_tile(filled=2, slots=4)
    m.on_complete(0, latency_s=0.2, violated=False)
    m.on_complete(1, latency_s=2.0, violated=True)
    m.on_swap(version=3)
    m.observe_queue_depth(5)
    return m


def test_serving_metrics_merge_empty_windows_is_identity():
    """Merging any number of EMPTY windows into a loaded one changes no
    counter — rollups of idle replicas are a no-op, applied repeatedly."""
    from repro_torch.serve.metrics import ServingMetrics

    clk = FakeClock(step=0.0)
    m = _loaded_metrics(clk)
    empties = [ServingMetrics(slo_s=1.0, clock=clk) for _ in range(3)]
    once = m.merge(*empties)
    twice = once.merge(*empties)
    base, s1, s2 = m.summary(), once.summary(), twice.summary()
    assert s1 == base
    assert s2 == s1
    # and empty + empty stays empty
    e = empties[0].merge(empties[1]).summary()
    assert e["submitted"] == 0 and e["completed"] == 0
    assert e["throughput_rps"] == 0.0


def test_serving_metrics_summary_schema_pinned():
    """``summary()`` is the BENCH_serving row shape AND what the obs
    bridge flattens into gauges — additions/renames must be deliberate."""
    clk = FakeClock(step=0.0)
    s = _loaded_metrics(clk).summary()
    assert set(s) == _SUMMARY_KEYS
    json.dumps(s)  # JSON-ready end to end
    assert s["submitted"] == 2 and s["completed"] == 2
    assert s["slo_violations"] == 1
    assert s["tile_fill"] == pytest.approx(0.5)
    assert set(s["per_task"]) == {"0", "1"}


def test_publish_serving_metrics_gauges():
    clk = FakeClock(step=0.0)
    reg = MetricsRegistry()
    publish_serving_metrics(_loaded_metrics(clk), replica="2", registry=reg)
    text = to_prometheus(reg)
    assert 'repro_serve_submitted{replica="2"} 2' in text
    assert 'repro_serve_slo_violations{replica="2"} 1' in text
    # latency quantile sub-dict flattens to its own gauge family
    assert "repro_serve_latency_p50" in text


# ---------------------------------------------------------------------------
# parity with the JAX package's copy
# ---------------------------------------------------------------------------
def _exercise(metrics_mod, clk):
    reg = metrics_mod.MetricsRegistry()
    c = reg.counter("repro_test_commits", "commits", labels=("worker",))
    c.inc(worker=0)
    c.inc(2.5, worker=1)
    g = reg.gauge("repro_test_depth", "queue depth")
    g.set(5.0)
    g.add(-2.0)
    h = reg.histogram("repro_test_latency", "s", labels=("replica",), buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v, replica="r0")
    metrics_mod.publish_wire_stats(
        {"codec": "int8", "topology": "ring", "n_commits": 12, "commit_bytes": 3456},
        transport="gossip", registry=reg,
    )
    metrics_mod.publish_staleness({"mean": 1.5, "max": 3, "per_worker": {"0": 1}},
                                  transport="threaded", registry=reg)
    return reg


def test_registry_and_exporters_match_jax(tmp_path):
    from repro.obs import export as jexport
    from repro.obs import metrics as jmetrics
    from repro_torch.obs import export as texport
    from repro_torch.obs import metrics as tmetrics

    clk = FakeClock()
    jreg, treg = _exercise(jmetrics, clk), _exercise(tmetrics, clk)
    assert texport.to_prometheus(treg) == jexport.to_prometheus(jreg)
    assert treg.as_dict() == jreg.as_dict()
    lines = []
    for exp_mod, reg, name in ((jexport, jreg, "j"), (texport, treg, "t")):
        path = tmp_path / f"{name}.jsonl"
        exp_mod.JsonlExporter(str(path), registry=reg, clock=clk).snapshot()
        lines.append(json.loads(path.read_text()))
    assert lines[0] == lines[1]


def test_serving_bridge_matches_jax():
    from repro.obs import export as jexport, metrics as jmetrics
    from repro.serve.metrics import ServingMetrics as JaxMetrics
    from repro_torch.serve.metrics import ServingMetrics

    clk = FakeClock(step=0.0)
    texts = []
    for metrics_cls, metrics_mod, export_mod in (
        (JaxMetrics, jmetrics, jexport), (ServingMetrics, obs.metrics, obs.export),
    ):
        m = metrics_cls(slo_s=1.0, clock=clk)
        m.on_submit(task=0)
        m.on_tile(filled=1, slots=4)
        m.on_complete(0, latency_s=0.2, violated=False)
        reg = metrics_mod.MetricsRegistry()
        metrics_mod.publish_serving_metrics(m, replica="1", registry=reg)
        texts.append(export_mod.to_prometheus(reg))
    assert texts[0] == texts[1]


def test_span_records_same_events_as_jax(clean_obs):
    from repro import obs as jobs

    out = []
    for mod in (jobs, obs):
        clk = FakeClock()
        tracer = mod.enable(clear=True, clock=clk)
        with mod.span("step", cat="serve", tile=4):
            with mod.span("run_tile", cat="serve"):
                clk.tick(0.5)
        mod.disable()
        evs = [{k: v for k, v in e.items() if k not in ("pid", "tid")}
               for e in tracer.events()]
        out.append((evs, mod.phase_breakdown()))
        tracer.clear()
    assert out[0] == out[1]
