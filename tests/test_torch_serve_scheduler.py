"""The port's continuous-batching scheduler and serving metrics
(repro_torch/serve/{scheduler,metrics}.py) against the JAX package's.

One scripted request stream under a VirtualClock — arrivals, deadlines
expiring at the door and at packing, a bounded queue, straggler tiles,
publishes between and inside tiles, a failed tile — runs through the JAX
stack and through the port's: per-request status, snapshot_version and
completion order are equal, scores agree within 1e-5, and the
``ServingMetrics.summary()`` counters are equal. The remaining cases are
the scenarios of tests/test_serve_scheduler.py on the port (not the
transport subscription: transports are not ported yet).
"""
import threading
import types

import numpy as np
import pytest

from repro_torch.serve import (
    ContinuousBatchingScheduler,
    LatencyHistogram,
    ModelSnapshot,
    MTLScoringEngine,
    QueueFull,
    ScoreRequest,
    ServeRequest,
    ServingMetrics,
    VirtualClock,
)

TOL = 1e-5


def _port_stack():
    return types.SimpleNamespace(
        Scheduler=ContinuousBatchingScheduler, ModelSnapshot=ModelSnapshot,
        ScoreRequest=ScoreRequest, QueueFull=QueueFull, VirtualClock=VirtualClock,
        engine=lambda W, **kw: MTLScoringEngine(W, device="cpu", **kw),
    )


def _jax_stack():
    from repro import serve

    return types.SimpleNamespace(
        Scheduler=serve.ContinuousBatchingScheduler, ModelSnapshot=serve.ModelSnapshot,
        ScoreRequest=serve.ScoreRequest, QueueFull=serve.QueueFull,
        VirtualClock=serve.VirtualClock, engine=serve.MTLScoringEngine,
    )


class PacedEngine:
    """Each tile advances the virtual clock by a scripted service time
    before scoring (and may fail or publish mid-tile); everything but
    ``run_tile`` delegates to the wrapped engine."""

    def __init__(self, inner, clock, service_s, fail_at=(), mid_tile=None):
        self.inner, self.clock = inner, clock
        self.service_s = list(service_s)
        self.fail_at, self.mid_tile = set(fail_at), mid_tile or {}
        self.tiles = 0

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def run_tile(self, reqs, snapshot):
        k = self.tiles
        self.tiles += 1
        self.clock.advance(self.service_s[min(k, len(self.service_s) - 1)])
        if k in self.mid_tile:
            self.mid_tile[k]()
        if k in self.fail_at:
            raise RuntimeError("device fell over")
        self.inner.run_tile(reqs, snapshot)


@pytest.fixture()
def W():
    return np.random.RandomState(0).randn(5, 12).astype(np.float32)


def _requests(S, n, m=5, d=12, seed=1):
    rng = np.random.RandomState(seed)
    return [
        S.ScoreRequest(task=int(rng.randint(m)), x=rng.randn(d).astype(np.float32))
        for _ in range(n)
    ]


def _scripted(S, W, policy):
    """Run the scripted stream through stack S; returns (requests in
    submission order, completion order, summary, final version)."""
    rng = np.random.RandomState(7)
    Ws = [W] + [rng.randn(*W.shape).astype(np.float32) for _ in range(3)]
    clk = S.VirtualClock()
    sched = None

    def publish_mid_tile():
        sched.publish_weights(Ws[3])

    eng = PacedEngine(S.engine(W, batch=2, version=1), clk,
                      [0.02, 0.05, 0.02, 0.3, 0.02], fail_at={2},
                      mid_tile={4: publish_mid_tile})
    sched = S.Scheduler(eng, slo_s=0.1, policy=policy, max_queue=8, clock=clk)
    reqs = _requests(S, 30, seed=11)
    deadlines = [None if i % 3 == 0 else 0.04 + 0.03 * (i % 5) for i in range(30)]
    order, outcomes = [], []
    i = 0
    for tick in range(40):
        # a burst every few ticks, overflowing the bounded queue
        burst = 10 if tick % 5 == 0 else 0
        for _ in range(burst):
            if i == len(reqs):
                break
            if i == 12:
                reqs[i].deadline_s = clk() - 1.0  # expired at the door
            try:
                sched.submit(reqs[i], deadline_s=deadlines[i])
                outcomes.append("ok")
            except S.QueueFull:
                outcomes.append("full")
            i += 1
        if tick == 3:
            sched.publish(S.ModelSnapshot(version=5, W=Ws[1]))
        if tick == 9:
            sched.publish_weights(Ws[2], version=2)  # behind: restamped
        try:
            order += [id(r) for r in sched.step()]
        except RuntimeError:
            outcomes.append("tile failed")
        clk.advance(0.01)
    sched.run_until_idle()
    return reqs, order, outcomes, sched.metrics.summary(), sched.version


@pytest.mark.parametrize("policy", ["edf", "fifo"])
def test_scripted_stream_matches_jax(W, policy):
    jr, jorder, jout, js, jv = _scripted(_jax_stack(), W, policy)
    tr, torder, tout, ts, tv = _scripted(_port_stack(), W, policy)
    assert tout == jout and tv == jv
    assert [r.status for r in tr] == [r.status for r in jr]
    assert [r.snapshot_version for r in tr] == [r.snapshot_version for r in jr]
    pos_j = {k: n for n, k in enumerate(jorder)}
    pos_t = {k: n for n, k in enumerate(torder)}
    assert [pos_t.get(id(r)) for r in tr] == [pos_j.get(id(r)) for r in jr]
    for a, b in zip(tr, jr):
        assert (a.score is None) == (b.score is None)
        if a.score is not None:
            assert a.score == pytest.approx(b.score, abs=TOL)
            assert a.label == b.label
            assert a.latency_s == pytest.approx(b.latency_s, abs=1e-12)
    # every status the stream is meant to exercise shows up
    assert {"done", "expired"} <= {r.status for r in tr} and "full" in tout
    assert "tile failed" in tout
    for key in ("submitted", "completed", "rejected", "expired", "slo_violations",
                "swaps", "last_version", "tiles", "tile_fill", "queue_depth_max",
                "per_task", "latency", "latency_buckets", "elapsed_s", "throughput_rps"):
        assert ts[key] == js[key], key


# ---------------------------------------------------------------------------
# the scenarios of tests/test_serve_scheduler.py, on the port
# ---------------------------------------------------------------------------
def _port_sched(W, batch=4, version=0, **kw):
    return ContinuousBatchingScheduler(
        MTLScoringEngine(W, batch=batch, version=version, device="cpu"),
        clock=kw.pop("clock", VirtualClock()), **kw)


def _preqs(n, seed=1):
    return _requests(_port_stack(), n, seed=seed)


def test_partial_tiles_pack_immediately(W):
    sched = _port_sched(W)
    reqs = _preqs(3)
    sched.submit_many(reqs)
    done = sched.step()
    assert [r is d for r, d in zip(reqs, done)] == [True] * 3
    assert all(r.status == "done" and r.score is not None for r in reqs)
    assert sched.metrics.tiles == 1 and sched.metrics.tile_fill() == 0.75
    assert sched.step() == []


def test_fifo_vs_edf_packing(W):
    sched = _port_sched(W, batch=2, policy="edf")
    a, b, c = _preqs(3)
    sched.submit(a, deadline_s=10.0)
    sched.submit(b)
    sched.submit(c, deadline_s=1.0)
    assert sched.step() == [c, a]
    assert sched.step() == [b]
    sched2 = _port_sched(W, batch=2, policy="fifo")
    a2, b2, c2 = _preqs(3)
    sched2.submit(a2, deadline_s=10.0)
    sched2.submit(b2)
    sched2.submit(c2, deadline_s=1.0)
    assert sched2.step() == [a2, b2]


def test_deadline_aware_admission_and_expiry(W):
    clk = VirtualClock()
    sched = _port_sched(W, clock=clk)
    dead = _preqs(1)[0]
    dead.deadline_s = -1.0
    sched.submit(dead)
    assert dead.status == "expired" and sched.pending == 0
    late, ok = _preqs(2)
    sched.submit(late, deadline_s=0.5)
    sched.submit(ok, deadline_s=100.0)
    clk.advance(1.0)
    assert sched.step() == [ok] and late.status == "expired" and late.score is None
    m = sched.metrics
    assert m.expired == 2 and m.slo_violations == 2 and m.completed == 1


def test_bounded_queue_and_validation(W):
    sched = _port_sched(W, batch=2, max_queue=2)
    r1, r2, r3 = _preqs(3)
    sched.submit(r1)
    sched.submit(r2)
    with pytest.raises(QueueFull):
        sched.submit(r3)
    assert sched.metrics.rejected == 1 and sched.pending == 2
    with pytest.raises(ValueError, match="task id"):
        sched.submit(ScoreRequest(task=9, x=np.zeros(12, np.float32)))
    with pytest.raises(ValueError, match="feature shape"):
        sched.submit(ScoreRequest(task=0, x=np.zeros(3, np.float32)))
    with pytest.raises(ValueError, match="policy"):
        _port_sched(W, policy="lifo")


def test_publish_version_rules(W):
    eng = MTLScoringEngine(W, batch=2, version=3, device="cpu")
    sched = ContinuousBatchingScheduler(eng, clock=VirtualClock())
    assert sched.publish(ModelSnapshot(version=3, W=W)) == 3
    assert sched.metrics.swaps == 0
    with pytest.raises(ValueError, match="not newer"):
        sched.publish(ModelSnapshot(version=2, W=W))
    with pytest.raises(TypeError):
        sched.publish(W)
    assert sched.publish_weights(W) == 4
    assert sched.publish_weights(W, version=1) == 5
    with pytest.raises(ValueError, match="shape"):
        sched.publish_weights(np.zeros((2, 2), np.float32))
    assert sched.version == 5


def test_scheduler_picks_up_engine_pushed_snapshot(W):
    W2 = np.random.RandomState(11).randn(*W.shape).astype(np.float32)
    W3 = np.random.RandomState(15).randn(*W.shape).astype(np.float32)
    eng = MTLScoringEngine(W, batch=4, version=1, device="cpu")
    sched = ContinuousBatchingScheduler(eng, clock=VirtualClock())
    eng.swap(W2)
    (out,) = sched.submit_many(_preqs(1, seed=12))
    sched.step()
    assert out.request.snapshot_version == 2 and sched.version == 2
    for _ in range(5):
        sched.publish_weights(W2)
    eng.swap(W3)  # version 3 on the engine, behind the scheduler's 7
    (out,) = sched.submit_many(_preqs(1, seed=16))
    sched.step()
    r = out.request
    assert r.snapshot_version == 8
    assert r.score == pytest.approx(float(r.x @ W3[r.task]), abs=TOL)


def test_failed_tile_requeues_requests(W):
    eng = MTLScoringEngine(W, batch=4, device="cpu")
    sched = ContinuousBatchingScheduler(eng, clock=VirtualClock())
    reqs = [o.request for o in sched.submit_many(_preqs(3, seed=13))]

    def boom(tile, snapshot):
        raise RuntimeError("device fell over")

    eng.run_tile = boom
    with pytest.raises(RuntimeError, match="fell over"):
        sched.step()
    assert sched.pending == 3
    assert all(r.status == "queued" and r.score is None for r in reqs)
    del eng.run_tile
    assert sched.run_until_idle() == 3
    assert all(r.status == "done" for r in reqs)


def test_streaming_engines_are_refused():
    """A streaming engine (one with ``decode_tick``) is refused the
    whole-tile path: the scheduler drives it one decode step at a time
    (drain, inject into free slots, decode_tick) and never calls
    ``run_tile``; ``in_flight`` counts its occupied slots."""

    class Streaming:
        batch = 1

        def __init__(self):
            self.calls, self.slot = [], None

        def admit(self, r):
            pass

        def model_snapshot(self):
            return ModelSnapshot(version=0)

        def run_tile(self, reqs, snap):
            raise AssertionError("run_tile on a streaming engine")

        @property
        def free_slots(self):
            return int(self.slot is None)

        @property
        def active(self):
            return int(self.slot is not None)

        def drain(self):
            self.calls.append("drain")
            return []

        def inject(self, reqs, snap):
            self.calls.append("inject")
            self.slot = reqs[0]

        def decode_tick(self):
            self.calls.append("tick")
            done, self.slot = [self.slot], None
            return done

    eng = Streaming()
    sched = ContinuousBatchingScheduler(eng, clock=VirtualClock())
    r = sched.submit(ServeRequest())
    assert sched.step() == [r] and eng.calls == ["drain", "inject", "tick"]
    assert r.status == "done" and r.first_token_s is not None and sched.in_flight == 0


def test_concurrent_submit_and_publish_thread_safety(W):
    """A training thread publishes while a serving thread steps: every
    request completes exactly once on SOME published version."""
    eng = MTLScoringEngine(W, batch=8, version=1, device="cpu")
    sched = ContinuousBatchingScheduler(eng)
    reqs = _preqs(64, seed=8)

    def trainer():
        for v in range(2, 12):
            sched.publish(ModelSnapshot(version=v, W=W * v))

    t = threading.Thread(target=trainer)
    for r in reqs[:32]:
        sched.submit(r)
    t.start()
    done, backlog = [], list(reqs[32:])
    while len(done) < len(reqs):
        done += sched.step()
        while backlog and sched.pending < 8:
            sched.submit(backlog.pop(0))
    t.join(timeout=30)
    assert not t.is_alive()
    assert len(done) == 64 and len({id(r) for r in done}) == 64
    for r in reqs:
        assert 1 <= r.snapshot_version <= 11
        assert r.score == pytest.approx(float(r.x @ (W[r.task] * max(r.snapshot_version, 1))),
                                        abs=1e-4)
    assert sched.version == 11


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------
def test_latency_histogram_matches_jax():
    from repro.serve import LatencyHistogram as JaxHist

    for max_samples in (64, 100_000):
        a, b = LatencyHistogram(max_samples=max_samples), JaxHist(max_samples=max_samples)
        for v in np.linspace(0.001, 0.1, 1000):
            a.observe(float(v))
            b.observe(float(v))
        assert a.summary() == b.summary()
        assert a.buckets() == b.buckets()
        other = LatencyHistogram(max_samples=max_samples)
        jother = JaxHist(max_samples=max_samples)
        for v in np.random.RandomState(3).rand(300):
            other.observe(float(v))
            jother.observe(float(v))
        assert a.merge(other).summary() == b.merge(jother).summary()


def test_metrics_summary_matches_jax():
    from repro.serve import ServingMetrics as JaxMetrics

    out = []
    for Metrics in (ServingMetrics, JaxMetrics):
        clk = VirtualClock()
        m = Metrics(slo_s=0.5, clock=clk)
        m.on_submit(3)
        m.on_submit(1)
        clk.advance(2.0)
        m.on_complete(3, 0.7, violated=True)
        m.on_expired(1)
        m.on_tile(3, 4)
        m.on_swap(4)
        m.observe_queue_depth(6)
        m.on_reject()
        merged = m.merge(Metrics(slo_s=0.5, clock=clk))
        out.append((m.summary(), merged.summary()))
    assert out[0] == out[1]
    assert out[0][0]["throughput_rps"] == pytest.approx(0.5)
    with pytest.raises(ValueError):
        ServingMetrics(slo_s=0.0)
