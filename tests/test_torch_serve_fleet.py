"""The port's fleet router (repro_torch/serve/fleet.py) against the JAX
package's.

One scripted stream under a shared VirtualClock — affinity routing,
spills, shedding, a rolling publish, a crash failover and a restore, a
client session with monotonic reads — runs through the JAX fleet and the
port's: per-request outcome (admitted, reason, replica), status,
snapshot_version and completion order are equal, scores agree within
1e-5, and the router counters and the merged ``ServingMetrics.summary()``
counters are equal. The remaining cases are the scenarios of
tests/test_serve_fleet.py on the port.
"""
import threading
import types

import numpy as np
import pytest

from repro_torch.core import DMTRLEstimator
from repro_torch.data.synthetic import synthetic
from repro_torch.serve import (
    ClientToken,
    ContinuousBatchingScheduler,
    FleetRouter,
    ModelSnapshot,
    MTLScoringEngine,
    ScoreRequest,
    ServingMetrics,
    SubmitOutcome,
    VirtualClock,
)

TOL = 1e-5


def _port_stack():
    return types.SimpleNamespace(
        Scheduler=ContinuousBatchingScheduler, Router=FleetRouter,
        ScoreRequest=ScoreRequest, VirtualClock=VirtualClock,
        engine=lambda W, **kw: MTLScoringEngine(W, device="cpu", **kw),
    )


def _jax_stack():
    from repro import serve

    return types.SimpleNamespace(
        Scheduler=serve.ContinuousBatchingScheduler, Router=serve.FleetRouter,
        ScoreRequest=serve.ScoreRequest, VirtualClock=serve.VirtualClock,
        engine=serve.MTLScoringEngine,
    )


class Crashable:
    """An engine whose tiles raise while ``crashed`` is set."""

    def __init__(self, inner):
        self.inner, self.crashed = inner, False

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def run_tile(self, reqs, snapshot):
        if self.crashed:
            raise RuntimeError("host down")
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


def _fleet(S, W, n=3, batch=4, version=1, clock=None, engine=None, **router_kw):
    clock = clock or S.VirtualClock()
    make = engine or (lambda: S.engine(W, batch=batch, version=version))
    reps = [S.Scheduler(make(), clock=clock) for _ in range(n)]
    return S.Router(reps, **router_kw), reps, clock


def _scripted(S, W):
    rng = np.random.RandomState(5)
    Ws = [rng.randn(*W.shape).astype(np.float32) for _ in range(2)]
    engines = []

    def make():
        engines.append(Crashable(S.engine(W, batch=4, version=1)))
        return engines[-1]

    router, reps, clk = _fleet(S, W, n=3, engine=make, slo_s=0.06, tile_cost_s=0.02,
                               spill_depth=3)
    reqs = _requests(S, 60, seed=21)
    token = router.session()
    outcomes, order = [], []
    for tick in range(30):
        for r in reqs[2 * tick : 2 * tick + 2] if tick % 3 else reqs[2 * tick : 2 * tick + 6]:
            if r.status != "new":
                continue
            client = token if r.task == 2 else None
            dl = 0.5 if r.task == 4 else None
            o = router.submit(r, deadline_s=dl, client=client)
            outcomes.append((o.admitted, o.reason, o.replica))
        if tick == 4:
            router.publish_weights(Ws[0])
        if tick == 7:
            engines[router.home_of(1)].crashed = True
        if tick == 12:
            engines[router.home_of(1)].crashed = False
            router.restore_replica(router.home_of(1))
            router.publish_weights(Ws[1], version=1)  # behind: restamped
        order += [id(r) for r in router.step()]
        clk.advance(0.01)
    router.run_until_idle()
    return reqs, order, outcomes, router, [rep.version for rep in reps]


def test_scripted_fleet_matches_jax(W):
    jr, jorder, jout, jrouter, jvers = _scripted(_jax_stack(), W)
    tr, torder, tout, trouter, tvers = _scripted(_port_stack(), W)
    assert tout == jout
    assert tvers == jvers == [trouter.version] * 3
    assert [r.status for r in tr] == [r.status for r in jr]
    assert [r.snapshot_version for r in tr] == [r.snapshot_version for r in jr]
    pos_j = {k: n for n, k in enumerate(jorder)}
    pos_t = {k: n for n, k in enumerate(torder)}
    assert [pos_t.get(id(r)) for r in tr] == [pos_j.get(id(r)) for r in jr]
    for a, b in zip(tr, jr):
        if a.score is not None:
            assert a.score == pytest.approx(b.score, abs=TOL)
    assert trouter.counters == jrouter.counters
    c = trouter.counters
    assert c["failovers"] == 1 and c["restarts"] == 1 and c["publishes"] == 2
    assert c["shed"] + c["spills"] > 0
    ts, js = trouter.summary(), jrouter.summary()
    assert ts["per_replica"] == js["per_replica"]
    for key in ("submitted", "completed", "rejected", "expired", "slo_violations",
                "swaps", "last_version", "tiles", "tile_fill", "per_task", "latency"):
        assert ts["fleet"][key] == js["fleet"][key], key
    # client reads never went backwards
    seen = [r.snapshot_version for r in tr if r.task == 2 and r.status == "done"]
    assert seen == sorted(seen)


# ---------------------------------------------------------------------------
# the scenarios of tests/test_serve_fleet.py, on the port
# ---------------------------------------------------------------------------
P = _port_stack()


def _preqs(n, seed=1):
    return _requests(P, n, seed=seed)


def test_virtual_clock_rules_and_threads():
    clk = VirtualClock(5.0)
    with pytest.raises(ValueError, match="earlier than the current time"):
        clk.advance_to(4.0)
    with pytest.raises(ValueError, match=">= 0"):
        clk.advance(-1.0)
    clk2 = VirtualClock()
    ts = [threading.Thread(target=lambda: [clk2.advance(0.001) for _ in range(1000)])
          for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in ts)
    assert clk2() == pytest.approx(8.0)


def test_submit_many_outcomes(W):
    sched = P.Scheduler(P.engine(W, batch=4), clock=VirtualClock(), max_queue=2)
    outs = sched.submit_many(_preqs(4))
    assert [o.admitted for o in outs] == [True, True, False, False]
    assert {o.reason for o in outs if not o.admitted} == {"queue_full"}
    sched.step()
    reqs = _preqs(2, seed=2)
    reqs[1].deadline_s = -1.0
    outs = sched.submit_many(reqs)
    assert outs[0].admitted and outs[1].reason == "expired"
    assert all(isinstance(o, SubmitOutcome) for o in outs)


def test_affinity_spill_and_shed(W):
    router, _, _ = _fleet(P, W)
    router2, _, _ = _fleet(P, W)
    homes = {t: router.home_of(t) for t in range(5)}
    assert homes == {t: router2.home_of(t) for t in range(5)}
    for t, rid in homes.items():
        assert router.submit(ScoreRequest(task=t, x=np.zeros(12, np.float32))).replica == rid
    router, _, _ = _fleet(P, W, spill_depth=3)
    home = router.home_of(0)
    for _ in range(3):
        assert router.submit(ScoreRequest(task=0, x=np.zeros(12, np.float32))).replica == home
    out = router.submit(ScoreRequest(task=0, x=np.zeros(12, np.float32)))
    assert out.admitted and out.replica != home and router.counters["spills"] == 1
    router, _, _ = _fleet(P, W, slo_s=0.05, tile_cost_s=0.02)
    for _ in range(24):
        assert router.submit(_preqs(1, seed=7)[0]).admitted
    shed = router.submit(_preqs(1, seed=8)[0])
    assert not shed.admitted and shed.reason == "shed" and shed.request.status == "shed"
    assert router.metrics().slo_violations == 0
    assert router.submit(_preqs(1, seed=9)[0], deadline_s=10.0).admitted


def test_rolling_publish_and_monotonic_reads(W):
    router, reps, _ = _fleet(P, W)
    assert router.publish_weights(W * 2.0) == 2
    assert sorted(r.version for r in reps) == [1, 1, 2] and router.roll_pending == 2
    tok = router.session()
    tok.observe(2)
    for _ in range(6):
        out = router.submit(_preqs(1, seed=5)[0], client=tok)
        assert out.admitted and reps[out.replica].version == 2
    assert all(r.snapshot_version >= 2 for r in router.step())
    router.step()
    assert sorted(r.version for r in reps) == [2, 2, 2] and router.roll_pending == 0
    assert router.publish_weights(W * 4.0, version=100) == 100
    assert router.publish(ModelSnapshot(version=5, W=W * 5.0)) == 101
    with pytest.raises(ValueError, match="shape"):
        router.publish_weights(np.zeros((2, 2), np.float32))
    assert isinstance(tok, ClientToken)


def test_pull_forward_failover_restore_and_no_replica(W):
    router, reps, _ = _fleet(P, W)
    router.publish_weights(W * 2.0)
    (fresh,) = [i for i, r in enumerate(reps) if r.version == 2]
    tok = router.session()
    tok.observe(2)
    router.fail_replica(fresh)
    out = router.submit(_preqs(1, seed=6)[0], client=tok)
    assert out.admitted and reps[out.replica].version == 2
    assert router.counters["pull_forwards"] == 1
    router.restore_replica(fresh)
    reqs = _preqs(9, seed=8)
    outs = [router.submit(r) for r in reqs]
    victim = outs[0].replica
    stranded = reps[victim].pending
    assert router.fail_replica(victim) == stranded and reps[victim].pending == 0
    router.run_until_idle()
    assert all(r.status == "done" and r.score is not None for r in reqs)
    router.publish_weights(W * 3.0)
    router.run_until_idle()
    while router.roll_pending:
        router.step()
    assert reps[victim].version < router.version  # down: the roll skipped it
    router.restore_replica(victim)
    assert reps[victim].version == router.version
    small, _, _ = _fleet(P, W, n=2)
    small.fail_replica(0)
    small.fail_replica(1)
    out = small.submit(_preqs(1, seed=3)[0])
    assert not out.admitted and out.reason == "no_replica"


def test_crashing_engine_fails_over(W):
    engines = []

    def make():
        engines.append(Crashable(P.engine(W, batch=4, version=1)))
        return engines[-1]

    router, reps, _ = _fleet(P, W, engine=make)
    reqs = _preqs(12, seed=9)
    for r in reqs:
        assert router.submit(r).admitted
    victim = next(i for i, rep in enumerate(reps) if rep.pending)
    engines[victim].crashed = True
    while router.pending:
        router.step()
    assert not router.replica(victim).up and router.counters["failovers"] == 1
    assert all(r.status == "done" for r in reqs)


def test_fleet_metrics_rollup_and_publish(W):
    from repro_torch.obs.export import to_prometheus
    from repro_torch.obs.metrics import MetricsRegistry

    router, reps, clock = _fleet(P, W)
    for r in _preqs(10, seed=11):
        router.submit(r)
    while router.pending:
        router.step()
        clock.advance(0.01)
    m = router.metrics()
    assert isinstance(m, ServingMetrics)
    assert m.completed == 10 == sum(rep.metrics.completed for rep in reps)
    s = router.summary()
    assert s["replicas"] == 3 and s["up"] == 3 and s["router"]["admitted"] == 10
    reg = MetricsRegistry()
    router.publish_metrics(registry=reg)
    text = to_prometheus(reg)
    assert 'repro_serve_completed{replica="all"} 10' in text


def test_estimator_serving_fleet_and_rolling_push():
    sp = synthetic(1, m=4, d=16, n_train_avg=30, n_test_avg=10, seed=0)
    est = DMTRLEstimator(loss="hinge", lam=1e-4, outer_iters=1, rounds=2, local_iters=16,
                         block_size=16, seed=0, device="cpu").fit(sp.train)
    router = est.serving_fleet(n_replicas=2, batch=4, clock=VirtualClock())
    assert router.n_replicas == 2
    v0 = router.version
    est.partial_fit(sp.train)  # pushes through the ROUTER (rolling)
    assert router.version > v0
    x = sp.test.x[0, 0].numpy()
    r = ScoreRequest(task=0, x=x)
    assert router.submit(r).admitted
    router.run_until_idle()
    assert r.status == "done"
    assert r.score == pytest.approx(float(est.decision_function(x, tasks=0)[0]), abs=1e-6)
    router.warmup()  # no graph to capture on the CPU: a no-op on every replica
    assert all(router.replica(i).scheduler.engine._graph is None for i in range(2))


class VersionEcho:
    """'Scores' a request by recording the snapshot version it ran
    against: pure queue/version semantics under contention."""

    batch = 4

    def __init__(self, version=1):
        self._snap = ModelSnapshot(version=version, W=None)

    def admit(self, r):
        pass

    def task_key(self, r):
        return r.task

    def model_snapshot(self):
        return self._snap

    def run_tile(self, reqs, snapshot):
        for r in reqs:
            r.score = float(snapshot.version)


def test_threaded_publish_storm_never_regresses_client_reads():
    clock = VirtualClock()
    router = FleetRouter([ContinuousBatchingScheduler(VersionEcho(), clock=clock)
                          for _ in range(3)])
    errors = []

    def producer(k):
        try:
            rng = np.random.RandomState(100 + k)
            for i in range(200):
                if i % 3 == k % 2:
                    router.publish_weights(None, version=int(rng.randint(1, 50)))
                else:
                    router.publish(ModelSnapshot(version=i, W=None))
        except Exception as e:  # pragma: no cover - failure reporting
            errors.append(e)

    def client(seed):
        try:
            tok = router.session()
            rng_c = np.random.RandomState(seed)
            for _ in range(40):
                r = ScoreRequest(task=int(rng_c.randint(5)), x=np.zeros(1, np.float32))
                floor = tok.min_version
                assert router.submit(r, client=tok).admitted
                while r.status != "done":
                    router.step()
                assert r.snapshot_version >= floor
                tok.observe(r.snapshot_version)
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=producer, args=(k,)) for k in range(4)]
    threads += [threading.Thread(target=client, args=(s,)) for s in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[0]
    assert router.metrics().completed >= 6 * 40
