"""The spans inside the port's single-process fit (``core/dmtrl.py``): one
span per layer's unit of work, nested by time under the engine's
``engine_run``, the same fit with tracing on and off, the self-time
breakdown, and the tracer on the profiler's clock.

    PYTHONPATH=src python -m pytest -q tests/test_torch_fit_spans.py
"""
import time

import pytest
import torch

from repro_torch import obs
from repro_torch.core import DMTRLEstimator
from repro_torch.data.synthetic import synthetic
from repro_torch.obs.trace import DEFAULT_CAPACITY, self_times

P, T, TRACK_EVERY = 2, 3, 2
# tracked evaluations a W-step: every TRACK_EVERY-th round and the last
EVALS = P * sum(1 for t in range(T) if t % TRACK_EVERY == 0 or t == T - 1)
ROUND_SPANS = ("coords", "local_sdca", "reduce")


@pytest.fixture
def clean_obs():
    """Tracer off, empty, at its default capacity and clock, before and after."""
    def reset():
        obs.enable(capacity=DEFAULT_CAPACITY, clock=time.perf_counter, clear=True)
        obs.disable()

    reset()
    yield
    reset()


@pytest.fixture(scope="module")
def train():
    return synthetic(1, m=4, d=16, n_train_avg=40, n_test_avg=10, seed=1).train


def _fit(train, solver):
    est = DMTRLEstimator(device="cpu", solver=solver, outer_iters=P, rounds=T,
                         track_every=TRACK_EVERY, block_size=16, seed=3)
    return est.fit(train)


def _traced_fit(train, solver):
    tracer = obs.enable(clear=True)
    est = _fit(train, solver)
    obs.disable()
    return est, [e for e in tracer.events() if e["cat"] == "driver"]


def _encloses(outer, inner):
    return (outer["tid"] == inner["tid"] and outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


@pytest.mark.parametrize("solver", ["pallas_round", "block_gram"])
def test_traced_fit_counts_each_layers_work(clean_obs, train, solver):
    _, events = _traced_fit(train, solver)
    counts = {}
    for e in events:
        counts[e["name"]] = counts.get(e["name"], 0) + 1
    assert counts == {
        "engine_run": 1, "rho": P, "w_step": P, "w_round": P * T, "coords": P * T,
        "local_sdca": P * T, "reduce": P * T, "objectives": EVALS, "omega_step": P,
        "w_from_alpha": P, "host_read": P + EVALS,
    }
    assert sorted(e["args"]["outer"] for e in events if e["name"] == "w_step") == list(range(P))
    per_round = [e for e in events if e["name"] in ("w_round",) + ROUND_SPANS]
    assert all("args" not in e for e in per_round)  # no labels on a round's spans


def test_round_spans_nest_under_the_round_the_w_step_and_the_run(clean_obs, train):
    _, events = _traced_fit(train, "pallas_round")
    by = {}
    for e in events:
        by.setdefault(e["name"], []).append(e)
    (run,) = by["engine_run"]
    for name in ROUND_SPANS:
        for e in by[name]:
            rounds = [r for r in by["w_round"] if _encloses(r, e)]
            assert len(rounds) == 1, name
            steps = [s for s in by["w_step"] if _encloses(s, rounds[0])]
            assert len(steps) == 1 and _encloses(run, steps[0]), name
    # each round's three layers in order, one after the other
    for r in by["w_round"]:
        inside = sorted((e for n in ROUND_SPANS for e in by[n] if _encloses(r, e)),
                        key=lambda e: e["ts"])
        assert [e["name"] for e in inside] == list(ROUND_SPANS)
    # every host read sits in the rho bound or in a tracked evaluation
    for e in by["host_read"]:
        assert sum(_encloses(o, e) for o in by["rho"] + by["objectives"]) == 1
    for name in ("rho", "omega_step", "w_from_alpha", "objectives"):
        assert all(_encloses(run, e) for e in by[name])


@pytest.mark.parametrize("solver", ["pallas_round", "block_gram"])
def test_tracing_off_records_nothing_and_changes_no_output(clean_obs, train, solver):
    off = _fit(train, solver)
    assert obs.get_tracer().events() == []
    on, events = _traced_fit(train, solver)
    assert events
    for f in ("W_", "alpha_", "sigma_", "omega_"):
        assert torch.equal(getattr(off, f), getattr(on, f)), f
    assert off.rho_per_outer_ == on.rho_per_outer_
    assert off.history_.keys() == on.history_.keys()
    for k in off.history_:
        assert (off.history_[k] == on.history_[k]).all(), k


def _ev(name, ts, dur, tid=0):
    return {"name": name, "cat": "t", "ph": "X", "ts": ts, "dur": dur, "pid": 1, "tid": tid}


def test_self_times_by_hand():
    events = [
        _ev("fit", 0, 100), _ev("round", 10, 30), _ev("coords", 12, 5),
        _ev("solve", 20, 15), _ev("round", 50, 40), _ev("solve", 55, 30),
        _ev("read", 95, 5),
        # another thread's spans never count as children
        _ev("fit", 20, 50, tid=1), _ev("solve", 30, 10, tid=1),
    ]
    got = self_times(events)
    want = {  # name: (count, total us, self us)
        "fit": (2, 150, 100 - 30 - 40 - 5 + 50 - 10),
        "round": (2, 70, 30 - 5 - 15 + 40 - 30),
        "coords": (1, 5, 5), "solve": (3, 55, 55), "read": (1, 5, 5),
    }
    assert set(got) == set(want)
    for name, (count, total, own) in want.items():
        assert got[name]["count"] == count
        assert got[name]["total_s"] == pytest.approx(total * 1e-6)
        assert got[name]["self_s"] == pytest.approx(own * 1e-6)
    # self time sums to the wall time the outermost spans cover
    assert sum(r["self_s"] for r in got.values()) == pytest.approx(150e-6)


def test_self_time_breakdown_of_a_traced_fit(clean_obs, train):
    _traced_fit(train, "block_gram")
    inclusive = obs.phase_breakdown(cat="driver")
    own = obs.self_time_breakdown(cat="driver")
    assert set(own) == set(inclusive)
    for name, row in own.items():
        assert row["count"] == inclusive[name]["count"]
        assert row["total_s"] == pytest.approx(inclusive[name]["total_s"])
        assert -1e-9 <= row["self_s"] <= row["total_s"] + 1e-9
    assert sum(r["self_s"] for r in own.values()) == pytest.approx(own["engine_run"]["total_s"])
    for leaf in ROUND_SPANS + ("host_read",):
        assert own[leaf]["self_s"] == pytest.approx(own[leaf]["total_s"])


def test_span_on_the_profilers_clock_contains_its_operator(clean_obs):
    from torch.profiler import ProfilerActivity, profile

    a = torch.randn(192, 192)
    tracer = obs.enable(clear=True, clock=obs.wall_clock)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with obs.span("matmul", cat="t"):
                a @ a
    obs.disable()
    base_us = prof.profiler.kineto_results.trace_start_ns() / 1e3
    mms = [e for e in prof.events() if e.name == "aten::mm"]
    spans = tracer.events()
    assert len(mms) == len(spans) == 3
    for e, s in zip(sorted(mms, key=lambda e: e.time_range.start), spans):
        # 1 us: the float resolution of an epoch time in seconds is 0.24 us
        assert s["ts"] - 1.0 <= base_us + e.time_range.start
        assert base_us + e.time_range.end <= s["ts"] + s["dur"] + 1.0
