"""``spans.py``: the readings of the span pass's record, the idle stretches
put down to the innermost span, the span pass on the CPU at a small size,
and on the card (marker ``gpu``) the shared clock: a span around K1's
launch and a synchronize holds K1's device interval, and the attribution
pass names every idle stretch inside a fit.

    python -m pytest perfbench/tests/test_perfbench_spans.py
    python -m pytest -m gpu perfbench/tests/test_perfbench_spans.py   # with a card
"""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import spans, spec  # noqa: E402

# the card's clocks: how far a kernel may lie outside the span around its
# launch and synchronize, in microseconds (PERF.md gives the margins read)
CLOCK_TOLERANCE_US = 2.0

CANNED = dict(fits=2, fit_s=0.2, spans={
    "w_round": dict(count=80, total_s=0.32, self_s=0.0),
    "omega_step": dict(count=8, total_s=0.008, self_s=0.008),
    "coords": dict(count=80, total_s=0.12, self_s=0.12),
    "objectives": dict(count=16, total_s=0.048, self_s=0.0),
    "host_read": dict(count=24, total_s=0.05, self_s=0.05),
})


def test_readings_on_a_canned_record():
    got = spans.readings(CANNED)
    assert got == pytest.approx(dict(fit_round_ms=4.0, fit_omega_ms=1.0, coords_ms=1.5,
                                     objectives_ms=3.0, sync_wait_ms=25.0))
    # a program without the spans (before they existed): nothing to read
    assert spans.readings(dict(fits=2, fit_s=0.2, spans={"engine_run": dict(
        count=2, total_s=0.4, self_s=0.4)})) == dict.fromkeys(spans.READINGS)
    assert spans.readings({}) == dict.fromkeys(spans.READINGS)


def _ev(name, ts, dur):
    return {"name": name, "cat": "driver", "ph": "X", "ts": ts, "dur": dur, "pid": 1, "tid": 0}


EVENTS = [
    _ev("engine_run", 0, 100), _ev("w_step", 5, 80), _ev("w_round", 10, 30),
    _ev("coords", 10, 10), _ev("local_sdca", 22, 15), _ev("w_round", 45, 30),
    _ev("coords", 45, 20), _ev("objectives", 78, 6), _ev("host_read", 80, 4),
]


def test_self_segments_name_the_innermost_span():
    segs = spans.self_segments(EVENTS)
    assert segs == [
        (0, 5, "engine_run"), (5, 10, "w_step"), (10, 20, "w_step/w_round/coords"),
        (20, 22, "w_step/w_round"), (22, 37, "w_step/w_round/local_sdca"),
        (37, 40, "w_step/w_round"), (40, 45, "w_step"), (45, 65, "w_step/w_round/coords"),
        (65, 75, "w_step/w_round"), (75, 78, "w_step"), (78, 80, "w_step/objectives"),
        (80, 84, "w_step/objectives/host_read"), (84, 85, "w_step"), (85, 100, "engine_run"),
    ]
    # the segments tile the root span once
    assert sum(b - a for a, b, _ in segs) == 100


def test_idle_gaps_put_down_to_the_innermost_span():
    gaps = [(12.0, 18.0), (19.0, 23.0), (50.0, 60.0), (81.0, 83.0), (98.0, 110.0),
            (120.0, 130.0)]
    out = spans.idle_by_span(gaps, spans.self_segments(EVENTS), top=3)
    coords = "w_step/w_round/coords"
    assert out["by_path"] == pytest.approx({
        coords: 6e-6 + 1e-6 + 10e-6, "w_step/w_round": 2e-6,
        "w_step/w_round/local_sdca": 1e-6, "w_step/objectives/host_read": 2e-6,
        "engine_run": 2e-6, spans.NO_SPAN: 10e-6 + 10e-6,
    })
    # the longest gaps inside a fit, each by the path covering most of it;
    # (98, 110) lies mostly past the fit's end
    assert out["longest"] == [
        [coords, pytest.approx(10e-6), pytest.approx(1.0), {coords: pytest.approx(1.0)}],
        [coords, pytest.approx(6e-6), pytest.approx(1.0), {coords: pytest.approx(1.0)}],
        ["w_step/w_round", pytest.approx(4e-6), pytest.approx(0.5),
         {coords: pytest.approx(0.25), "w_step/w_round": pytest.approx(0.5),
          "w_step/w_round/local_sdca": pytest.approx(0.25)}],
    ]


def test_by_name_sums_the_paths_last_parts():
    got = spans.by_name({"w_step/w_round/coords": 1.0, "w_step/w_round": 2.0,
                         "w_step/objectives/host_read": 3.0, "rho/host_read": 4.0,
                         spans.NO_SPAN: 5.0})
    assert got == {"coords": 1.0, "w_round": 2.0, "host_read": 7.0, spans.NO_SPAN: 5.0}


def test_span_pass_on_the_cpu():
    from perfbench.program import Program

    traffic = spec.load_json(spec.HERE / "traffic" / "paper_omega.json")
    traffic.update(outer_iters=2, rounds=3, track_every=2)
    config = {"generator": "synthetic1", "lam": 1e-3,
              "params": {"m": 6, "d": 8, "n_train_avg": 40, "n_test_avg": 10}}
    prog = Program(spec.make_data(config, 5), config, traffic, 5, "cpu")
    prog.fit()
    program = spans.span_pass(prog.fit, 2)
    counts = {name: row["count"] for name, row in program["spans"].items()}
    assert counts == {"engine_run": 2, "rho": 4, "w_step": 4, "w_round": 12, "coords": 12,
                      "local_sdca": 12, "reduce": 12, "objectives": 8, "host_read": 12,
                      "omega_step": 4, "w_from_alpha": 4}
    assert program["fits"] == 2 and program["fit_s"] > 0
    assert program["k1_launches"] == 0  # the kernel's plain version runs on the CPU
    assert all(v is not None and v > 0 for v in spans.readings(program).values())
    turns = spans.overhead(prog.fit, 1, turns=2)
    assert turns["off_s"] > 0 and turns["on_s"] > 0 and turns["span_s"] > 0
    from repro_torch import obs

    assert not obs.enabled() and obs.get_tracer().events() == []


# -- on the card ------------------------------------------------------------
@pytest.fixture
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.gpu
def test_span_around_k1_holds_its_device_interval(card):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs
    from repro_torch.kernels.sdca import ops

    g = torch.Generator(device="cpu").manual_seed(7)
    m, n, d, H = 10, 1200, 784, 1216  # MNIST's width, a tenth of its rows
    x = torch.randn(m, n, d, generator=g).to(card)
    y = torch.where(torch.rand(m, n, generator=g) < 0.5, -1.0, 1.0).to(card)
    alpha, w = torch.zeros(m, n, device=card), torch.zeros(m, d, device=card)
    u = torch.rand(m, H, generator=g).to(card)
    n_i = torch.full((m,), n, dtype=torch.int32, device=card)
    kappa = torch.full((m,), 1e-3, device=card)

    def k1():
        ops.sdca_round(x, y, alpha, w, u, n_i, kappa, "hinge", block=64)

    k1()
    torch.cuda.synchronize()
    tracer = obs.enable(clear=True, clock=obs.wall_clock)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                with obs.span("k1", cat="t"):
                    k1()
                    torch.cuda.synchronize()
    finally:
        obs.disable()
    base_us = prof.profiler.kineto_results.trace_start_ns() / 1e3
    kernels = [(e.time_range.start + base_us, e.time_range.end + base_us) for e in prof.events()
               if e.device_type != DeviceType.CPU and "sdca::" in e.name]
    events = tracer.events()
    tracer.clear()
    assert len(events) == 5 and len(kernels) == 10  # gram and chain, each launch
    before, after = [], []
    for ev in events:
        inside = [k for k in kernels if ev["ts"] - 50 <= k[0] <= ev["ts"] + ev["dur"]]
        assert len(inside) == 2
        before.append(min(k[0] for k in inside) - ev["ts"])
        after.append(ev["ts"] + ev["dur"] - max(k[1] for k in inside))
    print(f"margins us: start {min(before):.2f}..{max(before):.2f}, "
          f"end {min(after):.2f}..{max(after):.2f}")
    assert min(before) >= -CLOCK_TOLERANCE_US and min(after) >= -CLOCK_TOLERANCE_US


@pytest.mark.gpu
def test_attribution_pass_names_every_idle_gap_inside_a_fit(card):
    from perfbench.program import Program

    cell = spec.cell("synthetic1.fit")
    traffic = dict(cell.traffic, outer_iters=2, rounds=4, track_every=4)
    prog = Program(spec.make_data(cell.config, 11), cell.config, traffic, 11, card)
    prog.fit()
    program = spans.span_pass(prog.fit, 2)
    assert program["k1_launches"] == program["spans"]["w_round"]["count"] == 16
    idle = spans.attribution_pass(prog.fit, 2)
    assert idle["fits"] == 2 and idle["busy_s"] > 0 and idle["longest"]
    names = {p.rsplit("/", 1)[-1] for p in idle["by_path"]}
    assert {"coords", "local_sdca", "host_read"} <= names
    for path, seconds, share, parts in idle["longest"]:
        assert path != spans.NO_SPAN and seconds > 0 and 0 < share <= 1
        assert parts[path] == share and sum(parts.values()) == pytest.approx(1.0)
