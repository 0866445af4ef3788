"""The port's MTL examples against the JAX examples, on the CPU:
examples/torch/quickstart.py, serve_batch.py --mtl, serve_stream.py and
serve_fleet.py, each beside its twin in examples/ at the ``--tiny`` sizes.

The JAX example runs in this process (``runpy``) and its printed numbers
are parsed; the port example's ``main([..., "--device", "cpu"])`` returns
its numbers. A printed number is rounded: the bar is widened by half a
unit of its last digit (``assert_printed_close``). Bars: gaps and
W-derived scores at the fit bar on W (2e-4), the correlations at the one
on Sigma (1e-5), accuracies within one test sample of one task
(1 / (m n_min)); served-by-version histograms, counters and task homes
equal. Wall-clock numbers (latency, throughput, SLO violations) are not
compared. Without a card, ``--device cuda`` (the default) raises before
any work.
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.data.synthetic import synthetic
from torch_examples_util import (
    NUMBER,
    assert_printed_close,
    grab,
    port_example,
    run_jax_example,
)

TOL_W, TOL_SIGMA = 2e-4, 1e-5  # the fit bars (tests/test_distributed.py)


def one_sample(m, d, n_tr, n_te):
    """The accuracy of one test sample of the smallest task of the
    examples' Synthetic-1 split (seed 0)."""
    test = synthetic(1, m=m, d=d, n_train_avg=n_tr, n_test_avg=n_te, seed=0).test
    return 1.0 / (m * int(test.n.min()))


def served_of(text):
    body, = grab(r"on versions \{([^}]*)\}", text)
    return dict(kv.split(": ") for kv in body.replace("v", "").split(", "))


def test_quickstart_matches_jax(monkeypatch, capsys):
    text = run_jax_example("quickstart.py", ["--tiny"], monkeypatch, capsys)
    out = port_example("quickstart").main(["--tiny", "--device", "cpu"])
    g0, g1 = grab(rf"duality gap: ({NUMBER}) -> ({NUMBER})", text)
    assert_printed_close(g0, out["gap_first"], TOL_W, "gap first")
    assert_printed_close(g1, out["gap_last"], TOL_W, "gap last")
    assert out["gap_last"] < out["gap_first"]
    rhos, = grab(r"rho per outer iteration: \[([^\]]*)\]", text)
    rhos = rhos.split(", ")
    assert len(rhos) == len(out["rho_per_outer"])
    for r, v in zip(rhos, out["rho_per_outer"]):
        assert_printed_close(r, v, TOL_SIGMA, "rho")
    acc, acc_stl = grab(rf"DMTRL ({NUMBER})  vs  STL ({NUMBER})", text)
    bar = one_sample(6, 24, 60, 30)
    assert_printed_close(acc, out["accuracy"], bar, "accuracy")
    assert_printed_close(acc_stl, out["accuracy_stl"], bar, "STL accuracy")
    align, = grab(rf"alignment: ({NUMBER})", text)
    assert_printed_close(align, out["alignment"], TOL_SIGMA, "alignment")
    rows = text.split("(rounded):\n")[1].strip().replace("[", " ").replace("]", " ")
    printed = rows.split()
    learned = np.asarray(out["correlation"])
    assert learned.shape == (6, 6) and len(printed) == 36
    for p, v in zip(printed, learned.ravel()):
        assert_printed_close(p, float(v), TOL_SIGMA, "correlation")


def test_serve_batch_mtl_matches_jax(monkeypatch, capsys):
    text = run_jax_example("serve_batch.py", ["--mtl", "--tiny"], monkeypatch, capsys)
    out = port_example("serve_batch").main(["--mtl", "--tiny", "--device", "cpu"])
    acc, = grab(rf"test accuracy: ({NUMBER})", text)
    assert_printed_close(acc, out["accuracy"], one_sample(6, 24, 60, 40), "accuracy")
    reqs = re.findall(rf"req\d+: task=(\d+)  score=({NUMBER})  label=({NUMBER})", text)
    assert len(reqs) == len(out["requests"]) == 7
    for (task, score, label), r in zip(reqs, out["requests"]):
        assert int(task) == r["task"] and float(label) == r["label"]
        assert_printed_close(score, r["score"], TOL_W, "score")


def frozen_clock(monkeypatch, estimator_cls, clock_cls):
    """Give the schedulers ``estimator_cls.serving_scheduler`` builds a
    VirtualClock that never advances."""
    build = estimator_cls.serving_scheduler

    def frozen(self, *args, **kw):
        return build(self, *args, clock=clock_cls(), **kw)

    monkeypatch.setattr(estimator_cls, "serving_scheduler", frozen)


def test_serve_stream_matches_jax(monkeypatch, capsys):
    """Bursty arrivals through the scheduler with a partial_fit hot-swap
    halfway. The example's scheduler runs on the wall clock, against which
    its requests' 1 s deadlines expire: JAX's partial_fit alone can pass
    it (3 of 48 expired on the build host). Both runs here take a clock
    that never advances, so what is compared depends on no clock."""
    from repro.core import DMTRLEstimator as JaxEstimator
    from repro.serve import VirtualClock as JaxClock
    from repro_torch.core import DMTRLEstimator
    from repro_torch.serve import VirtualClock

    frozen_clock(monkeypatch, JaxEstimator, JaxClock)
    frozen_clock(monkeypatch, DMTRLEstimator, VirtualClock)
    text = run_jax_example("serve_stream.py", ["--tiny"], monkeypatch, capsys)
    out = port_example("serve_stream").main(["--tiny", "--device", "cpu"])
    acc, = grab(rf"test accuracy: ({NUMBER})", text)
    assert_printed_close(acc, out["accuracy"], one_sample(6, 24, 60, 40), "accuracy")
    v0, = grab(r"scheduler up: .* model v(\d+)", text)
    v1, = grab(r"now serving model v(\d+)", text)
    assert (int(v0), int(v1)) == (out["version_start"], out["version_swapped"])
    assert served_of(text) == {k: str(n) for k, n in out["served"].items()}
    completed, = grab(r"served (\d+) requests", text)
    fill, depth = grab(rf"tile fill: ({NUMBER})   queue depth max: (\d+)", text)
    expired, swaps = grab(r"\(expired: (\d+)\)   hot-swaps: (\d+)", text)
    assert int(completed) == out["completed"] == 48
    assert_printed_close(fill, out["tile_fill"], 0.0, "tile fill")
    assert (int(depth), int(expired), int(swaps)) == (
        out["queue_depth_max"], out["expired"], out["swaps"])


def test_serve_fleet_matches_jax(monkeypatch, capsys):
    text = run_jax_example("serve_fleet.py", ["--tiny"], monkeypatch, capsys)
    out = port_example("serve_fleet").main(["--tiny", "--device", "cpu"])
    acc, = grab(rf"test accuracy: ({NUMBER})", text)
    assert_printed_close(acc, out["accuracy"], one_sample(6, 24, 60, 40), "accuracy")
    n, v0 = grab(r"fleet up: (\d+) replicas, .* model v(\d+)", text)
    assert (int(n), int(v0)) == (out["replicas"], out["version_start"])
    homes = {rid: ts for rid, ts in re.findall(r"replica (\d+) <- tasks \[([^\]]*)\]", text)}
    assert homes == {k: ", ".join(map(str, v)) for k, v in out["homes"].items()}
    target, rolling = grab(r"fleet target v(\d+) \((\d+) replicas still rolling\)", text)
    moved, = grab(r"replica 1 down: (\d+) queued", text)
    restored, = grab(r"replica 1 restored at v(\d+)", text)
    assert tuple(map(int, (target, rolling, moved, restored))) == (
        out["target_version"], out["roll_pending"], out["moved"], out["restored_version"])
    assert served_of(text) == {k: str(v) for k, v in out["served"].items()}
    assert out["monotonic_reads"]
    completed, = grab(r"served (\d+) requests", text)
    assert int(completed) == out["completed"] == 60
    c = dict(zip(("spills", "shed", "failovers", "requeued", "restarts", "rolled_installs"),
                 map(int, grab(r"router: (\d+) spills, (\d+) shed, (\d+) failover \((\d+) "
                               r"re-pinned\), (\d+) restart, (\d+) rolled installs", text))))
    assert c == out["router"]
    per = re.findall(r"\[(\d+)\] v(\d+) done=(\d+)", text)
    assert [tuple(map(int, p)) for p in per] == [
        (p["id"], p["version"], p["completed"]) for p in out["per_replica"]]


@pytest.mark.parametrize("name, args", [
    ("quickstart", ["--tiny"]),
    ("serve_batch", ["--mtl", "--tiny"]),
    ("serve_stream", ["--tiny"]),
    ("serve_fleet", ["--tiny"]),
])
def test_runs_on_the_card_unless_asked(name, args, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    mod = port_example(name)
    capsys.readouterr()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main(args)
    assert capsys.readouterr().out == ""  # raised before any work
