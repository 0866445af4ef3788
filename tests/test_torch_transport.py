"""The port's parameter server (repro_torch/core/transport.py and
async_dmtrl.py) on the CPU, mirroring tests/test_transport.py:

  * tau = 0 parity: the threaded server at 1, 2 and 4 workers against the
    JAX package's single-process ``dmtrl.fit`` on the shared small problem,
    at the fit bars (W atol 2e-4, Sigma atol 1e-5; tests/test_distributed.py)
    — not against the JAX mesh engines, which fail on this jax;
  * the multiprocess server (worker processes importing only the port)
    against the threaded one, at the same bars;
  * the SSP gate under a paced straggler, tau="auto" with a zero budget,
    the overlapped Omega-step, the controller's transitions;
  * lossy codecs: the final objective within the JAX test's bound of the
    exact run and of the JAX transport's run under the same codec;
    ``payload_nbytes`` equal to the JAX transport's on the same snapshot;
  * a raising model subscriber isolated; a scheduler subscribed;
  * ``DMTRLEstimator(engine="async")`` fit, predict and warm-start
    ``partial_fit``; the simulated transport's protocol methods, its setup
    checks, and its parity with the threaded server at tau = 0 (its mesh
    cases are in tests/test_torch_distributed.py).
"""
import dataclasses
import logging

import numpy as np
import pytest
import torch

from repro.core import AsyncOptions as JAsyncOptions
from repro.core import MeshAxes as JMeshAxes
from repro.core import dmtrl as jdmtrl
from repro.core import omega_regularizers as jreg
from repro.core import transport as jtransport
from repro.core.async_dmtrl import fit_async as jfit_async
from repro_torch import prng
from repro_torch.core import AsyncOptions, DMTRLConfig, DMTRLEstimator, fit_async
from repro_torch.core import convergence as cv
from repro_torch.core import omega_regularizers as treg
from repro_torch.core.dmtrl import _rho_value
from repro_torch.core.engines import get_engine
from repro_torch.core.transport import (
    _adapt_tau,
    available_transports,
    get_transport,
    make_block_solver,
    payload_nbytes,
)
from repro_torch.data.synthetic import synthetic
from repro_torch.serve import ContinuousBatchingScheduler, MTLScoringEngine, VirtualClock

TOL_W, TOL_SIGMA = 2e-4, 1e-5  # the fit bars (tests/test_distributed.py)


@pytest.fixture(scope="module")
def port_problem():
    return synthetic(1, m=4, d=16, n_train_avg=40, n_test_avg=10, seed=1)


@pytest.fixture(scope="module")
def port_cfg(small_cfg):
    return DMTRLConfig(**dataclasses.asdict(small_cfg))


@pytest.fixture(scope="module")
def jax_ref(small_problem, small_cfg):
    return jdmtrl.fit(small_cfg, small_problem.train)


def _fit(cfg, data, transport, n_workers, **kw):
    opts = AsyncOptions(transport=transport, n_workers=n_workers, **kw)
    return fit_async(cfg, data, options=opts, device="cpu")


def _setup(cfg, data, name="threaded", track=False):
    t = get_transport(name).factory()
    reg = treg.resolve_regularizer(cfg, None, m=data.m)
    t.setup(cfg, data, mesh=None, axes=None, reg=reg, init=None, track=track,
            device="cpu")
    return t, reg


def _drive(t, cfg, reg):
    """The fit_async outer loop by hand over a set-up transport."""
    key = prng.PRNGKey(cfg.seed)
    rho_sigma = t.rho_sigma()
    for p in range(cfg.outer_iters):
        rho = _rho_value(cfg, rho_sigma, reg=reg)
        key, ok = prng.split(key)
        t.run_w_step(p, rho, ok)
        sig, om = t.pad_sigma(*reg.step(t.w_true(), cfg.omega_jitter))
        t.install_sigma(sig, om, defer=False)
        rho_sigma = sig


# ---------------------------------------------------------------------------
# registry and options
# ---------------------------------------------------------------------------
def test_registry_surface():
    assert set(available_transports()) == {"simulated", "threaded", "multiprocess", "gossip"}
    for n in available_transports():
        spec = get_transport(n)
        assert spec.name == n and callable(spec.factory)
    with pytest.raises(KeyError, match="unknown transport"):
        get_transport("carrier-pigeon")


def test_bad_transport_knobs_rejected(port_problem):
    with pytest.raises(ValueError, match="transport"):
        AsyncOptions(transport=7)
    with pytest.raises(ValueError, match="n_workers"):
        AsyncOptions(n_workers=0)
    with pytest.raises(ValueError, match="staleness_budget"):
        AsyncOptions(tau="auto", staleness_budget=-1.0)
    with pytest.raises(ValueError, match="staleness_budget"):
        AsyncOptions(tau=2, staleness_budget=0.5)
    with pytest.raises(ValueError, match="tau"):
        DMTRLConfig(tau="fast")
    with pytest.raises(ValueError, match="codec"):
        DMTRLConfig(codec="zstd")
    with pytest.raises(KeyError, match="unknown transport"):
        fit_async(DMTRLConfig(transport="smoke-signal"), port_problem.train, device="cpu")


def test_simulated_and_mesh_engine_raise_naming_the_roadmap(port_problem, port_cfg, jax_ref):
    """The three entry points that refused before the mesh engines were
    ported now run: fit_async with the default (simulated) transport,
    get_engine("distributed") and the estimator on it."""
    W, sigma, _, hist = fit_async(port_cfg, port_problem.train, options=AsyncOptions(),
                                  device="cpu")
    np.testing.assert_allclose(W.numpy(), np.asarray(jax_ref.W), atol=TOL_W)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(jax_ref.sigma), atol=TOL_SIGMA)
    assert hist["w_staleness"].max() == 0
    assert get_engine("distributed").name == "distributed"
    est = DMTRLEstimator(engine="distributed", config=port_cfg, device="cpu")
    est.fit(port_problem.train)
    np.testing.assert_allclose(est.W_.numpy(), np.asarray(jax_ref.W), atol=TOL_W)


def test_simulated_protocol_methods_drive_one_w_step(port_problem):
    """gate/snapshot/commit on the simulated transport are real protocol
    methods: one W-step driven one worker at a time equals the reference
    engine on a fixed-Sigma regularizer."""
    from repro_torch.core import fit as fit_reference, local_mesh

    cfg = DMTRLConfig(loss="hinge", lam=1e-3, outer_iters=1, rounds=3, local_iters=32,
                      solver="block_gram", block_size=32, seed=0,
                      omega_regularizer="identity_stl")
    data = port_problem.train
    reg = treg.get_regularizer("identity_stl")
    t = get_transport("simulated").factory()
    t.setup(cfg, data, mesh=local_mesh(device="cpu"), axes=None, reg=reg, init=None,
            track=False)
    rho = _rho_value(cfg, t.rho_sigma(), reg=reg)
    solve = make_block_solver(cfg, t.data.n_max, rho)
    _, outer_key = prng.split(prng.PRNGKey(cfg.seed))
    round_keys = prng.split(outer_key, cfg.rounds)
    tids = torch.arange(t.m)
    for r in range(cfg.rounds):
        assert t.gate(0, r)
        snap = t.snapshot(0)
        delta = solve(t.data.x, t.data.y, snap.alpha_rows, snap.W_rows, t.data.n,
                      snap.sigma_rows, tids, round_keys[r])
        receipt = t.commit(0, r, delta)
        assert (receipt.worker, receipt.round, receipt.staleness, receipt.lag) == (0, r, 0, 0)
        assert receipt.version == r + 1
    W, _, _, hist = t.result()
    ref = fit_reference(cfg, data, regularizer=reg, device="cpu")
    np.testing.assert_allclose(W.numpy(), ref.W.numpy(), atol=TOL_W)
    assert cv.staleness_summary(hist)["n_commits"] == cfg.rounds


def test_threaded_matches_simulated_at_tau0(port_problem, port_cfg):
    """Transport parity (simulated against threaded, 1 worker): the same
    final (W, Sigma) at tau = 0."""
    W1, s1, _, _ = fit_async(port_cfg, port_problem.train, device="cpu")
    W2, s2, _, _ = _fit(port_cfg, port_problem.train, "threaded", 1)
    np.testing.assert_allclose(W1.numpy(), W2.numpy(), atol=TOL_W)
    np.testing.assert_allclose(s1.numpy(), s2.numpy(), atol=TOL_SIGMA)


def test_simulated_setup_checks(port_problem, port_cfg):
    from repro_torch.core import local_mesh

    mesh = local_mesh(device="cpu")
    for opts, match in ((AsyncOptions(codec="int8"), "codec"),
                        (AsyncOptions(topology="ring"), "topology"),
                        (AsyncOptions(n_workers=2), "n_workers")):
        with pytest.raises(ValueError, match=match):
            fit_async(port_cfg, port_problem.train, mesh, options=opts)
    with pytest.raises(ValueError, match="needs a mesh"):
        get_transport("simulated").factory().setup(
            port_cfg, port_problem.train, mesh=None, axes=None, reg=None, init=None,
            track=False, device="cpu")


def test_adapt_tau_budget_transitions():
    slack = {"max_lag": 0.0, "mean_staleness": 0.0}
    hot = {"max_lag": 3.0, "mean_staleness": 2.5}
    for args in [(3, 5, hot, 8, 1.0), (0, 5, hot, 8, 1.0), (3, 2, slack, 8, 1.0),
                 (8, 2, slack, 8, 1.0), (3, 0, slack, 8, 1.0),
                 (3, 0, {"max_lag": 3.0, "mean_staleness": 1.0}, 8, 1.0),
                 (3, 0, {"max_lag": 3.0}, 8, None), (3, 0, {"max_lag": 0.0}, 8, None),
                 (3, 1, {"max_lag": 3.0}, 8, None)]:
        assert _adapt_tau(*args) == jtransport._adapt_tau(*args)
    assert [_adapt_tau(3, 5, hot, 8, 1.0), _adapt_tau(3, 2, slack, 8, 1.0),
            _adapt_tau(3, 0, slack, 8, 1.0)] == [2, 4, 2]


# ---------------------------------------------------------------------------
# parity at tau = 0
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_workers", [1, 2, 4])
def test_threaded_tau0_matches_jax_reference(port_problem, port_cfg, jax_ref, n_workers):
    W, sigma, state, hist = _fit(port_cfg, port_problem.train, "threaded", n_workers)
    np.testing.assert_allclose(W.numpy(), np.asarray(jax_ref.W), atol=TOL_W)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(jax_ref.sigma), atol=TOL_SIGMA)
    np.testing.assert_allclose(state.alpha.numpy(), np.asarray(jax_ref.alpha), atol=TOL_W)
    assert hist["w_lag"].max() == 0
    total = port_cfg.outer_iters * port_cfg.rounds * n_workers
    assert len(hist["w_worker"]) == total
    s = cv.staleness_summary(hist)
    assert s["n_commits"] == total and s["max_lag"] == 0.0


@pytest.fixture(scope="module")
def threaded2(port_problem, port_cfg):
    return _fit(port_cfg, port_problem.train, "threaded", 2)


@pytest.mark.parametrize("codec", ["none", "int8"])
def test_multiprocess_matches_threaded(port_problem, port_cfg, threaded2, codec):
    """Two worker processes (fresh interpreters that import only the port)
    over the loopback socket; under int8 the worker keeps its alpha mirror
    and ships error-feedback-encoded commits."""
    W, sigma, _, hist = _fit(port_cfg, port_problem.train, "multiprocess", 2, codec=codec)
    Wt, st, _, ht = threaded2
    if codec == "none":
        np.testing.assert_allclose(W.numpy(), Wt.numpy(), atol=TOL_W)
        np.testing.assert_allclose(sigma.numpy(), st.numpy(), atol=TOL_SIGMA)
    else:  # the JAX test's bound for the socket path under int8
        assert np.abs(W.numpy() - Wt.numpy()).max() <= 5e-2
        gap = abs(float(hist["primal"][-1]) - float(ht["primal"][-1]))
        assert gap <= 2e-2 * max(1.0, abs(float(ht["primal"][-1])))
    assert hist["w_lag"].max() == 0
    assert len(hist["w_worker"]) == port_cfg.outer_iters * port_cfg.rounds * 2


# ---------------------------------------------------------------------------
# staleness under stragglers
# ---------------------------------------------------------------------------
def test_threaded_ssp_gate_correct_under_stragglers(port_problem, port_cfg):
    sync_gap = None
    for tau in (0, 1):
        W, sigma, state, hist = _fit(port_cfg, port_problem.train, "threaded", 4,
                                     tau=tau, async_delays=(1, 1, 1, 4))
        assert hist["w_lag"].max() <= tau
        if tau == 0:
            sync_gap = abs(float(hist["gap"][-1]))
        else:
            assert hist["w_staleness"].max() >= 1
            assert float(hist["gap"][-1]) <= 2.0 * sync_gap + 1e-9
        # dual blocks only move where tasks have real samples
        alpha = state.alpha.numpy()[: port_problem.train.m]
        mask = port_problem.train.mask.numpy()
        assert np.all(alpha[mask == 0.0] == 0.0)
        assert all(np.any(alpha[i][mask[i] == 1.0] != 0.0)
                   for i in range(port_problem.train.m))


def test_snapshot_serves_the_workers_own_writes(port_problem, port_cfg):
    """A worker running ahead at tau = 1 reads the frozen boundary plus its
    own commits since (read-your-writes); the other worker reads the
    boundary alone until the floor advances. (The JAX host servers serve
    the boundary alone; at tau = 0 both read the same.)"""
    cfg = AsyncOptions(transport="threaded", n_workers=2, tau=1).merge_into(port_cfg)
    t, reg = _setup(cfg, port_problem.train)
    try:
        solve = make_block_solver(cfg, t.data.n_max, _rho_value(cfg, t.rho_sigma(), reg=reg))
        rows0, rows1 = t._rows(0), t._rows(1)
        data = t.data
        W_b = t._boundary[0]
        s0 = t.snapshot(0)
        dalpha, db = solve(data.x[rows0], data.y[rows0], s0.alpha_rows, s0.W_rows,
                           data.n[rows0], s0.sigma_rows, torch.arange(0, 2),
                           prng.PRNGKey(3))
        t.commit(0, 0, (dalpha, db))
        assert t.gate(0, 1)  # one round ahead of worker 1
        s1 = t.snapshot(0)
        assert s1.version == s0.version  # the same boundary ...
        torch.testing.assert_close(s1.W_rows, t.W[rows0], rtol=0, atol=1e-6)
        assert not torch.equal(s1.W_rows, W_b[rows0])  # ... plus its own commit
        assert torch.equal(s1.alpha_rows, t.alpha[rows0])
        assert torch.equal(t.snapshot(1).W_rows, W_b[rows1])  # worker 1: the boundary
        s1_dalpha, s1_db = solve(data.x[rows1], data.y[rows1], t.alpha[rows1], W_b[rows1],
                                 data.n[rows1], t.sigma[rows1], torch.arange(2, 4),
                                 prng.PRNGKey(3))
        t.commit(1, 0, (s1_dalpha, s1_db))  # the floor advances: a new boundary
        assert torch.equal(t.snapshot(0).W_rows, t.W[rows0])
    finally:
        t.close()


@pytest.mark.parametrize("tau", [0, 2])
def test_threaded_server_loses_no_update_under_contention(tau):
    """Twelve worker threads (one task each, more than the cores) with the interpreter switching
    threads every 10 us: after a W-step the served W still equals W(alpha)
    under Sigma (a lost W or alpha update breaks it), every commit landed
    once, and no worker ran more than tau rounds ahead."""
    import sys

    from repro_torch.core import dual as dm

    data = synthetic(1, m=12, d=12, n_train_avg=30, n_test_avg=5, seed=5).train
    cfg = DMTRLConfig(loss="hinge", lam=1e-2, outer_iters=1, rounds=4, local_iters=16,
                      solver="block_gram", block_size=16, n_workers=12, tau=tau,
                      transport="threaded")
    t, reg = _setup(cfg, data, track=True)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        t.run_w_step(0, _rho_value(cfg, t.rho_sigma(), reg=reg), prng.PRNGKey(4))
    finally:
        sys.setswitchinterval(switch)
        t.close()
    hist = {k: np.asarray(v) for k, v in t.hist.items()}
    assert len(hist["w_worker"]) == t.commits_total == 12 * cfg.rounds
    assert np.bincount(hist["w_worker"]).tolist() == [cfg.rounds] * 12
    assert hist["w_lag"].max() <= tau
    W_alpha = dm.weights_from_alpha(t.data, t.alpha, t.sigma, cfg.lam)
    torch.testing.assert_close(t.W, W_alpha, rtol=1e-4, atol=1e-5)


def test_threaded_omega_overlap_installs(port_problem, port_cfg):
    cfg = dataclasses.replace(port_cfg, outer_iters=3)
    W, sigma, _, hist = _fit(cfg, port_problem.train, "threaded", 2,
                             tau=1, omega_delay=2, async_delays=(1, 2))
    assert float(torch.trace(sigma)) == pytest.approx(1.0, abs=1e-4)
    assert hist["gap"][-1] < hist["gap"][0]


def test_staleness_budget_zero_pins_tau_auto_at_zero(port_problem, port_cfg):
    cfg = dataclasses.replace(port_cfg, outer_iters=2)
    _, _, _, hist = _fit(cfg, port_problem.train, "threaded", 4, tau="auto",
                         async_delays=(1, 1, 1, 4), staleness_budget=0.0)
    assert hist["tau_trace"].max() == 0


def test_tau_auto_widens_without_budget(port_problem, port_cfg):
    cfg = dataclasses.replace(port_cfg, outer_iters=2)
    _, _, _, hist = _fit(cfg, port_problem.train, "threaded", 4, tau="auto",
                         async_delays=(1, 1, 1, 4))
    assert hist["tau_trace"][0] == 0
    assert hist["tau_trace"].max() >= 1
    assert hist["gate_refusals"][-1] >= 1


# ---------------------------------------------------------------------------
# wire codecs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("codec", ["bf16", "int8"])
def test_threaded_codec_objective_gap(small_problem, small_cfg, port_problem, port_cfg,
                                      threaded2, codec):
    """The JAX test's bound on the lossy run against the exact one, and the
    same bound against the JAX threaded transport under the same codec."""
    _, _, _, h_exact = threaded2
    _, _, _, h_codec = _fit(port_cfg, port_problem.train, "threaded", 2, codec=codec)
    _, _, _, h_jax = jfit_async(
        small_cfg, small_problem.train, None, JMeshAxes(data="data"),
        options=JAsyncOptions(transport="threaded", n_workers=2, codec=codec),
    )
    bound = {"bf16": 5e-3, "int8": 2e-2}[codec]
    ref = max(1.0, abs(float(h_exact["primal"][-1])))
    assert abs(float(h_codec["primal"][-1]) - float(h_exact["primal"][-1])) <= bound * ref
    assert abs(float(h_codec["primal"][-1]) - float(h_jax["primal"][-1])) <= bound * ref


def test_payload_nbytes_equal_jax(small_problem, small_cfg, port_problem, port_cfg):
    cfg = dataclasses.replace(port_cfg, n_workers=2, transport="threaded")
    t, _ = _setup(cfg, port_problem.train)
    jcfg = dataclasses.replace(small_cfg, n_workers=2, transport="threaded")
    jt = jtransport.get_transport("threaded").factory()
    jt.setup(jcfg, small_problem.train, mesh=None, axes=None,
             reg=jreg.resolve_regularizer(jcfg, None), init=None, track=False)
    try:
        snap, jsnap = t.snapshot(0), jt.snapshot(0)
        raw = payload_nbytes(snap)
        assert raw == jtransport.payload_nbytes(jsnap)
        sizes = {c: payload_nbytes(snap, c) for c in ("bf16", "int8")}
        assert sizes == {c: jtransport.payload_nbytes(jsnap, c) for c in ("bf16", "int8")}
        assert raw > sizes["bf16"] > sizes["int8"]
    finally:
        t.close()
        jt.close()


def test_threaded_wire_stats_alpha_elision(port_problem, port_cfg):
    """Under a lossy codec alpha ships once per worker, so the aggregate
    compressed wire beats 4x on the fixture."""
    cfg = AsyncOptions(transport="threaded", n_workers=2, codec="int8").merge_into(port_cfg)
    t, reg = _setup(cfg, port_problem.train)
    try:
        _drive(t, cfg, reg)
        s = t.wire_stats
        assert s["codec"] == "int8" and s["n_snapshots"] == s["n_commits"] == 12
        shipped = s["snapshot_bytes"] + s["commit_bytes"]
        raw = s["raw_snapshot_bytes"] + s["raw_commit_bytes"]
        assert raw / shipped >= 4.0
    finally:
        t.close()


# ---------------------------------------------------------------------------
# model subscribers
# ---------------------------------------------------------------------------
def test_raising_subscriber_is_isolated_and_dropped(port_problem, port_cfg, caplog):
    cfg = dataclasses.replace(port_cfg, n_workers=1, transport="threaded")
    t, _ = _setup(cfg, port_problem.train)
    try:
        m = port_problem.train.m
        seen = []

        def broken_router(W, sigma, version):
            raise RuntimeError("router exploded")

        t.subscribe(broken_router)
        t.subscribe(lambda W, s, v: seen.append(v))
        sig, om = torch.eye(m) / m, torch.eye(m) * m
        with caplog.at_level(logging.ERROR, logger="repro_torch.core.transport"):
            t.install_sigma(sig, om, defer=False)  # must NOT raise
        assert seen == [1]
        assert any("dropping it" in r.message for r in caplog.records)
        caplog.clear()
        t.install_sigma(sig, om, defer=False)
        assert seen == [1, 2] and not caplog.records
        assert not t.unsubscribe(broken_router)
    finally:
        t.close()


def test_raising_subscriber_does_not_break_the_fit(port_problem, port_cfg, threaded2):
    cfg = AsyncOptions(transport="threaded", n_workers=2).merge_into(port_cfg)
    t, reg = _setup(cfg, port_problem.train, track=True)
    try:
        t.subscribe(lambda *a: (_ for _ in ()).throw(RuntimeError("boom")))
        _drive(t, cfg, reg)
        W, _, _, _ = t.result()
    finally:
        t.close()
    np.testing.assert_allclose(W.numpy(), threaded2[0].numpy(), atol=5e-5)


def test_scheduler_subscribed_to_the_server(port_problem, port_cfg):
    """transport.subscribe(scheduler.publish_weights): every Sigma install
    reaches the served snapshot as a copy of the server's W."""
    cfg = AsyncOptions(transport="threaded", n_workers=2).merge_into(port_cfg)
    t, reg = _setup(cfg, port_problem.train)
    m, d = port_problem.train.m, port_problem.train.d
    engine = MTLScoringEngine(np.zeros((m, d), np.float32), batch=4, device="cpu")
    sched = ContinuousBatchingScheduler(engine, clock=VirtualClock())
    try:
        t.subscribe(sched.publish_weights)
        _drive(t, cfg, reg)
        W, _, _, _ = t.result()
    finally:
        t.close()
    assert sched.version == port_cfg.outer_iters
    served = sched.snapshot.W
    assert torch.equal(served, W) and served.data_ptr() != W.data_ptr()


# ---------------------------------------------------------------------------
# the estimator facade
# ---------------------------------------------------------------------------
def test_estimator_routes_transport_and_rejects_core_kwarg(port_problem):
    with pytest.raises(ValueError, match="per-engine options"):
        DMTRLEstimator(engine="async", transport="threaded", device="cpu")
    with pytest.raises(ValueError, match="per-engine options"):
        DMTRLEstimator(engine="reference", staleness_budget=1.0, device="cpu")
    with pytest.raises(ValueError, match='engine="async"'):
        DMTRLEstimator(engine="reference", async_options=AsyncOptions(), device="cpu")
    with pytest.raises(TypeError, match="AsyncOptions"):
        DMTRLEstimator(engine="async", async_options={"tau": 0}, device="cpu")
    est = DMTRLEstimator(
        engine="async", async_options=AsyncOptions(transport="threaded", n_workers=2),
        loss="hinge", lam=1e-3, outer_iters=1, rounds=2, local_iters=32,
        solver="block_gram", block_size=32, seed=0, device="cpu",
    ).fit(port_problem.train)
    assert est.score(port_problem.test) > 0.0
    assert len(est.history["w_worker"]) == 2 * 2  # rounds x workers
    pred = est.predict(port_problem.test.x[1, :3], tasks=1)
    direct = torch.where(port_problem.test.x[1, :3] @ est.W_[1] >= 0, 1.0, -1.0)
    assert torch.equal(pred, direct)


def test_threaded_warm_start_partial_fit(port_problem):
    est = DMTRLEstimator(
        engine="async", async_options=AsyncOptions(transport="threaded", n_workers=2),
        loss="hinge", lam=1e-3, outer_iters=1, rounds=3, local_iters=32,
        solver="block_gram", block_size=32, seed=0, device="cpu",
    )
    est.partial_fit(port_problem.train)
    gap0 = est.history["gap"][-1]
    n0 = len(est.history["round"])
    est.partial_fit(port_problem.train)
    assert len(est.history["round"]) == 2 * n0
    assert est.history["round"][n0] > est.history["round"][n0 - 1]
    assert est.history["gap"][-1] <= gap0 + 1e-6
    assert est.alpha_.shape == tuple(port_problem.train.y.shape)


@pytest.mark.parametrize("engine", ["threaded", "mesh", "mesh_gram", "mesh_gram_hoisted"])
def test_engines_draw_the_reference_rounds_coordinates(port_problem, engine):
    """For one round key, the worker half of every other engine returns the
    dalpha of ``make_w_step_round``'s solver bit for bit: the threaded
    transport's ``make_block_solver`` over two task blocks, and the
    one-device mesh engine's ``make_local_solve`` without a ``model`` axis
    and with one (the Gram path: the full H x H Gram over one block, and
    the block Gram per H-block). All draw through ``draw_task_uniform``."""
    from repro_torch.core.distributed import MeshAxes, make_local_solve, make_mesh
    from repro_torch.core.dmtrl import make_w_step_round

    data = port_problem.train
    m, n_max, d = data.x.shape
    # the full Gram equals the block Gram bit for bit over a single block
    block = 64 if engine == "mesh_gram" else 32
    cfg = DMTRLConfig(loss="hinge", lam=1e-3, eta=0.75, local_iters=64,
                      solver="block_gram", block_size=block,
                      dist_block_hoisted=engine == "mesh_gram_hoisted")
    rs = np.random.RandomState(7)
    alpha = torch.from_numpy((0.1 * rs.rand(m, n_max)).astype(np.float32)) * data.mask
    W = torch.from_numpy((0.05 * rs.randn(m, d)).astype(np.float32))
    a = rs.randn(m, m).astype(np.float32)
    sigma = torch.from_numpy((a @ a.T / m + np.eye(m)).astype(np.float32) / m)
    key, rho = prng.split(prng.PRNGKey(5), 4)[2], 1.3
    want, _ = make_w_step_round(cfg, data, rho)(alpha, W, sigma, key)
    if engine == "threaded":
        solve = make_block_solver(cfg, n_max, rho)
        dalpha = torch.cat([
            solve(data.x[b], data.y[b], alpha[b], W[b], data.n[b], sigma[b],
                  torch.arange(b.start, b.stop), key)[0]
            for b in (slice(0, 2), slice(2, m))
        ])
    else:
        axes = MeshAxes(model=None if engine == "mesh" else "model")
        names = ("data",) if axes.model is None else ("data", "model")
        mesh = make_mesh((1,) * len(names), names, device="cpu")
        local_solve = make_local_solve(cfg, mesh, axes, m, n_max, d, rho)
        dalpha, _ = local_solve(data.x, data.y, data.n, alpha, W, sigma, key)
    assert dalpha.any()
    assert torch.equal(alpha + cfg.eta * dalpha, want)
