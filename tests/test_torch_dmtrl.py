"""The port's Algorithm-1 driver against the JAX package's, on the shared
small problem (tests/conftest.py's small_problem / small_cfg): W within
atol 2e-4, Sigma within 1e-5 (tests/test_distributed.py's bars), and the
gap histories agree. Both packages build the problem from one seed."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import dmtrl as jdmtrl
from repro_torch.core import DMTRLConfig, fit
from repro_torch.core import dual as dual_mod
from repro_torch.data.synthetic import synthetic
from repro_torch.kernels.nvcc import check_tensor
from repro_torch.kernels.sdca import ops, ref

SOLVERS = ("block_gram", "pallas_round")


@pytest.fixture(scope="module")
def port_problem():
    return synthetic(1, m=4, d=16, n_train_avg=40, n_test_avg=10, seed=1)


def _port_cfg(jax_cfg, **kw):
    return DMTRLConfig(**{**dataclasses.asdict(jax_cfg), **kw})


@pytest.fixture(scope="module")
def fits(small_problem, small_cfg, port_problem):
    out = {}
    for solver in SOLVERS:
        jcfg = dataclasses.replace(small_cfg, solver=solver)
        out[solver] = (
            jdmtrl.fit(jcfg, small_problem.train),
            fit(_port_cfg(jcfg), port_problem.train, device="cpu"),
        )
    return out


def test_synthetic_problems_are_identical(small_problem, port_problem):
    for split in ("train", "test"):
        j, t = getattr(small_problem, split), getattr(port_problem, split)
        for f in ("x", "y", "mask", "n"):
            assert np.array_equal(np.asarray(getattr(j, f)), getattr(t, f).numpy()), f
    assert np.array_equal(small_problem.W_true, port_problem.W_true)


@pytest.mark.parametrize("solver", SOLVERS)
def test_fit_matches_jax(fits, solver):
    rj, rt = fits[solver]
    np.testing.assert_allclose(rt.W.numpy(), np.asarray(rj.W), atol=2e-4)
    np.testing.assert_allclose(rt.sigma.numpy(), np.asarray(rj.sigma), atol=1e-5)
    np.testing.assert_allclose(rt.alpha.numpy(), np.asarray(rj.alpha), atol=2e-4)
    np.testing.assert_allclose(rt.rho_per_outer, rj.rho_per_outer, rtol=1e-5)


@pytest.mark.parametrize("solver", SOLVERS)
def test_gap_histories_agree(fits, solver):
    rj, rt = fits[solver]
    assert set(rt.history) == set(rj.history)
    for k in ("round", "outer"):
        np.testing.assert_array_equal(rt.history[k], rj.history[k])
    for k in ("dual", "primal", "gap"):
        np.testing.assert_allclose(rt.history[k], rj.history[k], atol=1e-5, rtol=1e-5)
    gaps = rt.history["gap"]
    assert np.all(np.isfinite(gaps)) and gaps[-1] < gaps[0]


def test_w_alpha_invariant_and_trace(fits, port_problem, small_cfg):
    _, rt = fits["block_gram"]
    W2 = dual_mod.weights_from_alpha(port_problem.train, rt.alpha, rt.sigma, small_cfg.lam)
    torch.testing.assert_close(rt.W, W2, atol=1e-4, rtol=0)
    assert float(torch.trace(rt.sigma)) == pytest.approx(1.0, abs=1e-5)
    assert float(torch.linalg.eigvalsh(rt.sigma).min()) > 0


def test_config_fields_and_defaults_match_jax():
    jf = {f.name: f.default for f in dataclasses.fields(jdmtrl.DMTRLConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(DMTRLConfig)}
    assert jf == tf


@pytest.mark.parametrize("bad", [dict(omega_regularizer="nope"),
                                 dict(omega_regularizer="low_rank")])
def test_config_validation(bad):
    with pytest.raises(ValueError, match="unknown omega_regularizer"):
        DMTRLConfig(**bad)


@pytest.mark.parametrize("name", ["graph_laplacian", "frobenius_shrunk", "low_rank_diag",
                                  "graphical_lasso"])
def test_config_names_every_member_jax_names(name):
    assert DMTRLConfig(omega_regularizer=name).omega_regularizer == \
        jdmtrl.DMTRLConfig(omega_regularizer=name).omega_regularizer


@pytest.mark.parametrize("fields", [
    dict(tau=2, tau_max=4, codec="int8", async_delays=(1, 3)),
    dict(tau="auto", staleness_budget=0.5, transport="threaded", n_workers=4),
    dict(topology="ring", omega_delay=1, gram_bf16=True, dist_block_hoisted=True),
])
def test_jax_config_carries_over(fields):
    """A JAX config with the knobs of engines not ported yet builds the same
    port config, field for field."""
    jcfg = jdmtrl.DMTRLConfig(**fields)
    tcfg = DMTRLConfig(**dataclasses.asdict(jcfg))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)


def test_fit_default_device_needs_a_card(port_problem):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fit(DMTRLConfig(outer_iters=1, rounds=1), port_problem.train)


def test_warm_start_continues(small_cfg, port_problem):
    from repro_torch.core import WarmStart

    cfg = _port_cfg(small_cfg)
    first = fit(cfg, port_problem.train, device="cpu")
    again = fit(cfg, port_problem.train, device="cpu",
                init=WarmStart(first.alpha, first.sigma, first.omega))
    assert again.history["gap"][-1] < first.history["gap"][0]


@pytest.mark.parametrize("solver", ["pallas_round", "pallas_block"])
def test_fit_feeds_kernels_their_contract(monkeypatch, small_cfg, port_problem, solver):
    """Route the kernel backends as on a card, with stand-ins that enforce
    the CUDA wrappers' argument checks (dtype, shape, contiguity) and then
    run the plain versions: a fit must satisfy them every round."""
    calls = {"round": 0, "block": 0}

    def check_all(names, tensors, shapes, dtypes):
        for name, t, shape, dt in zip(names, tensors, shapes, dtypes):
            check_tensor(name, t, shape, dt, t.device)

    def fake_round(x, y, alpha, w, u, n, kappa, loss, block=64):
        m, n_max, d = x.shape
        H = u.shape[1]
        f32 = torch.float32
        check_all("x y alpha w u n kappa".split(), (x, y, alpha, w, u, n, kappa),
                  [(m, n_max, d), (m, n_max), (m, n_max), (m, d), (m, H), (m,), (m,)],
                  [f32] * 5 + [torch.int32, f32])
        calls["round"] += 1
        return ref.sdca_round_ref(x, y, alpha, w, u, n, kappa, loss)

    def fake_block(xb, w, r, at0, y, cb, kappa, loss):
        m, B, d = xb.shape
        f32 = torch.float32
        check_all("xb w r at0 y cb kappa".split(), (xb, w, r, at0, y, cb, kappa),
                  [(m, B, d), (m, d), (m, d), (m, B), (m, B), (m, B), (m,)],
                  [f32] * 5 + [torch.int32, f32])
        calls["block"] += 1
        return ref.sdca_block_ref(xb, w, r, at0, y, cb, kappa, loss)

    monkeypatch.setattr(ops, "_use_kernel", lambda loss, t: True)
    monkeypatch.setattr(ops, "sdca_round_kernel", fake_round)
    monkeypatch.setattr(ops, "sdca_block_kernel", fake_block)
    cfg = _port_cfg(small_cfg, solver=solver)
    res = fit(cfg, port_problem.train, device="cpu")
    rounds = cfg.outer_iters * cfg.rounds
    if solver == "pallas_round":
        assert calls == {"round": rounds, "block": 0}
    else:
        assert calls == {"round": 0, "block": rounds * cfg.local_iters // cfg.block_size}
    assert np.all(np.isfinite(res.history["gap"]))


@pytest.mark.parametrize("engine", ["reference", "distributed", "async"])
def test_fit_with_an_empty_task_stays_finite(engine):
    """A task with no rows: every engine divides its delta_b, B column and
    objective terms by max(n_i, 1), so the fit ends with a finite W and a
    finite gap, and that task's alpha stays zero. (The JAX
    package divides 0 by 0 there, and its Omega-step refuses the W.)"""
    from repro_torch.core import AsyncOptions, DMTRLEstimator
    from repro_torch.core.mtl_data import from_task_list

    rs = np.random.RandomState(0)
    xs = [rs.randn(20, 8).astype(np.float32), np.zeros((0, 8), np.float32),
          rs.randn(13, 8).astype(np.float32)]
    ys = [np.sign(rs.randn(20)), np.zeros(0), np.sign(rs.randn(13))]
    opts = dict(async_options=AsyncOptions(transport="threaded")) if engine == "async" else {}
    est = DMTRLEstimator(engine=engine, device="cpu", outer_iters=2, rounds=2,
                         solver="block_gram", block_size=16, **opts)
    est.fit(from_task_list(xs, ys))
    assert bool(torch.isfinite(est.W_).all())
    assert not est.alpha_[1].any() and est.alpha_[0].any() and est.alpha_[2].any()
    assert np.all(np.isfinite(est.history_["gap"]))
