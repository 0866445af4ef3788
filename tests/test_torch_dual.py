"""The port's objectives, primal-dual map, duality gap and metrics against
repro.core.dual on the shared small problem with random feasible duals."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dual as jd
from repro.core import omega as jom
from repro.core.losses import get_loss as jloss
from repro_torch.core import dual as td
from repro_torch.core.losses import get_loss as tloss
from repro_torch.core.sigma_view import DenseSigma
from repro_torch.data.synthetic import synthetic

LAM = 1e-3


@pytest.fixture(scope="module")
def state(small_problem):
    port = synthetic(1, m=4, d=16, n_train_avg=40, n_test_avg=10, seed=1)
    jtr = small_problem.train
    rs = np.random.RandomState(7)
    y = np.asarray(jtr.y)
    alpha = (y * rs.uniform(0.0, 1.0, y.shape) * np.asarray(jtr.mask)).astype(np.float32)
    W0 = (0.3 * rs.randn(jtr.m, jtr.d)).astype(np.float32)
    sigma, omega = (np.array(a) for a in jom.omega_step(jnp.asarray(W0)))
    return dict(jtr=jtr, jte=small_problem.test, ttr=port.train, tte=port.test,
                alpha=alpha, sigma=sigma, omega=omega, W=W0)


def _close(t, j, tol=1e-5):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=tol, atol=tol)


def test_compute_B_and_weights(state):
    a, s = state["alpha"], state["sigma"]
    _close(td.compute_B(state["ttr"], torch.from_numpy(a)), jd.compute_B(state["jtr"], jnp.asarray(a)))
    Wj = jd.weights_from_alpha(state["jtr"], jnp.asarray(a), jnp.asarray(s), LAM)
    Wt = td.weights_from_alpha(state["ttr"], torch.from_numpy(a), torch.from_numpy(s), LAM)
    _close(Wt, Wj, 1e-4)
    Wv = td.weights_from_alpha(state["ttr"], torch.from_numpy(a), DenseSigma(torch.from_numpy(s)), LAM)
    _close(Wv, Wj, 1e-4)


@pytest.mark.parametrize("view", [False, True])
def test_quad_term(state, view):
    s = torch.from_numpy(state["sigma"])
    got = td.quad_term(state["ttr"], torch.from_numpy(state["alpha"]), DenseSigma(s) if view else s)
    ref = jd.quad_term(state["jtr"], jnp.asarray(state["alpha"]), jnp.asarray(state["sigma"]))
    assert float(got) == pytest.approx(float(ref), rel=1e-5)


@pytest.mark.parametrize("loss_name", ["hinge", "smoothed_hinge", "squared"])
def test_objectives_and_gap(state, loss_name):
    a, s = state["alpha"], state["sigma"]
    ja, js = jnp.asarray(a), jnp.asarray(s)
    ta, ts = torch.from_numpy(a), torch.from_numpy(s)
    jl, tl = jloss(loss_name), tloss(loss_name)
    for name in ("dual_objective", "primal_objective_from_alpha", "duality_gap"):
        got = getattr(td, name)(state["ttr"], ta, ts, LAM, tl)
        ref = getattr(jd, name)(state["jtr"], ja, js, LAM, jl)
        assert float(got) == pytest.approx(float(ref), rel=1e-5, abs=1e-5), name
    W, om = state["W"], state["omega"]
    got = td.primal_objective(state["ttr"], torch.from_numpy(W), torch.from_numpy(om), LAM, tl)
    ref = jd.primal_objective(state["jtr"], jnp.asarray(W), jnp.asarray(om), LAM, jl)
    assert float(got) == pytest.approx(float(ref), rel=1e-5)
    assert float(td.duality_gap(state["ttr"], ta, ts, LAM, tl)) >= -1e-5


def test_scores_and_metrics(state):
    W = state["W"]
    Wj, Wt = jnp.asarray(W), torch.from_numpy(W)
    _close(td.predictions(state["tte"], Wt), jd.predictions(state["jte"], Wj))
    X = np.asarray(state["jte"].x[1, :6])
    tasks = np.array([0, 1, 1, 3, 2, 0])
    _close(td.task_scores(Wt, torch.from_numpy(X.copy()), torch.from_numpy(tasks)),
           jd.task_scores(Wj, jnp.asarray(X), jnp.asarray(tasks)))
    for name in ("error_rate", "rmse", "explained_variance"):
        got = getattr(td, name)(state["tte"], Wt)
        ref = getattr(jd, name)(state["jte"], Wj)
        assert float(got) == pytest.approx(float(ref), rel=1e-5, abs=1e-6), name


@pytest.mark.parametrize("loss_name", ["hinge", "smoothed_hinge", "squared"])
@pytest.mark.parametrize("i", [0, 3])
def test_local_subproblem_objectives(state, loss_name, i):
    """D_i^rho of Eq. (4), without and with its constant term, at a random
    dalpha that keeps alpha + dalpha feasible: 1e-5 as the objectives."""
    a, s, W = state["alpha"], state["sigma"], state["W"]
    rs = np.random.RandomState(11 + i)
    y, mask = np.asarray(state["jtr"].y[i]), np.asarray(state["jtr"].mask[i])
    da = (0.3 * y * rs.uniform(0, 1, y.shape) * mask - 0.3 * a[i]).astype(np.float32)
    if loss_name == "squared":
        da = (0.5 * rs.randn(*y.shape) * mask).astype(np.float32)
    rho = 1.7
    jl, tl = jloss(loss_name), tloss(loss_name)
    got = td.local_subproblem_objective(
        state["ttr"], i, torch.from_numpy(da), torch.from_numpy(a), torch.from_numpy(W[i]),
        torch.tensor(s[i, i]), rho, LAM, tl, 4)
    ref = jd.local_subproblem_objective(
        state["jtr"], i, jnp.asarray(da), jnp.asarray(a), jnp.asarray(W[i]),
        jnp.asarray(s[i, i]), rho, LAM, jl, 4)
    assert np.isfinite(float(ref))
    assert float(got) == pytest.approx(float(ref), rel=1e-5, abs=1e-5)
    got = td.local_subproblem_objective_full(
        state["ttr"], i, torch.from_numpy(da), torch.from_numpy(a), torch.from_numpy(W[i]),
        torch.from_numpy(s), rho, LAM, tl)
    ref = jd.local_subproblem_objective_full(
        state["jtr"], i, jnp.asarray(da), jnp.asarray(a), jnp.asarray(W[i]),
        jnp.asarray(s), rho, LAM, jl)
    assert float(got) == pytest.approx(float(ref), rel=1e-5, abs=1e-5)
