"""The port's DMTRLEstimator against the JAX package's on the shared small
problem, and carrying a fitted JAX model across with
repro_torch.convert.from_reference."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import DMTRLEstimator as JaxEstimator
from repro_torch.convert import STATE_KEYS, from_reference
from repro_torch.core import DMTRLConfig, DMTRLEstimator, NotFittedError, get_engine
from repro_torch.data.synthetic import synthetic


@pytest.fixture(scope="module")
def port_problem():
    return synthetic(1, m=4, d=16, n_train_avg=40, n_test_avg=10, seed=1)


@pytest.fixture(scope="module")
def cfgs(small_cfg):
    return small_cfg, DMTRLConfig(**dataclasses.asdict(small_cfg))


@pytest.fixture(scope="module")
def pair(small_problem, port_problem, cfgs):
    """(JAX estimator, port estimator) after fit then partial_fit, with
    the state after fit kept aside."""
    jcfg, tcfg = cfgs
    je = JaxEstimator(engine="reference", config=jcfg).fit(small_problem.train)
    te = DMTRLEstimator(config=tcfg, device="cpu").fit(port_problem.train)
    after_fit = {k: np.array(getattr(je, k))
                 if k not in ("history_", "rho_per_outer_", "sigma_view_")
                 else getattr(je, k) for k in STATE_KEYS}
    W_fit = (np.asarray(je.W_).copy(), te.W_.clone())
    je.partial_fit(small_problem.train)
    te.partial_fit(port_problem.train)
    return je, te, after_fit, W_fit


def test_fit_matches_jax(pair):
    _, _, _, (Wj, Wt) = pair
    np.testing.assert_allclose(Wt.numpy(), Wj, atol=2e-4)


def test_partial_fit_matches_jax(pair):
    je, te, _, _ = pair
    np.testing.assert_allclose(te.W_.numpy(), np.asarray(je.W_), atol=2e-4)
    np.testing.assert_allclose(te.sigma_.numpy(), np.asarray(je.sigma_), atol=1e-5)
    for k in ("round", "outer"):
        np.testing.assert_array_equal(te.history[k], je.history[k])
    np.testing.assert_allclose(te.history["gap"], je.history["gap"], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(te.rho_per_outer_, je.rho_per_outer_, rtol=1e-5)
    assert te.n_fit_calls_ == je.n_fit_calls_ == 2


def test_predict_and_score_match_jax(pair, small_problem, port_problem):
    je, te, _, _ = pair
    assert te.score(port_problem.test) == pytest.approx(je.score(small_problem.test), abs=1e-6)
    X = np.array(small_problem.test.x[2, :7])
    np.testing.assert_array_equal(te.predict(X, tasks=2).numpy(), je.predict(X, tasks=2))
    tasks = [0, 1, 2, 3, 0, 1, 2]
    np.testing.assert_allclose(te.decision_function(X, tasks=tasks).numpy(),
                               je.decision_function(X, tasks=tasks), atol=1e-5)
    np.testing.assert_allclose(te.decision_function(port_problem.test).numpy(),
                               je.decision_function(small_problem.test), atol=1e-5)
    snap = te.model_snapshot()
    assert snap.version == 2 and torch.equal(snap.W, te.W_)


def test_from_reference_predicts_like_jax(pair, small_problem, port_problem, cfgs):
    je, _, _, _ = pair
    state = {k: getattr(je, k) for k in STATE_KEYS}
    te = from_reference(state, device="cpu", config=cfgs[1])
    X = np.array(small_problem.test.x[1, :9])
    np.testing.assert_allclose(te.decision_function(X, tasks=1).numpy(),
                               je.decision_function(X, tasks=1), atol=1e-6)
    np.testing.assert_array_equal(te.predict(X, tasks=1).numpy(), je.predict(X, tasks=1))
    assert te.score(port_problem.test) == pytest.approx(je.score(small_problem.test), abs=1e-6)


def test_from_reference_partial_fit_continues_like_jax(pair, small_problem, port_problem, cfgs):
    """The port continues training from the JAX package's fitted state as
    the JAX package itself does."""
    je, _, after_fit, _ = pair
    te = from_reference(after_fit, device="cpu", config=cfgs[1])
    te.partial_fit(port_problem.train)
    np.testing.assert_allclose(te.W_.numpy(), np.asarray(je.W_), atol=2e-4)
    np.testing.assert_allclose(te.sigma_.numpy(), np.asarray(je.sigma_), atol=1e-5)
    np.testing.assert_allclose(te.history["gap"], je.history["gap"], atol=1e-5, rtol=1e-5)


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DMTRLEstimator()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_reference({"W_": np.zeros((2, 3)), "alpha_": np.zeros((2, 4)),
                        "sigma_": np.eye(2) / 2})


def test_engine_and_option_validation():
    with pytest.raises(NotImplementedError, match="not ported"):
        DMTRLEstimator(engine="distributed", device="cpu")
    with pytest.raises(NotImplementedError, match="not ported"):
        get_engine("async")
    with pytest.raises(KeyError, match="reference"):
        DMTRLEstimator(engine="banana", device="cpu")
    with pytest.raises(ValueError, match="per-engine options"):
        DMTRLEstimator(tau=1, device="cpu")
    with pytest.raises(ValueError, match="unknown config fields"):
        DMTRLEstimator(nope=1, device="cpu")
    with pytest.raises(NotFittedError):
        DMTRLEstimator(device="cpu").predict(np.zeros((1, 3)), tasks=0)


def test_decision_function_input_checks(pair):
    _, te, _, _ = pair
    with pytest.raises(ValueError, match="features"):
        te.decision_function(np.zeros((2, 5)), tasks=0)
    with pytest.raises(ValueError, match="tasks="):
        te.decision_function(np.zeros((2, 16)))
    with pytest.raises(ValueError, match="task ids"):
        te.decision_function(np.zeros((2, 16)), tasks=[0, 9])


def test_learn_omega_false_is_identity_stl(port_problem, cfgs):
    te = DMTRLEstimator(config=cfgs[1], learn_omega=False, device="cpu")
    assert te.regularizer.name == "identity_stl"
    te.fit(port_problem.train)
    torch.testing.assert_close(te.sigma_, torch.eye(4) / 4)


@pytest.mark.parametrize("name,params", [("low_rank_diag", {"rank": 3}),
                                         ("graphical_lasso", {"penalty": 0.5})])
def test_from_reference_carries_a_structured_fit(small_problem, port_problem, cfgs,
                                                 name, params):
    """A JAX estimator fitted with a structured member crosses over through
    its sigma_view_'s factors: the port predicts, serves the same Sigma
    rows and continues training as the JAX estimator does."""
    from repro.serve import ScoreRequest as JaxRequest
    from repro_torch.serve import ScoreRequest

    je = JaxEstimator(config=cfgs[0], regularizer=name,
                      regularizer_params=params).fit(small_problem.train)
    state = {k: getattr(je, k) for k in STATE_KEYS}
    te = from_reference(state, device="cpu", config=cfgs[1], regularizer=name,
                        regularizer_params=params)
    assert type(te.sigma_view_).__name__ == type(je.sigma_view_).__name__
    np.testing.assert_allclose(te.sigma_view_.dense().numpy(),
                               np.asarray(je.sigma_view_.dense()), atol=1e-7)
    X = np.array(small_problem.test.x[1, :9])
    np.testing.assert_allclose(te.decision_function(X, tasks=1).numpy(),
                               je.decision_function(X, tasks=1), atol=1e-6)
    tasks = [0, 3, 1, 2, 3]
    jeng = je.scoring_engine(batch=4, gather_sigma_rows=True)
    teng = te.scoring_engine(batch=4, gather_sigma_rows=True)
    np.testing.assert_allclose(teng.sigma_rows_for(tasks), jeng.sigma_rows_for(tasks), atol=1e-6)
    jreqs = [JaxRequest(task=t, x=X[k]) for k, t in enumerate(tasks)]
    treqs = [ScoreRequest(task=t, x=X[k]) for k, t in enumerate(tasks)]
    jeng.run_tile(jreqs[:4], jeng.model_snapshot())
    teng.run_tile(treqs[:4], teng.model_snapshot())
    for a, b in zip(treqs[:4], jreqs[:4]):
        assert a.score == pytest.approx(b.score, abs=1e-5)
        np.testing.assert_allclose(a.sigma_row, b.sigma_row, atol=1e-6)
    je.partial_fit(small_problem.train)
    te.partial_fit(port_problem.train)
    np.testing.assert_allclose(te.W_.numpy(), np.asarray(je.W_), atol=2e-4)
    np.testing.assert_allclose(te.sigma_.numpy(), np.asarray(je.sigma_), atol=1e-5)
    assert teng.version == 2  # the push reached the engine
