"""The port's structured members of the Omega-regularizer family
(graph_laplacian, frobenius_shrunk, low_rank_diag, graphical_lasso)
against the JAX package's: each step (or fixed init) on the same W within
1e-5 of Sigma; a full low_rank_diag fit within W 2e-4 and Sigma 1e-5 (the
fit bars of tests/test_distributed.py); PSD and trace 1 over every member
(tests/test_sigma_view.py's sweep); the non-finite guard and the one-time
dense-at-scale warning."""
import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DMTRLEstimator as JaxEstimator
from repro.core import omega_regularizers as jreg
from repro_torch.core import DMTRLConfig, DMTRLEstimator, LowRankDiagSigma, SparseSigma
from repro_torch.core import omega as tom
from repro_torch.core import omega_regularizers as treg
from repro_torch.core.sigma_view import maybe_dense
from repro_torch.data.synthetic import synthetic

MEMBERS = [
    ("graph_laplacian", {"coupling": 2.0, "eps": 1e-2}),
    ("frobenius_shrunk", {"shrinkage": 0.3}),
    ("low_rank_diag", {"rank": 3}),
    ("graphical_lasso", {"penalty": 0.5}),
    ("graphical_lasso", {"penalty": 0.0}),
    ("graphical_lasso", {"penalty": 0.2, "max_nnz": 2}),
]


def _w(m=8, d=20, seed=0):
    return (0.3 * np.random.RandomState(seed).randn(m, d)).astype(np.float32)


def _chain(m):
    A = np.zeros((m, m))
    for i in range(m - 1):
        A[i, i + 1] = A[i + 1, i] = 1.0
    return A


def _dense(sigma):
    return np.asarray(maybe_dense(sigma, limit=10_000))


def _jdense(sigma):
    from repro.core.sigma_view import maybe_dense as jmaybe

    return np.asarray(jmaybe(sigma, limit=10_000))


@pytest.mark.parametrize("name,params", MEMBERS, ids=lambda p: str(p))
def test_member_matches_jax(name, params):
    W = _w()
    if name == "graph_laplacian":
        params = dict(params, adjacency=_chain(W.shape[0]))
    jr, tr = jreg.get_regularizer(name, **params), treg.get_regularizer(name, **params)
    assert (tr.learns, tr.structured, tr.custom_init) == (jr.learns, jr.structured, jr.custom_init)
    if tr.learns:
        (js, jo), (ts, to) = jr.step(jnp.asarray(W), 1e-6), tr.step(torch.from_numpy(W), 1e-6)
    else:
        (js, jo), (ts, to) = jr.init(W.shape[0]), tr.init(W.shape[0], torch.float32, "cpu")
    if tr.structured:
        assert type(ts).__name__ == type(js).__name__
    S = _dense(ts)
    np.testing.assert_allclose(S, _jdense(js), atol=1e-5)
    assert np.trace(S) == pytest.approx(1.0, abs=1e-5)
    assert (to is None) == (jo is None)
    if to is not None:  # the precision inverts the same Sigma
        O, Oj = _dense(to), _jdense(jo)
        np.testing.assert_allclose(O, Oj, rtol=1e-3, atol=1e-4 * np.abs(Oj).max())


@pytest.mark.parametrize("name", ["low_rank_diag", "graphical_lasso"])
def test_structured_init_matches_jax(name):
    (js, jo), (ts, to) = jreg.get_regularizer(name).init(6), \
        treg.get_regularizer(name).init(6, torch.float32, "cpu")
    assert type(ts).__name__ == type(js).__name__
    np.testing.assert_array_equal(_dense(ts), _jdense(js))
    np.testing.assert_array_equal(_dense(to), _jdense(jo))


def test_low_rank_full_rank_matches_omega_step():
    """At r = m the subspace is the whole space and low_rank_diag is the
    Zhang-Yeung step. In float32 the residual diagonal sqrt(max(M_ii -
    captured, 0)) takes the square root of a cancellation, so both packages
    land up to ~1e-4 off the dense step (JAX measured 1.0e-4 on these W):
    held at the JAX package's own bar for this claim (1e-3,
    tests/test_sigma_view.py), and to the JAX result where r < m."""
    for m, d, seed in [(4, 16, 0), (8, 40, 1), (16, 100, 3)]:
        W = torch.from_numpy(_w(m, d, seed))
        U, s, dd = tom.omega_step_lowrank(W, m)
        S = LowRankDiagSigma(U, torch.diag(s), dd).dense()
        torch.testing.assert_close(S, tom.omega_step(W)[0], atol=1e-3, rtol=0)
        assert float(torch.trace(S)) == pytest.approx(1.0, abs=1e-5)
        torch.testing.assert_close(U.T @ U, torch.eye(m), atol=1e-4, rtol=0)


def test_low_rank_step_matches_jax_below_full_rank():
    from repro.core import omega as jom
    from repro.core.sigma_view import LowRankDiagSigma as JaxLowRank

    for m, d, r in [(8, 40, 4), (16, 100, 8), (33, 12, 5)]:
        W = _w(m, d, m)
        U, s, dd = tom.omega_step_lowrank(torch.from_numpy(W), r)
        Uj, sj, dj = jom.omega_step_lowrank(jnp.asarray(W), r)
        np.testing.assert_allclose(
            LowRankDiagSigma(U, torch.diag(s), dd).dense().numpy(),
            np.asarray(JaxLowRank(Uj, jnp.diag(sj), dj).dense()), atol=1e-5)


@pytest.fixture(scope="module")
def lowrank_fits(small_problem, small_cfg):
    tp = synthetic(1, m=4, d=16, n_train_avg=40, n_test_avg=10, seed=1)
    tcfg = DMTRLConfig(**dataclasses.asdict(small_cfg))
    out = {}
    for name, params in [("low_rank_diag", {"rank": 2}), ("graphical_lasso", {"penalty": 0.5})]:
        je = JaxEstimator(config=small_cfg, regularizer=name, regularizer_params=params)
        te = DMTRLEstimator(config=tcfg, regularizer=name, regularizer_params=params,
                            device="cpu")
        je.fit(small_problem.train).partial_fit(small_problem.train)
        te.fit(tp.train).partial_fit(tp.train)
        out[name] = (je, te)
    return out


@pytest.mark.parametrize("name", ["low_rank_diag", "graphical_lasso"])
def test_structured_fit_matches_jax(lowrank_fits, name):
    je, te = lowrank_fits[name]
    np.testing.assert_allclose(te.W_.numpy(), np.asarray(je.W_), atol=2e-4)
    np.testing.assert_allclose(te.sigma_.numpy(), np.asarray(je.sigma_), atol=1e-5)
    np.testing.assert_allclose(te.sigma_view_.dense().numpy(),
                               np.asarray(je.sigma_view_.dense()), atol=1e-5)
    assert isinstance(te.sigma_view_, LowRankDiagSigma if name == "low_rank_diag"
                      else SparseSigma)
    np.testing.assert_allclose(te.history["gap"], je.history["gap"], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(te.rho_per_outer_, je.rho_per_outer_, rtol=1e-5)
    assert (te.omega_ is None) == (je.omega_ is None)


@pytest.mark.parametrize("m", [1, 2, 3, 257])
def test_all_members_sigma_psd_trace_normalized(m):
    for name in sorted(treg.available_regularizers()):
        params = {"adjacency": _chain(m)} if name == "graph_laplacian" else {}
        reg = treg.get_regularizer(name, **params)
        if reg.learns:
            sigma, _ = reg.step(torch.from_numpy(_w(m, 5)), 1e-6)
        else:
            sigma, _ = reg.init(m, torch.float32, "cpu")
        S = _dense(sigma).astype(np.float64)
        assert S.shape == (m, m), name
        assert np.allclose(S, S.T, atol=1e-5), name
        assert np.linalg.eigvalsh(S).min() > -1e-5, name
        assert np.trace(S) == pytest.approx(1.0, abs=1e-3), name


@pytest.mark.parametrize("name", ["trace_constraint", "low_rank_diag", "graphical_lasso",
                                  "frobenius_shrunk"])
def test_omega_step_rejects_non_finite_w(name):
    reg = treg.get_regularizer(name)
    for bad in (float("nan"), float("inf")):
        W = torch.ones((4, 3))
        W[1, 2] = bad
        with pytest.raises(ValueError, match="non-finite"):
            reg.step(W, 1e-6)
    reg2 = dataclasses.replace(reg, description="copy")
    with pytest.raises(ValueError, match="non-finite"):
        reg2.step(torch.full((3, 2), float("nan")), 1e-6)


def test_member_validation():
    with pytest.raises(ValueError, match="exactly one"):
        treg.get_regularizer("graph_laplacian")
    with pytest.raises(ValueError, match="symmetric"):
        treg.get_regularizer("graph_laplacian", adjacency=np.triu(np.ones((3, 3))))
    with pytest.raises(ValueError, match="non-negative"):
        treg.get_regularizer("graph_laplacian", adjacency=-np.ones((2, 2)))
    reg = treg.get_regularizer("graph_laplacian", laplacian=np.eye(3))
    with pytest.raises(ValueError, match="built for 3 tasks"):
        reg.init(4)
    with pytest.raises(ValueError, match="shrinkage"):
        treg.get_regularizer("frobenius_shrunk", shrinkage=1.5)
    with pytest.raises(ValueError, match="rank"):
        treg.get_regularizer("low_rank_diag", rank=0)
    with pytest.raises(ValueError, match="penalty"):
        treg.get_regularizer("graphical_lasso", penalty=-1.0)
    with pytest.raises(ValueError, match="needs member parameters"):
        treg.resolve_regularizer(DMTRLConfig(omega_regularizer="graph_laplacian"))
    # a degenerate W falls back to Sigma = I/m
    s, _ = treg.get_regularizer("graphical_lasso").step(torch.zeros((3, 2)), 1e-6)
    torch.testing.assert_close(s.dense(), torch.eye(3) / 3)


def test_dense_member_warns_once_above_threshold():
    cfg = DMTRLConfig()
    treg._dense_scale_warned.discard("trace_constraint")
    try:
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            treg.resolve_regularizer(cfg, m=4, dense_warn_threshold=2)
            treg.resolve_regularizer(cfg, m=4, dense_warn_threshold=2)  # once only
        msgs = [x for x in w if "dense" in str(x.message).lower()]
        assert len(msgs) == 1 and "low_rank_diag" in str(msgs[0].message)
        with warnings.catch_warnings(record=True) as w2:
            warnings.simplefilter("always")
            treg.resolve_regularizer(cfg, regularizer=treg.get_regularizer("low_rank_diag"),
                                     m=10_000, dense_warn_threshold=2)
        assert not [x for x in w2 if "dense" in str(x.message).lower()]
        assert treg.DENSE_SIGMA_WARN_THRESHOLD == jreg.DENSE_SIGMA_WARN_THRESHOLD
    finally:
        treg._dense_scale_warned.discard("trace_constraint")


def test_graph_laplacian_fit_keeps_its_fixed_sigma(small_cfg):
    tp = synthetic(1, m=4, d=16, n_train_avg=40, n_test_avg=10, seed=1)
    A = _chain(4)
    te = DMTRLEstimator(config=DMTRLConfig(**dataclasses.asdict(small_cfg)),
                        regularizer="graph_laplacian", regularizer_params={"adjacency": A},
                        device="cpu").fit(tp.train)
    s0, _ = treg.get_regularizer("graph_laplacian", adjacency=A).init(4)
    torch.testing.assert_close(te.sigma_, s0)
    assert te.sigma_view_ is None
