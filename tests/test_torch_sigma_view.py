"""The port's structured Sigma views (repro_torch/core/sigma_view.py)
against the JAX package's, built from the same numpy factors: rows within
1e-6 and matvec within 1e-5 (the bars of tests/test_sigma_view.py), and
diag, col_block_matvec, trace, nbytes, logdet_bound, pad/unpad,
precision, factors and the rho bounds beside them. Above
``_SPECTRAL_EXACT_LIMIT`` the power-iteration rho stays within
[eta, rho_lemma10]."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sigma_view as jsv
from repro_torch.core import sigma_view as tsv

KINDS = ["lowrank", "sparse", "dense"]


def _factors(m=7, r=3, k=2, seed=0):
    """Numpy factors of one view of each class (as in the JAX package's test)."""
    rng = np.random.RandomState(seed)
    U = rng.randn(m, r).astype(np.float32)
    core = np.diag(rng.rand(r).astype(np.float32) + 0.1)
    d = rng.rand(m).astype(np.float32) + 0.05
    cols = np.zeros((m, k), np.int32)
    vals = np.zeros((m, k), np.float32)
    for i in range(m):  # symmetric band: couple i with i+-1
        js = [j for j in (i - 1, i + 1) if 0 <= j < m][:k]
        cols[i, : len(js)] = js
        vals[i, : len(js)] = 0.01 * (1 + np.arange(len(js)))
    dense_off = np.zeros((m, m), np.float32)
    for i in range(m):
        for s in range(k):
            if vals[i, s]:
                dense_off[i, cols[i, s]] = vals[i, s]
    dense_off = 0.5 * (dense_off + dense_off.T)
    for i in range(m):
        for s in range(k):
            if vals[i, s]:
                vals[i, s] = dense_off[i, cols[i, s]]
    diag_v = rng.rand(m).astype(np.float32) + 0.5
    dense = (U @ core @ U.T + np.diag(d)).astype(np.float32)
    return {
        "lowrank": {"kind": "low_rank_diag", "U": U, "core": core, "d": d},
        "sparse": {"kind": "sparse", "diag_v": diag_v, "cols": cols, "vals": vals},
        "dense": {"kind": "dense", "sigma": dense},
    }


def _pair(kind, **kw):
    f = _factors(**kw)[kind]
    return jsv.view_from_factors(f), tsv.view_from_factors(f)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("kind", KINDS)
def test_view_ops_match_jax(kind):
    jv, tv = _pair(kind)
    m = tv.m
    assert tv.m == jv.m and tv.kind == jv.kind
    rng = np.random.RandomState(1)
    v = rng.randn(m).astype(np.float32)
    V = rng.randn(m, 3).astype(np.float32)
    np.testing.assert_allclose(_np(tv.matvec(torch.from_numpy(v))),
                               _np(jv.matvec(jnp.asarray(v))), atol=1e-5)
    np.testing.assert_allclose(_np(tv.matvec(torch.from_numpy(V))),
                               _np(jv.matvec(jnp.asarray(V))), atol=1e-5)
    np.testing.assert_allclose(_np(tv.diag()), _np(jv.diag()), atol=1e-6)
    idx = np.array([0, m - 1, 2, 2], np.int32)  # a repeated row too
    np.testing.assert_allclose(_np(tv.rows(torch.from_numpy(idx).long())),
                               _np(jv.rows(jnp.asarray(idx))), atol=1e-6)
    S = _np(tv.dense())
    np.testing.assert_allclose(S, _np(jv.dense()), atol=1e-6)
    np.testing.assert_allclose(S, S.T, atol=1e-6)
    db = rng.randn(3, 4).astype(np.float32)
    np.testing.assert_allclose(_np(tv.col_block_matvec(2, torch.from_numpy(db))),
                               _np(jv.col_block_matvec(2, jnp.asarray(db))), atol=1e-5)
    np.testing.assert_allclose(_np(tv.col_block_matvec(2, torch.from_numpy(db))),
                               S[:, 2:5] @ db, atol=1e-5)
    assert float(tv.trace()) == pytest.approx(float(jv.trace()), rel=1e-6)
    assert tv.nbytes() == jv.nbytes() > 0
    assert tv.logdet_bound() == pytest.approx(jv.logdet_bound(), rel=1e-5, abs=1e-5)


@pytest.mark.parametrize("kind", KINDS)
def test_view_pad_unpad_match_jax(kind):
    jv, tv = _pair(kind)
    m = tv.m
    jp, tp = jv.pad(m + 3, 1e-6), tv.pad(m + 3, 1e-6)
    assert tp.m == m + 3 and type(tp) is type(tv)
    np.testing.assert_allclose(_np(tp.dense()), _np(jp.dense()), atol=1e-6)
    assert np.abs(_np(tp.dense())[m:, :m]).max() == 0.0
    np.testing.assert_allclose(_np(tp.unpad(m).dense()), _np(tv.dense()), atol=1e-6)
    assert tv.pad(m, 1e-6) is tv


@pytest.mark.parametrize("kind", KINDS)
def test_view_precision_matches_jax(kind):
    jv, tv = _pair(kind)
    jp, tp = jv.precision(), tv.precision()
    assert type(tp).__name__ == type(jp).__name__
    P = _np(tp.dense())
    scale = np.abs(_np(jp.dense())).max()
    np.testing.assert_allclose(P, _np(jp.dense()), atol=2e-5 * scale)
    if kind != "lowrank":  # Woodbury is exact only at r = m
        np.testing.assert_allclose(P @ _np(tv.dense()), np.eye(tv.m), atol=1e-3)


def test_sparse_precision_refused_above_the_dense_limit():
    m = tsv._PRECISION_DENSE_LIMIT + 1
    view = tsv.SparseSigma(torch.ones(m), torch.zeros((m, 0), dtype=torch.int32),
                           torch.zeros((m, 0)))
    assert view.precision() is None


@pytest.mark.parametrize("kind", KINDS)
def test_factors_cross_both_packages(kind):
    jv, tv = _pair(kind)
    wire = tv.factors()
    assert all(isinstance(x, np.ndarray) for k, x in wire.items() if k != "kind")
    back_j = jsv.view_from_factors(wire)  # the port's wire -> JAX
    back_t = tsv.view_from_factors(jv.factors())  # JAX's wire -> the port
    assert type(back_t) is type(tv)
    np.testing.assert_array_equal(_np(back_j.dense()), _np(jv.dense()))
    np.testing.assert_array_equal(_np(back_t.dense()), _np(tv.dense()))
    with pytest.raises(ValueError, match="unknown SigmaView kind"):
        tsv.view_from_factors({"kind": "banana"})


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("eta", [1.0, 0.5])
def test_rho_bounds_match_jax(kind, eta):
    jv, tv = _pair(kind)
    assert float(tv.rho_lemma10(eta)) == pytest.approx(float(jv.rho_lemma10(eta)), rel=1e-5)
    assert float(tv.rho_spectral(eta)) == pytest.approx(float(jv.rho_spectral(eta)), rel=1e-5)
    assert float(tv.rho_spectral(eta)) <= float(tv.rho_lemma10(eta)) + 1e-6


def test_rho_spectral_power_iteration_above_exact_limit():
    """Above 2048 tasks rho_spectral is a power-iteration estimate, clamped
    into [eta, rho_lemma10]; the JAX package's estimate is the same one."""
    m, r = tsv.SigmaView._SPECTRAL_EXACT_LIMIT + 52, 4
    rng = np.random.RandomState(2)
    f = {"kind": "low_rank_diag", "U": (rng.randn(m, r) / np.sqrt(m)).astype(np.float32),
         "core": np.diag([0.5, 0.3, 0.2, 0.1]).astype(np.float32),
         "d": np.full((m,), 1.0 / m, np.float32)}
    tv, jv = tsv.view_from_factors(f), jsv.view_from_factors(f)
    for eta in (1.0, 0.5):
        rho = float(tv.rho_spectral(eta))
        assert eta <= rho <= float(tv.rho_lemma10(eta)) * (1 + 1e-6)
        assert rho == pytest.approx(float(jv.rho_spectral(eta)), rel=1e-4)


def test_lowrank_rho_lemma10_factored_bound_above_exact_limit():
    m = tsv.LowRankDiagSigma._RHO_EXACT_LIMIT + 8
    rng = np.random.RandomState(3)
    f = {"kind": "low_rank_diag", "U": rng.randn(m, 2).astype(np.float32),
         "core": np.diag([0.2, 0.1]).astype(np.float32),
         "d": np.full((m,), 0.5, np.float32)}
    tv, jv = tsv.view_from_factors(f), jsv.view_from_factors(f)
    assert float(tv.rho_lemma10()) == pytest.approx(float(jv.rho_lemma10()), rel=1e-5)


def test_maybe_dense_and_result_sigma_omega_limits():
    _, lr = _pair("lowrank")
    assert tsv.maybe_dense(lr, limit=2) is lr  # too big to materialize
    assert isinstance(tsv.maybe_dense(lr, limit=1000), torch.Tensor)
    assert isinstance(tsv.maybe_dense(np.eye(2)), torch.Tensor)
    s, o, v = tsv.result_sigma_omega(lr, None)
    assert v is lr and isinstance(s, torch.Tensor)
    torch.testing.assert_close(o, lr.precision().dense())  # derived omega
    s, o, v = tsv.result_sigma_omega(lr, None, limit=2)
    assert s is lr and o is None and v is lr
