"""The port's Omega-step, rho bounds, SigmaView and regularizer registry
against the JAX package's. eigh's eigenvector signs are arbitrary, so
Sigma and Omega are compared, never eigenvectors."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import omega as jom
from repro.core import omega_regularizers as jreg
from repro.core import sigma_view as jsv
from repro_torch.core import omega as tom
from repro_torch.core import omega_regularizers as treg
from repro_torch.core import sigma_view as tsv


def _w(seed, m, d, rank=None):
    rs = np.random.RandomState(seed)
    W = rs.randn(m, d)
    if rank is not None:  # rank-deficient W exercises the jitter
        W = rs.randn(m, rank) @ rs.randn(rank, d)
    return (0.3 * W).astype(np.float32)


# A rank-deficient W has (near-)zero eigenvalues whose float32 eigh noise
# (~1e-7 of the largest) passes through a square root: ~3e-4 of Sigma on
# both sides, so those cases carry that bar instead of 1e-5.
@pytest.mark.parametrize("m,d,rank,atol", [(4, 16, None, 1e-5), (8, 40, None, 1e-5),
                                           (6, 10, 2, 1e-3), (3, 50, 1, 1e-3)])
def test_omega_step_matches_jax(m, d, rank, atol):
    W = _w(m * d, m, d, rank)
    sj, oj = jom.omega_step(jnp.asarray(W))
    st, ot = tom.omega_step(torch.from_numpy(W))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=atol)
    if rank is None:  # Omega inverts the same eigenvalues
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-3,
                                   atol=1e-4 * float(np.abs(np.asarray(oj)).max()))
    assert float(torch.trace(st)) == pytest.approx(1.0, abs=1e-5)


def test_omega_step_zero_w_falls_back_to_identity():
    st, _ = tom.omega_step(torch.zeros(5, 7))
    torch.testing.assert_close(st, torch.eye(5) / 5, atol=1e-6, rtol=0)


def test_init_sigma_and_correlation():
    sj, oj = jom.init_sigma(6)
    st, ot = tom.init_sigma(6)
    assert np.array_equal(st.numpy(), np.asarray(sj))
    assert np.array_equal(ot.numpy(), np.asarray(oj))
    S = tom.omega_step(torch.from_numpy(_w(1, 5, 9)))[0]
    cj = jom.correlation_from_sigma(jnp.asarray(S.numpy()))
    np.testing.assert_allclose(tom.correlation_from_sigma(S).numpy(), np.asarray(cj), atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("eta", [1.0, 0.5])
def test_rho_bounds_match_jax(seed, eta):
    S = np.array(jom.omega_step(jnp.asarray(_w(seed, 7, 12)))[0])
    St = torch.from_numpy(S)
    assert float(tom.rho_lemma10(St, eta)) == pytest.approx(float(jom.rho_lemma10(jnp.asarray(S), eta)), rel=1e-6)
    assert float(tom.rho_spectral(St, eta)) == pytest.approx(float(jom.rho_spectral(jnp.asarray(S), eta)), rel=1e-5)
    assert float(tom.rho_spectral(St, eta)) <= float(tom.rho_lemma10(St, eta)) + 1e-6
    for mode in ("lemma10", "spectral", "fixed"):
        assert treg.default_rho_bound(St, eta, mode, 2.5) == pytest.approx(
            jreg.default_rho_bound(jnp.asarray(S), eta, mode, 2.5), rel=1e-5)
        assert treg.default_rho_bound(tsv.as_view(St), eta, mode, 2.5) == pytest.approx(
            jreg.default_rho_bound(jsv.as_view(jnp.asarray(S)), eta, mode, 2.5), rel=1e-5)


def test_dense_sigma_view_matches_jax():
    S = np.array(jom.omega_step(jnp.asarray(_w(4, 6, 11)))[0])
    jv, tv = jsv.DenseSigma(jnp.asarray(S)), tsv.DenseSigma(torch.from_numpy(S))
    V = np.random.RandomState(0).randn(6, 3).astype(np.float32)
    assert tv.m == 6 and tv.kind == "dense"
    np.testing.assert_allclose(tv.diag().numpy(), np.asarray(jv.diag()))
    np.testing.assert_allclose(tv.matvec(torch.from_numpy(V)).numpy(), np.asarray(jv.matvec(jnp.asarray(V))), atol=1e-6)
    assert np.array_equal(tv.dense().numpy(), S)
    for eta in (1.0, 0.5):
        assert float(tv.rho_lemma10(eta)) == pytest.approx(float(jv.rho_lemma10(eta)), rel=1e-6)
        assert float(tv.rho_spectral(eta)) == pytest.approx(float(jv.rho_spectral(eta)), rel=1e-5)
    assert tsv.as_view(tv) is tv


def test_result_sigma_omega_and_maybe_dense():
    S = torch.eye(3) / 3
    assert tsv.result_sigma_omega(S, None) == (S, None, None)
    view = tsv.DenseSigma(S)
    s, o, v = tsv.result_sigma_omega(view, tsv.DenseSigma(3 * torch.eye(3)))
    assert s is S and v is view
    torch.testing.assert_close(o, 3 * torch.eye(3))
    assert tsv.result_sigma_omega(view, None)[1] is None
    assert tsv.maybe_dense(None) is None
    assert tsv.maybe_dense(view) is S
    assert isinstance(tsv.maybe_dense(np.eye(2)), torch.Tensor)


def test_regularizer_registry():
    assert set(treg.available_regularizers()) == {"trace_constraint", "identity_stl"}
    tc = treg.get_regularizer("trace_constraint")
    assert tc.learns and not treg.get_regularizer("identity_stl").learns
    W = torch.from_numpy(_w(2, 4, 9))
    st, _ = tc.step(W, 1e-6)
    torch.testing.assert_close(st, tom.omega_step(W)[0])
    with pytest.raises(ValueError, match="non-finite"):
        tc.step(torch.full((3, 4), float("nan")), 1e-6)
    for name in ("graph_laplacian", "frobenius_shrunk", "low_rank_diag", "graphical_lasso"):
        with pytest.raises(NotImplementedError, match="not ported"):
            treg.get_regularizer(name)
    with pytest.raises(KeyError, match="unknown omega regularizer"):
        treg.get_regularizer("nope")


def test_resolve_regularizer_precedence():
    class Cfg:
        learn_omega = False
        omega_regularizer = "trace_constraint"

    assert treg.resolve_regularizer(Cfg()).name == "identity_stl"
    with pytest.raises(ValueError, match="learn_omega=False conflicts"):
        treg.resolve_regularizer(Cfg(), "trace_constraint")
    Cfg.learn_omega = True
    assert treg.resolve_regularizer(Cfg()).name == "trace_constraint"
    assert treg.resolve_regularizer(Cfg(), "identity_stl").name == "identity_stl"
    with pytest.raises(TypeError):
        treg.resolve_regularizer(Cfg(), 3)
