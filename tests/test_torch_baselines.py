"""The port's baselines (repro_torch/core/baselines.py) against
repro.core.baselines, on the JAX tests' problems (tests/test_dmtrl.py):

  * fit_stl at the fit bars (W atol 2e-4, Sigma atol 1e-5);
  * fit_centralized_mtrl's W at atol 1e-4 (FISTA in a Python loop against
    the JAX package's lax.scan);
  * fit_ssdca's dual history at 1e-4 relative; its task draws
    (``prng.randint``) bit-equal to ``jax.random.randint``;
  * the three baseline claims of tests/test_dmtrl.py on the port.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DMTRLConfig as JConfig
from repro.core import baselines as jb
from repro.core import dmtrl as jdmtrl
from repro.data.synthetic import synthetic as jsynthetic
from repro_torch import prng
from repro_torch.core import DMTRLConfig, fit
from repro_torch.core import baselines as tb
from repro_torch.core import dual as dm
from repro_torch.core import omega as om
from repro_torch.core.losses import get_loss
from repro_torch.data.synthetic import synthetic

TOL_W, TOL_SIGMA = 2e-4, 1e-5

SSDCA_CFG = dict(loss="hinge", lam=1e-2, outer_iters=1, rounds=25, local_iters=128,
                 learn_omega=False, seed=0)
SSDCA_DATA = dict(m=4, d=24, n_train_avg=60, n_test_avg=20, seed=3)
MTRL_CFG = dict(loss="squared", lam=1e-2, outer_iters=3, rounds=10, local_iters=160, seed=0)
MTRL_DATA = dict(m=5, d=16, n_train_avg=80, n_test_avg=40, seed=4)


def test_fit_stl_matches_jax(small_problem, small_cfg):
    port = synthetic(1, m=4, d=16, n_train_avg=40, n_test_avg=10, seed=1)
    rj = jb.fit_stl(small_cfg, small_problem.train)
    rt = tb.fit_stl(DMTRLConfig(**dataclasses.asdict(small_cfg)), port.train, device="cpu")
    np.testing.assert_allclose(rt.W.numpy(), np.asarray(rj.W), atol=TOL_W)
    np.testing.assert_allclose(rt.sigma.numpy(), np.asarray(rj.sigma), atol=TOL_SIGMA)
    # STL holds Sigma at the paper's init I/m
    np.testing.assert_allclose(rt.sigma.numpy(), np.eye(4) / 4, atol=1e-7)


@pytest.fixture(scope="module")
def mtrl():
    jd, td = jsynthetic(1, **MTRL_DATA), synthetic(1, **MTRL_DATA)
    Wj, Sj, hj = jb.fit_centralized_mtrl(JConfig(**MTRL_CFG), jd.train, inner_steps=500)
    Wt, St, ht = tb.fit_centralized_mtrl(DMTRLConfig(**MTRL_CFG), td.train,
                                         inner_steps=500, device="cpu")
    return td, (Wj, Sj, hj), (Wt, St, ht)


def test_fit_centralized_mtrl_matches_jax(mtrl):
    _, (Wj, Sj, hj), (Wt, St, ht) = mtrl
    np.testing.assert_allclose(Wt.numpy(), np.asarray(Wj), atol=1e-4)
    np.testing.assert_allclose(St.numpy(), np.asarray(Sj), atol=TOL_SIGMA)
    np.testing.assert_array_equal(ht["outer"], hj["outer"])
    np.testing.assert_allclose(ht["primal"], hj["primal"], rtol=1e-5)


@pytest.fixture(scope="module")
def ssdca():
    jd, td = jsynthetic(1, **SSDCA_DATA).train, synthetic(1, **SSDCA_DATA).train
    _, _, hj = jb.fit_ssdca(JConfig(**SSDCA_CFG), jd, passes=25)
    Wt, St, ht = tb.fit_ssdca(DMTRLConfig(**SSDCA_CFG), td, passes=25, device="cpu")
    return td, hj, (Wt, St, ht)


def test_fit_ssdca_dual_history_matches_jax(ssdca):
    _, hj, (_, _, ht) = ssdca
    np.testing.assert_array_equal(ht["pass"], hj["pass"])
    for k in ("dual", "primal"):
        np.testing.assert_allclose(ht[k], hj[k], rtol=1e-4)
    assert ht["gap"][-1] < ht["gap"][0]


@pytest.mark.parametrize("seed", [17, 18, 1234])
def test_ssdca_task_draws_bit_equal(seed):
    """One pass's draws: tasks by randint over m, rows by uniform."""
    key = jax.random.split(jax.random.PRNGKey(seed))[1]
    ki, kj = jax.random.split(key)
    tkey = torch.from_numpy(np.asarray(key).astype(np.int64))
    tki, tkj = prng.split(tkey)
    for m in (4, 10, 4096):
        want = np.asarray(jax.random.randint(ki, (5000,), 0, m))
        assert np.array_equal(prng.randint(tki, (5000,), 0, m).numpy(), want)
    assert np.array_equal(prng.uniform(tkj, (5000,)).numpy(),
                          np.asarray(jax.random.uniform(kj, (5000,))))


# ---------------------------------------------------------------------------
# the paper's baseline claims (tests/test_dmtrl.py) on the port
# ---------------------------------------------------------------------------
def test_dmtrl_beats_stl_on_correlated_tasks():
    small = synthetic(1, m=8, d=40, n_train_avg=40, n_test_avg=120, seed=2)
    cfg = DMTRLConfig(loss="hinge", lam=1e-3, outer_iters=3, rounds=6, local_iters=96, seed=0)
    res = fit(cfg, small.train, device="cpu")
    stl = tb.fit_stl(cfg, small.train, device="cpu")
    err_mtl = float(dm.error_rate(small.test, res.W))
    err_stl = float(dm.error_rate(small.test, stl.W))
    assert err_mtl <= err_stl + 0.01, (err_mtl, err_stl)


def test_ssdca_converges_to_same_dual(ssdca):
    data, _, (_, _, ht) = ssdca
    cfg = DMTRLConfig(**SSDCA_CFG)
    res = fit(cfg, data, device="cpu")
    sigma, _ = om.init_sigma(data.m)
    d_dmtrl = float(dm.dual_objective(data, res.alpha, sigma, cfg.lam, get_loss("hinge")))
    assert d_dmtrl == pytest.approx(ht["dual"][-1], rel=0.05)


def test_centralized_mtrl_parity_squared_loss(mtrl):
    td, _, (Wc, _, _) = mtrl
    res = fit(DMTRLConfig(**MTRL_CFG), td.train, device="cpu")
    rmse_d = float(dm.rmse(td.test, res.W))
    rmse_c = float(dm.rmse(td.test, Wc))
    assert rmse_d == pytest.approx(rmse_c, rel=0.1), (rmse_d, rmse_c)
    # the JAX package reaches the same RMSE on the same problem
    jd = jsynthetic(1, **MTRL_DATA)
    from repro.core import dual as jdual

    rj = jdmtrl.fit(JConfig(**MTRL_CFG), jd.train)
    assert rmse_d == pytest.approx(float(jdual.rmse(jd.test, jnp.asarray(rj.W))), rel=1e-4)
