"""The port's Section-6 quantities (repro_torch/core/convergence.py) against
repro.core.convergence on the same numpy inputs (the shared small problem):

  * q_max and the H/T bounds at 1e-6 relative (the bounds are the same
    float64 arithmetic; q_max a float32 max of row norms);
  * pi_i at 1e-5 relative: float32 largest singular values from two
    libraries' SVDs;
  * rho_min_power_iteration at 1e-4 relative: QR signs may differ, the
    projector Q Q^T and so the value do not; the start vector comes from
    ``prng.normal``, equal to JAX's to float32 rounding;
  * the staleness/tick helpers exactly, on a scripted history;
  * measure_theta at 1e-4 (relative, with a 1e-6 floor).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import convergence as jcv
from repro.core import omega as jom
from repro.core import sdca as jsdca
from repro.core.losses import get_loss as jloss
from repro_torch.core import convergence as tcv
from repro_torch.data.synthetic import synthetic


@pytest.fixture(scope="module")
def port_train():
    return synthetic(1, m=4, d=16, n_train_avg=40, n_test_avg=10, seed=1).train


@pytest.fixture(scope="module")
def sigma():
    W = np.random.RandomState(3).randn(4, 16).astype(np.float32)
    s, _ = jom.omega_step(jnp.asarray(W))
    return np.array(s)


def test_q_max(small_problem, port_train):
    assert tcv.q_max(port_train) == pytest.approx(jcv.q_max(small_problem.train), rel=1e-6)


@pytest.mark.parametrize("name, args", [
    ("h_bound_smooth", (0.3, 1.7, 0.25, 1.0, 1.0, 1e-3, 40)),
    ("h_bound_smooth", (0.01, 4.0, 0.1, 2.5, 0.5, 1e-2, 100)),
    ("t_bound_smooth", (1e-3, 1.0, 0.4, 1e-3, 1.0, 1.7, 40, 0.02, 4)),
    ("t_bound_smooth", (1e-5, 0.5, 0.9, 1e-2, 0.5, 3.0, 100, 0.5, 16)),
    ("t_bound_lipschitz", (1e-2, 1.0, 0.4, 1e-3, 1.7, 1.0, 0.3, 4)),
    ("t_bound_lipschitz", (1e-4, 0.5, 0.1, 1e-1, 1.0, 2.0, 1e-6, 64)),
])
def test_bounds(name, args):
    got, want = getattr(tcv, name)(*args), getattr(jcv, name)(*args)
    assert math.isfinite(got) and got == pytest.approx(want, rel=1e-6)


def test_pi_i(small_problem, port_train, sigma):
    sii = np.diag(sigma).copy()
    got = tcv.pi_i(port_train, torch.from_numpy(sii)).numpy()
    want = np.asarray(jcv.pi_i(small_problem.train, jnp.asarray(sii)))
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 3])
def test_rho_min_power_iteration(small_problem, port_train, sigma, seed):
    got = tcv.rho_min_power_iteration(port_train, torch.from_numpy(sigma), eta=1.0, seed=seed)
    want = jcv.rho_min_power_iteration(small_problem.train, jnp.asarray(sigma), 1.0, seed=seed)
    assert got == pytest.approx(want, rel=1e-4)
    # never above the Lemma-10 closed form it estimates under
    lemma10 = float(np.max(np.abs(sigma).sum(axis=1) / np.diag(sigma)))
    assert got <= lemma10 * (1 + 1e-5)
    # at the paper's init Sigma = I/m the blocks decouple: rho_min = 1
    eye = torch.eye(4) / 4
    assert tcv.rho_min_power_iteration(port_train, eye) == pytest.approx(1.0, rel=1e-4)


def _history():
    """A scripted gossip-shaped event history: 3 workers, uneven
    staleness, 2 exchanges on a 3-ring."""
    return {
        "round": np.array([1, 2, 3, 4, 5, 6]),
        "tick": np.array([0.5, 1.0, 2.0, 2.5, 4.0, 4.5]),
        "gap": np.array([3.0, 2.0, 1.2, 1.3, 0.4, 0.3]),
        "w_worker": np.array([0, 1, 2, 0, 1, 2, 0]),
        "w_staleness": np.array([0, 1, 2, 0, 3, 1, 2]),
        "w_lag": np.array([0, 0, 1, 0, 1, 0, 2]),
        "e_src": np.array([0, 0, 1, 0, 0, 1]),
        "e_dst": np.array([1, 2, 2, 1, 2, 2]),
        "e_stal": np.array([0, 1, 1, 2, 0, 1]),
        "e_tick": np.array([1.0, 1.0, 1.0, 2.0, 2.0, 2.0]),
    }


def test_staleness_helpers_exact():
    h = _history()
    assert tcv.staleness_summary(h) == jcv.staleness_summary(h)
    server_only = {k: v for k, v in h.items() if not k.startswith("e_")}
    assert tcv.staleness_summary(server_only) == jcv.staleness_summary(server_only)
    assert tcv.staleness_summary({}) == jcv.staleness_summary({})
    for a, b in zip(tcv.effective_gap_curve(h), jcv.effective_gap_curve(h)):
        assert np.array_equal(a, b)
    no_tick = {"gap": h["gap"]}
    for a, b in zip(tcv.effective_gap_curve(no_tick), jcv.effective_gap_curve(no_tick)):
        assert np.array_equal(a, b)
    assert np.array_equal(tcv.sync_effective_ticks(h, (1, 3, 2)),
                          jcv.sync_effective_ticks(h, (1, 3, 2)))
    for target in (1.25, 0.3, 0.1, 5.0):
        assert tcv.ticks_to_gap(h["tick"], h["gap"], target) == \
            jcv.ticks_to_gap(h["tick"], h["gap"], target)
    assert tcv.ticks_to_gap(h["tick"], h["gap"], 1.25) == 2.0
    assert tcv.ticks_to_gap(h["tick"], h["gap"], 0.1) == float("inf")


@pytest.mark.parametrize("loss_name, i", [("hinge", 1), ("squared", 2)])
def test_measure_theta(small_problem, port_train, sigma, loss_name, i):
    jtr = small_problem.train
    rs = np.random.RandomState(5)
    y, mask = np.asarray(jtr.y), np.asarray(jtr.mask)
    scale = 1.0 if loss_name == "hinge" else 0.3
    alpha = (y * rs.uniform(0, scale, y.shape) * mask).astype(np.float32)
    W = (0.2 * rs.randn(jtr.m, jtr.d)).astype(np.float32)
    rho, lam = 1.5, 1e-2
    # a short local solve (32 steps) as the iterate whose quality is measured
    coords = jsdca.sample_coords(jax.random.PRNGKey(9), 32, jtr.n[i], jtr.n_max)
    da, _ = jsdca.local_sdca_naive(
        jtr.x[i], jtr.y[i], jnp.asarray(alpha[i]), jnp.asarray(W[i]), jtr.n[i],
        jnp.asarray(sigma[i, i]), coords, rho, lam, jloss(loss_name))
    da = np.array(da)
    want = jcv.measure_theta(jtr, i, jnp.asarray(alpha), jnp.asarray(W), jnp.asarray(sigma),
                             rho, lam, loss_name, jnp.asarray(da), ref_steps=4000)
    got = tcv.measure_theta(port_train, i, torch.from_numpy(alpha), torch.from_numpy(W),
                            torch.from_numpy(sigma), rho, lam, loss_name,
                            torch.from_numpy(da), ref_steps=4000)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-6), k
    assert 0.0 <= got["theta"] <= 1.0
