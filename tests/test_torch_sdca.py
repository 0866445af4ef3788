"""The port's local-SDCA forms (repro_torch.core.sdca) against
repro.core.sdca on the same coordinates: naive, block-Gram and full-Gram
walk the same iterates, atol 2e-5 (tests/test_solver_backends.py's bar)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sdca as js
from repro.core.losses import get_loss as jloss
from repro_torch import prng
from repro_torch.core import sdca as ts
from repro_torch.core.losses import get_loss as tloss

ATOL = 2e-5
RHO, LAM = 2.0, 1e-3


def _tasks(seed, m=2, n=30, d=11, H=32, n_valid=25):
    rs = np.random.RandomState(seed)
    x = (rs.randn(m, n, d) / np.sqrt(d)).astype(np.float32)
    y = np.where(rs.randn(m, n) >= 0, 1.0, -1.0).astype(np.float32)
    alpha = (0.1 * rs.randn(m, n)).astype(np.float32)
    w = (0.05 * rs.randn(m, d)).astype(np.float32)
    n_i = np.full((m,), n_valid, np.int32)
    sigma = np.array([0.2, 0.35][:m], np.float32)
    coords = rs.randint(0, n_valid, size=(m, H))
    coords[:, 5] = coords[:, 1]  # a duplicate in the first block
    return x, y, alpha, w, n_i, sigma, coords


def _jax_per_task(fn, arrays, t, *extra, **kw):
    x, y, alpha, w, n_i, sigma, coords = arrays
    return fn(jnp.asarray(x[t]), jnp.asarray(y[t]), jnp.asarray(alpha[t]),
              jnp.asarray(w[t]), jnp.int32(n_i[t]), jnp.float32(sigma[t]),
              jnp.asarray(coords[t], jnp.int32), RHO, LAM, *extra, **kw)


def _port(fn, arrays, *extra, **kw):
    x, y, alpha, w, n_i, sigma, coords = (torch.from_numpy(a) for a in arrays)
    return fn(x, y, alpha, w, n_i, sigma, coords.long(), RHO, LAM, *extra, **kw)


@pytest.mark.parametrize("loss_name", ["hinge", "squared", "smoothed_hinge", "logistic"])
@pytest.mark.parametrize("form", ["naive", "block", "gram"])
def test_local_sdca_matches_jax(form, loss_name):
    arrays = _tasks(3)
    kw = {"block": 16} if form == "block" else {}
    fn_t = getattr(ts, f"local_sdca_{form}")
    fn_j = getattr(js, f"local_sdca_{form}")
    da, r = _port(fn_t, arrays, tloss(loss_name), **kw)
    for t in range(2):
        da_j, r_j = _jax_per_task(fn_j, arrays, t, jloss(loss_name), **kw)
        np.testing.assert_allclose(da[t].numpy(), np.asarray(da_j), atol=ATOL)
        np.testing.assert_allclose(r[t].numpy(), np.asarray(r_j), atol=ATOL)


def test_sample_coords_matches_jax():
    key = jax.random.PRNGKey(9)
    keys = jax.random.split(key, 3)
    n_i = np.array([17, 1, 250], np.int32)
    got = ts.sample_coords(prng.split(prng.PRNGKey(9), 3), 64, torch.from_numpy(n_i), 300)
    for t in range(3):
        ref = js.sample_coords(keys[t], 64, jnp.int32(n_i[t]), 300)
        assert np.array_equal(got[t].numpy(), np.asarray(ref))
    assert int(got[1].max()) == 0


def test_sdca_block_solve_matches_jax():
    x, y, alpha, w, n_i, sigma, coords = _tasks(4, H=16)
    cb = coords
    xb = np.take_along_axis(x, cb[:, :, None], axis=1)
    G = np.einsum("mbd,mcd->mbc", xb, xb)
    q = np.einsum("mbd,md->mb", xb, w)
    xr = (0.1 * np.random.RandomState(0).randn(*q.shape)).astype(np.float32)
    kappa = (RHO * sigma / (LAM * n_i)).astype(np.float32)
    dalpha0 = np.zeros_like(alpha)
    dal, deltas = ts.sdca_block_solve(
        *(torch.from_numpy(a) for a in (G, q, xr, dalpha0.copy(), alpha, y)),
        torch.from_numpy(cb).long(), torch.from_numpy(kappa), tloss("hinge"))
    for t in range(2):
        dj, ej = js.sdca_block_solve(
            jnp.asarray(G[t]), jnp.asarray(q[t]), jnp.asarray(xr[t]),
            jnp.asarray(dalpha0[t]), jnp.asarray(alpha[t]), jnp.asarray(y[t]),
            jnp.asarray(cb[t], jnp.int32), jnp.float32(kappa[t]), jloss("hinge"))
        np.testing.assert_allclose(dal[t].numpy(), np.asarray(dj), atol=ATOL)
        np.testing.assert_allclose(deltas[t].numpy(), np.asarray(ej), atol=ATOL)
