"""The port's solver-backend registry against the JAX package's: every
backend's (dalpha, r) against the same-named JAX backend on the same inputs
and keys, atol 2e-5 (tests/test_solver_backends.py's bar). The JAX kernel
backends run their Pallas kernels in interpret mode; the port's run the
kernels' plain versions, since the tensors lie on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.losses import get_loss as jax_loss
from repro.core.solver_backends import get_backend as jax_backend
from repro_torch import prng
from repro_torch.core.losses import get_loss
from repro_torch.core.solver_backends import available_backends, get_backend

KERNEL_LOSSES = ("hinge", "squared", "smoothed_hinge")
BACKENDS = ("naive", "block_gram", "pallas_block", "pallas_round")
ATOL = 2e-5


def _tasks(seed, m, n, d, n_valid):
    """m tasks of numpy inputs plus one JAX key per task."""
    rs = np.random.RandomState(seed)
    x = rs.randn(m, n, d).astype(np.float32)
    y = np.where(rs.randn(m, n) >= 0, 1.0, -1.0).astype(np.float32)
    alpha = (0.1 * rs.randn(m, n)).astype(np.float32)
    w = (0.05 * rs.randn(m, d)).astype(np.float32)
    n_i = np.full((m,), n_valid, np.int32)
    sigma = np.full((m,), 0.25, np.float32)
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(seed), m))
    return x, y, alpha, w, n_i, sigma, keys


def _compare(name, loss_name, seed, n, d, n_valid, H, block, m=2):
    arrays = _tasks(seed, m, n, d, n_valid)
    jb = jax_backend(name)
    jsolve = jb.make(jax_loss(loss_name), 2.0, 1e-3, jb.round_local_iters(H, block), block=block)
    tb = get_backend(name)
    Ht = tb.round_local_iters(H, block)
    tsolve = tb.make_from_uniform(get_loss(loss_name), 2.0, 1e-3, Ht, block=block)
    targs = [torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32 else a) for a in arrays]
    # the same JAX-split keys' uniforms, the stream the port's solvers take
    da_t, r_t = tsolve(*targs[:-1], prng.uniform(targs[-1], (Ht,)))
    x, y, alpha, w, n_i, sigma, keys = arrays
    for t in range(m):
        da_j, r_j = jsolve(
            jnp.asarray(x[t]), jnp.asarray(y[t]), jnp.asarray(alpha[t]),
            jnp.asarray(w[t]), jnp.int32(n_i[t]), jnp.float32(sigma[t]),
            jnp.asarray(keys[t]),
        )
        np.testing.assert_allclose(da_t[t].numpy(), np.asarray(da_j), atol=ATOL, err_msg=name)
        np.testing.assert_allclose(r_t[t].numpy(), np.asarray(r_j), atol=ATOL, err_msg=name)


@pytest.mark.parametrize("name", BACKENDS)
@pytest.mark.parametrize("loss_name", KERNEL_LOSSES)
def test_backend_matches_jax(name, loss_name):
    _compare(name, loss_name, seed=40 * 17, n=40, d=17, n_valid=35, H=64, block=16)


@pytest.mark.parametrize("name", BACKENDS)
def test_backend_matches_jax_ragged_h(name):
    """H = 100 is rounded up to 128 by the block-aligned backends."""
    _compare(name, "hinge", seed=5, n=70, d=33, n_valid=65, H=100, block=32, m=1)


@pytest.mark.parametrize("name", ["pallas_block", "pallas_round", "block_gram"])
@pytest.mark.parametrize("loss_name", ["logistic", "eps_insensitive"])
def test_fallback_losses_match_jax(name, loss_name):
    _compare(name, loss_name, seed=3, n=48, d=20, n_valid=48, H=64, block=32, m=1)


@pytest.mark.parametrize("name", ["block_gram", "pallas_block", "pallas_round"])
def test_duplicate_draws_match_jax(name):
    """n_valid = 3 over 32 draws per block: every block draws each
    coordinate many times, so dalpha must accumulate duplicates."""
    _compare(name, "squared", seed=11, n=12, d=7, n_valid=3, H=32, block=16)


def test_registry_api():
    have = available_backends()
    assert set(BACKENDS) <= set(have)
    with pytest.raises(KeyError, match="unknown solver backend"):
        get_backend("nope")
    assert get_backend("block_gram").round_local_iters(100, 64) == 128
    assert get_backend("naive").round_local_iters(100, 64) == 100
    for name in BACKENDS:
        assert get_backend(name).block_aligned == jax_backend(name).block_aligned
        assert get_backend(name).uses_pallas == jax_backend(name).uses_pallas
