"""repro_torch.prng against jax.random: keys, splits, folds and uniform
draws must be BIT-equal (every coordinate draw of the trainer rests on
them); normal agrees to float32 rounding (torch's erfinv is not XLA's)."""
import jax
import numpy as np
import pytest
import torch

from repro_torch import prng

SEEDS = [0, 1, 42, 2**31 - 1, 123456789]


def _np(key) -> np.ndarray:
    return np.asarray(key).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key(seed):
    assert np.array_equal(_np(jax.random.PRNGKey(seed)), prng.PRNGKey(seed).numpy())


@pytest.mark.parametrize("num", [2, 3, 20])
@pytest.mark.parametrize("seed", SEEDS)
def test_split(seed, num):
    got = prng.split(prng.PRNGKey(seed), num).numpy()
    assert np.array_equal(_np(jax.random.split(jax.random.PRNGKey(seed), num)), got)


@pytest.mark.parametrize("data", [0, 1, 7, 2**31 - 1])
@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in(seed, data):
    kj = jax.random.fold_in(jax.random.PRNGKey(seed), data)
    assert np.array_equal(_np(kj), prng.fold_in(prng.PRNGKey(seed), data).numpy())


def test_fold_in_batched_over_tasks():
    """The trainer's per-task keys fold_in(fold_in(key, t), 0), all tasks
    in one call, equal JAX's vmapped derivation."""
    key = jax.random.split(jax.random.PRNGKey(3))[1]
    tids = np.arange(9, dtype=np.int32)
    kj = jax.vmap(lambda t: jax.random.fold_in(jax.random.fold_in(key, t), 0))(tids)
    kt = prng.fold_in(prng.fold_in(torch.from_numpy(_np(key)), torch.arange(9)), 0)
    assert np.array_equal(_np(kj), kt.numpy())


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 4), (1000,), (2, 3, 5)])
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform(seed, shape):
    uj = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape))
    ut = prng.uniform(prng.PRNGKey(seed), shape).numpy()
    assert ut.dtype == np.float32 and np.array_equal(uj, ut)


def test_uniform_range_and_batched_keys():
    keys = prng.split(prng.PRNGKey(5), 4)
    u = prng.uniform(keys, (50,))
    assert u.shape == (4, 50)
    for i in range(4):
        one = np.asarray(jax.random.uniform(jax.random.split(jax.random.PRNGKey(5), 4)[i], (50,)))
        assert np.array_equal(one, u[i].numpy())
    lo_hi = prng.uniform(prng.PRNGKey(2), (200,), minval=-2.0, maxval=3.0)
    ref = np.asarray(jax.random.uniform(jax.random.PRNGKey(2), (200,), minval=-2.0, maxval=3.0))
    assert np.array_equal(ref, lo_hi.numpy())
    assert float(lo_hi.min()) >= -2.0 and float(lo_hi.max()) < 3.0


@pytest.mark.parametrize("seed", [0, 17])
def test_normal_close(seed):
    nj = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (500,)))
    nt = prng.normal(prng.PRNGKey(seed), (500,)).numpy()
    np.testing.assert_allclose(nt, nj, atol=2e-6, rtol=1e-6)


@pytest.mark.parametrize("lo, hi", [(0, 4), (0, 10), (3, 70000), (-5, 2**31 - 1),
                                    (0, 1), (5, 5), (-2**31, 2**31 - 1)])
@pytest.mark.parametrize("seed", [0, 17, 2**31 - 1])
def test_randint(seed, lo, hi):
    """jax.random.randint (int32, partitionable threefry) bit for bit, over
    spans below and above 2**16 (where the uint32 multiplier wraps), an
    empty span and the full int32 range."""
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (700,), lo, hi))
    got = prng.randint(prng.PRNGKey(seed), (700,), lo, hi)
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want)
    shaped = prng.randint(prng.PRNGKey(seed), (3, 5), lo, hi).numpy()
    assert np.array_equal(shaped, np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (3, 5), lo, hi)))
