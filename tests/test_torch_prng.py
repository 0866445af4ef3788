"""repro_torch.prng against jax.random: keys, splits, folds and uniform
draws must be BIT-equal (every coordinate draw of the trainer rests on
them); normal agrees to float32 rounding (torch's erfinv is not XLA's);
gumbel and categorical, which the serving engine samples with, give JAX's
ids bit for bit in float32 and bfloat16. The round's draw
(``solver_backends.draw_task_uniform``, off the card) equals prng's
composition of keys and draw and JAX's per-task draws bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.core.solver_backends import draw_task_uniform

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


@pytest.mark.parametrize("pod", [0, 3])
@pytest.mark.parametrize("first", [0, 5])
@pytest.mark.parametrize("m, H", [(10, 12032), (16, 2048), (1, 1), (3, 1000)])
@pytest.mark.parametrize("seed", [0, 42, 2**31 - 1])
def test_draw_task_uniform(seed, m, H, first, pod):
    """A round's (m, H) uniforms from its round key: task ids from ``first``,
    each task's key fold_in(fold_in(key, t), pod), at both benchmark cells'
    shapes, one element and an H that is no multiple of 4."""
    key = prng.split(prng.PRNGKey(seed), 10)[3]
    tids = torch.arange(first, first + m, dtype=torch.int32)
    got = draw_task_uniform(key, tids, pod, H, "cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, H)
    composed = prng.uniform(prng.fold_in(prng.fold_in(key, tids), pod), (H,))
    assert torch.equal(got.view(torch.int32), composed.view(torch.int32))
    kj = jax.random.split(jax.random.PRNGKey(seed), 10)[3]
    want = jax.vmap(lambda t: jax.random.uniform(
        jax.random.fold_in(jax.random.fold_in(kj, t), pod), (H,)))(
        jnp.arange(first, first + m, dtype=jnp.int32))
    assert np.array_equal(np.asarray(want).view(np.int32), got.numpy().view(np.int32))


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


DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]
SHAPES = [(3, 257), (4, 1024), (2, 5, 100)]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dtypes", DTYPES, ids=["float32", "bfloat16"])
def test_gumbel(seed, dtypes):
    """The noise within a few float32 ulps of JAX's (torch's log is not
    XLA's; 1e-6 absolute on values up to about 16); bfloat16 bit-equal."""
    for shape in SHAPES:
        want = np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed), shape, dtypes[1]))
        got = prng.gumbel(prng.PRNGKey(seed), shape, dtypes[0])
        assert got.dtype == dtypes[0] and tuple(got.shape) == shape
        if dtypes[0] == torch.bfloat16:
            assert np.array_equal(got.float().numpy(), want.astype(np.float32))
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dtypes", DTYPES, ids=["float32", "bfloat16"])
def test_categorical(seed, dtypes):
    """The sampled ids equal jax.random.categorical's, over several keys and
    shapes (the last axis is the categories)."""
    for i, shape in enumerate(SHAPES):
        logits = (2.0 * np.random.RandomState(seed % 1000 + i).randn(*shape)).astype(np.float32)
        want = np.asarray(jax.random.categorical(
            jax.random.PRNGKey(seed), jnp.asarray(logits).astype(dtypes[1])))
        got = prng.categorical(prng.PRNGKey(seed), torch.from_numpy(logits).to(dtypes[0]))
        assert np.array_equal(got.numpy(), want)


def test_categorical_over_a_prefix_of_the_columns():
    """``vocab`` keeps the noise of every column (JAX's draws) and lets only
    the first ``vocab`` columns win: equal ids wherever JAX picks one of
    them, never an id past ``vocab``."""
    logits = np.random.RandomState(3).randn(64, 300).astype(np.float32)
    logits[:, 256:] += 2.0  # the padded columns would often win
    want = np.asarray(jax.random.categorical(jax.random.PRNGKey(7), jnp.asarray(logits)))
    got = prng.categorical(prng.PRNGKey(7), torch.from_numpy(logits), vocab=256).numpy()
    assert (got < 256).all() and (want >= 256).any()
    assert np.array_equal(got[want < 256], want[want < 256])
