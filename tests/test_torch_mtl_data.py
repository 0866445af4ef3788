"""The port's MTLData helpers and synthetic generators against the JAX
package's: the same numpy inputs give the same padded arrays."""
import numpy as np
import pytest
import torch

from repro.core import mtl_data as jm
from repro.data import synthetic as js
from repro_torch.core import mtl_data as tm
from repro_torch.data import synthetic as ts


def _lists(seed=0, m=3, d=5):
    rs = np.random.RandomState(seed)
    ns = [4, 9, 6][:m]
    xs = [rs.randn(n, d).astype(np.float32) for n in ns]
    ys = [np.sign(rs.randn(n)).astype(np.float32) for n in ns]
    return xs, ys


def _same(t: tm.MTLData, j: jm.MTLData):
    for f in ("x", "y", "mask", "n"):
        a, b = getattr(t, f).numpy(), np.asarray(getattr(j, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.parametrize("n_max", [None, 12])
def test_from_task_list(n_max):
    xs, ys = _lists()
    _same(tm.from_task_list(xs, ys, n_max=n_max), jm.from_task_list(xs, ys, n_max=n_max))


def test_pad_tasks_and_accessors():
    xs, ys = _lists()
    t, j = tm.from_task_list(xs, ys), jm.from_task_list(xs, ys)
    _same(t.pad_tasks(5), j.pad_tasks(5))
    assert (t.m, t.n_max, t.d) == (j.m, j.n_max, j.d)
    xt, yt, nt = t.task(1)
    xj, yj, nj = j.task(1)
    assert nt == nj and np.array_equal(xt.numpy(), np.asarray(xj))
    assert t.pad_tasks(3) is t
    with pytest.raises(ValueError):
        t.pad_tasks(2)


def test_normalize_rows():
    xs, ys = _lists(seed=2)
    t = tm.normalize_rows(tm.from_task_list(xs, ys), max_norm=0.5)
    j = jm.normalize_rows(jm.from_task_list(xs, ys), max_norm=0.5)
    np.testing.assert_allclose(t.x.numpy(), np.asarray(j.x), atol=1e-7)


def test_train_test_split_tasks():
    xs, ys = _lists(seed=3)
    for a, b in zip(tm.train_test_split_tasks(xs, ys, 0.7, 4),
                    jm.train_test_split_tasks(xs, ys, 0.7, 4)):
        for u, v in zip(a, b):
            assert np.array_equal(u, v)


@pytest.mark.parametrize("name,kw", [
    ("synthetic1", dict(m=5, d=12, n_train_avg=30, n_test_avg=10, seed=2)),
    ("synthetic2", dict(m=4, d=9, n_train_avg=25, n_test_avg=8, seed=0)),
    ("school_like", dict(m=6, d=5, n_avg=20, seed=1)),
    ("mnist_like", dict(d=196, n_per_task_train=30, n_per_task_test=10, seed=0)),
    ("mds_like", dict(scale=0.01, seed=0)),
])
def test_generators_identical(name, kw):
    t, j = ts.DATASETS[name](**kw), js.DATASETS[name](**kw)
    _same(t.train, j.train)
    _same(t.test, j.test)


def test_to_device_is_identity_on_same_device():
    xs, ys = _lists()
    t = tm.from_task_list(xs, ys)
    assert t.to("cpu") is t and t.device == torch.device("cpu")
