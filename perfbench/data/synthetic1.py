"""The paper's Synthetic 1 (Liu, Pan, Ho, KDD 2017, Section 7.1): related
tasks around three parents, made from a seed.

A frozen copy of ``synthetic`` (variant 1) from
``src/repro_torch/data/synthetic.py`` at commit 80b0bbf, numpy
``RandomState`` only, line for line, with one change: the per-task row
counts come from a fixed stream (``SIZES_SEED``), and the seed only orders
them, so every seed does the same work (the same rows in all, the same
padded size) on other data.
"""
from __future__ import annotations

import numpy as np

from perfbench.data.arrays import TaskArrays, logistic_labels, normalize

SIZES_SEED = 0


def generate(m: int, d: int, n_train_avg: int, n_test_avg: int, seed: int) -> TaskArrays:
    """Synthetic 1: parents {w1, w6, w11} ~ N(0, I), children = +-parent +
    noise, logistic labels; per-task counts Poisson around the averages."""
    rng = np.random.RandomState(seed)
    n_parents = 3
    parent_ids = [0, 5, 10]
    parents = rng.randn(n_parents, d).astype(np.float32)
    parents = normalize(parents) * 3.0

    W = np.zeros((m, d), np.float32)
    for i in range(m):
        if i in parent_ids:
            k, s = parent_ids.index(i), +1.0
        else:
            k = rng.randint(n_parents)
            s = rng.choice([+1.0, -1.0])
        W[i] = s * parents[k] + 0.1 * rng.randn(d)

    sizes = np.random.RandomState(SIZES_SEED)
    n_tr = rng.permutation(np.maximum(50, sizes.poisson(n_train_avg, m)))
    n_te = rng.permutation(np.maximum(20, sizes.poisson(n_test_avg, m)))

    def draw(n_i, wi):
        x = rng.randn(n_i, d).astype(np.float32) / np.sqrt(d)
        y = logistic_labels(x @ wi * np.sqrt(d) * 0.6, rng)
        return normalize(x).astype(np.float32), y

    out = TaskArrays([], [], [], [])
    for i in range(m):
        x, y = draw(int(n_tr[i]), W[i])
        out.xtr.append(x), out.ytr.append(y)
        x, y = draw(int(n_te[i]), W[i])
        out.xte.append(x), out.yte.append(y)
    return out
