"""The paper's MDS (Liu, Pan, Ho, KDD 2017, Section 7.1 and Table 1):
Blitzer et al.'s multi-domain sentiment reviews, one binary classifier a
product domain, made from a seed.

The statistics of ``mds_like`` in ``src/repro_torch/data/synthetic.py``
(commit 4848c65), drawn with numpy ``RandomState`` in bulk rather than row
by row:
  * each review is a bag of words: ``nnz`` distinct active columns of d,
    values U[0.2, 1.2), the row normalised to unit length;
  * a shared sentiment lexicon over a quarter of the vocabulary at +-1, and
    a per-domain deviation of 0.3 N(0, 1) a column;
  * labels logistic in 10 x . w_i;
  * the first ``frac_train`` of each domain's reviews (rounded down) for
    training, the rest held out.
The domain sizes come from a fixed stream (``SIZES_SEED``), log-uniform
between ``n_min`` and ``n_max`` with the smallest and largest pinned to
them, so every seed does the same work; the seed orders them over the
domains and draws the reviews.
"""
from __future__ import annotations

import numpy as np

from perfbench.data.arrays import TaskArrays, logistic_labels

SIZES_SEED = 0


def domain_sizes(m: int, n_min: int, n_max: int) -> np.ndarray:
    """The m domain sizes, log-uniform on [n_min, n_max] from the fixed
    stream, the smallest set to n_min and the largest to n_max."""
    rs = np.random.RandomState(SIZES_SEED)
    sizes = np.exp(rs.uniform(np.log(n_min), np.log(n_max), size=m)).astype(np.int64)
    sizes[np.argmin(sizes)] = n_min
    sizes[np.argmax(sizes)] = n_max
    return sizes


def distinct_columns(rng: np.random.RandomState, n: int, d: int, nnz: int) -> np.ndarray:
    """(n, nnz) column ids, distinct within each row, each row a uniform
    draw of nnz of the d columns: the first nnz distinct values of a row of
    uniform draws with replacement (rows short of nnz are drawn again)."""
    out = np.empty((n, nnz), np.int64)
    todo = np.arange(n)
    extra = nnz + max(8, 4 * int(np.ceil(nnz * nnz / d)))
    small = np.int16 if d <= np.iinfo(np.int16).max else np.int64  # numpy radix-sorts int16
    while todo.size:
        draw = rng.randint(0, d, size=(todo.size, extra)).astype(small)
        order = np.argsort(draw, axis=1, kind="stable")
        srt = np.take_along_axis(draw, order, axis=1)
        dup_sorted = np.zeros_like(srt, dtype=bool)
        dup_sorted[:, 1:] = srt[:, 1:] == srt[:, :-1]
        first = np.empty_like(dup_sorted)
        np.put_along_axis(first, order, ~dup_sorted, axis=1)
        keep = first & (np.cumsum(first, axis=1) <= nnz)
        whole = keep.sum(axis=1) == nnz
        out[todo[whole]] = draw[whole][keep[whole]].reshape(-1, nnz)
        todo = todo[~whole]
    return out


def _dense(cols: np.ndarray, vals: np.ndarray, d: int) -> np.ndarray:
    x = np.zeros((cols.shape[0], d), np.float32)
    np.put_along_axis(x, cols, vals, axis=1)
    return x


def generate(m: int, d: int, nnz: int, n_min: int, n_max: int, frac_train: float,
             seed: int) -> TaskArrays:
    """m domains of reviews over d words, about nnz / d dense."""
    rng = np.random.RandomState(seed)
    lex = rng.choice(d, d // 4, replace=False)
    w_shared = np.zeros(d, np.float32)
    w_shared[lex] = rng.choice([-1.0, 1.0], size=lex.shape[0]).astype(np.float32)
    sizes = rng.permutation(domain_sizes(m, n_min, n_max))
    out = TaskArrays([], [], [], [])
    for n_i in sizes:
        n_i = int(n_i)
        wi = w_shared + 0.3 * rng.randn(d).astype(np.float32)
        cols = distinct_columns(rng, n_i, d, nnz)
        vals = rng.rand(n_i, nnz) + 0.2
        vals = (vals / np.linalg.norm(vals, axis=1, keepdims=True)).astype(np.float32)
        z = 10.0 * np.sum(vals * wi[cols], axis=1, dtype=np.float64)
        y = logistic_labels(z, rng)
        k = int(frac_train * n_i)
        for xs, ys, rows in ((out.xtr, out.ytr, slice(0, k)), (out.xte, out.yte, slice(k, n_i))):
            xs.append(_dense(cols[rows], vals[rows], d))
            ys.append(y[rows])
    return out

