"""Paper datasets (Section 7.1), reproduced generatively.

The three real-world datasets are not shipped, so they are replaced by
statistically matched stand-ins with the SAME shape/statistics as Table 1
(task counts, instance counts, dims, per-task imbalance) and the same
qualitative structure the paper's claims rely on:

 * synthetic1 / synthetic2  -- exactly the paper's recipe (3 parent tasks,
   children = +-parent + noise, logistic labels); synthetic2 re-draws the
   parents with strong mutual correlation so that rho is larger.
 * school_like   -- 139 regression tasks, d=27(+bias)=28, ~83 train/task,
   task weights drawn from a 3-cluster prior + per-school noise, continuous
   exam-score-like targets.
 * mnist_like    -- 10 one-vs-all binary tasks over d=784 with large
   per-task sample counts (data-rich regime where STL ~ MTL, the paper's
   MNIST observation). Digits are synthesized as class-template blobs +
   pixel noise in [0,1]^784.
 * mds_like      -- 22 sentiment tasks, d=10,000 sparse (0.9% density),
   n_i ranging 314..20,751 (heavy imbalance — the regime where the paper
   reports DMTRL >> STL because small tasks borrow strength).

This is a line-for-line copy of ``repro.data.synthetic`` (numpy
``RandomState`` only) that returns the port's tensor ``MTLData``, so both
packages build identical problems from one seed. The arrays land on the
CPU; the trainer moves them to its device.
"""
from __future__ import annotations

import dataclasses
import numpy as np

from ..core.mtl_data import MTLData, from_task_list, train_test_split_tasks


@dataclasses.dataclass
class MTLSplits:
    train: MTLData
    test: MTLData
    W_true: np.ndarray | None = None  # ground-truth weights when synthetic
    corr_true: np.ndarray | None = None  # ground-truth task correlation


def _logistic_labels(z: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    p = 1.0 / (1.0 + np.exp(-z))
    return np.where(rng.uniform(size=z.shape) < p, 1.0, -1.0).astype(np.float32)


def _normalize(x: np.ndarray) -> np.ndarray:
    nrm = np.linalg.norm(x, axis=1, keepdims=True)
    return x / np.maximum(nrm, 1e-12)


def synthetic(
    variant: int = 1,
    m: int = 16,
    d: int = 100,
    n_train_avg: int = 1894,
    n_test_avg: int = 811,
    seed: int = 0,
) -> MTLSplits:
    """Paper Synthetic 1 / 2.

    Variant 1: parents {w1, w6, w11} ~ N(0, I) (nearly orthogonal =>
    weaker cross-group correlation, smaller rho).
    Variant 2: same data xs but parents drawn with strong mutual correlation
    (parents share a common component) => larger rho. The paper reports
    rho = 6.24 (syn1) vs 12.95 (syn2).
    """
    rng = np.random.RandomState(seed)
    n_parents = 3
    parent_ids = [0, 5, 10]

    parents = rng.randn(n_parents, d).astype(np.float32)
    if variant == 2:
        common = rng.randn(1, d).astype(np.float32)
        parents = 0.35 * parents + 1.0 * common  # strongly correlated parents
    parents = _normalize(parents) * 3.0

    W = np.zeros((m, d), np.float32)
    signs = np.zeros(m)
    assign = np.zeros(m, int)
    for i in range(m):
        if i in parent_ids:
            k, s = parent_ids.index(i), +1.0
        else:
            k = rng.randint(n_parents)
            s = rng.choice([+1.0, -1.0])
        assign[i], signs[i] = k, s
        W[i] = s * parents[k] + 0.1 * rng.randn(d)
    corr_true = np.corrcoef(W)

    # per-task sample counts around the paper's averages
    n_tr = np.maximum(50, rng.poisson(n_train_avg, m))
    n_te = np.maximum(20, rng.poisson(n_test_avg, m))

    def draw(n_i, wi):
        x = rng.randn(n_i, d).astype(np.float32) / np.sqrt(d)
        y = _logistic_labels(x @ wi * np.sqrt(d) * 0.6, rng)
        return _normalize(x).astype(np.float32), y

    xtr, ytr, xte, yte = [], [], [], []
    for i in range(m):
        x, y = draw(int(n_tr[i]), W[i])
        xtr.append(x), ytr.append(y)
        x, y = draw(int(n_te[i]), W[i])
        xte.append(x), yte.append(y)

    return MTLSplits(
        train=from_task_list(xtr, ytr),
        test=from_task_list(xte, yte),
        W_true=W,
        corr_true=corr_true,
    )


def school_like(
    m: int = 139, d: int = 27, n_avg: int = 111, seed: int = 0
) -> MTLSplits:
    """School-like regression: m tasks, d features (+1 bias appended = 28),
    70/30-ish split matching ~83 train / ~28 test per task."""
    rng = np.random.RandomState(seed + 1)
    n_clusters = 3
    centers = rng.randn(n_clusters, d + 1).astype(np.float32) * 1.5
    xs, ys, Wt = [], [], np.zeros((m, d + 1), np.float32)
    for i in range(m):
        k = rng.randint(n_clusters)
        wi = centers[k] + 0.4 * rng.randn(d + 1)
        Wt[i] = wi
        n_i = max(20, rng.poisson(n_avg))
        x = rng.randn(n_i, d).astype(np.float32)
        x = np.concatenate([x, np.ones((n_i, 1), np.float32)], axis=1)  # bias
        x = _normalize(x)
        y = x @ wi + 0.35 * rng.randn(n_i)
        xs.append(x.astype(np.float32)), ys.append(y.astype(np.float32))
    xtr, ytr, xte, yte = train_test_split_tasks(xs, ys, 0.75, seed)
    return MTLSplits(
        train=from_task_list(xtr, ytr),
        test=from_task_list(xte, yte, n_max=from_task_list(xtr, ytr).n_max),
        W_true=Wt,
        corr_true=np.corrcoef(Wt),
    )


def mnist_like(
    n_classes: int = 10,
    d: int = 784,
    n_per_task_train: int = 12000,
    n_per_task_test: int = 2000,
    seed: int = 0,
    scale: float = 1.0,
) -> MTLSplits:
    """10 one-vs-all tasks, data-rich (paper: STL ~ DMTRL here)."""
    rng = np.random.RandomState(seed + 2)
    side = int(np.sqrt(d))
    templates = np.zeros((n_classes, d), np.float32)
    for c in range(n_classes):
        img = np.zeros((side, side), np.float32)
        # class-specific blob pattern: a few gaussian bumps per class
        for _ in range(3 + c % 4):
            cx, cy = rng.randint(4, side - 4, size=2)
            xx, yy = np.meshgrid(np.arange(side), np.arange(side))
            img += np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2.0 * 2.5**2))
        templates[c] = img.reshape(-1) / max(img.max(), 1e-6)

    n_tr = int(n_per_task_train * scale)
    n_te = int(n_per_task_test * scale)

    def draw_task(c, n_i):
        half = n_i // 2
        pos = templates[c][None, :] + 0.55 * rng.rand(half, d).astype(np.float32)
        neg_classes = rng.choice([k for k in range(n_classes) if k != c], n_i - half)
        neg = templates[neg_classes] + 0.55 * rng.rand(n_i - half, d).astype(np.float32)
        x = np.concatenate([pos, neg]).astype(np.float32)
        y = np.concatenate([np.ones(half), -np.ones(n_i - half)]).astype(np.float32)
        # ~3% label noise keeps the task non-degenerate (error > 0)
        flip = rng.uniform(size=n_i) < 0.03
        y = np.where(flip, -y, y).astype(np.float32)
        p = rng.permutation(n_i)
        return _normalize(x[p]), y[p]

    xtr, ytr, xte, yte = [], [], [], []
    for c in range(n_classes):
        x, y = draw_task(c, n_tr)
        xtr.append(x), ytr.append(y)
        x, y = draw_task(c, n_te)
        xte.append(x), yte.append(y)
    ntr = from_task_list(xtr, ytr)
    return MTLSplits(
        train=ntr, test=from_task_list(xte, yte, n_max=ntr.n_max)
    )


def mds_like(
    m: int = 22,
    d: int = 10000,
    density: float = 0.009,
    n_min: int = 314,
    n_max_task: int = 20751,
    seed: int = 0,
    scale: float = 1.0,
) -> MTLSplits:
    """22 sparse sentiment-like tasks with heavy size imbalance.

    A shared global sentiment direction + per-domain deviations: the regime
    where the paper reports DMTRL >> STL (small tasks borrow strength).
    ``scale`` shrinks n_i and d for fast CI runs while keeping imbalance.
    """
    rng = np.random.RandomState(seed + 3)
    d = max(64, int(d * scale))
    shared = rng.randn(d).astype(np.float32)
    shared /= np.linalg.norm(shared)

    # log-uniform task sizes in [n_min, n_max_task]
    sizes = np.exp(
        rng.uniform(np.log(n_min), np.log(n_max_task), size=m)
    ).astype(int)
    sizes = np.maximum(8, (sizes * scale).astype(int))

    nnz = max(8, int(3 * density * d))  # "review length" in active features
    # "sentiment lexicon": a quarter of the vocabulary carries a strong
    # SHARED polarity (+-1); per-domain deviation is mild. This is the
    # regime the paper's MDS experiment exercises: small domains cannot
    # estimate the lexicon alone and borrow strength through Sigma.
    lex = rng.choice(d, d // 4, replace=False)
    w_shared = np.zeros(d, np.float32)
    w_shared[lex] = rng.choice([-1.0, 1.0], size=lex.shape[0]).astype(np.float32)
    xs, ys = [], []
    for i in range(m):
        wi = w_shared + 0.3 * rng.randn(d).astype(np.float32)
        n_i = int(sizes[i])
        rows = np.zeros((n_i, d), np.float32)
        for r in range(n_i):
            idx = rng.choice(d, nnz, replace=False)
            rows[r, idx] = rng.rand(nnz).astype(np.float32) + 0.2
        rows = _normalize(rows)
        y = _logistic_labels(10.0 * rows @ wi, rng)
        xs.append(rows), ys.append(y)
    xtr, ytr, xte, yte = train_test_split_tasks(xs, ys, 0.7, seed)
    ntr = from_task_list(xtr, ytr)
    return MTLSplits(
        train=ntr,
        test=from_task_list(xte, yte, n_max=max(ntr.n_max, max(len(v) for v in yte))),
    )


DATASETS = {
    "synthetic1": lambda **kw: synthetic(1, **kw),
    "synthetic2": lambda **kw: synthetic(2, **kw),
    "school_like": school_like,
    "mnist_like": mnist_like,
    "mds_like": mds_like,
}
