"""The paper's MNIST (Liu, Pan, Ho, KDD 2017, Section 7.1 and Table 1):
one-vs-all tasks made from a seed.

A frozen copy of ``mnist_like`` from ``src/repro_torch/data/synthetic.py``
at commit 80b0bbf, numpy ``RandomState`` only, line for line.
"""
from __future__ import annotations

import numpy as np

from perfbench.data.arrays import TaskArrays, normalize


def generate(n_classes: int, d: int, n_per_task_train: int, n_per_task_test: int,
             seed: int, scale: float = 1.0) -> TaskArrays:
    """10 one-vs-all tasks over d = 784: class-template blobs plus pixel
    noise in [0, 1]^784, about 3 % label noise, unit-norm rows."""
    rng = np.random.RandomState(seed + 2)
    side = int(np.sqrt(d))
    templates = np.zeros((n_classes, d), np.float32)
    for c in range(n_classes):
        img = np.zeros((side, side), np.float32)
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
        flip = rng.uniform(size=n_i) < 0.03
        y = np.where(flip, -y, y).astype(np.float32)
        p = rng.permutation(n_i)
        return normalize(x[p]), y[p]

    out = TaskArrays([], [], [], [])
    for c in range(n_classes):
        x, y = draw_task(c, n_tr)
        out.xtr.append(x), out.ytr.append(y)
        x, y = draw_task(c, n_te)
        out.xte.append(x), out.yte.append(y)
    return out
