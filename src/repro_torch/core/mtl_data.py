"""Padded multi-task dataset container.

Tasks have unequal sample counts n_i; to batch over tasks we pad every task
to ``n_max`` and carry a validity mask. Padded coordinates never get sampled
by SDCA (indices are drawn in [0, n_i)) and carry zero weight in all
objective evaluations.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class MTLData:
    """m tasks padded to a common n_max.

    x:    (m, n_max, d) float32  features (phi already applied)
    y:    (m, n_max)    float32  labels (+-1 classification / real regression)
    mask: (m, n_max)    float32  1.0 on real samples, 0.0 on padding
    n:    (m,)          int32    true per-task sample counts
    """

    x: torch.Tensor
    y: torch.Tensor
    mask: torch.Tensor
    n: torch.Tensor

    @property
    def m(self) -> int:
        return self.x.shape[0]

    @property
    def n_max(self) -> int:
        return self.x.shape[1]

    @property
    def d(self) -> int:
        return self.x.shape[2]

    @property
    def device(self) -> torch.device:
        return self.x.device

    def to(self, device) -> "MTLData":
        """The same data on ``device`` (self when it is already there)."""
        device = torch.device(device)
        if self.x.device == device:
            return self
        return MTLData(*(t.to(device) for t in (self.x, self.y, self.mask, self.n)))

    def task(self, i: int) -> Tuple[torch.Tensor, torch.Tensor, int]:
        ni = int(self.n[i])
        return self.x[i, :ni], self.y[i, :ni], ni

    def pad_tasks(self, m_new: int) -> "MTLData":
        """Pad the task axis to ``m_new`` with empty (all-masked) tasks."""
        if m_new == self.m:
            return self
        if m_new < self.m:
            raise ValueError(f"cannot pad {self.m} tasks down to {m_new}")
        pad = m_new - self.m

        def z(a):
            return torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))], dim=0)

        # n=1 on padded tasks keeps 1/n_i finite; mask stays 0 so they are inert.
        n_pad = torch.cat([self.n, self.n.new_ones((pad,))])
        return MTLData(z(self.x), z(self.y), z(self.mask), n_pad)


def from_task_list(
    xs: Sequence[np.ndarray],
    ys: Sequence[np.ndarray],
    n_max: int | None = None,
    device="cpu",
) -> MTLData:
    """Build padded MTLData from per-task (n_i, d) / (n_i,) numpy arrays."""
    m = len(xs)
    if m == 0 or m != len(ys):
        raise ValueError(f"need one label array per task, got {m} and {len(ys)}")
    d = xs[0].shape[1]
    ns = [int(x.shape[0]) for x in xs]
    n_max = n_max or max(ns)
    X = np.zeros((m, n_max, d), np.float32)
    Y = np.zeros((m, n_max), np.float32)
    M = np.zeros((m, n_max), np.float32)
    for i, (x, y) in enumerate(zip(xs, ys)):
        ni = ns[i]
        if ni > n_max:
            raise ValueError(f"task {i} has {ni} > n_max={n_max}")
        X[i, :ni] = x
        Y[i, :ni] = np.asarray(y).reshape(-1)
        M[i, :ni] = 1.0
    return MTLData(
        torch.from_numpy(X).to(device),
        torch.from_numpy(Y).to(device),
        torch.from_numpy(M).to(device),
        torch.tensor(ns, dtype=torch.int32, device=device),
    )


def normalize_rows(data: MTLData, max_norm: float = 1.0) -> MTLData:
    """Scale every sample to ||x|| <= max_norm (the theory in Lemma 7 assumes
    normalized features; the algorithm itself does not require it)."""
    norms = torch.linalg.vector_norm(data.x, dim=-1, keepdim=True)
    scale = torch.clamp(max_norm / torch.clamp(norms, min=1e-12), max=1.0)
    return MTLData(data.x * scale, data.y, data.mask, data.n)


def train_test_split_tasks(
    xs: List[np.ndarray],
    ys: List[np.ndarray],
    frac_train: float,
    seed: int,
) -> Tuple[List[np.ndarray], List[np.ndarray], List[np.ndarray], List[np.ndarray]]:
    rng = np.random.RandomState(seed)
    xtr, ytr, xte, yte = [], [], [], []
    for x, y in zip(xs, ys):
        n = x.shape[0]
        perm = rng.permutation(n)
        k = max(1, int(round(frac_train * n)))
        k = min(k, n - 1) if n > 1 else 1
        tr, te = perm[:k], perm[k:]
        xtr.append(x[tr]), ytr.append(y[tr])
        xte.append(x[te]), yte.append(y[te])
    return xtr, ytr, xte, yte
