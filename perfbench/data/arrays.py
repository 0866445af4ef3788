"""What every generator of ``data/`` returns, and the helpers they share.

A configuration file names its generator; the harness loads
``data/<generator>.py`` by that name (``spec.generator``) and calls its
``generate(seed=..., **params)``. Adding a dataset adds a file; no file
here changes. The harness hands the same arrays to the program (through
``repro_torch.core.mtl_data.from_task_list``) and to the reference.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class TaskArrays:
    """Per-task training and held-out rows: lists of (n_i, d) float32
    features and (n_i,) float32 labels in {-1, +1}."""

    xtr: List[np.ndarray]
    ytr: List[np.ndarray]
    xte: List[np.ndarray]
    yte: List[np.ndarray]


def logistic_labels(z: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    p = 1.0 / (1.0 + np.exp(-z))
    return np.where(rng.uniform(size=z.shape) < p, 1.0, -1.0).astype(np.float32)


def normalize(x: np.ndarray) -> np.ndarray:
    nrm = np.linalg.norm(x, axis=1, keepdims=True)
    return x / np.maximum(nrm, 1e-12)
