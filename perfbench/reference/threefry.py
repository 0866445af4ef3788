"""Counter-based threefry2x32 draws in numpy, as ``jax.random`` makes them
in its partitionable mode.

A frozen copy of the arithmetic of ``src/repro_torch/prng.py`` at commit
80b0bbf (``threefry2x32``, ``PRNGKey``, ``split``, ``fold_in`` and
``uniform``), written against numpy's uint32 so that the reference draws
the coordinates that the program draws, without calling the program.
"""
from __future__ import annotations

import numpy as np

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32, 20 rounds, on uint32 arrays that broadcast together."""
    with np.errstate(over="ignore"):
        k1, k2 = np.asarray(k1, np.uint32), np.asarray(k2, np.uint32)
        ks = (k1, k2, k1 ^ k2 ^ _PARITY)
        x = [np.asarray(x1, np.uint32) + ks[0], np.asarray(x2, np.uint32) + ks[1]]
        for i in range(5):
            for r in _ROT[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def key(seed: int) -> np.ndarray:
    """``PRNGKey(seed)``: the words (0, seed mod 2**32)."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def _hash_iota(keys: np.ndarray, shape: tuple):
    n = int(np.prod(shape))
    counts = np.arange(n, dtype=np.uint64).reshape(shape)
    hi = (counts >> np.uint64(32)).astype(np.uint32)
    lo = (counts & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    batch = keys.shape[:-1]
    k1 = keys[..., 0].reshape(batch + (1,) * len(shape))
    k2 = keys[..., 1].reshape(batch + (1,) * len(shape))
    return threefry2x32(k1, k2, hi, lo)


def split(keys: np.ndarray, num: int = 2) -> np.ndarray:
    """``split``: (*batch, num, 2) new keys."""
    b1, b2 = _hash_iota(keys, (num,))
    return np.stack([b1, b2], axis=-1)


def fold_in(keys: np.ndarray, data) -> np.ndarray:
    """``fold_in``: hash the counter pair (0, data mod 2**32)."""
    data = np.asarray(data, np.int64) & 0xFFFFFFFF
    b1, b2 = threefry2x32(keys[..., 0], keys[..., 1], np.zeros_like(data), data)
    return np.stack(np.broadcast_arrays(b1, b2), axis=-1)


def uniform(keys: np.ndarray, shape: tuple) -> np.ndarray:
    """float32 draws in [0, 1), one stream per key of the batch."""
    b1, b2 = _hash_iota(keys, shape)
    bits = (b1 ^ b2) >> np.uint32(9) | np.uint32(0x3F800000)
    return bits.view(np.float32) - np.float32(1.0)
