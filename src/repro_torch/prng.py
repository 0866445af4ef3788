"""Counter-based threefry2x32 keys, bit-equal to ``jax.random``.

Every coordinate draw of the trainer comes from this module: the per-task
round keys are ``fold_in(fold_in(key, t), 0)``, the per-round keys come
from ``split``, and the local solvers map ``uniform`` draws to coordinates.
Matching JAX bit for bit makes the port walk the same iterate sequence as
the JAX package from the same seed.

The mode matched is the partitionable threefry (``jax_threefry_partitionable
=True``), where element ``i`` of a draw of shape ``s`` hashes the 64-bit
counter ``i`` (row-major over ``s``) as the pair ``(i >> 32, i & 0xFFFFFFFF)``.

A key is an int64 tensor whose last dimension holds the two uint32 words.
Leading dimensions are a batch of keys: ``uniform(keys (m, 2), (H,))``
returns ``(m, H)``, one independent stream per key, which is how the
trainer draws for all tasks at once. uint32 arithmetic is done in int64
with a ``0xFFFFFFFF`` mask (torch has no full uint32 arithmetic).
"""
from __future__ import annotations

import math
from typing import Sequence, Union

import torch

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Shape = Union[int, Sequence[int]]


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x & _MASK


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(
    k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor
):
    """The Threefry-2x32 hash (20 rounds) of counter words (x1, x2) under
    key words (k1, k2); all int64 tensors holding uint32 values, broadcast
    together. Returns the two output words."""
    ks = (k1, k2, (k1 ^ k2 ^ _PARITY) & _MASK)
    x = [_u32(x1 + ks[0]), _u32(x2 + ks[1])]
    for i in range(5):
        for r in _ROT[i % 2]:
            x[0] = _u32(x[0] + x[1])
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = _u32(x[0] + ks[(i + 1) % 3])
        x[1] = _u32(x[1] + ks[(i + 2) % 3] + (i + 1))
    return x[0], x[1]


def PRNGKey(seed: int) -> torch.Tensor:
    """Key from an integer seed, as ``jax.random.PRNGKey`` (32-bit mode):
    the words are (0, seed mod 2**32)."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64)


def _shape(shape: Shape) -> tuple:
    return (int(shape),) if isinstance(shape, int) else tuple(int(s) for s in shape)


def _hash_iota(key: torch.Tensor, shape: tuple, device):
    """threefry of the row-major 64-bit iota over ``shape`` under each key
    of the batch ``key (..., 2)``; returns two (..., *shape) word tensors."""
    key = key.to(device)
    n = math.prod(shape)
    counts = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    batch = key.shape[:-1]
    k1 = key[..., 0].reshape(batch + (1,) * len(shape))
    k2 = key[..., 1].reshape(batch + (1,) * len(shape))
    return threefry2x32(k1, k2, counts >> 32, counts & _MASK)


def split(key: torch.Tensor, num: Shape = 2) -> torch.Tensor:
    """``jax.random.split``: ``num`` new keys, shape (*key_batch, *num, 2)."""
    shape = _shape(num)
    b1, b2 = _hash_iota(key, shape, key.device)
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: hash the counter pair (0, data mod 2**32).
    ``data`` may be an int or an integer tensor broadcasting against the
    key batch (one fold per task, say)."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _MASK
    b1, b2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(b1, b2), dim=-1)


def random_bits(key: torch.Tensor, shape: Shape, device=None) -> torch.Tensor:
    """32 random bits per element (as int64 in [0, 2**32))."""
    b1, b2 = _hash_iota(key, _shape(shape), device or key.device)
    return b1 ^ b2


def uniform(
    key: torch.Tensor,
    shape: Shape = (),
    dtype: torch.dtype = torch.float32,
    minval: float = 0.0,
    maxval: float = 1.0,
    device=None,
) -> torch.Tensor:
    """``jax.random.uniform`` in float32: the top 23 bits become the
    mantissa of a float in [1, 2), minus 1, then scaled into
    [minval, maxval). ``device`` places the draw (default: the key's)."""
    if dtype != torch.float32:
        raise TypeError(f"uniform draws float32 only, got {dtype}")
    bits = random_bits(key, shape, device)
    fbits = (bits >> 9) | 0x3F800000
    floats = fbits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=dtype, device=floats.device)
    scale = torch.tensor(maxval, dtype=dtype, device=floats.device) - lo
    # XLA fuses floats * scale + lo into one fused multiply-add: the
    # float32 product is exact in float64, so one rounding matches it
    fused = (floats.double() * scale.double() + lo.double()).to(dtype)
    return torch.maximum(lo, fused)


def randint(
    key: torch.Tensor, shape: Shape, minval: int, maxval: int, device=None
) -> torch.Tensor:
    """``jax.random.randint`` for int32 draws in [minval, maxval): the key
    splits in two, each half gives 32 random bits per element, and the
    pair is reduced modulo the span as JAX does (in uint32 arithmetic, so
    products and sums wrap at 2**32). Returned as int64 holding the same
    values. A span of 0 or less returns ``minval`` everywhere, as JAX."""
    shape = _shape(shape)
    pair = split(key, 2)
    hi = random_bits(pair[..., 0, :], shape, device)
    lo = random_bits(pair[..., 1, :], shape, device)
    span = (int(maxval) - int(minval)) & _MASK if maxval > minval else 1
    mult = ((2**16 % span) ** 2 & _MASK) % span
    off = (((hi % span) * mult) & _MASK) + lo % span
    return int(minval) + (off & _MASK) % span


def normal(
    key: torch.Tensor, shape: Shape = (), dtype: torch.dtype = torch.float32,
    device=None,
) -> torch.Tensor:
    """``jax.random.normal``: sqrt(2) * erfinv(u), u uniform in
    (nextafter(-1, 0), 1). The uniform draw is bit-equal to JAX's; erfinv
    is torch's, so values agree to float32 rounding, not bit for bit."""
    lo = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
    u = uniform(key, shape, dtype, lo, 1.0, device)
    return math.sqrt(2.0) * torch.special.erfinv(u)
