"""Port's flash-attention layer against the JAX package's, on the CPU.

The same numpy inputs go through the JAX ``flash_attention`` (Pallas, in
interpret mode, as tests/test_kernels.py runs it) and through the port's
``ops.flash_attention``, which runs the kernel's plain version on CPU
tensors. Bars: fp32 1e-5 for the kernel and 2e-5 for the padded (B, S, H,
HD) wrapper, those of tests/test_kernels.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash import flash_attention as jax_flash
from repro.kernels.flash.ops import flash_attention_bshd as jax_bshd
from repro.kernels.flash.ref import attention_ref as jax_ref
from repro_torch.kernels.flash import ops, ref

# the fast shapes of tests/test_kernels.py::test_flash_vs_ref
SHAPES = [
    (2, 3, 256, 64, True, 0),
    (1, 2, 128, 32, True, 48),
    (1, 1, 64, 16, True, 16),
]


def _qkv(seed, shape):
    rs = np.random.RandomState(seed)
    return [rs.randn(*shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("B,H,S,HD,causal,window", SHAPES)
def test_flash_matches_jax_kernel(B, H, S, HD, causal, window):
    q, k, v = _qkv(S + HD, (B, H, S, HD))
    out = ops.flash_attention(
        *map(torch.from_numpy, (q, k, v)), causal, window, block_q=64, block_k=64
    )
    want = jax_flash(*map(jnp.asarray, (q, k, v)), causal, window, block_q=64, block_k=64)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("B,H,S,HD,causal,window", SHAPES + [(1, 2, 96, 16, False, 0)])
def test_attention_ref_matches_jax_ref(B, H, S, HD, causal, window):
    q, k, v = _qkv(7 * S + HD, (B, H, S, HD))
    out = ref.attention_ref(*map(torch.from_numpy, (q, k, v)), causal, window)
    want = jax_ref(*map(jnp.asarray, (q, k, v)), causal, window)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("S,block", [(200, 64), (17, 128), (300, 128)])
def test_flash_bshd_with_padding_matches_jax(S, block):
    q, k, v = _qkv(S, (2, S, 2, 64))
    out = ops.flash_attention_bshd(
        *map(torch.from_numpy, (q, k, v)), causal=True, block_q=block, block_k=block
    )
    want = jax_bshd(*map(jnp.asarray, (q, k, v)), causal=True, block_q=block, block_k=block)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=2e-5)
