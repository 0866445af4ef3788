"""Port's flash-attention layer against the JAX package's, on the CPU.

The same numpy inputs go through the JAX ``flash_attention`` (Pallas, in
interpret mode, as tests/test_kernels.py runs it) and through the port's
``ops.flash_attention``, which runs the kernel's plain version on CPU
tensors. Bars: fp32 1e-5 for the kernel and 2e-5 for the padded (B, S, H,
HD) wrapper, those of tests/test_kernels.py.

Also a plain emulation of the card's bf16 kernel (64-key blocks, online
softmax in the log2 domain, P rounded to bf16 before P V) against the JAX
kernel on bf16 inputs, at the bf16 bar 2e-2.
"""
import math

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


def _bf16_kernel_emulation(q, k, v, causal, window, block=64):
    """What flash_fwd_bf16_kernel computes, in plain torch: scores in fp32
    from bf16 operands, times scale * log2(e); the -1e30 sentinel; per 64-key
    block the running max, exp2, the fp32 sum, and P rounded to bf16 before
    P V with fp32 accumulation; acc / max(l, 1e-30) rounded to bf16."""
    S, HD = q.shape[2], q.shape[3]
    Sk = k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (
        (1.0 / math.sqrt(HD)) * math.log2(math.e))
    qpos = torch.arange(S)[:, None]
    kpos = torch.arange(Sk)[None, :]
    keep = torch.ones((S, Sk), dtype=torch.bool)
    if causal:
        keep &= kpos <= qpos
    if window > 0:
        keep &= kpos > qpos - window
    s = torch.where(keep, s, torch.full_like(s, -1e30))
    m = torch.full(s.shape[:3], -1e30)
    l = torch.zeros(s.shape[:3])
    acc = torch.zeros(q.shape)
    for k0 in range(0, Sk, block):
        sb = s[..., k0:k0 + block]
        m_new = torch.maximum(m, sb.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(sb - m_new[..., None])
        l = l * corr + p.sum(-1)
        pv = torch.einsum("bhqk,bhkd->bhqd", p.to(torch.bfloat16).float(),
                          v[:, :, k0:k0 + block].float())
        acc = acc * corr[..., None] + pv
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(torch.bfloat16)


@pytest.mark.parametrize("window", [0, 100])
def test_bf16_kernel_rounding_matches_jax(window):
    """Rounding P to bf16 before P V (the card's bf16 kernel) against the
    JAX kernel, which multiplies P by V in fp32: within the bf16 bar at the
    Zamba2 head dim 80 and a ragged S of 300 (padded for the JAX kernel)."""
    B, S, H, HD = 1, 300, 2, 80
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(S + window, (B, H, S, HD)))
    out = _bf16_kernel_emulation(q, k, v, True, window)
    to_jax = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16).transpose(0, 2, 1, 3)
    want = jax_bshd(to_jax(q), to_jax(k), to_jax(v), causal=True, window=window,
                    block_q=64, block_k=64)
    want = np.asarray(want.astype(jnp.float32)).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(out.float().numpy(), want, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("window", [0, 48])
def test_flash_at_head_dim_256_matches_jax_kernel(window):
    """gemma3's head dim through the plain version against the JAX kernel."""
    q, k, v = _qkv(256 + window, (1, 2, 128, 256))
    out = ops.flash_attention(*map(torch.from_numpy, (q, k, v)), True, window,
                              block_q=64, block_k=64)
    want = jax_flash(*map(jnp.asarray, (q, k, v)), True, window, block_q=64, block_k=64)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("L,S,window", [(21, 32, 0), (37, 64, 16), (64, 64, 0)])
def test_right_padded_bucket_needs_no_key_mask(L, S, window):
    """A right-padded bucket run causal over all S rows (the kernel's index
    mask, no key mask) gives, on every real row, what the JAX package's
    position mask gives with the pad positions at -1 (chunked_attention)."""
    from repro.models.attention import chunked_attention

    q, k, v = _qkv(L + S, (1, S, 4, 64))
    out = ops.flash_attention_bshd(*map(torch.from_numpy, (q, k, v)), True, window)
    pos = jnp.where(jnp.arange(S) < L, jnp.arange(S), -1)
    want = chunked_attention(*map(jnp.asarray, (q, k, v)), pos, pos, True, window)
    np.testing.assert_allclose(out.numpy()[:, :L], np.asarray(want)[:, :L], atol=2e-5)
    assert np.isfinite(out.numpy()).all()


def test_bf16_kernel_rounding_at_head_dim_256():
    """The card's bf16 rounding at gemma3's head dim (4 heads, its window
    of 512 over a 300-token prompt) against the JAX kernel, bf16 bar."""
    B, S, H, HD = 1, 300, 4, 256
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(S + HD, (B, H, S, HD)))
    out = _bf16_kernel_emulation(q, k, v, True, 512)
    to_jax = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16).transpose(0, 2, 1, 3)
    want = jax_bshd(to_jax(q), to_jax(k), to_jax(v), causal=True, window=512,
                    block_q=64, block_k=64)
    want = np.asarray(want.astype(jnp.float32)).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(out.float().numpy(), want, atol=2e-2, rtol=2e-2)
