"""The port's flash-attention kernel layer (repro_torch.kernels.flash).

On the CPU: the wrappers route CPU tensors to the plain version and the
kernel refuses them. On a CUDA card (marker ``gpu``; they skip here): the
Hopper kernels against their plain version, fp32 (the fp32-FMA kernel) at
atol 1e-5 and bf16 (the tensor-core kernel) at 2e-2, the JAX package's
bars (tests/test_kernels.py). This module imports
no JAX, so that the card's run, which has no JAX, can collect it:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_flash_kernel.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash import flash_kernel, ops, ref

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _qkv(seed, B, H, S, HD, dtype=torch.float32, device="cpu", Sk=None):
    rs = np.random.RandomState(seed)
    Sk = S if Sk is None else Sk
    arrays = [rs.randn(B, H, n, HD).astype(np.float32) for n in (S, Sk, Sk)]
    return [torch.from_numpy(a).to(device=device, dtype=dtype) for a in arrays]


def test_ops_route_cpu_tensors_to_plain():
    q, k, v = _qkv(0, 1, 2, 64, 16)
    before = flash_kernel.flash_attention.launches
    out = ops.flash_attention(q, k, v, True, 0, 32, 32)
    assert torch.equal(out, ref.attention_ref(q, k, v, True, 0))
    assert flash_kernel.flash_attention.launches == before


def test_kernel_rejects_cpu_tensors():
    q, k, v = _qkv(0, 1, 1, 16, 16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_kernel.flash_attention(q, k, v)


def test_bshd_refuses_non_causal_key_padding():
    q, k, v = (t.transpose(1, 2) for t in _qkv(1, 1, 1, 40, 16))
    with pytest.raises(AssertionError, match="non-causal"):
        ops.flash_attention_bshd(q, k, v, causal=False, block_q=32, block_k=32)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize(
    "B,H,S,HD,causal,window,dtype",
    [
        (1, 32, 512, 80, True, 0, torch.bfloat16),  # the Zamba2-2.7B prefill
        (1, 32, 512, 80, True, 0, torch.float32),
        (1, 32, 512, 80, True, 128, torch.float32),
        (2, 3, 256, 64, True, 0, torch.float32),
        (1, 2, 128, 32, True, 48, torch.float32),
        (1, 1, 64, 16, True, 16, torch.float32),
        (2, 2, 256, 64, False, 0, torch.float32),
        (1, 4, 512, 128, True, 0, torch.float32),
        (2, 2, 256, 64, True, 0, torch.bfloat16),
        (1, 4, 17, 80, True, 0, torch.float32),  # ragged: S not a multiple of 64
        (1, 4, 300, 80, True, 0, torch.bfloat16),
        (1, 2, 129, 80, True, 100, torch.float32),
        # the tensor-core bf16 kernel at every head dim it is built for
        (1, 2, 256, 16, True, 0, torch.bfloat16),
        (1, 2, 256, 32, True, 48, torch.bfloat16),
        (1, 2, 192, 48, True, 0, torch.bfloat16),
        (2, 2, 256, 64, True, 100, torch.bfloat16),
        (1, 2, 128, 96, True, 0, torch.bfloat16),
        (1, 2, 128, 112, True, 0, torch.bfloat16),
        (1, 4, 512, 128, True, 0, torch.bfloat16),
        (1, 4, 17, 80, True, 0, torch.bfloat16),  # ragged
        (1, 2, 129, 80, True, 100, torch.bfloat16),
        (1, 32, 512, 80, True, 128, torch.bfloat16),
        (2, 2, 200, 64, False, 0, torch.bfloat16),
        (1, 2, 150, 80, False, 64, torch.bfloat16),
        # head dims above 128: gemma3-1b's 256 (4 heads, its local window of
        # 512), 192, and qwen1.5-4b's prefill at 128
        (1, 4, 512, 256, True, 0, torch.bfloat16),
        (1, 4, 512, 256, True, 512, torch.bfloat16),
        (1, 4, 512, 256, True, 0, torch.float32),
        (1, 4, 512, 256, True, 512, torch.float32),
        (1, 4, 300, 256, True, 100, torch.bfloat16),
        (1, 2, 129, 256, True, 0, torch.float32),
        (2, 2, 150, 256, False, 0, torch.bfloat16),
        (1, 2, 200, 192, True, 0, torch.bfloat16),
        (1, 2, 200, 192, True, 64, torch.float32),
        (1, 20, 512, 128, True, 0, torch.bfloat16),
    ],
)
def test_kernel_matches_plain(cuda, B, H, S, HD, causal, window, dtype):
    q, k, v = _qkv(S * HD + H, B, H, S, HD, dtype, cuda)
    before = flash_kernel.flash_attention.launches
    out = flash_kernel.flash_attention(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert flash_kernel.flash_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    want = ref.attention_ref(q, k, v, causal, window)
    torch.testing.assert_close(out.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.gpu
def test_non_causal_cross_shapes(cuda):
    """Sk != S without a causal mask (encoder-style); the ragged key tile
    adds nothing."""
    q, k, v = _qkv(7, 1, 2, 70, 64, torch.float32, cuda, Sk=100)
    out = flash_kernel.flash_attention(q, k, v, causal=False)
    torch.testing.assert_close(out, ref.attention_ref(q, k, v, False, 0), atol=1e-5, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("S,window", [(512, 0), (300, 100), (17, 0), (200, 64), (1000, 130)])
def test_bf16_kernel_through_the_tile_ring(cuda, S, window):
    """From one key tile to more than the ring holds, with rows whose first
    visited blocks are all masked (window): one launch, the plain result."""
    q, k, v = _qkv(S + window, 1, 4, S, 80, torch.bfloat16, cuda)
    before = flash_kernel.flash_attention.launches
    out = flash_kernel.flash_attention(q, k, v, True, window)
    torch.cuda.synchronize()
    assert flash_kernel.flash_attention.launches == before + 1
    want = ref.attention_ref(q, k, v, True, window)
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,Sk,causal", [(70, 100, False), (64, 200, True), (17, 129, True)])
def test_kernel_with_more_keys_than_queries(cuda, dtype, S, Sk, causal):
    """Sk > S, causal or not; the ragged key tile adds nothing."""
    q, k, v = _qkv(S + Sk, 1, 2, S, 80, dtype, cuda, Sk=Sk)
    out = flash_kernel.flash_attention(q, k, v, causal=causal)
    want = ref.attention_ref(q, k, v, causal, 0)
    torch.testing.assert_close(out.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.gpu
def test_bshd_reads_the_model_layout_in_place(cuda):
    """On the card the (B, S, H, HD) wrapper hands the kernel strided views:
    one launch, no copy kernel, and an output that is contiguous in the
    model layout."""
    from torch.profiler import ProfilerActivity, profile

    q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)  # BSHD memory, BHSD view
               for t in _qkv(9, 1, 8, 300, 80, torch.bfloat16, cuda))
    qb, kb, vb = (t.transpose(1, 2) for t in (q, k, v))  # what the model hands over
    assert qb.is_contiguous()
    before = flash_kernel.flash_attention.launches
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = ops.flash_attention_bshd(qb, kb, vb, causal=True)
    torch.cuda.synchronize()
    assert flash_kernel.flash_attention.launches == before + 1
    assert not [e.key for e in prof.key_averages() if e.key in ("aten::copy_", "aten::pad")]
    assert out.shape == qb.shape and out.is_contiguous()
    want = ref.attention_ref(q, k, v, True, 0).transpose(1, 2)
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.gpu
def test_bshd_wrapper_with_padding_on_card(cuda):
    q, k, v = (t.transpose(1, 2) for t in _qkv(3, 2, 2, 200, 64, torch.float32, cuda))
    out = ops.flash_attention_bshd(q, k, v, causal=True, block_q=64, block_k=64)
    want = ref.attention_ref(*(t.transpose(1, 2) for t in (q, k, v)), True, 0)
    torch.testing.assert_close(out.transpose(1, 2), want, atol=2e-5, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("HD,dtype", [(72, torch.float32), (272, torch.float32),
                                      (144, torch.bfloat16)])
def test_kernel_raises_on_unsupported_head_dim(cuda, HD, dtype):
    q, k, v = _qkv(0, 1, 1, 64, HD, dtype, cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_kernel.flash_attention(q, k, v)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1500, 512, 37])
def test_non_causal_at_whisper_frames(cuda, dtype, S):
    """whisper-tiny's non-causal calls: 1500 keys (23 full tiles of 64 and
    a ragged one of 28), the encoder's S = 1500 and cross-attention's
    decoder rows against them, at head dim 64."""
    q, k, v = _qkv(S + 1500, 1, 6, S, 64, dtype, cuda, Sk=1500)
    before = flash_kernel.flash_attention.launches
    out = flash_kernel.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert flash_kernel.flash_attention.launches == before + 1
    assert bool(torch.isfinite(out).all())
    want = ref.attention_ref(q, k, v, False, 0)
    torch.testing.assert_close(out.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])
