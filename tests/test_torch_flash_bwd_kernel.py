"""The flash-attention backward kernel (K3-bwd, repro_torch.kernels.flash).

On the CPU: the plain backward is torch autograd through the plain
forward, the differentiable entry point routes CPU tensors to it, and the
backward kernel refuses CPU tensors. On a CUDA card (marker ``gpu``; they
skip here): K3-bwd against ``ref.attention_ref_bwd`` over every head dim,
causal, windowed, non-causal, Sk != S, ragged tiles and strided views; the
edges of its tiles (64 resident rows, 64, 32 or 16 streamed rows), several
batches and heads in one grid, misaligned views and bit-determinism; and
K3's row log-sum-exp against the plain one. Bars, relative to
max(1, max|plain|): fp32 2e-5 (the same sums in another order over at
most a few thousand terms; the kernel's products are split TF32, which
keeps fp32's accuracy); bf16 2e-2 (both sides round an fp32 value to
bf16, at most one step of 2^-7 at the largest entry; D comes from the
kernel's bf16 output, and P and dS are rounded to bf16 as mma operands,
at most 2^-9 relative each, as K3's forward rounds P). This module imports
no JAX, so that the card's run can collect it:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_flash_bwd_kernel.py
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash import flash_kernel, ops, ref

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _tensors(seed, B, H, S, HD, dtype=torch.float32, device="cpu", Sk=None):
    """q, k, v and an output gradient from one seed (numpy draws)."""
    rs = np.random.RandomState(seed)
    Sk = S if Sk is None else Sk
    arrays = [rs.randn(B, H, n, HD).astype(np.float32) for n in (S, Sk, Sk, S)]
    return [torch.from_numpy(a).to(device=device, dtype=dtype) for a in arrays]


def _err(got, want):
    """max|got - want| over max(1, max|want|), the bars' measure."""
    return ((got.float() - want.float()).abs().max() / max(1.0, want.float().abs().max())).item()


def test_plain_backward_is_autograd_of_the_plain_forward():
    q, k, v, g = _tensors(0, 1, 2, 40, 16)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref.attention_ref(*leaves, True, 8).backward(g)
    got = ref.attention_ref_bwd(q, k, v, g, True, 8)
    for a, leaf in zip(got, leaves):
        assert torch.equal(a, leaf.grad)


@pytest.mark.parametrize("causal", [True, False])
def test_bshd_differentiates_the_plain_version_on_cpu(causal):
    """The model-layout entry point pads and transposes on the CPU; its
    gradient is the plain backward's, and no kernel launches."""
    S = 100 if causal else 128  # a causal call pads its keys to the block
    q, k, v, g = (t.transpose(1, 2) for t in _tensors(1, 2, 3, S, 16))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = (flash_kernel.flash_attention.launches, flash_kernel.flash_attention_bwd.launches)
    if causal:
        out = ops.flash_attention_bshd(*leaves, True, 0, block_q=64, block_k=64)
    else:  # non-causal key padding is refused, so at block-multiple lengths
        out = ops.flash_attention_bshd(*leaves, False, 0)
    out.backward(g)
    want = ref.attention_ref_bwd(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                 g.transpose(1, 2), causal, 0)
    for leaf, w in zip(leaves, want):
        torch.testing.assert_close(leaf.grad, w.transpose(1, 2), atol=1e-6, rtol=1e-6)
    assert (flash_kernel.flash_attention.launches,
            flash_kernel.flash_attention_bwd.launches) == before


def test_backward_kernel_rejects_cpu_tensors():
    q, k, v, g = _tensors(2, 1, 1, 16, 16)
    lse = torch.zeros(1, 1, 16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_kernel.flash_attention_bwd(q, k, v, q, g, lse)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _check_bwd(q, k, v, g, causal, window):
    before = flash_kernel.flash_attention_bwd.launches
    out, lse = flash_kernel.flash_attention(q, k, v, causal, window, return_lse=True)
    got = flash_kernel.flash_attention_bwd(q, k, v, out, g, lse, causal, window)
    torch.cuda.synchronize()
    assert flash_kernel.flash_attention_bwd.launches == before + 1
    want = ref.attention_ref_bwd(q, k, v, g, causal, window)
    for name, a, w, t in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        assert a.dtype == t.dtype and a.shape == t.shape and a.stride() == t.stride(), name
        assert bool(torch.isfinite(a).all()), name
        e = _err(a, w)
        assert e <= TOL[q.dtype], (name, e)


# fp32 takes every multiple of 16 up to 256, bf16 the forward's list
HEAD_DIMS = ([("fp32", torch.float32, hd) for hd in flash_kernel.BF16_HEAD_DIMS + (144, 240)]
             + [("bf16", torch.bfloat16, hd) for hd in flash_kernel.BF16_HEAD_DIMS])


@pytest.mark.gpu
@pytest.mark.parametrize("name,dtype,HD", HEAD_DIMS, ids=[f"{n}-{h}" for n, _, h in HEAD_DIMS])
def test_backward_matches_plain_every_head_dim(cuda, name, dtype, HD):
    """Causal at a ragged length (both block sizes end mid-tile)."""
    _check_bwd(*_tensors(3, 1, 2, 130, HD, dtype, cuda), True, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("HD", [64, 256])
@pytest.mark.parametrize("case", ["window", "noncausal", "more_keys", "cross", "causal_more_keys"])
def test_backward_matches_plain_every_mask(cuda, dtype, HD, case):
    S, Sk, causal, window = {
        "window": (200, 200, True, 48),
        "noncausal": (150, 150, False, 0),
        "more_keys": (70, 150, False, 0),
        "cross": (37, 300, False, 0),
        "causal_more_keys": (70, 100, True, 0),
    }[case]
    _check_bwd(*_tensors(4, 2, 3, S, HD, dtype, cuda, Sk=Sk), causal, window)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_lse_is_the_rows_log2_sum_exp2(cuda, dtype):
    q, k, v, _ = _tensors(5, 1, 2, 100, 64, dtype, cuda)
    for causal, window in ((True, 0), (True, 16), (False, 0)):
        plain_out = ref.attention_ref(q, k, v, causal, window)
        out, lse = flash_kernel.flash_attention(q, k, v, causal, window, return_lse=True)
        torch.cuda.synchronize()
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(64)
        i = torch.arange(100, device=cuda)
        mask = torch.ones(100, 100, dtype=torch.bool, device=cuda)
        if causal:
            mask &= i[None, :] <= i[:, None]
        if window:
            mask &= i[None, :] > i[:, None] - window
        want = torch.logsumexp(s.masked_fill(~mask, -float("inf")), -1) / math.log(2.0)
        torch.testing.assert_close(lse, want, atol=1e-4, rtol=1e-5)
        # asking for lse leaves the output as it was
        torch.testing.assert_close(out, flash_kernel.flash_attention(q, k, v, causal, window),
                                   atol=0, rtol=0)
        assert _err(out, plain_out) <= (1e-5 if dtype == torch.float32 else 2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_function_trains_through_the_kernels_on_strided_views(cuda, dtype):
    """flash_attention_bshd on model-layout tensors (strided (B, H, S, HD)
    views): K3 once with lse, K3-bwd once, gradients in the model layout
    against autograd of the plain version on the card."""
    q, k, v, g = (t.transpose(1, 2).contiguous() for t in _tensors(6, 2, 4, 90, 128, dtype,
                                                                   cuda))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = (flash_kernel.flash_attention.launches, flash_kernel.flash_attention_bwd.launches)
    ops.flash_attention_bshd(*leaves, True, 32).backward(g)
    torch.cuda.synchronize()
    assert (flash_kernel.flash_attention.launches,
            flash_kernel.flash_attention_bwd.launches) == (before[0] + 1, before[1] + 1)
    want = ref.attention_ref_bwd(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                 g.transpose(1, 2), True, 32)
    for leaf, w in zip(leaves, want):
        assert _err(leaf.grad, w.transpose(1, 2)) <= TOL[dtype]
    with torch.no_grad():  # serving: one forward launch, no lse, no graph
        out = ops.flash_attention_bshd(q, k, v, True, 32)
    assert not out.requires_grad


@pytest.mark.gpu
def test_backward_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v, g = _tensors(7, 1, 2, 64, 64, torch.float32, cuda)
    out, lse = flash_kernel.flash_attention(q, k, v, True, 0, return_lse=True)
    with pytest.raises(TypeError):
        flash_kernel.flash_attention_bwd(*(t.half() for t in (q, k, v, out, g)), lse)
    with pytest.raises(ValueError, match="lse"):
        flash_kernel.flash_attention_bwd(q, k, v, out, g, lse[:, :, :10])
    with pytest.raises(ValueError, match="head dim"):
        q2, k2, v2, g2 = _tensors(7, 1, 2, 64, 24, torch.float32, cuda)
        flash_kernel.flash_attention_bwd(q2, k2, v2, q2, g2, lse)
    with pytest.raises(ValueError, match="Sk >= S"):
        flash_kernel.flash_attention_bwd(q, k[:, :, :32], v[:, :, :32], out, g, lse)


# the tiles' edges: S and Sk one short of and one past a multiple of the
# resident block (64) and of the streamed tiles (64, 32, 16), and windows
# that end inside a block
EDGE_CASES = (  # (S, Sk, causal, window)
    (63, 63, True, 0),
    (65, 65, True, 0),
    (127, 129, True, 0),
    (129, 127, False, 0),
    (97, 161, False, 0),
    (31, 33, False, 0),
    (17, 15, False, 0),
    (150, 150, True, 40),
    (200, 200, True, 33),
    (129, 129, False, 40),
)
EDGE_DIMS = ([("fp32", torch.float32, hd) for hd in (64, 128, 144, 256)]
             + [("bf16", torch.bfloat16, hd) for hd in (64, 128, 256)])


@pytest.mark.gpu
@pytest.mark.parametrize("name,dtype,HD", EDGE_DIMS, ids=[f"{n}-{h}" for n, _, h in EDGE_DIMS])
@pytest.mark.parametrize("S,Sk,causal,window", EDGE_CASES,
                         ids=[f"{s}x{k}-{'c' if c else 'n'}{w}" for s, k, c, w in EDGE_CASES])
def test_backward_matches_plain_at_tile_edges(cuda, name, dtype, HD, S, Sk, causal, window):
    _check_bwd(*_tensors(8, 1, 2, S, HD, dtype, cuda, Sk=Sk), causal, window)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("HD", [64, 256])
@pytest.mark.parametrize("S,Sk,causal,window", [(130, 130, True, 0), (150, 150, True, 48),
                                                (37, 300, False, 0)])
def test_backward_matches_plain_over_batches_and_heads(cuda, dtype, HD, S, Sk, causal, window):
    """B = 3 and H = 5: one grid of (heads, dK/dV and dQ blocks, batches)."""
    _check_bwd(*_tensors(9, 3, 5, S, HD, dtype, cuda, Sk=Sk), causal, window)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("HD", [64, 128, 256])
def test_backward_is_bit_deterministic(cuda, dtype, HD):
    """No atomics: two calls give the same bits."""
    for S, Sk, causal, window in ((200, 200, True, 0), (200, 200, True, 48), (70, 150, False, 0)):
        q, k, v, g = _tensors(10, 2, 3, S, HD, dtype, cuda, Sk=Sk)
        out, lse = flash_kernel.flash_attention(q, k, v, causal, window, return_lse=True)
        first = flash_kernel.flash_attention_bwd(q, k, v, out, g, lse, causal, window)
        second = flash_kernel.flash_attention_bwd(q, k, v, out, g, lse, causal, window)
        torch.cuda.synchronize()
        for a, b in zip(first, second):
            assert torch.equal(a, b)


def _shifted(t, elements):
    """A copy of ``t`` whose base sits ``elements`` past an aligned one."""
    buf = torch.empty(t.numel() + elements, dtype=t.dtype, device=t.device)
    view = buf[elements:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.gpu
def test_backward_copies_misaligned_fp32_views(cuda):
    """An fp32 input 4 bytes off a 16-byte boundary, or with a row stride
    that is not whole 16-byte units, is copied before the kernel stages
    it: the gradients are the plain ones, in the inputs' layout."""
    q, k, v, g = _tensors(11, 1, 2, 100, 64, torch.float32, cuda)
    _check_bwd(_shifted(q, 1), k, v, _shifted(g, 3), True, 0)
    wide = torch.zeros(1, 2, 100, 66, device=cuda)  # row stride 66 floats: 264 bytes
    wide[..., :64] = k
    k_view = wide[..., :64]  # not dense, so dk comes back dense
    out, lse = flash_kernel.flash_attention(q, k_view, v, True, 0, return_lse=True)
    got = flash_kernel.flash_attention_bwd(q, k_view, v, out, g, lse, True, 0)
    torch.cuda.synchronize()
    want = ref.attention_ref_bwd(q, k, v, g, True, 0)
    for a, w in zip(got, want):
        assert _err(a, w) <= TOL[torch.float32]


@pytest.mark.gpu
def test_backward_refuses_misaligned_bf16_views(cuda):
    q, k, v, g = _tensors(12, 1, 2, 64, 64, torch.bfloat16, cuda)
    out, lse = flash_kernel.flash_attention(q, k, v, True, 0, return_lse=True)
    with pytest.raises(ValueError, match="16-byte"):
        flash_kernel.flash_attention_bwd(_shifted(q, 4), k, v, out, g, lse)
