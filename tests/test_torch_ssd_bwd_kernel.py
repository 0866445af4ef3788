"""K4-bwd, the SSD chunk's backward kernel, on a CUDA card (marker ``gpu``;
every test skips without one).

``ssd_kernel.ssd_chunk_bwd_kernel`` against the plain backward
``ref.chunk_bwd_ref`` on the same card tensors: mamba2-780m's layout (P =
64, N = 128, one group) and zamba2-2.7b's (N = 64), with x, B and C as bf16
or fp32 views of one conv output, a ragged last chunk (L = 1000) and a
17-step chunk, G = 4 groups of H = 8 heads, and the chunk whose decay
overflows exp (finite outputs equal to the plain version's). Bars, relative
to max(1, max|plain|) as for K3-bwd: fp32 outputs (d(dt), dA, and dx, dB,
dC of fp32 inputs) 2e-5, the same sums in another order with the products
in split TF32; outputs rounded to bf16 2e-2, one bf16 step apart where the
two fp32 values straddle a rounding boundary. Two launches give the same
bits. The autograd Function ``ops.SSDChunk`` launches K4 and K4-bwd once
each and its gradients match the CPU's. This module imports no JAX, so that
the card's run can collect it:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_ssd_bwd_kernel.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.ssd import ops, ref, ssd_kernel

TOL_F32, TOL_BF16 = 2e-5, 2e-2
NAMES = ("dx", "ddt", "dA", "dB", "dC")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(seed, B, L, H, G, P, N, device, dtype, overflow=False, chunk=64):
    """x, B and C as views of one (B, L, H P + 2 G N) tensor in ``dtype``,
    dt and A in Mamba2's init ranges (A in [-16, -1]); ``overflow`` sets dt
    to 0.1, where the last head's decay over 64 steps passes exp's range;
    and the three cotangents."""
    rs = np.random.RandomState(seed)
    xbc = np.concatenate([rs.randn(B, L, H * P), 0.3 * rs.randn(B, L, 2 * G * N)], axis=-1)
    xbc = torch.from_numpy(xbc.astype(np.float32)).to(device=device, dtype=dtype)
    x = xbc[..., : H * P].reshape(B, L, H, P)
    Bm = xbc[..., H * P : H * P + G * N].reshape(B, L, G, N)
    Cm = xbc[..., H * P + G * N :].reshape(B, L, G, N)
    A = -torch.linspace(1.0, 16.0, H, device=device)
    dt0 = np.exp(np.linspace(np.log(1e-3), np.log(1e-1), H))
    dt = np.logaddexp(0.0, rs.randn(B, L, H) + dt0 + np.log(-np.expm1(-dt0)))
    if overflow:
        dt = np.full_like(dt, 0.1)
    dt = torch.from_numpy(dt.astype(np.float32)).to(device)
    Q = min(chunk, L)
    nc = -(-L // Q)
    cots = [torch.from_numpy(rs.randn(*s).astype(np.float32)).to(device)
            for s in ((B, L, H, P), (B, nc, H, N, P), (B, nc, H))]
    return [x, dt, A, Bm, Cm], cots


def _check(got, want, bf16):
    for name, a, b in zip(NAMES, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.isfinite(a).all(), name
        tol = TOL_BF16 if bf16 and name in ("dx", "dB", "dC") else TOL_F32
        err = (a.float() - b.float()).abs().max().item()
        assert err <= tol * max(1.0, b.float().abs().max().item()), (name, err)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "B,L,H,G,P,N,chunk,dtype",
    [
        (2, 256, 8, 1, 64, 128, 64, torch.bfloat16),  # mamba2-780m's layout, fewer heads
        (2, 256, 8, 1, 64, 128, 64, torch.float32),
        (1, 256, 16, 1, 64, 64, 64, torch.bfloat16),  # zamba2-2.7b's
        (1, 1000, 4, 1, 64, 128, 64, torch.bfloat16),  # ragged last chunk (40 rows)
        (1, 1000, 4, 2, 64, 64, 64, torch.float32),
        (1, 17, 8, 1, 64, 64, 64, torch.bfloat16),  # a 17-step chunk
        (2, 100, 8, 4, 64, 64, 64, torch.float32),  # G = 4 of H = 8
        (1, 96, 6, 3, 18, 30, 32, torch.float32),  # rows not 16-byte multiples
        (1, 64, 4, 4, 128, 64, 64, torch.float32),  # P = 128
    ],
)
def test_backward_kernel_matches_plain(cuda, B, L, H, G, P, N, chunk, dtype):
    inputs, cots = _inputs(L + H + N, B, L, H, G, P, N, cuda, dtype, chunk=chunk)
    before = ssd_kernel.ssd_chunk_bwd_kernel.launches
    got = ssd_kernel.ssd_chunk_bwd_kernel(*inputs, *cots, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_kernel.ssd_chunk_bwd_kernel.launches == before + 1
    _check(got, ref.chunk_bwd_ref(*inputs, *cots, chunk), dtype == torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernel_is_finite_where_exp_overflows(cuda, dtype):
    inputs, cots = _inputs(5, 1, 128, 4, 1, 64, 128, cuda, dtype, overflow=True)
    assert float(inputs[1][0, :64, -1].sum() * inputs[2][-1]) < -88.7
    got = ssd_kernel.ssd_chunk_bwd_kernel(*inputs, *cots, chunk=64)
    want = ref.chunk_bwd_ref(*inputs, *cots, 64)
    assert all(bool(torch.isfinite(w).all()) for w in want)
    _check(got, want, dtype == torch.bfloat16)


@pytest.mark.gpu
def test_backward_kernel_is_bit_deterministic(cuda):
    inputs, cots = _inputs(6, 2, 512, 8, 2, 64, 128, cuda, torch.bfloat16)
    a = ssd_kernel.ssd_chunk_bwd_kernel(*inputs, *cots, chunk=64)
    b = ssd_kernel.ssd_chunk_bwd_kernel(*inputs, *cots, chunk=64)
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(a, b))


@pytest.mark.gpu
def test_ssd_forward_gradients_on_card_match_cpu(cuda):
    """ops.ssd_forward under autograd: K4 and K4-bwd once each, and the
    gradients of x, dt, A, B and C those of the CPU (the plain versions),
    with the inter-chunk recurrence under autograd on both."""
    inputs, _ = _inputs(7, 2, 300, 4, 2, 64, 64, cuda, torch.float32)
    rs = np.random.RandomState(8)
    cot_y = torch.from_numpy(rs.randn(2, 300, 4, 64).astype(np.float32))
    cot_s = torch.from_numpy(rs.randn(2, 4, 64, 64).astype(np.float32))
    grads = {}
    for dev in ("cpu", cuda):
        leaves = [t.detach().to(dev).clone().requires_grad_(True) for t in inputs]
        counts = (ssd_kernel.ssd_chunk_kernel.launches, ssd_kernel.ssd_chunk_bwd_kernel.launches)
        Y, S = ops.ssd_forward(*leaves, chunk=64)
        g = torch.autograd.grad((Y, S), leaves, (cot_y.to(dev), cot_s.to(dev)))
        after = (ssd_kernel.ssd_chunk_kernel.launches, ssd_kernel.ssd_chunk_bwd_kernel.launches)
        grads[str(dev)] = ([t.cpu() for t in g], (after[0] - counts[0], after[1] - counts[1]))
    assert grads["cpu"][1] == (0, 0) and grads[str(cuda)][1] == (1, 1)
    _check(grads[str(cuda)][0], grads["cpu"][0], False)


@pytest.mark.gpu
def test_backward_kernel_refuses_what_it_does_not_take(cuda):
    inputs, cots = _inputs(9, 1, 128, 4, 1, 128, 128, cuda, torch.float32)
    with pytest.raises(ValueError, match="shared memory"):
        ssd_kernel.ssd_chunk_bwd_kernel(*inputs, *cots, chunk=64)
    inputs, cots = _inputs(9, 1, 128, 4, 1, 64, 64, cuda, torch.float32)
    with pytest.raises(ValueError, match="Q <= 64"):
        ssd_kernel.ssd_chunk_bwd_kernel(*inputs, *cots, chunk=128)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_kernel.ssd_chunk_bwd_kernel(*inputs, cots[0].transpose(2, 3).contiguous()
                                        .transpose(2, 3), *cots[1:], chunk=64)
