"""The port's SSD chunk kernel layer (repro_torch.kernels.ssd).

On the CPU: the wrappers route CPU tensors to the plain version and the
kernel refuses them. On a CUDA card (marker ``gpu``; they skip here): the
Hopper kernel against its plain version (``ref.chunk_ref``), atol 1e-5 (the
JAX package's bar, tests/test_kernels.py) at its test shapes, and at the
Zamba2-2.7B shape with dt and A drawn in the model's ranges. This module
imports no JAX, so that the card's run, which has no JAX, can collect it:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_ssd_kernel.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.ssd import ops, ref, ssd_kernel

ATOL = 1e-5


def _cells(seed, B, H, nc, Q, P, N, device="cpu", model_ranges=False):
    """Chunked inputs. ``model_ranges`` draws A and dt as Mamba2's init
    gives them (A in [-16, -1], dt = softplus(N(0, 1) + dt_bias) with
    dt_bias for dt0 log-spaced in [1e-3, 1e-1]); otherwise the JAX
    package's test ranges."""
    rs = np.random.RandomState(seed)
    x = rs.randn(B, H, nc, Q, P)
    Bm = rs.randn(B, H, nc, Q, N) * 0.3
    Cm = rs.randn(B, H, nc, Q, N) * 0.3
    if model_ranges:
        A = -np.linspace(1.0, 16.0, H)
        dt0 = np.exp(np.linspace(np.log(1e-3), np.log(1e-1), H))
        bias = dt0 + np.log(-np.expm1(-dt0))
        dt = np.logaddexp(0.0, rs.randn(B, H, nc, Q) + bias[None, :, None, None])
    else:
        A = -np.exp(rs.randn(H))
        dt = np.logaddexp(0.0, rs.randn(B, H, nc, Q)) * 0.1
    return [
        torch.from_numpy(a.astype(np.float32)).to(device) for a in (x, dt, A, Bm, Cm)
    ]


def test_ops_route_cpu_tensors_to_plain():
    cells = _cells(0, 1, 2, 3, 16, 8, 8)
    before = ssd_kernel.ssd_chunk_kernel.launches
    got = ops.ssd_chunk(*cells)
    for a, b in zip(got, ref.chunk_ref(*cells)):
        assert torch.equal(a, b)
    assert ssd_kernel.ssd_chunk_kernel.launches == before


def test_kernel_rejects_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_kernel.ssd_chunk_kernel(*_cells(0, 1, 1, 1, 8, 8, 8))


def test_plain_chunk_is_finite_where_exp_overflows():
    """Model-range decay over a 64-step chunk sends exp(cum_t - cum_tau)
    above the diagonal to inf; the masked result stays finite."""
    x, dt, A, Bm, Cm = _cells(2, 1, 4, 1, 64, 8, 8, model_ranges=True)
    dt = dt * 0 + 0.3
    cum = torch.cumsum(dt * A[None, :, None, None], dim=-1)
    assert torch.isinf(torch.exp(cum[..., :, None] - cum[..., None, :])).any()
    for a in ref.chunk_ref(x, dt, A, Bm, Cm):
        assert torch.isfinite(a).all()


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
    "B,H,nc,Q,P,N,model_ranges",
    [
        (2, 3, 4, 16, 8, 8, False),  # tests/test_kernels.py's shape
        (1, 80, 8, 64, 64, 64, False),  # Zamba2-2.7B, 512-token prefill
        (1, 80, 2, 17, 64, 64, False),  # a ragged chunk (17-token prompt)
        (1, 48, 2, 64, 64, 128, False),  # Mamba2-780m's N = 128
        (1, 2, 2, 128, 128, 128, False),  # the largest tile the kernel takes
        (1, 4, 3, 100, 16, 32, False),
    ],
)
def test_kernel_matches_plain(cuda, B, H, nc, Q, P, N, model_ranges):
    cells = _cells(Q * P + N, B, H, nc, Q, P, N, cuda, model_ranges)
    before = ssd_kernel.ssd_chunk_kernel.launches
    got = ssd_kernel.ssd_chunk_kernel(*cells)
    torch.cuda.synchronize()
    assert ssd_kernel.ssd_chunk_kernel.launches == before + 1
    for a, b in zip(got, ref.chunk_ref(*cells)):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=1e-5)


@pytest.mark.gpu
def test_kernel_masks_overflowing_exp(cuda):
    """dt = 0.3 and A down to -16 overflow exp above the diagonal: the
    kernel takes exp only where tau <= t, so no NaN or inf comes out."""
    x, dt, A, Bm, Cm = _cells(5, 1, 80, 2, 64, 64, 64, cuda, model_ranges=True)
    dt = torch.full_like(dt, 0.3)
    got = ssd_kernel.ssd_chunk_kernel(x, dt, A, Bm, Cm)
    for a, b in zip(got, ref.chunk_ref(x, dt, A, Bm, Cm)):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, atol=ATOL, rtol=1e-5)


@pytest.mark.gpu
def test_ssd_forward_on_card_matches_naive(cuda):
    rs = np.random.RandomState(4)
    B, L, H, P, N = 2, 150, 3, 16, 8
    x = torch.from_numpy(rs.randn(B, L, H, P).astype(np.float32)).to(cuda)
    dt = torch.from_numpy((np.logaddexp(0, rs.randn(B, L, H)) * 0.1).astype(np.float32)).to(cuda)
    A = torch.from_numpy((-np.exp(rs.randn(H))).astype(np.float32)).to(cuda)
    Bm = torch.from_numpy((rs.randn(B, L, H, N) * 0.3).astype(np.float32)).to(cuda)
    Cm = torch.from_numpy((rs.randn(B, L, H, N) * 0.3).astype(np.float32)).to(cuda)
    Y, S = ops.ssd_forward(x, dt, A, Bm, Cm, chunk=64)
    Y0, S0 = ref.naive_recurrence(x, dt, A, Bm, Cm)
    torch.testing.assert_close(Y, Y0, atol=2e-4, rtol=0)
    torch.testing.assert_close(S, S0, atol=2e-4, rtol=0)
