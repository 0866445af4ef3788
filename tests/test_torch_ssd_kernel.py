"""The port's SSD chunk kernel layer (repro_torch.kernels.ssd).

On the CPU: the wrappers route CPU tensors to the plain version and the
kernel refuses them; the chunked/sequence-major views that carry the JAX
layout to the kernel give the plain function's results; and a torch
emulation of the kernel's split-TF32 products (3xTF32: hi.hi + hi.lo +
lo.hi, operands rounded as cvt.rna.tf32.f32 rounds) holds the JAX kernel's
function (interpret mode) at chip_smoke.py's 5e-5 in Mamba2's dt/A ranges.
On a CUDA card (marker ``gpu``; they skip here): the Hopper kernel against
its plain version, atol 1e-5 (the JAX package's bar, tests/test_kernels.py)
at its test ranges, 5e-5 in the model's; per-group B/C, ragged chunks, N =
P = 128 (fp32 and bf16) and strided bf16 views. This module
imports no JAX at top level, so that the card's run, which has no JAX, can
collect it:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_ssd_kernel.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.ssd import ops, ref, ssd_kernel

ATOL = 1e-5
TOL_MODEL = 5e-5  # chip_smoke.py TOL_SSD: Mamba2 ranges (cum down to -300)


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


def test_chunked_views_give_the_plain_function():
    """The views ops.ssd_chunk hands the kernel (chunked -> sequence-major,
    and its outputs back) carry the same function: chunk_seq_ref on them
    equals chunk_ref on the chunked tensors."""
    x, dt, A, Bm, Cm = _cells(3, 2, 3, 4, 16, 8, 12)
    xs, dts, Bs, Cs = ops.chunked_as_seq(x, dt, Bm, Cm)
    assert xs.shape == (2, 64, 3, 8) and xs.data_ptr() == x.data_ptr()
    got = ops.seq_out_as_chunked(*ref.chunk_seq_ref(xs, dts, A, Bs, Cs, 16), 16)
    for a, b in zip(got, ref.chunk_ref(x, dt, A, Bm, Cm)):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def tf32_rna(a: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 as cvt.rna.tf32.f32 does: 10 mantissa bits,
    ties away from zero (adding half an ulp to the magnitude bits)."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel's mma.sync products: each operand split into
    hi = tf32(v) and lo = tf32(v - hi), lo.hi + hi.lo + hi.hi summed in
    fp32 (the TF32 products are exact; float64 stands in for the fp32
    accumulator, one rounding at the end)."""
    ah = tf32_rna(a)
    al = tf32_rna(a - ah)
    bh = tf32_rna(b)
    bl = tf32_rna(b - bh)
    f64 = torch.float64
    out = al.to(f64) @ bh.to(f64) + ah.to(f64) @ bl.to(f64) + ah.to(f64) @ bh.to(f64)
    return out.float()


def chunk_3xtf32(x, dt, A, Bm, Cm):
    """The chunk kernel's algorithm, chunked layout: C B^T, (C B^T o M) u and
    (B o d_end)^T u in split TF32; the mask and decays in fp32."""
    cum = torch.cumsum(dt * A[None, :, None, None], dim=-1)
    u = x * dt[..., None]
    Q = x.shape[-2]
    tri = torch.ones((Q, Q), dtype=torch.bool).tril()
    M = torch.where(tri, torch.exp(cum[..., :, None] - cum[..., None, :]), torch.zeros(()))
    CB = mm_3xtf32(Cm, Bm.transpose(-1, -2))
    Y = mm_3xtf32(CB * M, u)
    dend = torch.exp(cum[..., -1:] - cum)
    S = mm_3xtf32((Bm * dend[..., None]).transpose(-1, -2), u)
    return Y, S, torch.exp(cum[..., -1])


def test_tf32_rounding_is_rna():
    one_ulp = 2.0 ** -23
    a = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -11 - one_ulp, -(1.0 + 2.0 ** -11),
                      1.0 + 3 * 2.0 ** -11, 3.0e-3], dtype=torch.float32)
    got = tf32_rna(a)
    want = torch.tensor([1.0 + 2.0 ** -10, 1.0, -(1.0 + 2.0 ** -10), 1.0 + 2.0 ** -9, 0.0])
    torch.testing.assert_close(got[:4], want[:4], atol=0, rtol=0)
    assert abs(got[4].item() - 3.0e-3) <= 3.0e-3 * 2.0 ** -11
    # hi + lo carries about 22 bits: the split loses < 2^-21 relative
    lo = tf32_rna(a - got)
    assert ((got + lo - a).abs() <= a.abs() * 2.0 ** -21).all()


@pytest.mark.parametrize("Q,N", [(17, 64), (17, 128), (64, 64), (64, 128)])
def test_split_tf32_chunk_matches_jax_kernel(Q, N):
    import jax.numpy as jnp
    from repro.kernels.ssd import ssd_chunk_kernel as jax_chunk

    cells = _cells(Q + N, 1, 2, 2, Q, 16, N, model_ranges=True)
    got = chunk_3xtf32(*cells)
    want = jax_chunk(*(jnp.asarray(c.numpy()) for c in cells))
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL_MODEL, rtol=0)


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
    got = ops.ssd_chunk(*cells)
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
    got = ops.ssd_chunk(x, dt, A, Bm, Cm)
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


def _seq_inputs(seed, B, L, H, G, P, N, device, dtype=torch.float32):
    """Sequence-major inputs in Mamba2's ranges, x, B and C as strided views
    of one (B, L, H P + 2 G N) tensor, as the model's conv output holds them."""
    rs = np.random.RandomState(seed)
    xbc = np.concatenate([rs.randn(B, L, H * P), 0.3 * rs.randn(B, L, 2 * G * N)], axis=-1)
    xbc = torch.from_numpy(xbc.astype(np.float32)).to(device=device, dtype=dtype)
    x = xbc[..., : H * P].reshape(B, L, H, P)
    Bm = xbc[..., H * P : H * P + G * N].reshape(B, L, G, N)
    Cm = xbc[..., H * P + G * N :].reshape(B, L, G, N)
    A = -torch.linspace(1.0, 16.0, H, device=device)
    dt0 = np.exp(np.linspace(np.log(1e-3), np.log(1e-1), H))
    bias = dt0 + np.log(-np.expm1(-dt0))
    dt = np.logaddexp(0.0, rs.randn(B, L, H) + bias)
    return x, torch.from_numpy(dt.astype(np.float32)).to(device), A, Bm, Cm


@pytest.mark.gpu
@pytest.mark.parametrize(
    "B,L,H,G,P,N,chunk,dtype",
    [
        (1, 512, 16, 1, 64, 64, 64, torch.bfloat16),  # Zamba2's layout, fewer heads
        (1, 512, 16, 1, 64, 64, 64, torch.float32),
        (2, 150, 6, 2, 64, 64, 64, torch.float32),  # ragged last chunk, 2 groups
        (1, 17, 8, 8, 64, 64, 64, torch.bfloat16),  # a 17-token prompt, B/C per head
        (1, 130, 4, 1, 64, 128, 64, torch.bfloat16),  # mamba2-780m's N = 128
        (1, 200, 4, 2, 128, 128, 128, torch.float32),  # u in C's place (compact)
        (1, 200, 4, 2, 128, 128, 128, torch.bfloat16),  # compact, x widened in place
        (1, 256, 4, 1, 64, 128, 128, torch.bfloat16),  # compact at P = 64
        (1, 130, 4, 4, 128, 128, 64, torch.bfloat16),  # N = P = 128 at Q = 64
        (1, 100, 6, 3, 18, 30, 32, torch.float32),  # rows not 16-byte multiples
    ],
)
def test_kernel_seq_layout_matches_plain(cuda, B, L, H, G, P, N, chunk, dtype):
    x, dt, A, Bm, Cm = _seq_inputs(L + H + N, B, L, H, G, P, N, cuda, dtype)
    before = ssd_kernel.ssd_chunk_kernel.launches
    got = ssd_kernel.ssd_chunk_kernel(x, dt, A, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_kernel.ssd_chunk_kernel.launches == before + 1
    for a, b in zip(got, ref.chunk_seq_ref(x, dt, A, Bm, Cm, chunk)):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, atol=TOL_MODEL, rtol=1e-5)


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take(cuda):
    x, dt, A, Bm, Cm = _seq_inputs(0, 1, 64, 4, 1, 64, 64, cuda)
    with pytest.raises(ValueError, match="groups"):
        ssd_kernel.ssd_chunk_kernel(x, dt, A, Bm.expand(1, 64, 3, 64), Cm.expand(1, 64, 3, 64))
    with pytest.raises(ValueError, match="<= 128"):
        ssd_kernel.ssd_chunk_kernel(*_seq_inputs(1, 1, 64, 4, 1, 64, 160, cuda))
    with pytest.raises(TypeError, match="dtype"):
        ssd_kernel.ssd_chunk_kernel(x, dt.double(), A, Bm, Cm)


@pytest.mark.gpu
@pytest.mark.parametrize("G", [1, 2, 4])
def test_ssd_forward_groups_on_card_match_naive(cuda, G):
    B, L, H, P, N = 2, 150, 4, 16, 8
    x, dt, A, Bm, Cm = _seq_inputs(G, B, L, H, G, P, N, cuda)
    dt = dt * 0.2
    Y, S = ops.ssd_forward(x, dt, A, Bm, Cm, chunk=64)
    rep = lambda a: torch.repeat_interleave(a, H // G, dim=2).contiguous()
    Y0, S0 = ref.naive_recurrence(x, dt, A, rep(Bm), rep(Cm))
    torch.testing.assert_close(Y, Y0, atol=2e-4, rtol=0)
    torch.testing.assert_close(S, S0, atol=2e-4, rtol=0)
