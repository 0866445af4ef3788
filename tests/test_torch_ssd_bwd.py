"""The SSD chunk's backward (K4-bwd's math) on the CPU.

``ref.chunk_bwd_ref``, the closed-form backward of ``ref.chunk_seq_ref``,
against autograd of that forward in fp32 (bar 1e-5: the same function in
another order of sums) for per-head and grouped B and C, a ragged last
chunk and non-zero cotangents of all three outputs; bf16 inputs give the
fp32 widening's gradients rounded once. Where a chunk's decay passes exp's
fp32 range (about 88.7) autograd of ``chunk_seq_ref`` and ``jax.grad`` of
the JAX package's ``ssd_chunked`` give NaN in d(dt) and dA (ROADMAP RC5);
there the plain backward is finite and held against float64 autograd of the
masked formulation. The autograd Function ``ops.SSDChunk`` (through
``ops.ssd_forward``) against ``jax.vjp`` of ``repro.models.ssm.ssd_chunked``
at 2e-5 wherever JAX's gradient is finite, B and C repeated per head on
JAX's side and the head gradients summed back per group.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.ssm import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels.ssd import ops, ref, ssd_kernel

TOL = 1e-5
TOL_JAX = 2e-5
NAMES = ("dx", "ddt", "dA", "dB", "dC")


def _inputs(seed, B, L, H, G, P, N, dt_scale=0.1):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, L, H, P)
    dt = np.logaddexp(0.0, rs.randn(B, L, H)) * dt_scale
    A = -np.exp(rs.randn(H))
    Bm = rs.randn(B, L, G, N) * 0.3
    Cm = rs.randn(B, L, G, N) * 0.3
    return [torch.from_numpy(a.astype(np.float32)) for a in (x, dt, A, Bm, Cm)]


def _cotangents(seed, B, L, H, P, N, chunk):
    Q = min(chunk, L)
    nc = -(-L // Q)
    rs = np.random.RandomState(seed)
    return [torch.from_numpy(rs.randn(*s).astype(np.float32))
            for s in ((B, L, H, P), (B, nc, H, N, P), (B, nc, H))]


def _autograd(fn, inputs, cots, chunk):
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    outs = fn(*leaves, chunk)
    return torch.autograd.grad(outs, leaves, cots)


def _close(got, want, tol, what):
    for name, a, b in zip(NAMES, got, want):
        assert a.dtype == b.dtype, (what, name)
        err = (a.double() - b.double()).abs().max().item()
        scale = max(1.0, b.double().abs().max().item())
        assert err <= tol * scale, f"{what} {name}: {err:.3e} over {tol * scale:.3e}"


# (B, L, H, G, P, N, chunk): B and C per head, grouped (G < H), a ragged
# last chunk, a prompt shorter than one chunk, one group over all heads
CASES = [
    (2, 32, 3, 3, 8, 8, 16),
    (2, 48, 4, 2, 8, 16, 16),
    (2, 37, 4, 2, 16, 8, 16),
    (1, 11, 2, 1, 16, 8, 64),
    (1, 40, 6, 1, 8, 8, 8),
]


@pytest.mark.parametrize("B,L,H,G,P,N,chunk", CASES)
def test_plain_backward_matches_autograd(B, L, H, G, P, N, chunk):
    inputs = _inputs(L * H + G, B, L, H, G, P, N)
    cots = _cotangents(L + N, B, L, H, P, N, chunk)
    want = _autograd(ref.chunk_seq_ref, inputs, cots, chunk)
    got = ref.chunk_bwd_ref(*inputs, *cots, chunk)
    _close(got, want, TOL, "chunk_bwd_ref")


@pytest.mark.parametrize("which", ["dY", "dS", "da"])
def test_plain_backward_of_each_output(which):
    """Each cotangent alone (the other two zero): every term of the
    closed form is reached on its own."""
    B, L, H, G, P, N, chunk = 2, 37, 4, 2, 16, 8, 16
    inputs = _inputs(3, B, L, H, G, P, N)
    cots = [c if name == which else torch.zeros_like(c)
            for name, c in zip(("dY", "dS", "da"), _cotangents(4, B, L, H, P, N, chunk))]
    want = _autograd(ref.chunk_seq_ref, inputs, cots, chunk)
    got = ref.chunk_bwd_ref(*inputs, *cots, chunk)
    _close(got, want, TOL, f"chunk_bwd_ref ({which} only)")


def test_plain_backward_of_bf16_inputs_is_the_widened_one_rounded():
    """x, B and C in bf16 (views of the model's conv output): the backward
    computes on their fp32 widening and rounds dx, dB and dC once; d(dt)
    and dA stay fp32. The widened gradients match autograd at 1e-5."""
    B, L, H, G, P, N, chunk = 2, 40, 4, 1, 16, 16, 16
    x, dt, A, Bm, Cm = _inputs(7, B, L, H, G, P, N)
    xb, Bb, Cb = (t.to(torch.bfloat16) for t in (x, Bm, Cm))
    wide = [xb.float(), dt, A, Bb.float(), Cb.float()]
    cots = _cotangents(8, B, L, H, P, N, chunk)
    got = ref.chunk_bwd_ref(xb, dt, A, Bb, Cb, *cots, chunk)
    fp32 = ref.chunk_bwd_ref(*wide, *cots, chunk)
    for name, a, b in zip(NAMES, got, fp32):
        want = b.to(torch.bfloat16) if name in ("dx", "dB", "dC") else b
        assert a.dtype == want.dtype and torch.equal(a, want), name
    _close(fp32, _autograd(ref.chunk_seq_ref, wide, cots, chunk), TOL, "widened")


def _overflowing(seed, B=1, L=64, H=2, G=1, P=8, N=8):
    """One chunk of 64 steps with dt = 0.1 and A = -16 on the last head:
    mamba2-780m's init pairs them, and -sum(dt A) over the chunk reaches
    about 101, past exp's fp32 range above the diagonal."""
    x, dt, A, Bm, Cm = _inputs(seed, B, L, H, G, P, N)
    dt = torch.full_like(dt, 0.1)
    A = torch.tensor([-1.0] * (H - 1) + [-16.0])
    return [x, dt, A, Bm, Cm]


def _masked64(x, dt, A, Bm, Cm, chunk):
    """``chunk_seq_ref`` in float64 with the exponential masked before it is
    taken (its gradient is finite everywhere)."""
    B_, L, H, P = x.shape
    G = Bm.shape[2]
    Q = min(chunk, L)
    nc = L // Q

    def to_chunks(a):
        if a.shape[2] != H:
            a = torch.repeat_interleave(a, H // a.shape[2], dim=2)
        return a.reshape((B_, nc, Q) + tuple(a.shape[2:])).movedim(3, 1)

    xc, Bc, Cc = to_chunks(x), to_chunks(Bm), to_chunks(Cm)
    dtc = to_chunks(dt[..., None])[..., 0]
    cum = torch.cumsum(dtc * A[None, :, None, None], -1)
    tri = torch.ones((Q, Q), dtype=torch.bool).tril()
    M = torch.exp((cum[..., :, None] - cum[..., None, :]).masked_fill(~tri, float("-inf")))
    u = xc * dtc[..., None]
    Y = torch.einsum("bhcqk,bhckp->bhcqp", torch.einsum("bhcqn,bhckn->bhcqk", Cc, Bc) * M, u)
    S = torch.einsum("bhcqn,bhcqp->bhcnp", Bc * torch.exp(cum[..., -1:] - cum)[..., None], u)
    Y = Y.movedim(1, 3).reshape(B_, L, H, P)
    return Y, S.transpose(1, 2), torch.exp(cum[..., -1]).transpose(1, 2)


def test_plain_backward_is_finite_where_exp_overflows():
    inputs = _overflowing(11)
    cum_end = float((inputs[1][0, :, -1] * inputs[2][-1]).sum())
    assert cum_end < -88.7  # the decay over the chunk passes exp's range
    B, L, H, P = inputs[0].shape
    cots = _cotangents(12, B, L, H, P, inputs[3].shape[-1], 64)
    got = ref.chunk_bwd_ref(*inputs, *cots, 64)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    want = _autograd(_masked64, [t.double() for t in inputs], [c.double() for c in cots], 64)
    _close([g.double() for g in got], want, TOL, "chunk_bwd_ref vs float64")
    # autograd of the exp-then-mask forward (the JAX package's form) is not
    naive = _autograd(ref.chunk_seq_ref, inputs, cots, 64)
    assert not torch.isfinite(naive[1]).all() and not torch.isfinite(naive[2]).all()


def _jax_vjp(inputs, cot_y, cot_state, chunk):
    """jax.vjp of ssd_chunked with B and C repeated per head; the B and C
    gradients summed back per group."""
    x, dt, A, Bm, Cm = (jnp.asarray(t.numpy()) for t in inputs)
    H, G = x.shape[2], Bm.shape[2]
    rep = lambda a: jnp.repeat(a, H // G, axis=2)

    def f(x, dt, A, Bm, Cm):
        return jax_ssd_chunked(x, dt, A, rep(Bm), rep(Cm), chunk)

    _, vjp = jax.vjp(f, x, dt, A, Bm, Cm)
    return [torch.from_numpy(np.array(g)) for g in
            vjp((jnp.asarray(cot_y.numpy()), jnp.asarray(cot_state.numpy())))]


def _port_grads(inputs, cot_y, cot_state, chunk):
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    Y, state = ops.ssd_forward(*leaves, chunk=chunk)
    return torch.autograd.grad((Y, state), leaves, (cot_y, cot_state))


@pytest.mark.parametrize("B,L,H,G,P,N,chunk", [
    (2, 48, 4, 4, 8, 8, 16),
    (2, 53, 4, 2, 16, 8, 16),
    (1, 40, 6, 1, 8, 16, 8),
])
def test_ssd_forward_gradients_match_jax(B, L, H, G, P, N, chunk):
    """The Function's backward (chunk_bwd_ref on the CPU) plus autograd of the
    inter-chunk recurrence against jax.vjp of ssd_chunked."""
    inputs = _inputs(L + G, B, L, H, G, P, N)
    rs = np.random.RandomState(B + L)
    cot_y = torch.from_numpy(rs.randn(B, L, H, P).astype(np.float32))
    cot_state = torch.from_numpy(rs.randn(B, H, P, N).astype(np.float32))
    before = ssd_kernel.ssd_chunk_bwd_kernel.launches
    got = _port_grads(inputs, cot_y, cot_state, chunk)
    assert ssd_kernel.ssd_chunk_bwd_kernel.launches == before  # CPU: the plain backward
    _close(got, _jax_vjp(inputs, cot_y, cot_state, chunk), TOL_JAX, "ssd_forward vs jax.vjp")


def test_ssd_forward_gradients_where_jax_overflows():
    """Two chunks of 64 at the overflowing decay: JAX's d(dt) and dA are NaN
    (RC5), the port's are finite; dx, dB and dC, finite on both sides,
    agree at 2e-5."""
    inputs = _overflowing(21, B=1, L=128, H=2, G=1, P=8, N=8)
    rs = np.random.RandomState(22)
    cot_y = torch.from_numpy(rs.randn(1, 128, 2, 8).astype(np.float32))
    cot_state = torch.from_numpy(rs.randn(1, 2, 8, 8).astype(np.float32))
    got = _port_grads(inputs, cot_y, cot_state, 64)
    want = _jax_vjp(inputs, cot_y, cot_state, 64)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert not torch.isfinite(want[1]).all() and not torch.isfinite(want[2]).all()
    for name, a, b in zip(NAMES, got, want):
        if name in ("dx", "dB", "dC"):
            assert torch.isfinite(b).all()
            err = (a - b).abs().max().item()
            assert err <= TOL_JAX * max(1.0, b.abs().max().item()), (name, err)


def test_backward_kernel_refuses_cpu_tensors_and_shapes_it_does_not_take():
    inputs = _inputs(0, 1, 16, 2, 1, 8, 8)
    cots = _cotangents(1, 1, 16, 2, 8, 8, 16)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_kernel.ssd_chunk_bwd_kernel(*inputs, *cots, chunk=16)
    with pytest.raises(ValueError, match="Q <= 64"):
        ssd_kernel.check_bwd_shape(128, 64, 64)
    with pytest.raises(ValueError, match="shared memory"):
        ssd_kernel.check_bwd_shape(64, 128, 128)
    ssd_kernel.check_bwd_shape(64, 64, 128)  # mamba2-780m
    ssd_kernel.check_bwd_shape(64, 64, 64)  # zamba2-2.7b
    assert ssd_kernel.bwd_smem_bytes(64, 128, 64) == 178944
