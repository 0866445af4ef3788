"""Port's SSD layer against the JAX package's, on the CPU.

The same numpy inputs go through the JAX functions (the Pallas chunk
kernel in interpret mode, as tests/test_kernels.py runs it) and through
the port's, whose chunk kernel runs its plain version on CPU tensors.
Bars are those of tests/test_kernels.py: the chunk 1e-5; ``ssd_forward``
2e-5 against the JAX ``ssd_forward`` and ``ssd_chunked``, 2e-4 against the
naive recurrence and for B and C per group (the JAX functions take them per
head, so they get the groups repeated).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd import ssd_chunk_kernel as jax_chunk
from repro.kernels.ssd.ops import ssd_forward as jax_forward
from repro.kernels.ssd.ref import naive_recurrence as jax_naive
from repro.models.ssm import ssd_chunked as jax_chunked
from repro_torch.kernels.ssd import ops, ref
from repro_torch.models.ssm import ssd_chunked


def _seq(seed, B, L, H, P, N):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, L, H, P)
    dt = np.logaddexp(0.0, rs.randn(B, L, H)) * 0.1
    A = -np.exp(rs.randn(H))
    Bm = rs.randn(B, L, H, N) * 0.3
    Cm = rs.randn(B, L, H, N) * 0.3
    return [a.astype(np.float32) for a in (x, dt, A, Bm, Cm)]


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("B,H,nc,Q,P,N", [(2, 3, 4, 16, 8, 8), (1, 2, 2, 17, 16, 8)])
def test_chunk_ref_matches_jax_kernel(B, H, nc, Q, P, N):
    rs = np.random.RandomState(Q * P)
    x = rs.randn(B, H, nc, Q, P).astype(np.float32)
    dt = (np.logaddexp(0.0, rs.randn(B, H, nc, Q)) * 0.1).astype(np.float32)
    A = (-np.exp(rs.randn(H))).astype(np.float32)
    Bm = (rs.randn(B, H, nc, Q, N) * 0.3).astype(np.float32)
    Cm = (rs.randn(B, H, nc, Q, N) * 0.3).astype(np.float32)
    got = ops.ssd_chunk(*_t((x, dt, A, Bm, Cm)))
    want = jax_chunk(*_j((x, dt, A, Bm, Cm)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


# (B, L, H, P, N, chunk): L a multiple of the chunk, a ragged tail, and a
# prompt shorter than one chunk (Q = L)
SEQS = [(2, 80, 2, 16, 8, 16), (2, 53, 3, 8, 8, 16), (1, 11, 2, 16, 8, 64)]


@pytest.mark.parametrize("B,L,H,P,N,chunk", SEQS)
def test_ssd_forward_matches_jax(B, L, H, P, N, chunk):
    arrays = _seq(L * H, B, L, H, P, N)
    Y, S = ops.ssd_forward(*_t(arrays), chunk=chunk)
    for fn, tol in (
        (lambda *a: jax_forward(*a, chunk=chunk), 2e-5),
        (lambda *a: jax_chunked(*a, chunk=chunk), 2e-5),
        (jax_naive, 2e-4),
    ):
        Yj, Sj = fn(*_j(arrays))
        np.testing.assert_allclose(Y.numpy(), np.asarray(Yj), atol=tol)
        np.testing.assert_allclose(S.numpy(), np.asarray(Sj), atol=tol)


@pytest.mark.parametrize("B,L,H,P,N,chunk", SEQS)
def test_port_references_agree(B, L, H, P, N, chunk):
    """The port's three forms of the SSD function: the kernel pipeline, the
    all-torch ``ssd_chunked`` and the naive recurrence (the latter against
    the JAX naive recurrence too)."""
    arrays = _seq(L + 1, B, L, H, P, N)
    Y, S = ops.ssd_forward(*_t(arrays), chunk=chunk)
    Yc, Sc = ssd_chunked(*_t(arrays), chunk=chunk)
    Yn, Sn = ref.naive_recurrence(*_t(arrays))
    Yj, Sj = jax_naive(*_j(arrays))
    torch.testing.assert_close(Y, Yc, atol=2e-5, rtol=0)
    torch.testing.assert_close(S, Sc, atol=2e-5, rtol=0)
    torch.testing.assert_close(Y, Yn, atol=2e-4, rtol=0)
    torch.testing.assert_close(S, Sn, atol=2e-4, rtol=0)
    np.testing.assert_allclose(Yn.numpy(), np.asarray(Yj), atol=2e-5)
    np.testing.assert_allclose(Sn.numpy(), np.asarray(Sj), atol=2e-5)


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("B,L,H,P,N,chunk", [(2, 80, 4, 16, 8, 16), (1, 53, 4, 8, 16, 16),
                                             (1, 11, 4, 16, 8, 64)])
def test_ssd_forward_groups_match_jax(B, L, H, P, N, chunk, G):
    """B and C per group (G of H heads), as models/ssm.py passes them, against
    the JAX ``ssd_chunked`` on the groups repeated to every head."""
    x, dt, A, _, _ = _seq(L + G, B, L, H, P, N)
    rs = np.random.RandomState(G)
    Bg = (rs.randn(B, L, G, N) * 0.3).astype(np.float32)
    Cg = (rs.randn(B, L, G, N) * 0.3).astype(np.float32)
    Y, S = ops.ssd_forward(*_t((x, dt, A, Bg, Cg)), chunk=chunk)
    rep = lambda a: np.repeat(a, H // G, axis=2)
    Yj, Sj = jax_chunked(*_j((x, dt, A, rep(Bg), rep(Cg))), chunk=chunk)
    np.testing.assert_allclose(Y.numpy(), np.asarray(Yj), atol=2e-4)
    np.testing.assert_allclose(S.numpy(), np.asarray(Sj), atol=2e-4)
    # and the port's own per-head path on the repeated groups
    Yh, Sh = ops.ssd_forward(*_t((x, dt, A, rep(Bg), rep(Cg))), chunk=chunk)
    torch.testing.assert_close(Y, Yh, atol=2e-6, rtol=0)
    torch.testing.assert_close(S, Sh, atol=2e-6, rtol=0)


def test_ssd_forward_refuses_groups_that_do_not_divide_heads():
    x, dt, A, Bm, Cm = _t(_seq(0, 1, 16, 4, 8, 8))
    with pytest.raises(ValueError, match="groups"):
        ops.ssd_forward(x, dt, A, Bm[:, :, :3], Cm[:, :, :3], chunk=16)
