"""The port's SDCA kernel layer (repro_torch.kernels.sdca).

On the CPU: the port's plain versions behind ``ops.sdca_round`` /
``ops.sdca_block_apply`` against the JAX package's ``ops`` (Pallas kernels
in interpret mode for the kernel losses) at the shapes of
tests/test_solver_backends.py, atol 2e-5 (that file's bar).

On a CUDA card (marker ``gpu``; they skip here): each Hopper kernel against
its plain version. This module imports no JAX at top level so that the
card's run, which has no JAX, can collect it:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_sdca_kernel.py
"""
import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.core.sdca import gather_rows
from repro_torch.kernels.sdca import ops, ref, sdca_kernel

KERNEL_LOSSES = ("hinge", "squared", "smoothed_hinge")
SHAPES = [(70, 33, 96, 32), (40, 17, 64, 16)]  # (n, d, H, block)
ATOL = 2e-5


def _problem(seed, m, n, d, H):
    """m tasks of numpy inputs; n_valid = n - 5 so padding is never drawn."""
    rs = np.random.RandomState(seed)
    x = (rs.randn(m, n, d) / np.sqrt(d)).astype(np.float32)
    y = np.where(rs.randn(m, n) >= 0, 1.0, -1.0).astype(np.float32)
    alpha = (0.1 * rs.randn(m, n)).astype(np.float32)
    w = (0.05 * rs.randn(m, d)).astype(np.float32)
    u = rs.rand(m, H).astype(np.float32)
    n_i = np.full((m,), n - 5, np.int32)
    kappa = (0.5 + rs.rand(m)).astype(np.float32) * 0.01
    return x, y, alpha, w, u, n_i, kappa


def _t(*arrays, device="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays]


@pytest.mark.parametrize("loss", KERNEL_LOSSES)
@pytest.mark.parametrize("n,d,H,block", SHAPES)
def test_sdca_round_plain_matches_jax(loss, n, d, H, block):
    import jax.numpy as jnp
    from repro.kernels.sdca import ops as jops

    m = 2
    x, y, alpha, w, u, n_i, kappa = _problem(n * d, m, n, d, H)
    da, r = ops.sdca_round(*_t(x, y, alpha, w, u, n_i, kappa), loss, block=block)
    for t in range(m):
        da_j, r_j = jops.sdca_round(
            jnp.asarray(x[t]), jnp.asarray(y[t]), jnp.asarray(alpha[t]),
            jnp.asarray(w[t]), jnp.asarray(u[t]), jnp.int32(n_i[t]),
            jnp.float32(kappa[t]), loss, block=block,
        )
        np.testing.assert_allclose(da[t].numpy(), np.asarray(da_j), atol=ATOL)
        np.testing.assert_allclose(r[t].numpy(), np.asarray(r_j), atol=ATOL)


def _block_inputs(seed, m, n, d, block, dup=False):
    x, y, alpha, w, u, n_i, kappa = _problem(seed, m, n, d, block)
    rs = np.random.RandomState(seed + 1)
    cb = rs.randint(0, n - 5, size=(m, block)).astype(np.int64)
    if dup:  # one coordinate drawn three times in the block
        cb[:, 3] = cb[:, 0]
        cb[:, block - 1] = cb[:, 0]
    r = (0.1 * rs.randn(m, d)).astype(np.float32)
    xb = np.take_along_axis(x, cb[:, :, None], axis=1)
    at0 = np.take_along_axis(alpha, cb, axis=1)
    yb = np.take_along_axis(y, cb, axis=1)
    return xb, w, r, at0, yb, cb, kappa


@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("loss", KERNEL_LOSSES)
@pytest.mark.parametrize("n,d,H,block", SHAPES)
def test_sdca_block_plain_matches_jax(loss, n, d, H, block, dup):
    import jax.numpy as jnp
    from repro.kernels.sdca import ops as jops

    m = 2
    xb, w, r, at0, yb, cb, kappa = _block_inputs(n + d, m, n, d, block, dup)
    deltas = ops.sdca_block_apply(*_t(xb, w, r, at0, yb, cb, kappa), loss)
    for t in range(m):
        d_j = jops.sdca_block_apply(
            jnp.asarray(xb[t]), jnp.asarray(w[t]), jnp.asarray(r[t]),
            jnp.asarray(at0[t]), jnp.asarray(yb[t]), jnp.asarray(cb[t], jnp.int32),
            jnp.float32(kappa[t]), loss,
        )
        np.testing.assert_allclose(deltas[t].numpy(), np.asarray(d_j), atol=ATOL)


@pytest.mark.parametrize("loss", ["logistic", "eps_insensitive"])
def test_non_kernel_losses_route_to_plain(loss):
    """Losses without a closed-form kernel delta take the plain version."""
    x, y, alpha, w, u, n_i, kappa = _t(*_problem(5, 2, 40, 9, 32))
    before = sdca_kernel.sdca_round_kernel.launches
    da, r = ops.sdca_round(x, y, alpha, w, u, n_i, kappa, loss, block=16)
    da_p, r_p = ref.sdca_round_ref(x, y, alpha, w, u, n_i, kappa, loss)
    assert torch.equal(da, da_p) and torch.equal(r, r_p)
    assert sdca_kernel.sdca_round_kernel.launches == before


def test_duplicate_coordinates_accumulate():
    """A task with one valid sample draws it every time: dalpha[0] must hold
    the sum of every step's delta (index_add/scatter_add semantics)."""
    x, y, alpha, w, u, _, kappa = _t(*_problem(9, 2, 12, 6, 32))
    n_i = torch.ones(2, dtype=torch.int32)
    da, r = ops.sdca_round(x, y, alpha, w, u, n_i, kappa, "squared", block=16)
    # replay the steps by hand on the single coordinate
    for t in range(2):
        atilde, rr, total = alpha[t, 0].item(), torch.zeros(6), 0.0
        x0 = x[t, 0]
        for _ in range(32):
            c = float(x0 @ w[t]) + kappa[t].item() * float(x0 @ rr)
            a = kappa[t].item() * float(x0 @ x0)
            delta = (y[t, 0].item() - c - atilde) / (1.0 + a)
            atilde += delta
            total += delta
            rr = rr + delta * x0
        assert da[t, 0].item() == pytest.approx(total, rel=1e-4, abs=1e-5)
        assert torch.all(da[t, 1:] == 0)


def test_wrapper_rejects_non_cuda_tensors():
    x, y, alpha, w, u, n_i, kappa = _t(*_problem(1, 1, 20, 4, 16))
    with pytest.raises(ValueError, match="CUDA tensors"):
        sdca_kernel.sdca_round_kernel(x, y, alpha, w, u, n_i, kappa, "hinge", block=16)


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
@pytest.mark.parametrize("loss", KERNEL_LOSSES)
@pytest.mark.parametrize("n,d,H,block", SHAPES + [(300, 784, 256, 64)])
def test_round_kernel_matches_plain(cuda, loss, n, d, H, block):
    arrays = _problem(n * d + 1, 3, n, d, H)
    x, y, alpha, w, u, n_i, kappa = _t(*arrays, device=cuda)
    before = sdca_kernel.sdca_round_kernel.launches
    da, r = ops.sdca_round(x, y, alpha, w, u, n_i, kappa, loss, block=block)
    torch.cuda.synchronize()
    assert sdca_kernel.sdca_round_kernel.launches == before + 1
    da_p, r_p = ref.sdca_round_ref(x, y, alpha, w, u, n_i, kappa, loss)
    torch.testing.assert_close(da, da_p, atol=ATOL, rtol=0)
    torch.testing.assert_close(r, r_p, atol=ATOL, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("loss", KERNEL_LOSSES)
@pytest.mark.parametrize("n,d,H,block", SHAPES + [(300, 784, 64, 64)])
def test_block_kernel_matches_plain(cuda, loss, n, d, H, block, dup):
    xb, w, r, at0, yb, cb, kappa = _t(
        *_block_inputs(n + d, 3, n, d, block, dup), device=cuda
    )
    before = sdca_kernel.sdca_block_kernel.launches
    deltas = ops.sdca_block_apply(xb, w, r, at0, yb, cb, kappa, loss)
    torch.cuda.synchronize()
    assert sdca_kernel.sdca_block_kernel.launches == before + 1
    d_p = ref.sdca_block_ref(xb, w, r, at0, yb, cb, kappa, loss)
    torch.testing.assert_close(deltas, d_p, atol=ATOL, rtol=0)


@pytest.mark.gpu
def test_round_kernel_draws_sample_coords(cuda):
    """The kernel's on-device coordinate mapping is sample_coords': the
    entries of dalpha that move are the coordinates sample_coords draws."""
    m, n, d, H = 2, 50, 8, 64
    x, y, alpha, w, _, n_i, kappa = _t(*_problem(3, m, n, d, H), device=cuda)
    keys = prng.split(prng.PRNGKey(4), m)
    u = prng.uniform(keys, (H,), device=cuda)
    da, _ = ops.sdca_round(x, y, alpha, w, u, n_i, kappa, "squared", block=16)
    from repro_torch.core.sdca import sample_coords

    coords = sample_coords(keys, H, n_i, n)
    for t in range(m):
        drawn = set(coords[t].tolist())
        moved = set(torch.nonzero(da[t]).flatten().tolist())
        assert moved <= drawn and len(moved) >= len(drawn) - 1
    assert gather_rows(x, coords).shape == (m, H, d)


@pytest.mark.gpu
def test_wrapper_raises_on_unsupported_block(cuda):
    x, y, alpha, w, u, n_i, kappa = _t(*_problem(1, 1, 40, 4, 48), device=cuda)
    with pytest.raises(ValueError, match="block sizes"):
        ops.sdca_round(x, y, alpha, w, u, n_i, kappa, "hinge", block=48)
