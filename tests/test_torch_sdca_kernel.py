"""The port's SDCA kernel layer (repro_torch.kernels.sdca).

On the CPU: the port's plain versions behind ``ops.sdca_round`` /
``ops.sdca_block_apply`` against the JAX package's ``ops`` (Pallas kernels
in interpret mode for the kernel losses) at the shapes of
tests/test_solver_backends.py, atol 2e-5 (that file's bar).

Also on the CPU: a plain emulation of the round kernel's staged algorithm
(every block's Gram and q first, then the right-looking chain with alpha~
carried across blocks) against the JAX ``sdca_round_kernel``, atol 2e-5;
and a float32 emulation of the block kernel's (Gram, q and xr summed over
column slabs in rank order, the right-looking recursion with each row's
divisor inverted first) against the JAX ``sdca_block_kernel``, atol 2e-5.

On a CUDA card (marker ``gpu``; they skip here): each Hopper kernel against
its plain version. This module imports no JAX at top level so that the
card's run, which has no JAX, can collect it:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_sdca_kernel.py
"""
import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.core.losses import get_loss
from repro_torch.core.sdca import coords_from_uniform, gather_rows
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


def _staged_round(x, y, alpha, w, u, n_i, kappa, loss, block):
    """The round kernel's algorithm in plain torch: stage 1 forms G and q of
    every block from the drawn coordinates at once; stage 2 walks the
    blocks in order, alpha~ = alpha + dalpha at block start, and runs the
    right-looking recursion (each delta pushed into the running c and
    duplicate sums of the later rows)."""
    delta_fn = get_loss(loss).sdca_delta
    m, n_max, d = x.shape
    H = u.shape[1]
    cs = coords_from_uniform(u, n_i).view(m, H // block, block)
    tasks = torch.arange(m)[:, None]
    xb = gather_rows(x, cs.reshape(m, H)).view(m, H // block, block, d)
    G = xb @ xb.transpose(-1, -2)  # stage 1: (m, blocks, B, B)
    q = (xb @ w[:, None, :, None])[..., 0]  # (m, blocks, B)
    dalpha = torch.zeros((m, n_max))
    r = torch.zeros((m, d))
    for b in range(H // block):
        cb = cs[:, b]
        acc = (xb[:, b] @ r[:, :, None])[..., 0]  # xr, then + sum G delta
        at0 = alpha.gather(1, cb) + dalpha.gather(1, cb)
        yb = y.gather(1, cb)
        dup = torch.zeros((m, block))
        deltas = torch.zeros((m, block))
        for k in range(block):
            dk = delta_fn(at0[:, k] + dup[:, k], q[:, b, k] + kappa * acc[:, k],
                          kappa * G[:, b, k, k], yb[:, k])
            deltas[:, k] = dk
            acc = acc + G[:, b, k] * dk[:, None]
            dup = dup + torch.where(cb == cb[:, k:k + 1], dk[:, None], 0.0)
        for k in range(block):  # duplicates accumulate in draw order
            dalpha[tasks[:, 0], cb[:, k]] += deltas[:, k]
        r = r + (xb[:, b].transpose(1, 2) @ deltas[:, :, None])[..., 0]
    return dalpha, r


@pytest.mark.parametrize("loss", KERNEL_LOSSES)
@pytest.mark.parametrize("n,d,H,block", SHAPES)
def test_staged_round_matches_jax(loss, n, d, H, block):
    """The two numerical choices of the round kernel (Gram and q of all
    blocks up front, right-looking recursion) hold the JAX kernel's bar;
    H > n, so coordinates repeat within and across blocks."""
    import jax.numpy as jnp
    from repro.kernels.sdca import sdca_kernel as jkernel

    m = 2
    x, y, alpha, w, u, n_i, kappa = _problem(n * d + 7, m, n, d, H)
    da, r = _staged_round(*_t(x, y, alpha, w, u, n_i, kappa), loss, block)
    for t in range(m):
        da_j, r_j = jkernel.sdca_round_kernel(
            jnp.asarray(x[t]), jnp.asarray(y[t]), jnp.asarray(alpha[t]),
            jnp.asarray(w[t]), jnp.asarray(u[t]), jnp.int32(n_i[t]),
            jnp.float32(kappa[t]), loss, block=block, interpret=True,
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


def _delta_recip(loss, atilde, c, inv, y):
    """sdca_common.cuh's delta_of_recip: the closed-form delta with the
    divisor's reciprocal taken before the chain."""
    if loss == "hinge":
        return y * torch.clamp(y * (atilde + (y - c) * inv), 0.0, 1.0) - atilde
    if loss == "squared":
        return (y - c - atilde) * inv
    anew_u = atilde + (y - c - 0.5 * atilde) * inv
    return y * torch.clamp(y * anew_u, 0.0, 1.0) - atilde


def _recip(loss, a):
    if loss == "hinge":
        return 1.0 / torch.clamp(a, min=1e-12)
    return 1.0 / ((1.0 if loss == "squared" else 0.5) + a)


def _cluster_block(xb, w, r, at0, yb, cb, kappa, loss, cluster):
    """The block kernel's algorithm in float32: each of ``cluster`` column
    slabs (multiples of 4 columns) forms partial G, q and xr, summed in rank
    order; then the right-looking recursion (each delta pushed into the
    running c and duplicate sums of the later rows)."""
    m, B, d = xb.shape
    dcp = (-(-d // cluster) + 3) // 4 * 4
    G = torch.zeros((m, B, B))
    q = torch.zeros((m, B))
    xr = torch.zeros((m, B))
    for rank in range(cluster):
        sl = slice(rank * dcp, min(d, (rank + 1) * dcp))
        xs = xb[..., sl]
        G = G + xs @ xs.transpose(1, 2)
        q = q + (xs @ w[:, sl, None])[..., 0]
        xr = xr + (xs @ r[:, sl, None])[..., 0]
    acc = xr.clone()
    dup = torch.zeros((m, B))
    inv = _recip(loss, kappa[:, None] * torch.diagonal(G, dim1=1, dim2=2))
    deltas = torch.zeros((m, B))
    for k in range(B):
        dk = _delta_recip(loss, at0[:, k] + dup[:, k], q[:, k] + kappa * acc[:, k],
                          inv[:, k], yb[:, k])
        deltas[:, k] = dk
        acc = acc + G[:, k] * dk[:, None]
        dup = dup + torch.where(cb == cb[:, k:k + 1], dk[:, None], 0.0)
    return deltas


@pytest.mark.parametrize("cluster", [1, 8])
@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("loss", KERNEL_LOSSES)
@pytest.mark.parametrize("n,d,H,block", SHAPES)
def test_cluster_block_matches_jax(loss, n, d, H, block, dup, cluster):
    import jax.numpy as jnp
    from repro.kernels.sdca import sdca_kernel as jkernel

    m = 2
    xb, w, r, at0, yb, cb, kappa = _block_inputs(n + d + 3, m, n, d, block, dup)
    deltas = _cluster_block(*_t(xb, w, r, at0, yb, cb, kappa), loss, cluster)
    for t in range(m):
        d_j = jkernel.sdca_block_kernel(
            jnp.asarray(xb[t]), jnp.asarray(w[t]), jnp.asarray(r[t]), jnp.asarray(at0[t]),
            jnp.asarray(yb[t]), jnp.asarray(cb[t], jnp.int32), jnp.float32(kappa[t]), loss,
            interpret=True,
        )
        np.testing.assert_allclose(deltas[t].numpy(), np.asarray(d_j), atol=ATOL)


def test_block_cluster_rule():
    """Slabs of at least BLOCK_SLAB_MIN_COLS columns, as many as fit: four
    CTAs at Synthetic-1's d = 100, eight at MNIST's d = 784, one for a
    narrow d."""
    assert sdca_kernel.block_cluster(100) == 4
    assert sdca_kernel.block_cluster(60) == 2
    assert sdca_kernel.block_cluster(17) == 1
    assert sdca_kernel.block_cluster(784) == 8
    assert sdca_kernel.block_cluster(5000) == 8


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
@pytest.mark.parametrize("cluster", sdca_kernel.SUPPORTED_CLUSTERS)
@pytest.mark.parametrize("m", [1, 13])
@pytest.mark.parametrize("n,d,H,block", SHAPES + [(120, 100, 512, 64)])
def test_round_kernel_every_cluster(cuda, cluster, m, n, d, H, block):
    """Every cluster size, one task and many, d not a multiple of 4 C
    (33, 17), H > n (coordinates repeat within and across blocks)."""
    x, y, alpha, w, u, n_i, kappa = _t(*_problem(n + d + m, m, n, d, H), device=cuda)
    before = sdca_kernel.sdca_round_kernel.launches
    da, r = sdca_kernel.sdca_round_kernel(x, y, alpha, w, u, n_i, kappa, "hinge",
                                          block=block, cluster=cluster)
    torch.cuda.synchronize()
    assert sdca_kernel.sdca_round_kernel.launches == before + 1
    da_p, r_p = ref.sdca_round_ref(x, y, alpha, w, u, n_i, kappa, "hinge")
    torch.testing.assert_close(da, da_p, atol=ATOL, rtol=0)
    torch.testing.assert_close(r, r_p, atol=ATOL, rtol=0)


@pytest.mark.gpu
def test_round_kernel_in_scratch_groups(cuda, monkeypatch):
    """A scratch smaller than the round's blocks runs it in groups of
    blocks (stage 1 then stage 2 per group) with the same result."""
    x, y, alpha, w, u, n_i, kappa = _t(*_problem(11, 3, 70, 33, 96 * 4), device=cuda)
    whole = sdca_kernel.sdca_round_kernel(x, y, alpha, w, u, n_i, kappa, "squared", block=32)
    per_block = 4 * 3 * (32 * 32 + 4 * 32)
    monkeypatch.setattr(sdca_kernel, "SCRATCH_CAP_BYTES", 5 * per_block)  # 12 blocks: 5, 5, 2
    before = sdca_kernel.sdca_round_kernel.launches
    grouped = sdca_kernel.sdca_round_kernel(x, y, alpha, w, u, n_i, kappa, "squared", block=32)
    torch.cuda.synchronize()
    assert sdca_kernel.sdca_round_kernel.launches == before + 1
    for a, b in zip(whole, grouped):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_round_kernel_at_mnist_width(cuda):
    """Two tasks at the MNIST width (12000 rows x 784, one local epoch of
    H = 12032): 188 blocks of 64 chained through a cluster. The sequential
    plain version sums in another order over 12032 steps, so the bar is
    chip_smoke.py's TOL_ROUND (5e-4), not the 2e-5 of the test shapes."""
    x, y, alpha, w, u, n_i, kappa = _t(*_problem(2, 2, 12000, 784, 12032), device=cuda)
    n_i = torch.full((2,), 12000, dtype=torch.int32, device=cuda)
    before = sdca_kernel.sdca_round_kernel.launches
    da, r = ops.sdca_round(x, y, alpha, w, u, n_i, kappa, "hinge", block=64)
    torch.cuda.synchronize()
    assert sdca_kernel.sdca_round_kernel.launches == before + 1
    da_p, r_p = ref.sdca_round_ref(x, y, alpha, w, u, n_i, kappa, "hinge")
    torch.testing.assert_close(da, da_p, atol=5e-4, rtol=0)
    torch.testing.assert_close(r, r_p, atol=5e-4, rtol=0)


@pytest.mark.gpu
def test_round_stages_apart_equal_the_round(cuda):
    """Stage 1 then stage 2 launched apart (the timing path) give the
    round's result and do not count as launches of it."""
    m, n, d, H, block = 3, 300, 784, 256, 64
    x, y, alpha, w, u, n_i, kappa = _t(*_problem(5, m, n, d, H), device=cuda)
    da, r = sdca_kernel.sdca_round_kernel(x, y, alpha, w, u, n_i, kappa, "hinge", block=block)
    before = sdca_kernel.sdca_round_kernel.launches
    scratch = torch.empty(m * (H // block) * (block * block + 4 * block), device=cuda)
    da2, r2 = torch.zeros_like(da), torch.zeros_like(r)
    for stage in (1, 2):
        sdca_kernel.sdca_round_stage(stage, x, y, alpha, w, u, n_i, kappa, "hinge",
                                     scratch, da2, r2, block=block)
    torch.cuda.synchronize()
    assert sdca_kernel.sdca_round_kernel.launches == before
    assert torch.equal(da, da2) and torch.equal(r, r2)


@pytest.mark.gpu
def test_round_kernel_refuses_what_does_not_fit(cuda):
    x, y, alpha, w, u, n_i, kappa = _t(*_problem(1, 1, 40, 784, 64), device=cuda)
    with pytest.raises(ValueError, match="does not fit"):
        sdca_kernel.sdca_round_kernel(x, y, alpha, w, u, n_i, kappa, "hinge", cluster=2)
    with pytest.raises(ValueError, match="clusters"):
        sdca_kernel.sdca_round_kernel(x, y, alpha, w, u, n_i, kappa, "hinge", cluster=3)


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


@pytest.mark.gpu
@pytest.mark.parametrize("cluster", sdca_kernel.SUPPORTED_BLOCK_CLUSTERS)
@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("m", [1, 13])
@pytest.mark.parametrize("n,d,H,block", SHAPES + [(300, 784, 64, 64), (120, 100, 64, 64)])
def test_block_kernel_every_cluster(cuda, cluster, dup, m, n, d, H, block):
    """Every cluster size, one task and many, d not a multiple of 4 (33,
    17: 4-byte copies), slabs left empty (d = 17 over 8 CTAs)."""
    xb, w, r, at0, yb, cb, kappa = _t(*_block_inputs(n + d + m, m, n, d, block, dup),
                                      device=cuda)
    before = sdca_kernel.sdca_block_kernel.launches
    deltas = sdca_kernel.sdca_block_kernel(xb, w, r, at0, yb, cb.to(torch.int32), kappa,
                                           "smoothed_hinge", cluster=cluster)
    torch.cuda.synchronize()
    assert sdca_kernel.sdca_block_kernel.launches == before + 1
    d_p = ref.sdca_block_ref(xb, w, r, at0, yb, cb, kappa, "smoothed_hinge")
    torch.testing.assert_close(deltas, d_p, atol=ATOL, rtol=0)


@pytest.mark.gpu
def test_block_kernel_refuses_unsupported_cluster(cuda):
    xb, w, r, at0, yb, cb, kappa = _t(*_block_inputs(1, 1, 40, 17, 16), device=cuda)
    with pytest.raises(ValueError, match="clusters"):
        sdca_kernel.sdca_block_kernel(xb, w, r, at0, yb, cb.to(torch.int32), kappa, "hinge",
                                      cluster=3)


def test_round_cluster_rule():
    """Stage 2 keeps CLUSTER CTAs per task while the tasks are fewer than the
    SMs, and takes the fewest that fit d once they fill the card."""
    rc = sdca_kernel.round_cluster
    assert rc(10, 784, 64, 132) == sdca_kernel.CLUSTER
    assert rc(131, 100, 64, 132) == sdca_kernel.CLUSTER
    assert rc(4096, 100, 64, 132) == 2
    fits = [c for c in sdca_kernel.SUPPORTED_CLUSTERS
            if sdca_kernel.chain_smem_bytes(64, 784, c) <= sdca_kernel.MAX_SMEM_BYTES]
    assert rc(4096, 784, 64, 132) == min(fits) > 2
