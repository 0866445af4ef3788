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
    cs = coords_from_uniform(u, n_i, n_max).view(m, H // block, block)
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
@pytest.mark.parametrize("block", [16, 32, 64])
@pytest.mark.parametrize("d", [100, 784, 1000, 3006])
def test_stage1_writes_gram_q_and_metadata(cuda, d, block):
    """Stage 1 alone against float64 on the rows its coordinates draw, per
    block: the Gram exactly symmetric (the recursion reads it by rows); the
    Gram and q within fp32's worst case for a sum of d products, (d + 4)
    2^-24 times the sum of the products' magnitudes (each FMA rounds once,
    then the partials of at most 4 column ranges are added); labels, alphas
    and coordinate ids bit-equal to the drawn rows'. d = 1000 is no multiple
    of 32, d = 3006 no multiple of 4 (4-byte copies); one task has no rows
    (its draws wrap to row n_max - 1), one has 7. Past d = 3008 the round
    streams and launches no stage 1."""
    m, n_max, H = 3, 40, 4 * block
    nb, sf = H // block, block * block + 4 * block
    x, y, alpha, w, u, _, kappa = _t(*_problem(d + block, m, n_max, d, H), device=cuda)
    n_i = torch.tensor([0, 7, n_max], dtype=torch.int32, device=cuda)
    scratch = torch.full((m * nb * sf,), float("nan"), device=cuda)
    sdca_kernel.sdca_round_stage(1, x, y, alpha, w, u, n_i, kappa, "hinge", scratch,
                                 torch.zeros_like(alpha), torch.zeros_like(w), block=block)
    torch.cuda.synchronize()
    blk = scratch.view(m, nb, sf)
    j = coords_from_uniform(u, n_i, n_max)
    xb = gather_rows(x, j).view(m, nb, block, d).double()
    wd = w.double()[:, None, :, None]
    G = blk[..., : block * block].view(m, nb, block, block)
    assert torch.equal(G, G.transpose(-1, -2))
    bound = (d + 4) * 2.0 ** -24
    G64, Gabs = xb @ xb.transpose(-1, -2), xb.abs() @ xb.abs().transpose(-1, -2)
    assert bool(((G.double() - G64).abs() <= bound * Gabs).all())
    q = blk[..., block * block: block * block + block]
    q64, qabs = (xb @ wd).squeeze(-1), (xb.abs() @ wd.abs()).squeeze(-1)
    assert bool(((q.double() - q64).abs() <= bound * qabs).all())
    meta = blk[..., block * block + block:].reshape(m, nb, 3, block)
    assert torch.equal(meta[:, :, 0], torch.gather(y, 1, j).view(m, nb, block))
    assert torch.equal(meta[:, :, 1], torch.gather(alpha, 1, j).view(m, nb, block))
    ids = meta[:, :, 2].contiguous().view(torch.int32)
    assert torch.equal(ids, j.to(torch.int32).view(m, nb, block))
    assert bool((j[0] == n_max - 1).all()) and bool((j[1] < 7).all())


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


@pytest.mark.parametrize("m,d,path,cluster", [
    (10, 784, "chain", 4), (16, 100, "chain", 4), (22, 2048, "chain", 8),
    (22, 3008, "chain", 8), (22, 3009, "stream", 12), (22, 10000, "stream", 12),
    (1, 10000, "stream", 16), (4096, 100, "chain", 2), (4096, 10000, "stream", 1),
])
def test_round_plan_rule(m, d, path, cluster):
    """The round keeps its two stages where a supported cluster fits d (the
    smallest of at least CLUSTER while the tasks are fewer than the SMs:
    4 at d = 784 and 100, 8 at d = 2048) and streams the rows in one kernel
    where none does, with as many CTAs a task (up to 16) as leave every
    task's CTAs resident together: 12 for 22 tasks, two a card's SM, and
    one, which waits for no other, for 4096 tasks."""
    k = sdca_kernel
    plan = k.round_plan(m, d, 64, 132)
    assert (plan.path, plan.cluster) == (path, cluster)
    assert k.round_cluster(m, d, 64, 132) == cluster
    if path == "chain":
        assert plan.warps == -1 and k.chain_smem_bytes(64, d, cluster) <= k.MAX_SMEM_BYTES
        return
    assert all(k.chain_smem_bytes(64, d, c) > k.MAX_SMEM_BYTES for c in k.SUPPORTED_CLUSTERS)
    assert plan.warps == k.STREAM_WARPS and 1 <= cluster <= k.STREAM_MAX_CTAS
    smem = k.stream_smem_bytes(64, d, cluster, plan.warps)
    assert smem <= k.MAX_SMEM_BYTES
    assert cluster == 1 or m * cluster <= 132 * (k.SM_SMEM_BYTES // (smem + 1024))


def test_round_plan_at_the_mds_width():
    """22 tasks at d = 10 000 stream in 12 CTAs a task of STREAM_WARPS
    warps, two CTAs on every SM of the card; a CTA's
    shared memory is StreamSmem's: the warps' rings of two 65 x 32 stages,
    the slab of r, the exchange buffer of 32 padded tiles, 4 diagonal
    blocks, the diagonal of rows 32..63, q and xr, the Gram, 17 vectors."""
    k = sdca_kernel
    assert k.round_plan(22, 10000, 64, 132) == k.RoundPlan("stream", 12, k.STREAM_WARPS)
    assert k.stream_smem_bytes(64, 10000, 8, 4) == 4 * (4 * 2 * 65 * 32 + 1252
                                                         + (32 * 68 + 4 * 28 + 32 + 128)
                                                         + 64 * 64 + 17 * 64)


def test_plan_for_explicit_cluster_and_hold():
    """A cluster alone asks for the chain path; warps (where the parent's
    plan took held columns) ask for the streamed round."""
    x = torch.empty((22, 5, 10000))
    pf = sdca_kernel.plan_for
    assert pf(x, 64, cluster=2) == sdca_kernel.RoundPlan("chain", 2)
    assert pf(x, 64, warps=4) == sdca_kernel.RoundPlan("stream", 1, 4)  # no SMs on the CPU
    assert pf(x, 64, cluster=16, warps=2) == sdca_kernel.RoundPlan("stream", 16, 2)


@pytest.mark.parametrize("m,d,path", [
    (22, 10000, "stream"), (22, 3008, "chain"), (22, 3012, "stream"), (1, 3012, "stream"),
    (10, 3008, "chain"),
])
def test_stream_plan_at_the_path_edge(m, d, path):
    """The rule on d at the MDS width and on both sides of 3008: the chain
    path takes no warps; the streamed round's CTAs fit two an SM from 8 a
    task on with 4 warps and three with 2, a single CTA holds the whole
    width, and the scratch is what the CTAs exchange."""
    k = sdca_kernel
    plan = k.round_plan(m, d, 64, 132)
    assert plan.path == path
    if path == "chain":
        assert plan.warps == -1
        return
    assert 2 * (k.stream_smem_bytes(64, d, 8, 4) + 1024) <= k.SM_SMEM_BYTES
    assert 3 * (k.stream_smem_bytes(64, d, 16, 2) + 1024) <= k.SM_SMEM_BYTES
    assert k.stream_smem_bytes(64, d, 1, 4) <= k.MAX_SMEM_BYTES
    assert k.stream_scratch_floats(64, m, plan.cluster) == m * ((plan.cluster + 1) * 2448 + 129)


def test_stage1_refused_on_the_stream_path():
    """The streamed round is one kernel: its stage 1 alone is refused before
    anything is launched or checked."""
    x, y, alpha, w, u, n_i, kappa = _t(*_problem(1, 2, 20, 3012, 64))
    assert sdca_kernel.plan_for(x, 64).path == "stream"
    with pytest.raises(ValueError, match="no stage 1"):
        sdca_kernel.sdca_round_stage(1, x, y, alpha, w, u, n_i, kappa, "hinge", None,
                                     torch.zeros_like(alpha), torch.zeros_like(w))
    with pytest.raises(ValueError, match="no stage 1"):
        sdca_kernel.sdca_round_stage(1, x[:, :, :100], y, alpha, w[:, :100], u, n_i, kappa,
                                     "hinge", None, torch.zeros_like(alpha),
                                     torch.zeros_like(w[:, :100]), warps=4)


def test_span_args_name_nothing_off_the_card():
    """The solve's span labels name K1's stage-2 plan only where K1 runs."""
    from repro_torch.core.solver_backends import get_backend

    x = torch.zeros((3, 10, 3009))
    assert ops.round_span_args(x, "hinge") == {}
    assert get_backend("pallas_round").span_args(x, "hinge", 64) == {}
    assert get_backend("block_gram").span_args(x, "hinge", 64) == {}


# ---------------------------------------------------------------------------
# the streaming stage 2 (d past what a supported cluster holds)
# ---------------------------------------------------------------------------
def _stream_counts():
    k = sdca_kernel.sdca_round_kernel
    return k.launches, k.stream_launches, k.gram_launches


@pytest.mark.gpu
@pytest.mark.parametrize("loss", KERNEL_LOSSES)
@pytest.mark.parametrize("m", [1, 22])
@pytest.mark.parametrize("d", [3009, 3012, 10000, 10001])
def test_round_kernel_streams_at_large_d(cuda, loss, m, d):
    """Past d = 3008 the round streams the rows (d = 10001: 4-byte loads)
    and agrees with its plain version; launches and stream_launches count
    it, gram_launches does not (no stage 1)."""
    x, y, alpha, w, u, n_i, kappa = _t(*_problem(d + m, m, 100, d, 256), device=cuda)
    assert sdca_kernel.plan_for(x, 64).path == "stream"
    launches, streamed, gram = _stream_counts()
    da, r = ops.sdca_round(x, y, alpha, w, u, n_i, kappa, loss, block=64)
    torch.cuda.synchronize()
    assert _stream_counts() == (launches + 1, streamed + 1, gram)
    da_p, r_p = ref.sdca_round_ref(x, y, alpha, w, u, n_i, kappa, loss)
    torch.testing.assert_close(da, da_p, atol=ATOL, rtol=0)
    torch.testing.assert_close(r, r_p, atol=ATOL, rtol=0)


def _staged_stream_round(x, y, alpha, w, u, n_i, kappa, loss, block=64, **plan):
    """The streamed round launched as ``sdca_round_stage``'s stage 2 (the
    whole round) on the plan given."""
    m, n_max, d = x.shape
    da, r = torch.zeros((m, n_max), device=x.device), torch.zeros((m, d), device=x.device)
    sdca_kernel.sdca_round_stage(2, x, y, alpha, w, u, n_i, kappa, loss, None, da, r,
                                 block=block, **plan)
    return da, r


@pytest.mark.gpu
@pytest.mark.parametrize("warps", sdca_kernel.STREAM_WARP_COUNTS)
@pytest.mark.parametrize("cluster", [1, 2, 5, 8, 12, 16])
def test_stream_every_cluster_and_hold(cuda, cluster, warps):
    """The streamed round at 1 to 16 CTAs a task and either warp count; at
    16 CTAs the last slabs of d = 3012 hold fewer columns than a warp's
    stage."""
    for d in (10000, 3012):
        x, y, alpha, w, u, n_i, kappa = _t(*_problem(cluster + warps + d, 5, 100, d, 256),
                                          device=cuda)
        da, r = _staged_stream_round(x, y, alpha, w, u, n_i, kappa, "hinge", cluster=cluster,
                                     warps=warps)
        da_p, r_p = ref.sdca_round_ref(x, y, alpha, w, u, n_i, kappa, "hinge")
        torch.testing.assert_close(da, da_p, atol=ATOL, rtol=0)
        torch.testing.assert_close(r, r_p, atol=ATOL, rtol=0)


@pytest.mark.gpu
def test_stream_refuses_what_does_not_fit(cuda):
    x, y, alpha, w, u, n_i, kappa = _t(*_problem(1, 1, 40, 10000, 64), device=cuda)
    with pytest.raises(ValueError, match="does not fit"):
        sdca_kernel.sdca_round_kernel(x, y, alpha, w, u, n_i, kappa, "hinge", cluster=8)
    wide = _t(*_problem(2, 1, 8, 70000, 64), device=cuda)
    with pytest.raises(ValueError, match="does not fit"):
        _staged_stream_round(*wide, "hinge", cluster=2, warps=4)
    with pytest.raises(ValueError, match="warps a CTA"):
        _staged_stream_round(x, y, alpha, w, u, n_i, kappa, "hinge", warps=3)
    with pytest.raises(ValueError, match="supports clusters"):
        _staged_stream_round(x, y, alpha, w, u, n_i, kappa, "hinge", cluster=17, warps=4)
    with pytest.raises(ValueError, match="no stage 1"):
        sdca_kernel.sdca_round_stage(1, x, y, alpha, w, u, n_i, kappa, "hinge", None,
                                     torch.zeros_like(alpha), torch.zeros_like(w))


@pytest.mark.gpu
def test_round_kernel_streams_at_mds_width(cuda):
    """Two tasks at the MDS width (d = 10 000, 14 525 rows, H = 14 528: 227
    blocks of 64) against the sequential plain version at TOL_ROUND's 5e-4,
    as at MNIST width."""
    x, y, alpha, w, u, n_i, kappa = _t(*_problem(3, 2, 14525, 10000, 14528), device=cuda)
    n_i = torch.tensor([14525, 219], dtype=torch.int32, device=cuda)
    launches, streamed, gram = _stream_counts()
    da, r = ops.sdca_round(x, y, alpha, w, u, n_i, kappa, "hinge", block=64)
    torch.cuda.synchronize()
    assert _stream_counts() == (launches + 1, streamed + 1, gram)
    da_p, r_p = ref.sdca_round_ref(x, y, alpha, w, u, n_i, kappa, "hinge")
    torch.testing.assert_close(da, da_p, atol=5e-4, rtol=0)
    torch.testing.assert_close(r, r_p, atol=5e-4, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("d,path,cluster", [(784, "chain", 4), (3009, "stream", 16)])
def test_fit_counts_stream_launches_and_labels_its_span(cuda, d, path, cluster):
    """A fit launches K1 once a round, on the streaming path exactly where
    d asks for it, and its local_sdca spans name the path and cluster."""
    from repro_torch import obs
    from repro_torch.core import DMTRLEstimator
    from repro_torch.core.mtl_data import from_task_list

    rs = np.random.RandomState(d)
    xs = [(rs.randn(n, d) / np.sqrt(d)).astype(np.float32) for n in (50, 90, 7)]
    ys = [np.where(rs.randn(len(x)) >= 0, 1.0, -1.0).astype(np.float32) for x in xs]
    train = from_task_list(xs, ys, device=cuda)
    est = DMTRLEstimator(device=cuda, solver="pallas_round", outer_iters=2, rounds=2,
                         block_size=64, seed=1)
    sdca_kernel.reset_launch_counts()
    tracer = obs.enable(clear=True)
    try:
        est.fit(train)
        torch.cuda.synchronize()
    finally:
        obs.disable()
    spans = [e for e in tracer.events() if e["name"] == "local_sdca"]
    tracer.clear()
    assert sdca_kernel.sdca_round_kernel.launches == 4
    assert sdca_kernel.sdca_round_kernel.stream_launches == (4 if path == "stream" else 0)
    assert sdca_kernel.sdca_round_kernel.gram_launches == (0 if path == "stream" else 4)
    assert len(spans) == 4
    assert all(e["args"] == {"stage2": path, "cluster": cluster} for e in spans)


@pytest.mark.gpu
@pytest.mark.parametrize("loss", KERNEL_LOSSES)
def test_round_kernel_stream_empty_tasks(cuda, loss):
    """The streaming stage 2 with n_i = 0 and a task of 7 rows (fewer than
    a block), the tasks a view into buffers with NaN sentinels, as
    test_round_kernel_empty_tasks."""
    n, d, H = 40, 10000, 128
    bufs = _t(*_empty_task_buffers(n + H, n, d, H), device=cuda)
    x, y, alpha, w, u, n_i, kappa = [b[1:-1] for b in bufs]
    assert sdca_kernel.plan_for(x, 64).path == "stream"
    da, r = ops.sdca_round(x, y, alpha, w, u, n_i, kappa, loss, block=64)
    torch.cuda.synchronize()
    assert torch.isfinite(da).all() and torch.isfinite(r).all()
    da_p, r_p = ref.sdca_round_ref(x, y, alpha, w, u, n_i, kappa, loss)
    torch.testing.assert_close(da, da_p, atol=ATOL, rtol=0)
    torch.testing.assert_close(r, r_p, atol=ATOL, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("loss", KERNEL_LOSSES)
@pytest.mark.parametrize("d", [3012, 10000])
def test_stream_round_duplicate_coordinates(cuda, loss, d):
    """The streamed round where coordinates repeat within a block: a task of
    one row (every draw the same coordinate), one of three rows and one of
    ninety, against the plain version."""
    x, y, alpha, w, u, _, kappa = _t(*_problem(d + 7, 3, 100, d, 192), device=cuda)
    n_i = torch.tensor([1, 3, 90], dtype=torch.int32, device=cuda)
    assert sdca_kernel.plan_for(x, 64).path == "stream"
    da, r = ops.sdca_round(x, y, alpha, w, u, n_i, kappa, loss, block=64)
    torch.cuda.synchronize()
    da_p, r_p = ref.sdca_round_ref(x, y, alpha, w, u, n_i, kappa, loss)
    torch.testing.assert_close(da, da_p, atol=ATOL, rtol=0)
    torch.testing.assert_close(r, r_p, atol=ATOL, rtol=0)
    assert bool((da[0, 1:] == 0).all()) and bool((da[1, 3:] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("d,path", [(784, "chain"), (3008, "chain"), (3012, "stream")])
def test_gram_launches_count_stage1_rounds(cuda, d, path):
    """gram_launches counts the rounds that launched stage 1: one a round on
    the chain path, none on the streamed one; sdca_round_stage counts
    nothing."""
    x, y, alpha, w, u, n_i, kappa = _t(*_problem(d, 2, 100, d, 128), device=cuda)
    assert sdca_kernel.plan_for(x, 64).path == path
    sdca_kernel.reset_launch_counts()
    for _ in range(3):
        ops.sdca_round(x, y, alpha, w, u, n_i, kappa, "hinge", block=64)
    sdca_kernel.sdca_round_stage(2, x, y, alpha, w, u, n_i, kappa, "hinge",
                                 torch.zeros(2 * 2 * (64 * 64 + 4 * 64), device=cuda),
                                 torch.zeros_like(alpha), torch.zeros_like(w))
    torch.cuda.synchronize()
    assert _stream_counts() == (3, 3 if path == "stream" else 0, 0 if path == "stream" else 3)


# ---------------------------------------------------------------------------
# tasks with no samples: n_i = 0 (a padded task, a pod slice past the
# task's samples) and 0 < n_i < n_max, as the mesh engines feed them
# ---------------------------------------------------------------------------
# the mesh engines' n_i per task, between two sentinel tasks (slots 0, -1)
EMPTY_N = (0, 0, 7, 0, None, 0)


def _empty_task_buffers(seed, n, d, H):
    """Inputs of 4 tasks with n_i = (0, 7, 0, n) inside buffers of 6: the
    first and last task and every row a task's plain version never reads
    (rows at and past n_i, but for the last row of an empty task, which
    -1 wraps to) hold NaN, so any read outside shows up in the outputs."""
    x, y, alpha, w, u, _, kappa = _problem(seed, len(EMPTY_N), n, d, H)
    n_i = np.array([n if v is None else v for v in EMPTY_N], np.int32)
    for t, nt in enumerate(n_i):
        read = np.zeros(n, bool)
        if 0 < t < len(EMPTY_N) - 1:
            read[:nt] = True
            read[n - 1] |= nt == 0
        x[t][~read] = np.nan
        y[t][~read] = np.nan
        alpha[t][~read] = np.nan
    return x, y, alpha, w, u, n_i, kappa


def test_empty_task_sentinels_stay_out_of_the_plain_round():
    """The plain version on the sentinel buffers reads only the tasks' own
    rows: its outputs are finite (the card tests below rely on it)."""
    x, y, alpha, w, u, n_i, kappa = [a[1:-1] for a in _t(*_empty_task_buffers(3, 40, 17, 64))]
    da, r = ref.sdca_round_ref(x, y, alpha, w, u, n_i, kappa, "hinge")
    assert torch.isfinite(da).all() and torch.isfinite(r).all()
    assert torch.isfinite(ref.sdca_round_ref(x, y, alpha, w, u, n_i, kappa, "squared")[1]).all()


@pytest.mark.gpu
@pytest.mark.parametrize("loss", KERNEL_LOSSES)
@pytest.mark.parametrize("n,d,H,block", SHAPES + [(300, 784, 256, 64)])
def test_round_kernel_empty_tasks(cuda, loss, n, d, H, block):
    """K1 with n_i = 0 and 0 < n_i < n_max against its plain version, the
    tasks a view into buffers with NaN sentinels: nothing outside a task's
    rows is read (the outputs stay finite) or written (dalpha equals the
    plain version's everywhere, so no task's entry moved for another)."""
    bufs = _t(*_empty_task_buffers(n + d + H, n, d, H), device=cuda)
    x, y, alpha, w, u, n_i, kappa = [b[1:-1] for b in bufs]
    assert x.data_ptr() == bufs[0].data_ptr() + n * d * 4  # a view: no copy
    da, r = ops.sdca_round(x, y, alpha, w, u, n_i, kappa, loss, block=block)
    torch.cuda.synchronize()
    assert torch.isfinite(da).all() and torch.isfinite(r).all()
    da_p, r_p = ref.sdca_round_ref(x, y, alpha, w, u, n_i, kappa, loss)
    torch.testing.assert_close(da, da_p, atol=ATOL, rtol=0)
    torch.testing.assert_close(r, r_p, atol=ATOL, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("loss", KERNEL_LOSSES)
@pytest.mark.parametrize("n,d,H,block", SHAPES)
def test_block_kernel_empty_tasks(cuda, loss, n, d, H, block):
    """The pallas_block solver (gather, K2, scatter) with n_i = 0 and
    0 < n_i < n_max on the card against the same solver on the CPU (the
    plain version), the tasks a view into the sentinel buffers."""
    from repro_torch.core.losses import get_loss
    from repro_torch.core.solver_backends import get_backend

    arrays = _empty_task_buffers(n * d + H, n, d, H)
    solve = get_backend("pallas_block").make_from_uniform(get_loss(loss), 1.0, 1e-3, H,
                                                          block=block)
    keys = prng.fold_in(prng.fold_in(prng.PRNGKey(4), torch.arange(4)), 0)
    sig = torch.full((4,), 0.25)
    out = []
    for dev in (cuda, torch.device("cpu")):
        x, y, alpha, w, _, n_i, _ = [b[1:-1] for b in _t(*arrays, device=dev)]
        before = sdca_kernel.sdca_block_kernel.launches
        da, r = solve(x, y, alpha, w, n_i, sig.to(dev), prng.uniform(keys, (H,), device=dev))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert sdca_kernel.sdca_block_kernel.launches == before + H // block
        assert torch.isfinite(da).all() and torch.isfinite(r).all()
        out.append((da.cpu(), r.cpu()))
    torch.testing.assert_close(out[0][0], out[1][0], atol=ATOL, rtol=0)
    torch.testing.assert_close(out[0][1], out[1][1], atol=ATOL, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("loss", KERNEL_LOSSES)
def test_block_kernel_one_row_drawn_for_the_whole_block(cuda, loss):
    """An empty task draws its last row B times: K2 with every coordinate
    equal, its inputs views between NaN slabs (nothing outside is read)."""
    m, d, B = 3, 33, 32
    rs = np.random.RandomState(9)
    row = (rs.randn(m, 1, d) / np.sqrt(d)).astype(np.float32)
    row[1] = 0.0  # an empty task's padded row
    xb = np.full((m + 2, B, d), np.nan, np.float32)
    xb[1:-1] = np.repeat(row, B, axis=1)
    w = (0.05 * rs.randn(m, d)).astype(np.float32)
    r = (0.1 * rs.randn(m, d)).astype(np.float32)
    at0 = np.repeat((0.1 * rs.randn(m, 1)).astype(np.float32), B, axis=1)
    yb = np.repeat(np.where(rs.randn(m, 1) >= 0, 1.0, -1.0).astype(np.float32), B, axis=1)
    yb[1] = 0.0
    cb = np.full((m, B), 39, np.int64)
    kappa = (0.01 * (0.5 + rs.rand(m))).astype(np.float32)
    xbuf, = _t(xb, device=cuda)
    args = [xbuf[1:-1]] + _t(w, r, at0, yb, device=cuda)
    cbt, kap = _t(cb, kappa, device=cuda)
    deltas = sdca_kernel.sdca_block_kernel(*args, cbt.to(torch.int32), kap, loss)
    torch.cuda.synchronize()
    assert torch.isfinite(deltas).all()
    d_p = ref.sdca_block_ref(*args, cbt, kap, loss)
    torch.testing.assert_close(deltas, d_p, atol=ATOL, rtol=0)
