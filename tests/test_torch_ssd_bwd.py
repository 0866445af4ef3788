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
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.ssm import ssd_chunked as jax_ssd_chunked
from repro_torch.configs import all_configs
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


@pytest.mark.parametrize("B,L,H,G,P,N,chunk",
                         [c for c in CASES if c[1] % min(c[6], c[1]) == 0])
def test_plain_backward_in_fp64_is_the_exact_function(B, L, H, G, P, N, chunk):
    """``chunk_bwd_ref(..., compute=torch.float64)`` on fp64 inputs equals
    float64 autograd of the masked forward (1e-12), so it measures how far
    the fp32 plain version (and, on the card, the kernel) is from the exact
    function: within 1e-5 here."""
    inputs = _inputs(L * H + G + 1, B, L, H, G, P, N)
    cots = _cotangents(L + N + 1, B, L, H, P, N, chunk)
    wide, wide_cots = [t.double() for t in inputs], [c.double() for c in cots]
    exact = ref.chunk_bwd_ref(*wide, *wide_cots, chunk, compute=torch.float64)
    _close(exact, _autograd(_masked64, wide, wide_cots, chunk), 1e-12, "fp64 vs autograd")
    mixed = ref.chunk_bwd_ref(*inputs, *cots, chunk)
    _close([m.double() for m in mixed], exact, TOL, "chunk_bwd_ref vs fp64")


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
        ssd_kernel.check_bwd_shape(64, 128, 128)  # fp32: B and C take 68 KB
    ssd_kernel.check_bwd_shape(64, 128, 128, bf16=True)  # bf16 B, C, x fit
    ssd_kernel.check_bwd_shape(64, 64, 128)  # mamba2-780m
    ssd_kernel.check_bwd_shape(64, 64, 64)  # zamba2-2.7b
    assert ssd_kernel.bwd_smem_bytes(64, 128, 64) == 167936
    assert ssd_kernel.bwd_smem_bytes(64, 128, 64, bf16=True) == 188416  # two stages


def _per_head_smem_bytes(Q, N, P):
    """The shared memory of the per-head design this kernel replaced: its
    limits are the floor of the new plan's."""
    QP, NP, PP = (-(-v // 16) * 16 for v in (Q, N, P))
    MT, NT, PT = QP // 16, NP // 16, PP // 16
    mats = 2 * QP * (NP + 4) + 2 * QP * (PP + 4) + NP * (PP + 4) + 2 * QP * (QP + 4)
    return 4 * (mats + 7 * QP + 2 * MT * MT * 16 + (NT + PT) * QP)


@pytest.mark.parametrize("bf16", [False, True])
def test_backward_plan_takes_every_shape_the_per_head_design_took(bf16):
    for Q in (1, 16, 17, 32, 48, 63, 64):
        for N in (1, 8, 30, 64, 96, 112, 120, 128):
            for P in (1, 8, 18, 64, 96, 112, 120, 128):
                if _per_head_smem_bytes(Q, N, P) <= ssd_kernel.MAX_SMEM_BYTES:
                    ssd_kernel.check_bwd_shape(Q, P, N, bf16)


# clusters of c CTAs an H100 80GB HBM3 holds at once at mamba2-780m's plan
# (cudaOccupancyMaxActiveClusters; chip_smoke.py phase 2 prints them; the
# same at zamba2-2.7b's and in fp32)
H100_CLUSTERS = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15, 9: 9, 10: 7,
                 11: 7, 12: 7, 13: 7, 14: 7, 15: 7, 16: 7}


def _smoke_shapes():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return [(label, B, L, H, G, P, N, min(chunk, L), bf16)
            for label, B, L, H, G, P, N, chunk, bf16, _ in smoke.SSD_BWD_SHAPES]


def _ssm_shapes():
    out = []
    for arch, cfg in all_configs().items():
        for c in (cfg, cfg.reduced()):
            if c.ssm_heads:
                for B, L in ((2, 1024), (1, 64)):  # training; a short prompt
                    out.append((c.name, B, L, c.ssm_heads, c.ssm_groups, c.ssm_head_dim,
                                c.ssm_state, min(c.ssm_chunk, L), c.dtype == "bfloat16"))
    return out


@pytest.mark.parametrize("case", _ssm_shapes() + _smoke_shapes(), ids=lambda c: f"{c[0]}-{c[2]}")
def test_backward_launch_plan(case):
    """Head block, cluster, grid and shared memory for every SSM config and
    every phase-2 shape: within 227 KB, clusters of at most 16 that divide
    the grid's x, every CTA with at least one head and the group's heads
    covered once."""
    label, B, L, H, G, P, N, Q, bf16 = case
    hg = H // G
    cluster = ssd_kernel.bwd_cluster(B * -(-L // Q) * G, hg, H100_CLUSTERS.get)
    plan = ssd_kernel.bwd_plan(Q, P, N, hg, bf16, cluster)
    grid = (G * plan.cluster, -(-L // Q), B)  # ssd_chunk_bwd.cu's launch
    assert plan.smem_bytes <= ssd_kernel.MAX_SMEM_BYTES
    assert plan.smem_bytes == ssd_kernel.bwd_smem_bytes(Q, N, P, bf16)
    assert 1 <= plan.cluster <= ssd_kernel.MAX_CLUSTER and grid[0] % plan.cluster == 0
    assert (plan.cluster - 1) * plan.head_block < hg <= plan.cluster * plan.head_block
    assert plan.stages in (1, 2)


def test_backward_cluster_rule():
    """mamba2-780m's and zamba2-2.7b's training steps (2 x 16 chunks, 48
    and 80 heads a group) on the H100's residency: 3 CTAs a group, every
    cluster in one wave; four chunks of 48 heads (phase 2's overflow
    shape): 16 CTAs of 3 heads, past the portable 8 (each the fastest
    size in chip_smoke.py phase 2's sweeps); a size the card cannot hold
    is passed over; one head a group, one CTA."""
    assert ssd_kernel.bwd_cluster(32, 48, H100_CLUSTERS.get) == 3
    assert ssd_kernel.bwd_cluster(32, 80, H100_CLUSTERS.get) == 3
    assert ssd_kernel.bwd_cluster(4, 48, H100_CLUSTERS.get) == 16
    assert ssd_kernel.bwd_cluster(1, 48, H100_CLUSTERS.get) == 16
    portable = {c: n if c <= 8 else 0 for c, n in H100_CLUSTERS.items()}
    assert ssd_kernel.bwd_cluster(4, 48, portable.get) == 8
    assert ssd_kernel.bwd_cluster(100, 1, H100_CLUSTERS.get) == 1
    # 13 heads: the head block never divides them past one CTA
    plan = ssd_kernel.bwd_plan(64, 64, 128, 13, True, 8)
    assert (plan.head_block, plan.cluster) == (2, 7)


@pytest.mark.parametrize("G", [1, 2, 4])
def test_group_terms_factor_over_the_heads(G):
    """What the kernel relies on to form dB's and dC's group terms once per
    CTA: B and C are shared by a group's heads, so sum_h (dG_h o M_h) B =
    (sum_h dG_h o M_h) B, and the same for dB with C; plus dB's per-head
    term sum_h d_end_h o (u_h dS_h^T). Written out per group in plain torch
    and held against chunk_bwd_ref."""
    B, L, H, P, N, chunk = 2, 48, 8, 8, 16, 16
    x, dt, A, Bm, Cm = _inputs(31 + G, B, L, H, G, P, N)
    dY, dS, da = _cotangents(37 + G, B, L, H, P, N, chunk)
    want = ref.chunk_bwd_ref(x, dt, A, Bm, Cm, dY, dS, da, chunk)
    Q, nc, hg = chunk, L // chunk, H // G
    xc = x.reshape(B, nc, Q, G, hg, P)
    dYc = dY.reshape(B, nc, Q, G, hg, P)
    dtc = dt.reshape(B, nc, Q, G, hg)
    Bc, Cc = Bm.reshape(B, nc, Q, G, N), Cm.reshape(B, nc, Q, G, N)
    dSc = dS.reshape(B, nc, G, hg, N, P)
    cum = torch.cumsum(dtc * A.reshape(G, hg), dim=2)  # (B, nc, Q, G, hg)
    tri = torch.ones((Q, Q), dtype=torch.bool).tril()
    diff = cum[:, :, :, None] - cum[:, :, None]  # (B, nc, t, tau, G, hg)
    M = torch.exp(diff.masked_fill(~tri[None, None, :, :, None, None], float("-inf")))
    d_end = torch.exp(cum[:, :, -1:] - cum)
    u = xc * dtc[..., None]
    dG = torch.einsum("bcqghp,bckghp->bcqkgh", dYc, u)
    D = (dG * M).sum(-1)  # the group's sum over its heads, once
    dC = torch.einsum("bcqkg,bckgn->bcqgn", D, Bc)
    S = (d_end[..., None] * torch.einsum("bckghp,bcghnp->bckghn", u, dSc)).sum(-2)
    dB = torch.einsum("bcqkg,bcqgn->bckgn", D, Cc) + S
    for name, got, w in (("dB", dB, want[3]), ("dC", dC, want[4])):
        got = got.reshape(B, L, G, N)
        err = (got - w).abs().max().item()
        assert err <= 1e-5 * max(1.0, w.abs().max().item()), (G, name, err)
