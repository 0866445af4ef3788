#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. build  — compile the SDCA kernels from src/repro_torch/kernels/sdca/csrc
              with nvcc for sm_90a (one nvcc per source, started together);
  2. kernels against their plain PyTorch versions on the card, at the main
              path's shapes (10 tasks x 12000 rows x 784 features, B = 64),
              for the hinge, squared and smoothed-hinge losses;
  3. main path — DMTRLEstimator(solver="pallas_round") fits the paper's
              MNIST-width problem (mnist_like, scale 1.0) on the card, then
              scores and predicts; the fused round kernel must carry every
              round;
  4. second path — solver="pallas_block" on the paper's Synthetic-1 size,
              held against solver="block_gram" (plain torch) on the card.

It exits non-zero, printing no result, without a CUDA card or outside a
checkout of the repository. The line before the last is a JSON object with
each kernel's numbers; the last line is {"ok": true, "device": {...}}.
Float32 matmuls run in full float32 (TF32 off) throughout.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, 700 W): fp32 outside the tensor cores
# and HBM3 bandwidth; used for each kernel's bound
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

M, N_MAX, D, BLOCK = 10, 12000, 784, 64
GRAM_TRI = BLOCK * (BLOCK + 1) // 2  # Gram entries the B-step recursion reads
LOSSES = ("hinge", "squared", "smoothed_hinge")
# fp32 results of the block-Gram kernels against the sequential plain
# versions: the same arithmetic in another order. Measured on an H100 at
# the shapes below: over one local epoch (12032 steps) the two orders drift
# apart by up to 1.06e-4 on |r| ~ 20 (hinge), a 4.7x margin to TOL_ROUND;
# one block by up to 4.7e-5 (hinge), a 2.1x margin to TOL_BLOCK. The inputs
# come from fixed seeds and both sides sum in a fixed order, so the drift
# repeats from run to run, and a 2x margin only has to cover a change of
# card or compiler version.
TOL_ROUND = 5e-4
TOL_BLOCK = 1e-4
TOL_W, TOL_SIGMA = 2e-4, 1e-5  # fit parity bars of the JAX package's tests


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of fn() over reps calls after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch import prng
    from repro_torch.core import DMTRLEstimator
    from repro_torch.core import dual as dual_mod
    from repro_torch.core.sdca import coords_from_uniform, gather_rows, kappa_of
    from repro_torch.data.synthetic import mnist_like, synthetic
    from repro_torch.kernels.sdca import (
        build_all, ref, reset_launch_counts, sdca_block_kernel, sdca_round_kernel,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)  # name, power limit
    dev = torch.device("cuda", 0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # -- phase 1: build ----------------------------------------------------
    t0 = time.perf_counter()
    seconds = build_all()
    print(f"[1 build] {time.perf_counter() - t0:.2f} s wall; per source: "
          + ", ".join(f"{k} {v:.2f} s" for k, v in seconds.items()))

    # data of the main path (made on the host from a seed: set-up)
    t0 = time.perf_counter()
    mnist = mnist_like(scale=1.0, seed=0)
    train = mnist.train.to(dev)
    test = mnist.test.to(dev)
    print(f"[data] mnist_like scale 1.0: train x {tuple(train.x.shape)}, "
          f"test x {tuple(test.x.shape)} ({int(test.n[0])} rows per task, padded "
          f"to the train n_max), {time.perf_counter() - t0:.1f} s")
    check(tuple(train.x.shape) == (M, N_MAX, D), f"train shape {tuple(train.x.shape)}")

    # -- phase 2: kernels against their plain versions ----------------------
    rs = np.random.RandomState(0)
    x, y, n = train.x, train.y, train.n
    alpha = torch.from_numpy(0.5 * rs.rand(M, N_MAX).astype(np.float32)).to(dev) * y
    w = torch.from_numpy(0.01 * rs.randn(M, D).astype(np.float32)).to(dev)
    H = N_MAX + (-N_MAX) % BLOCK  # one local epoch, as the main path rounds it
    keys = prng.fold_in(prng.fold_in(prng.PRNGKey(0), torch.arange(M)), 0)
    u = prng.uniform(keys, (H,), device=dev)
    kappa = kappa_of(1.0, 1e-4, n, torch.full((M,), 1.0 / M, device=dev))

    err_round = 0.0
    r_state = None
    for loss in LOSSES:
        da_k, r_k = sdca_round_kernel(x, y, alpha, w, u, n, kappa, loss, block=BLOCK)
        torch.cuda.synchronize()
        da_p, r_p = ref.sdca_round_ref(x, y, alpha, w, u, n, kappa, loss)
        e = max((da_k - da_p).abs().max().item(), (r_k - r_p).abs().max().item())
        check(bool(torch.isfinite(da_k).all() and torch.isfinite(r_k).all()),
              f"sdca_round {loss}: non-finite output")
        print(f"[2 sdca_round {loss}] max|dalpha, r - plain| = {e:.3e} "
              f"(tolerance {TOL_ROUND:.0e}; max|r| {r_p.abs().max().item():.3f})")
        check(e <= TOL_ROUND, f"sdca_round {loss} disagrees with its plain version")
        err_round = max(err_round, e)
        if loss == "hinge":
            r_state = r_p
    ms_round = cuda_ms(torch, lambda: sdca_round_kernel(
        x, y, alpha, w, u, n, kappa, "hinge", block=BLOCK), reps=5)
    plain_round = cuda_ms(torch, lambda: ref.sdca_round_ref(
        x, y, alpha, w, u, n, kappa, "hinge"), reps=1)
    coords = coords_from_uniform(u, n)
    uniq = sum(int(torch.unique(coords[t]).numel()) for t in range(M))
    rows_bytes = uniq * D * 4 + uniq * 8  # gathered rows + their alpha, y
    io_bytes = (M * D * 4 + M * H * 4 + M * 8) + (M * N_MAX * 4 + M * D * 4)
    # per block: q, xr and r (3B dot products of length D) and the triangle
    # of the Gram the recursion reads (G[k, j] for j <= k)
    flops_round = 2.0 * M * (H // BLOCK) * (GRAM_TRI + 3 * BLOCK) * D
    b_round, by_round = bound_ms(rows_bytes + io_bytes, flops_round)
    print(f"[2 sdca_round] {ms_round:.3f} ms/call (plain {plain_round:.1f} ms), "
          f"bound {b_round:.4f} ms by {by_round} ({uniq} distinct rows, "
          f"{flops_round / 1e9:.2f} GFLOP) on {card}")

    cb = coords[:, :BLOCK].contiguous()
    xb = gather_rows(x, cb).contiguous()
    at0 = torch.gather(alpha, 1, cb).contiguous()
    yb = torch.gather(y, 1, cb).contiguous()
    cb32 = cb.to(torch.int32)
    err_block = 0.0
    for loss in LOSSES:
        d_k = sdca_block_kernel(xb, w, r_state, at0, yb, cb32, kappa, loss)
        torch.cuda.synchronize()
        d_p = ref.sdca_block_ref(xb, w, r_state, at0, yb, cb, kappa, loss)
        e = (d_k - d_p).abs().max().item()
        print(f"[2 sdca_block {loss}] max|deltas - plain| = {e:.3e} "
              f"(tolerance {TOL_BLOCK:.0e})")
        check(e <= TOL_BLOCK, f"sdca_block {loss} disagrees with its plain version")
        err_block = max(err_block, e)
    ms_block = cuda_ms(torch, lambda: sdca_block_kernel(
        xb, w, r_state, at0, yb, cb32, kappa, "hinge"), reps=50)
    plain_block = cuda_ms(torch, lambda: ref.sdca_block_ref(
        xb, w, r_state, at0, yb, cb, kappa, "hinge"), reps=5)
    block_bytes = M * BLOCK * D * 4 + 2 * M * D * 4 + 4 * M * BLOCK * 4 + M * 4
    flops_block = 2.0 * M * (GRAM_TRI + 2 * BLOCK) * D  # q, xr, Gram triangle
    b_block, by_block = bound_ms(block_bytes, flops_block)
    print(f"[2 sdca_block] {ms_block:.4f} ms/call (plain {plain_block:.2f} ms), "
          f"bound {b_block:.5f} ms by {by_block} on {card}")
    del alpha, w, u, r_state, xb

    # -- phase 3: the main path at MNIST width -------------------------------
    cfg = dict(solver="pallas_round", loss="hinge", lam=1e-4, outer_iters=2,
               rounds=5, local_iters=0, block_size=BLOCK)
    est = DMTRLEstimator(engine="reference", device="cuda", **cfg)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est.fit(train)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches_round = sdca_round_kernel.launches
    launches_block_main = sdca_block_kernel.launches
    n_rounds = cfg["outer_iters"] * cfg["rounds"]
    gap = est.history["gap"]
    print(f"[3 fit] gap per round: {np.array2string(gap, precision=5)}")
    print(f"[3 fit] {fit_s:.2f} s for {n_rounds} rounds = {fit_s / n_rounds * 1e3:.1f} "
          f"ms/round wall (objectives and Omega-steps included); "
          f"sdca_round launches {launches_round}")
    check(bool(np.all(np.isfinite(gap))), "gap is not finite")
    check(gap[-1] < gap[0], f"gap did not shrink: {gap[0]} -> {gap[-1]}")
    check(launches_round == n_rounds,
          f"sdca_round launched {launches_round} times, expected {n_rounds}")
    check(launches_block_main == 0, "the main path launched sdca_block")
    tr = float(torch.trace(est.sigma_))
    check(abs(tr - 1.0) <= 1e-5, f"tr(Sigma) = {tr}")
    W_alpha = dual_mod.weights_from_alpha(train, est.alpha_, est.sigma_, cfg["lam"])
    inv = (W_alpha - est.W_).abs().max().item()
    check(inv <= 1e-4, f"W != W(alpha): {inv}")
    acc = est.score(test)
    pred = est.predict(test.x[3, :5], tasks=3)
    direct = torch.where(test.x[3, :5] @ est.W_[3] >= 0, 1.0, -1.0)
    check(tuple(pred.shape) == (5,) and bool(torch.equal(pred, direct)),
          f"predict disagrees with sign(x . w_3): {pred} vs {direct}")
    print(f"[3 score] test error {1.0 - acc:.4f}, tr(Sigma) {tr:.7f}, "
          f"max|W - W(alpha)| {inv:.2e}, predict(task 3) {pred.tolist()}, "
          f"rho per outer {est.rho_per_outer_}")

    # where a warm round's time goes: the same 10 rounds again (partial_fit,
    # libraries initialized), under torch.profiler
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        est.partial_fit(train)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
    events = prof.key_averages()
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"[3 profile] warm partial_fit: {warm_s * 1e3 / n_rounds:.1f} ms/round wall "
          f"(profiler on), device busy {busy_ms / n_rounds:.1f} ms/round = "
          f"{busy_ms / (warm_s * 1e3):.1%} of wall; gap "
          f"{est.history['gap'][-1]:.5f}")
    for e in sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:6]:
        if e.self_device_time_total:
            print(f"[3 profile]   {e.self_device_time_total / 1e3 / n_rounds:9.3f} "
                  f"ms/round  x{e.count / n_rounds:g}  {e.key[:90]}")

    # -- phase 4: the per-block kernel on Synthetic-1 --------------------------
    syn = synthetic(1, seed=0)
    cfg4 = dict(loss="hinge", lam=1e-3, outer_iters=2, rounds=5, local_iters=0,
                block_size=BLOCK)
    fits = {}
    for solver in ("block_gram", "pallas_block"):
        est4 = DMTRLEstimator(solver=solver, device="cuda", **cfg4)
        reset_launch_counts()
        t0 = time.perf_counter()
        est4.fit(syn.train)
        torch.cuda.synchronize()
        fits[solver] = (est4, time.perf_counter() - t0, sdca_block_kernel.launches,
                        sdca_round_kernel.launches)
    ref_est, ref_s, _, _ = fits["block_gram"]
    blk_est, blk_s, launches_block, round_in_block = fits["pallas_block"]
    dW = (blk_est.W_ - ref_est.W_).abs().max().item()
    dS = (blk_est.sigma_ - ref_est.sigma_).abs().max().item()
    H4 = syn.train.n_max + (-syn.train.n_max) % BLOCK
    print(f"[4 synthetic1] x {tuple(syn.train.x.shape)}: pallas_block vs block_gram "
          f"max|dW| {dW:.3e} (tol {TOL_W:.0e}), max|dSigma| {dS:.3e} "
          f"(tol {TOL_SIGMA:.0e}); sdca_block launches {launches_block} "
          f"(= {n_rounds} rounds x {H4 // BLOCK} blocks); fit {blk_s:.2f} s vs "
          f"{ref_s:.2f} s; gap {blk_est.history['gap'][0]:.5f} -> "
          f"{blk_est.history['gap'][-1]:.5f}; test error "
          f"{1.0 - blk_est.score(syn.test):.4f}")
    check(dW <= TOL_W, "pallas_block W disagrees with block_gram")
    check(dS <= TOL_SIGMA, "pallas_block Sigma disagrees with block_gram")
    check(launches_block == n_rounds * (H4 // BLOCK),
          f"sdca_block launched {launches_block} times")
    check(round_in_block == 0, "the second path launched sdca_round")

    kernels = [
        dict(name="sdca_round", route="cuda",
             source="src/repro_torch/kernels/sdca/csrc/sdca_round.cu",
             replaces="src/repro/kernels/sdca/sdca_kernel.py:261",
             launches=launches_round, max_abs_err=err_round, ms=ms_round,
             plain_ms=plain_round, bound_ms=b_round, bound_by=by_round,
             library_ms=None),
        dict(name="sdca_block", route="cuda",
             source="src/repro_torch/kernels/sdca/csrc/sdca_block.cu",
             replaces="src/repro/kernels/sdca/sdca_kernel.py:143",
             launches=launches_block, max_abs_err=err_block, ms=ms_block,
             plain_ms=plain_block, bound_ms=b_block, bound_by=by_block,
             library_ms=None),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
