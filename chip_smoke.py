#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. build  — compile the four kernels (SDCA round and block, flash
              attention, SSD chunk) from src/repro_torch/kernels/*/csrc with
              nvcc for sm_90a (one nvcc per source, started together);
  2. kernels against their plain PyTorch versions on the card, at their
              paths' shapes: the SDCA round at 10 tasks x 12000 rows x 784
              features, B = 64, for the hinge, squared and smoothed-hinge
              losses (its two stages also timed apart, and at each cluster
              size that fits); the SDCA block at that width and at
              Synthetic-1's (16 tasks, d = 100), there also with duplicate
              coordinates, timed at every cluster size beside its chain
              floor; flash attention at Zamba2-2.7B's (1, 32, 512, 80),
              causal, bf16 (tensor-core kernel) and fp32 (fp32 kernel), each
              with and without a 128 window, timed beside
              scaled_dot_product_attention; the SSD chunk with dt and A in
              the model's ranges, per head in the chunked layout (1, 80, 8,
              64, 64, 64) and in Zamba2's own layout (bf16 views of the conv
              output, one B/C group), plus a ragged 17-step chunk and
              Q = N = P = 128 in fp32 and bf16;
  3. main path — DMTRLEstimator(solver="pallas_round") fits the paper's
              MNIST-width problem (mnist_like, scale 1.0) on the card, then
              scores and predicts; the fused round kernel must carry every
              round;
  4. second path — solver="pallas_block" on the paper's Synthetic-1 size,
              held against solver="block_gram" (plain torch) on the card;
  5. LM path — Zamba2-2.7B at full width (54 Mamba2 layers, the shared
              attention block 9 times; bf16, random weights from seed 0)
              behind ServingEngine(batch=4, max_len=1024) answers 6 greedy
              requests of 16 tokens (prompts of 512, 300, 129, 64, 200 and
              17 tokens; the last two enter freed slots); every prefill
              must launch flash attention 9 times and the SSD chunk 54
              times, decode ticks neither;
  5b. consistency — the same model in fp32: prefill of 256 tokens plus 3
              decode steps against prefills of 257, 258 and 259 tokens;
  6. MTL serving — (a) phase 3's estimator behind scoring_engine(batch=256)
              (warmup() captures the score tile as a CUDA graph) scores the
              20 000 test rows against decision_function, then the same
              rows stream through serving_scheduler(batch=256) with one
              partial_fit halfway; (b) serving_fleet(n_replicas=4) on the
              one card (one capture, adopted by the other replicas) routes
              them by task affinity through one rolling publish; (c) the
              structured Sigma at 4096 tasks: a low_rank_diag fit of
              Synthetic-1 (m = 4096, d = 100, about 100 rows a task)
              through the round kernel, its test rows served with their
              Sigma rows, and one graphical_lasso Omega-step (phase 2 holds
              the round kernel against its plain version at this shape).

It exits non-zero, printing no result, without a CUDA card or outside a
checkout of the repository. The line before the last is a JSON object with
each kernel's numbers; the last line is {"ok": true, "device": {...}}.
Float32 matmuls run in full float32 (TF32 off) throughout. Kernel times are
CUDA-event means over back-to-back calls queued behind a sleep on the
stream, so they are device times, not the host's launch pace.
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

# H100 SXM peaks (NVIDIA data sheet, 700 W): fp32 outside the tensor cores,
# dense bf16 and TF32 on the tensor cores and HBM3 bandwidth; used for each
# kernel's bound
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12

M, N_MAX, D, BLOCK = 10, 12000, 784, 64
GRAM_TRI = BLOCK * (BLOCK + 1) // 2  # Gram entries the B-step recursion reads
LOSSES = ("hinge", "squared", "smoothed_hinge")
# fp32 results of the block-Gram kernels against the sequential plain
# versions: the same arithmetic in another order. Measured on an H100 at
# the shapes below: over one local epoch (12032 steps) the two orders drift
# apart by up to 7.6e-5 on |r| ~ 20 (hinge), a 6.6x margin to TOL_ROUND;
# one block by up to 4.7e-5 (hinge), a 2.1x margin to TOL_BLOCK. The inputs
# come from fixed seeds and both sides sum in a fixed order, so the drift
# repeats from run to run, and a 2x margin only has to cover a change of
# card or compiler version.
TOL_ROUND = 5e-4
TOL_BLOCK = 1e-4
TOL_W, TOL_SIGMA = 2e-4, 1e-5  # fit parity bars of the JAX package's tests

# Zamba2-2.7B's shapes for the LM kernels: the shared block's attention
# (32 heads of 80) over the longest prompt, and one Mamba2 layer's SSD
# chunks (80 heads, P = N = 64, chunks of 64) over it
ATTN_HEADS, ATTN_S, ATTN_HD, ATTN_WINDOW = 32, 512, 80, 128
SSD_H, SSD_NC, SSD_Q, SSD_P, SSD_N = 80, 8, 64, 64, 64
# flash attention and the SSD chunk against their plain versions. Flash:
# the JAX package's bars (tests/test_kernels.py: fp32 1e-5, bf16 2e-2);
# measured on an H100 at the shapes below, 1.13e-6 in fp32 (8.8x margin)
# and 1.56e-2 in bf16: one bf16 step (2^-6) of an output in [2, 4). The
# bf16 kernel rounds P to bf16 (at most 2^-9 relative per weight), so its
# fp32 output differs from the plain one's by well under a step, and the
# two bf16 roundings differ by at most one step; max|plain| is 3.34 at
# these inputs, under 4, where the step would double. The SSD chunk: the
# JAX bar is 1e-5 at its test ranges, where |cumsum(dt A)| stays below
# about 5. At Mamba2's ranges (A down to -16, dt up to about 0.3) it
# reaches about -300 over a chunk, where fp32 values are 3e-5 apart, so
# exp(cum_t - cum_tau) carries a relative rounding of about 1e-5 that
# depends on the order of the prefix sums (the kernel's warp scan against
# torch.cumsum); on |Y_intra| up to 7.2 that measured 1.43e-5 (relative
# 2e-6). Held at 5e-5: a 3.5x margin.
TOL_FLASH_F32, TOL_FLASH_BF16, TOL_SSD = 1e-5, 2e-2, 5e-5
# the serving main path (phase 5) and its fp32 consistency check (5b)
PROMPT_LENS = (512, 300, 129, 64, 200, 17)
NEW_TOKENS, SERVE_BATCH, SERVE_MAX_LEN = 16, 4, 1024
CONSIST_S = 256
# fp32 prefill (chunked SSD through K4, flash attention through K3) against
# the recurrent plain decode over 54 layers: the same function summed in
# another order. tests/test_serve.py's decode bar; measured on an H100
# 5.4e-5 on logits up to 5.0 (a 9.3x margin).
TOL_CONSIST = 5e-4
# the MTL serving path (phase 6): tiles of 256 requests at MNIST width, a
# fleet of 4 replicas on the one card, and the structured Sigma at 4096
# tasks of Synthetic-1 (d = 100, about 100 train and 50 test rows a task)
SCORE_BATCH, N_REPLICAS = 256, 4
MANY_M, MANY_D, MANY_N_TRAIN, MANY_N_TEST, MANY_RANK = 4096, 100, 100, 50, 32
# served scores against the estimator's predict path: the same per-row dot
# products in another kernel (a gather and a row-wise dot against
# predictions' batched product); the JAX package's serving tests hold them
# at 1e-5. Sigma rows gathered from the factors against the dense view:
# the same products in another order, 1e-6 as in tests/test_sigma_view.py.
TOL_SCORE, TOL_SIGMA_ROW = 1e-5, 1e-6


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of fn() over reps calls after one warm-up call. The
    stream first sleeps for about 50 ms, so the host queues the calls ahead
    of the start event and a kernel shorter than its own launch overhead is
    timed back to back on the device, not at the host's pace."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # cycles
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, flops: float, peak_flops: float = PEAK_FP32_FLOPS):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def lm_kernel_checks(torch, dev, card: str) -> dict:
    """Phase 2 for flash attention (K3) and the SSD chunk (K4): each kernel
    against its plain version at the main path's shapes, CUDA-event times
    and bounds."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash import flash_kernel
    from repro_torch.kernels.flash import ref as flash_ref
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd import ref as ssd_ref
    from repro_torch.kernels.ssd import ssd_kernel

    rs = np.random.RandomState(1)
    H, S, HD = ATTN_HEADS, ATTN_S, ATTN_HD
    qkv32 = [torch.from_numpy(rs.randn(1, H, S, HD).astype(np.float32)).to(dev)
             for _ in range(3)]
    err_flash = 0.0
    for label, dtype, window, tol in (
        ("bf16", torch.bfloat16, 0, TOL_FLASH_BF16),
        (f"bf16 window {ATTN_WINDOW}", torch.bfloat16, ATTN_WINDOW, TOL_FLASH_BF16),
        ("fp32", torch.float32, 0, TOL_FLASH_F32),
        (f"fp32 window {ATTN_WINDOW}", torch.float32, ATTN_WINDOW, TOL_FLASH_F32),
    ):
        q, k, v = (t.to(dtype) for t in qkv32)
        out = flash_kernel.flash_attention(q, k, v, True, window)
        torch.cuda.synchronize()
        want = flash_ref.attention_ref(q, k, v, True, window)
        check(bool(torch.isfinite(out).all()), f"flash {label}: non-finite output")
        e = (out.float() - want.float()).abs().max().item()
        print(f"[2 flash_fwd {label}] max|out - plain| = {e:.3e} (tolerance {tol:.0e})")
        check(e <= tol, f"flash {label} disagrees with its plain version")
        err_flash = max(err_flash, e)
    q, k, v = (t.to(torch.bfloat16) for t in qkv32)
    ms_flash = cuda_ms(torch, lambda: flash_kernel.flash_attention(q, k, v, True, 0), reps=50)
    plain_flash = cuda_ms(torch, lambda: flash_ref.attention_ref(q, k, v, True, 0), reps=10)
    lib_flash = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True), reps=50)
    # q, k, v read once and o written once, bf16; QK^T and PV over the
    # causal triangle
    b_flash, by_flash = bound_ms(4 * q.numel() * 2, 4.0 * H * HD * S * (S + 1) / 2,
                                 PEAK_BF16_FLOPS)
    print(f"[2 flash_fwd] bf16 {tuple(q.shape)} causal: {ms_flash:.4f} ms/call (plain "
          f"{plain_flash:.3f} ms, scaled_dot_product_attention {lib_flash:.4f} ms), "
          f"bound {b_flash:.5f} ms by {by_flash} on {card}")

    Hs, nc, Q, P, N = SSD_H, SSD_NC, SSD_Q, SSD_P, SSD_N
    dt0 = np.exp(np.linspace(np.log(1e-3), np.log(1e-1), Hs))
    dt_bias = dt0 + np.log(-np.expm1(-dt0))
    A = -torch.linspace(1.0, 16.0, Hs, device=dev)  # A = -exp(A_log) at init

    def ssd_check(label, got, want):
        err = 0.0
        for name, a, b in zip(("Y_intra", "S_local", "a_tot"), got, want):
            check(bool(torch.isfinite(a).all()), f"ssd_chunk {label} {name}: non-finite output")
            e = (a - b).abs().max().item()
            print(f"[2 ssd_chunk {label}] max|{name} - plain| = {e:.3e} (max|plain| "
                  f"{b.abs().max().item():.3f}; tolerance {TOL_SSD:.0e})")
            err = max(err, e)
        check(err <= TOL_SSD, f"ssd_chunk {label} disagrees with its plain version")
        return err

    # (a) per-head inputs in the JAX kernel's chunked layout, through
    # ops.ssd_chunk: strided views into the kernel, no copies
    cells = [
        rs.randn(1, Hs, nc, Q, P),  # x
        np.logaddexp(0.0, rs.randn(1, Hs, nc, Q) + dt_bias[None, :, None, None]),  # dt
        0.3 * rs.randn(1, Hs, nc, Q, N),  # B
        0.3 * rs.randn(1, Hs, nc, Q, N),  # C
    ]
    x, dt, Bm, Cm = (torch.from_numpy(a.astype(np.float32)).to(dev) for a in cells)
    got = ssd_ops.ssd_chunk(x, dt, A, Bm, Cm)
    torch.cuda.synchronize()
    err_ssd = ssd_check("per head fp32", got, ssd_ref.chunk_ref(x, dt, A, Bm, Cm))
    ms_head = cuda_ms(torch, lambda: ssd_ops.ssd_chunk(x, dt, A, Bm, Cm), reps=50)
    cells_n = Hs * nc
    # per cell: x, dt, B, C read, Y, S, a_tot written (fp32); C B^T and Y
    # over the causal triangle, S over the whole chunk; three TF32 passes
    tri = Q * (Q + 1) / 2
    b_head, by_head = bound_ms(
        cells_n * 4 * (Q * P + Q + 2 * Q * N + Q * P + N * P + 1) + Hs * 4,
        3 * cells_n * (2.0 * tri * (N + P) + 2.0 * Q * N * P), PEAK_TF32_FLOPS)
    print(f"[2 ssd_chunk] per head fp32 {tuple(x.shape)}: {ms_head:.4f} ms/call, bound "
          f"{b_head:.5f} ms by {by_head} on {card}")
    del x, dt, Bm, Cm, got

    # (b) Zamba2's own layout: x, B, C as bf16 views of the conv output
    # (B, L, H P + 2 G N) with one group, dt (B, L, H) fp32, as
    # ops.ssd_forward passes them
    def seq_inputs(L, H, G, P_, N_, dtype, seed):
        r = np.random.RandomState(seed)
        xbc = np.concatenate([r.randn(1, L, H * P_), 0.3 * r.randn(1, L, 2 * G * N_)], -1)
        xbc = torch.from_numpy(xbc.astype(np.float32)).to(device=dev, dtype=dtype)
        db = dt_bias[np.arange(H) % Hs]
        dtv = np.logaddexp(0.0, r.randn(1, L, H) + db).astype(np.float32)
        return (xbc[..., : H * P_].reshape(1, L, H, P_), torch.from_numpy(dtv).to(dev),
                -torch.linspace(1.0, 16.0, H, device=dev), xbc[..., H * P_: H * P_ + G * N_].reshape(1, L, G, N_),
                xbc[..., H * P_ + G * N_:].reshape(1, L, G, N_))

    L = nc * Q
    zin = seq_inputs(L, Hs, 1, P, N, torch.bfloat16, 2)
    got = ssd_kernel.ssd_chunk_kernel(*zin, chunk=Q)
    torch.cuda.synchronize()
    err_ssd = max(err_ssd, ssd_check("Zamba2 layout bf16 G=1", got,
                                     ssd_ref.chunk_seq_ref(*zin, Q)))
    for label, (L_, H_, G_, P_, N_, Q_, dtype) in (
        ("ragged Q=17", (17, Hs, 1, P, N, 64, torch.bfloat16)),
        ("N=P=128 fp32", (256, 8, 1, 128, 128, 128, torch.float32)),
        ("N=P=128 bf16", (256, 8, 1, 128, 128, 128, torch.bfloat16)),
    ):
        inp = seq_inputs(L_, H_, G_, P_, N_, dtype, 3)
        got = ssd_kernel.ssd_chunk_kernel(*inp, chunk=Q_)
        torch.cuda.synchronize()
        err_ssd = max(err_ssd, ssd_check(label, got, ssd_ref.chunk_seq_ref(*inp, Q_)))
    del got, inp
    ms_ssd = cuda_ms(torch, lambda: ssd_kernel.ssd_chunk_kernel(*zin, chunk=Q), reps=50)
    plain_ssd = cuda_ms(torch, lambda: ssd_ref.chunk_seq_ref(*zin, Q), reps=10)
    # x, B, C (bf16, B and C once for the group) and dt read; Y, S, a_tot
    # written (fp32); C B^T once per chunk, Y and S per head, three passes
    # (the kernel forms C B^T per head: the bound counts the work needed)
    ssd_bytes = (L * Hs * P * 2 + L * 2 * N * 2 + L * Hs * 4
                 + 4 * (L * Hs * P + nc * Hs * N * P + nc * Hs) + Hs * 4)
    ssd_flops = 3 * (nc * 2.0 * tri * N + cells_n * (2.0 * tri * P + 2.0 * Q * N * P))
    b_ssd, by_ssd = bound_ms(ssd_bytes, ssd_flops, PEAK_TF32_FLOPS)
    print(f"[2 ssd_chunk] Zamba2 layout bf16 (1, {L}, {Hs}, {P}), G=1: {ms_ssd:.4f} ms/call "
          f"(plain {plain_ssd:.3f} ms), bound {b_ssd:.5f} ms by {by_ssd} "
          f"({ssd_bytes / 1e6:.2f} MB, {ssd_flops / 1e9:.2f} GFLOP TF32) on {card}")
    del zin
    return dict(
        flash=dict(max_abs_err=err_flash, ms=ms_flash, plain_ms=plain_flash,
                   bound_ms=b_flash, bound_by=by_flash, library_ms=lib_flash),
        ssd=dict(max_abs_err=err_ssd, ms=ms_ssd, plain_ms=plain_ssd,
                 bound_ms=b_ssd, bound_by=by_ssd, library_ms=None),
    )


def serve_main_path(torch, dev, card: str):
    """Phase 5: Zamba2-2.7B at full width behind the ServingEngine. Returns
    (flash launches, SSD launches, the config) of the counted run."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash import flash_kernel
    from repro_torch.kernels.ssd import ssd_kernel
    from repro_torch.models import decode_step, init_decode_cache, init_params, prefill
    from repro_torch.serve import Request, ServeConfig, ServingEngine

    cfg = get_config("zamba2-2.7b")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    print(f"[5 init] {cfg.name}: {cfg.param_count() / 1e9:.3f}e9 parameters "
          f"({cfg.dtype}), {torch.cuda.memory_allocated() / 1e9:.2f} GB on the card, "
          f"{time.perf_counter() - t0:.1f} s")
    eng = ServingEngine(cfg, params, ServeConfig(batch=SERVE_BATCH, max_len=SERVE_MAX_LEN),
                        device=dev)
    rs = np.random.RandomState(0)
    reqs = [Request(prompt=rs.randint(2, cfg.vocab_size, size=n).astype(np.int32),
                    max_new_tokens=NEW_TOKENS) for n in PROMPT_LENS]
    for r in reqs:
        eng.admit(r)
    periods = cfg.n_layers // cfg.hybrid_attn_every

    def counts():
        return flash_kernel.flash_attention.launches, ssd_kernel.ssd_chunk_kernel.launches

    inject_ms, tick_ms, done = [], [], []
    tick_launches = 0

    def inject(r):
        before = counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.inject([r])
        torch.cuda.synchronize()
        inject_ms.append((time.perf_counter() - t) * 1e3)
        after = counts()
        check(after[0] - before[0] == periods and after[1] - before[1] == cfg.n_layers,
              f"prefill of {len(r.prompt)} tokens launched flash "
              f"{after[0] - before[0]} and ssd_chunk {after[1] - before[1]} times")

    flash_kernel.flash_attention.launches = 0
    ssd_kernel.ssd_chunk_kernel.launches = 0
    t_run = time.perf_counter()
    queue = list(reqs)
    while queue and eng.free_slots:
        inject(queue.pop(0))
    while len(done) < len(reqs):
        check(len(tick_ms) < 10 * NEW_TOKENS * len(reqs), "the engine does not finish")
        before = counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        done += eng.decode_tick()
        torch.cuda.synchronize()
        tick_ms.append((time.perf_counter() - t) * 1e3)
        tick_launches += sum(counts()) - sum(before)
        while queue and eng.free_slots:
            inject(queue.pop(0))
    run_s = time.perf_counter() - t_run
    launches_flash, launches_ssd = counts()

    print(f"[5 serve] {len(reqs)} requests x {NEW_TOKENS} new tokens, batch {SERVE_BATCH}, "
          f"max_len {SERVE_MAX_LEN}: {run_s:.2f} s wall, {len(tick_ms)} decode ticks")
    for r, ms in zip(reqs, inject_ms):
        print(f"[5 serve]   prompt {len(r.prompt):4d}: inject (prefill + slot insert) "
              f"{ms:8.2f} ms; {r.finish_reason} after {len(r.output)} tokens: "
              f"{r.output[:8]}...")
    ticks = np.asarray(tick_ms)
    print(f"[5 serve] decode tick (batch {SERVE_BATCH}, host clock): mean {ticks.mean():.2f} "
          f"ms, median {np.median(ticks):.2f} ms, first {ticks[0]:.2f} ms, max "
          f"{ticks.max():.2f} ms; launches flash {launches_flash}, ssd_chunk "
          f"{launches_ssd}, during ticks {tick_launches}; on {card}")
    check(len(done) == len(reqs) and all(r.done for r in reqs), "a request did not finish")
    for r in reqs:
        check(r.finish_reason in ("eos", "length"), f"finish reason {r.finish_reason}")
        check(1 <= len(r.output) <= NEW_TOKENS, f"{len(r.output)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.output),
              f"token outside [0, {cfg.vocab_size}): {r.output}")
        check(r.finish_reason == "eos" or len(r.output) == NEW_TOKENS, "short by length")
    check(launches_flash == periods * len(reqs),
          f"flash launched {launches_flash} times, expected {periods} x {len(reqs)}")
    check(launches_ssd == cfg.n_layers * len(reqs),
          f"ssd_chunk launched {launches_ssd} times, expected {cfg.n_layers} x {len(reqs)}")
    check(tick_launches == 0, f"decode ticks launched the prefill kernels {tick_launches} times")

    # where the device time of one prefill (the longest prompt) and of one
    # decode step of the full batch goes, warm
    toks = torch.from_numpy(reqs[0].prompt[None]).to(dev)
    cache = init_decode_cache(cfg, SERVE_BATCH, SERVE_MAX_LEN, device=dev)
    cache.position = torch.full((SERVE_BATCH,), 600, dtype=torch.int32, device=dev)
    step_toks = torch.arange(2, 2 + SERVE_BATCH, device=dev)
    for label, run in (
        (f"prefill of {toks.shape[1]} tokens",
         lambda: prefill(cfg, params, toks, extra_len=SERVE_MAX_LEN - toks.shape[1])),
        (f"decode step of batch {SERVE_BATCH}", lambda: decode_step(cfg, params, step_toks, cache)),
    ):
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
        events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        if not events:
            print(f"[5 profile] {label}: the profiler saw no device time ({wall_ms:.1f} ms wall)")
            continue
        busy_ms = sum(e.self_device_time_total for e in events) / 1e3
        print(f"[5 profile] warm {label}: {wall_ms:.1f} ms wall (profiler on), device "
              f"busy {busy_ms:.2f} ms = {busy_ms / wall_ms:.1%} of wall, "
              f"{sum(e.count for e in events)} profiler events with device time")
        for e in sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:8]:
            dms = e.self_device_time_total / 1e3
            print(f"[5 profile]   {dms:8.3f} ms {dms / busy_ms:6.1%}  x{e.count:<5d} {e.key[:80]}")
        copy_ev = [e for e in prof.key_averages() if e.key == "aten::copy_"]
        print(f"[5 profile]   aten::copy_ calls: {sum(e.count for e in copy_ev)}, device "
              f"{sum(e.device_time_total for e in copy_ev) / 1e3:.3f} ms")
        for name in ("flash_fwd", "ssd_chunk_kernel"):
            dms = sum(e.self_device_time_total for e in events if name in e.key) / 1e3
            print(f"[5 profile]   {name}: {dms:.3f} ms = {dms / busy_ms:.1%} of device time")
    del cache
    del eng, params
    torch.cuda.empty_cache()
    return launches_flash, launches_ssd, cfg


def consistency(torch, dev, cfg) -> float:
    """Phase 5b: in fp32, prefill of S tokens plus 3 decode steps tracks
    the last logits of prefills over S+1, S+2 and S+3 tokens (the invariant
    of tests/test_serve.py), holding the kernel prefill against the plain
    decode path."""
    import dataclasses

    from repro_torch.models import decode_step, init_params, prefill

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = init_params(cfg32, seed=0, device=dev)
    rs = np.random.RandomState(5)
    toks = torch.from_numpy(rs.randint(2, cfg.vocab_size, size=(1, CONSIST_S + 3))).to(dev)
    _, cache = prefill(cfg32, params, toks[:, :CONSIST_S], extra_len=8)
    errs, scale = [], 0.0
    for t in range(3):
        out, cache = decode_step(cfg32, params, toks[:, CONSIST_S + t], cache)
        want, _ = prefill(cfg32, params, toks[:, :CONSIST_S + t + 1], extra_len=8)
        check(bool(torch.isfinite(out).all()), "decode logits not finite")
        errs.append((out - want).abs().max().item())
        scale = max(scale, want.abs().max().item())
    print(f"[5b consistency] fp32 {cfg.name}, prompt {CONSIST_S}: max|decode - prefill| "
          f"logits over 3 steps {', '.join(f'{e:.3e}' for e in errs)} (max|logit| "
          f"{scale:.2f}; tolerance {TOL_CONSIST:.0e})")
    check(max(errs) <= TOL_CONSIST, "prefill + decode disagrees with a longer prefill")
    del params, cache
    torch.cuda.empty_cache()
    return max(errs)


def test_rows(test):
    """The valid rows of an MTLData on the host: X (n, d), y (n,), tasks (n,)."""
    n = test.n.cpu().numpy()
    x, y = test.x.cpu().numpy(), test.y.cpu().numpy()
    X = np.concatenate([x[t, : n[t]] for t in range(len(n))])
    Y = np.concatenate([y[t, : n[t]] for t in range(len(n))])
    return X, Y, np.repeat(np.arange(len(n)), n)


def flat_scores(torch, est, test) -> np.ndarray:
    """est.decision_function over an MTLData, flattened to test_rows' order."""
    z = est.decision_function(test).cpu().numpy()
    n = test.n.cpu().numpy()
    return np.concatenate([z[t, : n[t]] for t in range(len(n))])


def check_versions(torch, dev, reqs, W_by_version, label):
    """Every request completed on a known version, its score that
    version's w_task . x within TOL_SCORE; returns the max error and the
    versions seen."""
    from repro_torch.core.dual import task_scores

    check(all(r.status == "done" for r in reqs), f"{label}: a request did not complete")
    err, seen = 0.0, sorted({r.snapshot_version for r in reqs})
    for v in seen:
        check(v in W_by_version, f"{label}: version {v} was never published")
        group = [r for r in reqs if r.snapshot_version == v]
        X = torch.from_numpy(np.stack([r.x for r in group])).to(dev)
        t = torch.tensor([r.task for r in group], device=dev)
        ref = task_scores(W_by_version[v], X, t).cpu().numpy()
        got = np.asarray([r.score for r in group], np.float32)
        err = max(err, float(np.abs(got - ref).max()))
    check(err <= TOL_SCORE, f"{label}: scores off their version's W by {err:.3e}")
    return err, seen


def mtl_serving_path(torch, dev, card: str, est, train, test) -> None:
    """Phases 6a and 6b: the fitted MNIST-width model behind the scoring
    engine, the continuous-batching scheduler and a fleet of replicas."""
    from repro_torch import obs
    from repro_torch.serve import ScoreRequest
    from repro_torch.serve.mtl import ScoreGraph, make_score_step

    B = SCORE_BATCH
    X, Y, tasks = test_rows(test)
    n, d = X.shape
    tiles = -(-n // B)
    eng = est.scoring_engine(batch=B)
    captures = ScoreGraph.captures
    t0 = time.perf_counter()
    eng.warmup()
    torch.cuda.synchronize()
    capture_ms = (time.perf_counter() - t0) * 1e3
    check(ScoreGraph.captures == captures + 1 and eng._graph is not None,
          "warmup() did not capture the score tile")
    eng.score_batch(X[:B], tasks[:B])
    t0 = time.perf_counter()
    z = eng.score_batch(X, tasks)
    batch_s = time.perf_counter() - t0
    ref = flat_scores(torch, est, test)
    err = float(np.abs(z - ref).max())
    wrong = [int(np.sum(np.sign(z[tasks == t]) != np.sign(Y[tasks == t])))
             for t in range(est.W_.shape[0])]
    wrong_ref = [int(np.sum(np.sign(ref[tasks == t]) != np.sign(Y[tasks == t])))
                 for t in range(est.W_.shape[0])]
    err_rate = float(np.mean([w / np.sum(tasks == t) for t, w in enumerate(wrong)]))
    est_err = 1.0 - est.score(test)
    print(f"[6a score] {n} test rows in {tiles} tiles of {B} through the captured graph: "
          f"max|score - decision_function| {err:.3e} (tolerance {TOL_SCORE:.0e}); test error "
          f"{err_rate:.4f} (the estimator's score(): {est_err:.4f}); capture {capture_ms:.1f} ms")
    check(err <= TOL_SCORE, "served scores disagree with decision_function")
    check(wrong == wrong_ref, f"served test errors per task {wrong} != {wrong_ref}")
    check(abs(err_rate - est_err) <= 1e-6, "served test error != the estimator's")

    # one tile on the device: the graph's replay against the eager step,
    # CUDA events behind a sleep; then a tile's host cost, synchronized
    g = eng._graph
    step = make_score_step()
    Xt = torch.from_numpy(X[:B]).to(dev)
    tt = torch.from_numpy(tasks[:B]).to(dev)
    W = est.W_
    dev_graph = cuda_ms(torch, g.graph.replay, reps=200)
    dev_eager = cuda_ms(torch, lambda: step(W, Xt, tt), reps=200)
    Xb, tb = X[:B], tasks[:B].astype(np.int32)

    def host_ms(fn, reps=200):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t) * 1e3 / reps

    # where score_batch's host time goes: the engine's steps timed apart
    # (validation; the rows' one copy to the card, pad rows zeroed there;
    # the replays with the scores' copy back), beside the whole-array pad
    # copy on the host that the JAX engine makes and this one does not
    t = time.perf_counter()
    Xv, tv = eng._validate_batch(X, tasks)
    t_val = time.perf_counter() - t
    t = time.perf_counter()
    n_pad = tiles * B
    Xd = torch.zeros((n_pad, d), dtype=torch.float32, device=dev)
    Xd[:n] = torch.from_numpy(Xv)
    td = torch.zeros((n_pad,), dtype=torch.int64, device=dev)
    td[:n] = torch.from_numpy(tv)
    torch.cuda.synchronize()
    t_copy = time.perf_counter() - t
    t = time.perf_counter()
    g.score(W, W, Xd, td)
    t_loop = time.perf_counter() - t
    t = time.perf_counter()
    np.concatenate([X, np.zeros((n_pad - n, d), np.float32)])
    t_pad = time.perf_counter() - t
    print(f"[6a score_batch] {batch_s * 1e3:.2f} ms for {tiles} tiles: validation "
          f"{t_val * 1e3:.2f} ms, rows to the card ({X.nbytes / 1e6:.1f} MB pageable) "
          f"{t_copy * 1e3:.2f} ms, {tiles} replays with the scores' copy back "
          f"{t_loop * 1e3:.2f} ms ({t_loop * 1e3 / tiles:.4f} ms per tile); a host pad "
          f"copy of the whole array (the JAX engine's, not made here) {t_pad * 1e3:.2f} ms")
    host_graph = host_ms(lambda: eng._score_tiles(Xb, tb, W))
    host_eager = host_ms(lambda: step(W, torch.from_numpy(Xb).to(dev),
                                      torch.from_numpy(tb.astype(np.int64)).to(dev)).cpu())
    nbytes = 2 * B * d * 4 + B * 8 + B * 4  # X tile and W rows read, tasks, scores
    b_tile, by_tile = bound_ms(nbytes, 2.0 * B * d)
    print(f"[6a tile] device ms per tile (CUDA events): graph replay {dev_graph:.4f}, eager "
          f"step {dev_eager:.4f}; bound {b_tile:.5f} ms by {by_tile} ({nbytes} bytes at "
          f"3.35 TB/s); host ms per tile (synchronized): graph path {host_graph:.4f}, eager "
          f"step {host_eager:.4f}; score_batch {batch_s * 1e3 / tiles:.4f} ms per tile "
          f"({n / batch_s:.0f} rows/s); on {card}")

    # a request's admission: the engine's check against the full one-row
    # validation it replaces for well-formed requests
    probe = [ScoreRequest(task=int(t), x=X[i]) for i, t in enumerate(tasks)]
    t = time.perf_counter()
    for r in probe:
        eng.admit(r)
    admit_us = (time.perf_counter() - t) * 1e6 / n
    t = time.perf_counter()
    for r in probe:
        eng._validate_batch(np.asarray(r.x, np.float32)[None], np.asarray([r.task]))
    full_us = (time.perf_counter() - t) * 1e6 / n
    print(f"[6a admit] {admit_us:.2f} us per request (the one-row validation: "
          f"{full_us:.2f} us)")

    # the same rows as requests through the scheduler on the real clock,
    # one partial_fit halfway (its push hot-swaps between tiles)
    sched = est.serving_scheduler(batch=B, policy="edf")
    check(sched.engine.adopt_warmup(eng), "the scheduler's engine did not adopt the graph")
    reqs = [ScoreRequest(task=int(t), x=X[i]) for i, t in enumerate(tasks)]
    W_by_version = {sched.version: est.W_}
    i = done = 0
    fit_s = submit_s = 0.0
    obs.enable(clear=True)  # the scheduler's pack and run_tile spans
    t0 = time.perf_counter()
    while done < n:
        t = time.perf_counter()
        while i < n and sched.pending < 2 * B:
            sched.submit(reqs[i])
            i += 1
        submit_s += time.perf_counter() - t
        done += len(sched.step())
        if not fit_s and done >= n // 2:
            t = time.perf_counter()
            est.partial_fit(train)
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t
            W_by_version[sched.version] = est.W_
    wall_s = time.perf_counter() - t0
    obs.disable()
    spans = obs.phase_breakdown(cat="serve")
    err_s, seen = check_versions(torch, dev, reqs, W_by_version, "scheduler")
    check(len(seen) == 2, f"the scheduler served versions {seen}, expected two")
    s = sched.metrics.summary()
    lat = s["latency"]
    print(f"[6a scheduler] {n} requests, EDF, 2 tiles queued ahead: {wall_s:.3f} s wall "
          f"including one partial_fit of {fit_s:.3f} s -> {n / (wall_s - fit_s):.0f} "
          f"requests/s while serving; latency p50 {lat['p50_s'] * 1e3:.3f} ms, p99 "
          f"{lat['p99_s'] * 1e3:.3f} ms (ServingMetrics; the p99 holds the requests queued "
          f"through the partial_fit); versions {seen}, swaps {s['swaps']}, tiles "
          f"{s['tiles']}, tile fill {s['tile_fill']:.3f}; max|score - W_v x| {err_s:.3e}")
    check(s["completed"] == n and s["expired"] == 0, f"scheduler summary {s}")
    pack_s, tile_s = spans["pack"]["total_s"], spans["run_tile"]["total_s"]
    rest_s = wall_s - fit_s - submit_s - pack_s - tile_s
    print(f"[6a scheduler] per tile (host clock, spans): submit of its requests "
          f"{submit_s * 1e3 / s['tiles']:.3f} ms, pack {pack_s * 1e3 / s['tiles']:.3f} ms, "
          f"run_tile {tile_s * 1e3 / s['tiles']:.3f} ms, completion bookkeeping "
          f"{rest_s * 1e3 / s['tiles']:.3f} ms")

    # 6b: four replicas on the one card, one capture adopted by the rest
    router = est.serving_fleet(n_replicas=N_REPLICAS, batch=B)
    captures = ScoreGraph.captures
    router.warmup()
    graphs = {id(router.replica(k).scheduler.engine._graph) for k in range(N_REPLICAS)}
    check(ScoreGraph.captures == captures + 1 and len(graphs) == 1,
          f"fleet warmup: {ScoreGraph.captures - captures} captures, {len(graphs)} graphs")
    tokens = {t: router.session() for t in range(est.W_.shape[0])}
    reqs = [ScoreRequest(task=int(t), x=X[i]) for i, t in enumerate(tasks)]
    floors = [0] * n
    W_by_version = {router.version: est.W_}
    i = done = 0
    published = False
    t0 = time.perf_counter()
    while done < n:
        while i < n and router.pending < 2 * B * N_REPLICAS:
            floors[i] = tokens[reqs[i].task].min_version
            check(router.submit(reqs[i], client=tokens[reqs[i].task]).admitted,
                  "the fleet refused a request")
            i += 1
        done += len(router.step())
        if not published and done >= n // 2:
            est.partial_fit(train)  # pushes through the router: a rolling swap
            W_by_version[router.version] = est.W_
            published = True
    while router.roll_pending:
        router.step()
    wall_s = time.perf_counter() - t0
    err_f, seen = check_versions(torch, dev, reqs, W_by_version, "fleet")
    check(all(r.snapshot_version >= f for r, f in zip(reqs, floors)),
          "a client read went behind the version its token had observed")
    versions = [router.replica(k).scheduler.version for k in range(N_REPLICAS)]
    check(versions == [router.version] * N_REPLICAS,
          f"replica versions {versions}, fleet version {router.version}")
    fs = router.summary()
    print(f"[6b fleet] {N_REPLICAS} replicas, 1 capture, 2 tiles queued per replica: {n} "
          f"requests by task affinity in "
          f"{wall_s:.3f} s wall (one partial_fit included); versions served {seen}, "
          f"replicas end at {versions}; router {fs['router']}; per-replica completed "
          f"{[r['completed'] for r in fs['per_replica']]}; latency p50 "
          f"{fs['fleet']['latency']['p50_s'] * 1e3:.3f} ms, p99 "
          f"{fs['fleet']['latency']['p99_s'] * 1e3:.3f} ms; max|score - W_v x| {err_f:.3e}")
    check(fs["fleet"]["completed"] == n and fs["router"]["admitted"] == n,
          "the fleet lost requests")


def round_at_many_tasks(torch, dev, card: str, data, sm_clock: str):
    """Phase 2, the round kernel at the structured path's shape (phase 6c:
    4096 tasks, d = 100, about 100 rows a task): against its plain version
    for each loss, timed beside its bound and chain floor."""
    from repro_torch import prng
    from repro_torch.core.sdca import coords_from_uniform, kappa_of
    from repro_torch.kernels.sdca import ref, sdca_kernel, sdca_round_kernel

    x, y, n = data.x, data.y, data.n
    m, n_max, d = x.shape
    H = n_max + (-n_max) % BLOCK
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rs = np.random.RandomState(6)
    alpha = torch.from_numpy(0.5 * rs.rand(m, n_max).astype(np.float32)).to(dev) * y
    w = torch.from_numpy(0.05 * rs.randn(m, d).astype(np.float32)).to(dev)
    keys = prng.fold_in(prng.fold_in(prng.PRNGKey(1), torch.arange(m)), 0)
    u = prng.uniform(keys, (H,), device=dev)
    kappa = kappa_of(1.0, 1e-3, n, torch.full((m,), 1.0 / m, device=dev))
    err = 0.0
    for loss in LOSSES:
        da_k, r_k = sdca_round_kernel(x, y, alpha, w, u, n, kappa, loss, block=BLOCK)
        torch.cuda.synchronize()
        da_p, r_p = ref.sdca_round_ref(x, y, alpha, w, u, n, kappa, loss)
        e = max((da_k - da_p).abs().max().item(), (r_k - r_p).abs().max().item())
        check(bool(torch.isfinite(da_k).all() and torch.isfinite(r_k).all()),
              f"sdca_round at {m} tasks {loss}: non-finite output")
        print(f"[2 sdca_round {m} tasks {loss}] max|dalpha, r - plain| = {e:.3e} "
              f"(tolerance {TOL_ROUND:.0e})")
        check(e <= TOL_ROUND, f"sdca_round at {m} tasks {loss} disagrees with its plain version")
        err = max(err, e)
    ms = cuda_ms(torch, lambda: sdca_round_kernel(
        x, y, alpha, w, u, n, kappa, "hinge", block=BLOCK), reps=20)
    plain = cuda_ms(torch, lambda: ref.sdca_round_ref(x, y, alpha, w, u, n, kappa, "hinge"),
                    reps=1)
    scratch = torch.empty(m * (H // BLOCK) * (BLOCK * BLOCK + 4 * BLOCK), device=dev)
    da_s, r_s = torch.zeros_like(alpha), torch.zeros_like(w)
    stage_ms = [cuda_ms(torch, lambda st=st: sdca_kernel.sdca_round_stage(
        st, x, y, alpha, w, u, n, kappa, "hinge", scratch, da_s, r_s, block=BLOCK), reps=20)
        for st in (1, 2)]
    del scratch, da_s, r_s
    cluster_ms = {c: cuda_ms(torch, lambda c=c: sdca_round_kernel(
        x, y, alpha, w, u, n, kappa, "hinge", block=BLOCK, cluster=c), reps=20)
        for c in sdca_kernel.SUPPORTED_CLUSTERS}
    srt = coords_from_uniform(u, n).sort(dim=1).values
    uniq = int((srt[:, 1:] != srt[:, :-1]).sum().item()) + m
    nbytes = (uniq * d * 4 + uniq * 8) + (m * d * 4 + m * H * 4 + m * 8) \
        + (m * n_max * 4 + m * d * 4)
    flops = 2.0 * m * (H // BLOCK) * (GRAM_TRI + 3 * BLOCK) * d
    b, by = bound_ms(nbytes, flops)
    floor = [H * cyc / (float(sm_clock) * 1e6) * 1e3 for cyc in (60, 100)]
    print(f"[2 sdca_round {m} tasks] x {tuple(x.shape)}, H = {H}: {ms:.4f} ms/call (plain "
          f"{plain:.1f} ms), bound {b:.4f} ms by {by} ({uniq} distinct rows, "
          f"{flops / 1e9:.2f} GFLOP); chain floor {floor[0]:.4f}-{floor[1]:.4f} ms on {card}")
    print(f"[2 sdca_round {m} tasks] stage 1 (Gram, q) {stage_ms[0]:.4f} ms, stage 2 (chains, "
          f"cluster {sdca_kernel.round_cluster(m, d, BLOCK, sms)}) {stage_ms[1]:.4f} ms; round "
          f"by cluster size: " + ", ".join(f"C={c} {t:.4f} ms" for c, t in cluster_ms.items()))
    return err


def structured_path(torch, dev, card: str, data) -> None:
    """Phase 6c: a low_rank_diag fit at 4096 tasks through the round
    kernel, its test rows served with their Sigma rows from the factors,
    and one graphical_lasso Omega-step on the fitted W."""
    from repro_torch.core import DMTRLEstimator, LowRankDiagSigma, SparseSigma
    from repro_torch.core.omega_regularizers import get_regularizer
    from repro_torch.kernels.sdca import reset_launch_counts, sdca_block_kernel, sdca_round_kernel
    from repro_torch.serve import ScoreRequest

    train, test = data.train.to(dev), data.test.to(dev)
    m = train.m
    cfg = dict(solver="pallas_round", loss="hinge", lam=1e-3, outer_iters=2, rounds=3,
               block_size=BLOCK)
    est = DMTRLEstimator(regularizer="low_rank_diag", regularizer_params={"rank": MANY_RANK},
                         device=dev, **cfg)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est.fit(train)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = sdca_round_kernel.launches
    rounds = cfg["outer_iters"] * cfg["rounds"]
    gap = est.history["gap"]
    view = est.sigma_view_
    tr = float(view.trace())
    print(f"[6c fit] low_rank_diag rank {MANY_RANK}, x {tuple(train.x.shape)}: {fit_s:.2f} s "
          f"for {rounds} rounds; gap {np.array2string(gap, precision=5)}; sdca_round "
          f"launches {launches}; tr(Sigma) {tr:.7f}; view {type(view).__name__} "
          f"{view.nbytes()} bytes against 4 m^2 = {4 * m * m} bytes dense; test error "
          f"{1.0 - est.score(test):.4f}")
    check(launches == rounds, f"sdca_round launched {launches} times, expected {rounds}")
    check(sdca_block_kernel.launches == 0, "the structured path launched sdca_block")
    check(bool(np.all(np.isfinite(gap))) and gap[-1] < gap[0], f"gap {gap[0]} -> {gap[-1]}")
    check(isinstance(view, LowRankDiagSigma), f"sigma_view_ is {type(view).__name__}")
    check(abs(tr - 1.0) <= 1e-5, f"tr(Sigma) = {tr}")

    X, _, tasks = test_rows(data.test)
    ref = flat_scores(torch, est, test)
    dense = view.dense()  # m = MATERIALIZE_LIMIT: built for the check only
    eng = est.scoring_engine(batch=SCORE_BATCH, gather_sigma_rows=True)
    eng.warmup()
    err = row_err = 0.0
    t0 = time.perf_counter()
    for lo in range(0, len(tasks), 16 * SCORE_BATCH):
        reqs = [ScoreRequest(task=int(t), x=X[lo + k])
                for k, t in enumerate(tasks[lo : lo + 16 * SCORE_BATCH])]
        eng.run(reqs)
        err = max(err, float(np.abs(np.asarray([r.score for r in reqs])
                                    - ref[lo : lo + len(reqs)]).max()))
        rows = torch.from_numpy(np.stack([r.sigma_row for r in reqs])).to(dev)
        want = dense[torch.from_numpy(tasks[lo : lo + len(reqs)]).to(dev)]
        row_err = max(row_err, (rows - want).abs().max().item())
    serve_s = time.perf_counter() - t0
    print(f"[6c serve] {len(tasks)} test rows with their Sigma rows in {serve_s:.2f} s: "
          f"max|score - decision_function| {err:.3e} (tolerance {TOL_SCORE:.0e}), "
          f"max|sigma_row - dense[task]| {row_err:.3e} (tolerance {TOL_SIGMA_ROW:.0e})")
    check(err <= TOL_SCORE, "structured scores disagree with decision_function")
    check(row_err <= TOL_SIGMA_ROW, "Sigma rows from the factors disagree with the dense view")
    del dense

    t0 = time.perf_counter()
    sparse, omega = get_regularizer("graphical_lasso").step(est.W_, 1e-6)
    step_s = time.perf_counter() - t0
    check(isinstance(sparse, SparseSigma) and omega is None, "graphical_lasso returned no view")
    # its dense form built apart from rows(): the diagonal plus the ELL entries
    D = np.diag(sparse.diag_v.cpu().numpy().astype(np.float64))
    np.add.at(D, (np.repeat(np.arange(m), sparse.k_max), sparse.cols.cpu().numpy().ravel()),
              sparse.vals.cpu().numpy().ravel())
    idx = torch.arange(m, device=dev)
    sp_err = max((sparse.rows(idx[lo : lo + 1024]).double().cpu().numpy()
                  - D[lo : lo + 1024]).__abs__().max() for lo in range(0, m, 1024))
    lam_min = torch.linalg.eigvalsh(torch.from_numpy(D).to(dev)).min().item()
    print(f"[6c graphical_lasso] Omega-step on the fitted W: {step_s:.2f} s on the host "
          f"(float64 numpy); k_max {sparse.k_max}, {int((sparse.vals != 0).sum())} couplings, "
          f"{sparse.nbytes()} bytes; max|rows - dense| {sp_err:.3e} (tolerance "
          f"{TOL_SIGMA_ROW:.0e}); smallest eigenvalue {lam_min:.3e}; tr {float(sparse.trace()):.7f}")
    check(sp_err <= TOL_SIGMA_ROW, "SparseSigma rows disagree with its dense form")
    check(lam_min >= -1e-6, f"graphical_lasso Sigma is not PSD: {lam_min}")


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
    from repro_torch.kernels import flash, nvcc, sdca, ssd
    from repro_torch.kernels.sdca import (
        ref, reset_launch_counts, sdca_block_kernel, sdca_kernel, sdca_round_kernel,
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
    seconds = nvcc.build_all(sdca.SOURCES + flash.SOURCES + ssd.SOURCES)
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
    t0 = time.perf_counter()
    many = synthetic(1, m=MANY_M, d=MANY_D, n_train_avg=MANY_N_TRAIN,
                     n_test_avg=MANY_N_TEST, seed=0)
    many_train = many.train.to(dev)
    print(f"[data] synthetic(1, m={MANY_M}, d={MANY_D}, n_train_avg={MANY_N_TRAIN}, "
          f"n_test_avg={MANY_N_TEST}): train x {tuple(many.train.x.shape)} "
          f"({many.train.x.numel() * 4 / 1e6:.0f} MB), test x {tuple(many.test.x.shape)}, "
          f"{time.perf_counter() - t0:.1f} s")

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
        x, y, alpha, w, u, n, kappa, "hinge", block=BLOCK), reps=20)
    # the two stages apart (stage 2 on the Gram blocks stage 1 left), and
    # the round at each cluster size that fits d (the measurements behind
    # sdca_kernel.round_cluster)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    scratch = torch.empty(M * (H // BLOCK) * (BLOCK * BLOCK + 4 * BLOCK), device=dev)
    da_s, r_s = torch.zeros_like(alpha), torch.zeros_like(w)
    stage_ms = [cuda_ms(torch, lambda st=st: sdca_kernel.sdca_round_stage(
        st, x, y, alpha, w, u, n, kappa, "hinge", scratch, da_s, r_s, block=BLOCK), reps=20)
        for st in (1, 2)]
    del scratch, da_s, r_s
    cluster_ms = {c: cuda_ms(torch, lambda c=c: sdca_round_kernel(
        x, y, alpha, w, u, n, kappa, "hinge", block=BLOCK, cluster=c), reps=20)
        for c in sdca_kernel.SUPPORTED_CLUSTERS
        if sdca_kernel.chain_smem_bytes(BLOCK, D, c) <= sdca_kernel.MAX_SMEM_BYTES}
    sm_clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0]
    # latency floor of the chain: H dependent steps (delta_of, a shuffle, an
    # FMA) at 60-100 cycles each at the SM's top clock
    floor_ms = [H * cyc / (float(sm_clock) * 1e6) * 1e3 for cyc in (60, 100)]
    print(f"[2 sdca_round] stage 1 (Gram, q) {stage_ms[0]:.4f} ms, stage 2 (chains, cluster "
          f"{sdca_kernel.round_cluster(M, D, BLOCK, sms)}) {stage_ms[1]:.4f} ms; round by cluster size: "
          + ", ".join(f"C={c} {t:.4f} ms" for c, t in cluster_ms.items())
          + f"; chain floor {floor_ms[0]:.3f}-{floor_ms[1]:.3f} ms ({H} steps x 60-100 "
          f"cycles at {sm_clock} MHz)")
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
    print(f"[2 sdca_round] {ms_round:.4f} ms/call (plain {plain_round:.1f} ms), "
          f"bound {b_round:.4f} ms by {by_round} ({uniq} distinct rows, "
          f"{flops_round / 1e9:.2f} GFLOP) on {card}")

    # K2 at the MNIST width (the first block of the round above) and at
    # Synthetic-1's shape (m = 16, d = 100: the second path's, phase 4),
    # there once with the draws of a round and once with duplicates forced
    syn = synthetic(1, seed=0)
    sx, sy = syn.train.x.to(dev), syn.train.y.to(dev)
    m4, n4, d4 = sx.shape
    rs4 = np.random.RandomState(4)
    s_alpha = torch.from_numpy(0.5 * rs4.rand(m4, n4).astype(np.float32)).to(dev) * sy
    s_w = torch.from_numpy(0.05 * rs4.randn(m4, d4).astype(np.float32)).to(dev)
    s_r = torch.from_numpy(0.1 * rs4.randn(m4, d4).astype(np.float32)).to(dev)
    s_kappa = kappa_of(1.0, 1e-3, syn.train.n.to(dev), torch.full((m4,), 1.0 / m4, device=dev))
    s_cb = torch.from_numpy(np.stack([rs4.randint(0, int(syn.train.n[t]), size=BLOCK)
                                      for t in range(m4)])).to(dev)
    s_cb_dup = s_cb.clone()
    s_cb_dup[:, 5] = s_cb_dup[:, 0]
    s_cb_dup[:, BLOCK - 1] = s_cb_dup[:, 0]

    def block_inputs(x_, alpha_, y_, w_, r_, cb_, kappa_):
        cb_ = cb_.contiguous()
        return (gather_rows(x_, cb_).contiguous(), w_, r_, torch.gather(alpha_, 1, cb_),
                torch.gather(y_, 1, cb_), cb_.to(torch.int32), kappa_), cb_

    shapes = {
        "MNIST": block_inputs(x, alpha, y, w, r_state, coords[:, :BLOCK], kappa),
        "Synthetic-1": block_inputs(sx, s_alpha, sy, s_w, s_r, s_cb, s_kappa),
        "Synthetic-1 duplicates": block_inputs(sx, s_alpha, sy, s_w, s_r, s_cb_dup, s_kappa),
    }
    err_block = 0.0
    for label, (args, cb_) in shapes.items():
        for loss in LOSSES:
            d_k = sdca_block_kernel(*args, loss)
            torch.cuda.synchronize()
            d_p = ref.sdca_block_ref(*args[:5], cb_, args[6], loss)
            e = (d_k - d_p).abs().max().item()
            print(f"[2 sdca_block {label} {loss}] max|deltas - plain| = {e:.3e} "
                  f"(tolerance {TOL_BLOCK:.0e})")
            check(bool(torch.isfinite(d_k).all()), f"sdca_block {label} {loss}: non-finite")
            check(e <= TOL_BLOCK, f"sdca_block {label} {loss} disagrees with its plain version")
            err_block = max(err_block, e)
    # latency floor of the recursion: BLOCK dependent steps at 60-100 cycles
    floor_block = [BLOCK * cyc / (float(sm_clock) * 1e6) * 1e3 for cyc in (60, 100)]
    block_times = {}
    for label in ("MNIST", "Synthetic-1"):
        args, cb_ = shapes[label]
        mm, _, dd = args[0].shape
        by_c = {c: cuda_ms(torch, lambda c=c: sdca_block_kernel(*args, "hinge", cluster=c),
                           reps=50) for c in sdca_kernel.SUPPORTED_BLOCK_CLUSTERS}
        ms_b = cuda_ms(torch, lambda: sdca_block_kernel(*args, "hinge"), reps=50)
        plain_b = cuda_ms(torch, lambda: ref.sdca_block_ref(*args[:5], cb_, args[6], "hinge"),
                          reps=5)
        nbytes = mm * BLOCK * dd * 4 + 2 * mm * dd * 4 + 4 * mm * BLOCK * 4 + mm * 4
        flops = 2.0 * mm * (GRAM_TRI + 2 * BLOCK) * dd  # q, xr, Gram triangle
        b_b, by_b = bound_ms(nbytes, flops)
        block_times[label] = (ms_b, plain_b, b_b, by_b)
        print(f"[2 sdca_block {label}] (m={mm}, d={dd}, B={BLOCK}): {ms_b:.4f} ms/call at "
              f"cluster {sdca_kernel.block_cluster(dd)} (plain {plain_b:.2f} ms); by cluster: "
              + ", ".join(f"C={c} {t:.4f} ms" for c, t in by_c.items())
              + f"; bound {b_b:.5f} ms by {by_b}; chain floor {floor_block[0] * 1e3:.2f}-"
              f"{floor_block[1] * 1e3:.2f} us ({BLOCK} steps x 60-100 cycles at {sm_clock} "
              f"MHz) on {card}")
    ms_block, plain_block, b_block, by_block = block_times["Synthetic-1"]
    err_round = max(err_round, round_at_many_tasks(torch, dev, card, many_train, sm_clock))
    del many_train
    del shapes, sx, sy, s_alpha, s_w, s_r
    del alpha, w, u, r_state
    lm = lm_kernel_checks(torch, dev, card)

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

    # -- phase 5: the LM serving path; 5b: its fp32 consistency ----------------
    launches_flash, launches_ssd, lm_cfg = serve_main_path(torch, dev, card)
    consistency(torch, dev, lm_cfg)

    # -- phase 6: the MTL serving path; 6c: structured Sigma at 4096 tasks -----
    t6 = time.perf_counter()
    mtl_serving_path(torch, dev, card, est, train, test)
    structured_path(torch, dev, card, many)
    print(f"[6] {time.perf_counter() - t6:.1f} s wall")

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
        dict(name="flash_fwd", route="cuda",
             source="src/repro_torch/kernels/flash/csrc/flash_fwd.cu",
             replaces="src/repro/kernels/flash/flash_kernel.py:84",
             launches=launches_flash, **lm["flash"]),
        dict(name="ssd_chunk", route="cuda",
             source="src/repro_torch/kernels/ssd/csrc/ssd_chunk.cu",
             replaces="src/repro/kernels/ssd/ssd_kernel.py:70",
             launches=launches_ssd, **lm["ssd"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
