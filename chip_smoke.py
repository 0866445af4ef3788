#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. build  — compile the seven kernel sources (SDCA round and block, flash
              attention forward and backward, SSD chunk forward and
              backward, the round's threefry draw) from
              src/repro_torch/kernels/*/csrc with nvcc for sm_90a (one nvcc
              per source, started together);
  2. kernels against their plain PyTorch versions on the card, at their
              paths' shapes: the round's threefry draw at both benchmark
              cells' shapes (10 x 12032, 16 x 2048), bit for bit, its
              device and host time beside prng's torch ops; the SDCA
              round at 10 tasks x 12000 rows x 784 features, B = 64, for
              the hinge, squared and smoothed-hinge
              losses (its two stages also timed apart, stage 1 beside its
              own bound at this width, at 4096 tasks and at Synthetic-1's,
              and at each cluster
              size that fits) and at the MDS width (22 tasks x 14 525 rows x
              10 000 features, the streamed round in one kernel, timed over
              cluster sizes and warps a CTA); the SDCA block at that width and at
              Synthetic-1's (16 tasks, d = 100), there also with duplicate
              coordinates, timed at every cluster size beside its chain
              floor; flash attention at Zamba2-2.7B's (1, 32, 512, 80),
              causal, bf16 (tensor-core kernel) and fp32 (fp32 kernel), each
              with and without a 128 window, timed beside
              scaled_dot_product_attention, and at gemma3-1b's (1, 4, 512,
              256; bf16 and fp32, causal and its 512 window) and
              qwen1.5-4b's (1, 20, 512, 128; bf16), qwen3-moe's (1, 32,
              512, 128; bf16), chameleon-34b's and kimi-k2's (1, 64, 512,
              128; bf16) and whisper-tiny's non-causal calls (1, 6, 1500,
              64) in fp32 and bf16 and (1, 6, 512, 64) against 1500 keys
              in fp32; the SSD chunk with dt
              and A in the model's ranges, per head in the chunked layout
              (1, 80, 8, 64, 64, 64), in Zamba2's own layout (bf16 views of
              the conv output, one B/C group) and in mamba2-780m's (48
              heads, P = 64, N = 128), plus a ragged 17-step chunk and
              Q = N = P = 128 in fp32 and bf16; the flash backward
              (K3-bwd) against autograd of the plain attention at the
              training shapes: gemma3-1b's (1, 4, 1024, 256) in bf16 causal
              and with its 512 window and in fp32, qwen1.5-4b's (1, 20,
              512, 128) bf16, whisper-tiny's encoder (1, 6, 1500, 64) and
              cross-attention (1, 6, 448, 64) x 1500 keys in fp32, each
              called twice (the two results bit-equal) and timed beside
              the backward of scaled_dot_product_attention; the SSD chunk
              backward (K4-bwd) against the plain backward at mamba2-780m's
              training layout (2 x 1024 tokens, 48 heads, N = 128) in bf16
              views and fp32, zamba2-2.7b's (80 heads, N = 64), a ragged
              L = 1000, Q = 17, 4 groups of 8 heads, a chunk whose decay
              overflows exp and 13 heads (no head block divides them),
              each called twice (bit-equal), the fp32 ones also against
              the function in fp64, and timed beside the design's byte
              count and its launch plan; every cluster size timed at the
              two training layouts and the overflow chunk; K1 and K2 on
              a pod slice of Synthetic-1 with empty tasks (n_i = 0, as the
              mesh engines feed them), each task a view between NaN
              sentinels, against their plain versions;
  3. main path — DMTRLEstimator(solver="pallas_round") fits the paper's
              MNIST-width problem (mnist_like, scale 1.0) on the card, then
              scores and predicts; the fused round kernel and the draw
              kernel must each carry every round once;
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
  5c. streaming — phase 5's engine behind ContinuousBatchingScheduler: 8
              requests arriving over the run, at temperature 0.8 (seed 0)
              twice (the same tokens) and at temperature 0 (the tokens of
              engine.run); time to first token, ticks, tokens/s;
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
              the round kernel against its plain version at this shape);
  7. the parameter server — (a) fit_async over the threaded server, 2
              worker threads at MNIST width through the round kernel (2
              launches a round), held against the one-process fit, then at
              tau = 1 with worker 1 paced 4x and under the int8 codec; (b)
              the multiprocess server (2 worker processes) on Synthetic-1
              against the threaded one; (c) the gossip ring of 4 nodes on
              Synthetic-1 through the block kernel; (d) the paper's claims:
              Table 2 on school_like (DMTRL, STL, centralized MTRL), the
              smooth loss converging faster (Theorems 8/9), Theta and
              rho_min on phase 3's model, SSDCA reaching DMTRL's dual;
  8. the LM families — phase 5's engine and requests (bf16, random weights
              from seed 0) at full width: (a) gemma3-1b, 26 layers (22
              local with a ring buffer of 512, 4 global), prompts prefilled
              in power-of-two buckets with true_len, K3 26 times a prefill;
              in fp32 a bucketed prefill against an exact-length one and
              the ring across the window (508 tokens + 8 decode steps
              against prefills of 509 .. 516); (b) qwen1.5-4b cut to 8 of
              its 40 layers, K3 8 times a prefill; (c) nemotron-4-15b cut
              to 4 layers; (d) mamba2-780m, 48 layers at exact length, K4
              48 times a prefill, and its fp32 state (256 + 3 against
              257 .. 259); (e) the bridge: DMTRL heads (fit_mtl_heads,
              pallas_round) on gemma3-1b's pooled features of 6 band tasks
              x 256 sequences x 64 tokens: K3 in the backbone, K1 24
              times in the fit, the features against the plain attention,
              the fit against block_gram on the same features, the test
              error;
  9. the rest of the zoo — phase 5's engine and requests (bf16, random
              weights from seed 0) at full width: (a) qwen3-moe-30b-a3b
              cut to 8 of 48 layers (128 experts top-8), K3 8 times a
              prefill, each prefill's drop_frac; in fp32 at lossless
              capacity 256 + 3 decode steps against prefills of 257 ..
              259 and bucketed against exact-length prefills; (b)
              kimi-k2-1t-a32b cut to 1 of 61 layers (384 experts, one
              shared), K3 once; (c) chameleon-34b cut to 4 of 48, K3 4
              times; (d) whisper-tiny whole, 1500 frames a request, exact
              length, K3 12 times (4 encoder layers non-causal, 4 decoder
              layers, 4 cross-attentions) and its fp32 state (256 + 3
              against 257 .. 259);
 10. training — (a) gemma3-1b at full width and depth (26 layers, bf16,
              remat, random init from seed 0) trains 10 steps through
              train.train with AdamW(lr=1e-3, warmup_steps=2) on one
              repeated batch of 2 x 1024 tokens: the loss falls by 0.5 nat
              or more, K3 runs 52 and K3-bwd 26 times a step; step time,
              tokens/s, device-busy share and peak memory; (b) one gradient
              and AdamW step on the card against the CPU in fp32: gemma3-1b
              at 6 layers, whisper-tiny whole and qwen3-moe reduced (the
              MoE's custom-VJP gathers), mamba2-780m reduced with chunks of
              64 (its last head's decay overflows exp) and zamba2-2.7b
              reduced (K3, K3-bwd, K4 and K4-bwd in one step); (c) the
              launcher on whisper-tiny (python -m repro_torch.launch.train
              --steps 3 --ckpt-dir ...), its checkpoint reloaded bit for
              bit; (d) mamba2-780m at full width and depth (48 layers, bf16,
              remat) trains 10 steps as (a) does: the loss is finite and
              falls, K4 runs 96 and K4-bwd 48 times a step;
 11. the mesh engines — (a) DMTRLEstimator(engine="distributed") on the
              local one-device mesh at phase 3's configuration, against
              phase 3's fit; (b) the same over a one-rank NCCL world
              (make_mesh over torch.distributed; the collectives counted);
              (c) pallas_block on Synthetic-1, against phase 4's fit; (d)
              engine="async" with the simulated transport at tau = 0
              (against a), tau = 2 with delays (2,), and the
              g1_tau2_omega1 golden history replayed; (e) low_rank_diag at
              4096 tasks on (b)'s world (the factored reduce), against
              phase 6c's fit;
 12. the sharded train step — phase 10's configs, init and batch through
              train.make_sharded_train_step on the local mesh
              (launch.make_host_mesh(1, 1)) and on a one-rank NCCL world
              (make_mesh((1, 1), ("data", "model"))): (a) gemma3-1b whole,
              10 steps (K3, K3-bwd); (b) mamba2-780m whole, 3 steps (K4,
              K4-bwd). The serve-mode step on both meshes against
              make_train_step, and on NCCL the train-mode (FSDP) step with
              2 microbatches and the same with ZeRO-2 against
              make_train_step(microbatches=2), in the same call: metrics
              and params bit-equal, phase 10's launches a microbatch, the
              all_gathers the specs give; warm step host ms, collectives
              by kind and peak memory beside phase 10's.
 13. the dry run and the roofline (launch.dryrun, launch.dryrun_dmtrl,
              roofline.analysis) — (a) gemma3-1b and mamba2-780m whole at
              phase 10's step through the dry run's train-mode step, one
              position: the dry run's bytes at rest
              equal the params and both moments on the card, exactly; the
              meta trace of one step equals roofline.analysis.CostCounter
              over one real step on the card, exactly, in FLOPs, bytes and
              kernel launches by kind (K3, K3-bwd; K4, K4-bwd), the
              counter's launches equal the wrappers'; the trace's peak of
              live bytes beside max_memory_allocated; the roofline terms
              and model FLOPs over phase 10's warm step at the bf16 peak.
              (b) make_distributed_round at phase 11e's size (4096 tasks,
              d = 100, one position) with block_gram and with pallas_round
              (K1): its meta trace equals the counter over the real round
              on the card, exactly; then dryrun_dmtrl's rows at the JAX
              package's defaults on the (16, 16) and (2, 16, 16) meshes.
              (c) every arch x input shape x mesh through launch.dryrun on
              the host (fake worlds of 256 and 512 ranks, meta tensors):
              every train row "ok" (the train-mode step with JAX's
              microbatches), every prefill and decode row "ok" (the
              sharded serving step under JAX's serve-mode specs and
              decode cache layouts), each row's state at rest plus its
              traced peak under the card's 80 GB but kimi-k2's serve rows
              ("fits" false), long_500k "skipped" where shape_applicable
              says; the train rows within DRYRUN_TABLE_S, the serve rows
              within DRYRUN_SERVE_S.
 14. the sharded serving step — gemma3-1b and zamba2-2.7b whole (bf16,
              seed 0): a 2 x 512-token prefill and 16 greedy decode ticks
              through models.make_sharded_prefill and
              make_sharded_decode_step on the local mesh and on a
              one-rank NCCL world, against prefill and decode_step in the
              same call: logits, every cache leaf and the position
              bit-equal; K3 (and K4) launches a prefill, collectives a
              tick, warm prefill and tick ms beside the unsharded ones;
              the meta trace of the same prefill and tick
              (dryrun.trace_serve) equals the counter over the card's
              calls, exactly;
 15. the examples — every port example (examples/torch) as its own
              process at the JAX examples' default sizes, four at a
              time: quickstart, serve_batch (gemma3-1b and mamba2-780m
              reduced, --mtl), serve_stream (and --interleave),
              serve_fleet, train_lm_mtl, distributed_workers and
              async_workers (--trace), the two mesh examples also under
              a one-rank torchrun world (nccl; async_workers there at
              its --tiny schedule); each exits 0 with its
              main's dict as its last line, which the phase checks (the
              gap shrinks, W against the reference engine, async ticks
              against sync, the threaded lag, the trace's spans, no
              served version regresses, the interleaved shorts finish
              first) along with each LM example's K3, K3-bwd and K4
              launches against its reduced config's layers.

It exits non-zero, printing no result, without a CUDA card or outside a
checkout of the repository. The line before the last is a JSON object with
each kernel's numbers; the last line is {"ok": true, "device": {...}}.
Float32 matmuls run in full float32 (TF32 off) throughout. Kernel times are
CUDA-event means over back-to-back calls queued behind a sleep on the
stream, so they are device times, not the host's launch pace.
"""
from __future__ import annotations

import contextlib
import gc
import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

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
# the dense and SSM families' shapes (phase 8) over the same prompt:
# gemma3-1b's attention (4 heads of 256 after the GQA expand, its local
# layers' window of 512), qwen1.5-4b's (20 heads of 128), and one
# mamba2-780m layer's SSD chunks (48 heads, P = 64, N = 128, one group)
GEMMA_HEADS, GEMMA_HD, GEMMA_WINDOW = 4, 256, 512
QWEN_HEADS, QWEN_HD = 20, 128
# the rest of the zoo (phase 9): qwen3-moe's attention (32 heads of 128),
# chameleon-34b's and kimi-k2's (64 heads of 128), whisper-tiny's (6 heads
# of 64; the encoder over its 1500 frames, cross-attention against them)
MOE_HEADS, WIDE_HEADS, ZOO_HD = 32, 64, 128
WHISPER_HEADS, WHISPER_HD, WHISPER_FRAMES = 6, 64, 1500
MAMBA_H, MAMBA_P, MAMBA_N = 48, 64, 128
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
# K3-bwd (phase 2) at the training shapes: gemma3-1b's attention over a
# sequence of 1024 (bf16, causal and its window of 512; fp32), qwen1.5-4b's
# over 512, whisper-tiny's encoder over its 1500 frames and its decoder's
# 448 rows across them (both fp32, non-causal). Bars relative to
# max(1, max|plain|), as in tests/test_torch_flash_bwd_kernel.py: fp32 2e-5
# (the same sums in another order; the products are split TF32, which keeps
# fp32's accuracy), bf16 2e-2 (both sides round an fp32 value to bf16, one
# step of 2^-7 at the largest entry; D = rowsum(dO o) comes from K3's bf16
# output, and P and dS are rounded to bf16 as mma operands)
BWD_SHAPES = (  # (label, heads, rows, keys, head dim, bf16, causal, window)
    ("gemma3-1b", GEMMA_HEADS, 1024, 1024, GEMMA_HD, True, True, 0),
    ("gemma3-1b", GEMMA_HEADS, 1024, 1024, GEMMA_HD, True, True, GEMMA_WINDOW),
    ("gemma3-1b", GEMMA_HEADS, 1024, 1024, GEMMA_HD, False, True, 0),
    ("qwen1.5-4b", QWEN_HEADS, 512, 512, QWEN_HD, True, True, 0),
    ("whisper-tiny encoder", WHISPER_HEADS, WHISPER_FRAMES, WHISPER_FRAMES, WHISPER_HD,
     False, False, 0),
    ("whisper-tiny cross", WHISPER_HEADS, 448, WHISPER_FRAMES, WHISPER_HD, False, False, 0),
)
TOL_BWD_F32, TOL_BWD_BF16 = 2e-5, 2e-2
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
# the paper's MDS width (Table 1's MDS): 22 domains of up to 14 525
# training reviews over d = 10 000 words; K1 streams the rows there in one kernel
MDS_M, MDS_N_MAX, MDS_D = 22, 14525, 10000
# the streamed round's plans timed there, (CTAs a task, warps a CTA): 12 x 22
# = 264 CTAs of 4 warps fill every SM twice
MDS_STREAM_PLANS = ((12, 4), (11, 4), (8, 4), (16, 2), (6, 4))
# the two-kernel round it replaced there (gram_kernel, then a streaming
# chain that read the rows twice), ms a round on an H100 at 700 W: its
# stages timed apart by this phase, and in mds.fit's profiled fits
MDS_PARENT_STAGES_MS = {"timed apart": (7.22, 8.85), "mds.fit profile": (7.27, 9.12)}
# served scores against the estimator's predict path: the same per-row dot
# products in another kernel (a gather and a row-wise dot against
# predictions' batched product); the JAX package's serving tests hold them
# at 1e-5. Sigma rows gathered from the factors against the dense view:
# the same products in another order, 1e-6 as in tests/test_sigma_view.py.
TOL_SCORE, TOL_SIGMA_ROW = 1e-5, 1e-6
# the parameter server (phase 7): 2 workers over the server at MNIST width
# and on Synthetic-1 (phase 4's lambda there), the second one paced 4x at
# tau = 1; the gossip ring over 4 nodes
PS_WORKERS, PS_DELAYS, GOSSIP_NODES = 2, (1, 4), 4
PS_CFG = dict(solver="pallas_round", loss="hinge", lam=1e-4, outer_iters=2, rounds=3,
              local_iters=0, block_size=BLOCK)
SYN_LAM = 1e-3
# the LM families (phase 8), each at full width behind phase 5's engine and
# requests; nemotron-4-15b's depth is cut to 4 of its 32 layers (its 15.7e9
# parameters at full depth would show nothing the other three do not), and
# qwen1.5-4b's to 8 of 40 (the same block each layer), which pays for part
# of phase 12's time.
# gemma3's ring buffer in fp32 across its window: a prefill of 508 tokens
# plus 8 decode steps against prefills of 509 .. 516 tokens
LM_FAMILIES = ("gemma3-1b", "qwen1.5-4b", "nemotron-4-15b", "mamba2-780m")
FAMILY_LAYERS = {"nemotron-4-15b": 4, "qwen1.5-4b": 8}
RING_S, RING_STEPS = 508, 8
BUCKET_LENS = (300, 129, 17)  # bucketed (512, 256, 32) against exact-length prefills
# the rest of the zoo (phase 9), each at full width behind phase 5's engine
# and requests: qwen3-moe cut to 8 of its 48 layers (every layer is the
# same MoE block), kimi-k2 to 1 of 61 (its 19.4e9 parameters a layer with
# the embeddings take 38.9 GB in bf16: 2 layers would be 73.1 GB),
# chameleon-34b to 4 of 48; whisper-tiny whole (4 encoder and 4 decoder
# layers over 1500 frames a request)
ZOO_FAMILIES = ("qwen3-moe-30b-a3b", "kimi-k2-1t-a32b", "chameleon-34b", "whisper-tiny")
ZOO_LAYERS = {"qwen3-moe-30b-a3b": 8, "kimi-k2-1t-a32b": 1, "chameleon-34b": 4}
# an fp32 bucketed MoE prefill at lossless capacity against exact length:
# the same rows through the same kernels, where the expert products' and
# the buffers' shapes follow the bucket (C = S K cf / E)
TOL_BUCKET = 1e-5
# 8e, the backbone -> DMTRL bridge: examples/train_lm_mtl.py's band recipe
# at 6 tasks x 256 sequences x 64 tokens (seed 0 train, seed 1 test), heads
# fitted on gemma3-1b's pooled features (d = 1152) through K1
BRIDGE_TASKS, BRIDGE_N, BRIDGE_SEQ = 6, 256, 64
BRIDGE_CFG = dict(loss="hinge", lam=1e-3, outer_iters=3, rounds=8, local_iters=128, seed=0)
# the bf16 backbone's unit-norm features through K3 against the same
# backbone with the plain attention on the card: K3 rounds P to bf16 (the
# plain version keeps it in fp32), which moves an attention output by up to
# one bf16 step, and 26 layers carry that to the pooled, normalized
# features (entries up to 0.14). Measured on an H100: 9.8e-4 (min cosine
# 0.999987); held at 5e-3, a 5x margin
TOL_FEATURES = 5e-3
# phase 10, training: (a) gemma3-1b at full width and depth in bf16 with
# remat, AdamW(lr=1e-3, warmup_steps=2), 10 steps on one repeated batch of
# 2 x 1024 tokens (so the local layers' window of 512 is active); each step
# runs K3 twice per layer (forward and remat) and K3-bwd once. (b) one step
# on the card against the same step on the CPU in fp32: gemma3-1b reduced
# to 6 layers (a global layer among the local ones), whisper-tiny whole
# (remat, 1500 frames) and qwen3-moe-30b-a3b reduced (the MoE gathers).
# Bars: the loss 1e-4, every gradient leaf 2e-4 (the prefill bar), the
# params after one update 2e-4 (a first AdamW step moves each entry by
# lr g / (|g| + eps), at most lr = 5e-5 apart where g is near 0). (c) the
# launcher on whisper-tiny for 3 steps with a checkpoint.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 1024, 10
CHECK_BATCH, CHECK_SEQ, CHECK_LR = 2, 64, 5e-5
TOL_TRAIN_LOSS, TOL_TRAIN_GRAD, TOL_TRAIN_PARAM = 1e-4, 2e-4, 2e-4
# K4-bwd (phase 2) at the training layouts: mamba2-780m's (2 x 1024 tokens,
# 48 heads, P = 64, N = 128, one group) with x, B and C as bf16 views of the
# conv output and in fp32, zamba2-2.7b's (80 heads, N = 64), a ragged last
# chunk (L = 1000), a 17-step chunk, 4 groups of 8 heads, and the chunk whose
# decay passes exp's range (dt = 0.1, A down to -16: RC5). Bars relative to
# max(1, max|plain|), as K3-bwd's: outputs in fp32 2e-5 (the same sums in
# another order, the products in split TF32), outputs rounded to bf16 2e-2
# (one bf16 step where the two fp32 values straddle a rounding boundary)
SSD_BWD_SHAPES = (  # (label, B, L, H, G, P, N, chunk, bf16, overflow)
    ("mamba2-780m bf16", 2, 1024, MAMBA_H, 1, MAMBA_P, MAMBA_N, 64, True, False),
    ("mamba2-780m fp32", 2, 1024, MAMBA_H, 1, MAMBA_P, MAMBA_N, 64, False, False),
    ("zamba2-2.7b bf16", 2, 1024, SSD_H, 1, SSD_P, SSD_N, 64, True, False),
    ("ragged L=1000 bf16", 1, 1000, MAMBA_H, 1, MAMBA_P, MAMBA_N, 64, True, False),
    ("Q=17 fp32", 1, 100, 8, 1, 64, 64, 17, False, False),
    ("G=4 of H=8 fp32", 2, 256, 8, 4, 64, 64, 64, False, False),
    ("overflow fp32", 1, 256, MAMBA_H, 1, MAMBA_P, MAMBA_N, 64, False, True),
    ("13 heads bf16", 2, 512, 13, 1, MAMBA_P, MAMBA_N, 64, True, False),
)
TOL_SSD_BWD_F32, TOL_SSD_BWD_BF16 = 2e-5, 2e-2
# the shapes whose cluster sizes phase 2 sweeps: the two training steps and
# a grid of four (batch, chunk) units
SSD_BWD_SWEEP = ("mamba2-780m bf16", "zamba2-2.7b bf16", "overflow fp32")
# phase 5c: phase 5's zamba2 engine behind the streaming scheduler, 8
# requests of 16 tokens arriving two at first and then one every second
# decode step; at temperature 0.8 (seed 0) twice and at temperature 0
STREAM_LENS = (512, 300, 129, 64, 200, 17, 90, 256)
STREAM_TEMPERATURE = 0.8
# phase 12, the sharded train step on one position: phase 10's configs,
# init and batch (bf16, remat, 2 x 1024 tokens, AdamW(lr=1e-3, warmup 2)),
# gemma3-1b for 10 steps and mamba2-780m for 3, through
# make_sharded_train_step on the local mesh and on a one-rank NCCL world,
# each against make_train_step in the same call. On one position every
# gather is a copy and every sum has one term, so the params and metrics
# are held bit for bit
SHARDED_STEPS = {"gemma3-1b": 10, "mamba2-780m": 3}
# phase 13c: the dry-run table's 20 train rows (a row of more than two
# microbatches counted from its first two) must stay well inside the
# script's own time limit (the whole table took 137.9 and 171.8 s on the
# card's host when they were its only traced rows); every row's state at
# rest plus its traced peak within the card's memory but kimi-k2's serve
# rows
DRYRUN_TABLE_S = 240.0
CARD_BYTES = 80e9
# phase 13c's 40 traced prefill and decode rows (a sharded serving step
# each), timed apart from the train rows: 31.7-33.4 s summed on the
# card's host
DRYRUN_SERVE_S = 120.0
# phase 14, the sharded serving step on one position: gemma3-1b and
# zamba2-2.7b whole (bf16, seed 0), a 2 x 512-token prefill and 16 greedy
# decode ticks through make_sharded_prefill and make_sharded_decode_step,
# on the local mesh and on a one-rank NCCL world, each against prefill and
# decode_step in the same call, bit for bit
SERVE_SHARDED = ("gemma3-1b", "zamba2-2.7b")
SERVE_BATCH, SERVE_PROMPT, SERVE_TICKS = 2, 512, 16


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


def device_events(prof) -> list:
    """The profile's device-side entries (kernels, copies, memsets), each
    counted once. An operator's entry also carries its kernels' time as
    its own self device time, so a sum over every entry would count each
    kernel twice."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type != DeviceType.CPU and e.self_device_time_total > 0]


def bound_ms(nbytes: float, flops: float, peak_flops: float = PEAK_FP32_FLOPS):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def stage1_bound(m: int, H: int, d: int) -> dict:
    """K1's stage 1 (``sdca::gram_kernel``) alone: the least time of its own
    work, each block's Gram triangle and q (2 (B(B+1)/2 + B) d FLOPs) at the
    fp32 peak against every drawn row read once (4 d bytes a draw) at HBM's."""
    flops = 2.0 * m * (H // BLOCK) * (GRAM_TRI + BLOCK) * d
    nbytes = 4.0 * m * H * d
    b, by = bound_ms(nbytes, flops)
    return dict(bound_ms=b, bound_by=by, gflop=flops / 1e9, gb=nbytes / 1e9)


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
    flash_shapes = [dict(shape=list(q.shape), keys=S, causal=True, dtype="bf16", window=0,
                         max_abs_err=err_flash,
                         ms=ms_flash, plain_ms=plain_flash, bound_ms=b_flash,
                         bound_by=by_flash, library_ms=lib_flash)]
    del qkv32, q, k, v

    # gemma3-1b (head dim 256, bf16 and fp32, causal and its window),
    # qwen1.5-4b (head dim 128, bf16), qwen3-moe (32 heads of 128),
    # chameleon-34b and kimi-k2 (64 heads of 128), and whisper-tiny's
    # non-causal calls (6 heads of 64 over its 1500 frames: the encoder's
    # self-attention in fp32, as the bf16 model runs its encoder, and in
    # bf16; cross-attention's 512 decoder rows against the frames in fp32),
    # each timed beside scaled_dot_product_attention where it computes the
    # same function (a window that covers the whole prompt is the causal mask)
    for H_, S_, Sk_, HD_, dtype, causal, window in (
        (GEMMA_HEADS, S, S, GEMMA_HD, torch.bfloat16, True, 0),
        (GEMMA_HEADS, S, S, GEMMA_HD, torch.bfloat16, True, GEMMA_WINDOW),
        (GEMMA_HEADS, S, S, GEMMA_HD, torch.float32, True, 0),
        (GEMMA_HEADS, S, S, GEMMA_HD, torch.float32, True, GEMMA_WINDOW),
        (QWEN_HEADS, S, S, QWEN_HD, torch.bfloat16, True, 0),
        (MOE_HEADS, S, S, ZOO_HD, torch.bfloat16, True, 0),
        (WIDE_HEADS, S, S, ZOO_HD, torch.bfloat16, True, 0),
        (WHISPER_HEADS, WHISPER_FRAMES, WHISPER_FRAMES, WHISPER_HD, torch.float32, False, 0),
        (WHISPER_HEADS, WHISPER_FRAMES, WHISPER_FRAMES, WHISPER_HD, torch.bfloat16, False, 0),
        (WHISPER_HEADS, S, WHISPER_FRAMES, WHISPER_HD, torch.float32, False, 0),
    ):
        bf16 = dtype == torch.bfloat16
        name, tol = ("bf16", TOL_FLASH_BF16) if bf16 else ("fp32", TOL_FLASH_F32)
        label = (f"{name} (1, {H_}, {S_}, {HD_})" + (f" x {Sk_} keys" if Sk_ != S_ else "")
                 + ("" if causal else " non-causal") + (f" window {window}" if window else ""))
        q = torch.from_numpy(rs.randn(1, H_, S_, HD_).astype(np.float32)).to(dev, dtype)
        k, v = (torch.from_numpy(rs.randn(1, H_, Sk_, HD_).astype(np.float32)).to(dev, dtype)
                for _ in range(2))
        out = flash_kernel.flash_attention(q, k, v, causal, window)
        torch.cuda.synchronize()
        want = flash_ref.attention_ref(q, k, v, causal, window)
        check(bool(torch.isfinite(out).all()), f"flash {label}: non-finite output")
        e = (out.float() - want.float()).abs().max().item()
        check(e <= tol, f"flash {label} disagrees with its plain version: {e:.3e}")
        err_flash = max(err_flash, e)
        ms = cuda_ms(torch, lambda: flash_kernel.flash_attention(q, k, v, causal, window),
                     reps=50)
        plain = cuda_ms(torch, lambda: flash_ref.attention_ref(q, k, v, causal, window), reps=10)
        lib = None
        if window == 0 or window >= S_:
            lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal),
                          reps=50)
        # (query, key) pairs kept: the causal triangle (within the window), or all
        pairs = (sum(min(i + 1, window or S_) for i in range(S_)) if causal else S_ * Sk_)
        b, by = bound_ms((2 * q.numel() + 2 * k.numel()) * q.element_size(),
                         4.0 * H_ * HD_ * pairs, PEAK_BF16_FLOPS if bf16 else PEAK_FP32_FLOPS)
        lib_txt = f"{lib:.4f} ms" if lib is not None else "n/a (window)"
        print(f"[2 flash_fwd {label}] max|out - plain| = {e:.3e} (tolerance {tol:.0e}); "
              f"{ms:.4f} ms/call (plain {plain:.3f} ms, scaled_dot_product_attention "
              f"{lib_txt}), bound {b:.5f} ms by {by} on {card}")
        flash_shapes.append(dict(shape=[1, H_, S_, HD_], keys=Sk_, causal=causal, dtype=name,
                                 window=window, max_abs_err=e, ms=ms, plain_ms=plain,
                                 bound_ms=b, bound_by=by, library_ms=lib))
        del q, k, v, out, want

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

    def ssd_bound(L_, H_, P_, N_, Q_):
        """x, B, C (bf16, one group) and dt read; Y, S, a_tot written
        (fp32); C B^T once per chunk, Y and S per head, three TF32 passes
        (the kernel forms C B^T per head: the bound counts the work needed)."""
        nc_, tri_ = -(-L_ // Q_), Q_ * (Q_ + 1) / 2
        nbytes = (L_ * H_ * P_ * 2 + L_ * 2 * N_ * 2 + L_ * H_ * 4
                  + 4 * (L_ * H_ * P_ + nc_ * H_ * N_ * P_ + nc_ * H_) + H_ * 4)
        flops = 3 * (nc_ * 2.0 * tri_ * N_ + nc_ * H_ * (2.0 * tri_ * P_ + 2.0 * Q_ * N_ * P_))
        return bound_ms(nbytes, flops, PEAK_TF32_FLOPS) + (nbytes, flops)

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
    b_ssd, by_ssd, ssd_bytes, ssd_flops = ssd_bound(L, Hs, P, N, Q)
    print(f"[2 ssd_chunk] Zamba2 layout bf16 (1, {L}, {Hs}, {P}), G=1: {ms_ssd:.4f} ms/call "
          f"(plain {plain_ssd:.3f} ms), bound {b_ssd:.5f} ms by {by_ssd} "
          f"({ssd_bytes / 1e6:.2f} MB, {ssd_flops / 1e9:.2f} GFLOP TF32) on {card}")
    del zin
    ssd_shapes = [dict(shape=[1, L, Hs, P], N=N, dtype="bf16", max_abs_err=err_ssd, ms=ms_ssd,
                       plain_ms=plain_ssd, bound_ms=b_ssd, bound_by=by_ssd, library_ms=None)]
    # mamba2-780m's layout: bf16 views of its conv output, one group
    min_ = seq_inputs(L, MAMBA_H, 1, MAMBA_P, MAMBA_N, torch.bfloat16, 4)
    got = ssd_kernel.ssd_chunk_kernel(*min_, chunk=Q)
    torch.cuda.synchronize()
    e = ssd_check("mamba2-780m layout bf16 G=1", got, ssd_ref.chunk_seq_ref(*min_, Q))
    err_ssd = max(err_ssd, e)
    ms = cuda_ms(torch, lambda: ssd_kernel.ssd_chunk_kernel(*min_, chunk=Q), reps=50)
    plain = cuda_ms(torch, lambda: ssd_ref.chunk_seq_ref(*min_, Q), reps=10)
    b, by, nbytes, flops = ssd_bound(L, MAMBA_H, MAMBA_P, MAMBA_N, Q)
    print(f"[2 ssd_chunk] mamba2-780m layout bf16 (1, {L}, {MAMBA_H}, {MAMBA_P}), N={MAMBA_N}, "
          f"G=1: {ms:.4f} ms/call (plain {plain:.3f} ms), bound {b:.5f} ms by {by} "
          f"({nbytes / 1e6:.2f} MB, {flops / 1e9:.2f} GFLOP TF32) on {card}")
    ssd_shapes.append(dict(shape=[1, L, MAMBA_H, MAMBA_P], N=MAMBA_N, dtype="bf16",
                           max_abs_err=e, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                           library_ms=None))
    del min_, got
    return dict(
        flash=dict(max_abs_err=err_flash, ms=ms_flash, plain_ms=plain_flash,
                   bound_ms=b_flash, bound_by=by_flash, library_ms=lib_flash,
                   shapes=flash_shapes),
        ssd=dict(max_abs_err=err_ssd, ms=ms_ssd, plain_ms=plain_ssd,
                 bound_ms=b_ssd, bound_by=by_ssd, library_ms=None, shapes=ssd_shapes),
    )


def flash_bwd_checks(torch, dev, card: str) -> dict:
    """Phase 2 for K3-bwd: the backward kernel against autograd of the plain
    attention at the training shapes (BWD_SHAPES), each timed beside the
    plain backward and the backward of scaled_dot_product_attention where
    it computes the same function (no window)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash import flash_kernel
    from repro_torch.kernels.flash import ref as flash_ref

    rs = np.random.RandomState(2)
    shapes, err_all = [], 0.0
    for label, H_, S_, Sk_, HD_, bf16, causal, window in BWD_SHAPES:
        dtype = torch.bfloat16 if bf16 else torch.float32
        name, tol = ("bf16", TOL_BWD_BF16) if bf16 else ("fp32", TOL_BWD_F32)
        text = (f"{label} {name} (1, {H_}, {S_}, {HD_})" + (f" x {Sk_} keys" if Sk_ != S_ else "")
                + ("" if causal else " non-causal") + (f" window {window}" if window else ""))
        q, do = (torch.from_numpy(rs.randn(1, H_, S_, HD_).astype(np.float32)).to(dev, dtype)
                 for _ in range(2))
        k, v = (torch.from_numpy(rs.randn(1, H_, Sk_, HD_).astype(np.float32)).to(dev, dtype)
                for _ in range(2))
        out, lse = flash_kernel.flash_attention(q, k, v, causal, window, return_lse=True)
        got = flash_kernel.flash_attention_bwd(q, k, v, out, do, lse, causal, window)
        again = flash_kernel.flash_attention_bwd(q, k, v, out, do, lse, causal, window)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"flash_bwd {text}: two calls gave different bits")
        want = flash_ref.attention_ref_bwd(q, k, v, do, causal, window)
        err, rel = 0.0, 0.0
        for g_name, a, b in zip(("dq", "dk", "dv"), got, want):
            check(bool(torch.isfinite(a).all()), f"flash_bwd {text}: non-finite {g_name}")
            e = (a.float() - b.float()).abs().max().item()
            err = max(err, e)
            rel = max(rel, e / max(1.0, b.float().abs().max().item()))
        check(rel <= tol, f"flash_bwd {text} disagrees with its plain version: {rel:.3e}")
        err_all = max(err_all, err)
        ms = cuda_ms(torch, lambda: flash_kernel.flash_attention_bwd(
            q, k, v, out, do, lse, causal, window), reps=10)
        plain = cuda_ms(torch, lambda: flash_ref.attention_ref_bwd(q, k, v, do, causal, window),
                        reps=5)
        lib = None
        if window == 0:
            qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
            o_lib = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
            lib = cuda_ms(torch, lambda: torch.autograd.grad(o_lib, (qg, kg, vg), do,
                                                             retain_graph=True), reps=10)
            del qg, kg, vg, o_lib
        pairs = (sum(min(i + 1, window or S_) for i in range(S_)) if causal else S_ * Sk_)
        # q, k, v, o, dO and lse read once, dq, dk, dv written once; the
        # function's five products of 2 HD flops per kept pair (S, dP, dV,
        # dK, dQ). The kernel's deterministic design does seven (S and dP
        # again in the dQ pass): its own floor is printed beside. bf16 at the
        # tensor cores' bf16 peak; fp32 runs three TF32 passes (split TF32),
        # and its fp32 FMA bound is printed beside
        nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size() + lse.numel() * 4
        flops = 10.0 * H_ * HD_ * pairs
        if bf16:
            b, by = bound_ms(nbytes, flops, PEAK_BF16_FLOPS)
            b7 = bound_ms(nbytes, flops * 7 / 5, PEAK_BF16_FLOPS)[0]
            fma_txt = ""
        else:
            b, by = bound_ms(nbytes, 3 * flops, PEAK_TF32_FLOPS)
            b7 = bound_ms(nbytes, 3 * flops * 7 / 5, PEAK_TF32_FLOPS)[0]
            fma_b = bound_ms(nbytes, flops, PEAK_FP32_FLOPS)[0]
            fma_txt = f", as fp32 FMAs {fma_b:.5f} ms"
        lib_txt = f"{lib:.4f} ms" if lib is not None else "n/a (window)"
        print(f"[2 flash_bwd {text}] max|d(q, k, v) - plain| = {err:.3e} (relative {rel:.3e}, "
              f"tolerance {tol:.0e}), two calls bit-equal; {ms:.4f} ms/call (plain "
              f"{plain:.3f} ms, scaled_dot_product_attention backward {lib_txt}), bound "
              f"{b:.5f} ms by {by} at 5 products a pair (the deterministic design's 7: "
              f"{b7:.5f}){fma_txt} on {card}")
        shapes.append(dict(shape=[1, H_, S_, HD_], keys=Sk_, causal=causal, dtype=name,
                           window=window, max_abs_err=err, max_rel_err=rel, bit_equal=True,
                           ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, bound_7_ms=b7,
                           library_ms=lib))
        del q, k, v, do, out, lse, got, again, want
    head = shapes[0]  # gemma3-1b bf16 causal: the phase-10 step's shape
    return dict(max_abs_err=err_all, ms=head["ms"], plain_ms=head["plain_ms"],
                bound_ms=head["bound_ms"], bound_by=head["bound_by"],
                library_ms=head["library_ms"], shapes=shapes)


def ssd_bwd_checks(torch, dev, card: str) -> dict:
    """Phase 2 for K4-bwd: the backward kernel against the plain backward
    (ref.chunk_bwd_ref) on the same card tensors at SSD_BWD_SHAPES, called
    twice (the two results bit-equal), timed beside the plain version, with
    the bound of the work the function needs."""
    from repro_torch.kernels.ssd import ref as ssd_ref
    from repro_torch.kernels.ssd import ssd_kernel

    names = ("dx", "ddt", "dA", "dB", "dC")
    shapes, err_all = [], 0.0
    for label, B_, L, H_, G_, P_, N_, chunk, bf16, overflow in SSD_BWD_SHAPES:
        rs = np.random.RandomState(L + H_ + N_)
        dtype = torch.bfloat16 if bf16 else torch.float32
        xbc = np.concatenate([rs.randn(B_, L, H_ * P_), 0.3 * rs.randn(B_, L, 2 * G_ * N_)], -1)
        xbc = torch.from_numpy(xbc.astype(np.float32)).to(device=dev, dtype=dtype)
        x = xbc[..., : H_ * P_].reshape(B_, L, H_, P_)
        Bm = xbc[..., H_ * P_: H_ * P_ + G_ * N_].reshape(B_, L, G_, N_)
        Cm = xbc[..., H_ * P_ + G_ * N_:].reshape(B_, L, G_, N_)
        A = -torch.linspace(1.0, 16.0, H_, device=dev)
        dt0 = np.exp(np.linspace(np.log(1e-3), np.log(1e-1), H_))
        dtv = np.logaddexp(0.0, rs.randn(B_, L, H_) + dt0 + np.log(-np.expm1(-dt0)))
        if overflow:
            dtv = np.full_like(dtv, 0.1)
        dt = torch.from_numpy(dtv.astype(np.float32)).to(dev)
        Q = min(chunk, L)
        nc = -(-L // Q)
        dY, dS, da = (torch.from_numpy(rs.randn(*s).astype(np.float32)).to(dev)
                      for s in ((B_, L, H_, P_), (B_, nc, H_, N_, P_), (B_, nc, H_)))
        args = (x, dt, A, Bm, Cm, dY, dS, da)
        got = ssd_kernel.ssd_chunk_bwd_kernel(*args, chunk=chunk)
        again = ssd_kernel.ssd_chunk_bwd_kernel(*args, chunk=chunk)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"ssd_chunk_bwd {label}: two calls gave different bits")
        want = ssd_ref.chunk_bwd_ref(*args, chunk)
        exact_txt, exact = "", {}
        if not bf16:  # both against the function evaluated in fp64
            w64 = ssd_ref.chunk_bwd_ref(*args, chunk, compute=torch.float64)
            for who, outs in (("kernel", got), ("plain", want)):
                exact[who] = max((a.double() - w.double()).abs().max().item()
                                 / max(1.0, w.abs().max().item()) for a, w in zip(outs, w64))
            exact_txt = (f"; relative max|d - fp64| kernel {exact['kernel']:.2e}, plain "
                         f"{exact['plain']:.2e}")
            del w64
        if overflow:
            decay = float(-(dt[0, :Q, -1] * A[-1]).sum())
            check(decay > 88.7, f"ssd_chunk_bwd {label}: the decay {decay:.1f} does not overflow")
            check(all(bool(torch.isfinite(w).all()) for w in want),
                  f"ssd_chunk_bwd {label}: the plain backward is not finite")
        err, rel, parts = 0.0, 0.0, []
        for name, a, b in zip(names, got, want):
            check(bool(torch.isfinite(a).all()), f"ssd_chunk_bwd {label}: non-finite {name}")
            e = (a.float() - b.float()).abs().max().item()
            r = e / max(1.0, b.float().abs().max().item())
            tol = TOL_SSD_BWD_BF16 if a.dtype == torch.bfloat16 else TOL_SSD_BWD_F32
            check(r <= tol, f"ssd_chunk_bwd {label} {name} disagrees with its plain version: "
                  f"{r:.3e} relative (tolerance {tol:.0e})")
            parts.append(f"{name} {r:.2e}")
            err, rel = max(err, e), max(rel, r)
        err_all = max(err_all, err)
        ms = cuda_ms(torch, lambda: ssd_kernel.ssd_chunk_bwd_kernel(*args, chunk=chunk), reps=20)
        plain = cuda_ms(torch, lambda: ssd_ref.chunk_bwd_ref(*args, chunk), reps=3)
        # the products the function needs: C B^T and the (dG o M) terms of
        # dC and dB once per group (B and C are a group's), dY u^T and G^T dY
        # per head over the causal triangle, u dS^T and B dS per head over
        # the chunk; three TF32 passes. Bytes: x, dt, B, C, dY, dS and da
        # read once, dx, d(dt), dA, dB and dC written once
        tri = Q * (Q + 1) / 2
        flops = B_ * nc * (G_ * 3 * 2.0 * tri * N_ + H_ * (2 * 2.0 * tri * P_ + 2 * 2.0 * Q * N_ * P_))
        es = x.element_size()
        nbytes = (2 * B_ * L * H_ * P_ * es + 4 * B_ * L * G_ * N_ * es + 2 * B_ * L * H_ * 4
                  + 2 * H_ * 4 + B_ * L * H_ * P_ * 4 + dS.numel() * 4 + da.numel() * 4)
        b, by = bound_ms(nbytes, 3 * flops, PEAK_TF32_FLOPS)
        # the design's own count of what it reads and writes (B and C once
        # per CTA of a group's cluster, dA's fp64 terms written and read
        # back, the rest once): worked out from the plan, not measured
        plan = ssd_kernel.bwd_launch_plan(B_, L, H_, G_, Q, P_, N_, bf16, dev)
        design = (nbytes + (plan.cluster - 1) * 2 * B_ * L * G_ * N_ * es
                  + 2 * da.numel() * 8)
        print(f"[2 ssd_chunk_bwd {label}] (B={B_}, L={L}, H={H_}, G={G_}, P={P_}, N={N_}, "
              f"Q={Q}): relative max|d - plain| {', '.join(parts)} (tolerance "
              f"{TOL_SSD_BWD_F32:.0e} fp32, {TOL_SSD_BWD_BF16:.0e} bf16){exact_txt}, two calls "
              f"bit-equal{', finite where exp overflows' if overflow else ''}; {ms:.4f} ms/call "
              f"(plain {plain:.3f} ms), bound {b:.5f} ms by {by} ({flops / 1e9:.2f} GFLOP, "
              f"{nbytes / 1e6:.1f} MB); the design's byte count {design / 1e6:.1f} MB; plan: "
              f"{plan.head_block} heads a CTA, clusters of {plan.cluster}, {plan.stages} "
              f"stage(s), bwd_smem_bytes {plan.smem_bytes}; on {card}")
        shapes.append(dict(label=label, shape=[B_, L, H_, P_], G=G_, N=N_, Q=Q,
                           dtype="bf16" if bf16 else "fp32", max_abs_err=err, max_rel_err=rel,
                           bit_equal=True, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                           library_ms=None, head_block=plan.head_block,
                           cluster=plan.cluster, stages=plan.stages,
                           smem_bytes=plan.smem_bytes,
                           **{f"max_rel_err_fp64_{k}": v for k, v in exact.items()}))
        if label in SSD_BWD_SWEEP:
            shapes[-1]["cluster_sweep"] = ssd_bwd_cluster_sweep(torch, args, chunk, card)
        del xbc, x, Bm, Cm, dt, dY, dS, da, args, got, again, want
    torch.cuda.empty_cache()
    head = shapes[0]  # mamba2-780m bf16: the phase-10d step's shape
    return dict(max_abs_err=err_all, ms=head["ms"], plain_ms=head["plain_ms"],
                bound_ms=head["bound_ms"], bound_by=head["bound_by"], library_ms=None,
                shapes=shapes)


def ssd_bwd_cluster_sweep(torch, args, chunk: int, card: str) -> list:
    """K4-bwd at every cluster size a group's heads allow: the clusters the
    card holds at once (cudaOccupancyMaxActiveClusters) and the time, beside
    the size ``ssd_kernel.bwd_cluster`` picks. Timing only."""
    from repro_torch.kernels.ssd import ssd_kernel

    x, Bm = args[0], args[3]
    B_, L, H_, P_ = x.shape
    G_, N_ = Bm.shape[2:]
    Q, bf16 = min(chunk, L), x.dtype == torch.bfloat16
    units = B_ * -(-L // Q) * G_
    pick = ssd_kernel.bwd_launch_plan(B_, L, H_, G_, Q, P_, N_, bf16, x.device).cluster
    rows = []
    for c in range(1, min(ssd_kernel.MAX_CLUSTER, H_ // G_) + 1):
        plan = ssd_kernel.bwd_plan(Q, P_, N_, H_ // G_, bf16, c)
        if plan.cluster != c:
            continue  # the same plan as a smaller size
        active = ssd_kernel._active_clusters(x.device.index or 0, Q, N_, P_, c, bf16)
        if active < 1:
            rows.append(dict(cluster=c, head_block=plan.head_block, active_clusters=0, ms=None))
            continue
        ms = cuda_ms(torch, lambda: ssd_kernel.ssd_chunk_bwd_kernel(*args, chunk=chunk,
                                                                    cluster=c), reps=20)
        rows.append(dict(cluster=c, head_block=plan.head_block, active_clusters=active, ms=ms))
    print(f"[2 ssd_chunk_bwd cluster sweep {x.dtype}, {tuple(x.shape)}] {units} (batch, chunk, "
          f"group) units, {H_ // G_} heads a group: " + "; ".join(
              f"{r['cluster']} CTAs of {r['head_block']} heads, {r['active_clusters']} clusters "
              f"at once: " + (f"{r['ms']:.4f} ms" if r["ms"] else "not launchable")
              for r in rows) + f"; bwd_cluster picks {pick} on {card}")
    return rows


@contextlib.contextmanager
def moe_drop_fracs():
    """Record the drop_frac of every MoE layer a prefill runs (S > 1), as
    device scalars, by wrapping models.mlp.moe_ffn while the block runs."""
    from repro_torch.models import mlp as mlp_mod

    moe, layers = mlp_mod.moe_ffn, []

    def recording(x, p, cfg, **kw):
        y, aux = moe(x, p, cfg, **kw)
        if x.shape[1] > 1:
            layers.append(aux["drop_frac"])
        return y, aux

    mlp_mod.moe_ffn = recording
    try:
        yield layers
    finally:
        mlp_mod.moe_ffn = moe


def serve_lm(torch, dev, card: str, cfg, tag: str, per_prefill) -> tuple:
    """``cfg`` at full width (random bf16 weights from seed 0) behind
    ServingEngine(batch=4, max_len=1024), answering the 6 greedy requests
    of PROMPT_LENS (an encoder-decoder's each with its own frames from
    embedding_side_inputs); every prefill must launch flash attention and
    the SSD chunk ``per_prefill`` = (flash, ssd) times, decode ticks
    neither. Prints the init's peak memory, each MoE prefill's drop_frac,
    inject and tick times, and where the device time of a warm prefill and
    decode step goes. Returns (flash, SSD) launches of the run, each
    counted from 0."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.tokens import embedding_side_inputs
    from repro_torch.kernels.flash import flash_kernel
    from repro_torch.kernels.ssd import ssd_kernel
    from repro_torch.models import decode_step, init_decode_cache, init_params, prefill
    from repro_torch.models.mlp import _capacity
    from repro_torch.serve import Request, ServeConfig, ServingEngine

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    print(f"[{tag} init] {cfg.name}: {cfg.param_count() / 1e9:.3f}e9 parameters "
          f"({cfg.dtype}, {cfg.n_layers} layers, d_model {cfg.d_model}), "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card (init peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB), "
          f"{time.perf_counter() - t0:.1f} s")
    eng = ServingEngine(cfg, params, ServeConfig(batch=SERVE_BATCH, max_len=SERVE_MAX_LEN),
                        device=dev)
    rs = np.random.RandomState(0)
    frames = [None] * len(PROMPT_LENS)
    if cfg.is_encoder_decoder:
        frames = list(embedding_side_inputs("audio", len(PROMPT_LENS), cfg.d_model, seed=0,
                                            frames=cfg.enc_frames))
    reqs = [Request(prompt=rs.randint(2, cfg.vocab_size, size=n).astype(np.int32),
                    max_new_tokens=NEW_TOKENS, side=f) for n, f in zip(PROMPT_LENS, frames)]
    for r in reqs:
        eng.admit(r)

    def counts():
        return flash_kernel.flash_attention.launches, ssd_kernel.ssd_chunk_kernel.launches

    inject_ms, tick_ms, done = [], [], []
    tick_launches = 0
    drops = []  # each MoE prefill's drop_frac per layer

    def inject(r):
        before = counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with moe_drop_fracs() as layers:
            eng.inject([r])
            torch.cuda.synchronize()
        inject_ms.append((time.perf_counter() - t) * 1e3)
        if cfg.arch_type == "moe":
            drops.append([float(f) for f in layers])
            check(len(layers) == cfg.n_layers, f"{len(layers)} MoE layers in a prefill")
        after = counts()
        check((after[0] - before[0], after[1] - before[1]) == tuple(per_prefill),
              f"{cfg.name}: prefill of {len(r.prompt)} tokens launched flash "
              f"{after[0] - before[0]} and ssd_chunk {after[1] - before[1]} times, "
              f"expected {per_prefill}")

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

    print(f"[{tag} serve] {len(reqs)} requests x {NEW_TOKENS} new tokens, batch "
          f"{SERVE_BATCH}, max_len {SERVE_MAX_LEN}: {run_s:.2f} s wall, {len(tick_ms)} decode "
          f"ticks; prefill {'in power-of-two buckets' if eng._maskable else 'at exact length'}")
    for i, (r, ms) in enumerate(zip(reqs, inject_ms)):
        drop_txt = (f"; drop_frac by layer {[round(f, 4) for f in drops[i]]} (capacity "
                    f"{_capacity(eng._bucket_for(len(r.prompt)), cfg)} a group)"
                    if drops else "")
        print(f"[{tag} serve]   prompt {len(r.prompt):4d} (prefill length "
              f"{eng._bucket_for(len(r.prompt))}): inject (prefill + slot insert) "
              f"{ms:8.2f} ms; {r.finish_reason} after {len(r.output)} tokens: "
              f"{r.output[:8]}...{drop_txt}")
    ticks = np.asarray(tick_ms)
    print(f"[{tag} serve] decode tick (batch {SERVE_BATCH}, host clock): mean "
          f"{ticks.mean():.2f} ms, median {np.median(ticks):.2f} ms, first {ticks[0]:.2f} ms, "
          f"max {ticks.max():.2f} ms; launches flash {launches_flash}, ssd_chunk "
          f"{launches_ssd} (per prefill {per_prefill[0]}, {per_prefill[1]}), during ticks "
          f"{tick_launches}; peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; on {card}")
    check(len(done) == len(reqs) and all(r.done for r in reqs), "a request did not finish")
    for r in reqs:
        check(r.finish_reason in ("eos", "length"), f"finish reason {r.finish_reason}")
        check(1 <= len(r.output) <= NEW_TOKENS, f"{len(r.output)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.output),
              f"token outside [0, {cfg.vocab_size}): {r.output}")
        check(r.finish_reason == "eos" or len(r.output) == NEW_TOKENS, "short by length")
    check(launches_flash == per_prefill[0] * len(reqs),
          f"flash launched {launches_flash} times, expected {per_prefill[0]} x {len(reqs)}")
    check(launches_ssd == per_prefill[1] * len(reqs),
          f"ssd_chunk launched {launches_ssd} times, expected {per_prefill[1]} x {len(reqs)}")
    check(tick_launches == 0, f"decode ticks launched the prefill kernels {tick_launches} times")

    # where the device time of one prefill (the longest prompt) and of one
    # decode step of the full batch goes, warm
    toks = torch.from_numpy(reqs[0].prompt[None]).to(dev)
    side = None if frames[0] is None else torch.from_numpy(frames[0][None]).to(dev)
    cache = init_decode_cache(cfg, SERVE_BATCH, SERVE_MAX_LEN, device=dev)
    cache.position = torch.full((SERVE_BATCH,), 600, dtype=torch.int32, device=dev)
    if cache.cross is not None:  # the served cache's: fp32 frames make fp32 cross k/v
        cache.cross = [(k.float(), v.float()) for k, v in cache.cross]
    step_toks = torch.arange(2, 2 + SERVE_BATCH, device=dev)
    for label, run in (
        (f"prefill of {toks.shape[1]} tokens",
         lambda: prefill(cfg, params, toks, side, extra_len=SERVE_MAX_LEN - toks.shape[1])),
        (f"decode step of batch {SERVE_BATCH}", lambda: decode_step(cfg, params, step_toks, cache)),
    ):
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
        events = device_events(prof)
        if not events:
            print(f"[{tag} profile] {label}: the profiler saw no device time "
                  f"({wall_ms:.1f} ms wall)")
            continue
        busy_ms = sum(e.self_device_time_total for e in events) / 1e3
        print(f"[{tag} profile] warm {label}: {wall_ms:.1f} ms wall (profiler on), device "
              f"busy {busy_ms:.2f} ms = {busy_ms / wall_ms:.1%} of wall, "
              f"{sum(e.count for e in events)} device events")
        for e in sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:8]:
            dms = e.self_device_time_total / 1e3
            print(f"[{tag} profile]   {dms:8.3f} ms {dms / busy_ms:6.1%}  x{e.count:<5d} "
                  f"{e.key[:80]}")
        copy_ev = [e for e in prof.key_averages() if e.key == "aten::copy_"]
        print(f"[{tag} profile]   aten::copy_ calls: {sum(e.count for e in copy_ev)}, device "
              f"{sum(e.device_time_total for e in copy_ev) / 1e3:.3f} ms")
        for name in ("flash_fwd", "ssd_chunk_kernel"):
            dms = sum(e.self_device_time_total for e in events if name in e.key) / 1e3
            print(f"[{tag} profile]   {name}: {dms:.3f} ms = {dms / busy_ms:.1%} of device time")
    del cache
    del eng, params
    torch.cuda.empty_cache()
    return launches_flash, launches_ssd


def consistency(torch, dev, cfg, tag: str, S: int = CONSIST_S, steps: int = 3) -> float:
    """In fp32, prefill of S tokens plus ``steps`` decode steps tracks the
    last logits of prefills over S+1 .. S+steps tokens (the invariant of
    tests/test_serve.py), holding the kernel prefill against the plain
    decode path. An encoder-decoder prefills with the same frames each
    time."""
    import dataclasses

    from repro_torch.data.tokens import embedding_side_inputs
    from repro_torch.models import decode_step, init_params, prefill

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = init_params(cfg32, seed=0, device=dev)
    rs = np.random.RandomState(5)
    toks = torch.from_numpy(rs.randint(2, cfg.vocab_size, size=(1, S + steps))).to(dev)
    side = None
    if cfg.is_encoder_decoder:
        side = torch.from_numpy(embedding_side_inputs("audio", 1, cfg.d_model, seed=5,
                                                      frames=cfg.enc_frames)).to(dev)
    _, cache = prefill(cfg32, params, toks[:, :S], side, extra_len=8)
    errs, scale = [], 0.0
    for t in range(steps):
        out, cache = decode_step(cfg32, params, toks[:, S + t], cache)
        want, _ = prefill(cfg32, params, toks[:, :S + t + 1], side, extra_len=8)
        check(bool(torch.isfinite(out).all()), "decode logits not finite")
        errs.append((out - want).abs().max().item())
        scale = max(scale, want.abs().max().item())
    print(f"[{tag}] fp32 {cfg.name}, prompt {S} + {steps} decode steps (positions {S} .. "
          f"{S + steps - 1}): max|decode - prefill| logits {', '.join(f'{e:.3e}' for e in errs)}"
          f" (max|logit| {scale:.2f}; tolerance {TOL_CONSIST:.0e})")
    check(max(errs) <= TOL_CONSIST, f"{cfg.name}: prefill + decode disagrees with a longer "
          "prefill")
    del params, cache
    torch.cuda.empty_cache()
    return max(errs)


def serve_main_path(torch, dev, card: str):
    """Phase 5: Zamba2-2.7B at full width behind the ServingEngine: the
    shared block's flash attention 9 times and the SSD chunk 54 times a
    prefill. Returns (flash launches, SSD launches, the config)."""
    from repro_torch.configs import get_config

    cfg = get_config("zamba2-2.7b")
    per_prefill = (cfg.n_layers // cfg.hybrid_attn_every, cfg.n_layers)
    return serve_lm(torch, dev, card, cfg, "5", per_prefill) + (cfg,)


def serve_streaming(torch, dev, card: str, cfg) -> dict:
    """Phase 5c: phase 5's engine (``cfg`` at full width, random bf16
    weights from seed 0, batch 4, max_len 1024) behind the streaming
    ContinuousBatchingScheduler: STREAM_LENS requests of NEW_TOKENS tokens,
    two queued at first and one more before every second step, at
    temperature 0.8 (seed 0) twice and at temperature 0. Checks: every
    request completes with its budget, every id in the vocabulary, the two
    sampled runs give the same tokens, and the greedy run's tokens equal
    ``engine.run``'s on the same prompts. Returns the kernels' launches of
    the first run."""
    from repro_torch.models import init_params
    from repro_torch.serve import (
        ContinuousBatchingScheduler, Request, ServeConfig, ServingEngine,
    )

    params = init_params(cfg, seed=0, device=dev)
    rs = np.random.RandomState(7)
    prompts = [rs.randint(2, cfg.vocab_size, size=n).astype(np.int32) for n in STREAM_LENS]
    kernels = lm_kernels()

    def engine(temperature):
        return ServingEngine(cfg, params, ServeConfig(
            batch=SERVE_BATCH, max_len=SERVE_MAX_LEN, temperature=temperature, seed=0,
            eos_id=-1), device=dev)

    def stream(temperature):
        eng = engine(temperature)
        sched = ContinuousBatchingScheduler(eng, policy="fifo")
        reqs = [Request(prompt=p, max_new_tokens=NEW_TOKENS) for p in prompts]
        arriving = list(reqs)
        for r in arriving[:2]:
            sched.submit(r)
        arriving = arriving[2:]
        for k in kernels.values():
            k.launches = 0
        steps, peak = 0, 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while arriving or sched.pending or sched.in_flight:
            if arriving and steps % 2 == 0:
                sched.submit(arriving.pop(0))
            sched.step()
            steps += 1
            peak = max(peak, eng.active)
            check(steps < 20 * NEW_TOKENS * len(reqs), "the streaming scheduler does not finish")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: k.launches for name, k in kernels.items()}
        ttft = np.array([r.ttft_s for r in reqs]) * 1e3
        m = sched.metrics
        print(f"[5c stream T={temperature}] {len(reqs)} requests x {NEW_TOKENS} tokens "
              f"(prompts {list(STREAM_LENS)}), batch {SERVE_BATCH}: {wall:.2f} s wall, "
              f"{steps} scheduler steps, {m.decode_steps} decode ticks, "
              f"{len(reqs) * NEW_TOKENS / wall:.1f} tokens/s, time to first token p50 "
              f"{np.median(ttft):.1f} ms (max {ttft.max():.1f}), peak {peak} of {SERVE_BATCH} "
              f"slots occupied (occupancy {m.slot_occupancy():.2f}); launches "
              + ", ".join(f"{k} {v}" for k, v in launches.items() if v) + f" on {card}")
        for r in reqs:
            check(r.status == "done" and len(r.output) == NEW_TOKENS,
                  f"a streamed request ended {r.status} with {len(r.output)} tokens")
            check(all(0 <= t < cfg.vocab_size for t in r.output),
                  f"a streamed token outside [0, {cfg.vocab_size}): {r.output}")
        return [r.output for r in reqs], launches

    hot, launches = stream(STREAM_TEMPERATURE)
    again, _ = stream(STREAM_TEMPERATURE)
    check(again == hot, "two sampled runs with the same seed gave different tokens")
    greedy, _ = stream(0.0)
    check(greedy != hot, "the sampled tokens are the greedy ones")
    blocking = []
    for i in range(0, len(prompts), SERVE_BATCH):
        reqs = [Request(prompt=p, max_new_tokens=NEW_TOKENS) for p in prompts[i:i + SERVE_BATCH]]
        engine(0.0).run(reqs)
        blocking += [r.output for r in reqs]
    check(greedy == blocking, "the greedy streamed tokens differ from engine.run's")
    print(f"[5c stream] T={STREAM_TEMPERATURE}: a second run gave the same tokens; T=0: the "
          f"streamed tokens equal engine.run's; first request sampled {hot[0][:8]}..., greedy "
          f"{greedy[0][:8]}...")
    del params
    torch.cuda.empty_cache()
    return launches


def bucketed_prefill(torch, dev, cfg, tag: str, tol: float = TOL_CONSIST) -> float:
    """In fp32, a right-padded power-of-two bucket (``true_len``) gives the
    last logits of an exact-length prefill of the same prompt, within
    ``tol``."""
    import dataclasses

    from repro_torch.models import init_params, prefill
    from repro_torch.serve.engine import _next_bucket

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = init_params(cfg32, seed=0, device=dev)
    rs = np.random.RandomState(7)
    errs = []
    for L in BUCKET_LENS:
        S = _next_bucket(L, 16, SERVE_MAX_LEN - 1)
        prompt = torch.from_numpy(rs.randint(2, cfg.vocab_size, size=(1, L))).to(dev)
        padded = torch.zeros((1, S), dtype=prompt.dtype, device=dev)
        padded[:, :L] = prompt
        got, cache = prefill(cfg32, params, padded, extra_len=8, true_len=L)
        want, _ = prefill(cfg32, params, prompt, extra_len=8)
        check(bool(torch.isfinite(got).all()) and int(cache.position) == L,
              f"bucketed prefill of {L} in {S}")
        errs.append((L, S, (got - want).abs().max().item()))
    print(f"[{tag}] fp32 {cfg.name}: bucketed against exact-length prefill, max|logits| "
          "difference " + ", ".join(f"{L} in {S}: {e:.3e}" for L, S, e in errs)
          + f" (tolerance {tol:.0e})")
    check(max(e for _, _, e in errs) <= tol, "bucketed prefill disagrees")
    del params
    torch.cuda.empty_cache()
    return max(e for _, _, e in errs)


def band_tasks(vocab: int, seed: int):
    """examples/train_lm_mtl.py's task recipe: each task prefers a distinct
    token-id band; a label says whether a sequence leans into that band."""
    rng = np.random.RandomState(seed)
    tokens, labels = [], []
    for t in range(BRIDGE_TASKS):
        lo, hi = (t * vocab) // BRIDGE_TASKS, ((t + 1) * vocab) // BRIDGE_TASKS
        toks = np.zeros((BRIDGE_N, BRIDGE_SEQ), np.int32)
        y = np.zeros((BRIDGE_N,), np.float32)
        for i in range(BRIDGE_N):
            pos = rng.rand() < 0.5
            toks[i] = rng.randint(lo, hi, size=BRIDGE_SEQ) if pos else rng.randint(
                0, vocab, size=BRIDGE_SEQ)
            y[i] = 1.0 if pos else -1.0
        tokens.append(toks)
        labels.append(y)
    return tokens, labels


def bridge(torch, dev, card: str) -> dict:
    """Phase 8e: DMTRL heads fitted on gemma3-1b's pooled features (K3 in
    the backbone, K1 in the fit). Returns the launches of the run."""
    from repro_torch.configs import get_config
    from repro_torch.core import DMTRLConfig, dual, fit
    from repro_torch.kernels.flash import flash_kernel
    from repro_torch.kernels.flash import ref as flash_ref
    from repro_torch.kernels.sdca import reset_launch_counts, sdca_round_kernel
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import init_params
    from repro_torch.train import build_mtl_data_from_backbone, fit_mtl_heads

    cfg = get_config("gemma3-1b")
    params = init_params(cfg, seed=0, device=dev)
    train_toks, train_labs = band_tasks(cfg.vocab_size, 0)
    test_toks, test_labs = band_tasks(cfg.vocab_size, 1)
    batches = BRIDGE_TASKS * -(-BRIDGE_N // 32)
    dcfg = DMTRLConfig(solver="pallas_round", **BRIDGE_CFG)

    # the entry point, counted: features through K3, the fit through K1
    reset_launch_counts()
    flash_kernel.flash_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fit_mtl_heads(cfg, params, train_toks, train_labs, dcfg, device=dev)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    k1, k3 = sdca_round_kernel.launches, flash_kernel.flash_attention.launches
    rounds = BRIDGE_CFG["outer_iters"] * BRIDGE_CFG["rounds"]
    gap = res.dmtrl.history["gap"]
    t0 = time.perf_counter()
    test = build_mtl_data_from_backbone(cfg, params, test_toks, test_labs, device=dev)
    torch.cuda.synchronize()
    feat_s = time.perf_counter() - t0
    err = float(dual.error_rate(test, res.dmtrl.W))
    print(f"[8e bridge] fit_mtl_heads on {cfg.name} ({cfg.dtype}, full width and depth): "
          f"{BRIDGE_TASKS} tasks x {BRIDGE_N} x {BRIDGE_SEQ} tokens, phi dim "
          f"{res.features_dim}: {fit_s:.2f} s (features and fit); K3 launches {k3} "
          f"(= {cfg.n_layers} x {batches} batches), sdca_round launches {k1} (= {rounds} "
          f"rounds); gap {gap[0]:.5f} -> {gap[-1]:.5f}; test error {err:.4f} (chance 0.5); "
          f"test features {feat_s:.2f} s on {card}")
    check(k1 == rounds, f"sdca_round launched {k1} times, expected {rounds}")
    check(k3 == cfg.n_layers * batches, f"flash launched {k3} times in the bridge")
    check(bool(np.all(np.isfinite(gap))) and gap[-1] < gap[0], f"gap did not shrink: {gap}")
    check(res.features_dim == cfg.d_model, "phi dim")

    # the same features through K3 and through the plain attention on the card
    data = build_mtl_data_from_backbone(cfg, params, train_toks, train_labs, device=dev)

    def plain_bshd(q, k, v, causal=True, window=0):
        return flash_ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                       causal, window).transpose(1, 2)

    kernel_bshd = attn_mod.flash_attention_bshd
    attn_mod.flash_attention_bshd = plain_bshd
    try:
        plain = build_mtl_data_from_backbone(cfg, params, train_toks, train_labs, device=dev)
    finally:
        attn_mod.flash_attention_bshd = kernel_bshd
    de = (data.x - plain.x).abs().max().item()
    real = data.mask > 0
    cos = torch.nn.functional.cosine_similarity(data.x, plain.x, dim=-1)[real].min().item()
    print(f"[8e features] through K3 against the plain attention on the card: max|dphi| "
          f"{de:.3e} (unit-norm rows, entries up to {plain.x.abs().max().item():.3f}; "
          f"tolerance {TOL_FEATURES:.0e}), min cosine {cos:.6f}")
    check(de <= TOL_FEATURES, "features through K3 disagree with the plain path")

    # K1 against the plain block_gram solver on the same features
    fits = {s: fit(DMTRLConfig(solver=s, **BRIDGE_CFG), data, device=dev)
            for s in ("pallas_round", "block_gram")}
    dW = (fits["pallas_round"].W - fits["block_gram"].W).abs().max().item()
    dS = (fits["pallas_round"].sigma - fits["block_gram"].sigma).abs().max().item()
    dE = (fits["pallas_round"].W - res.dmtrl.W).abs().max().item()
    print(f"[8e fit] pallas_round against block_gram on the same features: max|dW| {dW:.3e} "
          f"(tol {TOL_W:.0e}), max|dSigma| {dS:.3e} (tol {TOL_SIGMA:.0e}); the entry point's W "
          f"against a refit on recomputed features {dE:.3e}; Sigma diag "
          f"{np.round(np.diag(res.dmtrl.sigma.cpu().numpy()), 4).tolist()}")
    check(dW <= TOL_W and dS <= TOL_SIGMA, "pallas_round disagrees with block_gram")
    check(dE <= TOL_W, "the features are not reproducible")
    del params, data, plain, fits, res
    torch.cuda.empty_cache()
    return dict(sdca_round=k1, flash=k3)


def lm_families(torch, dev, card: str) -> dict:
    """Phase 8: the dense and SSM families at full width behind the engine,
    their fp32 checks, and the bridge. Returns launches by path."""
    import dataclasses

    from repro_torch.configs import get_config

    launches = {}
    for sub, name in zip("abcd", LM_FAMILIES):
        tag = f"8{sub} {name}"
        cfg = get_config(name)
        if name in FAMILY_LAYERS:
            full = cfg.n_layers
            cfg = dataclasses.replace(cfg, n_layers=FAMILY_LAYERS[name])
            print(f"[{tag}] depth cut: {cfg.n_layers} of {full} layers, full width (d_model "
                  f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} KV heads, d_ff "
                  f"{cfg.d_ff}, {cfg.act})")
        t0 = time.perf_counter()
        per_prefill = (0, cfg.n_layers) if cfg.arch_type == "ssm" else (cfg.n_layers, 0)
        launches[tag] = serve_lm(torch, dev, card, cfg, tag, per_prefill)
        if name == "gemma3-1b":
            bucketed_prefill(torch, dev, cfg, f"{tag} bucket")
            consistency(torch, dev, cfg, f"{tag} ring", S=RING_S, steps=RING_STEPS)
        if name == "mamba2-780m":
            consistency(torch, dev, cfg, f"{tag} consistency")
        print(f"[{tag}] {time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    launches["8e bridge"] = bridge(torch, dev, card)
    print(f"[8e bridge] {time.perf_counter() - t0:.1f} s wall")
    return launches


def lm_zoo(torch, dev, card: str) -> dict:
    """Phase 9: the MoE, VLM and encoder-decoder families at full width
    behind the engine (depth cut as ZOO_LAYERS says), the MoE's fp32
    checks at lossless capacity and the encoder-decoder's fp32 state.
    Returns launches by path."""
    import dataclasses

    from repro_torch.configs import get_config

    launches = {}
    for sub, name in zip("abcd", ZOO_FAMILIES):
        tag = f"9{sub} {name}"
        cfg = get_config(name)
        if name in ZOO_LAYERS:
            full = cfg.n_layers
            cfg = dataclasses.replace(cfg, n_layers=ZOO_LAYERS[name])
            moe = (f", {cfg.n_experts} experts top-{cfg.top_k} of {cfg.d_ff}"
                   + (f", {cfg.n_shared_experts} shared" if cfg.n_shared_experts else "")
                   + f", capacity factor {cfg.capacity_factor}" if cfg.n_experts else "")
            print(f"[{tag}] depth cut: {cfg.n_layers} of {full} layers, full width (d_model "
                  f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} KV heads of "
                  f"{cfg.head_dim}, d_ff {cfg.d_ff}{moe}{', q/k norms' if cfg.qk_norm else ''})")
        t0 = time.perf_counter()
        # K3 once a layer; the encoder-decoder also once an encoder layer
        # (non-causal over the frames) and once a cross-attention
        per_prefill = cfg.n_layers + (cfg.n_enc_layers + cfg.n_layers
                                      if cfg.is_encoder_decoder else 0)
        launches[tag] = serve_lm(torch, dev, card, cfg, tag, (per_prefill, 0))
        if cfg.arch_type == "moe" and name == ZOO_FAMILIES[0]:
            # lossless capacity (the reduced configs' rule, E / K): no token
            # is dropped, so a bucket and decode steps see what a longer
            # exact-length prefill sees
            lossless = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
            consistency(torch, dev, lossless, f"{tag} consistency")
            bucketed_prefill(torch, dev, lossless, f"{tag} bucket", tol=TOL_BUCKET)
        if cfg.is_encoder_decoder:
            consistency(torch, dev, cfg, f"{tag} consistency")
        print(f"[{tag}] {time.perf_counter() - t0:.1f} s wall")
    return launches


def attention_and_ssm_layers(cfg) -> tuple:
    """(attention calls, Mamba2 layers) of one forward pass of ``cfg``: a
    hybrid's shared block runs once per period, an encoder-decoder attends
    in its encoder, its decoder and across."""
    if cfg.arch_type == "ssm":
        return 0, cfg.n_layers
    if cfg.arch_type == "hybrid":
        return cfg.n_layers // cfg.hybrid_attn_every, cfg.n_layers
    if cfg.is_encoder_decoder:
        return cfg.n_enc_layers + 2 * cfg.n_layers, 0
    return cfg.n_layers, 0


def lm_kernels():
    """The LM kernels' wrappers by name, whose ``launches`` the paths count."""
    from repro_torch.kernels.flash import flash_kernel
    from repro_torch.kernels.ssd import ssd_kernel

    return {"K3": flash_kernel.flash_attention, "K3-bwd": flash_kernel.flash_attention_bwd,
            "K4": ssd_kernel.ssd_chunk_kernel, "K4-bwd": ssd_kernel.ssd_chunk_bwd_kernel}


def train_main_path(torch, dev, card: str, arch: str, tag: str, min_drop: float) -> dict:
    """Phases 10a and 10d: ``arch`` at full width and depth trains
    TRAIN_STEPS steps through ``train.train`` (bf16, remat, random init
    from seed 0) on one repeated batch. Checks finite losses and grad
    norms, a loss that falls by more than ``min_drop`` nat, and per layer
    and step 2 K3 and 1 K3-bwd launches for each attention, 2 K4 and 1
    K4-bwd for each Mamba2 layer. Prints the step's host time, tokens/s,
    peak memory and, from one more profiled step, the device-busy share and
    each kernel's part of it. Returns the launches of the 10 steps and the
    peak memory in GB and the warm step's median host ms."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import SyntheticTokenPipeline, TokenPipelineConfig
    from repro_torch.train import AdamW, TrainLogger, make_train_step, train

    cfg = dataclasses.replace(get_config(arch), remat=True)
    opt = AdamW(lr=1e-3, warmup_steps=2)
    batch = SyntheticTokenPipeline(TokenPipelineConfig(
        cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)).batch(0)
    n_attn, n_ssm = attention_and_ssm_layers(cfg)
    per_step = {"K3": 2 * n_attn, "K3-bwd": n_attn, "K4": 2 * n_ssm, "K4-bwd": n_ssm}

    def repeated():
        while True:
            yield batch

    shape = (f"{cfg.layer_kinds().count('local')} local, window {cfg.window}, head dim "
             f"{cfg.head_dim}" if n_attn else
             f"{cfg.ssm_heads} heads of {cfg.ssm_head_dim}, state {cfg.ssm_state}, chunk "
             f"{cfg.ssm_chunk}")
    print(f"[{tag} {arch} train] {cfg.n_layers} layers ({shape}), d_model {cfg.d_model}, vocab "
          f"{cfg.vocab_size}, {cfg.dtype}, remat {cfg.remat}; batch {TRAIN_BATCH} x {TRAIN_SEQ}, "
          f"AdamW(lr={opt.lr}, warmup_steps={opt.warmup_steps})")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels = lm_kernels()
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    params, state, hist = train(cfg, opt, repeated(), TRAIN_STEPS, seed=0,
                                logger=TrainLogger(every=1), device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = [h["loss"] for h in hist]
    gnorms = [h["grad_norm"] for h in hist]
    step_s = np.diff([h["elapsed_s"] for h in hist])[1:]  # steps 2 .. 9: warm
    step_ms = float(np.median(step_s)) * 1e3
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"[{tag} {arch} train] loss per step "
          f"{np.array2string(np.array(losses), precision=4)}; grad norm "
          f"{np.array2string(np.array(gnorms), precision=3)}")
    print(f"[{tag} {arch} train] {TRAIN_STEPS} steps in {wall:.2f} s (init and the first "
          f"step included); warm step host {step_ms:.1f} ms median ({step_s.min() * 1e3:.1f}-"
          f"{step_s.max() * 1e3:.1f}), {tokens / (step_ms / 1e3):.0f} tokens/s; launches "
          + ", ".join(f"{k} {v}" for k, v in launches.items())
          + f"; peak {peak:.2f} GB on {card}")
    check(all(np.isfinite(losses)) and all(np.isfinite(gnorms)), "non-finite loss or grad norm")
    check(losses[-1] < losses[0] - min_drop,
          f"the loss fell from {losses[0]:.4f} to {losses[-1]:.4f}, not more than {min_drop} nat")
    for name, n in per_step.items():
        check(launches[name] == n * TRAIN_STEPS,
              f"{name} launched {launches[name]} times, expected {n} a step")

    # one more step under the profiler: where its device time goes
    step = make_train_step(cfg, opt)
    tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    step(params, state, tb)  # the step object's first call
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, state, met = step(params, state, tb)
        float(met["loss"])
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    events = device_events(prof)
    busy = sum(e.self_device_time_total for e in events) / 1e3
    check(busy > 0, "the profiled training step recorded no device time")
    parts = []
    for name, key in (("K3", "flash_fwd"), ("K3-bwd", "flash_bwd"), ("K4", "ssd_chunk_kernel"),
                      ("K4-bwd", "ssd_chunk_bwd_kernel"), ("K4-bwd dA", "ssd_bwd_reduce")):
        found = [e for e in events if key in e.key]
        dms = sum(e.self_device_time_total for e in found) / 1e3
        count = sum(e.count for e in found)
        if per_step[name.split()[0]]:
            parts.append(f"{name} {dms:.2f} ms ({dms / busy:.1%}) x{count}")
            check(not name.startswith("K4-bwd") or count == per_step["K4-bwd"],
                  f"the profiled step ran {name} ({key}) {count} times, expected "
                  f"{per_step['K4-bwd']}")
    print(f"[{tag} profile] one step {prof_ms:.1f} ms wall (profiler on), device busy "
          f"{busy:.1f} ms = {busy / prof_ms:.1%}; " + ", ".join(parts) + f" on {card}")
    for e in sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:10]:
        print(f"[{tag} profile]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
              f"{e.key[:90]}")
    del params, state, step, tb
    torch.cuda.empty_cache()
    return launches, peak, step_ms


def gather_cost(torch, dev, mesh, cfg, reps: int = 50) -> dict:
    """What one all_gather of the step costs on ``mesh``: the largest
    column-split layer leaf of ``cfg`` (one layer, bf16) gathered along its
    last dim over ``model``, as each layer body gathers it; the host clock
    over ``reps`` calls ended by a synchronize, and CUDA events over the
    same."""
    from repro_torch.core import distributed as dist_mod
    from repro_torch.models import sharding
    from repro_torch.models.transformer import param_shapes

    shapes = param_shapes(cfg)["layers"]
    specs = sharding.param_pspecs(cfg, shapes, mesh)
    shape = max((tuple(leaf.shape[1:]) for leaf, spec in zip(
        sharding.tree_leaves(shapes), sharding.tree_leaves(specs)) if spec[-1] == "model"),
        key=lambda s: (int(np.prod(s)), s))
    t = torch.randn(shape, device=dev).to(torch.bfloat16)
    for _ in range(5):
        dist_mod.all_gather_dim(t, mesh, "model", -1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        dist_mod.all_gather_dim(t, mesh, "model", -1)
    torch.cuda.synchronize()
    host_us = (time.perf_counter() - t0) / reps * 1e6
    device_us = cuda_ms(torch, lambda: dist_mod.all_gather_dim(t, mesh, "model", -1), reps) * 1e3
    return {"shape": list(shape), "host_us": host_us, "device_us": device_us}


def expected_gathers(cfg, pshard, microbatches: int, zero2: bool, batch_keys: int) -> int:
    """The all_gathers one step of make_sharded_train_step calls on a
    one-position process-group mesh, from its specs: nothing is split over
    model there, so only the batch axes (FSDP) gather. ZeRO-2 gathers each
    such leaf once a step; otherwise every layer body gathers its layer's
    FSDP leaves (twice under remat: forward and recompute), a stacked leaf
    split on its layer dim is gathered whole and each other top-level FSDP
    leaf once, per microbatch. Microbatches re-lay the batch once (one
    gather a batch entry)."""
    from repro_torch.models import sharding

    batch = set(sharding.batch_axes(pshard["embed"].mesh))
    has = lambda spec: bool(set(sharding.spec_axes(spec)) & batch)
    relay = batch_keys if microbatches > 1 else 0
    if zero2:
        return sum(has(s.spec) for s in sharding.tree_leaves(pshard)) + relay
    bodies = 2 if cfg.remat else 1
    per_mb = 0
    for key, tree in pshard.items():
        leaves = sharding.tree_leaves(tree)
        if key in ("layers", "enc_layers", "cross_layers"):
            per_mb += bodies * cfg.n_layers * sum(has(s.spec[1:]) for s in leaves)
            per_mb += sum(has(s.spec[:1]) for s in leaves)
        else:
            per_mb += sum(has(s.spec) for s in leaves)
    return microbatches * per_mb + relay


def sharded_train_path(torch, dev, card: str, arch: str, tag: str, phase10_peak: float) -> dict:
    """Phase 12: ``arch`` at full width and depth (phase 10's config, init
    from seed 0 and batch) through ``train.make_sharded_train_step`` for
    SHARDED_STEPS[arch] steps: (a) on the local mesh from
    ``launch.make_host_mesh(1, 1)`` and (b) on a one-rank NCCL world
    (``make_mesh((1, 1), ("data", "model"))``), each against
    ``make_train_step`` run in the same call from a copy of the same init;
    then on the NCCL world the train-mode (FSDP) step with 2 microbatches,
    and the same with ZeRO-2 (serve specs inside, train specs for the
    gradients), each against ``make_train_step(microbatches=2)``. Checks
    that the metrics of every step and the params after the last are
    bit-equal to the reference's, and per step the K3 / K3-bwd / K4 /
    K4-bwd launches of phase 10 (per microbatch) and, on NCCL, the
    all_gathers the specs give (``expected_gathers``). Prints each run's
    warm step host time, collectives by kind and peak memory beside phase
    10's (``phase10_peak`` GB). Returns each run's launches."""
    import dataclasses
    import json as json_mod

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core import distributed as dist_mod
    from repro_torch.core import make_mesh
    from repro_torch.data.tokens import SyntheticTokenPipeline, TokenPipelineConfig
    from repro_torch.launch import make_host_mesh
    from repro_torch.models import init_params, sharding
    from repro_torch.models.transformer import param_shapes
    from repro_torch.train import AdamW, make_sharded_train_step, make_train_step
    from repro_torch.train.optimizer import tree_leaves, tree_map

    cfg = dataclasses.replace(get_config(arch), remat=True)
    steps = SHARDED_STEPS[arch]
    opt = AdamW(lr=1e-3, warmup_steps=2)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticTokenPipeline(
        TokenPipelineConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)).batch(0).items()}
    init = tree_map(lambda t: t.cpu(), init_params(cfg, 0, dev))  # phase 10's init
    torch.cuda.empty_cache()
    n_attn, n_ssm = attention_and_ssm_layers(cfg)
    per_step = {"K3": 2 * n_attn, "K3-bwd": n_attn, "K4": 2 * n_ssm, "K4-bwd": n_ssm}
    kernels = lm_kernels()
    warm = slice(1, 9) if steps >= 9 else slice(1, steps)  # steps 2-9, or 2 on

    def run(name, mesh=None, microbatches=1, **options):
        """``steps`` steps from a copy of ``init``: the metrics, the host
        time, launches and collectives of each step, the final params and
        the peak memory."""
        params = tree_map(lambda t: t.to(dev, copy=True), init)  # init stays as it is
        if mesh is None:
            step = make_train_step(cfg, opt, microbatches)
        else:
            step, pshard, _, bshard = make_sharded_train_step(
                cfg, opt, mesh, TRAIN_BATCH, TRAIN_SEQ, microbatches=microbatches, **options)
            params = sharding.shard_tree(pshard, params)
        state = opt.init(params)
        b = batch if mesh is None else {k: bshard[k].shard(v) for k, v in batch.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = {"metrics": [], "ms": [], "launches": [], "collectives": []}
        for k in kernels.values():
            k.launches = 0
        for _ in range(steps):
            dist_mod.reset_collective_counts()
            before = {n: k.launches for n, k in kernels.items()}
            t0 = time.perf_counter()
            params, state, m = step(params, state, b)
            m = {k: float(v) for k, v in m.items()}  # waits for the step
            out["ms"].append((time.perf_counter() - t0) * 1e3)
            out["metrics"].append(m)
            out["launches"].append({n: k.launches - before[n] for n, k in kernels.items()})
            out["collectives"].append(dict(dist_mod.COLLECTIVES))
        out["total"] = {n: k.launches for n, k in kernels.items()}
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["params"] = params
        if mesh is not None:
            out["shardings"] = pshard
        del state
        check(all(np.isfinite(list(m.values())).all() for m in out["metrics"]),
              f"[{tag} {name}] non-finite metrics")
        for i, got in enumerate(out["launches"]):
            for kname, n in per_step.items():
                check(got[kname] == n * microbatches, f"[{tag} {name}] step {i}: {kname} "
                      f"launched {got[kname]} times, expected {n * microbatches} (phase 10's "
                      f"a microbatch)")
        return out

    refs = {}
    for m in (1, 2):
        ref = run(f"make_train_step microbatches={m}", microbatches=m)
        # compared on the host, so that the device holds one run at a time
        ref["params"] = [t.cpu() for t in tree_leaves(ref.pop("params"))]
        refs[m] = ref
    runs = {"local": (1, run("local", make_host_mesh(1, 1, device=dev)))}
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device=dev)
        check(mesh.distributed, f"[{tag}] not a process-group mesh: {mesh}")
        # the communicators come up at their first call, before the timed run
        dist_mod.psum(torch.zeros(1, device=dev), mesh, "data")
        dist_mod.psum(torch.zeros(1, device=dev), mesh, "model")
        dist_mod.all_gather(torch.zeros(1, device=dev), mesh, "model")
        dist_mod.psum_scatter(torch.zeros(1, device=dev), mesh, "data", 0)
        torch.cuda.synchronize()
        shapes = param_shapes(cfg)
        zero2 = dict(inner_param_specs=sharding.param_pspecs(cfg, shapes, mesh, "serve"),
                     grad_specs=sharding.param_pspecs(cfg, shapes, mesh, "train"))
        runs["nccl"] = (1, run("nccl", mesh))
        runs["nccl train m2"] = (2, run("nccl train m2", mesh, 2, mode="train"))
        runs["nccl zero2 m2"] = (2, run("nccl zero2 m2", mesh, 2, mode="train", **zero2))
        gather_us = gather_cost(torch, dev, mesh, cfg)
    finally:
        dist.destroy_process_group()

    line = {"phase": tag, "arch": arch, "steps": steps, "card": card,
            "phase10_peak_gb": phase10_peak}
    for m, ref in refs.items():
        line[f"make_train_step m{m}"] = {"warm_ms_median": float(np.median(ref["ms"][warm])),
                                         "peak_gb": ref["peak_gb"]}
    line["nccl_all_gather_us"] = gather_us
    for name, (m, r) in runs.items():
        ref = refs[m]
        leaves = [t.cpu() for t in tree_leaves(r.pop("params"))]
        pshard = r.pop("shardings")
        if name != "local":
            want = expected_gathers(cfg, pshard, m, "zero2" in name, len(batch))
            got = r["collectives"][0].get("all_gather", 0)
            check(got == want, f"[{tag} {name}] {got} all_gathers a step, the specs give {want}")
        same_metrics = r["metrics"] == ref["metrics"]
        bit_equal = all(torch.equal(a, b) for a, b in zip(leaves, ref["params"]))
        # the difference in fp32 costs seconds on the host: only when there is one
        max_dp = 0.0 if bit_equal else max(float((a.float() - b.float()).abs().max())
                                           for a, b in zip(leaves, ref["params"]))
        check(same_metrics, f"[{tag} {name}] metrics differ from make_train_step(microbatches="
              f"{m})'s: {r['metrics']} vs {ref['metrics']}")
        check(bit_equal, f"[{tag} {name}] params differ from make_train_step(microbatches={m})'s "
              f"by up to {max_dp:.3e}")
        coll = r["collectives"]
        check(all(c == coll[0] for c in coll), f"[{tag} {name}] collectives vary by step: {coll}")
        line[name] = {"microbatches": m, "warm_ms_median": float(np.median(r["ms"][warm])),
                      "warm_ms_range": [float(min(r["ms"][warm])), float(max(r["ms"][warm]))],
                      "metrics_equal": same_metrics, "params_bit_equal": bit_equal,
                      "max_abs_param_diff": max_dp, "launches_per_step": r["launches"][0],
                      "collectives_per_step": coll[0], "peak_gb": r["peak_gb"],
                      "loss": [mm["loss"] for mm in r["metrics"]]}
        del leaves
    print(f"[{tag} {arch} sharded] " + json_mod.dumps(line))
    print(f"[{tag} {arch} sharded] warm step host ms median (peak GB): make_train_step "
          + ", ".join(f"m{m} {line[f'make_train_step m{m}']['warm_ms_median']:.1f} "
                      f"({line[f'make_train_step m{m}']['peak_gb']:.2f})" for m in refs)
          + "; " + ", ".join(f"{name} {line[name]['warm_ms_median']:.1f} "
                             f"({line[name]['peak_gb']:.2f})" for name in runs)
          + f"; phase 10 peak {phase10_peak:.2f} GB; NCCL collectives a step "
          + "; ".join(f"{name} {line[name]['collectives_per_step']}" for name in runs
                      if name != "local")
          + f"; one all_gather of a {gather_us['shape']} bf16 layer leaf "
          f"{gather_us['host_us']:.1f} us host, {gather_us['device_us']:.1f} us device; "
          "bit-equal " + ", ".join(f"{name} {line[name]['params_bit_equal']}" for name in runs)
          + f" on {card}")
    del refs
    torch.cuda.empty_cache()
    return {f"{tag} {arch} sharded {name}": r["total"] for name, (_, r) in runs.items()}


def train_card_against_cpu(torch, dev, card: str) -> dict:
    """Phase 10b: one gradient and one AdamW step of each config on the card
    and on the CPU in fp32, from the same params and batch: the loss, every
    gradient leaf and the updated params. Returns the card's launches."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import (
        SyntheticTokenPipeline, TokenPipelineConfig, embedding_side_inputs,
    )
    from repro_torch.models import init_params, loss_fn
    from repro_torch.train import AdamW
    from repro_torch.train.optimizer import tree_leaves, tree_map

    configs = (
        ("gemma3-1b 6 layers", dataclasses.replace(get_config("gemma3-1b").reduced(),
                                                   n_layers=6)),
        ("whisper-tiny", dataclasses.replace(get_config("whisper-tiny"), dtype="float32")),
        ("qwen3-moe-30b-a3b reduced", get_config("qwen3-moe-30b-a3b").reduced()),
        # chunks of 64 over the 64 tokens: the last head (A = -16, dt0 = 0.1)
        # decays past exp's range within the chunk (RC5)
        ("mamba2-780m reduced, chunk 64", dataclasses.replace(
            get_config("mamba2-780m").reduced(), ssm_chunk=64)),
        ("zamba2-2.7b reduced", get_config("zamba2-2.7b").reduced()),
    )
    kernels = lm_kernels()
    launches = {}
    for label, cfg in configs:
        tag = f"10b {label}"
        params = init_params(cfg, seed=0, device="cpu")
        b = SyntheticTokenPipeline(TokenPipelineConfig(
            cfg.vocab_size, CHECK_SEQ, CHECK_BATCH, seed=1)).batch(0)
        if cfg.is_encoder_decoder:
            b["frames"] = embedding_side_inputs("audio", CHECK_BATCH, cfg.d_model, 1,
                                                cfg.enc_frames)
        out = {}
        for where in ("cpu", dev):
            # a copy on either side: the update below works in place
            live = tree_map(lambda t: t.detach().to(where, copy=True).requires_grad_(True),
                            params)
            for k in kernels.values():
                k.launches = 0
            t0 = time.perf_counter()
            loss, parts = loss_fn(cfg, live, {k: torch.from_numpy(v).to(where)
                                              for k, v in b.items()})
            loss.backward()
            grads = tree_map(lambda t: t.grad, live)
            opt = AdamW(lr=CHECK_LR, warmup_steps=1)
            new, _, met = opt.update(grads, opt.init(live), tree_map(lambda t: t.detach(), live))
            float(met["grad_norm"])
            secs = time.perf_counter() - t0
            counts = {name: k.launches for name, k in kernels.items()}
            out[str(where)] = (loss.item(), [g.cpu() for g in tree_leaves(grads)],
                               [p.cpu() for p in tree_leaves(new)], float(met["grad_norm"]),
                               secs, counts)
        cpu, gpu = out["cpu"], out[str(dev)]
        d_loss = abs(cpu[0] - gpu[0])
        d_grad = max((a - b_).abs().max().item() for a, b_ in zip(cpu[1], gpu[1]))
        g_max = max(a.abs().max().item() for a in cpu[1])
        d_par = max((a - b_).abs().max().item() for a, b_ in zip(cpu[2], gpu[2]))
        finite = all(bool(torch.isfinite(g).all()) for side in (cpu, gpu) for g in side[1])
        launches[tag] = gpu[5]
        print(f"[{tag}] loss card {gpu[0]:.6f} cpu {cpu[0]:.6f} (|d| {d_loss:.2e}, tolerance "
              f"{TOL_TRAIN_LOSS:.0e}); max|d grad| {d_grad:.2e} over {len(cpu[1])} leaves (max|grad| "
              f"{g_max:.3f}; tolerance {TOL_TRAIN_GRAD:.0e}); max|d param| after one step "
              f"{d_par:.2e} (tolerance {TOL_TRAIN_PARAM:.0e}); grad norm {gpu[3]:.4f}; "
              f"card {gpu[4]:.2f} s, cpu {cpu[4]:.2f} s; every gradient finite on both: "
              f"{finite}; launches " + ", ".join(f"{k} {v}" for k, v in gpu[5].items())
              + f" on {card}")
        check(finite, f"{tag}: a gradient is not finite")
        check(np.isfinite(gpu[0]) and d_loss <= TOL_TRAIN_LOSS, f"{tag}: loss disagrees")
        check(d_grad <= TOL_TRAIN_GRAD, f"{tag}: gradients disagree ({d_grad:.3e})")
        check(d_par <= TOL_TRAIN_PARAM, f"{tag}: updated params disagree ({d_par:.3e})")
        n_attn, n_ssm = attention_and_ssm_layers(cfg)
        fwd = 2 if cfg.remat else 1
        want = {"K3": fwd * n_attn, "K3-bwd": n_attn, "K4": fwd * n_ssm, "K4-bwd": n_ssm}
        check(gpu[5] == want, f"{tag}: launched {gpu[5]}, expected {want}")
        check(not any(cpu[5].values()), f"{tag}: the CPU run launched a kernel")
    torch.cuda.empty_cache()
    return launches


def train_launcher(torch, dev, card: str) -> dict:
    """Phase 10c: ``python -m repro_torch.launch.train --arch whisper-tiny
    --steps 3`` with a checkpoint after step 3, run in this process; the
    checkpoint reloads bit for bit. Returns the launches."""
    import shutil

    from repro_torch.launch import train as launcher
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import tree_leaves, tree_map

    ck = ROOT / "build" / "phase10_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    kernels = lm_kernels()
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    argv = ["--arch", "whisper-tiny", "--steps", "3", "--batch", "2", "--seq", "64",
            "--log-every", "1", "--ckpt-dir", str(ck), "--ckpt-every", "3",
            "--history-out", str(ck / "history.json")]
    params, _, hist = launcher.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    back = ckpt.load(str(ck / "step_3"), tree_map(torch.zeros_like, params))
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(back), tree_leaves(params)))
    saved = json.loads((ck / "history.json").read_text())
    print(f"[10c launcher] python -m repro_torch.launch.train {' '.join(argv)}: losses "
          f"{[round(h['loss'], 4) for h in hist]}, {secs:.2f} s; checkpoint step "
          f"{ckpt.latest_step(str(ck / 'step_3'))} reloads bit for bit: {same}; K3 "
          f"{launches['K3']}, K3-bwd {launches['K3-bwd']} on {card}")
    check(same, "the launcher's checkpoint did not reload bit for bit")
    check(len(saved) == 3 and all(np.isfinite(h["loss"]) for h in saved),
          "the launcher's history is not 3 finite steps")
    shutil.rmtree(ck, ignore_errors=True)
    return launches


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


# the round's draw at the benchmark cells' shapes: (tasks, H) of mnist.fit
# (one local epoch of 12 000 rows at B = 64) and synthetic1.fit
DRAW_SHAPES = {"MNIST": (10, 12032), "Synthetic-1": (16, 2048)}


def threefry_draw_checks(torch, dev, card: str) -> dict:
    """Phase 2 for the round's draw kernel: at each shape of DRAW_SHAPES its
    uniforms bit-equal to the CPU path (prng's torch ops), its device time
    beside its bound (the output's bytes), and the host time a call takes,
    the kernel's against the same torch ops on the card (the path it
    replaced)."""
    from repro_torch import prng
    from repro_torch.core.solver_backends import draw_task_uniform
    from repro_torch.kernels.prng import threefry_draw

    key = prng.split(prng.PRNGKey(3), 10)[3]
    out = {}
    for tag, (m, H) in DRAW_SHAPES.items():
        tids = torch.arange(m, dtype=torch.int32)
        tids_dev = tids.to(dev)

        def kernel():
            return threefry_draw(key, tids_dev, 0, H)

        def torch_ops():
            return prng.uniform(prng.fold_in(prng.fold_in(key, tids), 0), (H,), device=dev)

        got = kernel()
        torch.cuda.synchronize()
        want = draw_task_uniform(key, tids, 0, H, "cpu")
        check(bool(torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))),
              f"threefry_draw {tag}: not bit-equal to the CPU path")
        check(bool(torch.equal(torch_ops().cpu().view(torch.int32), want.view(torch.int32))),
              f"threefry_draw {tag}: prng's torch ops on the card disagree")

        def host_ms(fn, reps=200):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            host = (time.perf_counter() - t0) / reps * 1e3
            torch.cuda.synchronize()
            return host

        ms = cuda_ms(torch, kernel, reps=200)
        plain = cuda_ms(torch, torch_ops, reps=20)
        bound, by = bound_ms(m * H * 4 + m * 4, 0.0)
        h_kernel, h_plain = host_ms(kernel), host_ms(torch_ops)
        print(f"[2 threefry_draw {tag}] {m} x {H}: bit-equal to the CPU path; "
              f"{ms:.4f} ms/call on the device (torch ops {plain:.4f}), bound {bound:.5f} ms "
              f"by {by}; host {h_kernel:.4f} ms a call (torch ops {h_plain:.4f}) on {card}")
        out[tag] = dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                        host_ms=h_kernel, plain_host_ms=h_plain)
    return out


def round_at_many_tasks(torch, dev, card: str, data, sm_clock: str):
    """Phase 2, the round kernel at the structured path's shape (phase 6c:
    4096 tasks, d = 100, about 100 rows a task): against its plain version
    for each loss, timed beside its bound and chain floor. Returns the
    largest error and stage 1's time beside its own bound."""
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
    srt = coords_from_uniform(u, n, n_max).sort(dim=1).values
    uniq = int((srt[:, 1:] != srt[:, :-1]).sum().item()) + m
    nbytes = (uniq * d * 4 + uniq * 8) + (m * d * 4 + m * H * 4 + m * 8) \
        + (m * n_max * 4 + m * d * 4)
    flops = 2.0 * m * (H // BLOCK) * (GRAM_TRI + 3 * BLOCK) * d
    b, by = bound_ms(nbytes, flops)
    floor = [H * cyc / (float(sm_clock) * 1e6) * 1e3 for cyc in (60, 100)]
    print(f"[2 sdca_round {m} tasks] x {tuple(x.shape)}, H = {H}: {ms:.4f} ms/call (plain "
          f"{plain:.1f} ms), bound {b:.4f} ms by {by} ({uniq} distinct rows, "
          f"{flops / 1e9:.2f} GFLOP); chain floor {floor[0]:.4f}-{floor[1]:.4f} ms on {card}")
    s1 = dict(ms=stage_ms[0], **stage1_bound(m, H, d))
    print(f"[2 sdca_round {m} tasks] stage 1 (Gram, q) {stage_ms[0]:.4f} ms, bound "
          f"{s1['bound_ms']:.4f} ms by {s1['bound_by']}; stage 2 (chains, "
          f"cluster {sdca_kernel.round_cluster(m, d, BLOCK, sms)}) {stage_ms[1]:.4f} ms; round "
          f"by cluster size: " + ", ".join(f"C={c} {t:.4f} ms" for c, t in cluster_ms.items()))
    return err, s1


def round_at_mds_width(torch, dev, card: str, sm_clock: str) -> dict:
    """Phase 2, K1 at the MDS width (22 x 14 525 x 10 000, B = 64, one local
    epoch of H = 14 528): the streamed round (``chain_stream_kernel`` alone)
    against the plain version (hinge), its device and host time a call, and
    each plan of ``MDS_STREAM_PLANS`` against the default's output and
    timed, beside the parent's two stages, the bound and the time of one
    and of two reads of the drawn rows. No stage 1 may launch."""
    from repro_torch.kernels.sdca import ref, sdca_kernel, sdca_round_kernel

    m, n_max, d = MDS_M, MDS_N_MAX, MDS_D
    H = n_max + (-n_max) % BLOCK
    g = torch.Generator(device=dev).manual_seed(34)
    x = torch.randn((m, n_max, d), device=dev, generator=g)
    x /= x.norm(dim=2, keepdim=True)
    y = torch.where(torch.rand((m, n_max), device=dev, generator=g) < 0.5, -1.0, 1.0)
    alpha = 0.5 * torch.rand((m, n_max), device=dev, generator=g) * y
    w = 0.01 * torch.randn((m, d), device=dev, generator=g)
    u = torch.rand((m, H), device=dev, generator=g)
    n = torch.from_numpy(np.geomspace(219, n_max, m).astype(np.int32)).to(dev)
    kappa = 1.0 / (m * 1e-4 * n.float())
    args = (x, y, alpha, w, u, n, kappa)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = sdca_kernel.round_plan(m, d, BLOCK, sms)
    check(plan.path == "stream", f"K1 at the MDS width plans {plan}")

    def counts():
        k = sdca_round_kernel
        return k.launches, k.stream_launches, k.gram_launches

    before = counts()
    da_k, r_k = sdca_round_kernel(*args, "hinge", block=BLOCK)
    torch.cuda.synchronize()
    check(counts() == (before[0] + 1, before[1] + 1, before[2]),
          f"the MDS round did not stream in one kernel: K1 counters {before} -> {counts()}")
    da_p, r_p = ref.sdca_round_ref(*args, "hinge")
    err = max((da_k - da_p).abs().max().item(), (r_k - r_p).abs().max().item())
    check(bool(torch.isfinite(da_k).all() and torch.isfinite(r_k).all()),
          "sdca_round at the MDS width: non-finite output")
    print(f"[2 sdca_round MDS width hinge] max|dalpha, r - plain| = {err:.3e} "
          f"(tolerance {TOL_ROUND:.0e}; max|r| {r_p.abs().max().item():.3f})")
    check(err <= TOL_ROUND, "sdca_round at the MDS width disagrees with its plain version")
    del da_p, r_p
    before = counts()
    ms = cuda_ms(torch, lambda: sdca_round_kernel(*args, "hinge", block=BLOCK), reps=10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        sdca_round_kernel(*args, "hinge", block=BLOCK)
    host = (time.perf_counter() - t0) / 10 * 1e3
    torch.cuda.synchronize()
    check(counts()[2] == before[2], "stage 1 launched at the MDS width")
    sweep = {}
    for c, wp in MDS_STREAM_PLANS:
        da_s, r_s = torch.zeros_like(alpha), torch.zeros_like(w)

        def fused(c=c, wp=wp, da_s=da_s, r_s=r_s):
            sdca_kernel.sdca_round_stage(2, *args, "hinge", None, da_s, r_s, block=BLOCK,
                                         cluster=c, warps=wp)
        fused()
        torch.cuda.synchronize()
        e = max((da_s - da_k).abs().max().item(), (r_s - r_k).abs().max().item())
        check(e <= TOL_ROUND, f"the streamed round at C={c}, {wp} warps: {e:.3e} off the default")
        sweep[f"C={c} warps={wp}"] = cuda_ms(torch, fused, reps=5)
    del da_k, r_k, da_s, r_s
    # each drawn row (with its alpha and y) read once as if all were distinct,
    # w, u, n, kappa read and dalpha, r written once; per block the Gram
    # triangle and q, xr and r
    nbytes = m * H * (d * 4 + 8) + (m * d * 4 + m * H * 4 + m * 8) + (m * n_max * 4 + m * d * 4)
    flops = 2.0 * m * (H // BLOCK) * (GRAM_TRI + 3 * BLOCK) * d
    b, by = bound_ms(nbytes, flops)
    reads = [k * m * H * d * 4 / PEAK_BYTES_PER_S * 1e3 for k in (1, 2)]
    floor = [H * cyc / (float(sm_clock) * 1e6) * 1e3 for cyc in (60, 100)]
    print(f"[2 sdca_round MDS width] x {tuple(x.shape)}, H = {H}, {plan}: {ms:.4f} ms/call on "
          f"the device, {host:.4f} ms/call on the host; bound {b:.4f} ms by {by} "
          f"({flops / 1e9:.1f} GFLOP, {nbytes / 1e9:.2f} GB); chain floor {floor[0]:.3f}-"
          f"{floor[1]:.3f} ms on {card}")
    print(f"[2 sdca_round MDS width] by plan: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in sweep.items()) + f"; the drawn rows read once "
          f"{reads[0]:.3f} ms, twice {reads[1]:.3f} ms; the two-kernel round's stage 1 + stage 2: "
          + ", ".join(f"{a:.2f} + {s2:.2f} = {a + s2:.2f} ms ({k})"
                      for k, (a, s2) in MDS_PARENT_STAGES_MS.items())
          + f"; stage 1 launches {counts()[2] - before[2]}")
    return dict(ms=ms, host_ms=host, bound_ms=b, bound_by=by, max_abs_err=err,
                reads_ms=reads, plan=dict(path=plan.path, cluster=plan.cluster,
                                          warps=plan.warps), by_plan=sweep)


def stream_at_cell_widths(torch, dev, card: str) -> dict:
    """Phase 2, K1's stage 2 at the widths where the chain path runs
    (``mnist.fit``: 10 x 12 000 x 784; ``synthetic1.fit``: 16 x 1 894 x 100;
    B = 64, one local epoch): ``chain_kernel`` at its cluster against
    the streamed round (``chain_stream_kernel``, the whole round with its
    own Gram) at that many CTAs a task and at the rule's. Each streamed round
    is checked against the chain's output. Stage 1 is timed there too,
    beside its own bound."""
    from repro_torch.kernels.sdca import sdca_kernel

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    for label, (m, n_max, d) in (("mnist.fit", (M, N_MAX, D)),
                                 ("synthetic1.fit", (16, 1894, 100))):
        H = n_max + (-n_max) % BLOCK
        g = torch.Generator(device=dev).manual_seed(d)
        x = torch.randn((m, n_max, d), device=dev, generator=g)
        x /= x.norm(dim=2, keepdim=True)
        y = torch.where(torch.rand((m, n_max), device=dev, generator=g) < 0.5, -1.0, 1.0)
        alpha = 0.5 * torch.rand((m, n_max), device=dev, generator=g) * y
        w = 0.01 * torch.randn((m, d), device=dev, generator=g)
        u = torch.rand((m, H), device=dev, generator=g)
        n = torch.full((m,), n_max, dtype=torch.int32, device=dev)
        kappa = 1.0 / (m * 1e-4 * n.float())
        args = (x, y, alpha, w, u, n, kappa)
        chain = sdca_kernel.round_plan(m, d, BLOCK, sms)
        check(chain.path == "chain", f"K1 at {label}'s width plans {chain}")
        scratch = torch.empty(m * (H // BLOCK) * (BLOCK * BLOCK + 4 * BLOCK), device=dev)
        da_1, r_1 = torch.zeros_like(alpha), torch.zeros_like(w)  # stage 1 leaves them be
        s1 = dict(ms=cuda_ms(torch, lambda: sdca_kernel.sdca_round_stage(
            1, *args, "hinge", scratch, da_1, r_1, block=BLOCK), reps=50), **stage1_bound(m, H, d))

        def stage2(**plan):
            da, r = torch.zeros_like(alpha), torch.zeros_like(w)
            sdca_kernel.sdca_round_stage(2, *args, "hinge", scratch, da, r, block=BLOCK, **plan)
            return da, r

        plans = {f"chain C={chain.cluster}": dict(cluster=chain.cluster)}
        for c in sorted({chain.cluster, sdca_kernel.stream_ctas(m, d, BLOCK, sms)}):
            plans[f"stream C={c}"] = dict(cluster=c, warps=sdca_kernel.STREAM_WARPS)
        da_c, r_c = stage2(**plans[f"chain C={chain.cluster}"])
        times = {}
        for name, plan in plans.items():
            da_s, r_s = stage2(**plan)
            torch.cuda.synchronize()
            e = max((da_s - da_c).abs().max().item(), (r_s - r_c).abs().max().item())
            check(e <= TOL_ROUND, f"stage 2 {name} at {label}'s width: {e:.3e} off the chain's")
            times[name] = cuda_ms(torch, lambda plan=plan: stage2(**plan), reps=10)
        print(f"[2 sdca_round stage 2 at {label}'s width] x {tuple(x.shape)}, H = {H}: "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items()) + f"; stage 1 "
              f"{s1['ms']:.4f} ms, bound {s1['bound_ms']:.5f} ms by {s1['bound_by']} on {card}")
        out[label] = dict(times, stage1=s1)
        del x, scratch
    return out


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
    return est


def empty_task_checks(torch, dev, data) -> tuple:
    """Phase 2, K1 and K2 on the tasks the mesh engines feed them: the
    second of 2 pod slices of Synthetic-1 (real tasks with 0 < n_i < n_loc
    or n_i = 0 there) with two more tasks emptied (padded tasks), each
    task a view between NaN sentinels. Every row a task's plain version
    does not read (at and past n_i, but for the last row of an empty task,
    which -1 wraps to) is NaN too, so a read outside shows as a non-finite
    output and a write into another task's entry as a mismatch. Returns
    the largest error of each kernel."""
    from repro_torch import prng
    from repro_torch.core.losses import get_loss
    from repro_torch.core.sdca import kappa_of
    from repro_torch.core.solver_backends import get_backend
    from repro_torch.kernels.sdca import ops, ref, sdca_block_kernel

    m, n_max, d = data.x.shape
    n_loc = (n_max + 1) // 2
    n_local = torch.clamp(data.n.to(torch.int64) - n_loc, 0, n_loc).to(torch.int32)
    n_local[[0, 3]] = 0
    rs = np.random.RandomState(7)
    px = torch.zeros((m, n_loc, d))
    px[:, : n_max - n_loc] = data.x[:, n_loc:].cpu()
    py = torch.zeros((m, n_loc))
    py[:, : n_max - n_loc] = data.y[:, n_loc:].cpu()
    pa = torch.from_numpy(0.5 * rs.rand(m, n_loc).astype(np.float32)) * py
    bufs = [torch.full((m + 2, n_loc) + a.shape[2:], float("nan")) for a in (px, py, pa)]
    for t in range(m):
        nt = int(n_local[t])
        rows = slice(n_loc - 1, n_loc) if nt == 0 else slice(0, nt)
        for buf, a in zip(bufs, (px, py, pa)):
            buf[t + 1, rows] = a[t, rows]
    bufs = [b.to(dev) for b in bufs]
    x, y, alpha = (b[1:-1] for b in bufs)
    n_local = n_local.to(dev)
    H = n_loc + (-n_loc) % BLOCK
    keys = prng.fold_in(prng.fold_in(prng.PRNGKey(2), torch.arange(m)), 1)
    u = prng.uniform(keys, (H,), device=dev)
    w = torch.from_numpy(0.05 * np.random.RandomState(5).randn(m, d).astype(np.float32)).to(dev)
    sig = torch.full((m,), 1.0 / m, device=dev)
    kappa = kappa_of(1.0, SYN_LAM, n_local, sig)
    err = err_b = 0.0
    for loss in LOSSES:
        da, r = ops.sdca_round(x, y, alpha, w, u, n_local, kappa, loss, block=BLOCK)
        torch.cuda.synchronize()
        da_p, r_p = ref.sdca_round_ref(x, y, alpha, w, u, n_local, kappa, loss)
        finite = bool(torch.isfinite(da).all() and torch.isfinite(r).all())
        e = max((da - da_p).abs().max().item(), (r - r_p).abs().max().item())
        solve = get_backend("pallas_block").make_from_uniform(get_loss(loss), 1.0, SYN_LAM, H,
                                                              block=BLOCK)
        before = sdca_block_kernel.launches
        db, rb = solve(x, y, alpha, w, n_local, sig, u)
        torch.cuda.synchronize()
        launched = sdca_block_kernel.launches - before
        cpu = [t.cpu() for t in (x, y, alpha, w, n_local, sig, u)]
        db_p, rb_p = solve(*cpu)
        finite_b = bool(torch.isfinite(db).all() and torch.isfinite(rb).all())
        eb = max((db.cpu() - db_p).abs().max().item(), (rb.cpu() - rb_p).abs().max().item())
        print(f"[2 empty tasks {loss}] pod slice of Synthetic-1 (m={m}, n_loc={n_loc}, d={d}), "
              f"n_i = {n_local.tolist()}: sdca_round max|dalpha, r - plain| = {e:.3e} "
              f"(tolerance {TOL_ROUND:.0e}), finite {finite}; gather + sdca_block + scatter "
              f"({launched} launches) against the CPU: {eb:.3e} (tolerance {TOL_BLOCK:.0e}), "
              f"finite {finite_b}")
        check(finite and finite_b, f"empty tasks {loss}: a kernel read outside its task")
        check(e <= TOL_ROUND, f"empty tasks {loss}: sdca_round disagrees with its plain version")
        check(eb <= TOL_BLOCK, f"empty tasks {loss}: the pallas_block solve disagrees")
        check(launched == H // BLOCK, f"sdca_block launched {launched} times")
        err, err_b = max(err, e), max(err_b, eb)
    return err, err_b


def mesh_engines_path(torch, dev, card: str, train, syn, ref3, ref4, many, ref6c) -> dict:
    """Phase 11: the paper's mesh engines on the card (core/distributed.py).
    (a) engine="distributed" on the local one-device mesh, phase 3's fit;
    (b) the same over a one-rank NCCL world (every collective through
    NCCL, counted); (c) pallas_block on Synthetic-1, phase 4's fit; (d)
    engine="async" with the default simulated transport: tau = 0 against
    (a), tau = 2 with worker delays (2,), the g1_tau2_omega1 golden history
    replayed; (e) low_rank_diag at 4096 tasks on (b)'s world with the
    factored reduce, against phase 6c's fit. Returns the K1/K2 launches of
    each path."""
    import torch.distributed as dist

    from repro_torch.core import AsyncOptions, DMTRLConfig, DMTRLEstimator, fit_async, make_mesh
    from repro_torch.core import distributed as dist_mod
    from repro_torch.kernels.sdca import reset_launch_counts, sdca_block_kernel, sdca_round_kernel

    launches = {}

    def fit(tag, data, expect_round, expect_block, **kw):
        reset_launch_counts()
        dist_mod.reset_collective_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        est = DMTRLEstimator(device=dev, **kw).fit(data)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = (sdca_round_kernel.launches, sdca_block_kernel.launches)
        launches[tag] = {"sdca_round": got[0], "sdca_block": got[1]}
        check(got == (expect_round, expect_block),
              f"[{tag}] launches (sdca_round, sdca_block) {got}, expected "
              f"{(expect_round, expect_block)}")
        gap = est.history["gap"]
        check(bool(np.all(np.isfinite(gap))) and gap[-1] < gap[0],
              f"[{tag}] gap did not shrink: {gap[0]} -> {gap[-1]}")
        return est, secs, gap, dict(dist_mod.COLLECTIVES)

    def against(tag, est, ref, tol_w=TOL_W, tol_s=TOL_SIGMA):
        dW = (est.W_ - ref.W_).abs().max().item()
        dS = (est.sigma_ - ref.sigma_).abs().max().item()
        check(dW <= tol_w and dS <= tol_s,
              f"[{tag}] max|dW| {dW:.3e} (tol {tol_w:.0e}), max|dSigma| {dS:.3e} "
              f"(tol {tol_s:.0e})")
        return dW, dS

    cfg3 = dict(solver="pallas_round", loss="hinge", lam=1e-4, outer_iters=2, rounds=5,
                local_iters=0, block_size=BLOCK)
    n3 = cfg3["outer_iters"] * cfg3["rounds"]
    # phase 3's fit again, warm, beside the mesh engine in the same call
    _, r_s, _, _ = fit("11a reference", train, n3, 0, **cfg3)
    a, a_s, a_gap, _ = fit("11a distributed", train, n3, 0, engine="distributed", **cfg3)
    dW, dS = against("11a", a, ref3)
    print(f"[11a distributed] local one-device mesh, x {tuple(train.x.shape)}: {a_s:.2f} s for "
          f"{n3} rounds = {a_s / n3 * 1e3:.2f} ms/round wall (objectives and Omega-steps "
          f"included; the reference engine warm {r_s / n3 * 1e3:.2f}); against phase 3's fit "
          f"max|dW| {dW:.3e} (tol {TOL_W:.0e}), max|dSigma| {dS:.3e} (tol {TOL_SIGMA:.0e}); "
          f"gap {a_gap[0]:.5f} -> {a_gap[-1]:.5f}; sdca_round launches "
          f"{launches['11a distributed']['sdca_round']} (1 a round) on {card}")

    t0 = time.perf_counter()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_mesh((1,), ("data",), device=dev)
        # the communicators come up at their first call: one of each kind
        # on every group, before the timed fits
        dist_mod.psum(torch.zeros(1, device=dev), mesh, "data")
        dist_mod.all_gather(torch.zeros(1, device=dev), mesh, "data")
        dist_mod.broadcast(torch.zeros(1, device=dev), mesh)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        check(mesh.distributed, f"not a process-group mesh: {mesh}")
        b, b_s, b_gap, coll = fit("11b nccl", train, n3, 0, engine="distributed", mesh=mesh,
                                  **cfg3)
        dW, dS = against("11b", b, ref3)
        same = bool(torch.equal(b.W_, a.W_) and torch.equal(b.sigma_, a.sigma_))
        print(f"[11b nccl] one-rank {dist.get_backend()} world on {mesh.device} (init and "
              f"first collectives {init_s:.2f} s): "
              f"{b_s:.2f} s for {n3} rounds = {b_s / n3 * 1e3:.2f} ms/round wall; against "
              f"phase 3's fit max|dW| {dW:.3e}, max|dSigma| {dS:.3e}; bit-equal to 11a {same}; "
              f"collectives through {dist.get_backend()} {sum(coll.values())} "
              f"({', '.join(f'{k} {v}' for k, v in sorted(coll.items()))}; "
              f"{sum(coll.values()) / n3:.1f} a round)")
        check(sum(coll.values()) >= 2 * n3, f"[11b] only {coll} collectives went through NCCL")

        # (e) the structured path at 4096 tasks on the same world
        cfg6 = dict(solver="pallas_round", loss="hinge", lam=1e-3, outer_iters=2, rounds=3,
                    block_size=BLOCK)
        n6 = cfg6["outer_iters"] * cfg6["rounds"]
        lowrank = dict(regularizer="low_rank_diag", regularizer_params={"rank": MANY_RANK})
        _, r6_s, _, _ = fit("11e reference", many.train, n6, 0, **lowrank, **cfg6)
        e, e_s, e_gap, coll = fit("11e low_rank_diag 4096", many.train, n6, 0,
                                  engine="distributed", mesh=mesh, **lowrank, **cfg6)
        dW, dS = against("11e", e, ref6c)
        check(e.sigma_view_ is not None and e.sigma_view_.kind == "low_rank_diag",
              "[11e] the fit did not keep the low-rank factors")
        print(f"[11e low_rank_diag 4096] x {tuple(many.train.x.shape)} on the NCCL mesh: "
              f"{e_s:.2f} s for {n6} rounds = {e_s / n6 * 1e3:.2f} ms/round wall (the reference "
              f"engine warm {r6_s / n6 * 1e3:.2f}); against "
              f"phase 6c's fit max|dW| {dW:.3e} (tol {TOL_W:.0e}), max|dSigma| {dS:.3e} (tol "
              f"{TOL_SIGMA:.0e}); gap {e_gap[0]:.5f} -> {e_gap[-1]:.5f}; sdca_round launches "
              f"{launches['11e low_rank_diag 4096']['sdca_round']}; collectives "
              f"{sum(coll.values())}")
    finally:
        dist.destroy_process_group()

    cfg4 = dict(solver="pallas_block", loss="hinge", lam=SYN_LAM, outer_iters=2, rounds=5,
                local_iters=0, block_size=BLOCK)
    H4 = syn.train.n_max + (-syn.train.n_max) % BLOCK
    c, c_s, _, _ = fit("11c pallas_block", syn.train, 0, n3 * (H4 // BLOCK),
                       engine="distributed", **cfg4)
    dW, dS = against("11c", c, ref4)
    print(f"[11c pallas_block] Synthetic-1 x {tuple(syn.train.x.shape)} on the local mesh: "
          f"{c_s:.2f} s; against phase 4's block_gram fit max|dW| {dW:.3e}, max|dSigma| "
          f"{dS:.3e}; sdca_block launches {launches['11c pallas_block']['sdca_block']} "
          f"(= {n3} rounds x {H4 // BLOCK} blocks)")

    # (d) the async engine's default transport
    d0, d0_s, _, _ = fit("11d async tau=0", train, n3, 0, engine="async", **cfg3)
    e0 = max((d0.W_ - a.W_).abs().max().item(), (d0.sigma_ - a.sigma_).abs().max().item())
    check(e0 <= 1e-6, f"[11d] simulated tau=0 differs from 11a by {e0}")
    d2, d2_s, d2_gap, _ = fit("11d async tau=2", train, n3, 0, engine="async",
                              async_options=AsyncOptions(tau=2, async_delays=(2,)), **cfg3)
    with open(ROOT / "tests" / "golden" / "async_histories.json") as f:
        rec = json.load(f)["g1_tau2_omega1"]
    kw = dict(rec["config"], async_delays=tuple(rec["config"]["async_delays"]))
    from repro_torch.data.synthetic import synthetic

    _, _, _, hist = fit_async(DMTRLConfig(**kw), synthetic(1, **rec["problem"]).train,
                              device=dev)
    got = {k: np.asarray(hist[k]).astype(int).tolist() for k in rec["history"]}
    check(got == rec["history"], "[11d] the g1_tau2_omega1 golden history differs")
    print(f"[11d async] simulated transport: tau=0 {d0_s / n3 * 1e3:.2f} ms/round wall, "
          f"max|d(W, Sigma)| against 11a {e0:.3e} (tolerance 1e-06); tau=2 with delays (2,) "
          f"{d2_s:.2f} s, gap {d2_gap[0]:.5f} -> {d2_gap[-1]:.5f}, max staleness "
          f"{int(d2.history['w_staleness'].max())}; golden g1_tau2_omega1 replayed on "
          f"{hist['round'].shape[0]} samples: equal")
    return launches


def wire_counters(transport: str, codec: str, topology: str = "star") -> dict:
    """The wire_stats that fit_async published (obs gauges) for its last
    run over ``transport`` under ``codec``."""
    from repro_torch.obs.metrics import get_registry

    reg = get_registry()
    keys = ("n_snapshots", "n_commits", "snapshot_bytes", "commit_bytes", "mix_bytes",
            "raw_snapshot_bytes", "raw_commit_bytes", "raw_mix_bytes", "n_exchanges",
            "spectral_gap")
    return {k: reg.gauge(f"repro_transport_{k}", labels=("transport", "codec", "topology"))
            .value(transport=transport, codec=codec, topology=topology) for k in keys}


def parameter_server_path(torch, dev, card: str, train, syn) -> None:
    """Phase 7a-c: fit_async over the threaded server at MNIST width (held
    against the single-process fit), at tau = 1 with a straggler and under
    the int8 codec; the multiprocess server on Synthetic-1 against the
    threaded one; the gossip ring through the block kernel."""
    import dataclasses

    from repro_torch import obs
    from repro_torch.core import AsyncOptions, DMTRLConfig, fit, fit_async
    from repro_torch.core import convergence as cv
    from repro_torch.core.solver_backends import get_backend
    from repro_torch.kernels.sdca import reset_launch_counts, sdca_block_kernel, sdca_round_kernel

    cfg = DMTRLConfig(**PS_CFG)
    rounds = cfg.outer_iters * cfg.rounds

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    def run(data, transport, workers, cfg=cfg, **kw):
        reset_launch_counts()
        opts = AsyncOptions(transport=transport, n_workers=workers, **kw)
        out, sec = timed(lambda: fit_async(cfg, data, options=opts, device=dev))
        return out, sec, sdca_round_kernel.launches, sdca_block_kernel.launches

    # 7a: the threaded server at full width against the one-process fit
    ref, ref_s = timed(lambda: fit(cfg, train, device=dev))
    obs.enable(clear=True)  # the transport's gate/snapshot/solve/commit spans
    (W, S, _, h0), s0, k1, k2 = run(train, "threaded", PS_WORKERS)
    obs.disable()
    spans = obs.phase_breakdown(cat="transport")
    dW = (W - ref.W).abs().max().item()
    dS = (S - ref.sigma).abs().max().item()
    print(f"[7a threaded] x {tuple(train.x.shape)}, {PS_WORKERS} worker threads, tau 0: "
          f"max|W - fit| {dW:.3e} (tolerance {TOL_W:.0e}), max|Sigma - fit| {dS:.3e} "
          f"(tolerance {TOL_SIGMA:.0e}); sdca_round launches {k1} = {k1 / rounds:g} per "
          f"round; {s0 * 1e3 / rounds:.1f} ms/round wall against {ref_s * 1e3 / rounds:.1f} "
          f"for the one-process fit (objectives per commit and Omega-steps included); gap "
          f"{np.array2string(h0['gap'], precision=5)} on {card}")
    check(k1 == PS_WORKERS * rounds, f"sdca_round launched {k1} times, expected "
          f"{PS_WORKERS} per round")
    check(k2 == 0, "the threaded MNIST path launched sdca_block")
    check(dW <= TOL_W, "the threaded fit's W disagrees with the one-process fit")
    check(dS <= TOL_SIGMA, "the threaded fit's Sigma disagrees with the one-process fit")
    check(bool(np.all(np.isfinite(h0["gap"]))), "threaded gap is not finite")
    print("[7a split] per round, host clock (spans summed over both workers): "
          + ", ".join(f"{k} {spans[k]['total_s'] * 1e3 / rounds:.3f} ms ({spans[k]['count']})"
                      for k in ("gate", "snapshot", "snapshot_encode", "snapshot_decode",
                                "solve", "commit") if k in spans))
    gap0 = abs(float(h0["gap"][-1]))
    wires = {"none": wire_counters("threaded", "none")}
    (_, _, _, h1), s1, k1b, _ = run(train, "threaded", PS_WORKERS, tau=1,
                                    async_delays=PS_DELAYS)
    stale = cv.staleness_summary(h1)
    print(f"[7a tau=1] worker delays {PS_DELAYS} (x {1e3 * 0.005:g} ms of sleep): "
          f"{s1 * 1e3 / rounds:.1f} ms/round wall; max lag {h1['w_lag'].max()}, max "
          f"staleness {h1['w_staleness'].max()}; final gap {float(h1['gap'][-1]):.5f} against "
          f"{gap0:.5f} at tau 0; staleness_summary {stale}; sdca_round launches {k1b}; "
          f"gap {np.array2string(h1['gap'], precision=5)}, commits by worker "
          f"{h1['w_worker'].tolist()}, their staleness {h1['w_staleness'].tolist()}")
    check(h1["w_lag"].max() <= 1, f"lag {h1['w_lag'].max()} exceeds tau = 1")
    check(h1["w_staleness"].max() >= 1, "no commit was stale at tau = 1")
    check(float(h1["gap"][-1]) <= 2.0 * gap0 + 1e-9, "tau = 1 gap above twice the tau = 0 gap")
    # the same fit again, warm: its device share under torch.profiler, and
    # its wall with the interpreter's thread switch interval cut from 5 ms
    # to 0.1 ms (the workers hand the interpreter lock to each other at
    # every synchronization: snapshot copies, objectives, the solve's wait)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, sp, _, _ = run(train, "threaded", PS_WORKERS)
    busy_ms = sum(e.self_device_time_total for e in device_events(prof)) / 1e3
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    try:
        _, ssw, _, _ = run(train, "threaded", PS_WORKERS)
    finally:
        sys.setswitchinterval(switch)
    print(f"[7a warm] {sp * 1e3 / rounds:.1f} ms/round wall under torch.profiler, device busy "
          f"{busy_ms / rounds:.2f} ms/round = {busy_ms / (sp * 1e3):.1%} of wall; with a "
          f"0.1 ms switch interval (default {switch * 1e3:g} ms): {ssw * 1e3 / rounds:.1f} "
          f"ms/round wall")
    (_, _, _, h8), s8, _, _ = run(train, "threaded", PS_WORKERS, codec="int8")
    wires["int8"] = wire_counters("threaded", "int8")
    for codec, w in wires.items():
        print(f"[7a wire {codec}] per round: snapshots {w['snapshot_bytes'] / rounds:.0f} B "
              f"(raw {w['raw_snapshot_bytes'] / rounds:.0f}), commits "
              f"{w['commit_bytes'] / rounds:.0f} B (raw {w['raw_commit_bytes'] / rounds:.0f}); "
              f"{int(w['n_snapshots'])} snapshots, {int(w['n_commits'])} commits")
    print(f"[7a int8] {s8 * 1e3 / rounds:.1f} ms/round wall; final primal "
          f"{float(h8['primal'][-1]):.6f} against {float(h0['primal'][-1]):.6f} exact")
    check(abs(float(h8["primal"][-1]) - float(h0["primal"][-1]))
          <= 2e-2 * max(1.0, abs(float(h0["primal"][-1]))), "int8 run outside its bound")

    # 7b: worker processes on Synthetic-1 against the threaded server
    data = syn.train.to(dev)
    scfg = dataclasses.replace(cfg, lam=SYN_LAM)
    (Wt, St, _, ht), st_s, kt, _ = run(data, "threaded", PS_WORKERS, cfg=scfg)
    obs.enable(clear=True)
    (Wm, Sm, _, hm), sm_s, _, _ = run(data, "multiprocess", PS_WORKERS, cfg=scfg)
    obs.disable()
    spans = obs.phase_breakdown(cat="transport")
    start_s = spans["start_workers"]["total_s"]
    stop_s = spans["stop_workers"]["total_s"]
    dW = (Wm - Wt).abs().max().item()
    dS = (Sm - St).abs().max().item()
    print(f"[7b multiprocess] x {tuple(data.x.shape)}, {PS_WORKERS} worker processes: "
          f"start-up {start_s:.2f} s (spawn, import, block to the card), exit "
          f"{stop_s:.2f} s, rounds {(sm_s - start_s - stop_s) * 1e3 / rounds:.1f} ms/round "
          f"wall against {st_s * 1e3 / rounds:.1f} threaded ({kt} sdca_round launches there); "
          f"max|W - threaded| {dW:.3e}, max|Sigma - threaded| {dS:.3e}; gap "
          f"{float(hm['gap'][0]):.5f} -> {float(hm['gap'][-1]):.5f}")
    check(dW <= TOL_W and dS <= TOL_SIGMA, "the multiprocess fit disagrees with the threaded one")
    check(hm["w_lag"].max() == 0 and len(hm["w_worker"]) == PS_WORKERS * rounds,
          "multiprocess commits")

    # 7c: the gossip ring through the block kernel
    gcfg = dataclasses.replace(scfg, solver="pallas_block")
    H = get_backend("pallas_block").round_local_iters(data.n_max, BLOCK)
    obs.enable(clear=True)
    (Wg, Sg, _, hg), sg_s, _, kb = run(data, "gossip", GOSSIP_NODES, cfg=gcfg, topology="ring")
    obs.disable()
    spans = obs.phase_breakdown(cat="transport")
    wg = wire_counters("gossip", "none", "ring")
    sys.setswitchinterval(1e-4)
    try:
        _, sg_sw, _, _ = run(data, "gossip", GOSSIP_NODES, cfg=gcfg, topology="ring")
    finally:
        sys.setswitchinterval(switch)
    print(f"[7c gossip] ring of {GOSSIP_NODES}, spectral gap {wg['spectral_gap']:.4f}: "
          f"{sg_s * 1e3 / rounds:.1f} ms/round wall ({sg_sw * 1e3 / rounds:.1f} with a 0.1 ms "
          f"switch interval); sdca_block launches {kb} "
          f"(= {GOSSIP_NODES} nodes x {rounds} rounds x {H // BLOCK} blocks); "
          f"{int(wg['n_exchanges'])} exchanges, {wg['mix_bytes'] / rounds:.0f} B mixed per "
          f"round; gap per commit {np.array2string(hg['gap'], precision=4)}")
    print("[7c split] per round, host clock (spans summed over the nodes): "
          + ", ".join(f"{k} {spans[k]['total_s'] * 1e3 / rounds:.3f} ms ({spans[k]['count']})"
                      for k in ("gate", "snapshot", "snapshot_encode", "solve", "commit")
                      if k in spans))
    check(kb == GOSSIP_NODES * rounds * (H // BLOCK), f"sdca_block launched {kb} times")
    check(bool(np.all(np.isfinite(hg["gap"]))) and hg["gap"][-1] < hg["gap"][0],
          "the gossip gap did not shrink")


def paper_claims(torch, dev, card: str, est, train) -> None:
    """Phase 7d: the paper's claims on the card (the bars of
    benchmarks/paper.py and tests/test_dmtrl.py)."""
    import dataclasses

    from repro_torch import prng
    from repro_torch.core import DMTRLConfig, fit, w_step
    from repro_torch.core import baselines, dual as dm, omega as om
    from repro_torch.core import convergence as cv
    from repro_torch.core.losses import get_loss
    from repro_torch.core.transport import make_block_solver
    from repro_torch.data.synthetic import school_like, synthetic

    # Table 2 on School: DMTRL no worse than STL, within 5 % of centralized
    sp = school_like(seed=0)
    tr, te = sp.train.to(dev), sp.test.to(dev)
    cfg = DMTRLConfig(loss="squared", lam=1e-3, outer_iters=4, rounds=10,
                      local_iters=128, seed=0)
    t = time.perf_counter()
    res = fit(cfg, tr, device=dev)
    stl = baselines.fit_stl(cfg, tr, device=dev)
    Wc, _, _ = baselines.fit_centralized_mtrl(cfg, tr, inner_steps=500, device=dev)
    rmse = {k: float(dm.rmse(te, W)) for k, W in
            (("dmtrl", res.W), ("stl", stl.W), ("centralized", Wc))}
    print(f"[7d table2] school_like x {tuple(tr.x.shape)}: RMSE {rmse} "
          f"({time.perf_counter() - t:.2f} s)")
    check(rmse["dmtrl"] <= rmse["stl"] + 1e-3, "Table 2: DMTRL worse than STL")
    check(abs(rmse["dmtrl"] - rmse["centralized"]) <= 0.05 * rmse["centralized"],
          "Table 2: DMTRL not within 5 % of centralized MTRL")

    # Theorems 8/9: the smooth loss's dual suboptimality falls faster
    data = synthetic(1, m=8, d=60, n_train_avg=200, n_test_avg=50, seed=0).train.to(dev)
    sigma0, _ = om.init_sigma(data.m, device=dev)
    slopes = {}
    for loss in ("squared", "hinge"):
        c = DMTRLConfig(loss=loss, lam=1e-3, rounds=40, local_iters=256, seed=0)
        zeros = (torch.zeros((data.m, data.n_max), device=dev),
                 torch.zeros((data.m, data.d), device=dev))
        _, _, hist = w_step(c, data, *zeros, sigma0, 1.0, prng.PRNGKey(0))
        d_star = hist["dual"][-1] + hist["gap"][-1]
        subopt = np.maximum(d_star - hist["dual"], 1e-12)
        slopes[loss] = float(np.polyfit(hist["round"][:20], np.log(subopt[:20]), 1)[0])
    print(f"[7d theory] log-suboptimality slope per round over the first 20: {slopes}")
    check(slopes["squared"] < slopes["hinge"] < 0, "smooth loss does not converge faster")

    # Assumption 1's Theta on phase 3's problem at the fit's first round
    # (alpha = 0, W = 0, Sigma = I/m, rho = 1: later the local subproblem
    # barely moves and Theta is float32 noise), one task's 1024-step round
    # through the round kernel against 20000 naive steps; Eq. (5)'s rho_min
    # on the fitted Sigma against the Lemma-10 rho a next W-step would use
    lam = est.config.lam
    sigma0, _ = om.init_sigma(train.m, device=dev)
    alpha0 = torch.zeros_like(train.y)
    W0 = torch.zeros((train.m, train.d), device=dev)
    rho0 = est.rho_per_outer_[0]
    solve = make_block_solver(dataclasses.replace(est.config, local_iters=1024),
                              train.n_max, rho0)
    dalpha, _ = solve(train.x, train.y, alpha0, W0, train.n, sigma0,
                      torch.arange(train.m), prng.PRNGKey(7))
    t = time.perf_counter()
    th = cv.measure_theta(train, 3, alpha0, W0, sigma0, rho0, lam, "hinge", dalpha[3])
    th_s = time.perf_counter() - t
    sigma = est.sigma_
    rho = float(om.rho_lemma10(sigma))
    t = time.perf_counter()
    rho_min = cv.rho_min_power_iteration(train, sigma)
    print(f"[7d theta] task 3, a 1024-step round against 20000 naive steps: {th} "
          f"({th_s:.2f} s); rho_min (power iteration) {rho_min:.5f} <= Lemma 10 "
          f"{rho:.5f} on the fitted Sigma ({time.perf_counter() - t:.2f} s); rho per outer "
          f"of the fit {[round(r, 5) for r in est.rho_per_outer_]}")
    check(0.0 <= th["theta"] <= 1.0, f"Theta {th['theta']} outside [0, 1]")
    check(rho_min <= rho * (1 + 1e-5), "rho_min above the Lemma-10 bound")

    # SSDCA: the single-machine exact solver reaches DMTRL's dual
    data = synthetic(1, m=4, d=24, n_train_avg=60, n_test_avg=20, seed=3).train.to(dev)
    cfg = DMTRLConfig(loss="hinge", lam=1e-2, outer_iters=1, rounds=25, local_iters=128,
                      learn_omega=False, seed=0)
    res = fit(cfg, data, device=dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    _, _, hist = baselines.fit_ssdca(cfg, data, passes=25, device=dev)
    torch.cuda.synchronize()
    ss_s = time.perf_counter() - t
    sig, _ = om.init_sigma(data.m, device=dev)
    d_dmtrl = float(dm.dual_objective(data, res.alpha, sig, cfg.lam, get_loss("hinge")))
    print(f"[7d ssdca] {data.m} x {data.n_max} coordinates a pass, 25 passes: dual "
          f"{hist['dual'][-1]:.6f} against DMTRL's {d_dmtrl:.6f}; "
          f"{ss_s * 1e3 / 25:.1f} ms per pass on {card} (one eager step per coordinate)")
    check(abs(d_dmtrl - hist["dual"][-1]) <= 0.05 * abs(hist["dual"][-1]),
          "SSDCA's dual not within 5 % of DMTRL's")


def recording_counter():
    """A roofline.analysis.CostCounter that also keeps, per counted op and
    kernel launch, (name, FLOPs, bytes): two runs that disagree are shown
    where they part."""
    from repro_torch.roofline.analysis import CostCounter

    class Recording(CostCounter):
        def __init__(self):
            super().__init__()
            self.log = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            f0, b0, paused = self.costs.flops, self.costs.bytes, self._paused
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if not paused:
                self.log.append((str(func), self.costs.flops - f0, self.costs.bytes - b0))
            return out

        def launch(self, name, cost, fn, *args, **kwargs):
            if not self._paused:
                self.log.append((name, int(cost[0]), int(cost[1])))
            return super().launch(name, cost, fn, *args, **kwargs)

    return Recording()


def check_same_counts(tag: str, trace, trace_log, card, card_log) -> None:
    """Fail unless the trace and the card counted the same, showing the
    first ops where the two logs part."""
    if trace.counted() == card.counted():
        return
    i = next((i for i, (a, b) in enumerate(zip(trace_log, card_log)) if a != b),
             min(len(trace_log), len(card_log)))
    print(f"[{tag}] the counts part at op {i} of {len(trace_log)} (trace) and "
          f"{len(card_log)} (card):", file=sys.stderr)
    for j in range(max(0, i - 2), i + 4):
        print(f"[{tag}]   trace {trace_log[j] if j < len(trace_log) else None}; "
              f"card {card_log[j] if j < len(card_log) else None}", file=sys.stderr)
    fail(f"[{tag}] the meta trace counted {trace.counted()}, the card "
         f"{card.counted()}")


def dryrun_against_card(torch, dev, card: str, arch: str, tag: str, step_ms: float) -> dict:
    """Phase 13a: ``arch`` whole at phase 10's step (bf16, remat, AdamW,
    2 x 1024 tokens, one position), through the dry run's train-mode step
    (``dryrun.microbatch_rule``). The dry run's bytes at rest equal the
    params and both moments built on the card; its meta trace of one step
    equals the counter over one warm step on the card, exactly, and the
    counter's kernel launches equal the wrappers' counts. Prints the
    trace's peak of live bytes beside max_memory_allocated, the roofline
    terms, and the model FLOPs over phase 10's warm step at the bf16 peak.
    Returns the counted step's launches."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import SyntheticTokenPipeline, TokenPipelineConfig
    from repro_torch.launch import PEAK_FLOPS_BF16, dryrun, make_host_mesh
    from repro_torch.launch.input_specs import InputShape, train_inputs
    from repro_torch.models import init_params
    from repro_torch.roofline.analysis import roofline_terms
    from repro_torch.train import AdamW
    from repro_torch.train.loop import make_sharded_train_step
    from repro_torch.train.optimizer import tree_leaves

    cfg = dataclasses.replace(get_config(arch), remat=True)
    shape = InputShape("phase 10", TRAIN_SEQ, TRAIN_BATCH, "train")
    one = dryrun.ShapeMesh({"data": 1, "model": 1})
    at_rest = dryrun.step_bytes_at_rest(cfg, one)
    arg_bytes = dryrun.arg_bytes_per_device(cfg, shape, one)
    rec_trace = recording_counter()
    t0 = time.perf_counter()
    trace = dryrun.trace_step(cfg, shape, make_host_mesh(1, 1, device="meta"), rec_trace)
    trace_s = time.perf_counter() - t0

    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    opt = AdamW(lr=1e-3, warmup_steps=2)
    mesh = make_host_mesh(1, 1, device=dev)
    options = dryrun.microbatch_rule(cfg, shape, mesh)  # the traced step's: train mode
    step, _, _, _ = make_sharded_train_step(cfg, opt, mesh, TRAIN_BATCH, TRAIN_SEQ, **options)
    params = init_params(cfg, 0, dev)  # on one position a rank's blocks are the leaves
    state = opt.init(params)
    held = sum(t.numel() * t.element_size()
               for t in tree_leaves(params) + tree_leaves(state.mu) + tree_leaves(state.nu))
    alloc = torch.cuda.memory_allocated() - base
    print(f"[{tag} {arch}] bytes at rest: the dry run {at_rest} (params and two fp32 "
          f"moments), on the card {held} (memory_allocated grew {alloc}); the JAX "
          f"definition's arg_bytes_per_device {arg_bytes} (3 x the params' bytes)")
    check(at_rest == held, f"[{tag} {arch}] the dry run's bytes at rest {at_rest} != {held}")
    dtypes = {k: v.dtype for k, v in train_inputs(cfg, shape).items()}
    batch = SyntheticTokenPipeline(TokenPipelineConfig(
        cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)).batch(0)
    batch = {k: torch.from_numpy(v).to(dev, dtypes[k]) for k, v in batch.items()}
    gc.collect()  # earlier phases' garbage, which a collection inside the step would free
    step(params, state, batch)  # warm: the counted step is phase 10's steady state
    torch.cuda.synchronize()
    kernels = lm_kernels()
    for k in kernels.values():
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    m0 = torch.cuda.memory_allocated()
    rec_card = recording_counter()
    t0 = time.perf_counter()
    with rec_card:
        step(params, state, batch)
        torch.cuda.synchronize()
    counted_s = time.perf_counter() - t0
    peak_card = torch.cuda.max_memory_allocated() - m0
    launches = {name: k.launches for name, k in kernels.items()}
    got = rec_card.costs
    check_same_counts(f"{tag} {arch}", trace, rec_trace.log, got, rec_card.log)
    check(dict(got.kernels) == {k: v for k, v in launches.items() if v},
          f"[{tag} {arch}] the counter's launches {dict(got.kernels)} != the wrappers' {launches}")
    print(f"[{tag} {arch}] one train-mode step ({options['mode']}, {options['microbatches']} "
          f"microbatch) traced on meta in {trace_s:.2f} s equals the counter over "
          f"the card's step ({counted_s:.2f} s under the counter): {trace.flops} FLOP, "
          f"{trace.bytes} bytes, {trace.ops} ops, kernels {dict(trace.kernels)} (wrappers "
          f"{launches}), kernel FLOP {dict(trace.kernel_flops)}")
    print(f"[{tag} {arch}] peak live bytes: trace {trace.peak_bytes / 1e9:.3f} GB, the "
          f"counter's over the card's step {got.peak_bytes / 1e9:.3f} GB, card "
          f"max_memory_allocated over the step {peak_card / 1e9:.3f} GB, gap "
          f"{(peak_card - trace.peak_bytes) / 1e9:+.3f} GB")
    flops = dryrun.model_flops(cfg, shape)
    terms = roofline_terms(trace, arch=arch, shape="2 x 1024 train", mesh_name="one position",
                           n_chips=1, model_flops=flops)
    share = flops / (step_ms / 1e3 * PEAK_FLOPS_BF16)
    print(f"[{tag} {arch}] roofline: compute {terms.compute_s * 1e3:.3f} ms, memory "
          f"{terms.memory_s * 1e3:.3f} ms, collective {terms.collective_s * 1e3:.3f} ms, "
          f"dominant {terms.dominant}; model FLOP 6 N_active tokens = {flops:.4e} "
          f"({flops / trace.flops:.3f} of the traced FLOP); over phase 10's warm step "
          f"{step_ms:.1f} ms at {PEAK_FLOPS_BF16:.3g} FLOP/s: {share:.2%} of the bf16 peak "
          f"on {card}")
    del params, state, batch, step
    torch.cuda.empty_cache()
    return launches


def sharded_serve_path(torch, dev, card: str, arch: str, tag: str) -> dict:
    """Phase 14: ``arch`` whole (bf16, random weights from seed 0), a
    SERVE_BATCH x SERVE_PROMPT prefill and SERVE_TICKS greedy decode ticks
    through ``models.make_sharded_prefill`` and
    ``make_sharded_decode_step``, (a) on the local mesh and (b) on a
    one-rank NCCL world, each against ``prefill`` and ``decode_step`` in
    the same call: the logits of the prefill and of every tick, every
    cache leaf after the prefill and after the last tick and the position
    bit-equal. Counts K3 and K4 a prefill and the collectives a tick;
    prints the warm prefill and tick ms beside the unsharded ones. Then
    the meta trace of the same sharded prefill and tick
    (``dryrun.trace_serve``) equals the counter over the card's calls,
    exactly. Returns each run's prefill launches."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core import distributed as dist_mod
    from repro_torch.core import make_mesh
    from repro_torch.launch import dryrun, make_host_mesh
    from repro_torch.launch.input_specs import InputShape
    from repro_torch.models import (
        decode_step, init_params, make_sharded_decode_step, make_sharded_prefill, prefill,
        sharding,
    )

    cfg = get_config(arch)
    B, S, T = SERVE_BATCH, SERVE_PROMPT, SERVE_TICKS
    params = init_params(cfg, 0, dev)  # on one position a rank's blocks are the leaves
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (B, S)).astype(np.int32)).to(dev)
    n_attn, n_ssm = attention_and_ssm_layers(cfg)
    per_prefill = {"K3": n_attn, "K4": n_ssm}
    kernels = lm_kernels()

    def leaves(cache):
        return [(p, t.clone()) for p, t in sharding.cache_items(cache)]

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def serve(pre, tick):
        """A warm prefill, then the timed one and its ticks: the logits, the
        caches, launches, ms and collectives a tick."""
        pre()  # warm: the first call's allocations and libraries
        for k in kernels.values():
            k.launches = 0
        (logits, cache), pre_ms = timed(pre)
        out = {"prefill_ms": pre_ms, "logits": [logits.clone()], "prefill_cache": leaves(cache),
               "launches": {n: kernels[n].launches for n in per_prefill}, "tick_ms": [],
               "collectives": []}
        for i in range(T):
            token = toks[i]
            dist_mod.reset_collective_counts()
            (logits, cache), ms = timed(lambda: tick(token, cache))
            out["tick_ms"].append(ms)
            out["collectives"].append(dict(dist_mod.COLLECTIVES))
            out["logits"].append(logits.clone())
        out["cache"] = leaves(cache)
        return out

    # the reference and its greedy tokens
    ref_logits, ref_cache = prefill(cfg, params, tokens, extra_len=T)
    toks = []
    for _ in range(T):
        toks.append(ref_logits[:, :cfg.vocab_size].argmax(-1).to(torch.int32))
        ref_logits, ref_cache = decode_step(cfg, params, toks[-1], ref_cache)
    del ref_cache
    ref = serve(lambda: prefill(cfg, params, tokens, extra_len=T),
                lambda tok, c: decode_step(cfg, params, tok, c))

    def sharded(mesh):
        pstep, _, bshard, _ = make_sharded_prefill(cfg, mesh, B, S, extra_len=T)
        dstep, _, tshard, _ = make_sharded_decode_step(cfg, mesh, B, S + T)
        batch = {"tokens": bshard["tokens"].shard(tokens)}
        return serve(lambda: pstep(params, batch),
                     lambda tok, c: dstep(params, tshard.shard(tok), c))

    runs = {"local": sharded(make_host_mesh(1, 1, device=dev))}
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device=dev)
        check(mesh.distributed, f"[{tag}] not a process-group mesh: {mesh}")
        dist_mod.psum(torch.zeros(1, device=dev), mesh, "data")  # the communicator
        runs["nccl"] = sharded(mesh)
    finally:
        dist.destroy_process_group()

    def same(a, b):
        return all(pa == pb and torch.equal(ta, tb) for (pa, ta), (pb, tb) in zip(a, b))

    warm = slice(1, T)
    line = {"phase": tag, "arch": arch, "batch": B, "prompt": S, "ticks": T, "card": card,
            "prefill/decode_step": {"prefill_ms": ref["prefill_ms"],
                                    "tick_ms_median": float(np.median(ref["tick_ms"][warm])),
                                    "launches_per_prefill": ref["launches"]}}
    for name, r in runs.items():
        logits_equal = all(torch.equal(a, b) for a, b in zip(r["logits"], ref["logits"]))
        cache_equal = same(r["prefill_cache"], ref["prefill_cache"]) and same(r["cache"],
                                                                                ref["cache"])
        check(logits_equal, f"[{tag} {arch} {name}] logits differ from prefill/decode_step's")
        check(cache_equal, f"[{tag} {arch} {name}] a cache leaf differs from prefill/"
              "decode_step's")
        check(r["launches"] == per_prefill, f"[{tag} {arch} {name}] launches a prefill "
              f"{r['launches']}, expected {per_prefill}")
        coll = r["collectives"]
        check(all(c == coll[0] for c in coll), f"[{tag} {arch} {name}] collectives vary: {coll}")
        line[name] = {"prefill_ms": r["prefill_ms"],
                      "tick_ms_median": float(np.median(r["tick_ms"][warm])),
                      "tick_ms_range": [float(min(r["tick_ms"][warm])),
                                        float(max(r["tick_ms"][warm]))],
                      "logits_bit_equal": logits_equal, "cache_bit_equal": cache_equal,
                      "launches_per_prefill": r["launches"], "collectives_per_tick": coll[0]}
    print(f"[{tag} {arch} sharded serve] " + json.dumps(line))

    # the meta trace of the same prefill and tick against the card's counter
    one = make_host_mesh(1, 1, device="meta")
    pstep, _, bshard, _ = make_sharded_prefill(cfg, make_host_mesh(1, 1, device=dev), B, S,
                                               extra_len=T)
    dstep, _, tshard, _ = make_sharded_decode_step(cfg, make_host_mesh(1, 1, device=dev), B,
                                                   S + T)
    for kind, seq in (("prefill", S), ("decode", S + T)):
        rec_trace = recording_counter()
        t0 = time.perf_counter()
        trace = dryrun.trace_serve(cfg, InputShape(f"{tag} {kind}", seq, B, kind), one,
                                   rec_trace, extra_len=T)
        trace_s = time.perf_counter() - t0
        logits, cache = pstep(params, {"tokens": tokens})  # warm, and the tick's cache
        torch.cuda.synchronize()
        rec_card = recording_counter()
        with rec_card:
            if kind == "prefill":
                pstep(params, {"tokens": tokens})
            else:
                dstep(params, toks[0], cache)
            torch.cuda.synchronize()
        check_same_counts(f"{tag} {arch} {kind}", trace, rec_trace.log, rec_card.costs,
                          rec_card.log)
        print(f"[{tag} {arch} {kind} counted] the meta trace ({trace_s:.2f} s) equals the "
              f"counter over the card's call: {trace.flops} FLOP, {trace.bytes} bytes, "
              f"{trace.ops} ops, kernels {dict(trace.kernels)}, collectives "
              f"{dict(trace.collectives)}; peak live bytes trace {trace.peak_bytes}, card "
              f"counter {rec_card.costs.peak_bytes}")
        del logits, cache
    print(f"[{tag} {arch}] warm ms: prefill {B} x {S} " + ", ".join(
        f"{k} {v['prefill_ms']:.1f}" for k, v in line.items() if isinstance(v, dict))
        + f"; decode tick median " + ", ".join(
        f"{k} {v['tick_ms_median']:.2f}" for k, v in line.items() if isinstance(v, dict))
        + f"; K3 / K4 a prefill {per_prefill}; collectives a tick "
        + ", ".join(f"{name} {line[name]['collectives_per_tick']}" for name in runs)
        + f"; bit-equal " + ", ".join(
            f"{name} {line[name]['logits_bit_equal'] and line[name]['cache_bit_equal']}"
            for name in runs) + f" on {card}")
    del params, ref, runs
    torch.cuda.empty_cache()
    return {f"{tag} {arch} sharded prefill {name}": {**dict.fromkeys(kernels, 0), **per_prefill}
            for name in ("local", "nccl")}


def dmtrl_dryrun_against_card(torch, dev, card: str, data) -> dict:
    """Phase 13b: one make_distributed_round at phase 11e's size (the 4096
    tasks of Synthetic-1, d = 100, hinge, one local epoch, one position),
    block_gram and pallas_round: the meta trace equals the counter over the
    real round on the card, exactly. Then dryrun_dmtrl's rows at the JAX
    package's defaults on both production meshes (host, meta). Returns
    the counted rounds' K1/K2 launches."""
    from repro_torch import prng
    from repro_torch.core import DMTRLConfig, MeshAxes
    from repro_torch.core.distributed import make_distributed_round
    from repro_torch.kernels.sdca import reset_launch_counts, sdca_block_kernel, sdca_round_kernel
    from repro_torch.launch import dryrun_dmtrl, make_host_mesh

    m, n_max, d = data.x.shape
    axes = MeshAxes(data="data")
    sigma = torch.eye(m, device=dev) / m
    rho = 2.0
    out = {}
    for solver in ("block_gram", "pallas_round"):
        cfg = DMTRLConfig(solver=solver, loss="hinge", lam=1e-3, local_iters=0,
                          block_size=BLOCK)
        rec_trace = recording_counter()
        t0 = time.perf_counter()
        trace = dryrun_dmtrl.trace_round(cfg, make_host_mesh(1, 1, device="meta"), axes, m,
                                         n_max, d, rho, counter=rec_trace)
        trace_s = time.perf_counter() - t0
        round_fn = make_distributed_round(cfg, make_host_mesh(1, 1, device=dev), axes, m,
                                          n_max, d, rho)
        args = (data.x, data.y, data.n, torch.zeros_like(data.y),
                torch.zeros((m, d), device=dev), sigma, prng.PRNGKey(0))
        round_fn(*args)  # warm
        torch.cuda.synchronize()
        reset_launch_counts()
        rec_card = recording_counter()
        t0 = time.perf_counter()
        with rec_card:
            round_fn(*args)
            torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        got = rec_card.costs
        launches = {"sdca_round": sdca_round_kernel.launches,
                    "sdca_block": sdca_block_kernel.launches}
        check_same_counts(f"13b {solver}", trace, rec_trace.log, got, rec_card.log)
        check(launches["sdca_round"] == got.kernels.get("K1", 0)
              == (1 if solver == "pallas_round" else 0),
              f"[13b {solver}] K1 launches: wrapper {launches}, counter {dict(got.kernels)}")
        print(f"[13b {solver}] one round at x {tuple(data.x.shape)} traced on meta in "
              f"{trace_s:.2f} s equals the counter over the card's round ({card_s * 1e3:.1f} ms "
              f"under the counter): {trace.flops} FLOP, {trace.bytes} bytes, {trace.ops} ops, "
              f"kernels {dict(trace.kernels)}, peak live bytes trace {trace.peak_bytes}")
        out[f"13b {solver} counted round"] = launches
    table = ROOT / "results" / "dryrun_torch"
    for mesh_name in ("single", "multi"):
        row = dryrun_dmtrl.run(mesh_name, 4096, 2048, 8192, str(table))
        check(row["status"] == "ok", f"[13b dryrun_dmtrl {mesh_name}] {row}")
        print(f"[13b dryrun_dmtrl {mesh_name}] m 4096, n_max 2048, d 8192, H 512, B 128 "
              f"(block_gram): per device {row['flops_per_device']:.4e} FLOP, "
              f"{row['bytes_per_device']:.4e} bytes, collectives {row['collective_counts']} "
              f"{row['collective_breakdown']} bytes; compute {row['compute_s'] * 1e3:.3f} ms, "
              f"memory {row['memory_s'] * 1e3:.3f} ms, collective "
              f"{row['collective_s'] * 1e3:.3f} ms ({row['dominant']}); useful "
              f"{row['useful_flops_ratio']:.3f}; traced in {row['trace_s']:.2f} s")
    return out


def dryrun_table(card: str) -> None:
    """Phase 13c: every arch x input shape x mesh through launch.dryrun on
    the host (meta tensors, fake worlds of 256 and 512 ranks): every
    train, prefill and decode row "ok" (traced), long_500k "skipped"
    exactly where shape_applicable says; each row's state at rest plus
    its traced peak within the card's memory ("fits") but kimi-k2's serve
    rows (its params alone under the serve-mode specs pass 80 GB); the
    train rows' traces under DRYRUN_TABLE_S, the serve rows' under
    DRYRUN_SERVE_S."""
    import collections

    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.input_specs import INPUT_SHAPES, shape_applicable

    t0 = time.perf_counter()
    recs = dryrun.run_all(ARCH_IDS, list(INPUT_SHAPES), ["single", "multi"],
                          str(ROOT / "results" / "dryrun_torch"), echo=None)
    total = time.perf_counter() - t0
    for r in recs:
        shape = INPUT_SHAPES[r["shape"]]
        where = f"[13c {r['arch']} {r['shape']} {r['mesh']}]"
        want = "skipped" if not shape_applicable(get_config(r["arch"]), shape)[0] else "ok"
        check(r["status"] == want, f"{where} {r['status']}, expected {want}: "
              f"{r.get('error', r.get('reason'))}")
        if r["status"] != "ok":
            continue
        micro = f"{r['microbatches']} microbatches" if shape.kind == "train" else shape.kind
        held = r["step_bytes_at_rest"] + r["peak_bytes_per_device"]
        print(f"{where} {r['trace_s']:.2f} s, {micro}: "
              f"{r['flops_per_device']:.4e} FLOP, {r['bytes_per_device']:.4e} bytes, "
              f"collective {r['collective_bytes_per_device']:.4e} bytes "
              f"{r['collective_counts']}; compute {r['compute_s']:.4f} s, memory "
              f"{r['memory_s']:.4f} s, collective {r['collective_s']:.4f} s "
              f"({r['dominant']}); useful {r['useful_flops_ratio']:.4f}; peak "
              f"{r['peak_bytes_per_device'] / 1e9:.2f} GB; at rest "
              f"{r['step_bytes_at_rest'] / 1e9:.2f} GB, JAX arg bytes "
              f"{r['arg_bytes_per_device'] / 1e9:.2f} GB; fits {r['fits']}")
        check(r["fits"] == (held <= CARD_BYTES), f"{where} fits {r['fits']} for {held} bytes")
        too_big = r["arch"] == "kimi-k2-1t-a32b" and shape.kind != "train"
        check(r["fits"] != too_big, f"{where} the state at rest and the traced peak take "
              f"{held / 1e9:.2f} GB against the card's {CARD_BYTES / 1e9:.0f} GB")
    counts = collections.Counter(r["status"] for r in recs)
    train_s = sum(r.get("trace_s", 0.0) for r in recs if r["shape"] == "train_4k")
    serve_s = sum(r.get("trace_s", 0.0) for r in recs if r["shape"] != "train_4k")
    print(f"[13c table] {len(recs)} rows {dict(counts)} in {total:.1f} s (train rows "
          f"{train_s:.1f} s, limit {DRYRUN_TABLE_S:.0f} s; serve rows {serve_s:.1f} s, limit "
          f"{DRYRUN_SERVE_S:.0f} s); host side of {card}")
    check(train_s < DRYRUN_TABLE_S, f"[13c] the train rows took {train_s:.1f} s")
    check(serve_s < DRYRUN_SERVE_S, f"[13c] the serve rows took {serve_s:.1f} s")


EXAMPLES = ROOT / "examples" / "torch"
EXAMPLES_AT_ONCE = 4  # phase 15's example processes sharing the card at a time
EXAMPLE_TIMEOUT_S = 300.0
EXAMPLES_BUDGET_S = 150.0
EXAMPLE_TAU = 2  # async_workers' staleness bound
FEATURE_BATCHES = 24  # train_lm_mtl's phi batches: 2 sets x 6 tasks x ceil(48 / 32)


def example_runs(trace: str) -> list:
    """Phase 15's runs, (tag, argv after the interpreter): every port
    example at its JAX twin's default sizes, and the mesh examples also as
    a one-rank torchrun world (NCCL refuses two ranks on one card).
    async_workers's torchrun form takes its twin's ``--tiny`` schedule: at
    the default one its threaded and gossip servers alone hold the host
    for about 120 s (8 worker threads of host-bound block_gram solves),
    which its plain run, first in the list, already spends."""
    def ex(name, *args):
        return [str(EXAMPLES / f"{name}.py"), *args]

    torchrun = ["-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "1"]
    return [
        ("async_workers --trace", ex("async_workers", "--trace", trace)),
        ("async_workers torchrun --tiny", torchrun + ex("async_workers", "--tiny")),
        ("train_lm_mtl", ex("train_lm_mtl")),
        ("serve_fleet", ex("serve_fleet")),
        ("serve_stream", ex("serve_stream")),
        ("quickstart", ex("quickstart")),
        ("distributed_workers", ex("distributed_workers")),
        ("distributed_workers torchrun", torchrun + ex("distributed_workers")),
        ("serve_batch gemma3-1b", ex("serve_batch")),
        ("serve_batch mamba2-780m", ex("serve_batch", "--arch", "mamba2-780m")),
        ("serve_batch --mtl", ex("serve_batch", "--mtl")),
        ("serve_stream --interleave", ex("serve_stream", "--interleave")),
    ]


def run_example(tag: str, argv: list) -> tuple:
    """One example in its own process group (so a torchrun's worker dies
    with it on a timeout): (tag, return code, wall s, stdout, stderr)."""
    import os
    import signal

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(SRC), env.get("PYTHONPATH")) if p)
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, *argv], cwd=ROOT, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=EXAMPLE_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        err += f"\n(killed after {EXAMPLE_TIMEOUT_S:.0f} s)"
    return tag, proc.returncode, time.perf_counter() - t0, out, err


def examples_path(card: str) -> dict:
    """Phase 15: every port example (examples/torch) on the card as a
    subprocess, EXAMPLES_AT_ONCE at a time, at the JAX examples' default
    sizes (the reduced LM configs are the examples' own; phases 5, 8-10
    and 12-14 run the same entry points at full width). Each must exit 0
    with its ``main``'s dict as its last line. Checks: the quickstart's gap
    shrinks; max |W_dist - W_ref| <= TOL_W (both mesh forms); async
    reaches the target in no more ticks than sync, the threaded server's
    max lag <= tau, the trace file holds spans; no served version
    regresses (stream, fleet); the interleaved shorts finish before the
    longest generation; each LM example's K3, K3-bwd and K4 launches
    equal what its reduced config's layers give. Returns the launches by
    path."""
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.configs import get_config

    tmp = tempfile.mkdtemp(prefix="chip_smoke_examples_")
    trace = str(Path(tmp) / "trace.json")
    t0 = time.perf_counter()
    try:
        with ThreadPoolExecutor(EXAMPLES_AT_ONCE) as pool:
            runs = list(pool.map(lambda r: run_example(*r), example_runs(trace)))
        total = time.perf_counter() - t0
        results = {}
        for tag, rc, wall, out, err in runs:
            lines = out.strip().splitlines()
            if rc != 0 or not lines:
                print(out[-2000:])
                fail(f"[15 {tag}] exited {rc}: {err[-3000:]}")
            try:
                res = json.loads(lines[-1])
            except json.JSONDecodeError:
                fail(f"[15 {tag}] the last line is not main's dict: {lines[-1][:200]!r}")
            results[tag] = res
            shown = {}
            for k, v in res.items():  # scalars, and one level of nested dicts
                if isinstance(v, dict):
                    shown.update({f"{k}.{i}": x for i, x in v.items()
                                  if not isinstance(x, (list, dict))})
                elif not isinstance(v, list):
                    shown[k] = v
            print(f"[15 {tag}] exit 0 in {wall:.1f} s wall ({EXAMPLES_AT_ONCE} examples at "
                  f"once) on {card}; {json.dumps(shown)}")
        with open(trace) as f:
            spans = json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    spans = spans["traceEvents"] if isinstance(spans, dict) else spans

    q = results["quickstart"]
    check(q["gap_last"] < q["gap_first"], f"[15 quickstart] gap {q['gap_first']} -> "
          f"{q['gap_last']}")
    for tag in ("distributed_workers", "distributed_workers torchrun"):
        d = results[tag]
        check(d["max_abs_w_diff"] <= TOL_W, f"[15 {tag}] max|W_dist - W_ref| "
              f"{d['max_abs_w_diff']:.3e} over {TOL_W:.0e}")
    for tag in ("async_workers --trace", "async_workers torchrun --tiny"):
        a = results[tag]
        check(a["ticks_async"] <= a["ticks_sync"], f"[15 {tag}] async took "
              f"{a['ticks_async']} ticks to the target, sync {a['ticks_sync']}")
        check(a["threaded"]["max_lag"] <= EXAMPLE_TAU,
              f"[15 {tag}] threaded max lag {a['threaded']['max_lag']} over tau")
    traced = results["async_workers --trace"]["trace"]
    check(traced["spans"] > 0 and len(spans) > 0,
          "[15 async_workers --trace] the trace holds no spans")
    print(f"[15 async_workers --trace] {traced['spans']} spans; inclusive host wall by phase "
          f"(summed over the worker threads): " + ", ".join(
              f"{r['name']} {r['count']} x = {r['total_s']:.1f} s" for r in traced["top"])
          + f" on {card}")
    check(results["serve_stream"]["monotonic"], "[15 serve_stream] a served version regressed")
    check(results["serve_fleet"]["monotonic_reads"],
          "[15 serve_fleet] a client saw the model version regress")
    inter = results["serve_stream --interleave"]
    check(inter["short_max_latency_ms"] < inter["long_max_latency_ms"],
          "[15 serve_stream --interleave] head-of-line blocking")

    def layers(arch):
        cfg = get_config(arch).reduced()
        return (*attention_and_ssm_layers(cfg), 2 if cfg.remat else 1)

    steps = results["train_lm_mtl"]["steps"]
    n_attn, _, fwd = layers("gemma3-1b")
    expected = {
        "serve_batch gemma3-1b": {"K3": 3 * layers("gemma3-1b")[0]},  # 3 prefills
        "serve_batch mamba2-780m": {"K4": 3 * layers("mamba2-780m")[1]},
        "serve_stream --interleave": {"K3": inter["completed"] * layers("qwen1_5-4b")[0]},
        "train_lm_mtl": {"K3": (fwd * steps + FEATURE_BATCHES) * n_attn,
                         "K3-bwd": steps * n_attn},
    }
    by_path = {}
    for tag, want in expected.items():
        got = results[tag]["launches"]
        want = {k: want.get(k, 0) for k in got}
        check(got == want, f"[15 {tag}] launches {got}, expected {want}")
        by_path[f"15 {tag}"] = got
    print("[15 launches] " + "; ".join(f"{k}: {v}" for k, v in by_path.items()))
    print(f"[15] {total:.1f} s wall for {len(runs)} runs, {EXAMPLES_AT_ONCE} at once (budget "
          f"{EXAMPLES_BUDGET_S:.0f} s) on {card}")
    return by_path


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
    from repro_torch.kernels import flash, nvcc, prng as prng_kernels, sdca, ssd
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
    seconds = nvcc.build_all(sdca.SOURCES + flash.SOURCES + ssd.SOURCES
                             + prng_kernels.SOURCES)
    print(f"[1 build] {time.perf_counter() - t0:.2f} s wall; per source: "
          + ", ".join(f"{k} {v:.2f} s" for k, v in seconds.items()))
    log = nvcc.BUILD_DIR / "ssd_chunk_bwd.log"  # nvcc -Xptxas -v of this build
    if seconds.get("ssd_chunk_bwd") and log.exists():
        lines = [ln.strip() for ln in log.read_text().splitlines()
                 if "registers" in ln or "spill" in ln]
        print("[1 build] ssd_chunk_bwd ptxas: " + "; ".join(lines))

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
    stage1 = dict(ms=stage_ms[0], **stage1_bound(M, H, D))
    print(f"[2 sdca_round] stage 1 (Gram, q) {stage_ms[0]:.4f} ms, bound "
          f"{stage1['bound_ms']:.4f} ms by {stage1['bound_by']}; stage 2 (chains, cluster "
          f"{sdca_kernel.round_cluster(M, D, BLOCK, sms)}) {stage_ms[1]:.4f} ms; round by cluster size: "
          + ", ".join(f"C={c} {t:.4f} ms" for c, t in cluster_ms.items())
          + f"; chain floor {floor_ms[0]:.3f}-{floor_ms[1]:.3f} ms ({H} steps x 60-100 "
          f"cycles at {sm_clock} MHz)")
    plain_round = cuda_ms(torch, lambda: ref.sdca_round_ref(
        x, y, alpha, w, u, n, kappa, "hinge"), reps=1)
    coords = coords_from_uniform(u, n, N_MAX)
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
    e_round, e_block = empty_task_checks(torch, dev, syn.train)
    err_round, err_block = max(err_round, e_round), max(err_block, e_block)
    e_many, stage1_many = round_at_many_tasks(torch, dev, card, many_train, sm_clock)
    err_round = max(err_round, e_many)
    del many_train
    mds_round = round_at_mds_width(torch, dev, card, sm_clock)
    mds_round["stream_at_cell_widths"] = stream_at_cell_widths(torch, dev, card)
    del shapes, sx, sy, s_alpha, s_w, s_r
    del alpha, w, u, r_state
    draw = threefry_draw_checks(torch, dev, card)
    lm = lm_kernel_checks(torch, dev, card)
    lm["flash_bwd"] = flash_bwd_checks(torch, dev, card)
    lm["ssd_bwd"] = ssd_bwd_checks(torch, dev, card)

    # -- phase 3: the main path at MNIST width -------------------------------
    cfg = dict(solver="pallas_round", loss="hinge", lam=1e-4, outer_iters=2,
               rounds=5, local_iters=0, block_size=BLOCK)
    est = DMTRLEstimator(engine="reference", device="cuda", **cfg)
    reset_launch_counts()
    draws_before = prng_kernels.threefry_draw.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est.fit(train)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches_round = sdca_round_kernel.launches
    launches_draw = prng_kernels.threefry_draw.launches - draws_before
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
    check(launches_draw == n_rounds,
          f"threefry_draw launched {launches_draw} times, expected {n_rounds}")
    # phase 3's fit as phase 11 compares with it (partial_fit moves est below)
    ref3 = SimpleNamespace(W_=est.W_.clone(), sigma_=est.sigma_.clone())
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
    events = device_events(prof)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"[3 profile] warm partial_fit: {warm_s * 1e3 / n_rounds:.1f} ms/round wall "
          f"(profiler on), device busy {busy_ms / n_rounds:.1f} ms/round = "
          f"{busy_ms / (warm_s * 1e3):.1%} of wall; gap "
          f"{est.history['gap'][-1]:.5f}")
    for e in sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:6]:
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

    # -- phase 5: the LM serving path; 5b: its fp32 consistency; 5c: streaming
    launches_flash, launches_ssd, lm_cfg = serve_main_path(torch, dev, card)
    consistency(torch, dev, lm_cfg, "5b consistency")
    t5 = time.perf_counter()
    stream_launches = serve_streaming(torch, dev, card, lm_cfg)
    print(f"[5c] {time.perf_counter() - t5:.1f} s wall")

    # -- phase 6: the MTL serving path; 6c: structured Sigma at 4096 tasks -----
    t6 = time.perf_counter()
    mtl_serving_path(torch, dev, card, est, train, test)
    ref6c = structured_path(torch, dev, card, many)
    print(f"[6] {time.perf_counter() - t6:.1f} s wall")

    # -- phase 7: the parameter server; 7d: the paper's claims ---------------
    t7 = time.perf_counter()
    parameter_server_path(torch, dev, card, train, syn)
    paper_claims(torch, dev, card, est, train)
    print(f"[7] {time.perf_counter() - t7:.1f} s wall")

    # -- phase 8: the dense and SSM LM families; 8e: the DMTRL bridge --------
    t8 = time.perf_counter()
    by_path = lm_families(torch, dev, card)
    print(f"[8] {time.perf_counter() - t8:.1f} s wall")
    # -- phase 9: the MoE, VLM and encoder-decoder LM families -------------
    t9 = time.perf_counter()
    by_path.update(lm_zoo(torch, dev, card))
    print(f"[9] {time.perf_counter() - t9:.1f} s wall")
    # -- phase 10: training; 10d: mamba2-780m through K4 and K4-bwd ---------
    t10 = time.perf_counter()
    launches_10a, peak_10a, step_10a = train_main_path(torch, dev, card, "gemma3-1b", "10a",
                                                       min_drop=0.5)
    train_by_path = {"10a gemma3-1b train": launches_10a}
    train_by_path.update(train_card_against_cpu(torch, dev, card))
    train_by_path["10c launcher whisper-tiny"] = train_launcher(torch, dev, card)
    launches_10d, peak_10d, step_10d = train_main_path(torch, dev, card, "mamba2-780m", "10d",
                                                       min_drop=0.0)
    train_by_path["10d mamba2-780m train"] = launches_10d
    print(f"[10] {time.perf_counter() - t10:.1f} s wall")
    # -- phase 11: the mesh engines (distributed, simulated transport) -------
    t11 = time.perf_counter()
    mesh_launches = mesh_engines_path(torch, dev, card, train, syn, ref3, ref_est, many, ref6c)
    print(f"[11] {time.perf_counter() - t11:.1f} s wall")
    # -- phase 12: the LM zoo's sharded train step on one position ----------
    t12 = time.perf_counter()
    train_by_path.update(sharded_train_path(torch, dev, card, "gemma3-1b", "12a", peak_10a))
    train_by_path.update(sharded_train_path(torch, dev, card, "mamba2-780m", "12b", peak_10d))
    print(f"[12] {time.perf_counter() - t12:.1f} s wall")
    # -- phase 13: the dry run and the roofline ------------------------------
    t13 = time.perf_counter()
    train_by_path["13a gemma3-1b counted step"] = dryrun_against_card(
        torch, dev, card, "gemma3-1b", "13a", step_10a)
    train_by_path["13a mamba2-780m counted step"] = dryrun_against_card(
        torch, dev, card, "mamba2-780m", "13a", step_10d)
    mesh_launches.update(dmtrl_dryrun_against_card(torch, dev, card, many.train.to(dev)))
    dryrun_table(card)
    print(f"[13] {time.perf_counter() - t13:.1f} s wall")
    # -- phase 14: the sharded serving step on one position -----------------
    t14 = time.perf_counter()
    for i, arch in enumerate(SERVE_SHARDED):
        train_by_path.update(sharded_serve_path(torch, dev, card, arch, f"14{'ab'[i]}"))
    print(f"[14] {time.perf_counter() - t14:.1f} s wall")
    # -- phase 15: the examples on the port, each its own process -----------
    train_by_path.update(examples_path(card))

    def by_kernel(name):
        return {k: v[name] for k, v in {"5c zamba2-2.7b stream": stream_launches,
                                         **train_by_path}.items() if v[name]}

    flash_by_path = {"5 zamba2-2.7b": launches_flash, **{
        k: (v["flash"] if isinstance(v, dict) else v[0]) for k, v in by_path.items()},
        **by_kernel("K3")}
    ssd_by_path = {"5 zamba2-2.7b": launches_ssd, **{
        k: v[1] for k, v in by_path.items() if not isinstance(v, dict)}, **by_kernel("K4")}

    kernels = [
        dict(name="sdca_round", route="cuda",
             source="src/repro_torch/kernels/sdca/csrc/sdca_round.cu",
             replaces="src/repro/kernels/sdca/sdca_kernel.py:261",
             launches=launches_round, max_abs_err=err_round, ms=ms_round,
             plain_ms=plain_round, bound_ms=b_round, bound_by=by_round,
             library_ms=None, mds_width=mds_round,
             stage1={"mnist": stage1, "4096 tasks": stage1_many,
                     "synthetic1": mds_round["stream_at_cell_widths"]["synthetic1.fit"]["stage1"]},
             launches_by_path={
                 "3 fit": launches_round, "8e bridge": by_path["8e bridge"]["sdca_round"],
                 **{k: v["sdca_round"] for k, v in mesh_launches.items() if v["sdca_round"]}}),
        dict(name="sdca_block", route="cuda",
             source="src/repro_torch/kernels/sdca/csrc/sdca_block.cu",
             replaces="src/repro/kernels/sdca/sdca_kernel.py:143",
             launches=launches_block, max_abs_err=err_block, ms=ms_block,
             plain_ms=plain_block, bound_ms=b_block, bound_by=by_block,
             library_ms=None, launches_by_path={
                 "4 synthetic1": launches_block,
                 **{k: v["sdca_block"] for k, v in mesh_launches.items() if v["sdca_block"]}}),
        # no TPU kernel: the JAX package draws with jax.random's threefry
        dict(name="threefry_draw", route="cuda",
             source="src/repro_torch/kernels/prng/csrc/threefry_draw.cu",
             replaces=None, launches=launches_draw, max_abs_err=0.0,
             library_ms=None, launches_by_path={"3 fit": launches_draw},
             **draw["MNIST"], by_shape=draw),
        dict(name="flash_fwd", route="cuda",
             source="src/repro_torch/kernels/flash/csrc/flash_fwd.cu",
             replaces="src/repro/kernels/flash/flash_kernel.py:84",
             launches=launches_flash, launches_by_path=flash_by_path, **lm["flash"]),
        dict(name="ssd_chunk", route="cuda",
             source="src/repro_torch/kernels/ssd/csrc/ssd_chunk.cu",
             replaces="src/repro/kernels/ssd/ssd_kernel.py:70",
             launches=launches_ssd, launches_by_path=ssd_by_path, **lm["ssd"]),
        # no TPU kernel: the JAX package differentiates its jnp attention
        dict(name="flash_bwd", route="cuda",
             source="src/repro_torch/kernels/flash/csrc/flash_bwd.cu",
             replaces="src/repro/models/attention.py:68",
             launches=train_by_path["10a gemma3-1b train"]["K3-bwd"],
             launches_by_path=by_kernel("K3-bwd"), **lm["flash_bwd"]),
        # no TPU kernel: the JAX package differentiates its jnp ssd_chunked
        dict(name="ssd_chunk_bwd", route="cuda",
             source="src/repro_torch/kernels/ssd/csrc/ssd_chunk_bwd.cu",
             replaces="src/repro/models/ssm.py:84",
             launches=train_by_path["10d mamba2-780m train"]["K4-bwd"],
             launches_by_path=by_kernel("K4-bwd"), **lm["ssd_bwd"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
