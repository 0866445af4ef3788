// Mamba2 SSD chunk-local computation for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/ssd/ssd_kernel.py
// (`ssd_chunk_kernel`, `_kernel`). Per (batch, head, chunk) of Q steps,
// all fp32:
//   cum     = cumsum(dt * A)                          (Q,)
//   Y_intra = ((C B^T) o exp(cum_t - cum_tau) . [tau <= t]) @ (dt x)   (Q, P)
//   S_local = (B * exp(cum_Q - cum))^T @ (dt x)       (N, P)
//   a_tot   = exp(cum_Q)
// The inter-chunk recurrence over (a_tot, S_local) stays outside, in
// ops.ssd_forward.
//
// Design. One CTA of 256 threads per (chunk, head, batch), the TPU kernel's
// grid cell. The chunk's u = dt x, B and C live in shared memory for the
// whole cell (Q, N, P <= 128: up to 215 KB, so the dynamic shared memory
// limit is raised above 48 KB). The cumulative log-decay is a warp scan.
// Y_intra never forms the whole Q x Q matrix: it walks tau in tiles of 32
// columns, forms that slice of (C B^T) o M in shared memory and adds its
// product with u's rows into per-thread registers.
//
// The masked exponential: cum falls by up to |A| dt per step (|A| <= 16,
// dt up to about 0.3 in Mamba2), so cum_t - cum_tau for tau > t reaches
// +100 and more, and exp overflows to inf; the TPU kernel takes exp of the
// whole matrix and masks afterwards with `where`. Multiplying inf by a 0
// mask gives NaN, so this kernel evaluates exp(cum_t - cum_tau) only where
// tau <= t (there it is <= 1) and writes 0 elsewhere.
//
// Bound. At the prefill shape (B=1, H=80, nc=8, Q=P=N=64) a cell does
// 2*(Q(Q+1)/2)*(N+P) + 2*Q*N*P = 1.06 MFLOP and moves about 82 KB (x, B,
// C in; Y and S out); over 640 cells that is 0.68 GFLOP at the H100's
// 67 TFLOP/s fp32 (10 us) against 52.6 MB at 3.35 TB/s (15.7 us), so the
// bytes bound it. This first version computes with fp32 FMAs from shared
// memory; tensor-core (TF32 or split-bf16) products are later work.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;  // 16 x 16 thread grid over output tiles
constexpr int MAXD = 128;     // Q, N, P <= MAXD
constexpr int MAX_I = MAXD / 16;
constexpr int TT = 32;        // tau columns per tile of (C B^T) o M

__global__ void __launch_bounds__(THREADS) ssd_chunk_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const float* __restrict__ Bm,
    const float* __restrict__ Cm, float* __restrict__ y, float* __restrict__ s_out,
    float* __restrict__ a_tot, int H, int nc, int Q, int P, int N) {
  extern __shared__ float smem[];
  float* cum = smem;              // [MAXD] inclusive cumulative log-decay
  float* dend = cum + MAXD;       // [MAXD] exp(cum_Q - cum)
  float* dts = dend + MAXD;       // [MAXD]
  float* us = dts + MAXD;         // [Q][P]   dt x
  float* Bs = us + Q * P;         // [Q][N+1] (padded: lanes read columns)
  float* Cs = Bs + Q * (N + 1);   // [Q][N]
  float* Gt = Cs + Q * N;         // [Q][TT+1] one tile of (C B^T) o M

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t cell = ((size_t)blockIdx.z * H + blockIdx.y) * nc + blockIdx.x;
  const float a = A[blockIdx.y];

  for (int t = tid; t < Q; t += THREADS) dts[t] = dt[cell * Q + t];
  __syncthreads();

  if (tid < 32) {
    // lane l sums steps [l*E, l*E + E) in order, then a warp scan of the
    // lane sums gives each lane its offset
    const int E = (Q + 31) / 32;  // <= 4
    float loc[MAXD / 32];
    float run = 0.f;
#pragma unroll
    for (int e = 0; e < MAXD / 32; ++e) {
      const int t = tid * E + e;
      if (e < E && t < Q) run += dts[t] * a;
      loc[e] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, incl, off);
      if (tid >= off) incl += up;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (tid == 0) excl = 0.f;
#pragma unroll
    for (int e = 0; e < MAXD / 32; ++e) {
      const int t = tid * E + e;
      if (e < E && t < Q) cum[t] = excl + loc[e];
    }
  }
  for (int idx = tid; idx < Q * P; idx += THREADS)
    us[idx] = x[cell * Q * P + idx] * dts[idx / P];
  for (int idx = tid; idx < Q * N; idx += THREADS) {
    const int t = idx / N, n = idx - t * N;
    Bs[t * (N + 1) + n] = Bm[cell * Q * N + idx];
    Cs[idx] = Cm[cell * Q * N + idx];
  }
  __syncthreads();
  for (int t = tid; t < Q; t += THREADS) dend[t] = expf(cum[Q - 1] - cum[t]);

  // ---- Y_intra: rows t = ty + 16i, columns p = tx + 16j -------------------
  float acc[MAX_I][MAX_I];
#pragma unroll
  for (int i = 0; i < MAX_I; ++i)
#pragma unroll
    for (int j = 0; j < MAX_I; ++j) acc[i][j] = 0.f;

  for (int t0 = 0; t0 < Q; t0 += TT) {
    __syncthreads();  // the previous tile's products are done with Gt
    for (int idx = tid; idx < Q * TT; idx += THREADS) {
      const int t = idx / TT, tl = idx - t * TT, tau = t0 + tl;
      float g = 0.f;
      if (tau <= t) {  // exp only below the diagonal, where it is <= 1
        float cb = 0.f;
        for (int n = 0; n < N; ++n) cb = fmaf(Cs[t * N + n], Bs[tau * (N + 1) + n], cb);
        g = cb * expf(cum[t] - cum[tau]);
      }
      Gt[t * (TT + 1) + tl] = g;
    }
    __syncthreads();
    const int tl_end = min(TT, Q - t0);
    for (int tl = 0; tl < tl_end; ++tl) {
      const float* urow = us + (t0 + tl) * P;
      float uv[MAX_I];
#pragma unroll
      for (int j = 0; j < MAX_I; ++j) uv[j] = (tx + 16 * j < P) ? urow[tx + 16 * j] : 0.f;
#pragma unroll
      for (int i = 0; i < MAX_I; ++i) {
        if (ty + 16 * i < Q) {
          const float g = Gt[(ty + 16 * i) * (TT + 1) + tl];
#pragma unroll
          for (int j = 0; j < MAX_I; ++j) acc[i][j] = fmaf(g, uv[j], acc[i][j]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < MAX_I; ++i)
#pragma unroll
    for (int j = 0; j < MAX_I; ++j) {
      const int t = ty + 16 * i, p = tx + 16 * j;
      if (t < Q && p < P) y[cell * Q * P + t * P + p] = acc[i][j];
    }

  // ---- S_local: rows n = ty + 16i, columns p = tx + 16j -------------------
#pragma unroll
  for (int i = 0; i < MAX_I; ++i)
#pragma unroll
    for (int j = 0; j < MAX_I; ++j) acc[i][j] = 0.f;
  for (int t = 0; t < Q; ++t) {
    const float d = dend[t];
    float bv[MAX_I], uv[MAX_I];
#pragma unroll
    for (int i = 0; i < MAX_I; ++i)
      bv[i] = (ty + 16 * i < N) ? Bs[t * (N + 1) + ty + 16 * i] * d : 0.f;
#pragma unroll
    for (int j = 0; j < MAX_I; ++j) uv[j] = (tx + 16 * j < P) ? us[t * P + tx + 16 * j] : 0.f;
#pragma unroll
    for (int i = 0; i < MAX_I; ++i)
#pragma unroll
      for (int j = 0; j < MAX_I; ++j) acc[i][j] = fmaf(bv[i], uv[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < MAX_I; ++i)
#pragma unroll
    for (int j = 0; j < MAX_I; ++j) {
      const int n = ty + 16 * i, p = tx + 16 * j;
      if (n < N && p < P) s_out[cell * N * P + n * P + p] = acc[i][j];
    }
  if (tid == 0) a_tot[cell] = expf(cum[Q - 1]);
}

}  // namespace

// x: (B, H, nc, Q, P); dt: (B, H, nc, Q); A: (H,); Bm, Cm: (B, H, nc, Q, N);
// y: (B, H, nc, Q, P); s: (B, H, nc, N, P); a_tot: (B, H, nc). fp32,
// row-major. Returns the launch's cudaError_t (0 on success).
extern "C" int ssd_chunk_launch(const void* x, const void* dt, const void* A,
                                const void* Bm, const void* Cm, void* y, void* s,
                                void* a_tot, int B, int H, int nc, int Q, int P, int N,
                                void* stream) {
  if (Q < 1 || Q > MAXD || P < 1 || P > MAXD || N < 1 || N > MAXD)
    return cudaErrorInvalidValue;
  const size_t smem =
      (size_t)(3 * MAXD + Q * P + Q * (N + 1) + Q * N + Q * (TT + 1)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(nc, H, B);
  ssd_chunk_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<float*>(y), static_cast<float*>(s),
      static_cast<float*>(a_tot), H, nc, Q, P, N);
  return cudaGetLastError();
}
