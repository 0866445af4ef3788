// Flash-attention forward (causal / sliding-window) for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/flash/flash_kernel.py
// (`flash_attention`, `_kernel`): softmax(q k^T * scale + mask) v over
// (B, H, S, HD) tensors, bf16 or fp32 in, fp32 math, q's dtype out.
//
// Design. One CTA of 256 threads per (64-row q block, head, batch). The
// TPU kernel walks the kv blocks as the innermost, sequential grid axis and
// carries the online-softmax state (m, l, acc) in VMEM scratch between grid
// steps; here a loop inside the CTA walks them, and the state never leaves
// the SM: m and l in shared memory, acc (64 x HD) in registers, four rows
// by HD/16 columns per thread. Each kv step stages K (transposed) and V as
// fp32 in shared memory, forms the 64 x 64 score tile, updates m and l one
// warp per row, and accumulates p v.
//
// The masks and the sentinel are the TPU kernel's: a masked score is
// NEG_INF = -1e30 (finite, so a row whose first blocks are all masked
// takes exp(0) = 1 there and is rescaled by exp(-1e30 - m) = 0 once a real
// key arrives, exactly as on the TPU), and the output divides by
// max(l, 1e-30). The TPU kernel runs fully masked kv blocks; this one
// starts at the first block the window reaches and stops at the last block
// the causal mask reaches. For a causal call with Sk >= S every row keeps
// its diagonal key, so the skipped blocks would add exp(-1e30 - m) = 0 and
// the result is the same. Keys past Sk (the ragged last tile) score -inf
// and are zero-filled, so they add nothing to l or acc.
//
// Bound. At the prefill shape (B=1, H=32, S=512, HD=80, causal) the work
// is 4*H*HD*S(S+1)/2 = 1.35 GFLOP and the bytes are q, k, v, o once each
// (10.5 MB in bf16); on an H100 the bytes bound it (3.1 us at 3.35 TB/s
// against 1.4 us at 989 TFLOP/s). This first version does its products
// with fp32 FMAs from shared memory, not with the tensor cores, so it is
// bound by those FMAs: wgmma with TMA-fed tiles is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;            // query rows per CTA
constexpr int BK = 64;            // keys per kv step
constexpr int THREADS = 256;      // 16 x 16 thread grid over (rows, cols)
constexpr int MAX_J = 8;          // HD / 16 columns per thread: HD <= 128
constexpr int KT_STRIDE = BK + 1; // padded rows of the transposed K tile
constexpr int S_STRIDE = BK + 1;  // padded rows of the score tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int H, int S, int Sk, int HD, int causal, int window,
    float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                 // [BQ][HD]
  float* Kt = Qs + BQ * HD;         // [HD][KT_STRIDE]
  float* Vs = Kt + HD * KT_STRIDE;  // [BK][HD]
  float* Ss = Vs + BK * HD;         // [BQ][S_STRIDE] scores, then p
  float* m_s = Ss + BQ * S_STRIDE;  // [BQ] running max
  float* l_s = m_s + BQ;            // [BQ] running denominator
  float* c_s = l_s + BQ;            // [BQ] this step's correction

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * BQ;
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  const T* qg = q + bh * S * HD;
  const T* kg = k + bh * Sk * HD;
  const T* vg = v + bh * Sk * HD;
  T* og = o + bh * S * HD;
  const int nj = HD / 16;

  for (int idx = tid; idx < BQ * HD; idx += THREADS) {
    const int r = idx / HD;
    Qs[idx] = (q0 + r < S) ? to_f(qg[(size_t)q0 * HD + idx]) : 0.f;
  }
  for (int r = tid; r < BQ; r += THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }

  float acc[4][MAX_J];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < MAX_J; ++j) acc[i][j] = 0.f;

  const int nk = (Sk + BK - 1) / BK;
  int kb_begin = 0, kb_end = nk;
  if (causal) {
    kb_end = min(nk, (q0 + BQ - 1) / BK + 1);
    if (window > 0) kb_begin = max(0, q0 - window + 1) / BK;
  }

  for (int kb = kb_begin; kb < kb_end; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();  // the previous step is done with Kt, Vs and Ss
    for (int idx = tid; idx < BK * HD; idx += THREADS) {
      const int c = idx / HD, d = idx - c * HD;
      const bool in = k0 + c < Sk;
      const size_t g = (size_t)k0 * HD + idx;
      Kt[d * KT_STRIDE + c] = in ? to_f(kg[g]) : 0.f;
      Vs[idx] = in ? to_f(vg[g]) : 0.f;
    }
    __syncthreads();

    // scores of rows ty + 16i against keys tx + 16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * HD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Kt[d * KT_STRIDE + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const int qp = q0 + r, kp = k0 + c;
        bool keep = true;
        if (causal) keep = keep && kp <= qp;
        if (window > 0) keep = keep && kp > qp - window;
        float val = keep ? s[i][j] * scale : NEG_INF;
        if (kp >= Sk) val = -INFINITY;
        Ss[r * S_STRIDE + c] = val;
      }
    __syncthreads();

    // online softmax: warp w owns rows 8w .. 8w+7, two keys per lane
    for (int rr = 0; rr < BQ / 8; ++rr) {
      const int r = warp * (BQ / 8) + rr;
      float* row = Ss + r * S_STRIDE;
      const float a0 = row[lane], a1 = row[lane + 32];
      float mx = fmaxf(a0, a1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = expf(a0 - m_new), p1 = expf(a1 - m_new);
      row[lane] = p0;
      row[lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + p v
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < MAX_J; ++j) acc[i][j] *= corr;
    }
    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ss[(ty + 16 * i) * S_STRIDE + c];
#pragma unroll
      for (int j = 0; j < MAX_J; ++j) {
        if (j < nj) {
          const float vv = Vs[c * HD + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= S) continue;
    const float denom = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < MAX_J; ++j)
      if (j < nj) og[(size_t)(q0 + r) * HD + tx + 16 * j] = from_f<T>(acc[i][j] / denom);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int S, int Sk, int HD, int causal, int window, float scale,
           cudaStream_t stream) {
  const size_t smem =
      (size_t)(BQ * HD + HD * KT_STRIDE + BK * HD + BQ * S_STRIDE + 3 * BQ) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, S, Sk, HD, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// q, o: (B, H, S, HD); k, v: (B, H, Sk, HD); all of one dtype, row-major.
// Returns the launch's cudaError_t (0 on success).
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v, void* o,
                                int B, int H, int S, int Sk, int HD, int causal,
                                int window, float scale, int is_bf16, void* stream) {
  if (HD <= 0 || HD % 16 != 0 || HD > 16 * MAX_J || S <= 0 || Sk <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, o, B, H, S, Sk, HD, causal, window, scale, st);
  return launch<float>(q, k, v, o, B, H, S, Sk, HD, causal, window, scale, st);
}
