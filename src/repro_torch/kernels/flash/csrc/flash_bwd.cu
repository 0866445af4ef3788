// Flash-attention backward (K3-bwd) for sm_90a: dQ, dK and dV of
// O = softmax(q k^T * scale + mask) v.
//
// No TPU kernel stands behind it: the JAX package trains through its jnp
// `chunked_attention` (src/repro/models/attention.py) and lets autodiff
// form the gradient. The port runs K3 (flash_fwd.cu) where JAX runs that
// function, so the gradient through K3 needs a kernel of its own. It takes
// the same strided (B, H, rows, HD) views and the same masks as the
// forward: causal, sliding window, non-causal, Sk != S and a ragged last
// tile, fp32 or bf16 in (fp32 math), HD any multiple of 16 up to 256.
//
// Inputs: q, k, v, the forward's output o, its gradient dO, and the row
// log-sum-exp lse (B, H, S) fp32 that flash_fwd_launch stores in log2
// units of the scaled scores, so P = 2^(s scale log2(e) - lse) is
// recomputed without a softmax pass. Three launches on one stream:
//   1. flash_bwd_dot_kernel: D = rowsum(dO o) (B, H, S) fp32, one warp a row;
//   2. flash_bwd_dkdv_kernel: one CTA per (BR-key block, head, batch) keeps
//      its K and V tiles in shared memory and accumulates dK and dV in
//      registers over the query blocks that see it:
//        S = Q K^T, P = 2^(S scale log2(e) - lse), dP = dO V^T,
//        dS = P (dP - D), dV += P^T dO, dK += dS^T Q (times scale at the end);
//   3. flash_bwd_dq_kernel: one CTA per (BR-row query block, head, batch)
//      walks the key blocks its rows see and accumulates dQ += dS K. This
//      second pass recomputes S and dP instead of adding dQ with atomics, so
//      the result does not depend on the order the CTAs run in.
// Both passes skip the blocks that the causal mask or the window hide
// entirely, as the forward does; inside a block the mask is per element
// and keys past Sk or rows past S get P = 0.
//
// Design: the simple one. 256 threads as a 16 x 16 grid over (rows, keys)
// or (rows, head-dim columns) of each tile, fp32 FMAs from shared memory
// (bf16 inputs are widened as they are staged). BR = 64 up to HD = 128 and
// BR = 32 above it, so the four staged tiles (K, V, Q, dO at HD + 1 floats
// a row, an odd stride that keeps column reads conflict-free) and the P
// and dS tiles fit the 227 KB of shared memory: 166 KB at HD = 128, 140 KB
// at HD = 256. Each thread keeps BR/16 rows x HD/16 columns of its two
// accumulators (64 registers). Bound: on an H100 the backward of a long
// causal sequence is bound by operations (five products of 2 HD flops per
// kept (query, key) pair); this kernel's shared-memory loads, not the
// tensor cores, set its pace. mma.sync / wgmma tiles are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // a 16 x 16 thread grid
constexpr int MAX_HD = 256;
constexpr float LOG2E = 1.4426950408889634f;

// element strides (batch, head, row) of one (B, H, rows, HD) view
struct View {
  long long b, h, s;
};
struct Views {
  View q, k, v, o, dout, dq, dk, dv;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// rows [row0, row0 + rows) of a (n_rows, HD) view with row stride rs into a
// [rows][ld] fp32 tile; rows at or past n_rows are zero-filled
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src, long long rs,
                                          int row0, int n_rows, int rows, int HD) {
  for (int idx = threadIdx.x; idx < rows * HD; idx += THREADS) {
    const int r = idx / HD, d = idx - r * HD;
    dst[r * ld + d] = (row0 + r < n_rows) ? to_f(src[(long long)(row0 + r) * rs + d]) : 0.f;
  }
}

// D = rowsum(dO o) for every (b, h, row), one warp a row
template <typename T>
__global__ void __launch_bounds__(THREADS) flash_bwd_dot_kernel(
    const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ D, int H, int S,
    int HD, View vo, View vd, long long total_rows) {
  const long long row = (long long)blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= total_rows) return;  // the whole warp leaves together
  const int s = (int)(row % S);
  const long long bh = row / S;
  const int h = (int)(bh % H), b = (int)(bh / H);
  const T* orow = o + b * vo.b + h * vo.h + s * vo.s;
  const T* drow = dout + b * vd.b + h * vd.h + s * vd.s;
  float acc = 0.f;
  for (int d = lane; d < HD; d += 32) acc = fmaf(to_f(orow[d]), to_f(drow[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) D[row] = acc;
}

// P and dS = P (dP - D) of the query rows [q0, q0 + BR) against the keys
// [k0, k0 + BR), from the staged Q, dO, K and V tiles; thread (ty, tx) forms
// rows ty + 16a against keys tx + 16c. Writes P to Ps (when given) and dS
// to dSs, both [BR][BR + 1].
template <int BR>
__device__ __forceinline__ void p_and_ds(const float* Qs, const float* dOs, const float* Ks,
                                         const float* Vs, const float* lse_s, const float* D_s,
                                         float* Ps, float* dSs, int HD, int q0, int k0, int S,
                                         int Sk, int causal, int window, float sl2) {
  constexpr int R = BR / 16;
  constexpr int LDP = BR + 1;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int ldh = HD + 1;
  float s[R][R], dp[R][R];
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int c = 0; c < R; ++c) s[a][c] = dp[a][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float qv[R], gv[R], kv[R], vv[R];
#pragma unroll
    for (int a = 0; a < R; ++a) {
      qv[a] = Qs[(ty + 16 * a) * ldh + d];
      gv[a] = dOs[(ty + 16 * a) * ldh + d];
    }
#pragma unroll
    for (int c = 0; c < R; ++c) {
      kv[c] = Ks[(tx + 16 * c) * ldh + d];
      vv[c] = Vs[(tx + 16 * c) * ldh + d];
    }
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int c = 0; c < R; ++c) {
        s[a][c] = fmaf(qv[a], kv[c], s[a][c]);
        dp[a][c] = fmaf(gv[a], vv[c], dp[a][c]);
      }
  }
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int c = 0; c < R; ++c) {
      const int r = ty + 16 * a, col = tx + 16 * c;
      const int qp = q0 + r, kp = k0 + col;
      bool keep = qp < S && kp < Sk;
      if (causal) keep = keep && kp <= qp;
      if (window > 0) keep = keep && kp > qp - window;
      const float p = keep ? exp2f(s[a][c] * sl2 - lse_s[r]) : 0.f;
      if (Ps != nullptr) Ps[r * LDP + col] = p;
      dSs[r * LDP + col] = p * (dp[a][c] - D_s[r]);
    }
}

// the shared-memory layout both passes use (floats)
template <int BR>
__host__ __device__ constexpr size_t smem_floats(int HD) {
  return (size_t)4 * BR * (HD + 1) + 2 * BR * (BR + 1) + 2 * BR;
}

// the row statistics of the query block at q0 (zero past S)
__device__ __forceinline__ void load_stats(float* lse_s, float* D_s, const float* lse_g,
                                           const float* D_g, int q0, int S, int rows) {
  for (int r = threadIdx.x; r < rows; r += THREADS) {
    const bool in = q0 + r < S;
    lse_s[r] = in ? lse_g[q0 + r] : 0.f;
    D_s[r] = in ? D_g[q0 + r] : 0.f;
  }
}

// MJ: the most head-dim columns a thread keeps (HD / 16 <= MJ)
template <typename T, int BR, int MJ>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ D,
    T* __restrict__ dk, T* __restrict__ dv, int S, int Sk, int HD, int causal, int window,
    float scale, Views st) {
  constexpr int R = BR / 16;
  constexpr int LDP = BR + 1;
  extern __shared__ float smem[];
  const int ldh = HD + 1;
  float* Ks = smem;
  float* Vs = Ks + BR * ldh;
  float* Qs = Vs + BR * ldh;
  float* dOs = Qs + BR * ldh;
  float* Ps = dOs + BR * ldh;
  float* dSs = Ps + BR * LDP;
  float* lse_s = dSs + BR * LDP;
  float* D_s = lse_s + BR;

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int k0 = blockIdx.x * BR;
  const int h = blockIdx.y, b = blockIdx.z;
  const T* qg = q + b * st.q.b + h * st.q.h;
  const T* kg = k + b * st.k.b + h * st.k.h;
  const T* vg = v + b * st.v.b + h * st.v.h;
  const T* gg = dout + b * st.dout.b + h * st.dout.h;
  const float* lse_g = lse + ((long long)b * gridDim.y + h) * S;
  const float* D_g = D + ((long long)b * gridDim.y + h) * S;
  const int nj = HD / 16;
  const float sl2 = scale * LOG2E;

  load_rows(Ks, ldh, kg, st.k.s, k0, Sk, BR, HD);
  load_rows(Vs, ldh, vg, st.v.s, k0, Sk, BR, HD);

  float dk_acc[R][MJ], dv_acc[R][MJ];
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int j = 0; j < MJ; ++j) dk_acc[a][j] = dv_acc[a][j] = 0.f;

  // the query blocks whose rows see a key of this block
  int qb_begin = 0, qb_end = (S + BR - 1) / BR;
  if (causal) {
    qb_begin = k0 / BR;  // row >= key
    if (window > 0) qb_end = min(qb_end, (k0 + BR + window - 2) / BR + 1);  // row < key + window
  }
  for (int qb = qb_begin; qb < qb_end; ++qb) {
    const int q0 = qb * BR;
    __syncthreads();  // the previous block is done with Qs, dOs, Ps and dSs
    load_rows(Qs, ldh, qg, st.q.s, q0, S, BR, HD);
    load_rows(dOs, ldh, gg, st.dout.s, q0, S, BR, HD);
    load_stats(lse_s, D_s, lse_g, D_g, q0, S, BR);
    __syncthreads();
    p_and_ds<BR>(Qs, dOs, Ks, Vs, lse_s, D_s, Ps, dSs, HD, q0, k0, S, Sk, causal, window, sl2);
    __syncthreads();
    // dV += P^T dO and dK += dS^T Q: keys ty + 16a, columns tx + 16j
    for (int r = 0; r < BR; ++r) {
      float pv[R], sv[R];
#pragma unroll
      for (int a = 0; a < R; ++a) {
        pv[a] = Ps[r * LDP + ty + 16 * a];
        sv[a] = dSs[r * LDP + ty + 16 * a];
      }
#pragma unroll
      for (int j = 0; j < MJ; ++j) {
        if (j < nj) {
          const float gv = dOs[r * ldh + tx + 16 * j], qv = Qs[r * ldh + tx + 16 * j];
#pragma unroll
          for (int a = 0; a < R; ++a) {
            dv_acc[a][j] = fmaf(pv[a], gv, dv_acc[a][j]);
            dk_acc[a][j] = fmaf(sv[a], qv, dk_acc[a][j]);
          }
        }
      }
    }
  }

  T* dkg = dk + b * st.dk.b + h * st.dk.h;
  T* dvg = dv + b * st.dv.b + h * st.dv.h;
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int kr = k0 + ty + 16 * a;
    if (kr >= Sk) continue;
#pragma unroll
    for (int j = 0; j < MJ; ++j)
      if (j < nj) {
        dkg[kr * st.dk.s + tx + 16 * j] = from_f<T>(dk_acc[a][j] * scale);
        dvg[kr * st.dv.s + tx + 16 * j] = from_f<T>(dv_acc[a][j]);
      }
  }
}

template <typename T, int BR, int MJ>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ D,
    T* __restrict__ dq, int S, int Sk, int HD, int causal, int window, float scale,
    Views st) {
  constexpr int R = BR / 16;
  constexpr int LDP = BR + 1;
  extern __shared__ float smem[];
  const int ldh = HD + 1;
  float* Ks = smem;
  float* Vs = Ks + BR * ldh;
  float* Qs = Vs + BR * ldh;
  float* dOs = Qs + BR * ldh;
  float* dSs = dOs + BR * ldh + BR * LDP;  // the P tile's room stays unused here
  float* lse_s = dSs + BR * LDP;
  float* D_s = lse_s + BR;

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  // the last query blocks see the most keys under a causal mask: start them first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BR;
  const int h = blockIdx.y, b = blockIdx.z;
  const T* qg = q + b * st.q.b + h * st.q.h;
  const T* kg = k + b * st.k.b + h * st.k.h;
  const T* vg = v + b * st.v.b + h * st.v.h;
  const T* gg = dout + b * st.dout.b + h * st.dout.h;
  const float* lse_g = lse + ((long long)b * gridDim.y + h) * S;
  const float* D_g = D + ((long long)b * gridDim.y + h) * S;
  const int nj = HD / 16;
  const float sl2 = scale * LOG2E;

  load_rows(Qs, ldh, qg, st.q.s, q0, S, BR, HD);
  load_rows(dOs, ldh, gg, st.dout.s, q0, S, BR, HD);
  load_stats(lse_s, D_s, lse_g, D_g, q0, S, BR);

  float dq_acc[R][MJ];
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int j = 0; j < MJ; ++j) dq_acc[a][j] = 0.f;

  // the key blocks these rows see (the forward's kv range at BR)
  const int nk = (Sk + BR - 1) / BR;
  int kb_begin = 0, kb_end = nk;
  if (causal) {
    kb_end = min(nk, (q0 + BR - 1) / BR + 1);
    if (window > 0) kb_begin = max(0, q0 - window + 1) / BR;
  }
  for (int kb = kb_begin; kb < kb_end; ++kb) {
    const int k0 = kb * BR;
    __syncthreads();  // the previous block is done with Ks and dSs
    load_rows(Ks, ldh, kg, st.k.s, k0, Sk, BR, HD);
    load_rows(Vs, ldh, vg, st.v.s, k0, Sk, BR, HD);
    __syncthreads();
    p_and_ds<BR>(Qs, dOs, Ks, Vs, lse_s, D_s, nullptr, dSs, HD, q0, k0, S, Sk, causal, window,
                 sl2);
    __syncthreads();
    // dQ += dS K: rows ty + 16a, columns tx + 16j
    for (int c = 0; c < BR; ++c) {
      float sv[R];
#pragma unroll
      for (int a = 0; a < R; ++a) sv[a] = dSs[(ty + 16 * a) * LDP + c];
#pragma unroll
      for (int j = 0; j < MJ; ++j) {
        if (j < nj) {
          const float kv = Ks[c * ldh + tx + 16 * j];
#pragma unroll
          for (int a = 0; a < R; ++a) dq_acc[a][j] = fmaf(sv[a], kv, dq_acc[a][j]);
        }
      }
    }
  }

  T* dqg = dq + b * st.dq.b + h * st.dq.h;
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int r = q0 + ty + 16 * a;
    if (r >= S) continue;
#pragma unroll
    for (int j = 0; j < MJ; ++j)
      if (j < nj) dqg[r * st.dq.s + tx + 16 * j] = from_f<T>(dq_acc[a][j] * scale);
  }
}

template <typename T, int BR, int MJ>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, void* dq, void* dk, void* dv, float* D, int B, int H, int S,
           int Sk, int HD, int causal, int window, float scale, const Views& st,
           cudaStream_t stream) {
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* g_ = static_cast<const T*>(dout);
  const long long rows = (long long)B * H * S;
  flash_bwd_dot_kernel<T><<<(unsigned)((rows + THREADS / 32 - 1) / (THREADS / 32)), THREADS, 0,
                            stream>>>(static_cast<const T*>(o), g_, D, H, S, HD, st.o, st.dout,
                                      rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int smem = (int)(smem_floats<BR>(HD) * sizeof(float));
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, BR, MJ>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, BR, MJ>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<T, BR, MJ><<<dim3((Sk + BR - 1) / BR, H, B), THREADS, smem, stream>>>(
      q_, k_, v_, g_, lse, D, static_cast<T*>(dk), static_cast<T*>(dv), S, Sk, HD, causal,
      window, scale, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<T, BR, MJ><<<dim3((S + BR - 1) / BR, H, B), THREADS, smem, stream>>>(
      q_, k_, v_, g_, lse, D, static_cast<T*>(dq), S, Sk, HD, causal, window, scale, st);
  return cudaGetLastError();
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, const void* o, const void* dout,
              const float* lse, void* dq, void* dk, void* dv, float* D, int B, int H, int S,
              int Sk, int HD, int causal, int window, float scale, const Views& st,
              cudaStream_t stream) {
  if (HD <= 128)
    return launch<T, 64, 8>(q, k, v, o, dout, lse, dq, dk, dv, D, B, H, S, Sk, HD, causal,
                            window, scale, st, stream);
  return launch<T, 32, 16>(q, k, v, o, dout, lse, dq, dk, dv, D, B, H, S, Sk, HD, causal,
                           window, scale, st, stream);
}

}  // namespace

// q, o, dout, dq: (B, H, S, HD) views; k, v, dk, dv: (B, H, Sk, HD) views;
// all of one dtype (fp32 or bf16), the head dim contiguous, HD a multiple
// of 16 up to 256. strides: 24 element strides, (batch, head, row) of q, k,
// v, o, dout, dq, dk, dv in that order. lse: the forward's (B, H, S) fp32
// row log-sum-exp (flash_fwd_launch's, log2 units); D: (B, H, S) fp32
// scratch. Returns the first failing launch's cudaError_t (0 on success).
extern "C" int flash_bwd_launch(const void* q, const void* k, const void* v, const void* o,
                                const void* dout, const float* lse, void* dq, void* dk,
                                void* dv, float* D, int B, int H, int S, int Sk, int HD,
                                int causal, int window, float scale, int is_bf16,
                                const long long* strides, void* stream) {
  if (HD <= 0 || HD % 16 != 0 || HD > MAX_HD || S <= 0 || Sk <= 0 || B <= 0 || H <= 0)
    return cudaErrorInvalidValue;
  View vw[8];
  for (int i = 0; i < 8; ++i) vw[i] = View{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const Views st{vw[0], vw[1], vw[2], vw[3], vw[4], vw[5], vw[6], vw[7]};
  cudaStream_t sm = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_hd<__nv_bfloat16>(q, k, v, o, dout, lse, dq, dk, dv, D, B, H, S, Sk, HD,
                                    causal, window, scale, st, sm);
  return launch_hd<float>(q, k, v, o, dout, lse, dq, dk, dv, D, B, H, S, Sk, HD, causal,
                          window, scale, st, sm);
}
