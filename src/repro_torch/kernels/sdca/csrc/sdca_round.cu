// One fused local SDCA round for every task in ONE launch (the
// `pallas_round` solver backend).
//
// Replaces the TPU kernel `sdca_round_kernel` / `_round_kernel` of
// repro/kernels/sdca/sdca_kernel.py. The TPU version stages the task's
// whole (n_max, d) block in VMEM; at MNIST width that block is 37.6 MB,
// far above the 227 KB of shared memory a Hopper block can use. So here:
//   * one CTA per task (the JAX vmap over tasks), 256 threads;
//   * X stays in global memory; each H-block gathers its B sampled rows in
//     d-tiles of 64 columns (block_gram), then reads them once more for
//     r += X_b^T deltas (those rows are then still in L2);
//   * w and the running correction r live in shared memory for the whole
//     round, next to the B x B Gram and the deltas;
//   * one warp runs the B-step recursion (warp reductions for G[k] . deltas
//     and for the earlier deltas of a coordinate drawn twice in the block),
//     then the first slot of each drawn coordinate is the single writer of
//     its dalpha entry;
//   * coordinates are drawn on the device from the round's uniforms with
//     the fp32 product and truncation of sample_coords.
// What bounds it on this card: the B sequential recursion steps per block
// (latency, one warp) and the gathered-row bytes (2 B d 4 per block), with
// one SM per task busy. Tensor cores are not used: the contractions are
// fp32 and the B x B x d Gram per block is small.
#include "sdca_common.cuh"

namespace sdca {

template <int B>
__global__ void __launch_bounds__(kThreads)
round_kernel(const float* __restrict__ x,      // (m, n_max, d)
             const float* __restrict__ y,      // (m, n_max)
             const float* __restrict__ alpha,  // (m, n_max)
             const float* __restrict__ w,      // (m, d)
             const float* __restrict__ u,      // (m, H)
             const int* __restrict__ n,        // (m,)
             const float* __restrict__ kappa,  // (m,)
             float* __restrict__ dalpha,       // (m, n_max), zero on entry
             float* __restrict__ r_out,        // (m, d)
             int n_max, int d, int H, int loss) {
  __shared__ BlockSmem<B> s;
  extern __shared__ float dyn[];
  float* w_s = dyn;      // (d,)
  float* r_s = dyn + d;  // (d,)

  const int t = blockIdx.x, tid = threadIdx.x;
  const float* xt = x + (int64_t)t * n_max * d;
  const float* yt = y + (int64_t)t * n_max;
  const float* at = alpha + (int64_t)t * n_max;
  float* dat = dalpha + (int64_t)t * n_max;
  const float* ut = u + (int64_t)t * H;
  const int nt = n[t];
  const float kap = kappa[t];

  for (int c = tid; c < d; c += kThreads) {
    w_s[c] = w[(int64_t)t * d + c];
    r_s[c] = 0.f;
  }

  for (int b0 = 0; b0 < H; b0 += B) {
    if (tid < B) {
      const int j = min((int)__fmul_rn(ut[b0 + tid], (float)nt), nt - 1);
      s.cb[tid] = j;
      s.rowoff[tid] = (int64_t)j * d;
      s.at0[tid] = at[j] + dat[j];
      s.yb[tid] = yt[j];
    }
    __syncthreads();
    block_gram<B>(xt, w_s, r_s, d, s);
    if (tid < 32) block_recursion<B>(s, kap, loss);
    __syncthreads();

    // scatter: the first slot of each coordinate adds all of the block's
    // deltas for it in draw order, so duplicates accumulate and every
    // dalpha entry has a single writer
    if (tid < B) {
      const int j = s.cb[tid];
      bool first = true;
      for (int k = 0; k < tid; ++k) first = first && s.cb[k] != j;
      if (first) {
        float v = dat[j];
        for (int k = tid; k < B; ++k)
          if (s.cb[k] == j) v += s.deltas[k];
        dat[j] = v;
      }
    }
    // r += X_b^T deltas (the block's rows are still in L2)
    for (int c = tid; c < d; c += kThreads) {
      float acc = 0.f;
#pragma unroll 16
      for (int k = 0; k < B; ++k) acc = fmaf(xt[s.rowoff[k] + c], s.deltas[k], acc);
      r_s[c] += acc;
    }
    __syncthreads();
  }
  for (int c = tid; c < d; c += kThreads) r_out[(int64_t)t * d + c] = r_s[c];
}

template <int B>
cudaError_t launch(const float* x, const float* y, const float* alpha,
                   const float* w, const float* u, const int* n,
                   const float* kappa, float* dalpha, float* r, int m,
                   int n_max, int d, int H, int loss, cudaStream_t stream) {
  const size_t dyn = 2 * (size_t)d * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      round_kernel<B>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (err != cudaSuccess) return err;
  round_kernel<B><<<m, kThreads, dyn, stream>>>(x, y, alpha, w, u, n, kappa,
                                                dalpha, r, n_max, d, H, loss);
  return cudaGetLastError();
}

}  // namespace sdca

// Plain C entry point for ctypes. Returns a cudaError_t (0 = launched).
extern "C" int sdca_round_launch(const void* x, const void* y,
                                 const void* alpha, const void* w,
                                 const void* u, const void* n,
                                 const void* kappa, void* dalpha, void* r,
                                 int m, int n_max, int d, int H, int block,
                                 int loss, void* stream) {
  using namespace sdca;
  if (H % block != 0 || loss < kHinge || loss > kSmoothedHinge)
    return (int)cudaErrorInvalidValue;
#define SDCA_ROUND_CASE(BB)                                                  \
  case BB:                                                                   \
    return (int)launch<BB>((const float*)x, (const float*)y,                \
                           (const float*)alpha, (const float*)w,            \
                           (const float*)u, (const int*)n,                  \
                           (const float*)kappa, (float*)dalpha, (float*)r,  \
                           m, n_max, d, H, loss, (cudaStream_t)stream);
  switch (block) {
    SDCA_ROUND_CASE(16)
    SDCA_ROUND_CASE(32)
    SDCA_ROUND_CASE(64)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SDCA_ROUND_CASE
}
