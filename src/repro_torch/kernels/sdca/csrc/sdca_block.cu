// The deltas of ONE H-block for every task in one launch (the
// `pallas_block` solver backend; one launch per H-block).
//
// Replaces the TPU kernel `sdca_block_kernel` / `_kernel` of
// repro/kernels/sdca/sdca_kernel.py. The TPU version runs a d-tiled grid
// that carries q, xr and G in VMEM scratch from one grid step to the next
// and solves on the last tile. Hopper blocks run in no order, so here one
// CTA per task walks the d-tiles itself in a loop (block_gram), then one
// warp runs the B-step recursion on the shared-memory Gram. A coordinate
// drawn twice in the block finds its earlier delta through the equality
// mask cb == cb[k], as on the TPU. The caller gathers the rows before and
// does the scatter into dalpha and r += X_b^T deltas after.
// What bounds it on this card: the B sequential recursion steps (latency,
// one warp) and the B d 4 bytes of rows plus w and r read per task, with
// one SM per task busy.
#include "sdca_common.cuh"

namespace sdca {

template <int B>
__global__ void __launch_bounds__(kThreads)
block_kernel(const float* __restrict__ xb,     // (m, B, d)
             const float* __restrict__ w,      // (m, d)
             const float* __restrict__ r,      // (m, d)
             const float* __restrict__ at0,    // (m, B)
             const float* __restrict__ y,      // (m, B)
             const int* __restrict__ cb,       // (m, B)
             const float* __restrict__ kappa,  // (m,)
             float* __restrict__ deltas,       // (m, B)
             int d, int loss) {
  __shared__ BlockSmem<B> s;
  const int t = blockIdx.x, tid = threadIdx.x;
  if (tid < B) {
    s.cb[tid] = cb[t * B + tid];
    s.rowoff[tid] = (int64_t)tid * d;
    s.at0[tid] = at0[t * B + tid];
    s.yb[tid] = y[t * B + tid];
  }
  __syncthreads();
  block_gram<B>(xb + (int64_t)t * B * d, w + (int64_t)t * d,
                r + (int64_t)t * d, d, s);
  if (tid < 32) block_recursion<B>(s, kappa[t], loss);
  __syncthreads();
  if (tid < B) deltas[t * B + tid] = s.deltas[tid];
}

}  // namespace sdca

// Plain C entry point for ctypes. Returns a cudaError_t (0 = launched).
extern "C" int sdca_block_launch(const void* xb, const void* w, const void* r,
                                 const void* at0, const void* y,
                                 const void* cb, const void* kappa,
                                 void* deltas, int m, int block, int d,
                                 int loss, void* stream) {
  using namespace sdca;
  if (loss < kHinge || loss > kSmoothedHinge) return (int)cudaErrorInvalidValue;
#define SDCA_BLOCK_CASE(BB)                                                    \
  case BB:                                                                     \
    block_kernel<BB><<<m, kThreads, 0, (cudaStream_t)stream>>>(                \
        (const float*)xb, (const float*)w, (const float*)r,                    \
        (const float*)at0, (const float*)y, (const int*)cb,                    \
        (const float*)kappa, (float*)deltas, d, loss);                         \
    return (int)cudaGetLastError();
  switch (block) {
    SDCA_BLOCK_CASE(16)
    SDCA_BLOCK_CASE(32)
    SDCA_BLOCK_CASE(64)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SDCA_BLOCK_CASE
}
