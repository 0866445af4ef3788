// Shared pieces of the two Hopper SDCA kernels (sdca_round.cu and
// sdca_block.cu): the closed-form coordinate deltas with their divisor
// inverted off the chain, the cp.async helpers, a warp sum, and the
// right-looking B-step recursion both kernels run on one warp.
//
// The recursion is right-looking: lane i keeps, for its rows, the running
// xr_i + sum_{j<k} G[i][j] delta_j and the sum of earlier deltas drawn at
// the same coordinate. At step k every lane evaluates the closed-form delta
// of its own row, one shuffle broadcasts row k's, and every lane adds
// G[k][i] delta_k and (cb_i == cb_k) delta_k to its rows (G is symmetric,
// so the row read is a conflict-free column read). The steps are unrolled
// and branch-free, the loss is a template parameter, and the delta's
// divisor (kappa G[k][k] plus the loss's constant, known at block start) is
// inverted per row before the chain, so no division sits on it (a rounding
// of about one ulp against the quotient).
//
// Arithmetic is float32 throughout, as in the TPU kernels
// (repro/kernels/sdca/sdca_kernel.py). Sums run in another order than on
// the TPU or the CPU, so results agree to float32 rounding, not bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sdca {

constexpr int kThreads = 256;
constexpr float kEps = 1e-12f;
constexpr float kGamma = 0.5f;  // smoothed-hinge knee (core/losses.py)

enum LossId : int { kHinge = 0, kSquared = 1, kSmoothedHinge = 2 };

__device__ __forceinline__ float clip01(float v) {
  return fminf(fmaxf(v, 0.f), 1.f);
}

// The divisor of the closed-form delta, inverted: a = kappa G[k][k]
template <int LOSS>
__device__ __forceinline__ float recip_of(float a) {
  if (LOSS == kHinge) return 1.f / fmaxf(a, kEps);
  if (LOSS == kSquared) return 1.f / (1.f + a);
  return 1.f / (kGamma + a);
}

// argmax over delta of -l*(-(atilde + delta)) - c delta - a/2 delta^2
// (repro/kernels/sdca/sdca_kernel.py:56-76), with inv = recip_of(a)
template <int LOSS>
__device__ __forceinline__ float delta_of_recip(float atilde, float c, float inv, float y) {
  if (LOSS == kHinge) return y * clip01(y * (atilde + (y - c) * inv)) - atilde;
  if (LOSS == kSquared) return (y - c - atilde) * inv;
  const float anew_u = atilde + (y - c - kGamma * atilde) * inv;
  return y * clip01(y * anew_u) - atilde;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {  // all but the newest group
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The rows one lane of the recursion warp owns: i = lane + 32 s (lanes
// past B repeat row B-1 and write nothing).
template <int B>
struct ChainRows {
  static constexpr int NR = (B + 31) / 32;
  float acc[NR];    // in: xr_i; then xr_i + sum_{j<k} G[i][j] delta_j
  float q[NR];      // q_i
  float at[NR];     // alpha~_i at block start
  float y[NR];      // label of row i
  float inv[NR];    // recip_of(kappa G[i][i])
  int cb[NR];       // coordinate of row i
  float dup[NR];    // out: the block's deltas drawn at row i's coordinate
  float delta[NR];  // out: delta_i
  bool first[NR];   // out: no earlier row of the block drew row i's coordinate
};

// The B steps on warp-wide rows r: c_k = q_k + kappa acc_k, alpha~_k = at_k
// + dup_k, delta_k = delta_of_recip(...). G is the block's B x B Gram and
// cb its coordinates, both in shared memory. Fully unrolled, so the G row
// loads run ahead of the chain; every lane evaluates the delta of its own
// row and the owner's value is taken, so no step branches.
template <int B, int LOSS>
__device__ __forceinline__ void right_looking(ChainRows<B>& r, const float* G, const int* cb,
                                              float kap) {
  constexpr int NR = ChainRows<B>::NR;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int s = 0; s < NR; ++s) {
    r.dup[s] = 0.f;
    r.delta[s] = 0.f;
    r.first[s] = lane + 32 * s < B;
  }
#pragma unroll
  for (int s = 0; s < NR; ++s)
#pragma unroll
    for (int kk = 0; kk < 32 && 32 * s + kk < B; ++kk) {
      const int k = 32 * s + kk;
      const float dl =
          delta_of_recip<LOSS>(r.at[s] + r.dup[s], r.q[s] + kap * r.acc[s], r.inv[s], r.y[s]);
      const float dk = __shfl_sync(0xffffffffu, dl, kk);
      if (lane == kk) r.delta[s] = dk;
      const int ck = cb[k];
      const float* Gk = G + k * B;
#pragma unroll
      for (int s2 = 0; s2 < NR; ++s2) {
        const int i = min(lane + 32 * s2, B - 1);
        r.acc[s2] = fmaf(Gk[i], dk, r.acc[s2]);
        if (r.cb[s2] == ck) {
          r.dup[s2] += dk;
          if (k < lane + 32 * s2) r.first[s2] = false;
        }
      }
    }
}

}  // namespace sdca
