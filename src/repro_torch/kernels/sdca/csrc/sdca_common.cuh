// Shared pieces of the two Hopper SDCA kernels: the closed-form coordinate
// deltas and a warp sum (sdca_round.cu and sdca_block.cu), and, for
// sdca_block.cu, the block-Gram accumulation over d-tiles and the
// single-warp, left-looking B-step recursion.
//
// The block kernel stages what the recursion reads (alpha~ at block start,
// the labels, the coordinate ids) in shared memory first, so the B
// sequential steps touch no device memory; a coordinate drawn twice in a
// block finds its earlier deltas through the equality mask cb == cb[k].
//
// Arithmetic is float32 throughout, as in the TPU kernels
// (repro/kernels/sdca/sdca_kernel.py). Sums run in another order than on
// the TPU or the CPU, so results agree to float32 rounding, not bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sdca {

constexpr int kThreads = 256;  // 16 x 16 threads tile the B x B Gram
constexpr int kTile = 64;      // d-columns of the gathered rows staged at once
constexpr float kEps = 1e-12f;
constexpr float kGamma = 0.5f;  // smoothed-hinge knee (core/losses.py)

enum LossId : int { kHinge = 0, kSquared = 1, kSmoothedHinge = 2 };

__device__ __forceinline__ float clip01(float v) {
  return fminf(fmaxf(v, 0.f), 1.f);
}

// argmax over delta of -l*(-(atilde + delta)) - c delta - a/2 delta^2
// (repro/kernels/sdca/sdca_kernel.py:56-76).
__device__ __forceinline__ float delta_of(int loss, float atilde, float c,
                                          float a, float y) {
  if (loss == kHinge) {
    a = fmaxf(a, kEps);
    return y * clip01(y * (atilde + (y - c) / a)) - atilde;
  }
  if (loss == kSquared) return (y - c - atilde) / (1.f + a);
  const float anew_u = atilde + (y - c - kGamma * atilde) / (kGamma + a);
  return y * clip01(y * anew_u) - atilde;
}

// Shared memory of one block of B gathered rows.
template <int B>
struct BlockSmem {
  float xs[B][kTile + 1];  // one d-tile of the rows (+1: no bank conflicts)
  float ws[kTile], rs[kTile];  // the same tile of w and r
  float G[B][B];
  float q[B], xr[B], deltas[B];
  float at0[B], yb[B];  // alpha~ at block start and label of row k
  int64_t rowoff[B];    // element offset of row k from the data base pointer
  int cb[B];            // coordinate id of row k
};

// q = X_b w, xr = X_b r and G = X_b X_b^T for the B rows at s.rowoff,
// accumulated over d in tiles of kTile columns. Thread (ti, tj) of the
// 16 x 16 grid owns G[ti + 16 a][tj + 16 b] for a, b < B/16, so each tile
// column costs it 2 B/16 shared loads for (B/16)^2 FMAs.
template <int B>
__device__ void block_gram(const float* __restrict__ x, const float* w,
                           const float* r, int d, BlockSmem<B>& s) {
  constexpr int RT = B / 16;
  const int tid = threadIdx.x;
  const int ti = tid / 16, tj = tid % 16;
  float g[RT][RT];
#pragma unroll
  for (int a = 0; a < RT; ++a)
#pragma unroll
    for (int b = 0; b < RT; ++b) g[a][b] = 0.f;
  float acc = 0.f;  // q[tid] for tid < B, xr[tid - B] for B <= tid < 2B

  for (int d0 = 0; d0 < d; d0 += kTile) {
#pragma unroll
    for (int i = 0; i < B * kTile / kThreads; ++i) {  // loads all in flight
      const int e = tid + i * kThreads;
      const int k = e / kTile, c = e % kTile;
      s.xs[k][c] = d0 + c < d ? x[s.rowoff[k] + d0 + c] : 0.f;
    }
    if (tid < kTile) {
      s.ws[tid] = d0 + tid < d ? w[d0 + tid] : 0.f;
      s.rs[tid] = d0 + tid < d ? r[d0 + tid] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float xa[RT], xb[RT];
#pragma unroll
      for (int a = 0; a < RT; ++a) xa[a] = s.xs[ti + 16 * a][c];
#pragma unroll
      for (int b = 0; b < RT; ++b) xb[b] = s.xs[tj + 16 * b][c];
#pragma unroll
      for (int a = 0; a < RT; ++a)
#pragma unroll
        for (int b = 0; b < RT; ++b) g[a][b] = fmaf(xa[a], xb[b], g[a][b]);
    }
    if (tid < 2 * B) {
      const int k = tid % B;
      const float* v = tid < B ? s.ws : s.rs;
      for (int c = 0; c < kTile; ++c) acc = fmaf(s.xs[k][c], v[c], acc);
    }
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < RT; ++a)
#pragma unroll
    for (int b = 0; b < RT; ++b) s.G[ti + 16 * a][tj + 16 * b] = g[a][b];
  if (tid < B) s.q[tid] = acc;
  else if (tid < 2 * B) s.xr[tid - B] = acc;
  __syncthreads();
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// deltas[k] for k = 0..B-1 in order, on the Gram block in shared memory:
//   c_k = q_k + kappa (xr_k + G[k, :k] . deltas[:k]),  a_k = kappa G[k, k],
//   alpha~_k = at0_k + sum of deltas[:k] drawn at the same coordinate.
// Run by warp 0 alone; lane 0 is the single writer of deltas.
template <int B>
__device__ void block_recursion(BlockSmem<B>& s, float kappa, int loss) {
  const int lane = threadIdx.x;
  for (int k = 0; k < B; ++k) {
    const int ck = s.cb[k];
    float part = 0.f, dup = 0.f;
    for (int j = lane; j < k; j += 32) {  // deltas[k:] are not yet set
      part = fmaf(s.G[k][j], s.deltas[j], part);
      if (s.cb[j] == ck) dup += s.deltas[j];
    }
    part = warp_sum(part);
    dup = warp_sum(dup);
    if (lane == 0) {
      const float c = s.q[k] + kappa * (s.xr[k] + part);
      const float a = kappa * s.G[k][k];
      s.deltas[k] = delta_of(loss, s.at0[k] + dup, c, a, s.yb[k]);
    }
    __syncwarp();
  }
}

}  // namespace sdca
