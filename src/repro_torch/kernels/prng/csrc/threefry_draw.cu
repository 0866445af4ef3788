// Every task's coordinate uniforms of one communication round in ONE launch
// (the `coords` stage of core/dmtrl.py's round).
//
// Replaces no TPU kernel: the JAX package draws these with jax.random
// (threefry2x32 in its partitionable mode) inside its jitted round, where
// XLA fuses the hash into the round's program. The port emulated the hash
// with int64 torch ops (repro_torch/prng.py): some 100 host ops for the
// per-task keys and 191 small device launches for the draw, every round.
// This kernel does the same uint32 arithmetic, so its uniforms are
// bit-equal to prng.uniform(prng.fold_in(prng.fold_in(key, tids), pod), (H,)):
//
//   k_t     = fold_in(fold_in(key, tids[t]), pod)  two hashes of the pair (0, datum)
//   b1, b2  = threefry2x32(k_t, (i >> 32, i & 0xFFFFFFFF))    element i's counter
//   u[t, i] = as_float(((b1 ^ b2) >> 9) | 0x3F800000) - 1.0f   in [0, 1), exact
//
// The round key's two words come as arguments (the wrapper reads them from
// the host's key), the task ids from a device int32 array.
//
// What bounds it on this card: it writes m H floats (481 KB at MNIST width,
// 0.14 us at 3.35 TB/s) after about three hashes of some 100 integer
// operations an element; at the fit's sizes the launch itself, a few
// microseconds, is the floor. So the design is plain: each thread derives
// its task's key in registers (two hashes) and draws kVec consecutive
// elements, stored as one 16-byte vector where every row starts 16-byte
// aligned (H a multiple of 4), one float at a time otherwise.
#include <cuda_runtime.h>
#include <stdint.h>

namespace threefry {

constexpr int kThreads = 128;
constexpr int kVec = 4;  // consecutive elements a thread draws
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Threefry-2x32, 20 rounds, of the counter words (x0, x1) under the key
// words (k0, k1): prng.threefry2x32 in uint32.
__device__ __forceinline__ uint2 hash(uint32_t k0, uint32_t k1, uint32_t x0, uint32_t x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[8] = {13, 15, 26, 6, 17, 29, 16, 24};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[(i % 2) * 4 + j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  return make_uint2(x0, x1);
}

// grid (ceil(H / (kThreads kVec)), min(m, kMaxGridY)); a block row walks the
// tasks t = blockIdx.y, blockIdx.y + gridDim.y, ...
__global__ void __launch_bounds__(kThreads)
    draw_kernel(uint32_t k0, uint32_t k1, const int* __restrict__ tids, uint32_t pod,
                float* __restrict__ u, int m, int H) {
  const int64_t i0 = ((int64_t)blockIdx.x * kThreads + threadIdx.x) * kVec;
  if (i0 >= H) return;
  for (int t = blockIdx.y; t < m; t += gridDim.y) {
    const uint2 a = hash(k0, k1, 0u, (uint32_t)tids[t]);
    const uint2 k = hash(a.x, a.y, 0u, pod);
    float v[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const uint64_t i = (uint64_t)(i0 + j);
      const uint2 b = hash(k.x, k.y, (uint32_t)(i >> 32), (uint32_t)i);
      v[j] = __uint_as_float(((b.x ^ b.y) >> 9) | 0x3F800000u) - 1.0f;
    }
    float* row = u + (int64_t)t * H;
    if (H % kVec == 0) {  // i0 + kVec <= H, and the row starts 16-byte aligned
      *reinterpret_cast<float4*>(row + i0) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        if (i0 + j < H) row[i0 + j] = v[j];
    }
  }
}

}  // namespace threefry

// u (m, H) float32, 16-byte aligned; tids (m,) int32; returns the launch's
// cudaError_t.
extern "C" int threefry_draw_launch(uint32_t k0, uint32_t k1, const void* tids, uint32_t pod,
                                    void* u, int m, int H, void* stream) {
  using namespace threefry;
  if (m < 1 || H < 1 || (uintptr_t)u % 16 != 0) return (int)cudaErrorInvalidValue;
  const int64_t per_block = (int64_t)kThreads * kVec;
  const dim3 grid((unsigned)((H + per_block - 1) / per_block),
                  (unsigned)(m < kMaxGridY ? m : kMaxGridY));
  draw_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(k0, k1, (const int*)tids, pod,
                                                          (float*)u, m, H);
  return (int)cudaGetLastError();
}
