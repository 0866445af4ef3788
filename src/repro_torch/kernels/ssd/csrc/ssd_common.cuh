// Helpers shared by the SSD chunk kernel (ssd_chunk.cu, K4) and its
// backward (ssd_chunk_bwd.cu, K4-bwd): the CTA size, the model-layout
// strides, the widening loads of x, B and C into fp32 shared memory, and
// the split-TF32 tensor-core product (3xTF32 on mma.sync.m16n8k8) with its
// fragment loads. Each kernel source includes this file once.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAXD = 128;                // Q, N, P <= MAXD
constexpr size_t MAX_SMEM = 232448;      // dynamic shared memory of one CTA

__host__ __device__ constexpr int round_up(int a, int b) { return (a + b - 1) / b * b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

struct Strides {  // element strides of (batch, step, head or group)
  long long xb, xl, xh, db, dl, dh, bb, bl, bg, cb, cl, cg;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// 16 bytes of T widened into 16 / sizeof(T) floats at dst (16-byte aligned)
__device__ __forceinline__ void widen16(const uint4& v, float* dst, float) {
  *reinterpret_cast<uint4*>(dst) = v;
}
__device__ __forceinline__ void widen16(const uint4& v, float* dst, __nv_bfloat16) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
  float f[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
  reinterpret_cast<float4*>(dst)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// v rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero), on the integer ALU: adding half a TF32 ulp to the magnitude
// bits and clearing the 13 low bits. cvt runs on the conversion pipe at a
// quarter of the ALU's rate, and the products convert every operand.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// a = hi + lo, both TF32
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(a);
  lo = tf32_rna(a - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// a b in split TF32 into three accumulators (d[0] += hi.hi, d[1] += hi.lo,
// d[2] += lo.hi): three independent mma chains instead of one
__device__ __forceinline__ void mma3(float (&d)[3][4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma_tf32(d[0], ah, bh);
  mma_tf32(d[1], ah, bl);
  mma_tf32(d[2], al, bh);
}

// the sum of the three accumulators, the small terms first
__device__ __forceinline__ float acc_sum(const float (&d)[3][4], int i) {
  return (d[2][i] + d[1][i]) + d[0][i];
}

// B fragment (k x n = 8 x 8, column-major) of a row-major [k][n] shared
// matrix: lane (g, t) holds rows t and t + 4 of column g
__device__ __forceinline__ void frag_b_kn(const float* M, int ld, int k0, int n0, int g,
                                          int t, uint32_t (&bh)[2], uint32_t (&bl)[2]) {
  split(M[(k0 + t) * ld + n0 + g], bh[0], bl[0]);
  split(M[(k0 + t + 4) * ld + n0 + g], bh[1], bl[1]);
}

// A fragment (m x k = 16 x 8, row-major) of a row-major [m][k] shared
// matrix: lane (g, t) holds rows g, g + 8 of columns t, t + 4
__device__ __forceinline__ void frag_a_mk(const float* M, int ld, int m0, int k0, int g,
                                          int t, uint32_t (&ah)[4], uint32_t (&al)[4]) {
  split(M[(m0 + g) * ld + k0 + t], ah[0], al[0]);
  split(M[(m0 + g + 8) * ld + k0 + t], ah[1], al[1]);
  split(M[(m0 + g) * ld + k0 + t + 4], ah[2], al[2]);
  split(M[(m0 + g + 8) * ld + k0 + t + 4], ah[3], al[3]);
}

// A fragment of a shared matrix stored transposed, [k][m]: element (m, k)
// is M[k][m]
__device__ __forceinline__ void frag_a_km(const float* M, int ld, int m0, int k0, int g,
                                          int t, uint32_t (&ah)[4], uint32_t (&al)[4]) {
  split(M[(k0 + t) * ld + m0 + g], ah[0], al[0]);
  split(M[(k0 + t) * ld + m0 + g + 8], ah[1], al[1]);
  split(M[(k0 + t + 4) * ld + m0 + g], ah[2], al[2]);
  split(M[(k0 + t + 4) * ld + m0 + g + 8], ah[3], al[3]);
}

// B fragment of a shared matrix stored transposed, [n][k]: element (k, n)
// is M[n][k]
__device__ __forceinline__ void frag_b_nk(const float* M, int ld, int k0, int n0, int g,
                                          int t, uint32_t (&bh)[2], uint32_t (&bl)[2]) {
  split(M[(n0 + g) * ld + k0 + t], bh[0], bl[0]);
  split(M[(n0 + g) * ld + k0 + t + 4], bh[1], bl[1]);
}

// a unit's 16 x 16 output (rows r0.., columns col0..; two n-tiles of
// three accumulators) into a row-major fp32 matrix with row stride rs,
// rows below rlimit and columns below climit
__device__ __forceinline__ void store_tile(float* base, long long rs, int rlimit, int climit,
                                           const float (&acc)[2][3][4], int r0, int col0,
                                           int g, int t) {
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int p = col0 + 8 * q + 2 * t;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = r0 + g + 8 * hr;
      if (r >= rlimit) continue;
      float* o = base + r * rs + p;
      if (p < climit) o[0] = acc_sum(acc[q], 2 * hr);
      if (p + 1 < climit) o[1] = acc_sum(acc[q], 2 * hr + 1);
    }
  }
}

// B and C of the chunk's group: rows [0, rows) x cols [0, N) of two
// (rows, N) slabs of T with row strides sb, sc into zero-padded fp32
// [QP][ldb] and [QP][ldc] shared matrices of NP columns. The 16-byte loads
// go out in batches of kBatch a thread before any is stored, so a CTA
// waits for one or two memory latencies, not one per load.
template <typename T>
__device__ void load_bc(float* Bs, int ldb, float* Cs, int ldc, int QP, int NP, const T* bsrc,
                        long long sb, const T* csrc, long long sc, int rows, int N, bool vec) {
  constexpr int kBatch = 4;
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    const int cpr = NP / V, per = QP * cpr, total = 2 * per;
    for (int e0 = threadIdx.x; e0 < total; e0 += kBatch * THREADS) {
      uint4 v[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int e = e0 + i * THREADS, w = e >= per, f = e - w * per;
        const int r = f / cpr, c = (f - r * cpr) * V;
        v[i] = make_uint4(0u, 0u, 0u, 0u);
        if (e < total && r < rows && c < N)
          v[i] = *reinterpret_cast<const uint4*>(w ? csrc + r * sc + c : bsrc + r * sb + c);
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int e = e0 + i * THREADS, w = e >= per, f = e - w * per;
        const int r = f / cpr, c = (f - r * cpr) * V;
        if (e < total) widen16(v[i], w ? Cs + r * ldc + c : Bs + r * ldb + c, T());
      }
    }
  } else {
    const int per = QP * NP;
    for (int e = threadIdx.x; e < 2 * per; e += THREADS) {
      const int w = e >= per, f = e - w * per, r = f / NP, c = f - r * NP;
      float v = 0.f;
      if (r < rows && c < N) v = to_f(w ? csrc[r * sc + c] : bsrc[r * sb + c]);
      (w ? Cs + r * ldc : Bs + r * ldb)[c] = v;
    }
  }
}

// rows [0, rows) of the head's x chunk into rows ld bytes apart at dst
// (cp.async when aligned); one commit group
template <typename T>
__device__ void load_x(char* dst, int ld, const T* src, long long rs, int rows, int P,
                       bool vec) {
  if (vec) {
    const int cpr = P * (int)sizeof(T) / 16;
    for (int e = threadIdx.x; e < rows * cpr; e += THREADS) {
      const int r = e / cpr, c = e - r * cpr;
      cp_async16(dst + r * ld + 16 * c, reinterpret_cast<const char*>(src + r * rs) + 16 * c);
    }
  } else {
    for (int e = threadIdx.x; e < rows * P; e += THREADS) {
      const int r = e / P, p = e - r * P;
      reinterpret_cast<T*>(dst + r * ld)[p] = src[r * rs + p];
    }
  }
  cp_async_commit();
}

}  // namespace
