// Flash-attention backward (K3-bwd) for sm_90a: dQ, dK and dV of
// O = softmax(q k^T * scale + mask) v, on the tensor cores.
//
// No TPU kernel stands behind it: the JAX package trains through its jnp
// `chunked_attention` (src/repro/models/attention.py) and lets autodiff
// form the gradient. The port runs K3 (flash_fwd.cu) where JAX runs that
// function, so the gradient through K3 needs a kernel of its own. It takes
// the same strided (B, H, rows, HD) views and the same masks as the
// forward: causal, sliding window, non-causal, Sk != S and ragged last
// tiles; bf16 (HD 16 .. 128 by 16, 192, 256) or fp32 (HD any multiple of
// 16 up to 256), fp32 accumulation.
//
// Inputs: q, k, v, the forward's output o, its gradient dO, and the row
// log-sum-exp lse (B, H, S) fp32 that flash_fwd_launch stores in log2
// units of the scaled scores, so P = 2^(s scale log2(e) - lse) is
// recomputed without a softmax pass. Two launches on one stream:
//   1. flash_bwd_dot_kernel: D = rowsum(dO o) (B, H, S) fp32, a warp a row;
//   2. flash_bwd_kernel: one grid of two kinds of CTA, each over 64
//      resident rows (4 row groups of 16, one mma M tile each):
//      * a dK/dV CTA keeps a block of 64 keys (K and V tiles) in shared
//        memory and walks the query tiles that see them, Q, dO, lse and D
//        streamed through a two-slot cp.async ring. It forms the
//        transposed products S^T = K Q^T and dP^T = V dO^T, so that
//        P^T = 2^(S^T scale log2(e) - lse) and dS^T = P^T (dP^T - D) come
//        out in the accumulator layout of an M tile of keys, which is (in
//        bf16, two n-tiles side by side) the A operand of dV += P^T dO and
//        dK += dS^T Q; dO and Q come in as B through ldmatrix.trans. P and
//        dS never go through shared memory (outside the split below);
//      * a dQ CTA keeps a block of 64 queries (Q and dO, and their lse and
//        D in registers) and walks the key tiles they see: S = Q K^T,
//        dP = dO V^T, dS = P (dP - D) in registers as A, dQ += dS K with K
//        through ldmatrix.trans.
//      dQ comes from this second pass instead of fp32 atomics from the
//      dK/dV CTAs, so every output element is summed by one thread in one
//      order and two calls give bit-equal results. That costs 7 products
//      of 2 HD flops per kept (query, key) pair (S and dP twice, dV, dK,
//      dQ) instead of 5. The grid is (H, key blocks + query blocks, B),
//      the two kinds interleaved with the heaviest causal blocks first
//      (dK/dV of the first keys, dQ of the last queries) and the heads
//      fastest, as the forward orders its q blocks.
// Both kinds skip the tiles that the causal mask or the window hide
// entirely (the forward's ranges); inside a tile that crosses the diagonal,
// the window's edge or the ragged end the mask is per element, and keys
// past Sk or rows past S (zero-filled in shared memory) get P = 0.
//
// Tiles: 64 resident rows a CTA (4 row groups of 16, one mma M tile each),
// streamed tiles of BT rows in the ring. Registers a thread (nvcc -Xptxas
// -v, sm_90a, no spills) and shared memory a CTA:
//   bf16 HD 16 .. 64    BT 64  4 warps  155 .. 218 regs  19 .. 55 KB
//   bf16 HD 80 .. 128   BT 32  4 warps  193 .. 242 regs  44.5 .. 68.5 KB
//   bf16 HD 192, 256    BT 32  8 warps  208, 242 regs    116.5, 148.5 KB
//   fp32 HD <= 64       BT 32  4 warps  167 regs (3 CTAs an SM)  68.5 KB at 64
//   fp32 HD 80 .. 128   BT 16  4 warps  223 regs          99 KB at 128
//   fp32 HD 144 .. 256  BT 16  8 warps  219 regs          203 KB at 256
// (bf16 is built per head dim; fp32 per range, with HD at run time.) Rows
// are padded to HD + 8 bf16 or HD + 4 fp32 elements, an odd number of
// 16-byte units, so the 8 rows an ldmatrix phase reads fall in 8 distinct
// bank groups. Above HD 128 a warp's dK and dV of 16 keys over all HD
// columns would take 256 fp32 registers a lane, over the 255 limit, so two
// warps share each row group: one forms S (or S^T), the other dP (or
// dP^T), each over all of HD; they swap them through shared memory (the
// only place P and dP go there) and then each accumulates half of the HD
// columns of dK and dV (or dQ).
//
// fp32 runs the same tiles on split TF32 (3xTF32, as ssd_chunk.cu): a =
// a_hi + a_lo, both TF32, and a b = a_hi b_hi + a_hi b_lo + a_lo b_hi on
// mma.sync.m16n8k8, which keeps fp32 accuracy where plain TF32 keeps about
// three digits. ldmatrix moves 16-byte rows of 32-bit values intact, so
// the A and the untransposed B fragments of m16n8k8 load as the bf16 ones
// do; the transposed B fragments are 32-bit shared loads, and P and dS
// move from the m16n8 accumulator layout into the k8 A layout with quad
// shuffles. The tensor cores truncate as they accumulate: three passes
// into one accumulator over a 1024-key reduction measured 2.1e-5 relative
// at gemma3's shape, over the 2e-5 bar. So every product sums a short
// stretch (two k8 steps of HD; one streamed tile of keys or queries) into
// fresh accumulators and adds that to the running sum in fp32, rounded to
// nearest: 2.2e-6 at that shape. The long reductions (dK, dV, dQ) keep
// hi.hi, hi.lo and lo.hi in three accumulators, three mma chains instead
// of one.
//
// Bound. At gemma3-1b's training shape (1 x 4 x 1024 x 256, bf16,
// causal: 524 800 kept pairs a head) the function's 5 products are
// 5.4 GFLOP, 5.4 us at 989 TFLOP/s, against 12.6 MB of q, k, v, o, dO, lse
// in and dq, dk, dv out, 3.8 us at 3.35 TB/s: the operations bound it.
// This design's 7 products (the price of determinism) put its own floor at
// 7.6 us. In fp32 the products run three TF32 passes, 32.6 us at
// 495 TFLOP/s for 5 (45.6 us for 7), or 80 us for 5 as fp32 FMAs at
// 67 TFLOP/s. mma.sync reaches a fraction of those rates:
// per streamed tile a warp reads its resident A fragments and the tile's
// B fragments again with ldmatrix (about 0.6 ldmatrix an mma at HD 256),
// with one or two warps per SM sub-partition to hide the latency, and the
// causal grid's heaviest CTA (the first key block walks every query tile)
// sets the pace. wgmma and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "flash_common.cuh"

namespace {

constexpr int BM = 64;            // resident rows per CTA: 4 row groups of 16
constexpr int STAGES = 2;         // streamed tiles in the cp.async ring
constexpr int DOT_THREADS = 256;  // flash_bwd_dot_kernel: a warp a row
constexpr int MAX_HD = 256;

// element strides (batch, head, row) of one (B, H, rows, HD) view
struct View {
  long long b, h, s;
};
struct Views {
  View q, k, v, o, dout, dq, dk, dv;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// D = rowsum(dO o) for every (b, h, row), one warp a row
template <typename T>
__global__ void __launch_bounds__(DOT_THREADS) flash_bwd_dot_kernel(
    const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ D, int H, int S,
    int HD, View vo, View vd, long long total_rows) {
  const long long row = (long long)blockIdx.x * (DOT_THREADS / 32) + threadIdx.x / 32;
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

// 4 bytes global -> shared, asynchronously; src_bytes = 0 zero-fills
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// the two warps of a row group (64 threads) meet; barrier 0 is __syncthreads
__device__ __forceinline__ void pair_barrier(int id) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory");
}

// ---------------------------------------------------------------------------
// split TF32 (the helpers of ssd_chunk.cu)
// ---------------------------------------------------------------------------
// v rounded to TF32 as cvt.rna.tf32.f32 rounds it, on the integer ALU
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}
// a = hi + lo, both TF32
__device__ __forceinline__ void split(uint32_t a, uint32_t& hi, uint32_t& lo) {
  const float f = __uint_as_float(a);
  hi = tf32_rna(f);
  lo = tf32_rna(f - __uint_as_float(hi));
}
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// a b in split TF32 into three accumulators (d[0] += hi.hi, d[1] += hi.lo,
// d[2] += lo.hi): three independent mma chains instead of one
__device__ __forceinline__ void mma_3xtf32(float (&d)[3][4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32(d[0], ah, bh0, bh1);
  mma_tf32(d[1], ah, bl0, bl1);
  mma_tf32(d[2], al, bh0, bh1);
}
// d += a b in split TF32 into one accumulator, the small terms first
__device__ __forceinline__ void mma_3xtf32_1(float (&d)[4], const uint32_t (&ah)[4],
                                             const uint32_t (&al)[4], uint32_t bh0,
                                             uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}
// acc += the three accumulators' sum, the small terms first
__device__ __forceinline__ void add_3xtf32(float (&acc)[4], const float (&d)[3][4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += (d[2][e] + d[1][e]) + d[0][e];
}
__device__ __forceinline__ void zero3(float (&d)[3][4]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[i][e] = 0.f;
}
__device__ __forceinline__ void split4(const uint32_t (&a)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split(a[i], hi[i], lo[i]);
}

// The k8 A fragment (rows g, g + 8; columns t, t + 4) of an m16n8 fp32
// accumulator (rows g, g + 8; columns 2t, 2t + 1), from the lanes of the
// quad that hold those columns
__device__ __forceinline__ void acc_to_a(const float (&c)[4], int lane, uint32_t (&a)[4]) {
  const int t = lane & 3;
  const int src0 = (lane & ~3) | (t >> 1), src1 = src0 + 2;
  const bool odd = t & 1;
  const float c0a = __shfl_sync(0xffffffffu, c[0], src0);
  const float c1a = __shfl_sync(0xffffffffu, c[1], src0);
  const float c2a = __shfl_sync(0xffffffffu, c[2], src0);
  const float c3a = __shfl_sync(0xffffffffu, c[3], src0);
  const float c0b = __shfl_sync(0xffffffffu, c[0], src1);
  const float c1b = __shfl_sync(0xffffffffu, c[1], src1);
  const float c2b = __shfl_sync(0xffffffffu, c[2], src1);
  const float c3b = __shfl_sync(0xffffffffu, c[3], src1);
  a[0] = __float_as_uint(odd ? c1a : c0a);
  a[1] = __float_as_uint(odd ? c3a : c2a);
  a[2] = __float_as_uint(odd ? c1b : c0b);
  a[3] = __float_as_uint(odd ? c3b : c2b);
}

// ---------------------------------------------------------------------------
// the tiles of one instantiation
// ---------------------------------------------------------------------------
// T: the element type; HDM: the largest head dim it takes; NSPLIT: warps
// per row group (2 splits the head-dim columns of the accumulators); BT:
// rows of a streamed tile.
template <typename T, int HDM, int NSPLIT, int BT>
struct Cfg {
  static constexpr int PAD = sizeof(T) == 2 ? 8 : 4;  // elements: an odd count of 16 B
  static constexpr int THREADS = 128 * NSPLIT;
  static constexpr int NTB = BT / 8;               // n-tiles of a streamed tile
  static constexpr int NTW = HDM / NSPLIT / 8;     // the most n-tiles of a warp's columns
  static_assert(BT % 16 == 0 && HDM % (16 * NSPLIT) == 0, "tile shape");
  static constexpr size_t smem_bytes(int hd) {
    return (size_t)(2 * BM + 2 * STAGES * BT) * (hd + PAD) * sizeof(T)  // R1, R2, the ring
           + (size_t)2 * STAGES * BT * sizeof(float)                   // lse, D per slot
           + (NSPLIT == 2 ? (size_t)4 * 2 * BT * 16 * sizeof(float) : 0);  // the swap
  }
};

// rows [row0, row0 + rows) of a (n_rows, hd) view with row stride rs into a
// [rows][ld] shared tile, 16 bytes a copy; rows at or past n_rows are
// zero-filled
template <typename T, int THREADS>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src, long long rs, int row0,
                                          int n_rows, int rows, int hd) {
  constexpr int E = 16 / sizeof(T);
  const int ch = hd / E;
  for (int c = threadIdx.x; c < rows * ch; c += THREADS) {
    const int r = c / ch, x = c - r * ch;
    const bool in = row0 + r < n_rows;
    cp_async16(dst + r * ld + x * E, in ? src + (row0 + r) * rs + x * E : src, in ? 16 : 0);
  }
}

// acc (16 rows x BT columns) = A B^T over the head dim: A the warp's 16
// resident rows, B the BT streamed rows, both [rows][ld] tiles; a_lane and
// b_lane are this lane's ldmatrix row addresses at k = 0
template <int NTB, int HD>
__device__ __forceinline__ void xprod(float (&acc)[NTB][4], const __nv_bfloat16* a_lane,
                                      const __nv_bfloat16* b_lane, int ld) {
#pragma unroll
  for (int j = 0; j < NTB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll 4
  for (int kk = 0; kk < HD; kk += 16) {
    uint32_t a[4];
    ldmatrix_x4(a, a_lane + kk);
#pragma unroll
    for (int np = 0; np < NTB / 2; ++np) {
      uint32_t bf[4];
      ldmatrix_x4(bf, b_lane + np * 16 * ld + kk);
      mma_bf16(acc[2 * np], a, bf[0], bf[1]);
      mma_bf16(acc[2 * np + 1], a, bf[2], bf[3]);
    }
  }
}

// xprod in split TF32. The tensor cores truncate as they accumulate, so
// each pair of k-steps sums into a fresh accumulator that is then added to
// acc in fp32 (rounded to nearest): the truncations are of the small
// partial sums, not of acc. One accumulator for the three passes here:
// three (as uprod keeps) took the registers that let three CTAs share an
// SM at HD <= 64 and measured slower at whisper's 1500 frames (PERF.md)
template <int NTB>
__device__ __forceinline__ void xprod_tf32(float (&acc)[NTB][4], const float* a_lane,
                                           const float* b_lane, int ld, int hd) {
#pragma unroll
  for (int j = 0; j < NTB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  for (int k0 = 0; k0 < hd; k0 += 16) {  // two k8 steps
    float part[NTB][4];
#pragma unroll
    for (int j = 0; j < NTB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
#pragma unroll
    for (int kk = k0; kk < k0 + 16; kk += 8) {
      uint32_t a[4], ah[4], al[4];
      ldmatrix_x4(a, a_lane + kk);
      split4(a, ah, al);
#pragma unroll
      for (int np = 0; np < NTB / 2; ++np) {
        uint32_t bf[4], bh[4], bl[4];
        ldmatrix_x4(bf, b_lane + np * 16 * ld + kk);
        split4(bf, bh, bl);
        mma_3xtf32_1(part[2 * np], ah, al, bh[0], bh[1], bl[0], bl[1]);
        mma_3xtf32_1(part[2 * np + 1], ah, al, bh[2], bh[3], bl[2], bl[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < NTB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
  }
}

// acc (16 rows x the warp's columns [c0, c0 + 8 nt)) += X B: X (16 x BT)
// in fp32 accumulators, B the streamed [BT][ld] tile
// the kernel's S / dP product in its element type
template <typename T, int NTB, int HDM>
__device__ __forceinline__ void xprod_t(float (&acc)[NTB][4], const T* a_lane, const T* b_lane,
                                        int ld, int hd) {
  if constexpr (sizeof(T) == 2)
    xprod<NTB, HDM>(acc, a_lane, b_lane, ld);
  else
    xprod_tf32<NTB>(acc, a_lane, b_lane, ld, hd);
}

template <typename T, int NTB, int NTW>
__device__ __forceinline__ void uprod(float (&acc)[NTW][4], const float (&x)[NTB][4],
                                      const T* tile, int ld, int c0, int nt, int lane) {
  if constexpr (sizeof(T) == 2) {
    const T* b_lane = tile + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + c0 + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < NTB / 2; ++kk) {
      const uint32_t pa[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                              pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                              pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                              pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < NTW / 2; ++np) {
        if (2 * np < nt) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, b_lane + kk * 16 * ld + np * 16);
          mma_bf16(acc[2 * np], pa, bf[0], bf[1]);
          mma_bf16(acc[2 * np + 1], pa, bf[2], bf[3]);
        }
      }
    }
  } else {  // split TF32; the tile's sum of each n-tile added to acc in fp32
    const float* b_lane = tile + (lane & 3) * ld + c0 + (lane >> 2);
    uint32_t ah[NTB][4], al[NTB][4];
#pragma unroll
    for (int kc = 0; kc < NTB; ++kc) {
      uint32_t a[4];
      acc_to_a(x[kc], lane, a);
      split4(a, ah[kc], al[kc]);
    }
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      if (j < nt) {
        float part[3][4];
        zero3(part);
#pragma unroll
        for (int kc = 0; kc < NTB; ++kc) {
          uint32_t bh0, bl0, bh1, bl1;
          split(__float_as_uint(b_lane[kc * 8 * ld + j * 8]), bh0, bl0);
          split(__float_as_uint(b_lane[(kc * 8 + 4) * ld + j * 8]), bh1, bl1);
          mma_3xtf32(part, ah[kc], al[kc], bh0, bh1, bl0, bl1);
        }
        add_3xtf32(acc[j], part);
      }
    }
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

template <typename T, int HDM, int NSPLIT, int BT, int MINB>
__global__ void __launch_bounds__(128 * NSPLIT, MINB) flash_bwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ D,
    T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv, int S, int Sk, int hd_arg,
    int causal, int window, float scale, Views st) {
  using C = Cfg<T, HDM, NSPLIT, BT>;
  constexpr int THREADS = C::THREADS, NTB = C::NTB, NTW = C::NTW;
  constexpr int E = 16 / sizeof(T);  // elements of 16 bytes
  const int hd = sizeof(T) == 2 ? HDM : hd_arg;  // bf16 is built per head dim
  const int ld = hd + C::PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* R1 = reinterpret_cast<T*>(smem_raw);  // [BM][ld]: K (dK/dV CTA) or Q (dQ CTA)
  T* R2 = R1 + BM * ld;                    // [BM][ld]: V or dO
  T* ring = R2 + BM * ld;                  // [STAGES][2][BT][ld]: Q, dO or K, V
  float* stats = reinterpret_cast<float*>(ring + STAGES * 2 * BT * ld);  // [STAGES][2][BT]
  float* swap = stats + STAGES * 2 * BT;   // [4][2][NTB * 4][32] (NSPLIT = 2)

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = warp % 4, half = warp / 4;  // row group; column half (NSPLIT = 2)
  const int g = lane >> 2, t = lane & 3;     // mma row group, thread in group
  const int h = blockIdx.x, b = blockIdx.z, H = gridDim.x;

  // the role: key blocks and query blocks interleaved, heaviest causal first
  const int nkb = (Sk + BM - 1) / BM, nqb = (S + BM - 1) / BM;
  const int y = blockIdx.y, m = min(nkb, nqb);
  bool kv;
  int blk;
  if (y < 2 * m) {
    kv = !(y & 1);
    blk = kv ? y / 2 : nqb - 1 - y / 2;
  } else {
    kv = nkb > nqb;
    blk = kv ? y - m : nqb - 1 - (y - m);
  }
  const int r0 = blk * BM;  // first resident row (a key or a query)

  const float* lse_g = lse + ((long long)b * H + h) * S;
  const float* D_g = D + ((long long)b * H + h) * S;
  const T* qg = q + b * st.q.b + h * st.q.h;
  const T* kg = k + b * st.k.b + h * st.k.h;
  const T* vg = v + b * st.v.b + h * st.v.h;
  const T* gg = dout + b * st.dout.b + h * st.dout.h;
  // resident R1, R2 and streamed T1, T2: (K, V; Q, dO) or (Q, dO; K, V)
  const T* R1g = kv ? kg : qg;
  const T* R2g = kv ? vg : gg;
  const T* T1g = kv ? qg : kg;
  const T* T2g = kv ? gg : vg;
  const long long R1s = kv ? st.k.s : st.q.s, R2s = kv ? st.v.s : st.dout.s;
  const long long T1s = kv ? st.q.s : st.k.s, T2s = kv ? st.dout.s : st.v.s;
  const int n_res = kv ? Sk : S, n_str = kv ? S : Sk;

  // the streamed tiles that hold a kept pair (the forward's ranges)
  int t_begin = 0, t_end = (n_str + BT - 1) / BT;
  if (causal) {
    if (kv) {  // rows >= key, and rows < key + window
      t_begin = r0 / BT;
      if (window > 0) t_end = min(t_end, (r0 + BM - 1 + window - 1) / BT + 1);
    } else {  // keys <= row, and keys > row - window
      t_end = min(t_end, (r0 + BM - 1) / BT + 1);
      if (window > 0) t_begin = max(0, r0 - window + 1) / BT;
    }
  }
  const int n_it = max(0, t_end - t_begin);

  // a dQ CTA's rows keep their lse and D in registers (rows g, g + 8)
  float lse_r[2] = {0.f, 0.f}, D_r[2] = {0.f, 0.f};
  if (!kv) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + rg * 16 + g + 8 * i;
      if (row < S) {
        lse_r[i] = lse_g[row];
        D_r[i] = D_g[row];
      }
    }
  }

  auto load_stream = [&](int slot, int tile) {
    const int row0 = tile * BT;
    T* dst = ring + slot * 2 * BT * ld;
    load_rows<T, THREADS>(dst, ld, T1g, T1s, row0, n_str, BT, hd);
    load_rows<T, THREADS>(dst + BT * ld, ld, T2g, T2s, row0, n_str, BT, hd);
    if (kv) {
      float* sd = stats + slot * 2 * BT;
      for (int i = threadIdx.x; i < 2 * BT; i += THREADS) {
        const int r = i < BT ? i : i - BT;
        const float* src = i < BT ? lse_g : D_g;
        const bool in = row0 + r < S;
        cp_async4(sd + i, in ? src + row0 + r : src, in ? 4 : 0);
      }
    }
  };
  if (n_it > 0) {
    load_rows<T, THREADS>(R1, ld, R1g, R1s, r0, n_res, BM, hd);
    load_rows<T, THREADS>(R2, ld, R2g, R2s, r0, n_res, BM, hd);
    load_stream(0, t_begin);
  }
  cp_async_commit();

  // kv: acc1 = dV, acc2 = dK; dQ CTA: acc1 = dQ
  float acc1[NTW][4], acc2[NTW][4];
#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc1[j][e] = acc2[j][e] = 0.f;

  const int ntw = hd / NSPLIT / 8, c0 = half * (hd / NSPLIT);
  const int a_off = (rg * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * E;
  const int b_off = ((lane & 7) + (lane >> 4) * 8) * ld + ((lane >> 3) & 1) * E;
  const float sl2 = scale * LOG2E;
  const int row_a = r0 + rg * 16 + g;  // this thread's resident rows: row_a, row_a + 8

  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // tile it landed; everyone is done with tile it - 1's slot
    if (it + 1 < n_it) load_stream((it + 1) % STAGES, t_begin + it + 1);
    cp_async_commit();
    const T* T1 = ring + (it % STAGES) * 2 * BT * ld;
    const T* T2 = T1 + BT * ld;
    const float* lse_s = stats + (it % STAGES) * 2 * BT;
    const float* D_s = lse_s + BT;
    const int s0 = (t_begin + it) * BT;  // first streamed row

    // x1 = S (or S^T), x2 = dP (or dP^T); split: each warp of a pair forms one
    float x1[NTB][4], x2[NTB][4];
    if constexpr (NSPLIT == 1) {
      xprod_t<T, NTB, HDM>(x1, R1 + a_off, T1 + b_off, ld, hd);
      xprod_t<T, NTB, HDM>(x2, R2 + a_off, T2 + b_off, ld, hd);
    } else {
      xprod_t<T, NTB, HDM>(x1, (half ? R2 : R1) + a_off, (half ? T2 : T1) + b_off, ld, hd);
    }

    // P where the tile needs no mask, or per element where it crosses one
    const int qa = kv ? s0 : r0, nq = kv ? BT : BM;
    const int ka = kv ? r0 : s0, nk = kv ? BM : BT;
    const bool masked = (causal && ka + nk - 1 > qa) ||
                        (window > 0 && ka <= qa + nq - 1 - window) || qa + nq > S ||
                        ka + nk > Sk;
    if (NSPLIT == 1 || half == 0) {
#pragma unroll
      for (int j = 0; j < NTB; ++j) {
        const float2 l2 = kv ? *reinterpret_cast<const float2*>(lse_s + j * 8 + 2 * t)
                             : make_float2(0.f, 0.f);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rr = row_a + 8 * (e >> 1), cc = s0 + j * 8 + 2 * t + (e & 1);
          const float l = kv ? ((e & 1) ? l2.y : l2.x) : lse_r[e >> 1];
          bool keep = true;
          if (masked) {
            const int qp = kv ? cc : rr, kp = kv ? rr : cc;
            keep = qp < S && kp < Sk && (!causal || kp <= qp) &&
                   (window <= 0 || kp > qp - window);
          }
          const float arg = x1[j][e] * sl2 - l;
          x1[j][e] = keep ? (sizeof(T) == 2 ? exp2_approx(arg) : exp2f(arg)) : 0.f;
        }
      }
    }
    if constexpr (NSPLIT == 2) {  // swap P and dP within the pair
      float* mine = swap + (rg * 2 + half) * NTB * 4 * 32 + lane;
      const float* theirs = swap + (rg * 2 + (half ^ 1)) * NTB * 4 * 32 + lane;
#pragma unroll
      for (int j = 0; j < NTB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[(j * 4 + e) * 32] = x1[j][e];
      pair_barrier(1 + rg);
#pragma unroll
      for (int j = 0; j < NTB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float other = theirs[(j * 4 + e) * 32];
          x2[j][e] = half ? x1[j][e] : other;
          x1[j][e] = half ? other : x1[j][e];
        }
    }
    // x2 = dS = P (dP - D)
#pragma unroll
    for (int j = 0; j < NTB; ++j) {
      const float2 d2 = kv ? *reinterpret_cast<const float2*>(D_s + j * 8 + 2 * t)
                           : make_float2(0.f, 0.f);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float d = kv ? ((e & 1) ? d2.y : d2.x) : D_r[e >> 1];
        x2[j][e] = x1[j][e] * (x2[j][e] - d);
      }
    }

    if (kv) {
      uprod<T, NTB, NTW>(acc1, x1, T2, ld, c0, ntw, lane);  // dV += P^T dO
      uprod<T, NTB, NTW>(acc2, x2, T1, ld, c0, ntw, lane);  // dK += dS^T Q
    } else {
      uprod<T, NTB, NTW>(acc1, x2, T1, ld, c0, ntw, lane);  // dQ += dS K
    }
  }
  cp_async_wait<0>();

  T* o1 = kv ? dv + b * st.dv.b + h * st.dv.h : dq + b * st.dq.b + h * st.dq.h;
  T* o2 = dk + b * st.dk.b + h * st.dk.h;
  const long long os1 = kv ? st.dv.s : st.dq.s, os2 = st.dk.s;
  const float f1 = kv ? 1.f : scale;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_a + 8 * i;
    if (row >= n_res) continue;
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      if (j < ntw) {
        const int col = c0 + j * 8 + 2 * t;
        store2(o1 + row * os1 + col, acc1[j][2 * i] * f1, acc1[j][2 * i + 1] * f1);
        if (kv) store2(o2 + row * os2 + col, acc2[j][2 * i] * scale, acc2[j][2 * i + 1] * scale);
      }
    }
  }
}

template <typename T, int HDM, int NSPLIT, int BT, int MINB = 1>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, void* dq, void* dk, void* dv, float* D, int B, int H, int S,
           int Sk, int HD, int causal, int window, float scale, const Views& st,
           cudaStream_t stream) {
  using C = Cfg<T, HDM, NSPLIT, BT>;
  auto kernel = flash_bwd_kernel<T, HDM, NSPLIT, BT, MINB>;
  // the kernel's attributes, set once per device (bit i: device i)
  static std::atomic<unsigned long long> ready{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(ready.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)C::smem_bytes(HDM));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    ready.fetch_or(bit, std::memory_order_release);
  }
  const long long rows = (long long)B * H * S;
  flash_bwd_dot_kernel<T><<<(unsigned)((rows + DOT_THREADS / 32 - 1) / (DOT_THREADS / 32)),
                            DOT_THREADS, 0, stream>>>(static_cast<const T*>(o),
                                                      static_cast<const T*>(dout), D, H, S, HD,
                                                      st.o, st.dout, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(H, (Sk + BM - 1) / BM + (S + BM - 1) / BM, B);
  kernel<<<grid, C::THREADS, C::smem_bytes(HD), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, D, static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), S, Sk, HD, causal, window, scale, st);
  return cudaGetLastError();
}

}  // namespace

// q, o, dout, dq: (B, H, S, HD) views; k, v, dk, dv: (B, H, Sk, HD) views;
// all of one dtype, the head dim contiguous: HD a multiple of 16 up to 256
// in fp32; 16 .. 128, 192 or 256 in bf16. strides: 24 element strides,
// (batch, head, row) of q, k, v, o, dout, dq, dk, dv in that order; those
// of q, k, v and dout whole 16-byte units and their bases 16-byte aligned
// (cp.async moves 16 bytes), those of dq, dk and dv even. lse: the
// forward's (B, H, S) fp32 row log-sum-exp (flash_fwd_launch's, log2
// units); D: (B, H, S) fp32 scratch. Returns the first failing launch's
// cudaError_t (0 on success).
extern "C" int flash_bwd_launch(const void* q, const void* k, const void* v, const void* o,
                                const void* dout, const float* lse, void* dq, void* dk,
                                void* dv, float* D, int B, int H, int S, int Sk, int HD,
                                int causal, int window, float scale, int is_bf16,
                                const long long* strides, void* stream) {
  if (HD <= 0 || HD % 16 != 0 || HD > MAX_HD || S <= 0 || Sk <= 0 || B <= 0 || H <= 0)
    return cudaErrorInvalidValue;
  const int esize = is_bf16 ? 2 : 4;
  const void* staged[4] = {q, k, v, dout};
  const int staged_view[4] = {0, 1, 2, 4};
  for (int i = 0; i < 4; ++i) {
    if (reinterpret_cast<uintptr_t>(staged[i]) % 16 != 0) return cudaErrorInvalidValue;
    for (int j = 0; j < 3; ++j)
      if (strides[3 * staged_view[i] + j] * esize % 16 != 0) return cudaErrorInvalidValue;
  }
  for (int i = 15; i < 24; ++i)  // dq, dk, dv: stores of two elements
    if (strides[i] % 2 != 0) return cudaErrorInvalidValue;
  View vw[8];
  for (int i = 0; i < 8; ++i) vw[i] = View{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const Views st{vw[0], vw[1], vw[2], vw[3], vw[4], vw[5], vw[6], vw[7]};
  cudaStream_t sm = static_cast<cudaStream_t>(stream);
#define FLASH_BWD_ARGS \
  q, k, v, o, dout, lse, dq, dk, dv, D, B, H, S, Sk, HD, causal, window, scale, st, sm
  // (T, HD range, warps per row group, streamed rows, CTAs an SM at least):
  // at HD <= 64 fp32 three CTAs fit an SM, so whisper's encoder call (288
  // CTAs) runs in one wave
  if (!is_bf16) {
    if (HD <= 64) return launch<float, 64, 1, 32, 3>(FLASH_BWD_ARGS);
    if (HD <= 128) return launch<float, 128, 1, 16>(FLASH_BWD_ARGS);
    return launch<float, 256, 2, 16>(FLASH_BWD_ARGS);
  }
  using bf16 = __nv_bfloat16;
  switch (HD) {
    case 16: return launch<bf16, 16, 1, 64>(FLASH_BWD_ARGS);
    case 32: return launch<bf16, 32, 1, 64>(FLASH_BWD_ARGS);
    case 48: return launch<bf16, 48, 1, 64>(FLASH_BWD_ARGS);
    case 64: return launch<bf16, 64, 1, 64>(FLASH_BWD_ARGS);
    case 80: return launch<bf16, 80, 1, 32>(FLASH_BWD_ARGS);
    case 96: return launch<bf16, 96, 1, 32>(FLASH_BWD_ARGS);
    case 112: return launch<bf16, 112, 1, 32>(FLASH_BWD_ARGS);
    case 128: return launch<bf16, 128, 1, 32>(FLASH_BWD_ARGS);
    case 192: return launch<bf16, 192, 2, 32>(FLASH_BWD_ARGS);
    case 256: return launch<bf16, 256, 2, 32>(FLASH_BWD_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef FLASH_BWD_ARGS
}
