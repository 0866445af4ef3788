// Mamba2 SSD chunk-local computation for sm_90a, on the tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/ssd/ssd_kernel.py
// (`ssd_chunk_kernel`, `_kernel`). Per (batch, head, chunk) of Q steps:
//   cum     = cumsum(dt * A)                          (Q,)
//   Y_intra = ((C B^T) o exp(cum_t - cum_tau) . [tau <= t]) @ (dt x)   (Q, P)
//   S_local = (B * exp(cum_Q - cum))^T @ (dt x)       (N, P)
//   a_tot   = exp(cum_Q)
// The inter-chunk recurrence over (a_tot, S_local) stays outside, in
// ops.ssd_forward.
//
// Layout. The kernel reads the model's tensors in place, through strides:
// x (B, L, H, P), dt (B, L, H), B and C (B, L, G, N) with G groups of H/G
// heads (G = H: B and C per head), the last dimension contiguous. x, B and
// C may be fp32 or bf16 (widened to fp32 in the kernel, as the TPU kernel
// widens them; widening is exact); dt and A are fp32. A ragged last chunk
// (L not a multiple of Q) reads as zero rows, which is what the TPU path's
// zero padding gives. Outputs: Y_intra (B, L, H, P), S_local
// (B, nc, H, N, P) and a_tot (B, nc, H), the layouts ops.ssd_forward's
// recurrence and sum read next.
//
// Design. One CTA of 256 threads takes one (batch, chunk, head); head h
// reads group h / (H/G). It forms that group's C B^T in shared memory and
// applies the head's decay mask to it, so C B^T is formed once per (chunk,
// head) and B and C are read once per head (the heads of a group read the
// same rows, mostly from L2). Every product runs on the tensor cores as
// split TF32 (3xTF32): a = a_hi + a_lo with a_hi = tf32(a), a_lo = tf32(a -
// a_hi) (rounded as cvt.rna.tf32 rounds, but on the integer ALU), and three
// mma.sync.m16n8k8 tf32 products (hi.hi, hi.lo, lo.hi, each into its own
// fp32 accumulator so the three chains overlap, summed small terms first),
// which keeps fp32 accuracy (plain TF32 keeps about three digits and
// breaks the 5e-5 bar). Then:
//   * u = dt x and G = (C B^T) o M go to shared memory: the m16n8 fp32
//     accumulator layout of C B^T is not the A-fragment layout of m16n8k8,
//     so G (formed in place of C B^T) is re-read as an A operand;
//   * Y = G u walks only the (t-tile, tau-tile) pairs on or below the
//     diagonal (the mask is exp(cum_t - cum_tau) where tau <= t, 0 above);
//   * S = (B o d_end)^T u reads B transposed from shared memory (ldmatrix
//     moves only 16-bit types, so fragments are 32-bit shared loads).
// The head's x is copied with cp.async into u's rows as it comes (fp32 or
// bf16) while B and C load and C B^T runs, and is widened and scaled by dt
// in place, a warp per row; B and C are loaded in batches of 16-byte
// loads; the cumulative decay is a block scan over four warps. Warps take
// the Y tiles in snake order over the t-tiles, so a heavy tile (many
// tau-tiles) pairs with a light one.
//
// One head per CTA: at the Zamba2 shape it measured faster than CTAs over
// 2, 4 or 8 of a group's heads sharing one C B^T, which leave fewer CTAs
// to hide each phase's latency (PERF.md). Clock stamps per phase showed the
// products bound by the rate of mma.sync TF32 on this card (about 4 cycles
// an m16n8k8 per SM; only wgmma reaches the 495 TFLOP/s peak), so 3xTF32
// through mma.sync does about as well as fp32 FMAs would. Splitting u and
// G into (hi, lo) pairs once, with Y and S fused on one warp, measured no
// faster and is not kept.
//
// Shared-memory rows are padded so every 32-bit fragment load is free of
// bank conflicts: B, u rows of N+8 / P+8 floats (stride = 8 or 24 mod 32:
// lanes (g, t) of a fragment read row t, column g), C and C B^T / G rows
// of N+4 / Q+4 floats (stride = 4 or 20 mod 32: lanes read row g, column
// t). Where Q, N, P are so large that separate buffers do not fit 227 KB
// (Q = N = 128), u takes C's place and x is loaded once C B^T is formed.
//
// The masked exponential: cum falls by up to |A| dt per step (|A| <= 16,
// dt up to about 0.3 in Mamba2), so cum_t - cum_tau for tau > t reaches
// +100 and more, and exp overflows to inf; the TPU kernel takes exp of the
// whole matrix and masks afterwards with `where`. Multiplying inf by a 0
// mask gives NaN, so this kernel evaluates exp(cum_t - cum_tau) only where
// tau <= t (there it is <= 1) and writes 0 elsewhere.
//
// Bound. At the Zamba2 prefill shape (B=1, L=512, H=80, G=1, Q=P=N=64,
// bf16 x, B and C) the bytes read once are x, dt, B and C of one group and
// Y, S, a_tot written: 26.5 MB (7.9 us at 3.35 TB/s). The products,
// counting C B^T once per group (this kernel forms it per head), are about
// 0.51 GFLOP, 1.5 GFLOP of TF32 products in three passes (3 us at 495
// TFLOP/s): the bytes bound it.
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

// Shared-memory plan of one CTA, offsets in floats (each a multiple of 4,
// so every buffer is 16-byte aligned). x lands in u's rows (row stride
// ldu floats) as loaded and is widened there.
struct Plan {
  int QP, NP, PP;              // Q, N, P padded to 16 (the mma tiles)
  int ldb, ldc, ldq, ldu;      // row strides of B, C, C B^T / G, u (floats)
  bool compact;                // u in C's place
  int Bs, Cs, CBs, Us, dt, cum, dend, total;
  __host__ __device__ Plan(int Q, int N, int P) {
    QP = round_up(Q, 16);
    NP = round_up(N, 16);
    PP = round_up(P, 16);
    ldb = NP + 8;
    ldc = NP + 4;
    ldq = QP + 4;
    ldu = PP + 8;
    const int sB = QP * ldb, sC = QP * ldc, sQ = QP * ldq, sU = QP * ldu;
    Bs = 0;
    Cs = Bs + sB;
    compact = (size_t)(Cs + sC + sQ + sU + 3 * QP) * 4 > MAX_SMEM;
    CBs = Cs + (compact ? imax(sC, sU) : sC);
    Us = compact ? Cs : CBs + sQ;
    dt = compact ? CBs + sQ : Us + sU;
    cum = dt + QP;
    dend = cum + QP;
    total = dend + QP;
  }
};

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

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const T* __restrict__ Bm,
                 const T* __restrict__ Cm, float* __restrict__ y, float* __restrict__ s_out,
                 float* __restrict__ a_tot, int L, int H, int G, int Q, int P, int N,
                 int vec_x, int vec_bc, Strides st) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float wsum[WARPS];
  const Plan pl(Q, N, P);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g8 = lane >> 2, t4 = lane & 3;
  const int h = blockIdx.x, grp = h / (H / G);
  const int c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int l0 = c * Q, rows = min(Q, L - l0);  // rows of the chunk inside the sequence
  const int QP = pl.QP, MT = QP / 16, NPR = pl.PP / 16, kq = (Q + 7) / 8;
  float* Bs = smem + pl.Bs;
  float* Cs = smem + pl.Cs;
  float* Gs = smem + pl.CBs;  // G is formed in place of C B^T
  float* CBs = smem + pl.CBs;
  float* Us = smem + pl.Us;
  float* dts = smem + pl.dt;
  float* cums = smem + pl.cum;
  float* dend = smem + pl.dend;
  const T* xh = x + b * st.xb + l0 * st.xl + h * st.xh;
  const int ldx = pl.ldu * 4;  // bytes between x's rows in u's place

  // x in flight during the loads and C B^T below (unless u shares C's place)
  if (!pl.compact) load_x(reinterpret_cast<char*>(Us), ldx, xh, st.xl, rows, P, vec_x);
  float d = 0.f;  // dt of step tid; rows past the chunk add dt = 0
  if (tid < rows) d = dt[b * st.db + (l0 + tid) * st.dl + h * st.dh];
  if (tid < QP) dts[tid] = d;
  load_bc(Bs, pl.ldb, Cs, pl.ldc, QP, pl.NP, Bm + b * st.bb + l0 * st.bl + grp * st.bg, st.bl,
          Cm + b * st.cb + l0 * st.cl + grp * st.cg, st.cl, rows, N, vec_bc);

  // cumulative log-decay: a block scan over the first QP / 32 warps
  {
    float v = d * A[h];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += up;
    }
    if (lane == 31) wsum[warp] = v;
    __syncthreads();  // also: B, C and dt are in shared memory
    for (int w = 0; w < warp; ++w) v += wsum[w];
    if (tid < QP) cums[tid] = v;
    if (tid == Q - 1) a_tot[((size_t)b * nc + c) * H + h] = expf(v);
  }

  // C B^T on and below the diagonal: unit (i, jp) is t-tile i and tau
  // columns [16 jp, 16 jp + 16), jp <= i
  {
    const int units = MT * (MT + 1) / 2, kn = (N + 7) / 8;
    for (int u = warp; u < units; u += WARPS) {
      int i = 0;
      while ((i + 1) * (i + 2) / 2 <= u) ++i;
      const int jp = u - i * (i + 1) / 2, r0 = 16 * i, col0 = 16 * jp;
      float acc[2][3][4] = {};
      for (int kk = 0; kk < kn; ++kk) {
        uint32_t ah[4], al[4], bh[2], bl[2];
        frag_a_mk(Cs, pl.ldc, r0, 8 * kk, g8, t4, ah, al);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          // B^T as the k x n operand: element (k, n) is B[col0 + 8q + n][k]
          const float* Brow = Bs + (col0 + 8 * q + g8) * pl.ldb + 8 * kk;
          split(Brow[t4], bh[0], bl[0]);
          split(Brow[t4 + 4], bh[1], bl[1]);
          mma3(acc[q], ah, al, bh, bl);
        }
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float* o = CBs + (r0 + g8) * pl.ldq + col0 + 8 * q + 2 * t4;
        o[0] = acc_sum(acc[q], 0);
        o[1] = acc_sum(acc[q], 1);
        o[8 * pl.ldq] = acc_sum(acc[q], 2);
        o[8 * pl.ldq + 1] = acc_sum(acc[q], 3);
      }
    }
  }
  __syncthreads();  // C B^T is whole; C is free
  if (pl.compact) load_x(reinterpret_cast<char*>(Us), ldx, xh, st.xl, rows, P, vec_x);
  cp_async_wait_all();
  __syncthreads();  // x is in u's rows

  // a warp per row: u = dt x, widened in place (the row's values are all
  // read before any is written, since a bf16 row is half a float row), and
  // G on and below the diagonal tiles (the tiles above are never read).
  // The exponent is <= 0 where it is taken, so __expf's error stays below
  // 1e-7 absolute.
#pragma unroll 2
  for (int tau = warp; tau < QP; tau += WARPS) {
    const T* xr = reinterpret_cast<const T*>(reinterpret_cast<const char*>(Us) + tau * ldx);
    const float dtau = dts[tau];
    float v[MAXD / 32];
#pragma unroll
    for (int i = 0; i < MAXD / 32; ++i) {
      const int p = lane + 32 * i;
      v[i] = (tau < rows && p < P) ? to_f(xr[p]) * dtau : 0.f;
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < MAXD / 32; ++i) {
      const int p = lane + 32 * i;
      if (p < pl.PP) Us[tau * pl.ldu + p] = v[i];
    }
  }
#pragma unroll 2
  for (int t = warp; t < QP; t += WARPS) {
    const float ct = cums[t];
#pragma unroll
    for (int i = 0; i < MAXD / 32; ++i) {
      const int tau = lane + 32 * i;
      if (tau <= (t | 15))
        Gs[t * pl.ldq + tau] = tau <= t ? CBs[t * pl.ldq + tau] * __expf(ct - cums[tau]) : 0.f;
    }
  }
  for (int tau = tid; tau < QP; tau += THREADS)
    dend[tau] = tau < Q ? __expf(cums[Q - 1] - cums[tau]) : 0.f;
  __syncthreads();

  float* yh = y + ((size_t)b * L + l0) * H * P + (size_t)h * P;  // Y rows H P apart
  float* sh = s_out + (((size_t)b * nc + c) * H + h) * N * P;   // S rows P apart
  // Y = G u: unit (i, jp) is t-tile i and p columns [16 jp, 16 jp + 16),
  // over tau-tiles 0 .. 2i+1; the units go to the warps in snake order
  const int yunits = MT * NPR;
  for (int k = 0; WARPS * k < yunits; ++k) {
    const int u = WARPS * k + ((k & 1) ? WARPS - 1 - warp : warp);
    if (u >= yunits) continue;
    const int i = u / NPR, col0 = 16 * (u - i * NPR), r0 = 16 * i;
    const int kend = min(2 * (i + 1), kq);
    float acc[2][3][4] = {};
#pragma unroll 2
    for (int kk = 0; kk < kend; ++kk) {
      uint32_t ah[4], al[4], bh[2], bl[2];
      frag_a_mk(Gs, pl.ldq, r0, 8 * kk, g8, t4, ah, al);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        frag_b_kn(Us, pl.ldu, 8 * kk, col0 + 8 * q, g8, t4, bh, bl);
        mma3(acc[q], ah, al, bh, bl);
      }
    }
    store_tile(yh, (long long)H * P, rows, P, acc, r0, col0, g8, t4);
  }

  // S = (B o d_end)^T u: unit (i, jp) is n-tile i and p columns
  // [16 jp, 16 jp + 16), over every tau-tile
  const int sunits = (pl.NP / 16) * NPR;
  for (int u = warp; u < sunits; u += WARPS) {
    const int i = u / NPR, col0 = 16 * (u - i * NPR), r0 = 16 * i;
    float acc[2][3][4] = {};
#pragma unroll 2
    for (int kk = 0; kk < kq; ++kk) {
      const int k0 = 8 * kk;
      const float d0 = dend[k0 + t4], d1 = dend[k0 + t4 + 4];
      const float* B0 = Bs + (k0 + t4) * pl.ldb + r0 + g8;
      const float* B1 = B0 + 4 * pl.ldb;
      uint32_t ah[4], al[4], bh[2], bl[2];
      split(B0[0] * d0, ah[0], al[0]);
      split(B0[8] * d0, ah[1], al[1]);
      split(B1[0] * d1, ah[2], al[2]);
      split(B1[8] * d1, ah[3], al[3]);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        frag_b_kn(Us, pl.ldu, k0, col0 + 8 * q, g8, t4, bh, bl);
        mma3(acc[q], ah, al, bh, bl);
      }
    }
    store_tile(sh, P, N, P, acc, r0, col0, g8, t4);
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
           void* y, void* s, void* a_tot, int Bsz, int L, int H, int G, int Q, int P, int N,
           const Strides& st, cudaStream_t stream) {
  const int es = sizeof(T);
  const Plan pl(Q, N, P);
  const size_t smem = (size_t)pl.total * 4;
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  auto al16 = [](long long v, int esz) { return (v * esz) % 16 == 0; };
  const int vec_x = reinterpret_cast<uintptr_t>(x) % 16 == 0 && (P * es) % 16 == 0 &&
                    al16(st.xb, es) && al16(st.xl, es) && al16(st.xh, es);
  const int vec_bc = reinterpret_cast<uintptr_t>(Bm) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(Cm) % 16 == 0 && (N * es) % 16 == 0 &&
                     al16(st.bb, es) && al16(st.bl, es) && al16(st.bg, es) &&
                     al16(st.cb, es) && al16(st.cl, es) && al16(st.cg, es);
  const dim3 grid(H, (L + Q - 1) / Q, Bsz);
  ssd_chunk_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), static_cast<float*>(y),
      static_cast<float*>(s), static_cast<float*>(a_tot), L, H, G, Q, P, N, vec_x, vec_bc, st);
  return cudaGetLastError();
}

}  // namespace

// x: (B, L, H, P) fp32 or bf16 (bf16 = 1); dt: (B, L, H) fp32; A: (H,)
// fp32 contiguous; Bm, Cm: (B, L, G, N) of x's type; strides in elements
// (last dimensions contiguous). Outputs, contiguous fp32: y (B, L, H, P),
// s (B, nc, H, N, P), a_tot (B, nc, H) with nc = ceil(L / Q). Returns the
// launch's cudaError_t (0 on success).
extern "C" int ssd_chunk_launch(const void* x, const void* dt, const void* A, const void* Bm,
                                const void* Cm, void* y, void* s, void* a_tot, int Bsz, int L,
                                int H, int G, int Q, int P, int N, int bf16, long long xb,
                                long long xl, long long xh, long long db, long long dl,
                                long long dh, long long bb, long long bl, long long bg,
                                long long cb, long long cl, long long cg, void* stream) {
  if (Q < 1 || Q > MAXD || P < 1 || P > MAXD || N < 1 || N > MAXD || G < 1 || H % G != 0 ||
      L < 1 || Bsz < 1)
    return cudaErrorInvalidValue;
  const Strides st{xb, xl, xh, db, dl, dh, bb, bl, bg, cb, cl, cg};
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, s, a_tot, Bsz, L, H, G, Q, P, N, st,
                                 strm);
  return launch<float>(x, dt, A, Bm, Cm, y, s, a_tot, Bsz, L, H, G, Q, P, N, st, strm);
}
