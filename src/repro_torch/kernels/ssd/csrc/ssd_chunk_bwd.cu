// Backward of the Mamba2 SSD chunk-local computation (K4-bwd) for sm_90a,
// on the tensor cores.
//
// No TPU kernel: the JAX package differentiates its jnp `ssd_chunked`
// (src/repro/models/ssm.py:84, from `ssm_block_train`). This is the
// backward of ssd_chunk.cu (K4): from the cotangents dY_intra, dS_local and
// d(a_tot) it gives dx, d(dt), dA, dB and dC. Per (batch, chunk, head),
// with cum = cumsum(dt A), M[t, tau] = exp(cum_t - cum_tau) for tau <= t
// (0 above), d_end = exp(cum_Q - cum), CB = C B^T and G = CB o M:
//   dG = dY u^T = (dY x^T) diag(dt)          (Q, Q), t >= tau
//   du = G^T dY + d_end o (B dS)              (Q, P);  dx = dt du
//   s  = u dS^T = diag(dt) (x dS^T)           (Q, N)
//   dcum = rowsum(dG o M o CB) - colsum(dG o M o CB) - e, e = rowsum(B o d_end o s),
//          plus sum(e) + da a_tot at step Q - 1
//   dla = reverse cumsum of dcum;  d(dt) = A dla + rowsum(x o du);  dA = sum(dt dla)
// and, summed over the group's heads h (B and C are the group's):
//   dC = (sum_h dG_h o M_h) B
//   dB = (sum_h dG_h o M_h)^T C + sum_h d_end_h o s_h
// (kernels/ssd/ref.py `chunk_bwd_ref` is the same function in PyTorch.)
//
// Layout. The kernel reads the forward's inputs as K4 does, in place through
// strides: x (B, L, H, P), dt (B, L, H), B and C (B, L, G, N), fp32 or bf16
// (kept in their dtype in shared memory); dY (B, L, H, P), dS (B, nc, H, N,
// P) and da (B, nc, H) are dense fp32. A ragged last chunk reads as zero
// rows. Outputs: dx (B, L, H, P), dB and dC (B, L, G, N) in x's dtype, each
// rounded once from fp32; d(dt) (B, L, H) fp32; dA's term per (batch,
// chunk, head), summed over batches and chunks in a fixed order by a
// second, small kernel. No float atomics: two calls give the same bits.
//
// Design. The work unit is (batch, chunk, group) x a block of HB of the
// group's heads: one CTA of 8 warps per unit, and the CL = ceil(heads per
// group / HB) CTAs of one (batch, chunk, group) form a thread-block
// cluster (CL <= 16: the portable size is 8, and the kernel allows the
// H100's non-portable 16; the last CTA may hold fewer heads). The wrapper
// picks CL from the card's residency (ssd_kernel.bwd_cluster: waves of
// clusters times heads a CTA), e.g. 3 CTAs of 16 heads at mamba2-780m's
// training step, every cluster in one wave, and 16 CTAs of 3 heads where
// the grid is a few (batch, chunk) units. Per CTA:
//   - B and C are loaded once, in their dtype, and each warp forms its
//     tiles of C B^T once into registers;
//   - a loop over the block's heads. Each head's x, dY and dS arrive by
//     cp.async into one of two stage buffers while the previous head
//     computes (one buffer where two do not fit: fp32 at N = 128); the next
//     head's x and dY go out at a head's start, its dS at the middle. Per
//     head: phase I, dY x^T on and below the diagonal (its epilogue applies
//     M, stores G, adds dG o M into the warp's register sum D and writes
//     the row and column partials of dcum) and x dS^T (its epilogue adds
//     d_end o s into the warp's register sum S of dB's term and writes e's
//     partials); phase II, du = d_end o (B dS) + G^T dY, writing dx and
//     rowsum(x o du)'s partials. Beside the next head's phase I, warp 0
//     adds the partials in a fixed order and takes the reverse cumsum of
//     dcum and the sums of e and dt dla by warp shuffles (in fp64: the row
//     and column sums cancel there), writing d(dt) and dA's term, and warp 1
//     computes the head after's cum and d_end (a ring of three slots; the
//     phase-I partials are double buffered);
//   - after the loop, dC = D B and dB = D^T C + S once per CTA, into shared
//     memory; the cluster's CTAs then sum their tiles through distributed
//     shared memory, each a share of the elements over the ranks in rank
//     order, and write dB and dC once. No per-head partials reach device
//     memory.
// Warps own fixed tiles across heads, so D, S and C B^T stay in registers:
// a warp's x dS^T, dB and dC tiles are a strip of one column tile, as are
// its du tiles, and two row tiles of a strip at a time share the fragments
// (split once) of the column tile's operand. dC and dB tiles (i, n) cost
// 2(i+1) and Q/8 - 2i k-steps, so every warp gets the same sum.
// Products run on mma.sync.m16n8k8 in TF32 with as many passes as the
// operands need: a bf16 value is exact in TF32, so a product of two bf16
// operands (C B^T) takes one pass, of a bf16 and an fp32 one two (hi.b +
// lo.b), of two fp32 ones three (3xTF32). u = dt x is never formed: dt
// scales the products' epilogues, so x dS^T and dY x^T keep x's exactness.
// Every FOLD k-steps go into fresh accumulators, added in fp32 (the tensor
// cores truncate as they accumulate; K3-bwd measured the drift). No wgmma:
// TF32 wgmma takes only K-major shared operands, and G^T dY, D^T C and B dS
// read an operand along its rows, so every product would need a transposed
// copy in shared memory, which the plan has no room for. No TMA: one bulk
// copy a padded row (256 a head) measured slower on an H100 than cp.async,
// and a tensor map's dense tiles would need swizzled fragment loads.

// The masked exponential: cum falls by up to |A| dt per step, so
// cum_t - cum_tau for tau > t passes exp's fp32 range (about 88.7) over a
// chunk in Mamba2's ranges (A = -16, dt = 0.1 over 64 steps). The JAX
// package forms exp of the whole matrix and masks it with `where`, whose
// backward multiplies the masked 0 by inf: NaN in d(dt) and dA. This kernel
// evaluates the exponential only where tau <= t, so it stays finite there.
//
// Bound. At mamba2-780m's training layout (2 x 1024 tokens, H = 48, P = 64,
// N = 128, G = 1, Q = 64, bf16 x, B, C) the bytes read and written once
// (x, dt, B, C, the fp32 cotangents dY, dS and da; dx, d(dt), dA, dB, dC)
// are 103.6 MB, 0.031 ms at 3.35 TB/s; the products the function needs are
// 4.1 GFLOP, 12.3 in three TF32 passes, 0.025 ms at 495 TFLOP/s: the bytes
// bound it. chip_smoke.py prints both counts, the design's own byte count
// (B and C once per CTA of a cluster, dA's fp64 terms; worked out, not
// measured) and its time; this design takes 0.28 ms there on an H100 80GB
// HBM3 at 700 W, 9x the bound: the products' fragment splits and the
// epilogues, not the bytes, set its pace (PERF.md).
//
// Limits: Q <= 64 (four 16-row tiles), P and N <= 128, and the shared
// memory plan (BwdPlan) within one CTA's 227 KB (fp32 at N = P = 128 does
// not fit, bf16 does). The wrapper refuses the rest.
#include <cooperative_groups.h>

#include <atomic>

#include "ssd_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int MAXQ_BWD = 64;
constexpr int FOLD = 4;         // k8 steps summed in fresh accumulators
constexpr int MAX_CLUSTER = 16;  // the H100's largest (non-portable) cluster
constexpr int RING = 3;         // per-head vector slots: the head, the one scanned, the next
constexpr int A_PER = 2;        // diagonal-and-below tiles of Q x Q a warp owns (<= 10 / 8)
constexpr int S_PER = 4;        // row tiles of a warp's strip (<= 4)

// Shared-memory plan, byte offsets (each a multiple of 16). Rows of fp32
// matrices are padded to 4 mod 32 floats, of bf16 ones to 4 mod 32 words,
// so that fragment loads along a row are free of bank conflicts; G's rows
// to 8 mod 32, as it is read down its columns. The scratch region holds
// the stage buffers during the head loop and dB's and dC's tiles after it.
struct BwdPlan {
  int QP, NP, PP, MT, NT, PT, HB, CL, stages;
  int ldbc, ldx, ldy, lds, ldg;  // row strides in elements
  int Bs, Cs, G, cum, dt, dend, rowp, colp, ep, xp, scratch, stage, sx, sy, out, total;
  __host__ __device__ BwdPlan(int Q, int N, int P, int HG, int cluster, int es) {
    QP = round_up(Q, 16);
    NP = round_up(N, 16);
    PP = round_up(P, 16);
    MT = QP / 16;
    NT = NP / 16;
    PT = PP / 16;
    HB = (HG + cluster - 1) / cluster;
    CL = (HG + HB - 1) / HB;  // no CTA without a head
    ldbc = NP + 16 / es;
    ldx = PP + 16 / es;
    ldy = lds = PP + 4;
    ldg = QP + 8;
    Bs = 0;
    Cs = Bs + QP * ldbc * es;
    G = Cs + QP * ldbc * es;
    cum = G + QP * ldg * 4;  // RING slots of cum (double), dt and d_end
    dt = cum + RING * QP * 8;
    dend = dt + RING * QP * 4;
    rowp = dend + RING * QP * 4;
    colp = rowp + 2 * MT * MT * 16 * 4;  // two of each phase-I partial: by head parity
    ep = colp + 2 * MT * MT * 16 * 4;
    xp = ep + 2 * NT * QP * 4;
    scratch = xp + PT * QP * 4;
    sx = QP * ldx * es;
    sy = QP * ldy * 4;
    stage = sx + sy + NP * lds * 4;
    out = 2 * QP * NP * 4;
    stages = scratch + imax(2 * stage, out) <= (int)MAX_SMEM ? 2 : 1;
    total = scratch + imax(stages * stage, out);
  }
};

__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
// two neighbours at p (even element offset in a row of even length: aligned)
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void cp_async_wait_pending(int n) {
  if (n <= 0)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else if (n == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else if (n == 2)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 4;\n" ::: "memory");
}

// rows [0, rows) x cols [0, cols) of a row-major matrix of E (row stride rs
// elements) into rows ld elements apart at dst: cp.async when every row is
// in 16-byte units, else plain loads and stores
template <typename E>
__device__ void load_rows(E* dst, int ld, const E* src, long long rs, int rows, int cols,
                          bool vec) {
  if (vec) {  // 16-byte chunks, row-major; two divisions a call, none a chunk
    constexpr int V = 16 / sizeof(E);
    const int cpr = cols / V, dr = THREADS / cpr, dq = THREADS - dr * cpr;
    int r = threadIdx.x / cpr, q = threadIdx.x - r * cpr;
    while (r < rows) {
      cp_async16(dst + r * ld + V * q, src + r * rs + V * q);
      r += dr;
      q += dq;
      if (q >= cpr) {
        q -= cpr;
        ++r;
      }
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += THREADS) {
      const int r = e / cols, k = e - r * cols;
      dst[r * ld + k] = src[r * rs + k];
    }
  }
}

// zeros where a (rows x cols) matrix stored as [rpad][ld] is padded to
// rpad x cpad: the rows below and the columns to the right
template <typename E>
__device__ void zero_pad(E* M, int ld, int rows, int cols, int rpad, int cpad) {
  for (int e = threadIdx.x; e < (rpad - rows) * cpad; e += THREADS) {
    const int r = e / cpad;
    from_f(M + (rows + r) * ld + e - r * cpad, 0.f);
  }
  const int w = cpad - cols;
  for (int e = threadIdx.x; e < rows * w; e += THREADS) {
    const int r = e / w;
    from_f(M + r * ld + cols + e - r * w, 0.f);
  }
}

// v as TF32 parts: a bf16 value is exact (hi only), an fp32 one is split
__device__ __forceinline__ void parts(float v, uint32_t& hi, uint32_t& lo) { split(v, hi, lo); }
__device__ __forceinline__ void parts(__nv_bfloat16 v, uint32_t& hi, uint32_t& lo) {
  hi = static_cast<uint32_t>(__bfloat16_as_ushort(v)) << 16;
  lo = 0u;
}

// fragment loaders of one 16 x 16 unit: A rows m0.., B columns n0.. (two
// n-tiles q = 0, 1), k-step kk; `exact` when the element type is bf16
template <typename E>
struct AMK {  // A row-major [m][k]
  static constexpr bool exact = sizeof(E) == 2;
  const E* M;
  int ld, m0, g, t;
  __device__ __forceinline__ void operator()(int kk, uint32_t (&h)[4], uint32_t (&l)[4]) const {
    const E* p = M + (m0 + g) * ld + 8 * kk + t;
    parts(p[0], h[0], l[0]);
    parts(p[8 * ld], h[1], l[1]);
    parts(p[4], h[2], l[2]);
    parts(p[8 * ld + 4], h[3], l[3]);
  }
};
template <typename E>
struct AKM {  // A stored [k][m]
  static constexpr bool exact = sizeof(E) == 2;
  const E* M;
  int ld, m0, g, t;
  __device__ __forceinline__ void operator()(int kk, uint32_t (&h)[4], uint32_t (&l)[4]) const {
    const E* p = M + (8 * kk + t) * ld + m0 + g;
    parts(p[0], h[0], l[0]);
    parts(p[8], h[1], l[1]);
    parts(p[4 * ld], h[2], l[2]);
    parts(p[4 * ld + 8], h[3], l[3]);
  }
};
template <typename E>
struct BKN {  // B row-major [k][n]
  static constexpr bool exact = sizeof(E) == 2;
  const E* M;
  int ld, n0, g, t;
  __device__ __forceinline__ void operator()(int kk, int q, uint32_t (&h)[2],
                                             uint32_t (&l)[2]) const {
    const E* p = M + (8 * kk + t) * ld + n0 + 8 * q + g;
    parts(p[0], h[0], l[0]);
    parts(p[4 * ld], h[1], l[1]);
  }
};
template <typename E>
struct BNK {  // B stored [n][k]
  static constexpr bool exact = sizeof(E) == 2;
  const E* M;
  int ld, n0, g, t;
  __device__ __forceinline__ void operator()(int kk, int q, uint32_t (&h)[2],
                                             uint32_t (&l)[2]) const {
    const E* p = M + (n0 + 8 * q + g) * ld + 8 * kk + t;
    parts(p[0], h[0], l[0]);
    parts(p[4], h[1], l[1]);
  }
};

// out[mi] += A_mi B over the k-steps [k0[mi], k1[mi]) for MI row tiles of
// 16 that share one column tile of 16 (two n8 tiles q = 0, 1) of B, in
// TF32: hi.hi, plus hi.lo unless B is exact, plus lo.hi unless A is exact
// (the two small terms in one accumulator). B's fragments are loaded, and
// split, once a k-step for all row tiles; A's loader takes each row tile's
// first row. Every FOLD steps go into fresh accumulators, then into out in
// fp32 (the tensor cores truncate as they accumulate). The FOLD steps are
// unrolled with the loads unconditional (a step outside a tile's range
// reads an in-range step and multiplies a zero A fragment), so the loads
// of several steps are in flight together. out[mi][q][e] is the m16n8
// accumulator layout: row g + 8 (e / 2), column 8 q + 2 t + e % 2.
template <int MI, typename FA, typename FB>
__device__ __forceinline__ void strip_product(float (&out)[MI][2][4], FA fa,
                                              const int (&m0)[MI], const int (&k0)[MI],
                                              const int (&k1)[MI], const FB& fb) {
  int lo = 1 << 30, hi = 0;  // the steps some row tile takes
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    lo = min(lo, k0[mi]);
    hi = max(hi, k1[mi]);
  }
  for (int kb = lo; kb < hi; kb += FOLD) {
    float acc[MI][2][2][4] = {};
#pragma unroll
    for (int u = 0; u < FOLD; ++u) {
      const int k = kb + u, kk = min(k, hi - 1);
      uint32_t bh[2][2], bl[2][2];
#pragma unroll
      for (int q = 0; q < 2; ++q) fb(kk, q, bh[q], bl[q]);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const uint32_t live = k >= k0[mi] && k < k1[mi] ? 0xffffffffu : 0u;
        uint32_t ah[4], al[4];
        fa.m0 = m0[mi];
        fa(kk, ah, al);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          ah[r] &= live;
          al[r] &= live;
        }
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          mma_tf32(acc[mi][q][0], ah, bh[q]);
          if constexpr (!FB::exact) mma_tf32(acc[mi][q][1], ah, bl[q]);
          if constexpr (!FA::exact) mma_tf32(acc[mi][q][1], al, bh[q]);
        }
      }
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) out[mi][q][e] += acc[mi][q][1][e] + acc[mi][q][0][e];
  }
}

// one 16 x 16 unit: rows m0.., k-steps [k0, k1)
template <typename FA, typename FB>
__device__ __forceinline__ void unit_product(float (&out)[2][4], FA fa, int m0, int k0, int k1,
                                             const FB& fb) {
  float (&o)[1][2][4] = reinterpret_cast<float (&)[1][2][4]>(out);
  const int m[1] = {m0}, a[1] = {k0}, b[1] = {k1};
  strip_product<1>(o, fa, m, a, b, fb);
}

// the sum over a quad's four lanes (one accumulator row), over the eight
// quads (one accumulator column) and over the warp, in a fixed order
template <typename F>
__device__ __forceinline__ F quad_sum(F v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
template <typename F>
__device__ __forceinline__ F column_sum(F v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}
template <typename F>
__device__ __forceinline__ F warp_sum(F v) { return column_sum(quad_sum(v)); }

// the diagonal-and-below tile v of Q x Q as (row tile i, column tile j)
__device__ __forceinline__ void tri_tile(int v, int& i, int& j) {
  i = 0;
  while ((i + 1) * (i + 2) / 2 <= v) ++i;
  j = v - i * (i + 1) / 2;
}
// the slot-th of those tiles that warp w owns: w, then 2 WARPS - 1 - w
// (the tiles past the first WARPS go to the last warps; warps 0 and 1 also
// scan and prepare the per-head vectors)
__device__ __forceinline__ int tri_owned(int w, int slot) {
  return slot == 0 ? w : 2 * WARPS - 1 - w;
}

// Warp w's strip of a matrix of rt x ct tiles of 16 (ct <= WARPS): column
// tile w % ct and row tiles w / ct, + per, ..., per = WARPS / ct warps a
// column (warps past per ct hold none). Slot sl is row tile row(sl), valid
// below rt. The strip's tiles share B's column tile.
struct Strip {
  int col, first, per;
  bool on;
  __device__ Strip(int w, int ct) {
    per = imax(1, WARPS / ct);
    col = w % ct;
    first = w / ct;
    on = w < per * ct;
  }
  __device__ int row(int sl) const { return first + sl * per; }
  __device__ bool valid(int sl, int rt) const { return on && row(sl) < rt; }
};

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
ssd_chunk_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const T* __restrict__ Bm,
                     const T* __restrict__ Cm, const float* __restrict__ dy,
                     const float* __restrict__ ds, const float* __restrict__ da,
                     T* __restrict__ dx, float* __restrict__ ddt, T* __restrict__ dB,
                     T* __restrict__ dC, double* __restrict__ dA_part, int L, int H, int G,
                     int Q, int P, int N, int cluster_size, int vec_x, int vec_bc, int vec_d,
                     Strides st) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int HG = H / G;
  const BwdPlan pl(Q, N, P, HG, cluster_size, sizeof(T));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g8 = lane >> 2, t4 = lane & 3;
  const int rank = (int)cluster.block_rank(), grp = blockIdx.x / pl.CL;
  const int c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int h0 = grp * HG + rank * pl.HB, nh = min(pl.HB, HG - rank * pl.HB);
  const int l0 = c * Q, rows = min(Q, L - l0);  // rows of the chunk inside the sequence
  const int QP = pl.QP, MT = pl.MT, NT = pl.NT, PT = pl.PT;
  const int kq = (Q + 7) / 8, kn = (N + 7) / 8, kp = (P + 7) / 8;
  const int n_a = MT * (MT + 1) / 2;
  T* Bs = reinterpret_cast<T*>(smem + pl.Bs);
  T* Cs = reinterpret_cast<T*>(smem + pl.Cs);
  float* Gs = reinterpret_cast<float*>(smem + pl.G);  // G of the head; D after the loop
  double* cums = reinterpret_cast<double*>(smem + pl.cum);  // [RING][QP] each
  float* dts = reinterpret_cast<float*>(smem + pl.dt);
  float* dends = reinterpret_cast<float*>(smem + pl.dend);
  float* rowp = reinterpret_cast<float*>(smem + pl.rowp);  // [2][i][j][16]: row sums of dG o G
  float* colp = reinterpret_cast<float*>(smem + pl.colp);  // [2][i][j][16]: column sums
  float* ep = reinterpret_cast<float*>(smem + pl.ep);      // [2][jn][QP]: e per x dS^T tile
  float* xp = reinterpret_cast<float*>(smem + pl.xp);      // [jp][QP]: rowsum(x o du) per du tile
  unsigned char* scratch = smem + pl.scratch;
  const size_t row0 = (size_t)b * L + l0;  // (batch, step) row of the chunk's first step
  const T* xc = x + b * st.xb + l0 * st.xl;
  auto stage_x = [&](int s) { return reinterpret_cast<T*>(scratch + s * pl.stage); };
  auto stage_y = [&](int s) { return reinterpret_cast<float*>(scratch + s * pl.stage + pl.sx); };
  auto stage_s = [&](int s) {
    return reinterpret_cast<float*>(scratch + s * pl.stage + pl.sx + pl.sy);
  };
  // head j's x and dY (part 0) or dS (part 1) into stage s, one cp.async
  // group each: the next head's two parts go out at two points of a head,
  // so that their requests do not all queue at once beside the products'
  auto issue = [&](int j, int s, int part) {
    const int h = h0 + j;
    if (part == 0) {
      load_rows(stage_x(s), pl.ldx, xc + h * st.xh, st.xl, rows, P, vec_x);
      load_rows(stage_y(s), pl.ldy, dy + (row0 * H + h) * P, (long long)H * P, rows, P, vec_d);
    } else {
      load_rows(stage_s(s), pl.lds, ds + (((size_t)b * nc + c) * H + h) * N * P, P, N, P, vec_d);
    }
    cp_async_commit();
  };
  // dt of head j at steps 2 lane and 2 lane + 1 (0 past the chunk)
  auto head_dt = [&](int j, float& d0, float& d1) {
    const int h = h0 + j, t0 = 2 * lane;
    d0 = t0 < rows ? dt[b * st.db + (l0 + t0) * st.dl + h * st.dh] : 0.f;
    d1 = t0 + 1 < rows ? dt[b * st.db + (l0 + t0 + 1) * st.dl + h * st.dh] : 0.f;
  };
  // one warp: head j's dt, cum = cumsum(dt A) (in fp64: M and d_end take
  // differences of it) and d_end into ring slot j % RING; lane l holds
  // steps 2l and 2l + 1 (their dt d0, d1), then a shuffle scan over the lanes
  auto head_vectors = [&](int j, float d0, float d1) {
    const int h = h0 + j, slot = j % RING, t0 = 2 * lane;
    const double Ah = A[h], v0 = (double)d0 * Ah, v1 = (double)d1 * Ah;
    double s = v0 + v1;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double up = __shfl_up_sync(0xffffffffu, s, off);
      if (lane >= off) s += up;
    }
    double before = __shfl_up_sync(0xffffffffu, s, 1);
    if (lane == 0) before = 0.0;
    const double c0 = before + v0, c1 = c0 + v1;
    const double c_end = __shfl_sync(0xffffffffu, (Q - 1) & 1 ? c1 : c0, (Q - 1) >> 1);
    double* cum = cums + slot * QP;
    if (t0 < QP) {
      cum[t0] = c0;
      dts[slot * QP + t0] = d0;
      dends[slot * QP + t0] = t0 < Q ? expf((float)(c_end - c0)) : 0.f;
    }
    if (t0 + 1 < QP) {
      cum[t0 + 1] = c1;
      dts[slot * QP + t0 + 1] = d1;
      dends[slot * QP + t0 + 1] = t0 + 1 < Q ? expf((float)(c_end - c1)) : 0.f;
    }
  };
  // one warp: head j's dcum from the partials (in fp64, as the row and
  // column sums of dG o G cancel in its reverse cumsum), its reverse cumsum
  // dla by shuffles, d(dt) and dA's term; lane l holds steps 2l and 2l + 1
  auto scan = [&](int j) {
    const int h = h0 + j, slot = j % RING, par = j & 1;
    const float* rp_h = rowp + par * MT * MT * 16;
    const float* cp_h = colp + par * MT * MT * 16;
    const float* ep_h = ep + par * NT * QP;
    const float* dtv = dts + slot * QP;
    double dc[2], ev[2], xd[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int t = 2 * lane + k;
      dc[k] = ev[k] = xd[k] = 0.0;
      if (t < QP) {
        const int it = t >> 4, r = t & 15;
        float rs = 0.f, cs = 0.f, e = 0.f, xs = 0.f;  // unrolled: the loads go out together
#pragma unroll
        for (int k4 = 0; k4 < MAXQ_BWD / 16; ++k4) {
          if (k4 <= it) rs += rp_h[(it * MT + k4) * 16 + r];
          if (k4 >= it && k4 < MT) cs += cp_h[(k4 * MT + it) * 16 + r];
        }
#pragma unroll
        for (int k8 = 0; k8 < MAXD / 16; ++k8) {
          if (k8 < NT) e += ep_h[k8 * QP + t];
          if (k8 < PT) xs += xp[k8 * QP + t];
        }
        dc[k] = ((double)rs - cs) - e;
        ev[k] = e;
        xd[k] = xs;
      }
    }
    const size_t cell = ((size_t)b * nc + c) * H + h;
    const double a_tot = expf((float)cums[slot * QP + Q - 1]);
    const double end = warp_sum(ev[0] + ev[1]) + (double)da[cell] * a_tot;
    if (2 * lane == Q - 1) dc[0] += end;
    if (2 * lane + 1 == Q - 1) dc[1] += end;
    double s_in = dc[0] + dc[1];  // suffix sums over the lanes
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double dn = __shfl_down_sync(0xffffffffu, s_in, off);
      if (lane + off < 32) s_in += dn;
    }
    double after = __shfl_down_sync(0xffffffffu, s_in, 1);
    if (lane == 31) after = 0.0;
    const double dla1 = dc[1] + after, dla0 = dc[0] + dla1;
    const double Ah = A[h];
    const int t0 = 2 * lane;
    if (t0 < rows) ddt[(row0 + t0) * H + h] = (float)(Ah * dla0 + xd[0]);
    if (t0 + 1 < rows) ddt[(row0 + t0 + 1) * H + h] = (float)(Ah * dla1 + xd[1]);
    double pa = 0.0;
    if (t0 < QP) pa += dtv[t0] * dla0;
    if (t0 + 1 < QP) pa += dtv[t0 + 1] * dla1;
    pa = warp_sum(pa);
    if (lane == 0) dA_part[cell] = pa;
  };

  // zeros in the pads (cp.async writes only the data), B and C, heads 0 and 1
  zero_pad(Bs, pl.ldbc, rows, N, QP, pl.NP);
  zero_pad(Cs, pl.ldbc, rows, N, QP, pl.NP);
  for (int s = 0; s < pl.stages; ++s) {
    zero_pad(stage_x(s), pl.ldx, rows, P, QP, pl.PP);
    zero_pad(stage_y(s), pl.ldy, rows, P, QP, pl.PP);
    zero_pad(stage_s(s), pl.lds, N, P, pl.NP, pl.PP);
  }
  load_rows(Bs, pl.ldbc, Bm + b * st.bb + l0 * st.bl + grp * st.bg, st.bl, rows, N, vec_bc);
  load_rows(Cs, pl.ldbc, Cm + b * st.cb + l0 * st.cl + grp * st.cg, st.cl, rows, N, vec_bc);
  cp_async_commit();
  issue(0, 0, 0);
  issue(0, 0, 1);
  const bool two = pl.stages == 2 && nh > 1;
  if (two) {
    issue(1, 1, 0);
    issue(1, 1, 1);
  }
  float dt0, dt1;  // warp 1: the next head's dt, loaded a head ahead
  if (warp == 0) {
    head_dt(0, dt0, dt1);
    head_vectors(0, dt0, dt1);
  }
  if (warp == 1 && nh > 1) head_dt(1, dt0, dt1);
  cp_async_wait_pending(two ? 4 : 2);
  __syncthreads();  // B, C, the pads' zeros and head 0's vectors

  const Strip ss(warp, NT), us(warp, PT);  // the warp's x dS^T (and dB, dC) and du strips
  // C B^T: each warp's diagonal-and-below tiles, once for all heads
  float CBr[A_PER][2][4] = {}, Dr[A_PER][2][4] = {}, Sr[S_PER][2][4] = {};
#pragma unroll
  for (int sl = 0; sl < A_PER; ++sl) {
    const int v = tri_owned(warp, sl);
    if (v < n_a) {
      int i, jp;
      tri_tile(v, i, jp);
      unit_product(CBr[sl], AMK<T>{Cs, pl.ldbc, 0, g8, t4}, 16 * i, 0, kn,
                   BNK<T>{Bs, pl.ldbc, 16 * jp, g8, t4});
    }
  }

  for (int j = 0; j < nh; ++j) {
    const int s = pl.stages == 2 ? (j & 1) : 0, par = j & 1, h = h0 + j, slot = j % RING;
    // the next head's stage was freed by the last barrier; with one stage,
    // this head's loads go out now
    const bool next = pl.stages == 2 && j > 0 && j + 1 < nh;
    if (next) issue(j + 1, (j + 1) & 1, 0);
    if (pl.stages == 1 && j > 0) {
      issue(j, 0, 0);
      issue(j, 0, 1);
    }
    cp_async_wait_pending(next ? 1 : (j == 0 && two) ? 2 : 0);
    __syncthreads();  // head j's x, dY and dS are in shared memory
    // off the barriers' path: warp 0 scans the last head, warp 1 prepares
    // the next head's vectors (three ring slots: neither touches head j's;
    // they were written before the last barrier)
    if (warp == 0 && j > 0) scan(j - 1);
    if (warp == 1 && j + 1 < nh) {
      head_vectors(j + 1, dt0, dt1);
      if (j + 2 < nh) head_dt(j + 2, dt0, dt1);
    }
    const T* Xs = stage_x(s);
    const float* Ys = stage_y(s);
    const float* Ss = stage_s(s);
    const float* dtv = dts + slot * QP;
    const double* cum = cums + slot * QP;
    const float* dend = dends + slot * QP;
    float* rp_h = rowp + par * MT * MT * 16;
    float* cp_h = colp + par * MT * MT * 16;
    float* ep_h = ep + par * NT * QP;

    // I.a dY x^T on and below the diagonal: G = CB o M stored, D += dG o M,
    //     the row and column sums of dG o G per tile
#pragma unroll
    for (int sl = 0; sl < A_PER; ++sl) {
      const int v = tri_owned(warp, sl);
      if (v < n_a) {
        int i, jp;
        tri_tile(v, i, jp);
        const int r0 = 16 * i, c0 = 16 * jp;
        float dg[2][4] = {};
        unit_product(dg, AMK<float>{Ys, pl.ldy, 0, g8, t4}, r0, 0, kp,
                     BNK<T>{Xs, pl.ldx, c0, g8, t4});
        float rs[2] = {0.f, 0.f}, cs[2][2] = {};
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = r0 + g8 + 8 * (e >> 1), tau = c0 + 8 * q + 2 * t4 + (e & 1);
            // the exponent is <= 0 where it is taken
            const float m = tau <= t ? expf((float)(cum[t] - cum[tau])) : 0.f;
            const float cb = CBr[sl][q][e], dgm = dg[q][e] * dtv[tau] * m, gg = dgm * cb;
            Gs[t * pl.ldg + tau] = cb * m;
            Dr[sl][q][e] += dgm;
            rs[e >> 1] += gg;
            cs[q][e & 1] += gg;
          }
        float* rp = rp_h + (i * MT + jp) * 16;
        float* cp = cp_h + (i * MT + jp) * 16;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const float w = quad_sum(rs[hr]);
          if (t4 == 0) rp[g8 + 8 * hr] = w;
        }
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const float w = column_sum(cs[q][k]);
            if (g8 == 0) cp[8 * q + 2 * t4 + k] = w;
          }
      }
    }
    // I.c x dS^T: S += d_end o dt o (x dS^T), e's partials; two row tiles
    //     of the warp's strip at a time share dS's fragments
#pragma unroll
    for (int s0 = 0; s0 < S_PER; s0 += 2) {
      float o[2][2][4] = {};
      int m0[2], k0[2], k1[2];
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        const bool ok = ss.valid(s0 + d, MT);
        m0[d] = ok ? 16 * ss.row(s0 + d) : 0;
        k0[d] = ok ? 0 : kp;
        k1[d] = ok ? kp : 0;
      }
      if (!ss.valid(s0, MT)) continue;
      strip_product<2>(o, AMK<T>{Xs, pl.ldx, 0, g8, t4}, m0, k0, k1,
                       BNK<float>{Ss, pl.lds, 16 * ss.col, g8, t4});
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        if (!ss.valid(s0 + d, MT)) continue;
        const int r0 = m0[d], c0 = 16 * ss.col;
        float er[2] = {0.f, 0.f};
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int tau = r0 + g8 + 8 * (e >> 1), n = c0 + 8 * q + 2 * t4 + (e & 1);
            const float bs = o[d][q][e] * dtv[tau] * dend[tau];
            Sr[s0 + d][q][e] += bs;
            er[e >> 1] += to_f(Bs[tau * pl.ldbc + n]) * bs;
          }
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const float w = quad_sum(er[hr]);
          if (t4 == 0) ep_h[ss.col * QP + r0 + g8 + 8 * hr] = w;
        }
      }
    }
    __syncthreads();  // G; the last head's scan is done with xp
    if (next) issue(j + 1, (j + 1) & 1, 1);

    // II. du = d_end o (B dS) + G^T dY over t >= tau; dx = dt du; two row
    //     tiles of the warp's strip at a time share dS's and dY's fragments
    {
      T* dxh = dx + row0 * H * P + (size_t)h * P;  // rows H P apart
      const int c0 = 16 * us.col;
#pragma unroll
      for (int s0 = 0; s0 < S_PER; s0 += 2) {
        if (!us.valid(s0, MT)) continue;
        float o[2][2][4] = {};
        int m0[2], k0[2], k1[2];
#pragma unroll
        for (int d = 0; d < 2; ++d) {
          const bool ok = us.valid(s0 + d, MT);
          m0[d] = ok ? 16 * us.row(s0 + d) : 0;
          k0[d] = ok ? 0 : kn;
          k1[d] = ok ? kn : 0;
        }
        strip_product<2>(o, AMK<T>{Bs, pl.ldbc, 0, g8, t4}, m0, k0, k1,
                         BKN<float>{Ss, pl.lds, c0, g8, t4});
#pragma unroll
        for (int d = 0; d < 2; ++d) {
          const bool ok = us.valid(s0 + d, MT);
#pragma unroll
          for (int q = 0; q < 2; ++q)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[d][q][e] *= dend[m0[d] + g8 + 8 * (e >> 1)];
          k0[d] = ok ? 2 * us.row(s0 + d) : kq;
          k1[d] = ok ? kq : 0;
        }
        strip_product<2>(o, AKM<float>{Gs, pl.ldg, 0, g8, t4}, m0, k0, k1,
                         BKN<float>{Ys, pl.ldy, c0, g8, t4});
#pragma unroll
        for (int d = 0; d < 2; ++d) {
          if (!us.valid(s0 + d, MT)) continue;
          const int r0 = m0[d];
          float xr[2] = {0.f, 0.f};
#pragma unroll
          for (int q = 0; q < 2; ++q)
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {  // columns p, p + 1 of row tau
              const int tau = r0 + g8 + 8 * hr, p = c0 + 8 * q + 2 * t4;
              if (tau >= rows || p >= P) continue;
              const float du0 = o[d][q][2 * hr], du1 = o[d][q][2 * hr + 1];
              T* out = dxh + (size_t)tau * H * P + p;
              const float x0 = to_f(Xs[tau * pl.ldx + p]), x1 = to_f(Xs[tau * pl.ldx + p + 1]);
              if (P % 2 == 0) {  // p + 1 < P, and the pair is aligned
                store2(out, dtv[tau] * du0, dtv[tau] * du1);
              } else {
                from_f(out, dtv[tau] * du0);
                if (p + 1 < P) from_f(out + 1, dtv[tau] * du1);
              }
              xr[hr] += x0 * du0 + x1 * du1;  // x's pads are zero
            }
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const float w = quad_sum(xr[hr]);
            if (t4 == 0) xp[us.col * QP + r0 + g8 + 8 * hr] = w;
          }
        }
      }
    }
    __syncthreads();  // the partials; head j's stage is free
  }
  if (warp == 0) scan(nh - 1);  // beside the products below: it reads no scratch

  // D (the sum of dG o M over the block's heads) into G's place; G was last
  // read before the loop's last barrier
#pragma unroll
  for (int sl = 0; sl < A_PER; ++sl) {
    const int v = tri_owned(warp, sl);
    if (v < n_a) {
      int i, jp;
      tri_tile(v, i, jp);
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          Gs[(16 * i + g8 + 8 * (e >> 1)) * pl.ldg + 16 * jp + 8 * q + 2 * t4 + (e & 1)] =
              Dr[sl][q][e];
    }
  }
  __syncthreads();

  // dB = D^T C over t >= tau + S and dC = D B over tau <= t, the block's
  // sums, over the warp's strip (S's tiles, two at a time), into
  // [2][QP][NP] fp32 in the scratch region
  {
    float* outB = reinterpret_cast<float*>(scratch);
    float* outC = outB + QP * pl.NP;
    const int n0 = 16 * ss.col;
#pragma unroll
    for (int s0 = 0; s0 < S_PER; s0 += 2) {
      if (!ss.valid(s0, MT)) continue;
      float ob[2][2][4], oc[2][2][4] = {};
      int m0[2], k0[2], k1[2], c1[2];
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        const bool ok = ss.valid(s0 + d, MT);
        const int i = ss.row(s0 + d);
        m0[d] = ok ? 16 * i : 0;
        k0[d] = ok ? 2 * i : kq;
        k1[d] = ok ? kq : 0;
        c1[d] = ok ? min(2 * (i + 1), kq) : 0;
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) ob[d][q][e] = Sr[s0 + d][q][e];
      }
      strip_product<2>(ob, AKM<float>{Gs, pl.ldg, 0, g8, t4}, m0, k0, k1,
                       BKN<T>{Cs, pl.ldbc, n0, g8, t4});
      const int z[2] = {0, 0};
      strip_product<2>(oc, AMK<float>{Gs, pl.ldg, 0, g8, t4}, m0, z, c1,
                       BKN<T>{Bs, pl.ldbc, n0, g8, t4});
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        if (!ss.valid(s0 + d, MT)) continue;
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = m0[d] + g8 + 8 * (e >> 1), n = n0 + 8 * q + 2 * t4 + (e & 1);
            outB[r * pl.NP + n] = ob[d][q][e];
            outC[r * pl.NP + n] = oc[d][q][e];
          }
      }
    }
  }
  cluster.sync();  // every CTA's tiles are in its shared memory

  // each rank sums a share of dB's and dC's elements over the ranks, in
  // rank order, and writes them once in T
  {
    const int CL = (int)cluster.num_blocks();
    const float* outB = reinterpret_cast<const float*>(scratch);
    T* dBg = dB + row0 * G * N + (size_t)grp * N;  // rows G N apart
    T* dCg = dC + row0 * G * N + (size_t)grp * N;
    if (N % 4 == 0) {
      const int n4 = N / 4, per = rows * n4, share = (2 * per + CL - 1) / CL;
      const int e_end = min(2 * per, (rank + 1) * share);
      for (int e = rank * share + tid; e < e_end; e += THREADS) {
        const int w = e >= per, f = e - w * per, r = f / n4, n = 4 * (f - r * n4);
        const int off = w * QP * pl.NP + r * pl.NP + n;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int q = 0; q < CL; ++q) {
          const float4 u = *reinterpret_cast<const float4*>(cluster.map_shared_rank(outB, q) + off);
          v.x += u.x;
          v.y += u.y;
          v.z += u.z;
          v.w += u.w;
        }
        T* o = (w ? dCg : dBg) + (size_t)r * G * N + n;
        from_f(o, v.x);
        from_f(o + 1, v.y);
        from_f(o + 2, v.z);
        from_f(o + 3, v.w);
      }
    } else {
      const int per = rows * N, share = (2 * per + CL - 1) / CL;
      const int e_end = min(2 * per, (rank + 1) * share);
      for (int e = rank * share + tid; e < e_end; e += THREADS) {
        const int w = e >= per, f = e - w * per, r = f / N, n = f - r * N;
        const int off = w * QP * pl.NP + r * pl.NP + n;
        float v = 0.f;
        for (int q = 0; q < CL; ++q) v += cluster.map_shared_rank(outB, q)[off];
        from_f((w ? dCg : dBg) + (size_t)r * G * N + n, v);
      }
    }
  }
  cluster.sync();  // no CTA leaves while another may read its shared memory
}

// dA (H,) = the per-(batch, chunk) terms summed in order (fp64, then fp32)
__global__ void ssd_bwd_reduce_kernel(const double* __restrict__ dA_part, float* __restrict__ dA,
                                      int H, int cells) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H) return;
  double s = 0.0;
  for (int k = 0; k < cells; ++k) s += dA_part[(size_t)k * H + h];
  dA[h] = (float)s;
}

// The kernel's attributes, set once per instantiation and device (bit i:
// device i): the most dynamic shared memory a CTA may take (each launch
// asks for its plan's) and clusters past the portable 8.
template <typename T>
cudaError_t prepare() {
  static std::atomic<unsigned long long> ready{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(ready.load(std::memory_order_acquire) & bit)) {
    auto kern = ssd_chunk_bwd_kernel<T>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)MAX_SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    ready.fetch_or(bit, std::memory_order_release);
  }
  return cudaSuccess;
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
           const void* dy, const void* ds, const void* da, void* dx, void* ddt, void* dA,
           void* dB, void* dC, void* dA_part, int Bsz, int L, int H, int G, int Q, int P, int N,
           int cluster, const Strides& st, cudaStream_t stream) {
  const int es = sizeof(T);
  const BwdPlan pl(Q, N, P, H / G, cluster, es);
  if (pl.total > (int)MAX_SMEM) return cudaErrorInvalidValue;
  auto kern = ssd_chunk_bwd_kernel<T>;
  cudaError_t err = prepare<T>();
  if (err != cudaSuccess) return err;
  auto al16 = [](long long v, int esz) { return (v * esz) % 16 == 0; };
  auto ptr16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int vec_x = ptr16(x) && (P * es) % 16 == 0 && al16(st.xb, es) && al16(st.xl, es) &&
                    al16(st.xh, es);
  const int vec_bc = ptr16(Bm) && ptr16(Cm) && (N * es) % 16 == 0 && al16(st.bb, es) &&
                     al16(st.bl, es) && al16(st.bg, es) && al16(st.cb, es) &&
                     al16(st.cl, es) && al16(st.cg, es);
  const int vec_d = ptr16(dy) && ptr16(ds) && P % 4 == 0;
  const int nc = (L + Q - 1) / Q;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G * pl.CL, nc, Bsz);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = pl.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(x), static_cast<const float*>(dt),
                           static_cast<const float*>(A), static_cast<const T*>(Bm),
                           static_cast<const T*>(Cm), static_cast<const float*>(dy),
                           static_cast<const float*>(ds), static_cast<const float*>(da),
                           static_cast<T*>(dx), static_cast<float*>(ddt), static_cast<T*>(dB),
                           static_cast<T*>(dC), static_cast<double*>(dA_part), L, H, G, Q, P, N,
                           cluster, vec_x, vec_bc, vec_d, st);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_reduce_kernel<<<(H + 127) / 128, 128, 0, stream>>>(
      static_cast<const double*>(dA_part), static_cast<float*>(dA), H, Bsz * nc);
  return cudaGetLastError();
}

}  // namespace

// Inputs as ssd_chunk_launch takes them (x, B, C fp32 or bf16 = 1 with
// element strides, last dimensions contiguous; dt fp32 strided; A (H,)
// fp32) and the dense fp32 cotangents dy (B, L, H, P), ds (B, nc, H, N, P),
// da (B, nc, H). Outputs, dense: dx (B, L, H, P) and dB, dC (B, L, G, N) in
// x's type, ddt (B, L, H) and dA (H,) fp32; dA_part (B, nc, H) fp64
// scratch. `cluster` CTAs (1 .. 16) share a group's heads (the plan may use
// fewer, so that none is empty). Two launches on `stream`; returns the
// first cudaError_t (0 on success).
extern "C" int ssd_chunk_bwd_launch(const void* x, const void* dt, const void* A, const void* Bm,
                                    const void* Cm, const void* dy, const void* ds,
                                    const void* da, void* dx, void* ddt, void* dA, void* dB,
                                    void* dC, void* dA_part, int Bsz, int L, int H, int G, int Q,
                                    int P, int N, int bf16, int cluster, long long xb,
                                    long long xl, long long xh, long long db, long long dl,
                                    long long dh, long long bb, long long bl, long long bg,
                                    long long cb, long long cl, long long cg, void* stream) {
  if (Q < 1 || Q > MAXQ_BWD || P < 1 || P > MAXD || N < 1 || N > MAXD || G < 1 ||
      H % G != 0 || L < 1 || Bsz < 1 || cluster < 1 || cluster > MAX_CLUSTER)
    return cudaErrorInvalidValue;
  const Strides st{xb, xl, xh, db, dl, dh, bb, bl, bg, cb, cl, cg};
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, dy, ds, da, dx, ddt, dA, dB, dC, dA_part,
                                 Bsz, L, H, G, Q, P, N, cluster, st, strm);
  return launch<float>(x, dt, A, Bm, Cm, dy, ds, da, dx, ddt, dA, dB, dC, dA_part, Bsz, L, H,
                       G, Q, P, N, cluster, st, strm);
}

// The clusters of `cluster` CTAs (1 .. 16) that the card holds at once for
// the plan of (Q, N, P, heads_per_group, bf16), into *active; returns the
// cudaError_t. The wrapper picks the cluster size from it.
extern "C" int ssd_chunk_bwd_clusters(int Q, int N, int P, int heads_per_group, int cluster,
                                      int bf16, int* active) {
  if (Q < 1 || Q > MAXQ_BWD || P < 1 || P > MAXD || N < 1 || N > MAXD ||
      heads_per_group < 1 || cluster < 1 || cluster > MAX_CLUSTER)
    return cudaErrorInvalidValue;
  const BwdPlan pl(Q, N, P, heads_per_group, cluster, bf16 ? 2 : 4);
  if (pl.total > (int)MAX_SMEM) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.CL);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = pl.total;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  auto query = [&](auto kern, cudaError_t ready) {
    if (ready != cudaSuccess) return (int)ready;
    return (int)cudaOccupancyMaxActiveClusters(active, (void*)kern, &cfg);
  };
  return bf16 ? query(ssd_chunk_bwd_kernel<__nv_bfloat16>, prepare<__nv_bfloat16>())
              : query(ssd_chunk_bwd_kernel<float>, prepare<float>());
}
