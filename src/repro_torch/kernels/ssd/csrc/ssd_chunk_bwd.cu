// Backward of the Mamba2 SSD chunk-local computation (K4-bwd) for sm_90a,
// on the tensor cores.
//
// No TPU kernel: the JAX package differentiates its jnp `ssd_chunked`
// (src/repro/models/ssm.py:84, from `ssm_block_train`). This is the
// backward of ssd_chunk.cu (K4): from the cotangents dY_intra, dS_local and
// d(a_tot) of one (batch, chunk, head) it gives dx, d(dt), and that head's
// parts of dA, dB and dC. Per chunk of Q steps, with cum = cumsum(dt A),
// u = dt x, M[t, tau] = exp(cum_t - cum_tau) for tau <= t (0 above),
// d_end = exp(cum_Q - cum) and G = (C B^T) o M:
//   dG = dY u^T                         (Q, Q), t >= tau
//   du = G^T dY + d_end o (B dS)        (Q, P)
//   dC = (dG o M) B                     (Q, N)
//   dB = (dG o M)^T C + d_end o (u dS^T)  (Q, N)
//   dcum = rowsum(dG o G) - colsum(dG o G) - e, e = rowsum(B o d_end o (u dS^T)),
//          plus sum(e) + da a_tot at step Q - 1
//   dla = reverse cumsum of dcum;  d(dt) = A dla + rowsum(x o du)
//   dA = sum(dt dla);  dx = dt du
// (kernels/ssd/ref.py `chunk_bwd_ref` is the same function in PyTorch.)
//
// Layout. The kernel reads the forward's inputs as K4 does, in place through
// strides: x (B, L, H, P), dt (B, L, H), B and C (B, L, G, N), fp32 or bf16
// (widened to fp32 in shared memory); dY (B, L, H, P), dS (B, nc, H, N, P)
// and da (B, nc, H) are dense fp32. A ragged last chunk reads as zero rows.
// Outputs: dx (B, L, H, P) in x's dtype, rounded once from fp32; d(dt)
// (B, L, H) fp32; and fp32 partials of dB and dC per head (B, L, H, N) and
// of dA per (batch, chunk, head). A second kernel sums the partials in a
// fixed order (dB and dC over a group's heads, rounded once to x's dtype;
// dA over batches and chunks): no float atomics, so the result is the same
// bits from run to run.
//
// Design. One CTA of 256 threads per (batch, chunk, head), as K4. It loads
// x (as u = dt x), dY, dS, B and C into fp32 shared memory (cp.async where
// 16-byte aligned), scans cum, and then runs the seven products on the
// tensor cores in split TF32 (3xTF32 on mma.sync.m16n8k8, ssd_common.cuh),
// each warp taking 16 x 16 output units:
//   1. C B^T and dY u^T together, on and below the diagonal: the epilogue
//      applies the mask M (exp only where tau <= t), stores G and dG o M,
//      and sums dG o G along rows and columns into per-unit partials;
//   2. dC, dB and du, the Q x Q factors walking only the tiles on or below
//      the diagonal; the epilogues add the d_end terms, write dx and the
//      partials of dB and dC, and sum e and x o du per unit;
//   3. one thread per step adds the partials in a fixed order, takes the
//      reverse cumsum and writes d(dt) and the chunk's dA term.
// The tensor cores truncate as they accumulate, so a product summed over a
// long reduction in one accumulator drifts (K3-bwd measured it): every
// FOLD k-steps go into fresh accumulators and are added in fp32.
//
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
// are 103.6 MB, 0.031 ms at 3.35 TB/s; the products the function needs
// (C B^T and the (dG o M) terms of dC and dB once per group, the rest per
// head, the Q x Q ones over the causal triangle) are 4.1 GFLOP, 12.3 in
// three TF32 passes, 0.025 ms at 495 TFLOP/s: the bytes bound it. This
// design does 5.7 GFLOP (it forms the group terms per head) with one CTA
// an SM (175 KB of shared memory), so a CTA's loads and its serial steps
// overlap nothing; measured 0.518 ms on an H100 80GB HBM3 at 700 W, 17x
// the bound (PERF.md). chip_smoke.py prints both counts from the shapes.
//
// Limits: Q <= 64 (four 16-row tiles), P and N <= 128, and the shared
// memory plan (BwdPlan) within one CTA's 227 KB (Q = 64, N = 128, P = 64:
// 175 KB; N = P = 128 does not fit). The wrapper refuses the rest.
#include "ssd_common.cuh"

namespace {

constexpr int MAXQ_BWD = 64;
constexpr int FOLD = 4;  // k8 steps summed in fresh accumulators

// Shared-memory plan, offsets in floats (each a multiple of 4, so every
// buffer is 16-byte aligned). Rows are padded to strides of 4 mod 32
// floats: fragment loads of a row-major operand are free of bank
// conflicts, those of a transposed one 2-way.
struct BwdPlan {
  int QP, NP, PP, MT, NT, PT;  // Q, N, P padded to 16; their tile counts
  int ldb, ldc, ldu, ldy, lds, ldq;
  int Bs, Cs, Us, Ys, Ss, Gs, Ds, dt, cum, dend, dcum, ev, xv, pv, rowp, colp, ep, xp, total;
  __host__ __device__ BwdPlan(int Q, int N, int P) {
    QP = round_up(Q, 16);
    NP = round_up(N, 16);
    PP = round_up(P, 16);
    MT = QP / 16;
    NT = NP / 16;
    PT = PP / 16;
    ldb = ldc = NP + 4;
    ldu = ldy = lds = PP + 4;
    ldq = QP + 4;
    Bs = 0;
    Cs = Bs + QP * ldb;
    Us = Cs + QP * ldc;
    Ys = Us + QP * ldu;
    Ss = Ys + QP * ldy;
    Gs = Ss + NP * lds;
    Ds = Gs + QP * ldq;
    dt = Ds + QP * ldq;
    cum = dt + QP;
    dend = cum + QP;
    dcum = dend + QP;
    ev = dcum + QP;
    xv = ev + QP;
    pv = xv + QP;
    rowp = pv + QP;
    colp = rowp + MT * MT * 16;
    ep = colp + MT * MT * 16;
    xp = ep + NT * QP;
    total = xp + PT * QP;
  }
};

__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// rows [0, rows) x cols [0, cols) of a row-major fp32 matrix (row stride
// rs) into [rpad][ld] shared memory, zero-padded to rpad x cpad
__device__ void load_f32_rows(float* dst, int ld, const float* src, long long rs, int rows,
                              int cols, int rpad, int cpad, bool vec) {
  if (vec) {
    const int cpr = cols / 4;
    for (int e = threadIdx.x; e < rows * cpr; e += THREADS) {
      const int r = e / cpr, q = e - r * cpr;
      cp_async16(dst + r * ld + 4 * q, src + r * rs + 4 * q);
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += THREADS) {
      const int r = e / cols, k = e - r * cols;
      dst[r * ld + k] = src[r * rs + k];
    }
  }
  for (int e = threadIdx.x; e < rpad * cpad; e += THREADS) {
    const int r = e / cpad, k = e - r * cpad;
    if (r >= rows || k >= cols) dst[r * ld + k] = 0.f;
  }
}

// fragment loaders of one 16 x 16 unit: A rows m0.., B columns n0.. (two
// n-tiles q = 0, 1), k-step kk
struct AMK {  // A row-major [m][k]
  const float* M;
  int ld, m0, g, t;
  __device__ void operator()(int kk, uint32_t (&h)[4], uint32_t (&l)[4]) const {
    frag_a_mk(M, ld, m0, 8 * kk, g, t, h, l);
  }
};
struct AKM {  // A stored [k][m]
  const float* M;
  int ld, m0, g, t;
  __device__ void operator()(int kk, uint32_t (&h)[4], uint32_t (&l)[4]) const {
    frag_a_km(M, ld, m0, 8 * kk, g, t, h, l);
  }
};
struct BKN {  // B row-major [k][n]
  const float* M;
  int ld, n0, g, t;
  __device__ void operator()(int kk, int q, uint32_t (&h)[2], uint32_t (&l)[2]) const {
    frag_b_kn(M, ld, 8 * kk, n0 + 8 * q, g, t, h, l);
  }
};
struct BNK {  // B stored [n][k]
  const float* M;
  int ld, n0, g, t;
  __device__ void operator()(int kk, int q, uint32_t (&h)[2], uint32_t (&l)[2]) const {
    frag_b_nk(M, ld, 8 * kk, n0 + 8 * q, g, t, h, l);
  }
};

// out += A B over the k-steps [k0, k1) of one 16 x 16 unit, in split TF32;
// every FOLD steps go into fresh accumulators, then into out in fp32.
// out[q][e] is the m16n8 accumulator layout: row g + 8 (e / 2), column
// 8 q + 2 t + e % 2.
template <typename FA, typename FB>
__device__ __forceinline__ void unit_product(float (&out)[2][4], int k0, int k1, const FA& fa,
                                             const FB& fb) {
  for (int kb = k0; kb < k1; kb += FOLD) {
    const int ke = min(kb + FOLD, k1);
    float acc[2][3][4] = {};
    for (int kk = kb; kk < ke; ++kk) {
      uint32_t ah[4], al[4];
      fa(kk, ah, al);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        uint32_t bh[2], bl[2];
        fb(kk, q, bh, bl);
        mma3(acc[q], ah, al, bh, bl);
      }
    }
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) out[q][e] += acc_sum(acc[q], e);
  }
}

// the sum over a quad's four lanes (one accumulator row) and over the
// eight quads (one accumulator column), in a fixed order
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float column_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const T* __restrict__ Bm,
                     const T* __restrict__ Cm, const float* __restrict__ dy,
                     const float* __restrict__ ds, const float* __restrict__ da,
                     T* __restrict__ dx, float* __restrict__ ddt, float* __restrict__ dB_part,
                     float* __restrict__ dC_part, float* __restrict__ dA_part, int L, int H,
                     int G, int Q, int P, int N, int vec_x, int vec_bc, int vec_d, Strides st) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float wsum[WARPS];
  const BwdPlan pl(Q, N, P);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g8 = lane >> 2, t4 = lane & 3;
  const int h = blockIdx.x, grp = h / (H / G);
  const int c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int l0 = c * Q, rows = min(Q, L - l0);  // rows of the chunk inside the sequence
  const int QP = pl.QP, MT = pl.MT, kq = (Q + 7) / 8, kn = (N + 7) / 8, kp = (P + 7) / 8;
  float* Bs = smem + pl.Bs;
  float* Cs = smem + pl.Cs;
  float* Us = smem + pl.Us;
  float* Ys = smem + pl.Ys;
  float* Ss = smem + pl.Ss;
  float* Gs = smem + pl.Gs;
  float* Ds = smem + pl.Ds;  // dG o M
  float* dts = smem + pl.dt;
  float* cums = smem + pl.cum;
  float* dend = smem + pl.dend;
  float* dcum = smem + pl.dcum;
  float* ev = smem + pl.ev;
  float* xv = smem + pl.xv;
  float* pv = smem + pl.pv;
  float* rowp = smem + pl.rowp;  // [i][jp][16]: row sums of dG o G per unit
  float* colp = smem + pl.colp;  // [i][jp][16]: column sums
  float* ep = smem + pl.ep;      // [jn][QP]: e per dB unit
  float* xp = smem + pl.xp;      // [jp][QP]: rowsum(x o du) per du unit
  const size_t cell = ((size_t)b * nc + c) * H + h;
  const size_t row0 = (size_t)b * L + l0;  // (batch, step) row of the chunk's first step
  const T* xh = x + b * st.xb + l0 * st.xl + h * st.xh;
  const int ldx = pl.ldu * 4;  // bytes between x's rows in u's place

  load_x(reinterpret_cast<char*>(Us), ldx, xh, st.xl, rows, P, vec_x);
  load_f32_rows(Ys, pl.ldy, dy + row0 * H * P + (size_t)h * P, (long long)H * P, rows, P, QP,
                pl.PP, vec_d);
  load_f32_rows(Ss, pl.lds, ds + cell * N * P, P, N, P, pl.NP, pl.PP, vec_d);
  cp_async_commit();
  float d = 0.f;  // dt of step tid; rows past the chunk add dt = 0
  if (tid < rows) d = dt[b * st.db + (l0 + tid) * st.dl + h * st.dh];
  if (tid < QP) dts[tid] = d;
  load_bc(Bs, pl.ldb, Cs, pl.ldc, QP, pl.NP, Bm + b * st.bb + l0 * st.bl + grp * st.bg, st.bl,
          Cm + b * st.cb + l0 * st.cl + grp * st.cg, st.cl, rows, N, vec_bc);
  const float Ah = A[h];
  {  // cum = cumsum(dt A): a block scan, as K4's
    float v = d * Ah;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += up;
    }
    if (lane == 31) wsum[warp] = v;
    __syncthreads();
    for (int w = 0; w < warp; ++w) v += wsum[w];
    if (tid < QP) cums[tid] = v;
  }
  cp_async_wait_all();
  __syncthreads();  // x, dY, dS, B, C, dt and cum are in shared memory

  // u = dt x in place, a warp per row (the row's values are all read before
  // any is written: a bf16 row is half a float row), and d_end
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
  for (int tau = tid; tau < QP; tau += THREADS)
    dend[tau] = tau < Q ? expf(cums[Q - 1] - cums[tau]) : 0.f;
  __syncthreads();

  // 1. unit (i, jp), jp <= i: rows t of tile i, columns tau of tile jp.
  //    C B^T over n and dY u^T over p; G = C B^T o M and dG o M stored
  {
    const int units = MT * (MT + 1) / 2;
    for (int un = warp; un < units; un += WARPS) {
      int i = 0;
      while ((i + 1) * (i + 2) / 2 <= un) ++i;
      const int jp = un - i * (i + 1) / 2, r0 = 16 * i, c0 = 16 * jp;
      float cb[2][4] = {}, dg[2][4] = {};
      unit_product(cb, 0, kn, AMK{Cs, pl.ldc, r0, g8, t4}, BNK{Bs, pl.ldb, c0, g8, t4});
      unit_product(dg, 0, kp, AMK{Ys, pl.ldy, r0, g8, t4}, BNK{Us, pl.ldu, c0, g8, t4});
      float rs[2] = {0.f, 0.f}, cs[2][2] = {};
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = r0 + g8 + 8 * (e >> 1), tau = c0 + 8 * q + 2 * t4 + (e & 1);
          // the exponent is <= 0 where it is taken
          const float m = tau <= t ? expf(cums[t] - cums[tau]) : 0.f;
          const float dgm = dg[q][e] * m, gg = dgm * cb[q][e];
          Gs[t * pl.ldq + tau] = cb[q][e] * m;
          Ds[t * pl.ldq + tau] = dgm;
          rs[e >> 1] += gg;
          cs[q][e & 1] += gg;
        }
      float* rp = rowp + (i * MT + jp) * 16;
      float* cp = colp + (i * MT + jp) * 16;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const float v = quad_sum(rs[hr]);
        if (t4 == 0) rp[g8 + 8 * hr] = v;
      }
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float v = column_sum(cs[q][j]);
          if (g8 == 0) cp[8 * q + 2 * t4 + j] = v;
        }
    }
  }
  __syncthreads();

  // 2. dC (rows t), dB (rows tau), du (rows tau) units of 16 x 16
  {
    const int NT = pl.NT, PT = pl.PT, n_c = MT * NT, n_b = MT * NT, n_u = MT * pl.PT;
    float* dCh = dC_part + row0 * H * N + (size_t)h * N;  // rows H N apart
    float* dBh = dB_part + row0 * H * N + (size_t)h * N;
    T* dxh = dx + row0 * H * P + (size_t)h * P;  // rows H P apart
    for (int un = warp; un < n_c + n_b + n_u; un += WARPS) {
      if (un < n_c) {  // dC = (dG o M) B over tau <= t
        const int i = un / NT, r0 = 16 * i, c0 = 16 * (un - i * NT);
        float o[2][4] = {};
        unit_product(o, 0, min(2 * (i + 1), kq), AMK{Ds, pl.ldq, r0, g8, t4},
                     BKN{Bs, pl.ldb, c0, g8, t4});
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = r0 + g8 + 8 * (e >> 1), n = c0 + 8 * q + 2 * t4 + (e & 1);
            if (t < rows && n < N) dCh[(size_t)t * H * N + n] = o[q][e];
          }
      } else if (un < n_c + n_b) {  // dB = (dG o M)^T C over t >= tau + d_end o (u dS^T)
        const int v = un - n_c, i = v / NT, jn = v - i * NT, r0 = 16 * i, c0 = 16 * jn;
        float o[2][4] = {}, s[2][4] = {};
        unit_product(o, 2 * i, kq, AKM{Ds, pl.ldq, r0, g8, t4}, BKN{Cs, pl.ldc, c0, g8, t4});
        unit_product(s, 0, kp, AMK{Us, pl.ldu, r0, g8, t4}, BNK{Ss, pl.lds, c0, g8, t4});
        float er[2] = {0.f, 0.f};
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int tau = r0 + g8 + 8 * (e >> 1), n = c0 + 8 * q + 2 * t4 + (e & 1);
            const float bs = s[q][e] * dend[tau];
            er[e >> 1] += Bs[tau * pl.ldb + n] * bs;
            if (tau < rows && n < N) dBh[(size_t)tau * H * N + n] = o[q][e] + bs;
          }
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const float w = quad_sum(er[hr]);
          if (t4 == 0) ep[jn * QP + r0 + g8 + 8 * hr] = w;
        }
      } else {  // du = G^T dY over t >= tau + d_end o (B dS); dx = dt du
        const int v = un - n_c - n_b, i = v / PT, jp = v - i * PT, r0 = 16 * i, c0 = 16 * jp;
        float o[2][4] = {}, s[2][4] = {};
        unit_product(o, 2 * i, kq, AKM{Gs, pl.ldq, r0, g8, t4}, BKN{Ys, pl.ldy, c0, g8, t4});
        unit_product(s, 0, kn, AMK{Bs, pl.ldb, r0, g8, t4}, BKN{Ss, pl.lds, c0, g8, t4});
        float xr[2] = {0.f, 0.f};
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int tau = r0 + g8 + 8 * (e >> 1), p = c0 + 8 * q + 2 * t4 + (e & 1);
            if (tau < rows && p < P) {
              const float du = o[q][e] + dend[tau] * s[q][e];
              from_f(dxh + (size_t)tau * H * P + p, dts[tau] * du);
              xr[e >> 1] += to_f(xh[tau * st.xl + p]) * du;
            }
          }
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const float w = quad_sum(xr[hr]);
          if (t4 == 0) xp[jp * QP + r0 + g8 + 8 * hr] = w;
        }
      }
    }
  }
  __syncthreads();

  // 3. dcum from the partials, its reverse cumsum dla, d(dt) and dA's term
  if (tid < QP) {
    const int it = tid >> 4, r = tid & 15;
    float rs = 0.f, cs = 0.f, e = 0.f, xd = 0.f;
    for (int jp = 0; jp <= it; ++jp) rs += rowp[(it * MT + jp) * 16 + r];
    for (int i = it; i < MT; ++i) cs += colp[(i * MT + it) * 16 + r];
    for (int jn = 0; jn < pl.NT; ++jn) e += ep[jn * QP + tid];
    for (int jp = 0; jp < pl.PT; ++jp) xd += xp[jp * QP + tid];
    dcum[tid] = rs - cs - e;
    ev[tid] = e;
    xv[tid] = xd;
  }
  __syncthreads();
  if (tid == 0) {
    float se = 0.f;
    for (int tau = 0; tau < QP; ++tau) se += ev[tau];
    dcum[Q - 1] += se + da[cell] * expf(cums[Q - 1]);
  }
  __syncthreads();
  if (tid < QP) {
    float dla = 0.f;
    for (int t = QP - 1; t >= tid; --t) dla += dcum[t];
    if (tid < rows) ddt[(row0 + tid) * H + h] = Ah * dla + xv[tid];
    pv[tid] = dts[tid] * dla;
  }
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int tau = 0; tau < QP; ++tau) s += pv[tau];
    dA_part[cell] = s;
  }
}

// dB, dC (B, L, G, N) = the per-head partials summed over each group's H/G
// heads, rounded once to T; dA (H,) = the per-(batch, chunk) terms summed
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_reduce_kernel(const float* __restrict__ dB_part, const float* __restrict__ dC_part,
                      const float* __restrict__ dA_part, T* __restrict__ dB, T* __restrict__ dC,
                      float* __restrict__ dA, long long steps, int H, int G, int N, int cells) {
  const long long per = steps * G * N;
  const int hg = H / G;
  for (long long e = (long long)blockIdx.x * THREADS + threadIdx.x; e < 2 * per + H;
       e += (long long)gridDim.x * THREADS) {
    if (e < 2 * per) {
      const int w = e >= per;
      const long long f = e - w * per, bl = f / ((long long)G * N);
      const int gn = (int)(f - bl * G * N), g = gn / N, n = gn - g * N;
      const float* src = (w ? dC_part : dB_part) + (bl * H + (long long)g * hg) * N + n;
      float s = 0.f;
      for (int j = 0; j < hg; ++j) s += src[(long long)j * N];
      from_f((w ? dC : dB) + f, s);
    } else {
      const int h = (int)(e - 2 * per);
      float s = 0.f;
      for (int k = 0; k < cells; ++k) s += dA_part[(long long)k * H + h];
      dA[h] = s;
    }
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
           const void* dy, const void* ds, const void* da, void* dx, void* ddt, void* dA,
           void* dB, void* dC, void* dB_part, void* dC_part, void* dA_part, int Bsz, int L,
           int H, int G, int Q, int P, int N, const Strides& st, cudaStream_t stream) {
  const int es = sizeof(T);
  const BwdPlan pl(Q, N, P);
  const size_t smem = (size_t)pl.total * 4;
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
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
  const dim3 grid(H, nc, Bsz);
  ssd_chunk_bwd_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), static_cast<const float*>(dy),
      static_cast<const float*>(ds), static_cast<const float*>(da), static_cast<T*>(dx),
      static_cast<float*>(ddt), static_cast<float*>(dB_part), static_cast<float*>(dC_part),
      static_cast<float*>(dA_part), L, H, G, Q, P, N, vec_x, vec_bc, vec_d, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = 2LL * Bsz * L * G * N + H;
  const long long need = (total + THREADS - 1) / THREADS;
  const int blocks = (int)(need < 1056 ? need : 1056);  // 8 CTAs an SM at most
  ssd_bwd_reduce_kernel<T><<<blocks, THREADS, 0, stream>>>(
      static_cast<const float*>(dB_part), static_cast<const float*>(dC_part),
      static_cast<const float*>(dA_part), static_cast<T*>(dB), static_cast<T*>(dC),
      static_cast<float*>(dA), (long long)Bsz * L, H, G, N, Bsz * nc);
  return cudaGetLastError();
}

}  // namespace

// Inputs as ssd_chunk_launch takes them (x, B, C fp32 or bf16 = 1 with
// element strides, last dimensions contiguous; dt fp32 strided; A (H,)
// fp32) and the dense fp32 cotangents dy (B, L, H, P), ds (B, nc, H, N, P),
// da (B, nc, H). Outputs, dense: dx (B, L, H, P) and dB, dC (B, L, G, N) in
// x's type, ddt (B, L, H) and dA (H,) fp32; dB_part, dC_part (B, L, H, N)
// and dA_part (B, nc, H) fp32 scratch. Two launches on `stream`; returns
// the first cudaError_t (0 on success).
extern "C" int ssd_chunk_bwd_launch(const void* x, const void* dt, const void* A, const void* Bm,
                                    const void* Cm, const void* dy, const void* ds,
                                    const void* da, void* dx, void* ddt, void* dA, void* dB,
                                    void* dC, void* dB_part, void* dC_part, void* dA_part,
                                    int Bsz, int L, int H, int G, int Q, int P, int N, int bf16,
                                    long long xb, long long xl, long long xh, long long db,
                                    long long dl, long long dh, long long bb, long long bl,
                                    long long bg, long long cb, long long cl, long long cg,
                                    void* stream) {
  if (Q < 1 || Q > MAXQ_BWD || P < 1 || P > MAXD || N < 1 || N > MAXD || G < 1 ||
      H % G != 0 || L < 1 || Bsz < 1)
    return cudaErrorInvalidValue;
  const Strides st{xb, xl, xh, db, dl, dh, bb, bl, bg, cb, cl, cg};
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, dy, ds, da, dx, ddt, dA, dB, dC, dB_part,
                                 dC_part, dA_part, Bsz, L, H, G, Q, P, N, st, strm);
  return launch<float>(x, dt, A, Bm, Cm, dy, ds, da, dx, ddt, dA, dB, dC, dB_part, dC_part,
                       dA_part, Bsz, L, H, G, Q, P, N, st, strm);
}
