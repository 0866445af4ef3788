// Flash-attention forward (causal / sliding-window) for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/flash/flash_kernel.py
// (`flash_attention`, `_kernel`): softmax(q k^T * scale + mask) v over
// (B, H, S, HD) views, bf16 or fp32 in, fp32 softmax, q's dtype out. Each
// tensor comes with its own batch, head and row strides (elements; the
// head dim is contiguous), so the model's (B, S, H, HD) layout is read and
// written in place, without transposes or copies.
//
// Two kernels, one per dtype:
//   * bf16: flash_fwd_bf16_kernel, on the tensor cores (FlashAttention-2
//     form). A CTA of 4 warps per (64-row q block, head, batch); each warp
//     owns 16 q rows and, up to HD = 128, keeps them as mma A fragments in
//     registers for the whole kv loop. Above 128 (192 and 256, gemma3's
//     head dim) the O accumulator alone takes HD/2 registers a thread (128
//     at HD = 256), so the Q fragments are read again from the resident Q
//     tile at every k-step instead; the tiles then take 129 KB (HD = 192)
//     or 165 KB (HD = 256) of shared memory, one CTA per SM. K and V tiles
//     of 64 keys stay bf16 in shared memory in
//     a ring of STAGES tiles filled by cp.async, STAGES - 1 tiles ahead of
//     the one in use; rows are padded to HD + 8 elements, an odd number of
//     16-byte units, so the 8 rows an ldmatrix phase reads fall in 8
//     distinct bank groups for every HD. S = Q K^T is HD/16 k-steps x 8
//     n-tiles of mma.sync.m16n8k16 (bf16 in, fp32 accumulate) fed by
//     ldmatrix; the online softmax stays in registers (row max and sum over
//     the 4-lane quad that shares a row; m and the partial l per row per
//     thread; exp2 on the MUFU unit); P is rounded to bf16 and reused in
//     place as the A operand of P V (the m16n8 accumulators of two adjacent
//     n-tiles are the k16 A layout), 4 k-steps x HD/8 n-tiles with V
//     through ldmatrix.trans. The TPU kernel multiplies P by V in fp32;
//     rounding P to bf16 is what PyTorch's fused attention does, and stays
//     inside the bf16 bar (2e-2). The grid is (H, q blocks, B) with the q
//     block index reversed, so the heaviest causal blocks of every head are
//     dispatched first.
//   * fp32: flash_fwd_kernel, fp32 FMAs from shared memory (256 threads,
//     K transposed and V staged as fp32, the score tile in shared memory;
//     HD/16 output columns a thread, up to MJ = 8 columns below HD = 128
//     and 16 above, 210 KB of shared memory at HD = 256).
//     Its 1e-5 bar cannot be met with bf16 operands, so fp32 calls keep it.
//
// The masks and the sentinel are the TPU kernel's: a masked score is
// NEG_INF = -1e30 (finite, so a row whose first blocks are all masked
// takes exp(0) = 1 there and is rescaled by exp(-1e30 - m) = 0 once a real
// key arrives, exactly as on the TPU), and the output divides by
// max(l, 1e-30). The bf16 kernel works in the log2 domain (scores times
// scale * log2(e), exp2) with the same sentinel, which gives the same
// zeros and ones. The TPU kernel runs fully masked kv blocks; these start
// at the first block the window reaches and stop at the last block the
// causal mask reaches. For a causal call with Sk >= S every row keeps its
// diagonal key, so the skipped blocks would add exp(-1e30 - m) = 0 and the
// result is the same. Masks are evaluated only on blocks that cross the
// diagonal, the window's edge or the ragged end. Keys past Sk (the ragged
// last tile) score -inf and their rows are zero-filled, so they add
// nothing to l or acc.
//
// For training, a caller may also ask for each row's log-sum-exp (lse, in
// log2 units of the scaled scores), which the backward (flash_bwd.cu) needs
// to recompute P without a second softmax pass. The store is compiled into
// kernel instantiations of its own (template LSE), chosen when lse is not
// null, so the serving kernels are the same code as without it.
//
// Bound. At the prefill shape (B=1, H=32, S=512, HD=80, causal) the work
// is 4*H*HD*S(S+1)/2 = 1.35 GFLOP and the bytes are q, k, v, o once each
// (10.5 MB in bf16); on an H100 the bytes bound it (3.1 us at 3.35 TB/s
// against 1.4 us at 989 TFLOP/s). mma.sync at even 60 % of the bf16 rate
// does the products in about 2.3 us, under the byte bound, so it does not
// set the pace; wgmma's 128-byte swizzled tiles fit HD = 80 badly. What
// does set it, measured on an H100 at that shape (about 6x the bound), is
// latency: the heaviest q block walks its eight kv tiles in sequence with
// one or two warps per SM sub-partition to hide each step's latency.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

constexpr int BQ = 64;            // query rows per CTA
constexpr int BK = 64;            // keys per kv step
constexpr int THREADS = 256;      // fp32 kernel: 16 x 16 thread grid over (rows, cols)
constexpr int MAX_HD = 256;       // both kernels: HD a multiple of 16 up to 256
constexpr int KT_STRIDE = BK + 1; // padded rows of the transposed K tile
constexpr int S_STRIDE = BK + 1;  // padded rows of the score tile
constexpr int BF16_THREADS = 128;  // bf16 kernel: 4 warps x 16 q rows
// bf16 kernel: K/V tiles in the cp.async ring. Two measured as fast as three
// or four at the prefill shape and faster on larger grids, where the smaller
// ring lets three CTAs share an SM.
constexpr int STAGES = 2;
constexpr float NEG_INF = -1e30f;

// element strides of one (B, H, rows, HD) view; the head dim is contiguous
struct Strides {
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

// causal and window block range of the q block of `rows` rows at q0
__device__ __forceinline__ void kv_range(int q0, int rows, int Sk, int causal, int window,
                                         int& kb_begin, int& kb_end) {
  const int nk = (Sk + BK - 1) / BK;
  kb_begin = 0;
  kb_end = nk;
  if (causal) {
    kb_end = min(nk, (q0 + rows - 1) / BK + 1);
    if (window > 0) kb_begin = max(0, q0 - window + 1) / BK;
  }
}

// MJ: the most output columns a thread keeps (HD / 16 <= MJ); LSE: store
// each row's log-sum-exp (an instantiation of its own, so the serving
// kernel's code stays as it was)
template <typename T, int MJ, bool LSE>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int S, int Sk, int HD, int causal,
    int window, float scale, Strides st) {
  extern __shared__ float smem[];
  float* Qs = smem;                 // [BQ][HD]
  float* Kt = Qs + BQ * HD;         // [HD][KT_STRIDE]
  float* Vs = Kt + HD * KT_STRIDE;  // [BK][HD]
  float* Ss = Vs + BK * HD;         // [BQ][S_STRIDE] scores, then p
  float* m_s = Ss + BQ * S_STRIDE;  // [BQ] running max
  float* l_s = m_s + BQ;            // [BQ] running denominator
  float* c_s = l_s + BQ;            // [BQ] this step's correction

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const T* qg = q + b * st.qb + h * st.qh;
  const T* kg = k + b * st.kb + h * st.kh;
  const T* vg = v + b * st.vb + h * st.vh;
  T* og = o + b * st.ob + h * st.oh;
  const int nj = HD / 16;

  for (int idx = tid; idx < BQ * HD; idx += THREADS) {
    const int r = idx / HD, d = idx - r * HD;
    Qs[idx] = (q0 + r < S) ? to_f(qg[(q0 + r) * st.qs + d]) : 0.f;
  }
  for (int r = tid; r < BQ; r += THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }

  float acc[4][MJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < MJ; ++j) acc[i][j] = 0.f;

  int kb_begin, kb_end;
  kv_range(q0, BQ, Sk, causal, window, kb_begin, kb_end);

  for (int kb = kb_begin; kb < kb_end; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();  // the previous step is done with Kt, Vs and Ss
    for (int idx = tid; idx < BK * HD; idx += THREADS) {
      const int c = idx / HD, d = idx - c * HD;
      const bool in = k0 + c < Sk;
      Kt[d * KT_STRIDE + c] = in ? to_f(kg[(k0 + c) * st.ks + d]) : 0.f;
      Vs[idx] = in ? to_f(vg[(k0 + c) * st.vs + d]) : 0.f;
    }
    __syncthreads();

    // scores of rows ty + 16i against keys tx + 16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * HD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Kt[d * KT_STRIDE + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const int qp = q0 + r, kp = k0 + c;
        bool keep = true;
        if (causal) keep = keep && kp <= qp;
        if (window > 0) keep = keep && kp > qp - window;
        float val = keep ? s[i][j] * scale : NEG_INF;
        if (kp >= Sk) val = -INFINITY;
        Ss[r * S_STRIDE + c] = val;
      }
    __syncthreads();

    // online softmax: warp w owns rows 8w .. 8w+7, two keys per lane
    for (int rr = 0; rr < BQ / 8; ++rr) {
      const int r = warp * (BQ / 8) + rr;
      float* row = Ss + r * S_STRIDE;
      const float a0 = row[lane], a1 = row[lane + 32];
      float mx = fmaxf(a0, a1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = expf(a0 - m_new), p1 = expf(a1 - m_new);
      row[lane] = p0;
      row[lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + p v
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < MJ; ++j) acc[i][j] *= corr;
    }
    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ss[(ty + 16 * i) * S_STRIDE + c];
#pragma unroll
      for (int j = 0; j < MJ; ++j) {
        if (j < nj) {
          const float vv = Vs[c * HD + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= S) continue;
    const float denom = fmaxf(l_s[r], 1e-30f);
    if (LSE && tx == 0)  // log2 of the row's sum, in scaled-score units
      lse[((long long)b * gridDim.y + h) * S + q0 + r] = m_s[r] * LOG2E + log2f(denom);
#pragma unroll
    for (int j = 0; j < MJ; ++j)
      if (j < nj) og[(q0 + r) * st.os + tx + 16 * j] = from_f<T>(acc[i][j] / denom);
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
// Copy rows [row0, row0 + 64) of a (rows, HD) view with row stride rs into
// a [64][HD + 8] shared tile; rows at or past n_rows are zero-filled. Each
// thread moves HD/16 chunks of 16 bytes at fixed places in the tile; the
// offsets within the tile are 32-bit, because 64-bit address math on every
// chunk measured slower (the loads' issue is on each kv step's path).
template <int HD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long rs, int row0, int n_rows) {
  constexpr int LD = HD + 8, CH = HD / 8, PER = 64 * CH / BF16_THREADS;
  const __nv_bfloat16* base = src + row0 * rs;
  const int rs32 = static_cast<int>(rs);
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = threadIdx.x + i * BF16_THREADS;
    const int r = c / CH, ch = c - r * CH;
    const bool in = row0 + r < n_rows;
    cp_async16(dst + r * LD + ch * 8, base + (in ? r * rs32 + ch * 8 : 0), in ? 16 : 0);
  }
}

template <int HD, bool LSE>
__global__ void __launch_bounds__(BF16_THREADS) flash_fwd_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int S, int Sk, int causal, int window, float scale, Strides st) {
  constexpr int LD = HD + 8;  // shared row stride (elements)
  constexpr int KS = HD / 16; // k-steps of Q K^T
  constexpr int NT = HD / 8;  // n-tiles of P V
  constexpr bool Q_IN_REGS = HD <= 128;  // else Q fragments come from Qs per k-step
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [64][LD]
  __nv_bfloat16* Ks = Qs + BQ * LD;                                 // [STAGES][64][LD]
  __nv_bfloat16* Vs = Ks + STAGES * BK * LD;                        // [STAGES][64][LD]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;  // mma row group, thread in group
  // grid (H, q blocks, B): the block scheduler walks x fastest, so the
  // heaviest causal q blocks of every head are dispatched first
  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const __nv_bfloat16* qg = q + b * st.qb + h * st.qh;
  const __nv_bfloat16* kg = k + b * st.kb + h * st.kh;
  const __nv_bfloat16* vg = v + b * st.vb + h * st.vh;
  __nv_bfloat16* og = o + b * st.ob + h * st.oh;
  const float sl2 = scale * LOG2E;

  int kb_begin, kb_end;
  kv_range(q0, BQ, Sk, causal, window, kb_begin, kb_end);
  const int n_kv = kb_end - kb_begin;

  // a ring of STAGES K/V tiles: tiles 0 .. STAGES-2 now, then one more per
  // step, STAGES-1 ahead of the one in use (one commit group per tile)
  load_tile<HD>(Qs, qg, st.qs, q0, S);
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_kv) {
      load_tile<HD>(Ks + i * BK * LD, kg, st.ks, (kb_begin + i) * BK, Sk);
      load_tile<HD>(Vs + i * BK * LD, vg, st.vs, (kb_begin + i) * BK, Sk);
    }
    cp_async_commit();
  }

  uint32_t qf[Q_IN_REGS ? KS : 1][4];
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};
  const int row_a = q0 + warp * 16 + g;  // this thread's rows: row_a, row_a + 8

  for (int it = 0; it < n_kv; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile it landed; everyone is done with tile it - 1's slot
    if (it + STAGES - 1 < n_kv) {
      const int slot = (it + STAGES - 1) % STAGES, kb = kb_begin + it + STAGES - 1;
      load_tile<HD>(Ks + slot * BK * LD, kg, st.ks, kb * BK, Sk);
      load_tile<HD>(Vs + slot * BK * LD, vg, st.vs, kb * BK, Sk);
    }
    cp_async_commit();
    const __nv_bfloat16* Kb = Ks + (it % STAGES) * BK * LD;
    const __nv_bfloat16* Vb = Vs + (it % STAGES) * BK * LD;
    // this lane's ldmatrix row of the warp's Q rows, k-step 0
    const __nv_bfloat16* q_lane =
        Qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
    if constexpr (Q_IN_REGS) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) ldmatrix_x4(qf[kk], q_lane + kk * 16);
      }
    }

    // S = Q K^T: 16 rows x 64 keys per warp
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[4];
      if constexpr (Q_IN_REGS) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = qf[kk][e];
      } else {
        ldmatrix_x4(qa, q_lane + kk * 16);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4];
        ldmatrix_x4(bk, Kb + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qa, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qa, bk[2], bk[3]);
      }
    }

    // scale (log2 domain) and mask where the block needs it
    const int k0 = (kb_begin + it) * BK;
    const bool masked = (causal && k0 + BK - 1 > q0) ||
                        (window > 0 && k0 <= q0 + BQ - 1 - window) || k0 + BK > Sk;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float val = s[j][e] * sl2;
        if (masked) {
          const int qp = row_a + (e >> 1) * 8, kp = k0 + j * 8 + tig * 2 + (e & 1);
          bool keep = true;
          if (causal) keep = keep && kp <= qp;
          if (window > 0) keep = keep && kp > qp - window;
          if (!keep) val = NEG_INF;
          if (kp >= Sk) val = -INFINITY;
        }
        s[j][e] = val;
      }

    // online softmax on the thread's two rows; a row lives on one quad
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[i], mx);
      const float corr = exp2_approx(m_r[i] - m_new);
      m_r[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 2 * i; e < 2 * i + 2; ++e) {
          const float p = exp2_approx(s[j][e] - m_new);
          s[j][e] = p;
          sum += p;
        }
      l_r[i] = l_r[i] * corr + sum;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        acc[j][2 * i] *= corr;
        acc[j][2 * i + 1] *= corr;
      }
    }

    // acc += P V, P rounded to bf16 in the A layout
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, Vb + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                  np * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * np], pa, bv[0], bv[1]);
        mma_bf16(acc[2 * np + 1], pa, bv[2], bv[3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_r[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = row_a + 8 * i;
    if (row >= S) continue;
    const float denom = fmaxf(l, 1e-30f);
    if (LSE && tig == 0)  // m_r is already in log2 units
      lse[((long long)b * gridDim.x + h) * S + row] = m_r[i] + log2f(denom);
    __nv_bfloat16* orow = og + row * st.os + tig * 2;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      *reinterpret_cast<uint32_t*>(orow + j * 8) =
          pack_bf16(acc[j][2 * i] / denom, acc[j][2 * i + 1] / denom);
  }
}

template <int MJ, bool LSE>
int launch_f32(const void* q, const void* k, const void* v, void* o, float* lse, int B,
               int H, int S, int Sk, int HD, int causal, int window, float scale,
               const Strides& st, cudaStream_t stream) {
  const size_t smem =
      (size_t)(BQ * HD + HD * KT_STRIDE + BK * HD + BQ * S_STRIDE + 3 * BQ) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<float, MJ, LSE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<float, MJ, LSE><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, S, Sk, HD, causal, window,
      scale, st);
  return cudaGetLastError();
}

template <int HD, bool LSE>
int launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                int H, int S, int Sk, int causal, int window, float scale, const Strides& st,
                cudaStream_t stream) {
  const size_t smem = (size_t)(BQ + 2 * STAGES * BK) * (HD + 8) * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<HD, LSE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  // all of the SM's unified memory as shared memory, so two or three CTAs
  // fit on an SM (the default split may leave room for one)
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<HD, LSE>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, (S + BQ - 1) / BQ, B);
  flash_fwd_bf16_kernel<HD, LSE><<<grid, BF16_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, S, Sk,
      causal, window, scale, st);
  return cudaGetLastError();
}

}  // namespace

// q, o: (B, H, S, HD) views; k, v: (B, H, Sk, HD) views; all of one dtype,
// the head dim contiguous: HD a multiple of 16 up to 256 in fp32; 16 .. 128,
// 192 or 256 in bf16. strides: 12 element strides, (batch, head, row)
// of q, k, v and o in that order; for bf16 each must be a multiple of 8 and
// each base 16-byte aligned (cp.async moves 16 bytes). lse: null, or a
// contiguous (B, H, S) fp32 output that receives each row's log-sum-exp in
// the units the backward (flash_bwd.cu) recomputes P in: log2 of
// sum_k 2^(s_k scale log2(e)), so P = 2^(s scale log2(e) - lse). Returns the
// launch's cudaError_t (0 on success).
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v, void* o,
                                int B, int H, int S, int Sk, int HD, int causal,
                                int window, float scale, int is_bf16,
                                const long long* strides, float* lse, void* stream) {
  if (HD <= 0 || HD % 16 != 0 || HD > MAX_HD || S <= 0 || Sk <= 0)
    return cudaErrorInvalidValue;
  const Strides st{strides[0], strides[1], strides[2], strides[3], strides[4],  strides[5],
                   strides[6], strides[7], strides[8], strides[9], strides[10], strides[11]};
  cudaStream_t sm = static_cast<cudaStream_t>(stream);
  if (!is_bf16) {
    if (HD <= 128)
      return lse ? launch_f32<8, true>(q, k, v, o, lse, B, H, S, Sk, HD, causal, window, scale,
                                       st, sm)
                 : launch_f32<8, false>(q, k, v, o, lse, B, H, S, Sk, HD, causal, window,
                                        scale, st, sm);
    return lse ? launch_f32<16, true>(q, k, v, o, lse, B, H, S, Sk, HD, causal, window, scale,
                                      st, sm)
               : launch_f32<16, false>(q, k, v, o, lse, B, H, S, Sk, HD, causal, window, scale,
                                       st, sm);
  }
  for (int i = 0; i < 12; ++i)
    if (strides[i] % 8 != 0) return cudaErrorInvalidValue;
  for (int i = 2; i < 12; i += 3)  // 64 rows of offsets within a tile fit 32 bits
    if (strides[i] > INT_MAX / 64) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16 != 0)
    return cudaErrorInvalidValue;
#define FLASH_BF16_CASE(D) \
  case D:                  \
    return lse ? launch_bf16<D, true>(q, k, v, o, lse, B, H, S, Sk, causal, window, scale, st, \
                                      sm)                                                      \
               : launch_bf16<D, false>(q, k, v, o, lse, B, H, S, Sk, causal, window, scale,   \
                                       st, sm);
  switch (HD) {
    FLASH_BF16_CASE(16)
    FLASH_BF16_CASE(32)
    FLASH_BF16_CASE(48)
    FLASH_BF16_CASE(64)
    FLASH_BF16_CASE(80)
    FLASH_BF16_CASE(96)
    FLASH_BF16_CASE(112)
    FLASH_BF16_CASE(128)
    FLASH_BF16_CASE(192)
    FLASH_BF16_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef FLASH_BF16_CASE
}
