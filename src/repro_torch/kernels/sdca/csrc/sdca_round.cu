// One fused local SDCA round for every task in ONE call (the
// `pallas_round` solver backend): two kernels over the whole card while a
// block's rows fit a cluster's shared memory, one past that width.
//
// Replaces the TPU kernel `sdca_round_kernel` / `_round_kernel` of
// repro/kernels/sdca/sdca_kernel.py. The TPU version stages the task's
// whole (n_max, d) block in VMEM and walks the H/B blocks in order. At
// MNIST width that block is 37.6 MB, far above a Hopper block's 227 KB, and
// one CTA per task would leave 122 of 132 SMs idle. But q = X_b w and
// G = X_b X_b^T depend only on w and on the block's coordinates, which the
// round's uniforms fix up front, so they are computed for every block of
// every task at once; only xr = X_b r, the B-step recursion and alpha~
// carried across blocks are sequential. Hence:
//
//   Stage 1, gram_kernel, grid (blocks, m), up to 4 warps a CTA: draws the
//   block's coordinates (fp32 product and truncation of sample_coords, row
//   n_max - 1 for a task with no samples, as coords_from_uniform wraps),
//   then forms the lower triangle of the B x B Gram the recursion reads and
//   q = X_b w. Each warp owns a contiguous range of d's 4-column chunks
//   (split-K inside the CTA) and streams the block's B rows over it, with
//   the matching columns of w, through a ring of its own (two stages of 32
//   columns, 16-byte cp.async, 4-byte where d % 4 != 0), waiting only on
//   its own copies: the CTA meets at a barrier before and after the column
//   loop, never inside it. A lane keeps one 8 x 8 tile of the triangle in
//   registers (B = 64: 28 below the diagonal, 4 diagonal blocks whole; the
//   other 4 diagonal blocks a lane a stage, below their diagonal). The
//   epilogue sums the warps' partials in warp order and writes G full B x B
//   and bit-exactly symmetric, then q and the rows' labels, alphas and ids,
//   to a scratch the wrapper allocates. fp32 FMAs: TF32 would break the
//   2e-5 bar.
//
//   Stage 2, chain_kernel, one thread-block cluster of C CTAs per task
//   (cudaLaunchKernelEx with a cluster dimension). CTA `rank` owns a slab
//   of dcp columns of r and of every block's gathered rows, kept in shared
//   memory: the rows are loaded once per block and serve both xr and the
//   r update. Per block:
//     1. partial xr over the CTA's columns;
//     2. cluster.sync (release/acquire at cluster scope);
//     3. warp 0 of every CTA sums the C partials in rank order and reads
//        rank 0's alpha~ (alpha[j] + dalpha[j] at block start) through
//        distributed shared memory, then runs the same recursion on the
//        same inputs: the recursion is replicated, not broadcast, so a
//        block needs one cluster barrier. Rank 0's warp 0 then scatters
//        into dalpha: the first row of each coordinate writes dalpha at
//        block start plus every delta of the block drawn there, summed in
//        draw order, so each entry has a single writer. Meanwhile warps
//        1-7 prefetch the next block's rows and scratch with cp.async into
//        the other buffer;
//     4. rank 0 gathers the next block's alpha~ (its loads in flight during
//        the r update), and every CTA adds X_b^T deltas to its columns of r.
//   The partials and alpha~ are double-buffered by block parity, so one
//   cluster barrier per block orders every exchange.
//
// The recursion is the right-looking one of sdca_common.cuh (shared with
// the block kernel): one closed-form delta per lane, one shuffle and one
// FMA per step, unrolled and branch-free, the divisor inverted before the
// chain; its running duplicate sums double as the scatter's totals.
//
// Cluster size: C = 4 by default, chosen by measurement (chip_smoke.py
// phase 2 times C = 4 and 8 at MNIST width). C = 2 does not fit d = 784 in
// shared memory. A round with more blocks than the scratch holds runs in
// groups of blocks, stage 1 then stage 2 per group, with the same result.
//
// What bounds it on this card: stage 1 is fp32 FMA work, the triangle
// and q (2 (B(B+1)/2 + B) d FLOPs a block) against the drawn rows read once;
// the kernel issues 2 256 FMAs a column for the 2 144 it needs. Its 8 x 8
// tiles read 16 floats from shared memory for 64 FMAs; at d = 10 000 it took
// 7.22-7.26 ms a round against 3.8 ms of bytes, 3.2 ms with the FMAs taken
// out and 6.2 with the copies taken out, so the FMA loop sets it. Stage 2 is
// a dependent chain of H steps per task (a closed-form delta, a shuffle, an
// FMA), plus per block a cluster barrier, the partial xr and the r update.
//
// Where no supported cluster fits d in shared memory (d > 3008 at B = 64),
// the two stages would read the drawn rows three times, so the round is one
// kernel instead, chain_stream_kernel (sdca_stream.cuh): it draws each
// block's coordinates itself, forms the Gram triangle, q and xr in one read
// of the rows, and reads them again for the r update; its scratch holds only
// what a task's CTAs exchange, and it runs in no groups.
#include <cooperative_groups.h>

#include "sdca_common.cuh"

namespace cg = cooperative_groups;

namespace sdca {

// floats of one block's scratch: G (B x B), q, labels, alphas, coordinate ids
template <int B>
__host__ __device__ constexpr int scratch_floats() {
  return B * B + 4 * B;
}

// ---------------------------------------------------------------------------
// stage 1: G, q and the block's metadata for every (block, task)
// ---------------------------------------------------------------------------
// 4 warps a CTA, 3 CTAs (12 warps) an SM at 168 registers: at the MDS width
// that beat 2 CTAs of 180-254 registers, a ring of 3 stages and 8 warps a
// CTA by 7-11 % (H100)
constexpr int kGramCols = 32;     // columns of d in one ring stage: 8 chunks of 4
constexpr int kGramWarps = 4;     // most warps (column ranges) in one CTA
constexpr int kGramDepth = 2;     // ring stages per warp
constexpr int kGramPart = 68;     // floats of one lane's 8 x 8 tile in the epilogue (padded)

// The lower triangle of the B x B Gram in tiles of 8 x 8: R row blocks, OFF
// tiles below the diagonal and R on it. Pass 1 gives each lane one tile for
// every column: the OFF off-diagonal ones, then diagonal blocks, taken
// whole. At B = 64 that is 28 + 4 of the 36; the last D2 = 4 diagonal
// blocks go below their diagonal to gram_diag, lane l taking one block over
// one 4-column chunk of each ring stage, and their diagonal to the q step.
template <int B>
struct GramTiles {
  static constexpr int R = B / 8;
  static constexpr int OFF = R * (R - 1) / 2;
  static constexpr int T1 = OFF + R < 32 ? OFF + R : 32;
  static constexpr int D2 = OFF + R - T1;
  static_assert(D2 == 0 || (D2 == 4 && B == 64), "gram_diag: 4 blocks x 8 chunks, one a lane");
};

// pass-1 tile (row block I >= column block J) of lane l; lanes past T1 repeat
// the last tile and store nothing
template <int B>
__device__ __forceinline__ void gram_tile(int l, int& I, int& J) {
  using GT = GramTiles<B>;
  l = min(l, GT::T1 - 1);
  if (l < GT::OFF) {
    I = 1;
    while ((I + 1) * I / 2 <= l) ++I;
    J = l - I * (I - 1) / 2;
  } else {
    I = J = l - GT::OFF;
  }
}

// The ring stores row p's 16-byte chunk c at chunk c ^ gram_swz(p) of the
// row's 128 bytes, so the eight rows 8I + r (I = 0..7) a pass-1 load reads
// fall in eight distinct bank quads.
__device__ __forceinline__ int gram_swz(int p) {
  return (p >> 3) ^ (((p >> 2) & 1) << 2);
}

__device__ __forceinline__ float lane_of(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// floats of one ring stage: B rows of kGramCols columns, then those columns of w
template <int B>
__host__ __device__ constexpr int gram_stage_floats() {
  return (B + 1) * kGramCols;
}

// dynamic shared memory of one stage-1 CTA of nw warps: the ring, reused by
// the epilogue (each warp's tiles and q, then the summed Gram)
template <int B>
__host__ __device__ constexpr int gram_smem_floats(int nw) {
  constexpr int part2 = GramTiles<B>::D2 > 0 ? 32 * 29 : 0;
  const int ring = nw * kGramDepth * gram_stage_floats<B>();
  const int epi = nw * (32 * kGramPart + part2 + B) + B * B;
  return ring > epi ? ring : epi;
}

// one warp: chunks [cs, cs + nk) of the rows (and of w) into a ring stage,
// 16-byte copies where d allows, else 4-byte ones zero-filled past d
template <int B>
__device__ __forceinline__ void gram_issue(float* st, const float* __restrict__ x,
                                           const float* __restrict__ wt, const int64_t* rowoff,
                                           int cs, int nk, int d, bool vec) {
  const int lane = threadIdx.x & 31;
  if (vec) {
    for (int e = lane; e < B * 8; e += 32) {
      const int p = e >> 3, c = e & 7;
      if (c < nk) cp_async16(st + p * kGramCols + ((c ^ gram_swz(p)) << 2), x + rowoff[p] + 4 * (cs + c));
    }
    if (lane < nk) cp_async16(st + B * kGramCols + 4 * lane, wt + 4 * (cs + lane));
  } else {
    const int cols = 4 * nk;
    for (int e = lane; e < B * kGramCols; e += 32) {
      const int p = e >> 5, cc = e & 31, col = 4 * cs + cc;
      const bool in = col < d;
      if (cc < cols)
        cp_async4_zfill(st + p * kGramCols + (((cc >> 2) ^ gram_swz(p)) << 2) + (cc & 3),
                        x + rowoff[p] + (in ? col : 0), in ? 4 : 0);
    }
    const int col = 4 * cs + lane;
    if (lane < cols) cp_async4_zfill(st + B * kGramCols + lane, wt + (col < d ? col : 0), col < d ? 4 : 0);
  }
}

// one chunk (4 columns) of a ring stage st into a lane's accumulators: its
// pass-1 tile (I, J), q of rows lane + 32 s, and (B = 64) the diagonal entry
// of row lane + 32, whose row the q step has loaded
template <int B>
__device__ __forceinline__ void gram_chunk(const float* st, int kc, int I, int J,
                                           float (&acc)[8][8], float (&accq)[(B + 31) / 32],
                                           float& accd) {
  constexpr int KT = kGramCols;
  const int lane = threadIdx.x & 31;
  // rows 8I + r sit at chunk kc ^ I (r < 4) or kc ^ I ^ 4 (r >= 4)
  const float* ra = st + 8 * I * KT;
  const float* rb = st + 8 * J * KT;
  const int ca = (kc ^ I) << 2, cb = (kc ^ J) << 2;
  float4 a[8], b[4];
#pragma unroll
  for (int r = 0; r < 8; ++r) a[r] = *reinterpret_cast<const float4*>(ra + r * KT + (r < 4 ? ca : ca ^ 16));
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // the tile's columns in two halves: fewer live registers
#pragma unroll
    for (int r = 0; r < 4; ++r)
      b[r] = *reinterpret_cast<const float4*>(rb + (4 * h + r) * KT + (h == 0 ? cb : cb ^ 16));
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][4 * h + j] = fmaf(lane_of(a[i], k), lane_of(b[j], k), acc[i][4 * h + j]);
  }
  const float4 wv = *reinterpret_cast<const float4*>(st + B * KT + 4 * kc);
#pragma unroll
  for (int qs = 0; qs < (B + 31) / 32; ++qs) {
    const int p = min(lane + 32 * qs, B - 1);
    const float4 xv = *reinterpret_cast<const float4*>(st + p * KT + ((kc ^ gram_swz(p)) << 2));
#pragma unroll
    for (int k = 0; k < 4; ++k) accq[qs] = fmaf(lane_of(xv, k), lane_of(wv, k), accq[qs]);
    if (GramTiles<B>::D2 > 0 && qs == 1)
#pragma unroll
      for (int k = 0; k < 4; ++k) accd = fmaf(lane_of(xv, k), lane_of(xv, k), accd);
  }
}

// B = 64, once a ring stage: the diagonal blocks pass 1 leaves (4..7) below
// their diagonal, lane l taking block 4 + (l & 3) over chunk l >> 2 of the
// stage: one 8-row load a chunk, and the block's rows serve both sides
template <int B>
__device__ __forceinline__ void gram_diag(const float* st, int nk, float (&acc2)[28]) {
  constexpr int KT = kGramCols;
  const int lane = threadIdx.x & 31;
  const int P = GramTiles<B>::R - GramTiles<B>::D2 + (lane & 3), kc = lane >> 2;
  if (kc >= nk) return;
  const int c = (kc ^ P) << 2;
  float4 x[8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
    x[r] = *reinterpret_cast<const float4*>(st + (8 * P + r) * KT + (r < 4 ? c : c ^ 16));
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int i = 1; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < i; ++j)
        acc2[i * (i - 1) / 2 + j] = fmaf(lane_of(x[i], k), lane_of(x[j], k), acc2[i * (i - 1) / 2 + j]);
}

// Grid (blocks, m), 32 nw threads. Warp w owns a contiguous range of the
// column chunks and streams it through its own ring of kGramDepth stages
// (cp.async, waited on by the warp alone), accumulating its partial Gram
// triangle and q in registers; the CTA meets at a barrier only before and
// after the column loop.
template <int B>
__global__ void __launch_bounds__(32 * kGramWarps, 3)
gram_kernel(const float* __restrict__ x,      // (m, n_max, d)
            const float* __restrict__ y,      // (m, n_max)
            const float* __restrict__ alpha,  // (m, n_max)
            const float* __restrict__ w,      // (m, d)
            const float* __restrict__ u,      // (m, H)
            const int* __restrict__ n,        // (m,)
            float* __restrict__ scratch,      // (m, nbg, scratch_floats<B>)
            int n_max, int d, int H, int b_begin, int nbg, int vec) {
  using GT = GramTiles<B>;
  constexpr int SF = gram_stage_floats<B>();
  constexpr int QR = (B + 31) / 32;  // q rows a lane: l + 32 s
  extern __shared__ __align__(16) float dyn[];
  __shared__ int64_t rowoff[B];

  const int bi = blockIdx.x, t = blockIdx.y, tid = threadIdx.x;
  const int nw = blockDim.x / 32, warp = tid / 32, lane = tid % 32;
  const int nt = n[t];
  float* blk = scratch + ((int64_t)t * nbg + bi) * scratch_floats<B>();
  for (int k = tid; k < B; k += blockDim.x) {
    int j = min((int)__fmul_rn(u[(int64_t)t * H + (b_begin + bi) * B + k], (float)nt), nt - 1);
    // a task with no samples (a padded task, or a pod slice past its
    // samples) gets -1: the plain version's wrap to the block's last row,
    // so nothing outside the task's own rows is read or written
    if (j < 0) j += n_max;
    rowoff[k] = ((int64_t)t * n_max + j) * d;
    blk[B * B + B + k] = y[(int64_t)t * n_max + j];
    blk[B * B + 2 * B + k] = alpha[(int64_t)t * n_max + j];
    reinterpret_cast<int*>(blk)[B * B + 3 * B + k] = j;
  }
  __syncthreads();

  // this warp's chunks of 4 columns, [c0, c1), in stages of 8
  const int n_chunks = (d + 3) / 4;
  const int c0 = warp * n_chunks / nw, c1 = (warp + 1) * n_chunks / nw;
  const int ns = (c1 - c0 + 7) / 8;
  const float* wt = w + (int64_t)t * d;
  float* ring = dyn + warp * kGramDepth * SF;

  int I, J;
  gram_tile<B>(lane, I, J);
  float acc[8][8], acc2[28], accq[QR], accd = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int i = 0; i < 28; ++i) acc2[i] = 0.f;
#pragma unroll
  for (int s = 0; s < QR; ++s) accq[s] = 0.f;

  for (int s = 0; s < kGramDepth - 1; ++s) {  // one commit group a stage, issued or not
    if (s < ns)
      gram_issue<B>(ring + s * SF, x, wt, rowoff, c0 + 8 * s, min(8, c1 - c0 - 8 * s), d, vec);
    cp_async_commit();
  }
  for (int s = 0; s < ns; ++s) {
    const int nx = s + kGramDepth - 1;
    if (nx < ns)  // into the stage read at s - 1: __syncwarp below ordered it
      gram_issue<B>(ring + (nx % kGramDepth) * SF, x, wt, rowoff, c0 + 8 * nx,
                    min(8, c1 - c0 - 8 * nx), d, vec);
    cp_async_commit();
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kGramDepth - 1) : "memory");  // stage s is in
    __syncwarp();
    const float* st = ring + (s % kGramDepth) * SF;
    const int nk = min(8, c1 - c0 - 8 * s);
    for (int kc = 0; kc < nk; ++kc) gram_chunk<B>(st, kc, I, J, acc, accq, accd);
    if (GT::D2 > 0) gram_diag<B>(st, nk, acc2);
    __syncwarp();  // every lane is done with this stage before it is refilled
  }
  cp_async_wait_all();
  __syncthreads();  // every warp is past its ring: the epilogue reuses it

  // each warp's tiles and q, lane by lane, then their sums in warp order
  float* part = dyn;                              // [nw][32][kGramPart] pass-1 tiles
  float* part2 = part + nw * 32 * kGramPart;      // [nw][32][29] the diagonal blocks' (D2 > 0)
  float* qpart = part2 + (GT::D2 > 0 ? nw * 32 * 29 : 0);  // [nw][B]
  float* M = qpart + nw * B;                      // [B][B] the summed Gram
  if (lane < GT::T1) {
    float* mine = part + (warp * 32 + lane) * kGramPart;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      *reinterpret_cast<float4*>(mine + 8 * i) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(mine + 8 * i + 4) = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
  }
  if (GT::D2 > 0) {
    float* mine = part2 + (warp * 32 + lane) * 29;
#pragma unroll
    for (int i = 0; i < 28; ++i) mine[i] = acc2[i];
    mine[28] = accd;
  }
#pragma unroll
  for (int s = 0; s < QR; ++s)
    if (lane + 32 * s < B) qpart[warp * B + lane + 32 * s] = accq[s];
  __syncthreads();

  // pass-1 tiles: row 8I + i, columns 8J + 4h .. + 3, mirrored above the
  // diagonal blocks; a diagonal block is symmetric as computed (fmaf(a, b,
  // c) and fmaf(b, a, c) round alike), so the scratch's Gram is bit-exactly
  // symmetric
  for (int g = tid; g < GT::T1 * 16; g += blockDim.x) {
    const int L = g >> 4, i = (g >> 1) & 7, h = g & 1;
    const float* src = part + L * kGramPart + 8 * i + 4 * h;
    float4 v = *reinterpret_cast<const float4*>(src);
    for (int q = 1; q < nw; ++q) {
      const float4 o = *reinterpret_cast<const float4*>(src + q * 32 * kGramPart);
      v.x += o.x;
      v.y += o.y;
      v.z += o.z;
      v.w += o.w;
    }
    int TI, TJ;
    gram_tile<B>(L, TI, TJ);
    const int row = 8 * TI + i, col = 8 * TJ + 4 * h;
    *reinterpret_cast<float4*>(M + row * B + col) = v;
    if (TI != TJ) {
      M[col * B + row] = v.x;
      M[(col + 1) * B + row] = v.y;
      M[(col + 2) * B + row] = v.z;
      M[(col + 3) * B + row] = v.w;
    }
  }
  if (GT::D2 > 0) {
    // below the diagonal of blocks 4..7: lanes P - 4 + 4c hold block P over
    // chunks c; summed lane by lane in each warp, warp by warp
    for (int g = tid; g < 4 * 28; g += blockDim.x) {
      const int bq = g / 28, e = g % 28;
      float v = 0.f;
      for (int q = 0; q < nw; ++q)
        for (int c = 0; c < 8; ++c) v += part2[(q * 32 + bq + 4 * c) * 29 + e];
      int i = 1;
      while ((i + 1) * i / 2 <= e) ++i;
      const int P = GT::R - GT::D2 + bq, row = 8 * P + i, col = 8 * P + e - i * (i - 1) / 2;
      M[row * B + col] = v;
      M[col * B + row] = v;
    }
    // their diagonal, row 32 + l from lane l (its q step)
    for (int l = tid; l < 32; l += blockDim.x) {
      float v = 0.f;
      for (int q = 0; q < nw; ++q) v += part2[(q * 32 + l) * 29 + 28];
      const int row = 8 * (GT::R - GT::D2) + l;
      M[row * B + row] = v;
    }
  }
  for (int i = tid; i < B; i += blockDim.x) {
    float s = qpart[i];
    for (int q = 1; q < nw; ++q) s += qpart[q * B + i];
    blk[B * B + i] = s;
  }
  __syncthreads();
  for (int e = tid; e < B * B / 4; e += blockDim.x)
    reinterpret_cast<float4*>(blk)[e] = reinterpret_cast<const float4*>(M)[e];
}

// ---------------------------------------------------------------------------
// stage 2: the chain, one cluster per task
// ---------------------------------------------------------------------------
template <int B>
struct ChainSmem {
  // float offsets into the dynamic shared memory of one CTA
  int rows, blk, r, xr, at0, dstart, deltas, cbn, total;
  __host__ __device__ ChainSmem(int dcp) {
    rows = 0;                                    // [2][B][dcp] gathered rows
    blk = rows + 2 * B * dcp;                    // [2][scratch_floats<B>]
    r = blk + 2 * scratch_floats<B>();           // [dcp] this CTA's r
    xr = r + dcp;                                // [2][B] partial xr
    at0 = xr + 2 * B;                            // [2][B] alpha~ (rank 0)
    dstart = at0 + 2 * B;                        // [2][B] dalpha at block start (rank 0)
    deltas = dstart + 2 * B;                     // [B]
    cbn = deltas + B;                            // [B] next block's ids
    total = cbn + B;
  }
};

// warps 1-7: the rows (this CTA's columns) and scratch of block bi into
// buffer buf, with cp.async; one commit group per thread
template <int B>
__device__ void prefetch_block(const float* __restrict__ x, const float* __restrict__ scratch,
                               float* dyn, const ChainSmem<B>& L, int t, int bi, int buf,
                               int n_max, int d, int nbg, int c0, int dc, int dcp, bool vec) {
  constexpr int SF = scratch_floats<B>();
  constexpr int NP = kThreads - 32;  // prefetching threads
  const int p = threadIdx.x - 32;
  const float* src = scratch + ((int64_t)t * nbg + bi) * SF;
  int* cbn = reinterpret_cast<int*>(dyn + L.cbn);
  if (p < B) cbn[p] = reinterpret_cast<const int*>(src)[B * B + 3 * B + p];
  float* blk = dyn + L.blk + buf * SF;
  for (int e = p; e < SF / 4; e += NP) cp_async16(blk + 4 * e, src + 4 * e);
  asm volatile("bar.sync 1, %0;\n" ::"n"(NP) : "memory");  // cbn is written
  float* rows = dyn + L.rows + buf * B * dcp;
  const float* xt = x + (int64_t)t * n_max * d + c0;
  if (vec) {
    const int nq = dc / 4;
    for (int e = p; e < B * nq; e += NP) {
      const int k = e / nq, c = 4 * (e - k * nq);
      cp_async16(rows + k * dcp + c, xt + (int64_t)cbn[k] * d + c);
    }
  } else {
    for (int e = p; e < B * dc; e += NP) {
      const int k = e / dc, c = e - k * dc;
      cp_async4(rows + k * dcp + c, xt + (int64_t)cbn[k] * d + c);
    }
  }
  cp_async_commit();
}

// rank 0, thread k < B: alpha~ = alpha[j] + dalpha[j] of row k of block bi
// (coordinate ids in cbn, alphas from the scratch) into buffer buf, and
// dalpha[j] itself, which the block's scatter adds to
template <int B>
__device__ __forceinline__ void alpha_tilde(float* dyn, const ChainSmem<B>& L,
                                            const float* __restrict__ scratch,
                                            const float* dat, const int* cbn, int t, int bi,
                                            int nbg, int buf) {
  const int k = threadIdx.x;
  const float dst = dat[cbn[k]];
  const float al = scratch[((int64_t)t * nbg + bi) * scratch_floats<B>() + B * B + 2 * B + k];
  dyn[L.at0 + buf * B + k] = al + dst;
  dyn[L.dstart + buf * B + k] = dst;
}

template <int B, int LOSS>
__global__ void __launch_bounds__(kThreads)
chain_kernel(const float* __restrict__ x,        // (m, n_max, d)
             const float* __restrict__ scratch,  // (m, nbg, scratch_floats<B>)
             const float* __restrict__ kappa,    // (m,)
             float* __restrict__ dalpha,         // (m, n_max)
             float* __restrict__ r_out,          // (m, d): r in, r out
             int n_max, int d, int nbg, int dcp, int vec) {
  constexpr int SF = scratch_floats<B>();
  constexpr int NR = ChainRows<B>::NR;  // recursion rows per lane
  constexpr int RPW = B / 8;         // xr rows per warp
  extern __shared__ __align__(16) float dyn[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), C = (int)cluster.num_blocks();
  const ChainSmem<B> L(dcp);
  const int t = blockIdx.y, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c0 = rank * dcp, dc = max(0, min(dcp, d - c0));
  const float kap = kappa[t];
  float* r_s = dyn + L.r;
  float* deltas = dyn + L.deltas;
  float* dat = dalpha + (int64_t)t * n_max;

  for (int c = tid; c < dc; c += kThreads) r_s[c] = r_out[(int64_t)t * d + c0 + c];
  if (warp != 0)
    prefetch_block<B>(x, scratch, dyn, L, t, 0, 0, n_max, d, nbg, c0, dc, dcp, vec);
  cp_async_wait_all();
  __syncthreads();
  if (rank == 0 && tid < B)  // alpha~ of the first block (the cluster barrier orders it)
    alpha_tilde<B>(dyn, L, scratch, dat, reinterpret_cast<const int*>(dyn + L.cbn), t, 0, nbg, 0);

  for (int bi = 0; bi < nbg; ++bi) {
    const int buf = bi & 1;
    const float* rows = dyn + L.rows + buf * B * dcp;
    const float* blk = dyn + L.blk + buf * SF;
    const float* G = blk;
    const int* cb = reinterpret_cast<const int*>(blk + B * B + 3 * B);

    // 1. partial xr over this CTA's columns: warp w owns rows w + 8i
    {
      float acc[RPW];
#pragma unroll
      for (int i = 0; i < RPW; ++i) acc[i] = 0.f;
      for (int c = lane; c < dc; c += 32) {
        const float rv = r_s[c];
#pragma unroll
        for (int i = 0; i < RPW; ++i) acc[i] = fmaf(rows[(warp + 8 * i) * dcp + c], rv, acc[i]);
      }
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float s = warp_sum(acc[i]);
        if (lane == 0) dyn[L.xr + buf * B + warp + 8 * i] = s;
      }
    }
    cluster.sync();

    if (warp == 0) {
      // 3. the recursion, on every CTA of the cluster
      ChainRows<B> rr;
      const float* at0 = cluster.map_shared_rank(dyn + L.at0, 0) + buf * B;
#pragma unroll
      for (int s = 0; s < NR; ++s) {
        const int i = min(lane + 32 * s, B - 1);
        float xr = 0.f;
        for (int qr = 0; qr < C; ++qr) xr += cluster.map_shared_rank(dyn + L.xr, qr)[buf * B + i];
        rr.acc[s] = xr;
        rr.q[s] = blk[B * B + i];
        rr.y[s] = blk[B * B + B + i];
        rr.at[s] = at0[i];
        rr.inv[s] = recip_of<LOSS>(kap * G[i * B + i]);
        rr.cb[s] = cb[i];
      }
      right_looking<B, LOSS>(rr, G, cb, kap);
#pragma unroll
      for (int s = 0; s < NR; ++s)
        if (lane + 32 * s < B) deltas[lane + 32 * s] = rr.delta[s];
      // 4a. rank 0 scatters: the first row of each coordinate writes dalpha
      // at block start plus every delta of the block drawn there, summed in
      // draw order (dup now holds all of them)
      if (rank == 0) {
#pragma unroll
        for (int s = 0; s < NR; ++s)
          if (rr.first[s]) dat[rr.cb[s]] = dyn[L.dstart + buf * B + lane + 32 * s] + rr.dup[s];
      }
    } else if (bi + 1 < nbg) {
      prefetch_block<B>(x, scratch, dyn, L, t, bi + 1, buf ^ 1, n_max, d, nbg, c0, dc, dcp, vec);
    }
    __syncthreads();

    // alpha~ of the next block, after this block's scatter; its loads are in
    // flight during the r update
    if (rank == 0 && tid < B && bi + 1 < nbg)
      alpha_tilde<B>(dyn, L, scratch, dat, reinterpret_cast<const int*>(dyn + L.cbn), t,
                     bi + 1, nbg, buf ^ 1);
    // 4b. r += X_b^T deltas over this CTA's columns
    for (int c = tid; c < dc; c += kThreads) {
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 4
      for (int k = 0; k < B; k += 4) {
        a0 = fmaf(rows[k * dcp + c], deltas[k], a0);
        a1 = fmaf(rows[(k + 1) * dcp + c], deltas[k + 1], a1);
        a2 = fmaf(rows[(k + 2) * dcp + c], deltas[k + 2], a2);
        a3 = fmaf(rows[(k + 3) * dcp + c], deltas[k + 3], a3);
      }
      r_s[c] += (a0 + a1) + (a2 + a3);
    }
    cp_async_wait_all();
    __syncthreads();
  }
  for (int c = tid; c < dc; c += kThreads) r_out[(int64_t)t * d + c0 + c] = r_s[c];
  cluster.sync();  // no CTA leaves while another may read its shared memory
}

}  // namespace sdca

#include "sdca_stream.cuh"

namespace sdca {

// columns of d per CTA of a cluster of C: a multiple of 4, so 16-byte copies
// stay aligned
inline int slab(int d, int C) { return ((d + C - 1) / C + 3) / 4 * 4; }

// warps < 0: the round is gram_kernel then chain_kernel; warps > 0: the
// round is chain_stream_kernel alone, that many warps a CTA and C CTAs a
// task, all resident together (a cooperative launch), exchanging through
// the scratch: stream_scratch_floats<B>(m, C)
template <int B>
cudaError_t launch(const float* x, const float* y, const float* alpha, const float* w,
                   const float* u, const int* n, const float* kappa, float* dalpha,
                   float* r, float* scratch, int m, int n_max, int d, int H,
                   int group, int C, int loss, int stages, int warps, cudaStream_t stream) {
  const int nb = H / B;
  const int dcp = slab(d, C);
  const bool streamed = warps > 0;
  const size_t chain_smem = streamed
      ? (size_t)StreamSmem<B>(dcp, warps).total * sizeof(float)
      : (size_t)ChainSmem<B>(dcp).total * sizeof(float);
  // stage 1: one warp per column range of at least two ring stages where d
  // has them (the second's copy runs under the first's FMAs), at most
  // kGramWarps (at d = 100 two warps took 17.0 us at Synthetic-1's width and
  // four 23.4, H100)
  const int ranges = (d + 2 * kGramCols - 1) / (2 * kGramCols);
  const int gram_warps = ranges < kGramWarps ? ranges : kGramWarps;
  const size_t gram_smem = (size_t)gram_smem_floats<B>(gram_warps) * sizeof(float);
  if (chain_smem > 232448 || (streamed && stages != 2)) return cudaErrorInvalidValue;
  const int vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int vec1 = vec && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, m);
  cfg.blockDim = dim3(streamed ? 32 * warps : kThreads);
  cfg.dynamicSmemBytes = chain_smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err;
  if (streamed) {
    using StreamFn = void (*)(const float*, const float*, const float*, const float*,
                              const float*, const int*, const float*, float*, float*, float*,
                              float*, float*, int*, int, int, int, int, int);
    StreamFn fused = loss == kHinge     ? chain_stream_kernel<B, kHinge>
                     : loss == kSquared ? chain_stream_kernel<B, kSquared>
                                        : chain_stream_kernel<B, kSmoothedHinge>;
    float* part = scratch;
    float* sum = part + (size_t)m * C * exchange_floats<B>();
    float* at0g = sum + (size_t)m * exchange_floats<B>();
    int* cnt = reinterpret_cast<int*>(at0g + (size_t)m * 2 * B);
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    cfg.numAttrs = C > 1 ? 1 : 0;
    err = cudaFuncSetAttribute(fused, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)chain_smem);
    if (err == cudaSuccess) err = cudaMemsetAsync(cnt, 0, (size_t)m * sizeof(int), stream);
    if (err == cudaSuccess)
      err = cudaLaunchKernelEx(&cfg, fused, x, y, alpha, w, u, n, kappa, dalpha, r, part, sum,
                               at0g, cnt, n_max, d, H, dcp, vec1);
    if (err == cudaSuccess) err = cudaGetLastError();
    return err;
  }
  using ChainFn = void (*)(const float*, const float*, const float*, float*, float*, int, int,
                           int, int, int);
  ChainFn chain = loss == kHinge     ? chain_kernel<B, kHinge>
                  : loss == kSquared ? chain_kernel<B, kSquared>
                                     : chain_kernel<B, kSmoothedHinge>;
  err = cudaFuncSetAttribute(chain, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)chain_smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gram_kernel<B>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)gram_smem);
  if (err != cudaSuccess) return err;
  for (int b0 = 0; b0 < nb; b0 += group) {
    const int nbg = nb - b0 < group ? nb - b0 : group;
    if (stages & 1) {
      gram_kernel<B><<<dim3(nbg, m), 32 * gram_warps, gram_smem, stream>>>(
          x, y, alpha, w, u, n, scratch, n_max, d, H, b0, nbg, vec1);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    if (stages & 2) {
      err = cudaLaunchKernelEx(&cfg, chain, x, (const float*)scratch, kappa, dalpha, r, n_max, d,
                               nbg, dcp, vec);
      if (err != cudaSuccess) return err;
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

}  // namespace sdca

// Plain C entry point for ctypes. dalpha and r are zero on entry. warps: -1
// runs the round as gram_kernel then chain_kernel in groups of `group` blocks
// (scratch holds m * group * (B*B + 4B) floats), cluster 2, 4 or 8 CTAs a
// task in stage 2; 2 or 4 runs it as chain_stream_kernel alone, that many
// warps a CTA and `cluster` (1 to 16) CTAs a task, scratch holding
// stream_scratch_floats<B>(m, cluster) floats. stages: 1 = stage 1
// only, 2 = stage 2 only (the streamed round whole), 3 = the round (the
// single stages exist to time them apart). Returns a cudaError_t (0 =
// launched).
extern "C" int sdca_round_launch(const void* x, const void* y, const void* alpha,
                                 const void* w, const void* u, const void* n,
                                 const void* kappa, void* dalpha, void* r, void* scratch,
                                 int m, int n_max, int d, int H, int block, int loss,
                                 int group, int cluster, int stages, int warps, void* stream) {
  using namespace sdca;
  const bool streamed = warps > 0;
  if (H % block != 0 || loss < kHinge || loss > kSmoothedHinge || group < 1 ||
      (warps != -1 && warps != 2 && warps != kStreamMaxWarps) ||
      (streamed ? cluster < 1 || cluster > kStreamMaxCtas
                : cluster != 2 && cluster != 4 && cluster != 8))
    return (int)cudaErrorInvalidValue;
#define SDCA_ROUND_CASE(BB)                                                               \
  case BB:                                                                                \
    return (int)launch<BB>((const float*)x, (const float*)y, (const float*)alpha,        \
                           (const float*)w, (const float*)u, (const int*)n,              \
                           (const float*)kappa, (float*)dalpha, (float*)r,               \
                           (float*)scratch, m, n_max, d, H, group, cluster, loss, stages, \
                           warps, (cudaStream_t)stream);
  switch (block) {
    SDCA_ROUND_CASE(16)
    SDCA_ROUND_CASE(32)
    SDCA_ROUND_CASE(64)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SDCA_ROUND_CASE
}
