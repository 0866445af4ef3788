// One fused local SDCA round for every task in ONE call (the
// `pallas_round` solver backend), as two kernels over the whole card.
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
//   Stage 1, gram_kernel, grid (blocks, m), 256 threads: draws the block's
//   coordinates (fp32 product and truncation of sample_coords, row n_max - 1
//   for a task with no samples, as coords_from_uniform wraps), gathers its
//   B rows in d-tiles of 32 columns (stored transposed, the next tile's
//   loads in flight while this one is used), and writes G (full B x B,
//   bit-exactly symmetric), q, and the rows' labels, alphas and ids to a
//   scratch the wrapper allocates. fp32 FMAs: TF32 would break the 2e-5 bar.
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
// What bounds it on this card: stage 1 is fp32 FMA work (the full Gram
// blocks, 12.1 GFLOP at MNIST width, twice the triangle the recursion
// reads) and the gathered rows; stage 2 is a dependent chain
// of H steps per task (a closed-form delta, a shuffle, an FMA), plus per
// block a cluster barrier, the partial xr and the r update.
//
// Where no supported cluster fits d in shared memory (d > 3008 at B = 64),
// stage 2 is chain_stream_kernel instead (sdca_stream.cuh): the same chain,
// the block's rows read from global memory rather than held whole.
#include <cooperative_groups.h>

#include "sdca_common.cuh"

namespace cg = cooperative_groups;

namespace sdca {

constexpr int kGramTile = 32;  // d-columns of the gathered rows per stage-1 tile

// floats of one block's scratch: G (B x B), q, labels, alphas, coordinate ids
template <int B>
__host__ __device__ constexpr int scratch_floats() {
  return B * B + 4 * B;
}

// Element e of a stage-1 tile (B rows x kGramTile columns): each quarter
// warp reads 8 consecutive columns of 4 rows, so the global loads fill
// 32-byte sectors and the transposed shared stores hit 32 distinct banks.
__device__ __forceinline__ void gram_elem(int e, int& k, int& c) {
  static_assert(kGramTile == 32, "the mapping takes 4 groups of 8 columns");
  c = (e & 7) | (((e >> 5) & 3) << 3);
  k = ((e >> 3) & 3) | ((e >> 7) << 2);
}

// this thread's elements of the tile at column d0 into registers
template <int B>
__device__ __forceinline__ void load_gram_tile(float (&pre)[B * kGramTile / kThreads],
                                               const float* __restrict__ x,
                                               const int64_t* rowoff, int d0, int d) {
#pragma unroll
  for (int i = 0; i < B * kGramTile / kThreads; ++i) {
    int k, c;
    gram_elem(threadIdx.x + i * kThreads, k, c);
    pre[i] = d0 + c < d ? x[rowoff[k] + d0 + c] : 0.f;
  }
}

// ---------------------------------------------------------------------------
// stage 1: G, q and the block's metadata for every (block, task)
// ---------------------------------------------------------------------------
template <int B>
__global__ void __launch_bounds__(kThreads)
gram_kernel(const float* __restrict__ x,      // (m, n_max, d)
            const float* __restrict__ y,      // (m, n_max)
            const float* __restrict__ alpha,  // (m, n_max)
            const float* __restrict__ w,      // (m, d)
            const float* __restrict__ u,      // (m, H)
            const int* __restrict__ n,        // (m,)
            float* __restrict__ scratch,      // (m, nbg, scratch_floats<B>)
            int n_max, int d, int H, int b_begin, int nbg) {
  constexpr int KT = kGramTile;
  constexpr int LDT = B + 4;               // xsT row stride: float4 aligned
  constexpr int TG = B / 4;                // Gram threads: TG x TG, 4 x 4 each
  constexpr int PER = B * KT / kThreads;   // tile elements loaded per thread
  constexpr int QP = kThreads / B;         // q partial sums per row
  __shared__ __align__(16) float xsT[KT][LDT];
  __shared__ int64_t rowoff[B];
  __shared__ float qpart[QP][B];
  extern __shared__ float w_s[];           // (ceil(d / KT) * KT,) zero-padded

  const int bi = blockIdx.x, t = blockIdx.y, tid = threadIdx.x;
  const int nt = n[t];
  float* blk = scratch + ((int64_t)t * nbg + bi) * scratch_floats<B>();
  if (tid < B) {
    int j = min((int)__fmul_rn(u[(int64_t)t * H + (b_begin + bi) * B + tid], (float)nt), nt - 1);
    // a task with no samples (a padded task, or a pod slice past its
    // samples) gets -1: the plain version's wrap to the block's last row,
    // so nothing outside the task's own rows is read or written
    if (j < 0) j += n_max;
    rowoff[tid] = ((int64_t)t * n_max + j) * d;
    blk[B * B + B + tid] = y[(int64_t)t * n_max + j];
    blk[B * B + 2 * B + tid] = alpha[(int64_t)t * n_max + j];
    reinterpret_cast<int*>(blk)[B * B + 3 * B + tid] = j;
  }
  const int n_tiles = (d + KT - 1) / KT;
  for (int c = tid; c < n_tiles * KT; c += kThreads)
    w_s[c] = c < d ? w[(int64_t)t * d + c] : 0.f;
  __syncthreads();

  float pre[PER];
  load_gram_tile<B>(pre, x, rowoff, 0, d);
  const int ti = tid / TG, tj = tid % TG;
  const bool gram_thread = tid < TG * TG;
  float g[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) g[a][b] = 0.f;
  const int qk = tid % B, qp = tid / B;
  float qacc = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    __syncthreads();  // the previous tile is consumed
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      int k, c;
      gram_elem(threadIdx.x + i * kThreads, k, c);
      xsT[c][k] = pre[i];
    }
    __syncthreads();
    if (tile + 1 < n_tiles)  // in flight during the FMAs
      load_gram_tile<B>(pre, x, rowoff, (tile + 1) * KT, d);
    if (gram_thread) {
#pragma unroll 8
      for (int c = 0; c < KT; ++c) {
        const float4 a4 = *reinterpret_cast<const float4*>(&xsT[c][4 * ti]);
        const float4 b4 = *reinterpret_cast<const float4*>(&xsT[c][4 * tj]);
        const float av[4] = {a4.x, a4.y, a4.z, a4.w}, bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) g[a][b] = fmaf(av[a], bv[b], g[a][b]);
      }
    }
#pragma unroll
    for (int cc = 0; cc < KT / QP; ++cc) {
      const int c = qp * (KT / QP) + cc;
      qacc = fmaf(xsT[c][qk], w_s[tile * KT + c], qacc);
    }
  }
  qpart[qp][qk] = qacc;
  if (gram_thread) {
#pragma unroll
    for (int a = 0; a < 4; ++a)
      *reinterpret_cast<float4*>(&blk[(4 * ti + a) * B + 4 * tj]) =
          make_float4(g[a][0], g[a][1], g[a][2], g[a][3]);
  }
  __syncthreads();
  if (tid < B) {
    float s = 0.f;
#pragma unroll
    for (int p = 0; p < QP; ++p) s += qpart[p][tid];
    blk[B * B + tid] = s;
  }
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

// hold < 0: stage 2 is chain_kernel; hold >= 0: chain_stream_kernel, keeping
// the first `hold` columns (a multiple of 4) of each CTA's slab
template <int B>
cudaError_t launch(const float* x, const float* y, const float* alpha, const float* w,
                   const float* u, const int* n, const float* kappa, float* dalpha,
                   float* r, float* scratch, int m, int n_max, int d, int H,
                   int group, int C, int loss, int stages, int hold, cudaStream_t stream) {
  const int nb = H / B;
  const int dcp = slab(d, C);
  const bool streamed = hold >= 0;
  const size_t chain_smem = streamed
      ? (size_t)StreamSmem<B>(dcp, hold).total * sizeof(float)
      : (size_t)ChainSmem<B>(dcp).total * sizeof(float);
  const size_t gram_smem = (size_t)((d + kGramTile - 1) / kGramTile * kGramTile) * sizeof(float);
  if (chain_smem > 232448 || gram_smem > 232448 || (streamed && hold % 4 != 0))
    return cudaErrorInvalidValue;
  using ChainFn = void (*)(const float*, const float*, const float*, float*, float*, int, int,
                           int, int, int);
  using StreamFn = void (*)(const float*, const float*, const float*, float*, float*, int, int,
                            int, int, int, int);
  ChainFn chain = loss == kHinge     ? chain_kernel<B, kHinge>
                  : loss == kSquared ? chain_kernel<B, kSquared>
                                     : chain_kernel<B, kSmoothedHinge>;
  StreamFn chain_stream = loss == kHinge     ? chain_stream_kernel<B, kHinge>
                          : loss == kSquared ? chain_stream_kernel<B, kSquared>
                                             : chain_stream_kernel<B, kSmoothedHinge>;
  const void* stage2 = streamed ? (const void*)chain_stream : (const void*)chain;
  cudaError_t err =
      cudaFuncSetAttribute(stage2, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)chain_smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gram_kernel<B>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)gram_smem);
  if (err != cudaSuccess) return err;
  const int vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  for (int b0 = 0; b0 < nb; b0 += group) {
    const int nbg = nb - b0 < group ? nb - b0 : group;
    if (stages & 1) {
      gram_kernel<B><<<dim3(nbg, m), kThreads, gram_smem, stream>>>(
          x, y, alpha, w, u, n, scratch, n_max, d, H, b0, nbg);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    if (stages & 2) {
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(C, m);
      cfg.blockDim = dim3(kThreads);
      cfg.dynamicSmemBytes = chain_smem;
      cfg.stream = stream;
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = C;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      err = streamed ? cudaLaunchKernelEx(&cfg, chain_stream, x, (const float*)scratch, kappa,
                                          dalpha, r, n_max, d, nbg, dcp, hold, vec)
                     : cudaLaunchKernelEx(&cfg, chain, x, (const float*)scratch, kappa, dalpha,
                                          r, n_max, d, nbg, dcp, vec);
      if (err != cudaSuccess) return err;
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

}  // namespace sdca

// Plain C entry point for ctypes. dalpha and r are zero on entry; scratch
// holds m * group * (B*B + 4B) floats; the round runs in groups of `group`
// blocks. stages: 1 = stage 1 only, 2 = stage 2 only, 3 = the round (the
// single stages exist to time them apart). cluster: 2, 4 or 8 CTAs a task
// in stage 2. hold: -1 runs stage 2 as chain_kernel, >= 0 as
// chain_stream_kernel keeping that many columns of a CTA's slab. Returns a
// cudaError_t (0 = launched).
extern "C" int sdca_round_launch(const void* x, const void* y, const void* alpha,
                                 const void* w, const void* u, const void* n,
                                 const void* kappa, void* dalpha, void* r, void* scratch,
                                 int m, int n_max, int d, int H, int block, int loss,
                                 int group, int cluster, int stages, int hold, void* stream) {
  using namespace sdca;
  if (H % block != 0 || loss < kHinge || loss > kSmoothedHinge || group < 1 || hold < -1 ||
      (cluster != 2 && cluster != 4 && cluster != 8))
    return (int)cudaErrorInvalidValue;
#define SDCA_ROUND_CASE(BB)                                                               \
  case BB:                                                                                \
    return (int)launch<BB>((const float*)x, (const float*)y, (const float*)alpha,        \
                           (const float*)w, (const float*)u, (const int*)n,              \
                           (const float*)kappa, (float*)dalpha, (float*)r,               \
                           (float*)scratch, m, n_max, d, H, group, cluster, loss, stages, \
                           hold, (cudaStream_t)stream);
  switch (block) {
    SDCA_ROUND_CASE(16)
    SDCA_ROUND_CASE(32)
    SDCA_ROUND_CASE(64)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SDCA_ROUND_CASE
}
