// The round at large d in one launch: chain_stream_kernel.
//
// chain_kernel (sdca_round.cu) keeps every block's gathered rows in shared
// memory over the CTA's slab of d / C columns, double-buffered, so a Hopper
// CTA's 227 KB caps d: at B = 64 it fits d <= 1504 at C = 4 and d <= 3008 at
// C = 8. At the paper's MDS width (d = 10 000) one block's drawn rows are
// 2.5 MB, so past that width the rows are streamed: read once for the Gram
// triangle, q and xr, and once more for the r update. Stage 1 and a
// streaming chain apart read them three times.
//
// C CTAs a task (grid (C, m)) walk the task's blocks in order. CTA `rank`
// owns a slab of dcp columns (a multiple of 4) of r, in shared memory; each
// of its warps owns a contiguous range of the slab's 4-column chunks and
// streams the block's rows over it through a ring of its own (two stages of
// 32 columns: gram_issue's 16-byte cp.async, or 4-byte zero-filled ones
// where d % 4 != 0, the rows XOR-swizzled as in stage 1), waiting on its own
// copies only. Per block:
//   1. first read: every warp accumulates over its columns the lane tiles of
//      the Gram's lower triangle (gram_chunk, gram_diag), q = X_b w and xr =
//      X_b r; meanwhile threads k < B load the next block's draw
//      (gram_kernel's fp32 product and truncation, row n_max - 1 for a task
//      with no samples);
//   2. the warps' partials are summed in warp order and written to the
//      task's global scratch; the task's CTAs meet (a counter in global
//      memory), CTA `rank` sums its slice of the exchange over the C CTAs in
//      rank order into the task's sum, they meet again, and every CTA reads
//      the sum into G (mirrored, bit-exactly symmetric), q and xr: every CTA
//      holds the same bits;
//   3. warp 0 of every CTA runs the recursion of sdca_common.cuh on rank 0's
//      alpha~ (replicated, so the deltas need no exchange); rank 0 scatters
//      into dalpha and publishes the next block's alpha~;
//   4. second read: r += X_b^T deltas, each warp walking its range
//      backwards, so its ring's last two stages of the first read serve the
//      first two of the second and the next come from L2 first; the stage
//      after the last is the next block's first.
// The drawn rows and alpha~ are double-buffered by block parity; the two
// meetings a block order every exchange.
//
// Why global memory and not a thread-block cluster: a task's CTAs wait for
// each other, so all of them must be resident, and the first read's FMAs
// set the pace only where every SM holds the same work. At the MDS width
// (22 tasks) 12 CTAs a task fill the card's 132 SMs twice over (two CTAs of
// 4 warps an SM, by registers and shared memory), but clusters of 12 fit
// only 16 at a time (cudaOccupancyMaxActiveClusters, H100), and clusters of
// 8 leave 88 SMs with one CTA and 44 with two. So the launch is
// cooperative (all CTAs resident) and the exchange goes through L2 (about
// 10 KB a CTA a block). With m tasks too many for 2 CTAs a task to be
// resident, a task takes one CTA, which waits for no other.
//
// What binds it (H100, MDS width, 12 CTAs a task, 13.3-13.5 ms a round; per
// block, the mean over CTAs): the first read, 30 us: fp32 FMAs (2 (B(B + 1)/2
// + 2B) d a block, 222 GFLOP a round, 3.3 ms at 67 TFLOP/s) through 8 x 8
// lane tiles that read as many floats from shared memory as they do FMAs, on
// two CTAs an SM; the second read, 9.7 us, one stage in flight a warp; the
// two meetings and the sums through L2, 12.5 us; the recursion, 5.1 us.
// Only the order of each sum differs from the two-stage round; fp32 FMAs
// only.
//
// Included by sdca_round.cu after chain_kernel: the stage-1 helpers, the
// coordinate draw's rule and the C entry point are the round's own.
#pragma once

namespace sdca {

constexpr int kStreamMaxWarps = 4;  // warps (column ranges) a CTA at most
constexpr int kStreamMaxCtas = 16;  // CTAs a task at most
constexpr int kExTile = 68;          // floats of one lane tile in the exchange (padded)

// floats of one exchange buffer: the lane tiles of the Gram's triangle, the
// diagonal blocks pass 1 leaves (below their diagonal, then the diagonal of
// rows 32..63), q and xr
template <int B>
__host__ __device__ constexpr int exchange_floats() {
  return kExTile * GramTiles<B>::T1 + (GramTiles<B>::D2 > 0 ? 4 * 28 + 32 : 0) + 2 * B;
}

// floats of the global scratch of m tasks of C CTAs: every CTA's partials,
// each task's sum, rank 0's alpha~ (two buffers), then one int counter a task
template <int B>
__host__ __device__ constexpr size_t stream_scratch_floats(int m, int C) {
  return (size_t)m * ((size_t)(C + 1) * exchange_floats<B>() + 2 * B + 1);
}

// float offsets into the dynamic shared memory of one CTA of nw warps
template <int B>
struct StreamSmem {
  int ring, r, ex, G, q, xr, y, cb, al, at0, dstart, deltas, rowoff, total;
  __host__ __device__ StreamSmem(int dcp, int nw) {
    ring = 0;                                     // [nw][2][gram_stage_floats<B>]
    r = ring + nw * kGramDepth * gram_stage_floats<B>();  // [dcp] this CTA's r
    ex = r + dcp;                                 // [exchange_floats<B>]
    G = ex + exchange_floats<B>();                // [B][B] the summed Gram
    q = G + B * B;                                // [B]
    xr = q + B;                                   // [B]
    y = xr + B;                                   // [2][B] labels of the drawn rows
    cb = y + 2 * B;                               // [2][B] coordinate ids
    al = cb + 2 * B;                              // [2][B] alphas (rank 0)
    at0 = al + 2 * B;                             // [2][B] alpha~ (rank 0)
    dstart = at0 + 2 * B;                         // [2][B] dalpha at block start (rank 0)
    deltas = dstart + 2 * B;                      // [B]
    rowoff = deltas + B;                          // [2][B] int64 row offsets, in float pairs
    total = rowoff + 4 * B;
  }
};

// thread k < B: row k of block bi, drawn by gram_kernel's rule, with its
// label and (rank 0) its alpha; loaded a block ahead, stored when its
// buffer is free
struct DrawnRow {
  int j;
  float y, al;
};

template <int B>
__device__ __forceinline__ DrawnRow stream_draw(const float* __restrict__ y,
                                                const float* __restrict__ alpha,
                                                const float* __restrict__ u, int t, int nt,
                                                int n_max, int H, int bi, bool rank0) {
  DrawnRow r;
  r.j = min((int)__fmul_rn(u[(int64_t)t * H + bi * B + threadIdx.x], (float)nt), nt - 1);
  if (r.j < 0) r.j += n_max;  // no samples: the plain version's wrap to row n_max - 1
  r.y = y[(int64_t)t * n_max + r.j];
  r.al = rank0 ? alpha[(int64_t)t * n_max + r.j] : 0.f;
  return r;
}

template <int B>
__device__ __forceinline__ void stream_store(float* dyn, const StreamSmem<B>& L, DrawnRow r,
                                             int t, int n_max, int d, int buf) {
  const int k = threadIdx.x;
  reinterpret_cast<int64_t*>(dyn + L.rowoff)[buf * B + k] = ((int64_t)t * n_max + r.j) * d;
  dyn[L.y + buf * B + k] = r.y;
  reinterpret_cast<int*>(dyn + L.cb)[buf * B + k] = r.j;
  dyn[L.al + buf * B + k] = r.al;
}

// rank 0, thread k < B: alpha~ and dalpha at block start of row k of the
// block in buffer buf
template <int B>
__device__ __forceinline__ void stream_alpha_tilde(float* dyn, const StreamSmem<B>& L,
                                                   const float* dat, int buf) {
  const int k = threadIdx.x;
  const float dst = dat[reinterpret_cast<const int*>(dyn + L.cb)[buf * B + k]];
  dyn[L.at0 + buf * B + k] = dyn[L.al + buf * B + k] + dst;
  dyn[L.dstart + buf * B + k] = dst;
}

__device__ __forceinline__ float dot4(const float4 a, const float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void add4(float4& a, const float4 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// one warp's partials into the exchange buffer E (or added to it)
template <int B>
__device__ __forceinline__ void stream_part(float* E, bool add, const float (&acc)[8][8],
                                            const float (&acc2)[28], float accd,
                                            const float (&accq)[(B + 31) / 32],
                                            const float (&accx)[(B + 31) / 32]) {
  using GT = GramTiles<B>;
  constexpr int QR = (B + 31) / 32;
  constexpr int TILES = kExTile * GT::T1;
  const int lane = threadIdx.x & 31;
  if (lane < GT::T1) {
    float* e = E + lane * kExTile;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float4 v = make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                               acc[i][4 * h + 3]);
        float4* p = reinterpret_cast<float4*>(e + 8 * i + 4 * h);
        if (add) add4(v, *p);
        *p = v;
      }
  }
  if (GT::D2 > 0) {
    // lanes l and l ^ 4, ^ 8, ^ 16 hold block 4 + (l & 3) over other chunks
    if (lane < 4) {
      float* e = E + TILES + 28 * lane;
#pragma unroll
      for (int i = 0; i < 28; ++i) e[i] = add ? e[i] + acc2[i] : acc2[i];
    }
    float* e = E + TILES + 4 * 28 + lane;
    *e = add ? *e + accd : accd;
  }
  float* qx = E + TILES + (GT::D2 > 0 ? 4 * 28 + 32 : 0);
#pragma unroll
  for (int s = 0; s < QR; ++s)
    if (lane + 32 * s < B) {
      float* eq = qx + lane + 32 * s;
      *eq = add ? *eq + accq[s] : accq[s];
      eq[B] = add ? eq[B] + accx[s] : accx[s];
    }
}

// exchange elements e .. e + 3, summed over the task's CTAs, into G
// (mirrored), q and xr: gram_kernel's epilogue on the exchange layout
template <int B>
__device__ __forceinline__ void stream_scatter(float* dyn, const StreamSmem<B>& L, int e,
                                               float4 v) {
  using GT = GramTiles<B>;
  constexpr int TILES = kExTile * GT::T1;
  float* G = dyn + L.G;
  const float vs[4] = {v.x, v.y, v.z, v.w};
  if (e < TILES) {
    const int f = (e % kExTile) / 4;  // float4 within the tile; 16 is padding
    if (f >= 16) return;
    int TI, TJ;
    gram_tile<B>(e / kExTile, TI, TJ);
    const int row = 8 * TI + (f >> 1), col = 8 * TJ + 4 * (f & 1);
    *reinterpret_cast<float4*>(G + row * B + col) = v;
    if (TI != TJ)
#pragma unroll
      for (int k = 0; k < 4; ++k) G[(col + k) * B + row] = vs[k];
    return;
  }
  e -= TILES;
  if (GT::D2 > 0) {
    if (e < 4 * 28) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int bq = (e + k) / 28, x = (e + k) % 28;
        int i = 1;
        while ((i + 1) * i / 2 <= x) ++i;
        const int P = GT::R - GT::D2 + bq, row = 8 * P + i, col = 8 * P + x - i * (i - 1) / 2;
        G[row * B + col] = vs[k];
        G[col * B + row] = vs[k];
      }
      return;
    }
    e -= 4 * 28;
    if (e < 32) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int row = 8 * (GT::R - GT::D2) + e + k;
        G[row * B + row] = vs[k];
      }
      return;
    }
    e -= 32;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) dyn[L.q + e + k] = vs[k];  // q, then xr right after it
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// The CTAs of one task meet: each arrives once (its global writes made
// visible first), and all wait until the task's counter reaches C k. All of
// a task's CTAs are resident together (a cooperative launch), so the wait
// ends.
__device__ __forceinline__ void task_barrier(int* cnt, int C, int k) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.s32 [%0], 1;\n" ::"l"(cnt) : "memory");
    while (ld_acquire(cnt) < C * k) __nanosleep(32);
  }
  __syncthreads();
}

template <int B, int LOSS>
__global__ void __launch_bounds__(32 * kStreamMaxWarps)
chain_stream_kernel(const float* __restrict__ x,      // (m, n_max, d)
                    const float* __restrict__ y,      // (m, n_max)
                    const float* __restrict__ alpha,  // (m, n_max)
                    const float* __restrict__ w,      // (m, d)
                    const float* __restrict__ u,      // (m, H)
                    const int* __restrict__ n,        // (m,)
                    const float* __restrict__ kappa,  // (m,)
                    float* __restrict__ dalpha,       // (m, n_max)
                    float* __restrict__ r_out,        // (m, d): r in, r out
                    float* __restrict__ part,         // (m, C, exchange_floats<B>)
                    float* __restrict__ sum,          // (m, exchange_floats<B>)
                    float* __restrict__ at0g,         // (m, 2, B) alpha~ (rank 0's)
                    int* __restrict__ cnt,            // (m,) zero on entry
                    int n_max, int d, int H, int dcp, int vec) {
  using GT = GramTiles<B>;
  constexpr int SF = gram_stage_floats<B>();
  constexpr int EX = exchange_floats<B>();
  constexpr int NR = ChainRows<B>::NR;
  constexpr int QR = (B + 31) / 32;
  constexpr int KT = kGramCols;
  extern __shared__ __align__(16) float dyn[];
  const int rank = blockIdx.x, C = gridDim.x;
  const int nw = blockDim.x / 32;
  const StreamSmem<B> L(dcp, nw);
  const int t = blockIdx.y, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c0 = rank * dcp, dc = max(0, min(dcp, d - c0));
  const int nt = n[t], nb = H / B;
  const float kap = kappa[t];
  const float* wt = w + (int64_t)t * d;
  float* r_s = dyn + L.r;
  float* E = dyn + L.ex;
  float* dat = dalpha + (int64_t)t * n_max;
  float* part_t = part + (int64_t)t * C * EX;
  float* sum_t = sum + (int64_t)t * EX;
  float* at0_t = at0g + (int64_t)t * 2 * B;
  int* cnt_t = cnt + t;
  const int64_t* rowoff = reinterpret_cast<const int64_t*>(dyn + L.rowoff);

  // this warp's chunks of 4 columns, [k0, k1) of the slab's, in stages of 8;
  // chunk k of the slab is chunk c0 / 4 + k of the row
  const int n_chunks = (dc + 3) / 4;
  const int k0 = warp * n_chunks / nw, k1 = (warp + 1) * n_chunks / nw;
  const int ns = (k1 - k0 + 7) / 8;
  const int cs0 = c0 / 4 + k0;
  float* ring = dyn + L.ring + warp * kGramDepth * SF;
  auto stage_chunks = [&](int s) { return min(8, k1 - k0 - 8 * s); };

  for (int c = tid; c < dcp; c += blockDim.x)
    r_s[c] = c < dc ? r_out[(int64_t)t * d + c0 + c] : 0.f;
  if (tid < B)
    stream_store<B>(dyn, L, stream_draw<B>(y, alpha, u, t, nt, n_max, H, 0, rank == 0), t, n_max,
                    d, 0);
  __syncthreads();
  if (rank == 0 && tid < B) {
    stream_alpha_tilde<B>(dyn, L, dat, 0);
    at0_t[tid] = dyn[L.at0 + tid];
  }
  int slot = 0;  // ring stage of this warp's next stage
  if (ns > 0) gram_issue<B>(ring, x, wt, rowoff, cs0, stage_chunks(0), d, vec);
  cp_async_commit();

  int I, J;
  gram_tile<B>(lane, I, J);
  for (int bi = 0; bi < nb; ++bi) {
    const int buf = bi & 1;
    const int64_t* ro = rowoff + buf * B;
    // the next block's draw: its loads in flight during the first read
    DrawnRow next = {0, 0.f, 0.f};
    if (tid < B && bi + 1 < nb)
      next = stream_draw<B>(y, alpha, u, t, nt, n_max, H, bi + 1, rank == 0);

    // 1. first read: the Gram's lane tiles, q and xr over this warp's chunks
    float acc[8][8], acc2[28], accq[QR], accx[QR], accd = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll
    for (int i = 0; i < 28; ++i) acc2[i] = 0.f;
#pragma unroll
    for (int s = 0; s < QR; ++s) accq[s] = accx[s] = 0.f;
    for (int s = 0; s < ns; ++s) {
      if (s + 1 < ns)  // into the stage read at s - 1: __syncwarp below ordered it
        gram_issue<B>(ring + (slot ^ 1) * SF, x, wt, ro, cs0 + 8 * (s + 1), stage_chunks(s + 1),
                      d, vec);
      cp_async_commit();
      cp_async_wait_one();  // stage s is in
      __syncwarp();
      const float* st = ring + slot * SF;
      const int nk = stage_chunks(s);
      const float* rs = r_s + 4 * (k0 + 8 * s);
      for (int kc = 0; kc < nk; ++kc) {
        gram_chunk<B>(st, kc, I, J, acc, accq, accd);
        const float4 rv = *reinterpret_cast<const float4*>(rs + 4 * kc);
#pragma unroll
        for (int qs = 0; qs < QR; ++qs) {
          const int p = min(lane + 32 * qs, B - 1);
          const float4 xv = *reinterpret_cast<const float4*>(st + p * KT + ((kc ^ gram_swz(p)) << 2));
          accx[qs] = dot4(xv, rv, accx[qs]);
        }
      }
      if (GT::D2 > 0) gram_diag<B>(st, nk, acc2);
      __syncwarp();  // every lane is done with this stage before it is refilled
      slot ^= 1;
    }

    // 2. the warps' partials in warp order into the exchange buffer and out
    // to the task's slot for this CTA; the next block's draw stored once
    // every warp is past the previous block's rows
    if (GT::D2 > 0)
#pragma unroll
      for (int i = 0; i < 28; ++i)
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
          acc2[i] += __shfl_xor_sync(0xffffffffu, acc2[i], off);
    for (int q = 0; q < nw; ++q) {
      if (warp == q) stream_part<B>(E, q > 0, acc, acc2, accd, accq, accx);
      __syncthreads();
      if (q == 0 && tid < B && bi + 1 < nb)
        stream_store<B>(dyn, L, next, t, n_max, d, buf ^ 1);
    }
    for (int g = tid; g < EX / 4; g += blockDim.x)
      reinterpret_cast<float4*>(part_t + (int64_t)rank * EX)[g] =
          reinterpret_cast<const float4*>(E)[g];
    // 3. the C partials summed in rank order: CTA `rank` sums its slice over
    // the task's CTAs into the task's sum, which every CTA then reads whole,
    // so every CTA holds the same bits
    task_barrier(cnt_t, C, 2 * bi + 1);
    float at_pre[NR];  // rank 0's alpha~, written before its arrival
#pragma unroll
    for (int s = 0; s < NR; ++s)
      at_pre[s] = warp == 0 ? __ldcg(at0_t + buf * B + min(lane + 32 * s, B - 1)) : 0.f;
    {
      const int per = (EX / 4 + C - 1) / C;
      const int g1 = min(EX / 4, (rank + 1) * per);
      for (int g = rank * per + tid; g < g1; g += blockDim.x) {
        float4 v = __ldcg(reinterpret_cast<const float4*>(part_t) + g);
        for (int qr = 1; qr < C; ++qr)
          add4(v, __ldcg(reinterpret_cast<const float4*>(part_t + (int64_t)qr * EX) + g));
        reinterpret_cast<float4*>(sum_t)[g] = v;
      }
    }
    task_barrier(cnt_t, C, 2 * bi + 2);
    for (int g = tid; g < EX / 4; g += blockDim.x)
      stream_scatter<B>(dyn, L, 4 * g, __ldcg(reinterpret_cast<const float4*>(sum_t) + g));
    __syncthreads();

    // 4. the recursion, on every CTA of the task (chain_kernel's step 3)
    if (warp == 0) {
      const float* G = dyn + L.G;
      const int* cb = reinterpret_cast<const int*>(dyn + L.cb) + buf * B;
      ChainRows<B> rr;
#pragma unroll
      for (int s = 0; s < NR; ++s) {
        const int i = min(lane + 32 * s, B - 1);
        rr.acc[s] = dyn[L.xr + i];
        rr.q[s] = dyn[L.q + i];
        rr.y[s] = dyn[L.y + buf * B + i];
        rr.at[s] = at_pre[s];
        rr.inv[s] = recip_of<LOSS>(kap * G[i * B + i]);
        rr.cb[s] = cb[i];
      }
      right_looking<B, LOSS>(rr, G, cb, kap);
#pragma unroll
      for (int s = 0; s < NR; ++s)
        if (lane + 32 * s < B) dyn[L.deltas + lane + 32 * s] = rr.delta[s];
      // rank 0 scatters: the first row of each coordinate writes dalpha at
      // block start plus every delta of the block drawn there
      if (rank == 0) {
#pragma unroll
        for (int s = 0; s < NR; ++s)
          if (rr.first[s]) dat[rr.cb[s]] = dyn[L.dstart + buf * B + lane + 32 * s] + rr.dup[s];
      }
    }
    __syncthreads();
    // alpha~ of the next block, after this block's scatter, out to the task's
    // other CTAs (the next block's first barrier orders it)
    if (rank == 0 && tid < B && bi + 1 < nb) {
      stream_alpha_tilde<B>(dyn, L, dat, buf ^ 1);
      at0_t[(buf ^ 1) * B + tid] = dyn[L.at0 + (buf ^ 1) * B + tid];
    }

    // 5. second read, backwards: r += X_b^T deltas over this warp's columns,
    // lane l taking column l of each stage. The first read's last two
    // stages are in the ring; the stage after the last is the next block's
    // first
    const float* dl = dyn + L.deltas;
    slot ^= 1;  // the first read's last stage
    for (int s = ns - 1; s >= 0; --s) {
      if (s >= 1 && s < ns - 1)  // stage s - 1, unless the ring still holds it
        gram_issue<B>(ring + (slot ^ 1) * SF, x, wt, ro, cs0 + 8 * (s - 1), stage_chunks(s - 1),
                      d, vec);
      else if (s == 0 && bi + 1 < nb)
        gram_issue<B>(ring + (slot ^ 1) * SF, x, wt, rowoff + (buf ^ 1) * B, cs0,
                      stage_chunks(0), d, vec);
      cp_async_commit();
      cp_async_wait_one();
      __syncwarp();
      const float* st = ring + slot * SF;
      const int kc = lane >> 2;
      if (kc < stage_chunks(s)) {
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
        for (int k = 0; k < B; k += 4) {
          const float4 dk = *reinterpret_cast<const float4*>(dl + k);
          a0 = fmaf(st[k * KT + ((kc ^ gram_swz(k)) << 2) + (lane & 3)], dk.x, a0);
          a1 = fmaf(st[(k + 1) * KT + ((kc ^ gram_swz(k + 1)) << 2) + (lane & 3)], dk.y, a1);
          a2 = fmaf(st[(k + 2) * KT + ((kc ^ gram_swz(k + 2)) << 2) + (lane & 3)], dk.z, a2);
          a3 = fmaf(st[(k + 3) * KT + ((kc ^ gram_swz(k + 3)) << 2) + (lane & 3)], dk.w, a3);
        }
        const int lc = 4 * (k0 + 8 * s) + lane;
        if (lc < dc) r_s[lc] += (a0 + a1) + (a2 + a3);
      }
      __syncwarp();
      slot ^= 1;
    }
  }
  cp_async_wait_all();
  __syncthreads();
  for (int c = tid; c < dc; c += blockDim.x) r_out[(int64_t)t * d + c0 + c] = r_s[c];
}

}  // namespace sdca
