// Stage 2 of the round at large d: chain_stream_kernel.
//
// chain_kernel (sdca_round.cu) keeps every block's gathered rows in shared
// memory over the CTA's slab of d / C columns, double-buffered, so a Hopper
// CTA's 227 KB caps d: at B = 64 it fits d <= 1504 at C = 4 and d <= 3008 at
// C = 8. At the paper's MDS width (d = 10 000) one CTA of a cluster of 8
// would need 682 896 bytes, and even a cluster of 16 single-buffered would
// need 200 144 bytes a CTA, one CTA an SM: 22 tasks x 16 CTAs could not be
// resident at once, and a task whose cluster waits for a free wave waits for
// another task's whole chain.
//
// So this kernel holds no block whole. A cluster of C CTAs per task, each
// owning a slab of dcp columns of r (in shared memory) as chain_kernel does,
// walks the blocks in order. Per block:
//   1. partial xr over the CTA's columns, the block's rows read from global
//      memory (16-byte loads where d allows); the first `hold` columns of
//      each row are also kept in shared memory, as many as the card's
//      shared memory leaves when every task's cluster is resident;
//   2. cluster.sync;
//   3. warp 0 of every CTA sums the C partials and runs the recursion of
//      sdca_common.cuh on rank 0's alpha~, as chain_kernel's step 3, and
//      rank 0 scatters into dalpha; warps 1-7 copy the next block's scratch
//      (G, q, labels, alphas, ids) into the other buffer with cp.async;
//   4. every CTA adds X_b^T deltas to its columns of r: the held columns
//      from shared memory, the rest read again, last-read first, so the
//      second read finds in L2 what the first read left there.
// The partials, alpha~ and the row offsets are double-buffered by block
// parity: one cluster barrier per block orders every exchange, as in
// chain_kernel. fp32 FMAs throughout; only the order of each dot product's
// sum differs from chain_kernel's.
//
// Included by sdca_round.cu after chain_kernel: the stage-1 kernel, the
// scratch layout and the C entry point are the round's own.
#pragma once

namespace sdca {

// float offsets into the dynamic shared memory of one stage-2 CTA
template <int B>
struct StreamSmem {
  int blk, r, xr, at0, dstart, deltas, cbn, rowoff, hold, total;
  __host__ __device__ StreamSmem(int dcp, int hold_cols) {
    blk = 0;                                  // [2][scratch_floats<B>]
    r = blk + 2 * scratch_floats<B>();        // [dcp] this CTA's r
    xr = r + dcp;                             // [2][B] partial xr
    at0 = xr + 2 * B;                         // [2][B] alpha~ (rank 0)
    dstart = at0 + 2 * B;                     // [2][B] dalpha at block start (rank 0)
    deltas = dstart + 2 * B;                  // [B]
    cbn = deltas + B;                         // [B] next block's ids
    rowoff = cbn + B;                         // [2][B] int64 row offsets, in float pairs
    hold = rowoff + 4 * B;                    // [B][hold_cols] held columns of the rows
    total = hold + B * hold_cols;
  }
};

// warps 1-7: the scratch of block bi into buffer buf with cp.async (one
// commit group per thread), the block's ids into cbn and its rows' offsets
// (this CTA's first column included) into rowoff[buf]
template <int B>
__device__ void stream_prefetch(const float* __restrict__ scratch, float* dyn,
                                const StreamSmem<B>& L, int t, int bi, int buf, int n_max,
                                int d, int nbg, int c0) {
  constexpr int SF = scratch_floats<B>();
  constexpr int NP = kThreads - 32;
  const int p = threadIdx.x - 32;
  const float* src = scratch + ((int64_t)t * nbg + bi) * SF;
  if (p < B) {
    const int j = reinterpret_cast<const int*>(src)[B * B + 3 * B + p];
    reinterpret_cast<int*>(dyn + L.cbn)[p] = j;
    reinterpret_cast<int64_t*>(dyn + L.rowoff)[buf * B + p] = ((int64_t)t * n_max + j) * d + c0;
  }
  float* blk = dyn + L.blk + buf * SF;
  for (int e = p; e < SF / 4; e += NP) cp_async16(blk + 4 * e, src + 4 * e);
  cp_async_commit();
}

// rank 0, thread k < B: alpha~ and dalpha at block start of row k of block
// bi into buffer buf (chain_kernel's alpha_tilde on this layout)
template <int B>
__device__ __forceinline__ void stream_alpha_tilde(float* dyn, const StreamSmem<B>& L,
                                                   const float* __restrict__ scratch,
                                                   const float* dat, int t, int bi, int nbg,
                                                   int buf) {
  const int k = threadIdx.x;
  const float dst = dat[reinterpret_cast<const int*>(dyn + L.cbn)[k]];
  const float al = scratch[((int64_t)t * nbg + bi) * scratch_floats<B>() + B * B + 2 * B + k];
  dyn[L.at0 + buf * B + k] = al + dst;
  dyn[L.dstart + buf * B + k] = dst;
}

__device__ __forceinline__ float dot4(const float4 a, const float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float4 axpy4(const float4 xv, float s, float4 a) {
  return make_float4(fmaf(xv.x, s, a.x), fmaf(xv.y, s, a.y), fmaf(xv.z, s, a.z),
                     fmaf(xv.w, s, a.w));
}

template <int B, int LOSS>
__global__ void __launch_bounds__(kThreads, 3)
chain_stream_kernel(const float* __restrict__ x,        // (m, n_max, d)
                    const float* __restrict__ scratch,  // (m, nbg, scratch_floats<B>)
                    const float* __restrict__ kappa,    // (m,)
                    float* __restrict__ dalpha,         // (m, n_max)
                    float* __restrict__ r_out,          // (m, d): r in, r out
                    int n_max, int d, int nbg, int dcp, int hold, int vec) {
  constexpr int SF = scratch_floats<B>();
  constexpr int NR = ChainRows<B>::NR;
  constexpr int RPW = B / 8;  // xr rows per warp
  extern __shared__ __align__(16) float dyn[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), C = (int)cluster.num_blocks();
  const StreamSmem<B> L(dcp, hold);
  const int t = blockIdx.y, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c0 = rank * dcp, dc = max(0, min(dcp, d - c0));
  const int hc = min(hold, dc);  // held columns of this CTA
  const float kap = kappa[t];
  float* r_s = dyn + L.r;
  float* held = dyn + L.hold;
  float* deltas = dyn + L.deltas;
  float* dat = dalpha + (int64_t)t * n_max;
  const int64_t* rowoff_s = reinterpret_cast<const int64_t*>(dyn + L.rowoff);

  for (int c = tid; c < dc; c += kThreads) r_s[c] = r_out[(int64_t)t * d + c0 + c];
  if (warp != 0) stream_prefetch<B>(scratch, dyn, L, t, 0, 0, n_max, d, nbg, c0);
  cp_async_wait_all();
  __syncthreads();
  if (rank == 0 && tid < B) stream_alpha_tilde<B>(dyn, L, scratch, dat, t, 0, nbg, 0);

  for (int bi = 0; bi < nbg; ++bi) {
    const int buf = bi & 1;
    const float* blk = dyn + L.blk + buf * SF;
    const float* G = blk;
    const int* cb = reinterpret_cast<const int*>(blk + B * B + 3 * B);
    const int64_t* rowoff = rowoff_s + buf * B;

    // 1. partial xr over this CTA's columns: warp w owns rows w + 8i, the
    // first hc columns kept in shared memory on the way
    {
      float acc[RPW];
      const float* rp[RPW];
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        acc[i] = 0.f;
        rp[i] = x + rowoff[warp + 8 * i];
      }
      if (vec) {
        for (int c = 4 * lane; c < hc; c += 128) {
          const float4 rv = *reinterpret_cast<const float4*>(r_s + c);
#pragma unroll
          for (int i = 0; i < RPW; ++i) {
            const float4 xv = __ldg(reinterpret_cast<const float4*>(rp[i] + c));
            *reinterpret_cast<float4*>(held + (warp + 8 * i) * hold + c) = xv;
            acc[i] = dot4(xv, rv, acc[i]);
          }
        }
        for (int c = hc + 4 * lane; c < dc; c += 128) {
          const float4 rv = *reinterpret_cast<const float4*>(r_s + c);
#pragma unroll
          for (int i = 0; i < RPW; ++i)
            acc[i] = dot4(__ldg(reinterpret_cast<const float4*>(rp[i] + c)), rv, acc[i]);
        }
      } else {
        for (int c = lane; c < hc; c += 32) {
          const float rv = r_s[c];
#pragma unroll
          for (int i = 0; i < RPW; ++i) {
            const float xv = __ldg(rp[i] + c);
            held[(warp + 8 * i) * hold + c] = xv;
            acc[i] = fmaf(xv, rv, acc[i]);
          }
        }
        for (int c = hc + lane; c < dc; c += 32) {
          const float rv = r_s[c];
#pragma unroll
          for (int i = 0; i < RPW; ++i) acc[i] = fmaf(__ldg(rp[i] + c), rv, acc[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float s = warp_sum(acc[i]);
        if (lane == 0) dyn[L.xr + buf * B + warp + 8 * i] = s;
      }
    }
    cluster.sync();

    if (warp == 0) {
      // 3. the recursion, on every CTA of the cluster (chain_kernel's step 3)
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
      if (rank == 0) {
#pragma unroll
        for (int s = 0; s < NR; ++s)
          if (rr.first[s]) dat[rr.cb[s]] = dyn[L.dstart + buf * B + lane + 32 * s] + rr.dup[s];
      }
    } else if (bi + 1 < nbg) {
      stream_prefetch<B>(scratch, dyn, L, t, bi + 1, buf ^ 1, n_max, d, nbg, c0);
    }
    __syncthreads();

    if (rank == 0 && tid < B && bi + 1 < nbg)
      stream_alpha_tilde<B>(dyn, L, scratch, dat, t, bi + 1, nbg, buf ^ 1);
    // 4. r += X_b^T deltas over this CTA's columns: held columns from shared
    // memory, then the others read again, the last-read ones first
    if (vec) {
      const int n4 = dc / 4, h4 = hc / 4;
      for (int g = tid; g < h4; g += kThreads) {
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
        for (int k = 0; k < B; ++k)
          a = axpy4(*reinterpret_cast<const float4*>(held + k * hold + 4 * g), deltas[k], a);
        float4* rv = reinterpret_cast<float4*>(r_s + 4 * g);
        const float4 o = *rv;
        *rv = make_float4(o.x + a.x, o.y + a.y, o.z + a.z, o.w + a.w);
      }
      for (int g = n4 - 1 - tid; g >= h4; g -= kThreads) {
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
        for (int k = 0; k < B; ++k)
          a = axpy4(__ldg(reinterpret_cast<const float4*>(x + rowoff[k] + 4 * g)), deltas[k], a);
        float4* rv = reinterpret_cast<float4*>(r_s + 4 * g);
        const float4 o = *rv;
        *rv = make_float4(o.x + a.x, o.y + a.y, o.z + a.z, o.w + a.w);
      }
    } else {
      for (int c = tid; c < hc; c += kThreads) {
        float a = 0.f;
#pragma unroll 8
        for (int k = 0; k < B; ++k) a = fmaf(held[k * hold + c], deltas[k], a);
        r_s[c] += a;
      }
      for (int c = dc - 1 - tid; c >= hc; c -= kThreads) {
        float a = 0.f;
#pragma unroll 8
        for (int k = 0; k < B; ++k) a = fmaf(__ldg(x + rowoff[k] + c), deltas[k], a);
        r_s[c] += a;
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }
  for (int c = tid; c < dc; c += kThreads) r_out[(int64_t)t * d + c0 + c] = r_s[c];
  cluster.sync();  // no CTA leaves while another may read its shared memory
}

}  // namespace sdca
