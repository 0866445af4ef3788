// The deltas of ONE H-block for every task in one launch (the
// `pallas_block` solver backend; one launch per H-block).
//
// Replaces the TPU kernel `sdca_block_kernel` / `_kernel` of
// repro/kernels/sdca/sdca_kernel.py. The TPU version runs a d-tiled grid
// that carries q, xr and G in VMEM scratch from one grid step to the next
// and solves on the last tile. Hopper blocks run in no order, so here a
// thread-block cluster of C CTAs takes one task (cudaLaunchKernelEx with a
// cluster dimension): CTA `rank` owns a slab of about d / C columns.
//   1. It walks its slab in tiles of kTile columns: the B gathered rows and
//      w, r of the tile are copied with 16-byte cp.async (4-byte copies
//      where d * 4 is not a multiple of 16), the next tile in flight while
//      this one is used, and all 256 threads form partial G (the full
//      B x B block; 16 B^2/256 entries a thread, float4 shared loads laid
//      out so a warp's loads are conflict-free), q = X_b w and xr = X_b r
//      with register-tiled fp32 FMAs (TF32 would break the 1e-4 bar).
//   2. cluster.sync; every CTA sums a share of the entries over the C
//      partials in rank order (so the sums do not depend on timing) and
//      stores it into rank 0's shared memory through DSMEM; cluster.sync.
//   3. Warp 0 of rank 0 runs the B-step right-looking recursion of
//      sdca_common.cuh on the summed Gram; a coordinate drawn twice in the
//      block finds its earlier deltas through the equality mask
//      cb == cb[k], as on the TPU.
// The caller gathers the rows before and does the scatter into dalpha and
// r += X_b^T deltas after.
//
// Cluster size: chosen from d by the wrapper (as many CTAs as keep slabs of
// at least 24 columns: C = 4 at d = 100, C = 8 at d = 784), measured at
// both shapes by chip_smoke.py phase 2. What bounds it on this card: the B
// dependent steps of the recursion (a closed-form delta, a shuffle, an
// FMA: 64 steps at 60-100 cycles, 2-3 us) after the slab's Gram (B^2 d / C
// FMAs per CTA).
#include <cooperative_groups.h>

#include "sdca_common.cuh"

namespace cg = cooperative_groups;

namespace sdca {

constexpr int kTile = 32;         // columns of the rows per tile
constexpr int kLd = kTile + 4;    // row stride of a staged tile (16-byte rows)

template <int B>
struct BlockLayout {  // float offsets into the dynamic shared memory
  static constexpr int E = B * B + 2 * B;  // G, q, xr
  static constexpr int xs = 0;             // [2][B][kLd] row tiles
  static constexpr int ws = xs + 2 * B * kLd;  // [2][kTile]
  static constexpr int rs = ws + 2 * kTile;    // [2][kTile]
  static constexpr int part = rs + 2 * kTile;  // [E] this CTA's partials
  static constexpr int sum = part + E;         // [E] the cluster's sums (rank 0)
  static constexpr int at0 = sum + E;          // [B]
  static constexpr int yb = at0 + B;           // [B]
  static constexpr int cb = yb + B;            // [B] ints
  static constexpr int total = cb + B;
};

// tile `tile` of the slab (columns [tile kTile, +kTile) of [0, dc)) into
// buffer buf; columns past dc are zero; one commit group
template <int B>
__device__ __forceinline__ void load_tile(float* dyn, int buf, int tile, const float* xt,
                                          const float* wt, const float* rt, int d, int dc,
                                          bool vec) {
  using LY = BlockLayout<B>;
  float* xs = dyn + LY::xs + buf * B * kLd;
  float* ws = dyn + LY::ws + buf * kTile;
  float* rs = dyn + LY::rs + buf * kTile;
  const int col = tile * kTile, ncols = min(kTile, dc - col);
  if (vec) {  // dc is a multiple of 4
    constexpr int CPR = kTile / 4;
    for (int e = threadIdx.x; e < (B + 2) * CPR; e += kThreads) {
      const int k = e / CPR, c = 4 * (e - k * CPR);
      float* dst = k < B ? xs + k * kLd + c : (k == B ? ws : rs) + c;
      const float* src = k < B ? xt + (int64_t)k * d : (k == B ? wt : rt);
      if (c < ncols)
        cp_async16(dst, src + col + c);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int e = threadIdx.x; e < (B + 2) * kTile; e += kThreads) {
      const int k = e / kTile, c = e - k * kTile;
      float* dst = k < B ? xs + k * kLd + c : (k == B ? ws : rs) + c;
      const float* src = k < B ? xt + (int64_t)k * d : (k == B ? wt : rt);
      if (c < ncols)
        cp_async4(dst, src + col + c);
      else
        *dst = 0.f;
    }
  }
  cp_async_commit();
}

template <int B, int LOSS>
__global__ void __launch_bounds__(kThreads)
block_kernel(const float* __restrict__ xb,     // (m, B, d)
             const float* __restrict__ w,      // (m, d)
             const float* __restrict__ r,      // (m, d)
             const float* __restrict__ at0,    // (m, B)
             const float* __restrict__ y,      // (m, B)
             const int* __restrict__ cb,       // (m, B)
             const float* __restrict__ kappa,  // (m,)
             float* __restrict__ deltas,       // (m, B)
             int d, int dcp, int vec) {
  using LY = BlockLayout<B>;
  constexpr int RT = B / 16;            // Gram rows (and columns) a thread owns
  constexpr int PARTS = kThreads / B;   // threads that share one row's q and xr
  constexpr int CPP = kTile / PARTS;    // columns of a tile per part
  extern __shared__ __align__(16) float dyn[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), C = (int)cluster.num_blocks();
  const int t = blockIdx.y, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c0 = rank * dcp, dc = max(0, min(dcp, d - c0));
  const int n_tiles = (dc + kTile - 1) / kTile;
  const float* xt = xb + (int64_t)t * B * d + c0;
  const float* wt = w + (int64_t)t * d + c0;
  const float* rt = r + (int64_t)t * d + c0;

  if (n_tiles > 0) load_tile<B>(dyn, 0, 0, xt, wt, rt, d, dc, vec);
  if (rank == 0 && tid < B) {
    dyn[LY::at0 + tid] = at0[t * B + tid];
    dyn[LY::yb + tid] = y[t * B + tid];
    reinterpret_cast<int*>(dyn + LY::cb)[tid] = cb[t * B + tid];
  }

  // Gram thread (ti, tj) owns rows ti + 16a, tj + 16b: a warp covers 4 ti
  // and 8 tj, so its float4 loads of a column quad touch 4 and 8 rows
  // whose 16-byte pieces fall in distinct banks (rows kLd = 36 floats apart)
  const int ti = (warp >> 1) * 4 + (lane >> 3), tj = (warp & 1) * 8 + (lane & 7);
  // q / xr thread: row k, columns part + PARTS cc of each tile
  const int qk = tid / PARTS, qp = tid % PARTS;
  float g[RT][RT];
#pragma unroll
  for (int a = 0; a < RT; ++a)
#pragma unroll
    for (int b = 0; b < RT; ++b) g[a][b] = 0.f;
  float qa = 0.f, xa_r = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int buf = tile & 1;
    if (tile + 1 < n_tiles) {
      load_tile<B>(dyn, buf ^ 1, tile + 1, xt, wt, rt, d, dc, vec);
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    const float* X = dyn + LY::xs + buf * B * kLd;
#pragma unroll 2
    for (int c = 0; c < kTile; c += 4) {
      float4 xa[RT], xv[RT];
#pragma unroll
      for (int a = 0; a < RT; ++a) xa[a] = *reinterpret_cast<const float4*>(X + (ti + 16 * a) * kLd + c);
#pragma unroll
      for (int b = 0; b < RT; ++b) xv[b] = *reinterpret_cast<const float4*>(X + (tj + 16 * b) * kLd + c);
#pragma unroll
      for (int a = 0; a < RT; ++a)
#pragma unroll
        for (int b = 0; b < RT; ++b) {
          g[a][b] = fmaf(xa[a].x, xv[b].x, g[a][b]);
          g[a][b] = fmaf(xa[a].y, xv[b].y, g[a][b]);
          g[a][b] = fmaf(xa[a].z, xv[b].z, g[a][b]);
          g[a][b] = fmaf(xa[a].w, xv[b].w, g[a][b]);
        }
    }
    const float* W = dyn + LY::ws + buf * kTile;
    const float* R = dyn + LY::rs + buf * kTile;
#pragma unroll
    for (int cc = 0; cc < CPP; ++cc) {
      const int c = qp + PARTS * cc;
      const float xv = X[qk * kLd + c];
      qa = fmaf(xv, W[c], qa);
      xa_r = fmaf(xv, R[c], xa_r);
    }
    __syncthreads();  // buf is consumed before the next iteration refills it
  }

  float* part = dyn + LY::part;
#pragma unroll
  for (int a = 0; a < RT; ++a)
#pragma unroll
    for (int b = 0; b < RT; ++b) part[(ti + 16 * a) * B + tj + 16 * b] = g[a][b];
#pragma unroll
  for (int off = PARTS / 2; off > 0; off >>= 1) {  // the parts of a row are neighbouring lanes
    qa += __shfl_xor_sync(0xffffffffu, qa, off);
    xa_r += __shfl_xor_sync(0xffffffffu, xa_r, off);
  }
  if (qp == 0) {
    part[B * B + qk] = qa;
    part[B * B + B + qk] = xa_r;
  }
  cluster.sync();

  // every CTA sums a share of the entries over the ranks, in rank order,
  // into rank 0's shared memory
  {
    const int per = (LY::E + C - 1) / C;
    const int e_end = min(LY::E, (rank + 1) * per);
    float* sum0 = cluster.map_shared_rank(dyn + LY::sum, 0);
    for (int e = rank * per + tid; e < e_end; e += kThreads) {
      float v = 0.f;
      for (int q = 0; q < C; ++q) v += cluster.map_shared_rank(part, q)[e];
      sum0[e] = v;
    }
  }
  cluster.sync();  // no CTA reads another's shared memory after this

  if (rank == 0 && warp == 0) {
    const float* G = dyn + LY::sum;
    const float* qs = G + B * B;
    const float* xrs = qs + B;
    const int* cbs = reinterpret_cast<const int*>(dyn + LY::cb);
    const float kap = kappa[t];
    ChainRows<B> rr;
#pragma unroll
    for (int s = 0; s < ChainRows<B>::NR; ++s) {
      const int i = min(lane + 32 * s, B - 1);
      rr.acc[s] = xrs[i];
      rr.q[s] = qs[i];
      rr.at[s] = dyn[LY::at0 + i];
      rr.y[s] = dyn[LY::yb + i];
      rr.inv[s] = recip_of<LOSS>(kap * G[i * B + i]);
      rr.cb[s] = cbs[i];
    }
    right_looking<B, LOSS>(rr, G, cbs, kap);
#pragma unroll
    for (int s = 0; s < ChainRows<B>::NR; ++s)
      if (lane + 32 * s < B) deltas[t * B + lane + 32 * s] = rr.delta[s];
  }
}

// columns of d per CTA of a cluster of C: a multiple of 4, so 16-byte
// copies stay aligned
inline int block_slab(int d, int C) { return ((d + C - 1) / C + 3) / 4 * 4; }

template <int B>
cudaError_t launch_block(const float* xb, const float* w, const float* r, const float* at0,
                         const float* y, const int* cb, const float* kappa, float* deltas,
                         int m, int d, int loss, int C, cudaStream_t stream) {
  const size_t smem = (size_t)BlockLayout<B>::total * sizeof(float);
  auto kern = loss == kHinge     ? block_kernel<B, kHinge>
              : loss == kSquared ? block_kernel<B, kSquared>
                                 : block_kernel<B, kSmoothedHinge>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(xb) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(r) % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, m);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, xb, w, r, at0, y, cb, kappa, deltas, d,
                           block_slab(d, C), vec);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace sdca

// Plain C entry point for ctypes: `cluster` CTAs per task (1, 2, 4 or 8).
// Returns a cudaError_t (0 = launched).
extern "C" int sdca_block_launch(const void* xb, const void* w, const void* r,
                                 const void* at0, const void* y, const void* cb,
                                 const void* kappa, void* deltas, int m, int block, int d,
                                 int loss, int cluster, void* stream) {
  using namespace sdca;
  if (loss < kHinge || loss > kSmoothedHinge || m < 1 || d < 1 ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8))
    return (int)cudaErrorInvalidValue;
#define SDCA_BLOCK_CASE(BB)                                                               \
  case BB:                                                                                \
    return (int)launch_block<BB>((const float*)xb, (const float*)w, (const float*)r,     \
                                 (const float*)at0, (const float*)y, (const int*)cb,      \
                                 (const float*)kappa, (float*)deltas, m, d, loss, cluster, \
                                 (cudaStream_t)stream);
  switch (block) {
    SDCA_BLOCK_CASE(16)
    SDCA_BLOCK_CASE(32)
    SDCA_BLOCK_CASE(64)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SDCA_BLOCK_CASE
}
