// Kernels A and K: nearest posed-SMPL vertex of each query point.
//
// Replaces the TPU kernels arah_tpu/ops/pallas/knn_kernel.py:
// nn_idx_pallas_t (A, body _knn_kernel_t) and nn_idx_pallas (K, body
// _knn_kernel): a running min/argmin of |v|^2 - 2 v.x over vertex tiles,
// ties to the first index. The two compute one function in two TPU
// layouts; here they are one body behind one C entry, arah_knn, and their
// wrappers (ops/knn.py:nn_idx for A, nn_idx_rows for K) differ only in
// their launch counters. (N, 3) points x (V, 3) vertices -> (N,) int32.
//
// Bound on the H100: operations. Every point meets every vertex (N x V
// pairs; the bound column counts 7 flops a pair, 3 products, 2 sums, the
// subtraction and the running minimum, at the FMA-counted f32 peak),
// while the bytes are tiny (12 B in and 4 B out a point, 12 B a vertex).
// The arithmetic stays un-contracted: the expanded form cancels (|v|^2
// and 2 v.x are ~10 where near-tied vertices differ by ~1e-6), and an FMA
// chose another vertex for 0.0025% of points. So each of those 7 is an
// instruction of its own: 7 lane-instructions a pair, ~0.76 ms at
// 524,288 x 6,946 pairs on 132 SMs at ~1.98 GHz, against the bound
// column's 0.38 ms.
//
// Design:
// - Pre-doubled records. A CTA stages its vertices once a launch as
//   float4 records (2x, 2y, 2z, |v|^2) in shared memory (6,946 vertices:
//   111 KB), |v|^2 rounded in the plain version's order. Scaling by 2 is
//   exact, so d = |v|^2 - (px 2x + py 2y + pz 2z), each product and sum
//   rounded on its own, has the bits of |v|^2 - 2 (v.p) without the
//   multiply by 2; ops/knn.py:nn_idx_plain computes the same form.
// - Register-blocked points: a thread holds P points, and one broadcast
//   LDS.128 of a record serves P pairs.
// - Index by chunk: over each chunk of KNN_CHUNK vertices a point keeps
//   only a running fminf (a NaN distance never wins), and notes the chunk
//   when it lowers the point's best strictly. After the scan one rescan of
//   that chunk finds the first vertex whose recomputed distance equals the
//   best. That is the first index of the minimum, as a strict `<` in index
//   order gives, at one FMNMX a pair instead of a compare and two selects.
// - Vertex splits: a CTA's threads form W groups that scan W contiguous
//   ranges of its vertices for the same points, and the C CTAs of a
//   cluster each stage and scan 1/C of them. The partial (min, first
//   index) pairs merge through shared memory, over the cluster through
//   distributed shared memory, an equal distance going to the lower index.
//   This puts the card to work on the plain march's batches of 8,192 and
//   <= 1,024 points.
// - Persistent grid: at most as many CTAs as fit at once, walking the
//   R-point tiles with a grid stride. A CTA whose share of the vertices
//   exceeds its shared memory (VMAX records) stages it in chunks of VMAX
//   once a tile instead, so any V >= 1 works.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define KNN_CHUNK 32          // vertices a running-minimum chunk
#define KNN_SMEM 232448       // dynamic shared memory a CTA may take (B)

// NT threads a CTA, P points a thread, W vertex groups a CTA, C CTAs a
// cluster, MINB CTAs an SM for the register budget.
template <int NT_, int P_, int W_, int C_, int MINB_>
struct KnnShape {
  static constexpr int NT = NT_, P = P_, W = W_, C = C_, MINB = MINB_;
  static constexpr int GT = NT / W;          // threads of a vertex group
  static constexpr int R = GT * P;           // points of a tile
  static constexpr int MERGE = W * C > 1 ? W * R * 8 : 0;   // bytes
  static constexpr int VMAX =                // records a CTA holds
      (KNN_SMEM - MERGE) / 16 / KNN_CHUNK * KNN_CHUNK;
  static_assert(GT % 32 == 0 && GT * W == NT && P >= 1 && KNN_CHUNK == 32,
                "shape");
};

struct KnnArgs {
  const float* pts;
  int n;
  const float* verts;
  int v;
  int* out;
};

// A CTA's share of V vertices on a cluster of c CTAs, in whole chunks.
__host__ __device__ inline int knn_share(int v, int c) {
  return ((v + c - 1) / c + KNN_CHUNK - 1) / KNN_CHUNK * KNN_CHUNK;
}

__device__ __forceinline__ float knn_dist(float px, float py, float pz,
                                          float4 q) {
  const float dot = __fadd_rn(__fadd_rn(__fmul_rn(px, q.x),
                                        __fmul_rn(py, q.y)),
                              __fmul_rn(pz, q.z));
  return __fsub_rn(q.w, dot);
}

template <int C>
__device__ __forceinline__ void knn_sync() {
  if constexpr (C > 1) cg::this_cluster().sync();
  else __syncthreads();
}

// Records sv[0, cnt) of vertices [lo, lo + cnt), then NaN records (they
// never win) up to the next chunk boundary; KNN_FLIGHT vertices a thread
// in flight.
#define KNN_FLIGHT 8
template <int NT>
__device__ void knn_stage(float4* sv, const float* __restrict__ verts,
                          int lo, int cnt) {
  const int padded = (cnt + KNN_CHUNK - 1) / KNN_CHUNK * KNN_CHUNK;
  const float nan = __int_as_float(0x7fc00000);
  for (int k0 = threadIdx.x; k0 < padded; k0 += KNN_FLIGHT * NT) {
    float x[KNN_FLIGHT], y[KNN_FLIGHT], z[KNN_FLIGHT];
#pragma unroll
    for (int b = 0; b < KNN_FLIGHT; ++b) {
      const int k = k0 + b * NT;
      x[b] = y[b] = z[b] = nan;
      if (k < cnt) {
        const float* p = verts + 3 * (long long)(lo + k);
        x[b] = __ldg(p);
        y[b] = __ldg(p + 1);
        z[b] = __ldg(p + 2);
      }
    }
#pragma unroll
    for (int b = 0; b < KNN_FLIGHT; ++b) {
      const int k = k0 + b * NT;
      if (k < padded)
        sv[k] = make_float4(
            __fmul_rn(2.f, x[b]), __fmul_rn(2.f, y[b]), __fmul_rn(2.f, z[b]),
            __fadd_rn(__fadd_rn(__fmul_rn(x[b], x[b]), __fmul_rn(y[b], y[b])),
                      __fmul_rn(z[b], z[b])));
    }
  }
}

template <class S>
__global__ void __launch_bounds__(S::NT, S::MINB)
knn_kernel(const KnnArgs a) {
  constexpr int P = S::P, W = S::W, C = S::C, GT = S::GT, R = S::R;
  extern __shared__ __align__(16) float4 sv[];
  int rank = 0;
  if constexpr (C > 1) rank = (int)cg::this_cluster().block_rank();
  const int j = threadIdx.x, g = j / GT, u = j % GT;
  // this CTA's vertices [lo, lo + cnt); every CTA of a cluster lays out
  // its shared memory alike (rec records, then the merge rows)
  const int vc = knn_share(a.v, C);
  const int lo = min(a.v, rank * vc), cnt = min(a.v - lo, vc);
  const int rec = min(vc, S::VMAX);
  float* s_best = reinterpret_cast<float*>(sv + rec);     // [W][R]
  int* s_idx = reinterpret_cast<int*>(s_best + W * R);    // [W][R]
  const int stages = (cnt + S::VMAX - 1) / S::VMAX;
  const bool resident = stages <= 1;
  if (resident) {
    knn_stage<S::NT>(sv, a.verts, lo, cnt);
    __syncthreads();
  }
  const float inf = __int_as_float(0x7f800000);
  const int tiles = (a.n + R - 1) / R;
  // a cluster's CTAs walk the same tiles (their trip counts agree)
  for (int t = blockIdx.x / C; t < tiles; t += gridDim.x / C) {
    const int base = t * R;
    float px[P], py[P], pz[P], best[P];
    int idx[P], bch[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const long long i = min(base + u + p * GT, a.n - 1);
      px[p] = __ldg(a.pts + 3 * i);
      py[p] = __ldg(a.pts + 3 * i + 1);
      pz[p] = __ldg(a.pts + 3 * i + 2);
      best[p] = inf;
      idx[p] = 0;
      bch[p] = -1;
    }
    for (int s = 0; s < stages; ++s) {
      const int s0 = s * S::VMAX, sc = min(S::VMAX, cnt - s0);
      if (!resident) {
        __syncthreads();
        knn_stage<S::NT>(sv, a.verts, lo + s0, sc);
        __syncthreads();
      }
      // group g scans chunks [g per, (g + 1) per) of the stage, in order
      const int nch = (sc + KNN_CHUNK - 1) / KNN_CHUNK;
      const int per = (nch + W - 1) / W;
      const int c1 = min(nch, (g + 1) * per);
      for (int c = g * per; c < c1; ++c) {
        const float4* q = sv + c * KNN_CHUNK;
        float m[P];
#pragma unroll
        for (int p = 0; p < P; ++p) m[p] = best[p];
#pragma unroll
        for (int k = 0; k < KNN_CHUNK; ++k) {
          const float4 r = q[k];
#pragma unroll
          for (int p = 0; p < P; ++p)
            m[p] = fminf(m[p], knn_dist(px[p], py[p], pz[p], r));
        }
#pragma unroll
        for (int p = 0; p < P; ++p) {
          if (m[p] < best[p]) {
            best[p] = m[p];
            bch[p] = c;
          }
        }
      }
      // the first vertex of the chunk that set the best, at that distance;
      // each lane starts at its own record, so the lanes of a quarter-warp
      // read 8 records on 8 different bank quads (chunks start on a
      // multiple of 512 B: from one record all lanes would conflict)
#pragma unroll
      for (int p = 0; p < P; ++p) {
        if (bch[p] >= 0) {
          const float4* q = sv + bch[p] * KNN_CHUNK;
          int f = KNN_CHUNK;
          for (int k = 0; k < KNN_CHUNK; ++k) {
            const int kk = (k + j) & (KNN_CHUNK - 1);
            if (knn_dist(px[p], py[p], pz[p], q[kk]) == best[p])
              f = min(f, kk);
          }
          idx[p] = lo + s0 + bch[p] * KNN_CHUNK + f;
          bch[p] = -1;
        }
      }
    }
    if constexpr (W * C == 1) {
#pragma unroll
      for (int p = 0; p < P; ++p)
        if (base + u + p * GT < a.n) a.out[base + u + p * GT] = idx[p];
    } else {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        s_best[g * R + u + p * GT] = best[p];
        s_idx[g * R + u + p * GT] = idx[p];
      }
      knn_sync<C>();
      // rank r merges points [r RS, (r + 1) RS) over every group of every
      // CTA: the lower index wins an equal distance, whatever the order
      constexpr int RS = (R + C - 1) / C;
      for (int e = j; e < RS; e += S::NT) {
        const int pt = rank * RS + e;
        if (pt < R && base + pt < a.n) {
          float b = inf;
          int bi = 0;
#pragma unroll
          for (int r = 0; r < C; ++r) {
            const float* rb = s_best;
            const int* ri = s_idx;
            if constexpr (C > 1) {
              rb = cg::this_cluster().map_shared_rank(s_best, r);
              ri = cg::this_cluster().map_shared_rank(s_idx, r);
            }
#pragma unroll
            for (int h = 0; h < W; ++h) {
              const float ob = rb[h * R + pt];
              const int oi = ri[h * R + pt];
              if (ob < b || (ob == b && oi < bi)) {
                b = ob;
                bi = oi;
              }
            }
          }
          a.out[base + pt] = bi;
        }
      }
      knn_sync<C>();
    }
  }
}

// The launch of shape S for n points and v vertices: as many CTAs
// (clusters) as fit on the card at once, at most one a tile. shape (if
// not null): blocks, cluster size, points a tile, dynamic shared memory a
// CTA, CTAs resident an SM.
template <class S>
static int knn_launch(const KnnArgs& a, cudaStream_t stream, int* shape,
                      bool run) {
  if (a.v < 1 || a.n < 0) return (int)cudaErrorInvalidValue;
  const int share = knn_share(a.v, S::C);
  const int rec = share < S::VMAX ? share : S::VMAX;
  const size_t smem = (size_t)rec * 16 + S::MERGE;
  auto kernel = knn_kernel<S>;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.blockDim = dim3(S::NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  if (S::C > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = S::C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  // the attribute and occupancy of this shape, queried again only when
  // the device or the shared memory changes: the tracer's plain loops
  // launch it dozens of times a frame at one V, and a launch captured
  // into a CUDA graph after one at the same V makes no query
  static int q_dev = -1, q_smem = -1, q_cap = 0, q_per_sm = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev != q_dev || (int)smem != q_smem) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      S::NT, smem);
    if (e != cudaSuccess) return (int)e;
    int cap = per_sm * sms;
    if (S::C > 1) {
      cfg.gridDim = dim3(S::C * sms);
      int clusters = 0;
      e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
      if (e != cudaSuccess) return (int)e;
      cap = clusters * S::C;
    }
    q_dev = dev;
    q_smem = (int)smem;
    q_cap = cap;
    q_per_sm = per_sm;
  }
  const int cap = q_cap, per_sm = q_per_sm;
  if (cap <= 0) return (int)cudaErrorInvalidConfiguration;
  const long long want = ((long long)a.n + S::R - 1) / S::R * S::C;
  const int blocks = want < cap ? (int)want : cap;
  cfg.gridDim = dim3(blocks);
  if (shape) {
    shape[0] = blocks;
    shape[1] = S::C;
    shape[2] = S::R;
    shape[3] = (int)smem;
    shape[4] = per_sm;
  }
  if (!run || a.n <= 0) return 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return (int)e;
  return launch_status();
}

// The launch shapes (ops/knn.py:SHAPES; ops/knn.py:launch_shape picks 0,
// 1 or 2 by the number of points; PERF.md gives the sweep that chose
// them): 0 the wide shape, two 256-thread CTAs an SM, each holding every
// vertex; 1 and 2 split the vertices over 8 groups of a CTA and 2 or 4
// CTAs of a cluster, for the plain march's batches.
//                           NT  P  W  C MINB
using KnnShape0 = KnnShape<256, 8, 1, 1, 2>;
using KnnShape1 = KnnShape<256, 4, 8, 2, 2>;
using KnnShape2 = KnnShape<256, 2, 8, 4, 2>;

static int knn_dispatch(int variant, const KnnArgs& a, cudaStream_t st,
                        int* shape, bool run) {
  switch (variant) {
    case 0: return knn_launch<KnnShape0>(a, st, shape, run);
    case 1: return knn_launch<KnnShape1>(a, st, shape, run);
    case 2: return knn_launch<KnnShape2>(a, st, shape, run);
  }
  return (int)cudaErrorInvalidValue;
}

// The launch shape `variant` would take for n points and v vertices:
// blocks, cluster size, points a tile, dynamic shared memory a CTA, CTAs
// an SM (nothing launched).
extern "C" int arah_knn_shape(int variant, int n, int v, int* shape) {
  KnnArgs a = {};
  a.n = n;
  a.v = v;
  return knn_dispatch(variant, a, 0, shape, false);
}

// pts (n, 3), verts (v, 3), out (n,): the first index of each point's
// nearest vertex, at launch shape `variant`.
extern "C" int arah_knn(const float* pts, int n, const float* verts, int v,
                        int variant, int* out, void* stream) {
  if (n <= 0) return 0;
  KnnArgs a = {pts, n, verts, v, out};
  return knn_dispatch(variant, a, (cudaStream_t)stream, nullptr, true);
}
