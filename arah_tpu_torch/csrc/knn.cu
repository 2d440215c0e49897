// Kernel A: nearest posed-SMPL vertex of each query point.
//
// Replaces the TPU kernel arah_tpu/ops/pallas/knn_kernel.py:nn_idx_pallas_t
// (body _knn_kernel_t): a running min/argmin of |v|^2 - 2 v.x over vertex
// tiles, ties to the first index.
//
// Bound on the H100: operations. Every point meets every vertex
// (N x V pairs, 8 flops each: the 3 products and 2 sums of v.x, the
// scale by 2, the subtract, the compare), while the bytes are tiny (12 B
// in and 4 B out per point, 12 B per vertex).
//
// Design: one thread per point, the point in registers. The block streams
// the vertices through shared memory in tiles of 2048 float4 records
// (x, y, z, |v|^2; 32 KB), so each vertex is read from device memory once
// per block and every thread of a warp reads the same record (a shared
// memory broadcast). The same expanded form as the JAX path with a strict
// `<` keeps the first index on ties. The expanded form cancels (|v|^2 and
// 2 v.x are ~10 where near-tied vertices differ by ~1e-6), so every
// product and sum is rounded on its own (__fmul_rn/__fadd_rn, no FMA
// contraction) in the order of the plain version (ops/knn.py:
// nn_idx_plain), and the two choose the same vertex. Any N and V work:
// the last block and the last tile are masked.
#include "common.cuh"

#define KNN_THREADS 256
#define KNN_TILE 2048

__global__ void __launch_bounds__(KNN_THREADS)
knn_kernel(const float* __restrict__ pts, int n,
           const float* __restrict__ verts, int v, int* __restrict__ out) {
  __shared__ float4 sv[KNN_TILE];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float px = 0.f, py = 0.f, pz = 0.f;
  if (i < n) {
    px = pts[3 * i];
    py = pts[3 * i + 1];
    pz = pts[3 * i + 2];
  }
  float best = 1e30f;
  int best_idx = 0;
  for (int base = 0; base < v; base += KNN_TILE) {
    const int cnt = min(KNN_TILE, v - base);
    __syncthreads();
    for (int k = threadIdx.x; k < cnt; k += blockDim.x) {
      const float x = verts[3 * (base + k)];
      const float y = verts[3 * (base + k) + 1];
      const float z = verts[3 * (base + k) + 2];
      sv[k] = make_float4(
          x, y, z,
          __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                    __fmul_rn(z, z)));
    }
    __syncthreads();
    for (int k = 0; k < cnt; ++k) {
      const float4 q = sv[k];
      const float dot = __fadd_rn(__fadd_rn(__fmul_rn(px, q.x),
                                            __fmul_rn(py, q.y)),
                                  __fmul_rn(pz, q.z));
      const float d = __fsub_rn(q.w, __fmul_rn(2.0f, dot));
      if (d < best) {
        best = d;
        best_idx = base + k;
      }
    }
  }
  if (i < n) out[i] = best_idx;
}

extern "C" int arah_knn(const float* pts, int n, const float* verts, int v,
                        int* out, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + KNN_THREADS - 1) / KNN_THREADS;
  knn_kernel<<<blocks, KNN_THREADS, 0, (cudaStream_t)stream>>>(
      pts, n, verts, v, out);
  return launch_status();
}

// Kernel K: the same query in the row layout.
//
// Replaces the TPU kernel arah_tpu/ops/pallas/knn_kernel.py:nn_idx_pallas
// (body _knn_kernel), whose (T, Vt) distance tiles reduce along the vertex
// axis. Same function, rounding and tie rule as kernel A above, and the
// same bound (8 flops per point-vertex pair).
//
// Design: the vertex axis is reduced across lanes. A warp owns
// KR_PPW points (in registers); its 32 lanes walk the shared-memory vertex
// tile with a stride of 32, each keeping a running (min, first index) per
// point, then a shuffle reduction merges the lanes, an equal distance
// keeping the lower index, so the first index of the minimum wins as in
// the plain version. Each float4 vertex record a lane reads serves KR_PPW
// points. At the march's 8,192 points this gives 2,048 warps where A's
// one thread per point gives 256.
#define KR_THREADS 256
#define KR_PPW 4

__global__ void __launch_bounds__(KR_THREADS)
knn_rows_kernel(const float* __restrict__ pts, int n,
                const float* __restrict__ verts, int v,
                int* __restrict__ out) {
  __shared__ float4 sv[KNN_TILE];
  const int lane = threadIdx.x & 31;
  const int p0 = (blockIdx.x * (KR_THREADS / 32) + (threadIdx.x >> 5))
                 * KR_PPW;
  float px[KR_PPW], py[KR_PPW], pz[KR_PPW], best[KR_PPW];
  int bidx[KR_PPW];
#pragma unroll
  for (int p = 0; p < KR_PPW; ++p) {
    const int i = min(p0 + p, n - 1);
    px[p] = pts[3 * i];
    py[p] = pts[3 * i + 1];
    pz[p] = pts[3 * i + 2];
    best[p] = __int_as_float(0x7f800000);   // +inf
    bidx[p] = 0;
  }
  for (int base = 0; base < v; base += KNN_TILE) {
    const int cnt = min(KNN_TILE, v - base);
    __syncthreads();
    for (int k = threadIdx.x; k < cnt; k += blockDim.x) {
      const float x = verts[3 * (base + k)];
      const float y = verts[3 * (base + k) + 1];
      const float z = verts[3 * (base + k) + 2];
      sv[k] = make_float4(
          x, y, z,
          __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                    __fmul_rn(z, z)));
    }
    __syncthreads();
    for (int k = lane; k < cnt; k += 32) {
      const float4 q = sv[k];
#pragma unroll
      for (int p = 0; p < KR_PPW; ++p) {
        const float dot = __fadd_rn(__fadd_rn(__fmul_rn(px[p], q.x),
                                              __fmul_rn(py[p], q.y)),
                                    __fmul_rn(pz[p], q.z));
        const float d = __fsub_rn(q.w, __fmul_rn(2.0f, dot));
        if (d < best[p]) {
          best[p] = d;
          bidx[p] = base + k;
        }
      }
    }
  }
#pragma unroll
  for (int p = 0; p < KR_PPW; ++p) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best[p], o);
      const int oi = __shfl_xor_sync(0xffffffffu, bidx[p], o);
      if (ob < best[p] || (ob == best[p] && oi < bidx[p])) {
        best[p] = ob;
        bidx[p] = oi;
      }
    }
    if (lane == 0 && p0 + p < n) out[p0 + p] = bidx[p];
  }
}

extern "C" int arah_knn_rows(const float* pts, int n, const float* verts,
                             int v, int* out, void* stream) {
  if (n <= 0) return 0;
  const int per_block = (KR_THREADS / 32) * KR_PPW;
  const int blocks = (n + per_block - 1) / per_block;
  knn_rows_kernel<<<blocks, KR_THREADS, 0, (cudaStream_t)stream>>>(
      pts, n, verts, v, out);
  return launch_status();
}
