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
