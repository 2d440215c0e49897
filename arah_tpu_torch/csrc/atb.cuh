// The weight-gradient reduction of the backward kernels H and I:
// C[m][n] += sum over points p of A[p][m] * B[p][n], a product of two
// point-major (P, M) and (P, N) operands over the point axis, with both
// operands rounded to bf16 under `bf` and f32 accumulation.
//
// The points run to the hundreds of thousands and C is at most a few
// hundred square, so the reduction is split over the points: block
// (i, j, s) accumulates tile (i, j) of C over the s-th of `splits`
// contiguous point ranges and writes it to its own slot of `part`;
// atb_sum then adds the slots into C in split order. No float atomics, so
// the sums are the same on every run.
//
// Under bf16 the operands are bf16 values, so the tiles run on the tensor
// cores (nvcuda::wmma, bf16 x bf16 products, f32 accumulators): a 128x128
// tile per block of 8 warps, each warp 32x64 of it as 2x4 16x16
// fragments, 32 points at a time staged in shared memory as bf16. The rows
// come as f32 (I's, rounded when staged) or as bf16 (H's, rounded by the
// tile kernel that wrote them: half the bytes, the same values). In f32
// each of 256 threads accumulates a 4x4 sub-tile of a 64x64 tile with
// FMAs, 32 points at a time staged in shared memory.
#pragma once

#include <mma.h>

#include "common.cuh"

#define ATB_TILE 64            // f32 tile
#define ATB_WTILE 128          // bf16 (tensor-core) tile
#define ATB_K 32               // points staged per step
#define ATB_MAX_SPLITS 128
#define ATB_TARGET_BLOCKS 512

static __global__ void __launch_bounds__(256)
atb_kernel(const float* __restrict__ A, int lda,
           const float* __restrict__ B, int ldb, long long P, int M, int N,
           int splits, float* __restrict__ part) {
  __shared__ __align__(16) float As[ATB_K][ATB_TILE];
  __shared__ __align__(16) float Bs[ATB_K][ATB_TILE];
  const int m0 = blockIdx.x * ATB_TILE, n0 = blockIdx.y * ATB_TILE;
  const long long per = (P + splits - 1) / splits;
  const long long pb = (long long)blockIdx.z * per;
  const long long pe = min(P, pb + per);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (long long p0 = pb; p0 < pe; p0 += ATB_K) {
    for (int e = threadIdx.x; e < ATB_K * ATB_TILE; e += blockDim.x) {
      const int kk = e / ATB_TILE, c = e % ATB_TILE;
      const long long p = p0 + kk;
      const bool in = p < pe;
      As[kk][c] = (in && m0 + c < M) ? A[p * lda + m0 + c] : 0.f;
      Bs[kk][c] = (in && n0 + c < N) ? B[p * ldb + n0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < ATB_K; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = part + (long long)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (m < M && n < N) out[(long long)m * N + n] = acc[i][j];
    }
  }
}

#define ATB_LDS (ATB_WTILE + 8)    // bf16 row stride in shared memory

// Four consecutive operands as two bf16 pairs: f32 rows are rounded to
// nearest here, bf16 rows (already rounded by their writer) are copied.
__device__ __forceinline__ void ld4_bf16(const float* s, __nv_bfloat162* d) {
  const float4 a = *reinterpret_cast<const float4*>(s);
  d[0] = __floats2bfloat162_rn(a.x, a.y);
  d[1] = __floats2bfloat162_rn(a.z, a.w);
}
__device__ __forceinline__ void ld4_bf16(const __nv_bfloat16* s,
                                         __nv_bfloat162* d) {
  const uint2 a = *reinterpret_cast<const uint2*>(s);
  d[0] = *reinterpret_cast<const __nv_bfloat162*>(&a.x);
  d[1] = *reinterpret_cast<const __nv_bfloat162*>(&a.y);
}
__device__ __forceinline__ __nv_bfloat16 to_bf16(float x) {
  return __float2bfloat16_rn(x);
}
__device__ __forceinline__ __nv_bfloat16 to_bf16(__nv_bfloat16 x) {
  return x;
}

// T: the rows' type (float, rounded when staged, or __nv_bfloat16). VEC:
// rows read four operands at a time (lda, ldb, M and N multiples of 4,
// aligned).
template <typename T, bool VEC>
static __global__ void __launch_bounds__(256)
atb_bf16_kernel(const T* __restrict__ A, int lda, const T* __restrict__ B,
                int ldb, long long P, int M, int N, int splits,
                float* __restrict__ part) {
  using namespace nvcuda;
  __shared__ __align__(32) __nv_bfloat16 As[ATB_K][ATB_LDS];
  __shared__ __align__(32) __nv_bfloat16 Bs[ATB_K][ATB_LDS];
  __shared__ __align__(32) float scratch[8][16 * 16];
  const int m0 = blockIdx.x * ATB_WTILE, n0 = blockIdx.y * ATB_WTILE;
  const long long per = (P + splits - 1) / splits;
  const long long pb = (long long)blockIdx.z * per;
  const long long pe = min(P, pb + per);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 64;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  for (long long p0 = pb; p0 < pe; p0 += ATB_K) {
    if (VEC) {
      for (int e = threadIdx.x; e < ATB_K * ATB_WTILE / 4;
           e += blockDim.x) {
        const int kk = e / (ATB_WTILE / 4), c = 4 * (e % (ATB_WTILE / 4));
        const long long p = p0 + kk;
        __nv_bfloat162* ad = reinterpret_cast<__nv_bfloat162*>(&As[kk][c]);
        __nv_bfloat162* bd = reinterpret_cast<__nv_bfloat162*>(&Bs[kk][c]);
        if (p < pe && m0 + c < M) {
          ld4_bf16(A + p * lda + m0 + c, ad);
        } else {
          ad[0] = ad[1] = __halves2bfloat162(zero, zero);
        }
        if (p < pe && n0 + c < N) {
          ld4_bf16(B + p * ldb + n0 + c, bd);
        } else {
          bd[0] = bd[1] = __halves2bfloat162(zero, zero);
        }
      }
    } else {
      for (int e = threadIdx.x; e < ATB_K * ATB_WTILE; e += blockDim.x) {
        const int kk = e / ATB_WTILE, c = e % ATB_WTILE;
        const long long p = p0 + kk;
        const bool in = p < pe;
        As[kk][c] = (in && m0 + c < M) ? to_bf16(A[p * lda + m0 + c]) : zero;
        Bs[kk][c] = (in && n0 + c < N) ? to_bf16(B[p * ldb + n0 + c]) : zero;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < ATB_K; kk += 16) {
      // A^T: element (m, p) of the product's left operand is As[p][m]
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[kk][wm + 16 * i], ATB_LDS);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(b[j], &Bs[kk][wn + 16 * j], ATB_LDS);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = part + (long long)blockIdx.z * M * N;
  float* sc = scratch[warp];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(sc, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int m = m0 + wm + 16 * i + e / 16;
        const int n = n0 + wn + 16 * j + e % 16;
        if (m < M && n < N) out[(long long)m * N + n] = sc[e];
      }
      __syncwarp();
    }
}

// C[m * ldc + n] += sum over splits s, in order, of part[s][m][n].
static __global__ void atb_sum(const float* __restrict__ part, int M, int N,
                               int splits, float* __restrict__ C, int ldc) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= M * N) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[(long long)k * M * N + e];
  C[(long long)(e / N) * ldc + e % N] += s;
}

// The backward kernels' small sums (biases, FiLM vectors, ...) go to
// per-block partials of a fixed grid instead: out[e] += sum over blocks
// b, in block order, of partial[b][e].
static __global__ void sum_partials(const float* __restrict__ partial,
                                    int nb, long long gsize,
                                    float* __restrict__ out) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= gsize) return;
  float s = 0.f;
  for (int b = 0; b < nb; ++b) s += partial[(long long)b * gsize + e];
  out[e] += s;
}

// C (M x N at leading dimension ldc) += A^T B over P points; `part` holds
// ATB_MAX_SPLITS * M * N floats. f32 rows take the tensor cores under `bf`
// (rounded when staged) and the CUDA cores otherwise; bf16 rows always
// take the tensor cores. Returns the launch status.
template <typename T>
static inline int atb_accumulate(const T* A, int lda, const T* B, int ldb,
                                 long long P, int M, int N, bool bf,
                                 float* part, float* C, int ldc,
                                 cudaStream_t stream) {
  if (P <= 0 || M <= 0 || N <= 0) return 0;
  constexpr bool rows_bf16 = sizeof(T) == 2;
  bf = bf || rows_bf16;
  const int t = bf ? ATB_WTILE : ATB_TILE;
  const dim3 tiles((M + t - 1) / t, (N + t - 1) / t);
  int splits = ATB_TARGET_BLOCKS / (int)(tiles.x * tiles.y);
  splits = splits < 1 ? 1 : (splits > ATB_MAX_SPLITS ? ATB_MAX_SPLITS
                                                       : splits);
  const dim3 grid(tiles.x, tiles.y, splits);
  const bool vec = lda % 4 == 0 && ldb % 4 == 0 && M % 4 == 0
                   && N % 4 == 0
                   && (reinterpret_cast<size_t>(A) & (4 * sizeof(T) - 1)) == 0
                   && (reinterpret_cast<size_t>(B) & (4 * sizeof(T) - 1)) == 0;
  if (bf && vec)
    atb_bf16_kernel<T, true><<<grid, 256, 0, stream>>>(A, lda, B, ldb, P, M,
                                                       N, splits, part);
  else if (bf)
    atb_bf16_kernel<T, false><<<grid, 256, 0, stream>>>(A, lda, B, ldb, P,
                                                        M, N, splits, part);
  else if constexpr (!rows_bf16)
    atb_kernel<<<grid, 256, 0, stream>>>(A, lda, B, ldb, P, M, N, splits,
                                         part);
  atb_sum<<<(M * N + 255) / 256, 256, 0, stream>>>(part, M, N, splits, C,
                                                   ldc);
  return (int)cudaGetLastError();
}
