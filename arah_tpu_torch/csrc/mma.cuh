// The tile products of kernels C (shade.cu), H (shade_bwd.cu), D and I
// (color.cu): a tile of points' rows, f32 in shared memory, times a weight
// matrix, for 256 threads (8 warps).
//
// Under bf16_shading every operand of these products is already a bf16
// value (rounded where the plain versions round it), so they run on the
// tensor cores (prod_mma: mma.sync m16n8k16, bf16 x bf16 -> f32) and
// compute the same products as f32 FMAs would, summed in another order.
// The f32 launches take prod_fma on the CUDA cores (never TF32).
#pragma once

#include "common.cuh"

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// out[p][n] = (out[p][n] if add, else 0) + sum over k < K of in[p][k]
// M[n][k], for the MT x 16 points p of the tile and n < N, on the tensor
// cores. M: bf16, row-major (N, K), K a multiple of 32, N of 8; `in` holds
// bf16 values in f32 rows of stride ldi, `out` rows of stride ldo (both
// multiples of 4, 16-byte aligned); `out` may be `in` (every read is done
// before the first write). Warp w owns units [32w, 32w + 32): MT x 4
// fragments of 16 points x 8 units. Per chunk of 32 k, lane (g, t) loads 8
// consecutive k of unit row g of each fragment (16 B, straight from L2,
// the next chunk in flight while the current one multiplies) and of its
// two point rows; the k order inside the chunk is permuted alike for both
// operands (slots 2t, 2t+1, 2t+8, 2t+9 of step s take k 8t + 4s + 0..3),
// which only reorders the sum. Each weight a warp loads feeds 16 MT
// points; a weight is used by one warp only, so it is not staged.
template <int MT>
__device__ void prod_mma(const float* in, int ldi, int K,
                         const __nv_bfloat16* M, int N, float* out, int ldo,
                         bool add) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = warp * 32;
  const bool on = n0 < N;
  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  if (on) {
    uint4 b[4], bn[4];
    auto load_b = [&](int k0, uint4 (&dst)[4]) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int nr = n0 + 8 * nt + g;
        dst[nt] = nr < N ? __ldg(reinterpret_cast<const uint4*>(
                               M + (long long)nr * K + k0 + 8 * t))
                         : make_uint4(0u, 0u, 0u, 0u);
      }
    };
    load_b(0, b);
    for (int k0 = 0; k0 < K; k0 += 32) {
      if (k0 + 32 < K) load_b(k0 + 32, bn);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float* r0 = in + (16 * mt + g) * ldi + k0 + 8 * t;
        const float* r1 = r0 + 8 * ldi;
        const float4 x0 = *reinterpret_cast<const float4*>(r0);
        const float4 x1 = *reinterpret_cast<const float4*>(r0 + 4);
        const float4 y0 = *reinterpret_cast<const float4*>(r1);
        const float4 y1 = *reinterpret_cast<const float4*>(r1 + 4);
        const unsigned a0[4] = {pack_bf16(x0.x, x0.y), pack_bf16(y0.x, y0.y),
                                pack_bf16(x0.z, x0.w), pack_bf16(y0.z, y0.w)};
        const unsigned a1[4] = {pack_bf16(x1.x, x1.y), pack_bf16(y1.x, y1.y),
                                pack_bf16(x1.z, x1.w), pack_bf16(y1.z, y1.w)};
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          mma_bf16(acc[mt][nt], a0, b[nt].x, b[nt].y);
          mma_bf16(acc[mt][nt], a1, b[nt].z, b[nt].w);
        }
      }
      if (k0 + 32 < K) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) b[nt] = bn[nt];
      }
    }
  }
  __syncthreads();                     // every read of the rows is done
  if (on) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int nc = n0 + 8 * nt + 2 * t;
        if (nc < N) {                  // N % 8 == 0: nc + 1 < N too
          float* r = out + (16 * mt + g) * ldo + nc;
          float2 lo = make_float2(acc[mt][nt][0], acc[mt][nt][1]);
          float2 hi = make_float2(acc[mt][nt][2], acc[mt][nt][3]);
          if (add) {
            const float2 l0 = *reinterpret_cast<const float2*>(r);
            const float2 h0 = *reinterpret_cast<const float2*>(r + 8 * ldo);
            lo = make_float2(l0.x + lo.x, l0.y + lo.y);
            hi = make_float2(h0.x + hi.x, h0.y + hi.y);
          }
          *reinterpret_cast<float2*>(r) = lo;
          *reinterpret_cast<float2*>(r + 8 * ldo) = hi;
        }
      }
  }
  __syncthreads();
}

// rows[p][n] <- sum over k < K of rows[p][k] W[k * ldw + n], for the NP
// points p of the tile and n < N, on the CUDA cores: thread n owns unit
// n, and each weight it loads from L2 (coalesced over n) feeds NP points.
template <int NP>
__device__ void prod_fma(float* rows, int ld, int K,
                         const float* __restrict__ W, int ldw, int N) {
  const int j = threadIdx.x;
  float acc[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p) acc[p] = 0.f;
  if (j < N) {
    if ((K & 3) == 0) {
      for (int k = 0; k < K; k += 4) {
        const float w0 = __ldg(W + (long long)k * ldw + j);
        const float w1 = __ldg(W + (long long)(k + 1) * ldw + j);
        const float w2 = __ldg(W + (long long)(k + 2) * ldw + j);
        const float w3 = __ldg(W + (long long)(k + 3) * ldw + j);
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const float4 v =
              *reinterpret_cast<const float4*>(rows + p * ld + k);
          float a = acc[p];
          a = fmaf(v.x, w0, a);
          a = fmaf(v.y, w1, a);
          a = fmaf(v.z, w2, a);
          a = fmaf(v.w, w3, a);
          acc[p] = a;
        }
      }
    } else {
      for (int k = 0; k < K; ++k) {
        const float w = __ldg(W + (long long)k * ldw + j);
#pragma unroll
        for (int p = 0; p < NP; ++p)
          acc[p] = fmaf(rows[p * ld + k], w, acc[p]);
      }
    }
  }
  __syncthreads();                     // every read of the rows is done
  if (j < N) {
#pragma unroll
    for (int p = 0; p < NP; ++p) rows[p * ld + j] = acc[p];
  }
  __syncthreads();
}

// dx[p][c] = sum over k < K of rows[p][k] W[k * din + c], c < din <= 4,
// for a tile of NP points (rows of stride ld) on 256 threads: 256 / NP
// lanes per point, each a strided share of k, then a shuffle sum. Rows of
// padded points (p0 + p >= n) are not written.
template <int NP>
__device__ void dx_rows(const float* rows, int ld, int K,
                        const float* __restrict__ W, int din, int p0, int n,
                        float* __restrict__ dx_g) {
  constexpr int LN = 256 / NP;
  static_assert(NP * LN == 256 && LN >= 4 && LN <= 32, "dx_rows lanes");
  const int p = threadIdx.x / LN, l = threadIdx.x % LN;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k = l; k < K; k += LN) {
    const float r = rows[p * ld + k];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (c < din)
        acc[c] = fmaf(r, __ldg(W + (long long)k * din + c), acc[c]);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int o = LN / 2; o > 0; o >>= 1)
      acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], o, LN);
  if (l < din && p0 + p < n)
    dx_g[(long long)(p0 + p) * din + l] =
        l == 0 ? acc[0] : (l == 1 ? acc[1] : (l == 2 ? acc[2] : acc[3]));
}
