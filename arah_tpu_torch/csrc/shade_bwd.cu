// Kernel H: the backward of the shading kernel C (the training step's
// differentiable (sdf, features, normal) of the generated SIREN).
//
// Replaces the TPU kernel arah_tpu/ops/pallas/shade_grad_kernel.py:
// _shade_bwd_pallas (body _shade_bwd_kernel). Per point, with cotangents
// (g_out, g_feat, g_n) of (sdf, features, normal = d sdf / dx):
//   1. recompute the primal chain z_i = W_i h_i + b_i, u_i = f_i z_i + p_i,
//      h_{i+1} = sin(30 u_i), keeping z_i;
//   2. recompute the reverse normal chain g_{L-1} = W_{L-1}[0],
//      a_i = g_{i+1} o 30 f_i cos(30 u_i), g_i = W_i^T a_i, keeping g_{i+1};
//   3. the adjoint of that chain, a forward sweep seeded with t_0 = g_n:
//      abar = W_i t_i, dW_i += a_i (x) t_i, cbar = g_{i+1} o abar,
//      dfreq_i += 30 cos o cbar, ubar_c = -900 f h_{i+1} o cbar,
//      t_{i+1} = 30 f cos o abar;
//   4. the output layer: dW_{L-1} += g_out (x) h_{L-1} (+ sum t_{L-1} on
//      row 0), db_{L-1} += g_out, hbar = W_{L-1}^T g_out + g_feat;
//   5. the primal backward with the second-order term ubar_c:
//      ubar = 30 cos o hbar + ubar_c, dfreq += z o ubar, dphase += ubar,
//      zbar = f ubar, dW_i += zbar (x) h_i, db_i += zbar, hbar = W_i^T zbar;
//      dx = hbar.
// Under bf16_shading every product's operands are rounded to bf16 at the
// places _shade_bwd_kernel rounds them (_dot, _dot_nt) and accumulated in
// f32; chain values and residents stay f32 (shade_resid_bf16 off).
//
// Bound on the H100: operations. A point costs ~2.9x C's multiply-adds:
// the forward and reverse chains again, the adjoint and primal-backward
// sweeps, and the two rank-1 weight-gradient terms of every hidden layer.
//
// Design. A block of 256 threads owns a tile of SB_TILE = 32 points and
// walks its share of the tiles in a fixed order (a persistent grid of as
// many blocks as fit on the card at once).
// - The chain products. Each hidden (H x H) layer takes four per point
//   (steps 1, 2, 3, 5). Under bf16 their operands are bf16 values, so they
//   run on the tensor cores (prod_mma: mma.sync m16n8k16, bf16 x bf16 ->
//   f32): warp w owns output units [32w, 32w + 32) of all 32 points, loads
//   its weight fragments straight from a bf16 copy of the weights in L2
//   (16 B a lane, the next k-chunk in flight while the current one
//   multiplies), so each weight it loads feeds 32 points. The f32 launch
//   (the eikonal points) runs the same body with FMA products on the CUDA
//   cores (prod_fma; never TF32). The din-wide products (the first layer,
//   dx) run on the CUDA cores in both.
// - The tile's rows. One f32 [point][unit] tile in shared memory holds the
//   current product's input; a product reads it, synchronises and writes
//   its result in place, and each thread then does the per-unit algebra of
//   its own unit j over the 32 points. Every row is rounded when written
//   under bf16, so the tensor cores' bf16 operands are exact.
// - The residents. Only z_i and g_{i+1} (overwritten by ubar_c_i) are kept
//   per point, unit and sine layer, in a per-block scratch that the block
//   reuses tile after tile; u, sin(30 u) and cos(30 u) are recomputed from
//   z by one expression (unit_sc), so every recomputation has the primal
//   chain's bits.
// - The hidden layers' weight gradients: dW_i sums a_i (x) t_i + zbar_i
//   (x) h_i over all points. Float atomics across blocks would change from
//   run to run, so the kernel writes each point's four operand rows to a
//   workspace (a and zbar as the rows of A_i, t and h as the rows of B_i)
//   and atb.cuh reduces A_i^T B_i over the points, split over point ranges
//   and summed in split order. Under bf16 the rows are stored as bf16
//   (each is rounded before it is written: the same values, half the
//   bytes). The points run in chunks of SB_CHUNK. The vectors (db, dfreq,
//   dphase) and the output layer's gradients, a few thousand floats, go to
//   per-block partials, summed over the blocks in block order by
//   sum_partials. Every sum is the same on every run. Padded points have
//   zero cotangents and zero a rows, are never written to the workspace,
//   and contribute exactly zero.
#include "atb.cuh"
#include "shade_meta.cuh"

#define SB_THREADS 256
#define SB_TILE 32                 // points per tile
#define SB_LD (256 + 4)            // row stride of the tile (floats)
#define SB_CHUNK 65536             // points per workspace pass
#define SB_PF 4                    // residents loaded ahead, per thread

static_assert(SB_TILE * 8 == SB_THREADS, "dx_rows: 8 lanes per point");
static_assert(SB_TILE == 32, "prod_mma: two 16-point fragments per warp");
static_assert(SB_TILE % SB_PF == 0, "whole groups of residents");

template <bool BF> struct WsRow { using T = float; };
template <> struct WsRow<true> { using T = __nv_bfloat16; };

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Element offsets of one chunk's workspace rows, per sine layer i: A_i
// (2 nc, H) = [a_i rows; zbar_i rows], B_i (2 nc, K_i) = [t_i rows; h_i
// rows], K_0 = din, K_i = H.
struct ShadeWs {
  long long a[MAX_LAYERS], b[MAX_LAYERS];
};

// u = f z + ph and (sin, cos)(30 u) of one unit: the primal chain's values,
// bit for bit wherever they are recomputed from z.
__device__ __forceinline__ void unit_sc(float z, float f, float ph,
                                        bool film, float& s, float& c) {
  const float u = film ? __fadd_rn(__fmul_rn(f, z), ph) : z;
  sincosf(__fmul_rn(30.f, u), &s, &c);
}

// rows[p][n] <- sum over k < K of rows[p][k] W[k * ldw + n], n < N, on the
// CUDA cores: thread n owns unit n, and each weight it loads from L2
// (coalesced over n) feeds the tile's 32 points.
__device__ void prod_fma(float* rows, int K, const float* __restrict__ W,
                         int ldw, int N) {
  const int j = threadIdx.x;
  float acc[SB_TILE];
#pragma unroll
  for (int p = 0; p < SB_TILE; ++p) acc[p] = 0.f;
  if (j < N) {
    if ((K & 3) == 0) {
      for (int k = 0; k < K; k += 4) {
        const float w0 = __ldg(W + (long long)k * ldw + j);
        const float w1 = __ldg(W + (long long)(k + 1) * ldw + j);
        const float w2 = __ldg(W + (long long)(k + 2) * ldw + j);
        const float w3 = __ldg(W + (long long)(k + 3) * ldw + j);
#pragma unroll
        for (int p = 0; p < SB_TILE; ++p) {
          const float4 v =
              *reinterpret_cast<const float4*>(rows + p * SB_LD + k);
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
        for (int p = 0; p < SB_TILE; ++p)
          acc[p] = fmaf(rows[p * SB_LD + k], w, acc[p]);
      }
    }
  }
  __syncthreads();                     // every read of the rows is done
  if (j < N) {
#pragma unroll
    for (int p = 0; p < SB_TILE; ++p) rows[p * SB_LD + j] = acc[p];
  }
  __syncthreads();
}

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

// rows[p][n] <- sum over k < K of rows[p][k] M[n][k], n < N, on the tensor
// cores. M: bf16, row-major (N, K), K a multiple of 32; the rows hold bf16
// values in f32. Warp w owns units [32w, 32w + 32): 2 x 4 fragments of
// 16 points x 8 units. Per chunk of 32 k, lane (g, t) loads 8 consecutive
// k of unit row g of each fragment (16 B) and of its two point rows; the
// k order inside the chunk is permuted alike for both operands (slots
// 2t, 2t+1, 2t+8, 2t+9 of step s take k 8t + 4s + 0..3), which only
// reorders the sum.
__device__ void prod_mma(float* rows, int K, const __nv_bfloat16* M, int N) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = warp * 32;
  const bool on = n0 < N;
  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
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
      for (int mt = 0; mt < 2; ++mt) {
        const float* r0 = rows + (16 * mt + g) * SB_LD + k0 + 8 * t;
        const float* r1 = r0 + 8 * SB_LD;
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
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int nc = n0 + 8 * nt + 2 * t;
        if (nc < N) {                  // N % 8 == 0: nc + 1 < N too
          float* r = rows + (16 * mt + g) * SB_LD + nc;
          *reinterpret_cast<float2*>(r) =
              make_float2(acc[mt][nt][0], acc[mt][nt][1]);
          *reinterpret_cast<float2*>(r + 8 * SB_LD) =
              make_float2(acc[mt][nt][2], acc[mt][nt][3]);
        }
      }
  }
  __syncthreads();
}

// dx[p][c] = sum over k < K of rows[p][k] W[k * din + c], c < din <= 4:
// 8 lanes per point, each a strided share of k, then a shuffle sum.
__device__ void dx_rows(const float* rows, int K, const float* __restrict__ W,
                        int din, int p0, int n, float* __restrict__ dx_g) {
  const int p = threadIdx.x >> 3, l = threadIdx.x & 7;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k = l; k < K; k += 8) {
    const float r = rows[p * SB_LD + k];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (c < din)
        acc[c] = fmaf(r, __ldg(W + (long long)k * din + c), acc[c]);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int o = 4; o > 0; o >>= 1)
      acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], o, 8);
  if (l < din && p0 + p < n)
    dx_g[(long long)(p0 + p) * din + l] =
        l == 0 ? acc[0] : (l == 1 ? acc[1] : (l == 2 ? acc[2] : acc[3]));
}

// BF: the bf16_shading launch (tensor-core products, bf16 workspace rows);
// otherwise f32 throughout.
template <bool BF>
__global__ void __launch_bounds__(SB_THREADS, 2)
shade_bwd_kernel(const float* __restrict__ x_g, int n,
                 const float* __restrict__ P,
                 const __nv_bfloat16* __restrict__ Wb, ShadeMeta m,
                 const float* __restrict__ gout_g,
                 const float* __restrict__ gfeat_g,
                 const float* __restrict__ gn_g, float* __restrict__ dx_g,
                 float* __restrict__ partial, ShadeMeta gm, long long gsize,
                 typename WsRow<BF>::T* __restrict__ ws, ShadeWs lay,
                 float* __restrict__ scratch) {
  __shared__ __align__(16) float rows[SB_TILE * SB_LD];
  __shared__ float gos[SB_TILE * 16];
  const int H = m.hidden, L = m.n_layers, din = m.din, dout = m.dout;
  const int NL = L - 1;                        // sine layers
  const bool film = m.film != 0;
  const int j = threadIdx.x;
  const bool act = j < H;
  float* part = partial + (long long)blockIdx.x * gsize;
  // this block's residents of its current tile: z_i and g_{i+1}, later
  // ubar_c_i, of every sine layer i, point p and unit j
  float* Zs = scratch + (long long)blockIdx.x * 2 * NL * SB_TILE * H;
  float* Gs = Zs + (long long)NL * SB_TILE * H;
  auto rs = [&](int i, int p) {
    return ((long long)i * SB_TILE + p) * H + j;
  };
  auto freq = [&](int i) {
    return film ? __ldg(P + m.freq_off + (long long)i * H + j) : 1.f;
  };
  auto phase = [&](int i) {
    return film ? __ldg(P + m.phase_off + (long long)i * H + j) : 0.f;
  };
  // rows <- rows W_i^T (steps 1 and 3) and rows <- rows W_i (2 and 5, i >= 1)
  auto fwd = [&](int i) {
    if (i == 0) {
      prod_fma(rows, din, P + m.wt_off[0], H, H);
    } else {
      if constexpr (BF)
        prod_mma(rows, H, Wb + 2LL * (i - 1) * H * H, H);
      else
        prod_fma(rows, H, P + m.wt_off[i], H, H);
    }
  };
  auto rev = [&](int i) {
    if constexpr (BF)
      prod_mma(rows, H, Wb + (2LL * (i - 1) + 1) * H * H, H);
    else
      prod_fma(rows, H, P + m.w_off[i], H, H);
  };
  const int ntiles = (n + SB_TILE - 1) / SB_TILE;

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int p0 = tile * SB_TILE;
    // ---- 0. the rounded points (the rows, B_0's second half) and g_out
    for (int e = j; e < SB_TILE * din; e += blockDim.x) {
      const int p = e / din, k = e - p * din;
      const bool in = p0 + p < n;
      const float v =
          in ? rnd_if(x_g[(long long)(p0 + p) * din + k], BF) : 0.f;
      rows[p * SB_LD + k] = v;
      if (in) put(ws + lay.b[0] + (long long)(n + p0 + p) * din + k, v);
    }
    for (int e = j; e < SB_TILE * dout; e += blockDim.x) {
      const int p = e / dout;
      gos[e] = p0 + p < n ? gout_g[(long long)p0 * dout + e] : 0.f;
    }
    __syncthreads();

    // ---- 1. primal chain; the rounded h_{i+1} rows feed the next layer
    for (int i = 0; i < NL; ++i) {
      fwd(i);
      if (act) {
        const float b = __ldg(P + m.b_off[i] + j), f = freq(i),
                    ph = phase(i);
        for (int p = 0; p < SB_TILE; ++p) {
          const float z = rows[p * SB_LD + j] + b;
          float s, c;
          unit_sc(z, f, ph, film, s, c);
          Zs[rs(i, p)] = z;
          const float h = rnd_if(s, BF);
          if (i + 1 < NL && p0 + p < n)   // h_{i+1}: B_{i+1}'s second half
            put(ws + lay.b[i + 1] + (long long)(n + p0 + p) * H + j, h);
          rows[p * SB_LD + j] = h;
        }
      }
      __syncthreads();
    }

    // ---- 2. reverse normal chain; a_i -> A_i's first half
    for (int i = NL - 1; i >= 0; --i) {
      if (i < NL - 1) rev(i + 1);      // rows <- a_{i+1} W_{i+1} = g_{i+1}
      if (act) {
        const float f = freq(i), ph = phase(i), cf = 30.f * f;
        const float g_top = __ldg(P + m.w_off[L - 1] + j);
        for (int q0 = 0; q0 < SB_TILE; q0 += SB_PF) {
          float zv[SB_PF];
#pragma unroll
          for (int q = 0; q < SB_PF; ++q) zv[q] = Zs[rs(i, q0 + q)];
#pragma unroll
          for (int q = 0; q < SB_PF; ++q) {
            const int p = q0 + q;
            const bool live = p0 + p < n;
            const float g = i == NL - 1 ? g_top : rows[p * SB_LD + j];
            float s, c;
            unit_sc(zv[q], f, ph, film, s, c);
            const float a = live ? rnd_if(g * (cf * c), BF) : 0.f;
            Gs[rs(i, p)] = g;
            if (live) put(ws + lay.a[i] + (long long)(p0 + p) * H + j, a);
            rows[p * SB_LD + j] = a;
          }
        }
      }
      __syncthreads();
    }

    // ---- 3. adjoint of the reverse chain, seeded with t_0 = g_n
    for (int e = j; e < SB_TILE * din; e += blockDim.x) {
      const int p = e / din, k = e - p * din;
      rows[p * SB_LD + k] =
          p0 + p < n ? rnd_if(gn_g[(long long)(p0 + p) * din + k], BF) : 0.f;
    }
    __syncthreads();
    float st = 0.f;                    // t_{L-1} of unit j, summed
    for (int i = 0; i < NL; ++i) {
      const int K = i == 0 ? din : H;
      for (int e = j; e < SB_TILE * K; e += blockDim.x) {
        const int p = e / K, k = e - p * K;
        if (p0 + p < n)                // t_i: B_i's first half
          put(ws + lay.b[i] + (long long)(p0 + p) * K + k,
              rows[p * SB_LD + k]);
      }
      fwd(i);                          // rows <- abar_i
      if (act) {
        const float f = freq(i), ph = phase(i), cf = 30.f * f;
        float s_fr = 0.f;
        for (int q0 = 0; q0 < SB_TILE; q0 += SB_PF) {
          float zv[SB_PF], gv[SB_PF];
#pragma unroll
          for (int q = 0; q < SB_PF; ++q) {
            zv[q] = Zs[rs(i, q0 + q)];
            gv[q] = Gs[rs(i, q0 + q)];
          }
#pragma unroll
          for (int q = 0; q < SB_PF; ++q) {
            const int p = q0 + q;
            const float abar = rows[p * SB_LD + j];
            float s, c;
            unit_sc(zv[q], f, ph, film, s, c);
            const float cbar = gv[q] * abar;
            if (film) s_fr += (30.f * c) * cbar;
            Gs[rs(i, p)] = (-900.f * f) * s * cbar;     // ubar_c_i
            const float tv = (cf * c) * abar;
            if (i == NL - 1) {         // the rows take h_{L-1} for step 4
              st += tv;
              rows[p * SB_LD + j] = s;
            } else {
              rows[p * SB_LD + j] = rnd_if(tv, BF);
            }
          }
        }
        if (film) part[gm.freq_off + (long long)i * H + j] += s_fr;
      }
      __syncthreads();
    }

    // ---- 4. output layer; hbar -> the rows
    if (act) {
      const float* WL = P + m.w_off[L - 1];       // (dout, H)
      for (int o = 0; o < dout; ++o) {
        float s = 0.f;
        for (int p = 0; p < SB_TILE; ++p)
          s = fmaf(rnd_if(gos[p * dout + o], BF),
                   rnd_if(rows[p * SB_LD + j], BF), s);
        part[gm.w_off[L - 1] + (long long)o * H + j] += o == 0 ? s + st : s;
      }
#pragma unroll 8
      for (int p = 0; p < SB_TILE; ++p) {
        float hb = 0.f;
        for (int o = 0; o < dout; ++o)
          hb = fmaf(rnd_if(gos[p * dout + o], BF),
                    rnd_if(__ldg(WL + (long long)o * H + j), BF), hb);
        rows[p * SB_LD + j] =
            hb + (p0 + p < n ? gfeat_g[(long long)(p0 + p) * H + j] : 0.f);
      }
    }
    if (j < dout) {
      float s = 0.f;
      for (int p = 0; p < SB_TILE; ++p) s += gos[p * dout + j];
      part[gm.b_off[L - 1] + j] += s;
    }
    __syncthreads();

    // ---- 5. primal backward; zbar_i -> A_i's second half
    for (int i = NL - 1; i >= 0; --i) {
      if (act) {
        const float f = freq(i), ph = phase(i);
        float s_fr = 0.f, s_ph = 0.f, s_db = 0.f;
        for (int q0 = 0; q0 < SB_TILE; q0 += SB_PF) {
          float zv[SB_PF], gv[SB_PF];
#pragma unroll
          for (int q = 0; q < SB_PF; ++q) {
            zv[q] = Zs[rs(i, q0 + q)];
            gv[q] = Gs[rs(i, q0 + q)];
          }
#pragma unroll
          for (int q = 0; q < SB_PF; ++q) {
            const int p = q0 + q;
            float s, c;
            unit_sc(zv[q], f, ph, film, s, c);
            const float ub = (30.f * c) * rows[p * SB_LD + j] + gv[q];
            float zb = ub;
            if (film) {
              s_fr += zv[q] * ub;
              s_ph += ub;
              zb = f * ub;
            }
            s_db += zb;
            const float a = rnd_if(zb, BF);
            rows[p * SB_LD + j] = a;
            if (p0 + p < n)
              put(ws + lay.a[i] + (long long)(n + p0 + p) * H + j, a);
          }
        }
        if (film) {
          part[gm.freq_off + (long long)i * H + j] += s_fr;
          part[gm.phase_off + (long long)i * H + j] += s_ph;
        }
        part[gm.b_off[i] + j] += s_db;
      }
      __syncthreads();
      if (i > 0)
        rev(i);                        // rows <- zbar_i W_i = hbar_i
      else
        dx_rows(rows, H, P + m.w_off[0], din, p0, n, dx_g);
    }
    __syncthreads();
  }
}

// The persistent grid for n points: as many blocks as fit on the card at
// once (more would run after the first ones, each with a share of the
// tiles), at most one per tile of the first chunk.
extern "C" int arah_shade_bwd_blocks(int n, ShadeMeta m) {
  int per_sm = 0, dev = 0, sms = 0;
  const cudaError_t e =
      m.bf16 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   &per_sm, shade_bwd_kernel<true>, SB_THREADS, 0)
             : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   &per_sm, shade_bwd_kernel<false>, SB_THREADS, 0);
  if (e != cudaSuccess || cudaGetDevice(&dev) != cudaSuccess
      || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
             != cudaSuccess)
    return 0;
  const int nc = n < SB_CHUNK ? n : SB_CHUNK;
  const int tiles = (nc + SB_TILE - 1) / SB_TILE;
  const int b = per_sm * sms;
  return b < tiles ? b : tiles;
}

// The workspace rows of a chunk of nc points: their element offsets, each
// array 16-byte aligned, and (in *count) their number of elements.
static ShadeWs ws_layout(long long nc, const ShadeMeta& m, long long* count) {
  ShadeWs w = {};
  const int NL = m.n_layers - 1;
  long long e = 0;
  auto take = [&](long long k) {
    const long long o = e;
    e += (k + 7) / 8 * 8;
    return o;
  };
  for (int i = 0; i < NL; ++i) w.a[i] = take(2 * nc * m.hidden);
  for (int i = 0; i < NL; ++i)
    w.b[i] = take(2 * nc * (i == 0 ? m.din : m.hidden));
  *count = e;
  return w;
}

// Floats of a chunk's rows (bf16 under bf16: two to a float).
static long long rows_floats(long long nc, const ShadeMeta& m) {
  long long e;
  ws_layout(nc, m, &e);
  return m.bf16 ? e / 2 : e;
}

static long long scratch_floats(int nblocks, const ShadeMeta& m) {
  return (long long)nblocks * 2 * (m.n_layers - 1) * SB_TILE * m.hidden;
}

// Floats of the workspace for n points on nblocks blocks: one chunk's A and
// B rows, the blocks' residents, then the A^T B reduction's split partials.
extern "C" long long arah_shade_bwd_ws(int n, int nblocks, ShadeMeta m) {
  const long long nc = n < SB_CHUNK ? n : SB_CHUNK, H = m.hidden;
  return rows_floats(nc, m) + scratch_floats(nblocks, m)
         + (long long)ATB_MAX_SPLITS * H * (H > m.din ? H : m.din);
}

// Per chunk of SB_CHUNK points: the tile kernel (dx, the workspace rows,
// the per-block partials), then per sine layer the A^T B reduction into
// the hidden dW of `grads` (zeroed by the caller); last, the per-block
// partials added into the rest of `grads`. `wbf16`: under bf16, the hidden
// layers' weights 1..L-2 as bf16 (L-2, 2, H, H), each (out, in) then
// transposed (ops/shade.py:pack_shade_bf16); null in f32. `partial` holds
// nblocks x gsize zeroed floats, `ws` arah_shade_bwd_ws(n, nblocks, m)
// floats.
extern "C" int arah_shade_bwd(const float* x, int n, const float* params,
                              const void* wbf16, ShadeMeta m,
                              const float* gout, const float* gfeat,
                              const float* gn, float* dx, float* partial,
                              int nblocks, ShadeMeta gm, long long gsize,
                              float* grads, float* ws, void* stream) {
  if (n <= 0 || nblocks <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const int H = m.hidden, din = m.din, dout = m.dout, NL = m.n_layers - 1;
  const bool bf = m.bf16 != 0;
  const long long nmax = n < SB_CHUNK ? n : SB_CHUNK;
  float* scratch = ws + rows_floats(nmax, m);
  float* apart = scratch + scratch_floats(nblocks, m);
  const __nv_bfloat16* wb = static_cast<const __nv_bfloat16*>(wbf16);
  __nv_bfloat16* wsh = reinterpret_cast<__nv_bfloat16*>(ws);
  for (int c0 = 0; c0 < n; c0 += SB_CHUNK) {
    const int nc = n - c0 < SB_CHUNK ? n - c0 : SB_CHUNK;
    long long count;
    const ShadeWs lay = ws_layout(nc, m, &count);
    const float* xc = x + (long long)c0 * din;
    const float* goc = gout + (long long)c0 * dout;
    const float* gfc = gfeat + (long long)c0 * H;
    const float* gnc = gn + (long long)c0 * din;
    float* dxc = dx + (long long)c0 * din;
    if (bf)
      shade_bwd_kernel<true><<<nblocks, SB_THREADS, 0, st>>>(
          xc, nc, params, wb, m, goc, gfc, gnc, dxc, partial, gm, gsize, wsh,
          lay, scratch);
    else
      shade_bwd_kernel<false><<<nblocks, SB_THREADS, 0, st>>>(
          xc, nc, params, wb, m, goc, gfc, gnc, dxc, partial, gm, gsize, ws,
          lay, scratch);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const long long n2 = 2LL * nc;
    for (int i = 0; i < NL; ++i) {
      const int K = i == 0 ? din : H;
      const int r =
          bf ? atb_accumulate(wsh + lay.a[i], H, wsh + lay.b[i], K, n2, H, K,
                              true, apart, grads + gm.w_off[i], K, st)
             : atb_accumulate(ws + lay.a[i], H, ws + lay.b[i], K, n2, H, K,
                              false, apart, grads + gm.w_off[i], K, st);
      if (r != 0) return r;
    }
  }
  const long long blocks = (gsize + 255) / 256;
  sum_partials<<<(unsigned)blocks, 256, 0, st>>>(partial, nblocks, gsize,
                                                 grads);
  return launch_status();
}
