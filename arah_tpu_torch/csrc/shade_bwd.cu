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
// f32; chain values and residents stay f32. Under resid (the TPU kernel's
// resid_bf16, RES) every value the TPU kernel stores through its `st` is
// rounded to bf16 where that store is read: h_{i+1} (the workspace rows of
// dW_{i+1} and, as the features, of dW_{L-1}), cos(30 u), z, 30 f cos, g,
// a and ubar_c; the running chain (the products' inputs under f32), t and
// every cotangent product stay f32.
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
//   run on the tensor cores (mma.cuh:prod_mma, shared with C and I:
//   mma.sync m16n8k16, bf16 x bf16 -> f32): warp w owns output units
//   [32w, 32w + 32) of all 32 points, loads its weight fragments straight
//   from a bf16 copy of the weights in L2 (16 B a lane, the next k-chunk
//   in flight while the current one multiplies), so each weight it loads
//   feeds 32 points. The f32 launch (the eikonal points) runs the same
//   body with FMA products on the CUDA cores (mma.cuh:prod_fma; never
//   TF32). The din-wide products (the first layer, dx) run on the CUDA
//   cores in both.
// - The tile's rows. One f32 [point][unit] tile in shared memory holds the
//   current product's input; a product reads it, synchronises and writes
//   its result in place, and each thread then does the per-unit algebra of
//   its own unit j over the 32 points. Every row is rounded when written
//   under bf16, so the tensor cores' bf16 operands are exact.
// - The residents. Only z_i and g_{i+1} (overwritten by ubar_c_i) are kept
//   per point, unit and sine layer, in a per-block scratch that the block
//   reuses tile after tile; u, sin(30 u) and cos(30 u) are recomputed from
//   z by one expression (unit_sc), so every recomputation has the primal
//   chain's bits. Under resid g and ubar_c, which the TPU kernel stores in
//   bf16, are kept in bf16; z stays f32, the source the chain's sines are
//   recomputed from (the TPU kernel computes them from the f32 z before it
//   stores any), and is rounded where the TPU kernel reads its z.
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
#include "mma.cuh"
#include "shade_meta.cuh"

#define SB_THREADS 256
#define SB_TILE 32                 // points per tile
#define SB_LD (256 + 4)            // row stride of the tile (floats)
#define SB_CHUNK 65536             // points per workspace pass
#define SB_PF 4                    // residents loaded ahead, per thread

static_assert(SB_TILE * 8 == SB_THREADS, "dx_rows: 8 lanes per point");
static_assert(SB_TILE == 32, "prod_mma: two 16-point fragments per warp");
static_assert(SB_TILE % SB_PF == 0, "whole groups of residents");

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

// BF: the bf16_shading launch (tensor-core products, bf16 workspace rows);
// otherwise f32 throughout. RES: the residents in bf16 (resid).
template <bool BF, bool RES>
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
  const long long nres = (long long)NL * SB_TILE * H;
  float* Zs = scratch + blockIdx.x * (RES ? 3 : 4) * (nres / 2);
  ResT<RES>* Gs = reinterpret_cast<ResT<RES>*>(Zs + nres);
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
      prod_fma<SB_TILE>(rows, SB_LD, din, P + m.wt_off[0], H, H);
    } else {
      if constexpr (BF)
        prod_mma<2>(rows, SB_LD, H, Wb + 2LL * (i - 1) * H * H, H, rows,
                    SB_LD, false);
      else
        prod_fma<SB_TILE>(rows, SB_LD, H, P + m.wt_off[i], H, H);
    }
  };
  auto rev = [&](int i) {
    if constexpr (BF)
      prod_mma<2>(rows, SB_LD, H, Wb + (2LL * (i - 1) + 1) * H * H, H,
                  rows, SB_LD, false);
    else
      prod_fma<SB_TILE>(rows, SB_LD, H, P + m.w_off[i], H, H);
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
            put(ws + lay.b[i + 1] + (long long)(n + p0 + p) * H + j,
                rnd_if(h, RES));
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
            const float af = live ? g * rnd_if(cf * c, RES) : 0.f;
            const float a = rnd_if(af, BF);
            res_put<RES>(Gs + rs(i, p), g);
            if (live)
              put(ws + lay.a[i] + (long long)(p0 + p) * H + j,
                  rnd_if(a, RES));
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
            gv[q] = res_get<RES>(Gs + rs(i, q0 + q));
          }
#pragma unroll
          for (int q = 0; q < SB_PF; ++q) {
            const int p = q0 + q;
            const float abar = rows[p * SB_LD + j];
            float s, c;
            unit_sc(zv[q], f, ph, film, s, c);
            const float cbar = gv[q] * abar;
            if (film) s_fr += (30.f * rnd_if(c, RES)) * cbar;
            s = rnd_if(s, RES);
            res_put<RES>(Gs + rs(i, p), (-900.f * f) * s * cbar);  // ubar_c
            const float tv = rnd_if(cf * c, RES) * abar;
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
            gv[q] = res_get<RES>(Gs + rs(i, q0 + q));
          }
#pragma unroll
          for (int q = 0; q < SB_PF; ++q) {
            const int p = q0 + q;
            float s, c;
            unit_sc(zv[q], f, ph, film, s, c);
            const float ub =
                (30.f * rnd_if(c, RES)) * rows[p * SB_LD + j] + gv[q];
            float zb = ub;
            if (film) {
              s_fr += rnd_if(zv[q], RES) * ub;
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
        dx_rows<SB_TILE>(rows, SB_LD, H, P + m.w_off[0], din, p0, n, dx_g);
    }
    __syncthreads();
  }
}

// The persistent grid for n points: as many blocks as fit on the card at
// once (more would run after the first ones, each with a share of the
// tiles), at most one per tile of the first chunk.
template <bool BF, bool RES>
static cudaError_t bwd_per_sm(int* per_sm) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, shade_bwd_kernel<BF, RES>, SB_THREADS, 0);
}

extern "C" int arah_shade_bwd_blocks(int n, ShadeMeta m) {
  int per_sm = 0, dev = 0, sms = 0;
  const cudaError_t e =
      m.bf16 ? (m.resid ? bwd_per_sm<true, true>(&per_sm)
                        : bwd_per_sm<true, false>(&per_sm))
             : (m.resid ? bwd_per_sm<false, true>(&per_sm)
                        : bwd_per_sm<false, false>(&per_sm));
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

// Floats of the blocks' residents: z in f32, g / ubar_c in f32 (bf16, two
// to a float, under resid).
static long long scratch_floats(int nblocks, const ShadeMeta& m) {
  return (long long)nblocks * (m.resid ? 3 : 4)
         * ((long long)(m.n_layers - 1) * SB_TILE * m.hidden / 2);
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
    if (bf && m.resid)
      shade_bwd_kernel<true, true><<<nblocks, SB_THREADS, 0, st>>>(
          xc, nc, params, wb, m, goc, gfc, gnc, dxc, partial, gm, gsize, wsh,
          lay, scratch);
    else if (bf)
      shade_bwd_kernel<true, false><<<nblocks, SB_THREADS, 0, st>>>(
          xc, nc, params, wb, m, goc, gfc, gnc, dxc, partial, gm, gsize, wsh,
          lay, scratch);
    else if (m.resid)
      shade_bwd_kernel<false, true><<<nblocks, SB_THREADS, 0, st>>>(
          xc, nc, params, wb, m, goc, gfc, gnc, dxc, partial, gm, gsize, ws,
          lay, scratch);
    else
      shade_bwd_kernel<false, false><<<nblocks, SB_THREADS, 0, st>>>(
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
