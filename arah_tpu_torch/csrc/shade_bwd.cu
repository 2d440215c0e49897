// Kernel H: the backward of the shading kernel C (the training step's
// differentiable (sdf, features, normal) of the generated SIREN).
//
// Replaces the TPU kernel arah_tpu/ops/pallas/shade_grad_kernel.py:
// _shade_bwd_pallas (body _shade_bwd_kernel). Per point, with cotangents
// (g_out, g_feat, g_n) of (sdf, features, normal = d sdf / dx):
//   1. recompute the primal chain z_i = W_i h_i + b_i, u_i = f_i z_i + p_i,
//      h_{i+1} = sin(30 u_i), keeping z_i, cos(30 u_i) and h_{i+1};
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
// Design: C's structure (256 threads, thread j = hidden unit j, the
// hidden weights streamed from L2, coalesced across j) over a tile of
// SB_TILE points, so each weight feeds SB_TILE FMAs. The only row in
// shared memory is the current product's input (SB_TILE x H floats,
// 16 KB at the flagship); the per-layer residents (cos, z,
// h and g, which becomes ubar_c after the adjoint sweep; 4 KB a point at
// the flagship) go to device memory, each thread writing and reading its
// own unit's column, and every operand of a product is rounded once,
// when its row is written (the packed hidden weights come rounded from
// the host). The hidden layers' weight gradients are the crux: dW_i sums
// a_i (x) t_i + zbar_i (x) h_i over all points. Float atomics across
// blocks would change from run to run, and adding each tile's update to
// a per-block partial moves the whole dW through memory per tile (~1.2 s
// at the flagship). So the kernel writes each point's four operand rows
// to a workspace (a and zbar as the rows of A_i, t and h as the rows of
// B_i) and atb.cuh reduces A_i^T B_i over the points, split over point
// ranges and summed in split order. The points run in chunks of SB_CHUNK
// so that workspace and residents stay ~3 GB. The vectors (db, dfreq,
// dphase) and the output layer's gradients, a few thousand floats, go to
// per-block partials (a fixed, persistent grid, each block's tiles in a
// fixed order), summed over the blocks in block order by sum_partials.
// Every sum is the same on every run. Padded rows have zero cotangents,
// read zero residents, are never written, and contribute exactly zero.
#include "atb.cuh"
#include "shade_meta.cuh"

#define SB_THREADS 256
#define SB_TILE 16
#define SB_CHUNK 65536             // points per workspace pass

// acc[p] += sum_k in[p * stride + k] * W[k * ldw + col] over k < K. The
// operands come rounded under bf16, so the loop is plain FMA.
__device__ __forceinline__ void tile_dot(const float* in, int stride, int K,
                                         const float* __restrict__ W,
                                         int ldw, int col, float* acc) {
  if ((K & 3) == 0 && (stride & 3) == 0) {
    for (int k = 0; k < K; k += 4) {
      const float w0 = __ldg(W + (long long)k * ldw + col);
      const float w1 = __ldg(W + (long long)(k + 1) * ldw + col);
      const float w2 = __ldg(W + (long long)(k + 2) * ldw + col);
      const float w3 = __ldg(W + (long long)(k + 3) * ldw + col);
#pragma unroll
      for (int p = 0; p < SB_TILE; ++p) {
        const float4 v = *reinterpret_cast<const float4*>(in + p * stride + k);
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
      const float w = __ldg(W + (long long)k * ldw + col);
#pragma unroll
      for (int p = 0; p < SB_TILE; ++p)
        acc[p] = fmaf(in[p * stride + k], w, acc[p]);
    }
  }
}

__global__ void __launch_bounds__(SB_THREADS, 2)
shade_bwd_kernel(const float* __restrict__ x_g, int n,
                 const float* __restrict__ P, ShadeMeta m,
                 const float* __restrict__ gout_g,
                 const float* __restrict__ gfeat_g,
                 const float* __restrict__ gn_g, float* __restrict__ dx_g,
                 float* __restrict__ partial, ShadeMeta gm,
                 long long gsize, float* __restrict__ ws,
                 float* __restrict__ res) {
  extern __shared__ __align__(16) float rows[];     // [TILE][H]
  __shared__ __align__(16) float xs[SB_TILE * 4];
  __shared__ float gos[SB_TILE * 16];
  const int H = m.hidden, L = m.n_layers, din = m.din, dout = m.dout;
  const int NL = L - 1;                        // sine layers
  const bool bf = m.bf16 != 0, film = m.film != 0;
  const int j = threadIdx.x;
  const bool act = j < H;
  float* part = partial + (long long)blockIdx.x * gsize;
  const int ntiles = (n + SB_TILE - 1) / SB_TILE;
  // workspace: per sine layer i, A_i (2n, H) = [a_i rows; zbar_i rows]
  // and B_i (2n, K_i) = [t_i rows; h_i rows], K_0 = din, K_i = H
  const long long n2 = 2LL * n;
  auto wsA = [&](int i) { return ws + (long long)i * n2 * H; };
  auto wsB = [&](int i) {
    return ws + (long long)NL * n2 * H
           + (i == 0 ? 0LL : n2 * din + (long long)(i - 1) * n2 * H);
  };
  // residents, (n, H) per sine layer: cos(30 u_i), z_i, h_{i+1}, and
  // g_{i+1}, overwritten by ubar_c_i
  const long long RS = (long long)n * H;
  float* Cg = res;
  float* Zg = Cg + NL * RS;
  float* Hg = Zg + NL * RS;
  float* Gg = Hg + NL * RS;

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int p0 = tile * SB_TILE;
    // resident element (layer i, point p) of unit j; padded points read 0
    auto at = [&](int i, int p) {
      return i * RS + (long long)(p0 + p) * H + j;
    };
    auto ld = [&](const float* r, int i, int p) {
      return p0 + p < n ? r[at(i, p)] : 0.f;
    };
    for (int e = j; e < SB_TILE * 4; e += blockDim.x) {
      const int p = e / 4, k = e % 4;
      const bool in = p0 + p < n && k < din;
      xs[e] = in ? rnd_if(x_g[(long long)(p0 + p) * din + k], bf) : 0.f;
      if (in) wsB(0)[(n + p0 + p) * (long long)din + k] = xs[e];
    }
    for (int e = j; e < SB_TILE * dout; e += blockDim.x) {
      const int p = e / dout;
      gos[e] = p0 + p < n ? gout_g[(long long)p0 * dout + e] : 0.f;
    }
    __syncthreads();

    // ---- 1. primal chain; the rounded h_{i+1} rows feed the next layer
    for (int i = 0; i < NL; ++i) {
      float acc[SB_TILE];
#pragma unroll
      for (int p = 0; p < SB_TILE; ++p) acc[p] = 0.f;
      if (act) {
        if (i == 0)
          tile_dot(xs, 4, din, P + m.wt_off[0], H, j, acc);
        else
          tile_dot(rows, H, H, P + m.wt_off[i], H, j, acc);
      }
      __syncthreads();                 // every read of rows is done
      if (act) {
        const float b = __ldg(P + m.b_off[i] + j);
        const float f = film ? __ldg(P + m.freq_off + (long long)i * H + j)
                             : 1.f;
        const float ph = film ? __ldg(P + m.phase_off + (long long)i * H + j)
                              : 0.f;
#pragma unroll
        for (int p = 0; p < SB_TILE; ++p) {
          const float z = acc[p] + b;
          const float u = film ? f * z + ph : z;
          float s, c;
          sincosf(30.f * u, &s, &c);
          if (p0 + p < n) {
            Cg[at(i, p)] = c;
            if (film) Zg[at(i, p)] = z;
            Hg[at(i, p)] = s;
            if (i + 1 < NL)            // h_{i+1}: B_{i+1}'s second half
              wsB(i + 1)[(n + p0 + p) * (long long)H + j] = s;
          }
          rows[p * H + j] = rnd_if(s, bf);
        }
      }
      __syncthreads();
    }

    // ---- 2. reverse normal chain, g in registers; a_i -> A_i's first half
    float g[SB_TILE];
    {
      const float g0 = act ? __ldg(P + m.w_off[L - 1] + j) : 0.f;
#pragma unroll
      for (int p = 0; p < SB_TILE; ++p) g[p] = g0;
    }
    for (int i = NL - 1; i >= 0; --i) {
      if (act) {
        const float f = film ? __ldg(P + m.freq_off + (long long)i * H + j)
                             : 1.f;
        const float cf = 30.f * f;
#pragma unroll
        for (int p = 0; p < SB_TILE; ++p) {
          const float a = rnd_if(g[p] * (cf * ld(Cg, i, p)), bf);
          if (p0 + p < n) {
            Gg[at(i, p)] = g[p];
            wsA(i)[(long long)(p0 + p) * H + j] = a;
          }
          if (i > 0) rows[p * H + j] = a;
        }
      }
      if (i == 0) break;
      __syncthreads();
#pragma unroll
      for (int p = 0; p < SB_TILE; ++p) g[p] = 0.f;
      if (act) tile_dot(rows, H, H, P + m.w_off[i], H, j, g);
      __syncthreads();
    }
    __syncthreads();

    // ---- 3. adjoint of the reverse chain, seeded with t_0 = g_n
    for (int e = j; e < SB_TILE * 4; e += blockDim.x) {
      const int p = e / 4, k = e % 4;
      if (k < din)
        rows[p * H + k] = p0 + p < n
            ? rnd_if(gn_g[(long long)(p0 + p) * din + k], bf) : 0.f;
    }
    __syncthreads();
    float t[SB_TILE];                  // t_{i+1}, unrounded
    for (int i = 0; i < NL; ++i) {
      const int K = (i == 0) ? din : H;
      for (int e = j; e < SB_TILE * K; e += blockDim.x) {
        const int p = e / K, k = e - p * K;
        if (p0 + p < n)                // t_i: B_i's first half
          wsB(i)[(long long)(p0 + p) * K + k] = rows[p * H + k];
      }
      float abar[SB_TILE];
#pragma unroll
      for (int p = 0; p < SB_TILE; ++p) abar[p] = 0.f;
      if (act) tile_dot(rows, H, K, P + m.wt_off[i], H, j, abar);
      __syncthreads();
      if (act) {
        const float f = film ? __ldg(P + m.freq_off + (long long)i * H + j)
                             : 1.f;
        const float cf = 30.f * f;
        float s_fr = 0.f;
#pragma unroll
        for (int p = 0; p < SB_TILE; ++p) {
          const float c = ld(Cg, i, p);
          const float cbar = ld(Gg, i, p) * abar[p];
          if (film) s_fr += (30.f * c) * cbar;
          if (p0 + p < n)
            Gg[at(i, p)] = (-900.f * f) * ld(Hg, i, p) * cbar;
          t[p] = (cf * c) * abar[p];
          rows[p * H + j] = rnd_if(t[p], bf);
        }
        if (film) part[gm.freq_off + (long long)i * H + j] += s_fr;
      }
      __syncthreads();
    }

    // ---- 4. output layer: t holds t_{L-1}, column j
    float hb[SB_TILE];
#pragma unroll
    for (int p = 0; p < SB_TILE; ++p) hb[p] = 0.f;
    if (act) {
      float st = 0.f;
#pragma unroll
      for (int p = 0; p < SB_TILE; ++p) st += t[p];
      const float* WL = P + m.w_off[L - 1];       // (dout, H)
      for (int o = 0; o < dout; ++o) {
        float s = 0.f;
#pragma unroll
        for (int p = 0; p < SB_TILE; ++p)
          s = fmaf(rnd_if(gos[p * dout + o], bf),
                   rnd_if(ld(Hg, NL - 1, p), bf), s);
        part[gm.w_off[L - 1] + (long long)o * H + j] += (o == 0) ? s + st
                                                                 : s;
        const float w = rnd_if(__ldg(WL + (long long)o * H + j), bf);
#pragma unroll
        for (int p = 0; p < SB_TILE; ++p)
          hb[p] = fmaf(rnd_if(gos[p * dout + o], bf), w, hb[p]);
      }
#pragma unroll
      for (int p = 0; p < SB_TILE; ++p)
        hb[p] += p0 + p < n ? gfeat_g[(long long)(p0 + p) * H + j] : 0.f;
    }
    if (j < dout) {
      float s = 0.f;
#pragma unroll
      for (int p = 0; p < SB_TILE; ++p) s += gos[p * dout + j];
      part[gm.b_off[L - 1] + j] += s;
    }

    // ---- 5. primal backward; zbar_i -> A_i's second half
    for (int i = NL - 1; i >= 0; --i) {
      const int K = (i == 0) ? din : H;
      if (act) {
        const float f = film ? __ldg(P + m.freq_off + (long long)i * H + j)
                             : 1.f;
        float s_fr = 0.f, s_ph = 0.f, s_db = 0.f;
#pragma unroll
        for (int p = 0; p < SB_TILE; ++p) {
          const float ub = (30.f * ld(Cg, i, p)) * hb[p] + ld(Gg, i, p);
          float zb = ub;
          if (film) {
            s_fr += ld(Zg, i, p) * ub;
            s_ph += ub;
            zb = f * ub;
          }
          s_db += zb;
          const float a = rnd_if(zb, bf);
          rows[p * H + j] = a;
          if (p0 + p < n) wsA(i)[(n + p0 + p) * (long long)H + j] = a;
        }
        if (film) {
          part[gm.freq_off + (long long)i * H + j] += s_fr;
          part[gm.phase_off + (long long)i * H + j] += s_ph;
        }
        part[gm.b_off[i] + j] += s_db;
      }
      __syncthreads();
#pragma unroll
      for (int p = 0; p < SB_TILE; ++p) hb[p] = 0.f;
      if (j < K) tile_dot(rows, H, H, P + m.w_off[i], K, j, hb);
      __syncthreads();
    }
    if (j < din) {
#pragma unroll
      for (int p = 0; p < SB_TILE; ++p)
        if (p0 + p < n) dx_g[(long long)(p0 + p) * din + j] = hb[p];
    }
    __syncthreads();
  }
}

// The persistent grid for n points: as many blocks as fit on the card at
// once (more would run after the first ones, each with a share of the
// tiles), at most one per tile of the first chunk.
extern "C" int arah_shade_bwd_blocks(int n, ShadeMeta m) {
  const size_t smem = (size_t)SB_TILE * m.hidden * sizeof(float);
  if (cudaFuncSetAttribute(shade_bwd_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return 0;
  int per_sm = 0, dev = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, shade_bwd_kernel, SB_THREADS, smem) != cudaSuccess
      || cudaGetDevice(&dev) != cudaSuccess
      || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
             != cudaSuccess)
    return 0;
  const int nc = n < SB_CHUNK ? n : SB_CHUNK;
  const int tiles = (nc + SB_TILE - 1) / SB_TILE;
  const int b = per_sm * sms;
  return b < tiles ? b : tiles;
}

// Floats of one chunk's workspace rows (A and B of every sine layer).
static long long ab_floats(long long nc, const ShadeMeta& m) {
  const int NL = m.n_layers - 1;
  return 2 * nc * ((long long)NL * m.hidden + m.din
                   + (long long)(NL - 1) * m.hidden);
}

// Floats of the workspace for n points: one chunk's A and B rows, its
// residents, then the A^T B reduction's split partials.
extern "C" long long arah_shade_bwd_ws(int n, ShadeMeta m) {
  const long long nc = n < SB_CHUNK ? n : SB_CHUNK, H = m.hidden;
  return ab_floats(nc, m) + 4LL * (m.n_layers - 1) * nc * H
         + (long long)ATB_MAX_SPLITS * H * (H > m.din ? H : m.din);
}

// Per chunk of SB_CHUNK points: the tile kernel (dx, the workspace rows,
// the per-block partials), then per sine layer the A^T B reduction into
// the hidden dW of `grads` (zeroed by the caller); last, the per-block
// partials added into the rest of `grads`. `partial` holds nblocks x
// gsize zeroed floats, `ws` arah_shade_bwd_ws(n, m) floats.
extern "C" int arah_shade_bwd(const float* x, int n, const float* params,
                              ShadeMeta m, const float* gout,
                              const float* gfeat, const float* gn, float* dx,
                              float* partial, int nblocks, ShadeMeta gm,
                              long long gsize, float* grads, float* ws,
                              void* stream) {
  if (n <= 0 || nblocks <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const int H = m.hidden, din = m.din, dout = m.dout, NL = m.n_layers - 1;
  const size_t smem = (size_t)SB_TILE * H * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      shade_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long nmax = n < SB_CHUNK ? n : SB_CHUNK;
  float* res = ws + ab_floats(nmax, m);
  float* apart = res + 4LL * NL * nmax * H;
  for (int c0 = 0; c0 < n; c0 += SB_CHUNK) {
    const int nc = n - c0 < SB_CHUNK ? n - c0 : SB_CHUNK;
    shade_bwd_kernel<<<nblocks, SB_THREADS, smem, st>>>(
        x + (long long)c0 * din, nc, params, m, gout + (long long)c0 * dout,
        gfeat + (long long)c0 * H, gn + (long long)c0 * din,
        dx + (long long)c0 * din, partial, gm, gsize, ws, res);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const long long n2 = 2LL * nc;
    const float* wsB = ws + (long long)NL * n2 * H;
    for (int i = 0; i < NL; ++i) {
      const int K = i == 0 ? din : H;
      const float* B = wsB + (i == 0 ? 0LL : n2 * din
                                              + (long long)(i - 1) * n2 * H);
      const int r = atb_accumulate(ws + (long long)i * n2 * H, H, B, K, n2,
                                   H, K, m.bf16 != 0, apart,
                                   grads + gm.w_off[i], K, st);
      if (r != 0) return r;
    }
  }
  const long long blocks = (gsize + 255) / 256;
  sum_partials<<<(unsigned)blocks, 256, 0, st>>>(partial, nblocks, gsize,
                                                 grads);
  return launch_status();
}
