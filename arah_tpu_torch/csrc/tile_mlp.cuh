// Shared pieces of the solver kernels (B and L corr, one body in
// corr_rows.cu; E march, F iso) and of J (siren): the skinning MLP's
// softplus100 and SNARF hierarchical softmax, the adjugate 3x3 inverse, the
// per-point good-Broyden step of the corr solve, and a tile's passes
// through the generated SIREN and the collapsed skinning MLP.
//
// Tile layout (B/L, E, F, J): a block of TILE_THREADS threads owns TILE_RAYS
// rays (points). A layer's activations for the tile live in shared memory as
// [ray][unit] rows of stride TILE_LD; thread j computes output unit j (or
// unit j % width for narrow layers, whose rays are split between thread
// groups), so each weight it loads from L2 (coalesced, from a transposed
// (in, out) copy) feeds one FMA per ray, and the inputs are float4
// broadcasts from shared memory. Every function here is called by all
// threads of the block (they synchronise inside).
#pragma once

#include "common.cuh"

#define TILE_RAYS 16
#define TILE_THREADS 256
#define TILE_LD 256          // widest layer of either network
#define NET_MAX_LAYERS 8
#define N_BONES 24

// The generated SIREN (3 -> hidden x (n_layers - 1) -> 1, FiLM optional)
// and, for F, the collapsed skinning MLP (3 -> ... -> 25), as offsets into
// one f32 parameter buffer.
struct NetMeta {
  int n_layers, hidden, film;
  long long wt_off[NET_MAX_LAYERS];   // (in, hidden) copies, layers 0..L-2
  long long wl_off;                   // last layer's (hidden,) row
  long long b_off[NET_MAX_LAYERS];    // biases, b_off[L-1] the output's
  long long freq_off, phase_off;      // (L-1, hidden) each, if film
  int n_skin;                         // skinning linear layers (F only)
  int skin_dims[NET_MAX_LAYERS + 1];  // widths: 3, ..., 25
  long long skin_wt_off[NET_MAX_LAYERS];  // (in, out) copies
  long long skin_b_off[NET_MAX_LAYERS];
};

__device__ __forceinline__ float softplus100(float x) {
  const float bx = 100.f * x;
  return bx > 20.f ? x : log1pf(expf(bx)) / 100.f;
}

__device__ __forceinline__ float sigm(float x) {
  return 1.f / (1.f + expf(-x));
}

// SNARF hierarchical softmax, (25) logits -> (24) probabilities, in the
// order of corr_kernel_t.py:_hier_softmax_rows.
static __device__ void hier_softmax(const float* c, float* p) {
  const float m_hip = fmaxf(fmaxf(c[1], c[2]), c[3]);
  const float e1 = expf(c[1] - m_hip), e2 = expf(c[2] - m_hip),
              e3 = expf(c[3] - m_hip);
  const float denom = e1 + e2 + e3;
  const float root_gate = sigm(c[0]);
  p[1] = root_gate * e1 / denom;
  p[2] = root_gate * e2 / denom;
  p[3] = root_gate * e3 / denom;
  p[0] = 1.f - root_gate;
  const int ch1[8] = {4, 5, 6, 7, 8, 9, 10, 11};
  const int pa1[8] = {1, 2, 3, 4, 5, 6, 7, 8};
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const float s = sigm(c[ch1[t]]);
    p[ch1[t]] = p[pa1[t]] * s;
    p[pa1[t]] = p[pa1[t]] * (1.f - s);
  }
  const float spine_gate = sigm(c[24]);
  const float m_sp = fmaxf(fmaxf(c[12], c[13]), c[14]);
  const float e12 = expf(c[12] - m_sp), e13 = expf(c[13] - m_sp),
              e14 = expf(c[14] - m_sp);
  const float denom_s = e12 + e13 + e14;
  p[12] = p[9] * spine_gate * e12 / denom_s;
  p[13] = p[9] * spine_gate * e13 / denom_s;
  p[14] = p[9] * spine_gate * e14 / denom_s;
  p[9] = p[9] * (1.f - spine_gate);
  const int ch2[9] = {15, 16, 17, 18, 19, 20, 21, 22, 23};
  const int pa2[9] = {12, 13, 14, 16, 17, 18, 19, 20, 21};
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    const float s = sigm(c[ch2[t]]);
    p[ch2[t]] = p[pa2[t]] * s;
    p[pa2[t]] = p[pa2[t]] * (1.f - s);
  }
}

// Row-major 3x3 inverse by the adjugate (corr_kernel_t.py:_inv3x3_rows).
static __device__ void inv3x3(const float m[9], float o[9]) {
  const float a = m[0], b = m[1], c = m[2], d = m[3], e = m[4], f = m[5],
              g = m[6], h = m[7], i = m[8];
  const float A = e * i - f * h, B = -(d * i - f * g), C = d * h - e * g;
  const float D = -(b * i - c * h), E = a * i - c * g, F = -(a * h - b * g);
  const float G = b * f - c * e, H = -(a * f - c * d), I = a * e - b * d;
  const float inv_det = 1.f / (a * A + b * B + c * C);
  o[0] = A * inv_det; o[1] = D * inv_det; o[2] = G * inv_det;
  o[3] = B * inv_det; o[4] = E * inv_det; o[5] = H * inv_det;
  o[6] = C * inv_det; o[7] = F * inv_det; o[8] = I * inv_det;
}

// The good-Broyden solve of one point of the corr kernel (B/L), in the
// order of corr_kernel_t.py's body. broyden_init: from fwd_skin at the init
// (residual g, blended transform T), the adjugate inverse Ji of T's 3x3 and
// the first step upd = -Ji g; returns |g|, the first best residual norm.
__device__ __forceinline__ float broyden_init(const float T[16],
                                              const float g[3], float Ji[9],
                                              float upd[3]) {
  const float J0[9] = {T[0], T[1], T[2], T[4], T[5], T[6],
                       T[8], T[9], T[10]};
  inv3x3(J0, Ji);
#pragma unroll
  for (int r = 0; r < 3; ++r)
    upd[r] = -(Ji[3 * r] * g[0] + Ji[3 * r + 1] * g[1] + Ji[3 * r + 2] * g[2]);
  return sqrtf(g[0] * g[0] + g[1] * g[1] + g[2] * g[2]);
}

// broyden_step: one iteration of an active point, after fwd_skin at x + dx
// gave the residual gn_v. Keeps the best residual norm gn_opt (`better`
// when this iterate beats it: the caller then keeps x + dx and its
// transform), applies the good-Broyden rank-1 update to Ji with a +/-eps
// denominator, and sets g <- gn_v and upd <- -Ji gn_v. Returns whether the
// point stays active: gn_opt > cvg and |gn_v| < dvg.
__device__ __forceinline__ bool broyden_step(float Ji[9], float g[3],
                                             float upd[3], float& gn_opt,
                                             bool& better, const float dx[3],
                                             const float gn_v[3], float cvg,
                                             float dvg, float eps) {
  float dg[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) dg[c] = gn_v[c] - g[c];
  const float gn = sqrtf(gn_v[0] * gn_v[0] + gn_v[1] * gn_v[1]
                         + gn_v[2] * gn_v[2]);
  better = gn < gn_opt;
  if (better) gn_opt = gn;
  const bool active = (gn_opt > cvg) && (gn < dvg);
  float vT[3], a[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    vT[c] = dx[0] * Ji[c] + dx[1] * Ji[3 + c] + dx[2] * Ji[6 + c];
#pragma unroll
  for (int r = 0; r < 3; ++r)
    a[r] = dx[r] - (Ji[3 * r] * dg[0] + Ji[3 * r + 1] * dg[1]
                    + Ji[3 * r + 2] * dg[2]);
  float bd = vT[0] * dg[0] + vT[1] * dg[1] + vT[2] * dg[2];
  bd = (bd >= 0.f) ? bd + eps : bd - eps;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float u = a[r] / bd;
#pragma unroll
    for (int c = 0; c < 3; ++c) Ji[3 * r + c] += u * vT[c];
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    upd[r] = -(Ji[3 * r] * gn_v[0] + Ji[3 * r + 1] * gn_v[1]
               + Ji[3 * r + 2] * gn_v[2]);
    g[r] = gn_v[r];
  }
  return active;
}

// The canonical normalisation and SDF scale of the Pallas kernels:
// x_norm = x * nscale + noff, metric sdf = raw * mscale
// (march_kernel.py:56-63, the form of ops/march.py:kernel_affine).
struct FrameAffine {
  float nscale, noff[3], mscale, trans[3];
};

__device__ __forceinline__ FrameAffine frame_affine(const float* f8) {
  FrameAffine a;
  const float cmin = f8[0], cmax = f8[1];
  const float ext = __fsub_rn(cmax, cmin);
  a.nscale = __fdiv_rn(2.f, __fmul_rn(ext, 1.1f));
  const float pad = __fmul_rn(0.05f, ext);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    a.noff[c] = __fsub_rn(
        __fmul_rn(__fadd_rn(__fsub_rn(-f8[2 + c], cmin), pad), a.nscale),
        1.f);
    a.trans[c] = f8[5 + c];
  }
  a.mscale = __fmul_rn(0.55f, ext);
  return a;
}

// One skinning-MLP layer over the tile, in place in hbuf [ray][TILE_LD]:
// h[p][o] <- softplus100(sum_k h[p][k] W[o][k] + b[o]) for o < dout <=
// TILE_LD, or the logits scaled by `scale` when `logits`, with Wt the
// (din, dout) transposed weights. RP rays per thread: TILE_RAYS / RP
// groups of dout threads.
template <int RP>
static __device__ void tile_dense_rp(float* hbuf, int din, const float* Wt,
                                     const float* b, int dout, bool logits,
                                     float scale) {
  constexpr int G = TILE_RAYS / RP;
  const int j = threadIdx.x;
  const int unit = j % dout, grp = j / dout;
  const bool on = grp < G;
  float* rows = hbuf + (on ? grp : 0) * RP * TILE_LD;
  float acc[RP];
#pragma unroll
  for (int r = 0; r < RP; ++r) acc[r] = 0.f;
  if (on) {
    if (din % 4 == 0) {
      for (int k = 0; k < din; k += 4) {
        const float w0 = __ldg(Wt + (long long)k * dout + unit);
        const float w1 = __ldg(Wt + (long long)(k + 1) * dout + unit);
        const float w2 = __ldg(Wt + (long long)(k + 2) * dout + unit);
        const float w3 = __ldg(Wt + (long long)(k + 3) * dout + unit);
#pragma unroll
        for (int r = 0; r < RP; ++r) {
          const float4 h4 =
              *reinterpret_cast<const float4*>(rows + r * TILE_LD + k);
          float a = acc[r];
          a = fmaf(h4.x, w0, a);
          a = fmaf(h4.y, w1, a);
          a = fmaf(h4.z, w2, a);
          a = fmaf(h4.w, w3, a);
          acc[r] = a;
        }
      }
    } else {
      for (int k = 0; k < din; ++k) {
        const float w = __ldg(Wt + (long long)k * dout + unit);
#pragma unroll
        for (int r = 0; r < RP; ++r)
          acc[r] = fmaf(rows[r * TILE_LD + k], w, acc[r]);
      }
    }
  }
  __syncthreads();        // every read of the layer's input is done
  if (on) {
    const float bb = __ldg(b + unit);
#pragma unroll
    for (int r = 0; r < RP; ++r) {
      const float z = acc[r] + bb;
      rows[r * TILE_LD + unit] = logits ? z * scale : softplus100(z);
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void tile_dense(float* hbuf, int din,
                                           const float* Wt, const float* b,
                                           int dout, bool logits,
                                           float scale) {
  if (2 * dout <= TILE_THREADS)
    tile_dense_rp<TILE_RAYS / 2>(hbuf, din, Wt, b, dout, logits, scale);
  else
    tile_dense_rp<TILE_RAYS>(hbuf, din, Wt, b, dout, logits, scale);
}

// The generated SIREN's hidden layers over the tile: hbuf [ray][TILE_LD]
// holds the normalised inputs (3 columns) and, on return, the last hidden
// activations. The forward is h <- sin(30 (f (h W^T + b) + p)) as
// siren_apply, with exact sinf.
static __device__ void tile_siren_hidden(float* hbuf,
                                         const float* __restrict__ P,
                                         const NetMeta& m) {
  const int H = m.hidden, L = m.n_layers, j = threadIdx.x;
  for (int i = 0; i < L - 1; ++i) {
    const float* Wt = P + m.wt_off[i];
    float acc[TILE_RAYS];
#pragma unroll
    for (int p = 0; p < TILE_RAYS; ++p) acc[p] = 0.f;
    if (j < H) {
      if (i == 0) {
        for (int k = 0; k < 3; ++k) {
          const float w = __ldg(Wt + (long long)k * H + j);
#pragma unroll
          for (int p = 0; p < TILE_RAYS; ++p)
            acc[p] = fmaf(hbuf[p * TILE_LD + k], w, acc[p]);
        }
      } else {
        for (int k = 0; k < H; k += 4) {
          const float w0 = __ldg(Wt + (long long)k * H + j);
          const float w1 = __ldg(Wt + (long long)(k + 1) * H + j);
          const float w2 = __ldg(Wt + (long long)(k + 2) * H + j);
          const float w3 = __ldg(Wt + (long long)(k + 3) * H + j);
#pragma unroll
          for (int p = 0; p < TILE_RAYS; ++p) {
            const float4 h4 =
                *reinterpret_cast<const float4*>(hbuf + p * TILE_LD + k);
            float a = acc[p];
            a = fmaf(h4.x, w0, a);
            a = fmaf(h4.y, w1, a);
            a = fmaf(h4.z, w2, a);
            a = fmaf(h4.w, w3, a);
            acc[p] = a;
          }
        }
      }
    }
    __syncthreads();      // every read of hbuf for this layer is done
    if (j < H) {
      const float b = __ldg(P + m.b_off[i] + j);
      const float f = m.film ? __ldg(P + m.freq_off + (long long)i * H + j)
                             : 1.f;
      const float ph = m.film ? __ldg(P + m.phase_off + (long long)i * H + j)
                              : 0.f;
#pragma unroll
      for (int p = 0; p < TILE_RAYS; ++p) {
        float z = acc[p] + b;
        if (m.film) z = f * z + ph;
        hbuf[p * TILE_LD + j] = sinf(30.f * z);
      }
    }
    __syncthreads();
  }
}

// One output unit of ray p = threadIdx.x / 16 from its last hidden row:
// the 16 lanes of the ray take strided units of the weight row wrow (H),
// then a shuffle sum; every lane returns the sum (bias not added).
static_assert(TILE_RAYS * 16 == TILE_THREADS, "16 lanes per ray");
__device__ __forceinline__ float tile_row_dot(const float* hbuf,
                                              const float* __restrict__ wrow,
                                              int H) {
  const int p = threadIdx.x >> 4, lane = threadIdx.x & 15;
  float a = 0.f;
  for (int k = lane; k < H; k += 16)
    a = fmaf(hbuf[p * TILE_LD + k], __ldg(wrow + k), a);
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o, 16);
  return a;
}

// The generated SIREN (one output) over the tile: hbuf as for
// tile_siren_hidden; writes the raw (normalised) SDF of ray p to sdf[p].
static __device__ void tile_siren(float* hbuf, const float* __restrict__ P,
                                  const NetMeta& m, float* sdf) {
  tile_siren_hidden(hbuf, P, m);
  const float a = tile_row_dot(hbuf, P + m.wl_off, m.hidden);
  if ((threadIdx.x & 15) == 0)
    sdf[threadIdx.x >> 4] = a + __ldg(P + m.b_off[m.n_layers - 1]);
  __syncthreads();
}
