// The exact forward-skinning Jacobian d fwd_skin / d x_hat of a tile of
// canonical points, as three forward-mode tangent chains beside the primal:
// kernel G (csrc/skin_jac.cu) runs it over its points, kernel B
// (csrc/corr_rows.cu) under want_jac on the points its slots retire. The
// collapsed skinning MLP (softplus100 hidden layers) at x_norm = x * nscale
// + noff, the hierarchical softmax of the scaled logits, the bone blend T =
// sum_b w_b B_b and LBS xb = T[:3,:3] x + T[:3,3], differentiated along the
// three input axes: J[i][k] = d xb_i / d x_k (corr_kernel_t.py:
// _make_jac_kernel and want_jac).
//
// The tile: JT points on NTH threads. Each layer is one (4 JT rows x din) .
// (din x dout) f32 product of the same weights, written as an SGEMM tile:
// - Row 4p + t is point p's primal (t = 0) or its tangent along x_{t-1}.
//   The activations live in shared memory k-major, act[k][row], so a
//   thread's 4 rows of one k are one float4.
// - The layer's (din, dout) weights, dout zero-padded to a multiple of 32
//   (the 25 logits -> 32: exact zeros; ops/march.py:put_skin_padded), are
//   read from `ws`: G stages each layer whole in shared memory with
//   cp.async (STAGED; the next layer's copy in flight during this layer's
//   epilogue), B reads them from the pack in L2.
// - Thread (p, g) computes its point's 4 rows x UN units from unit UN g:
//   NTH / JT unit groups of SJ_MAXW JT / NTH units (8 in G: 16 points on
//   256 threads; 4 in B) for the hidden layers, 8 groups of 4 for the
//   padded logits. Per k, one
//   LDS.128 of activations and UN / 4 of weights feed 4 UN FMAs. Each
//   output's sum runs over k in order from 0, as a thread-per-unit loop
//   sums it. Under B's precision every layer after the first takes B's
//   products (tile_mlp.cuh:PREC_*), on the primal and on each tangent
//   alike, as the TPU kernel's jvp runs its tangents through the same
//   layer_dot: split3's split where read, bf16's rounding where written.
// - The epilogue holds a point's primal and its tangents of a unit in one
//   thread: it adds the bias to the primal, applies softplus100 and scales
//   the tangents by softplus100' = sigmoid(100 z) (exactly 1 above the
//   linear threshold, as JAX's derivative of its `where`), and writes the
//   four back in place (the product's reads are done) as one float4; the
//   logits, scaled, go to the same buffer row-major for the softmax.
// The softmax, blend and LBS run per point with their tangents in f32,
// the softmax on 3 JT threads (a point's three tangents); exact
// expf/log1pf, no fast math.
#pragma once

#include "tile_mlp.cuh"

#define SJ_MAXW 128                 // widest (padded) layer
#define SJ_LDL 33                   // row stride of the logits rows (odd:
                                    // the softmax's reads miss no bank)

__host__ __device__ inline int sj_pad(int d) { return (d + 31) & ~31; }

// A tile's per-point state: its points (x, and the row of jac_out each
// writes, -1 for none), the weights and transforms with their tangents
// (the weights again in pw for the softmax threads of tangents 1 and 2).
template <int JT>
struct SjScratch {
  float xs[JT][3];
  int idx[JT];
  float w[JT][N_BONES];
  float pw[2][JT][N_BONES];
  float dw[3][JT][N_BONES];
  float T[JT][16];
  float dT[3][JT][16];
};

// Floats of a tile's activations (act[SJ_MAXW][4 JT]; the logits rows
// reuse them).
template <int JT>
__host__ __device__ constexpr int sj_act_floats() {
  return SJ_MAXW * 4 * JT;
}

// Start the copy of layer l's (din, pad(dout)) weights into ws.
__device__ __forceinline__ void sj_stage_w(float* ws,
                                           const float* __restrict__ P,
                                           const NetMeta& m, int l) {
  const float* src = P + m.skin_wt_off[l];
  const int n4 = m.skin_dims[l] * sj_pad(m.skin_dims[l + 1]) / 4;
  for (int i = threadIdx.x; i < n4; i += blockDim.x)
    cp_async16(ws + 4 * i, src + 4 * i);
}

// acc[t][j] = sum over k < din, in order, of act[k][4p + t] ws[k][u0 + j]
// (SPLIT3: split3's products).
template <int UN, int JT, bool SPLIT3>
__device__ __forceinline__ void sj_product(const float* act, const float* ws,
                                           int din, int ldw, int p, int u0,
                                           float (&acc)[4][UN]) {
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int j = 0; j < UN; ++j) acc[t][j] = 0.f;
  const float* a = act + 4 * p;
  const float* w = ws + u0;
#pragma unroll 4
  for (int k = 0; k < din; ++k) {
    const float4 x4 = *reinterpret_cast<const float4*>(a + k * 4 * JT);
    const float x[4] = {x4.x, x4.y, x4.z, x4.w};
    float wv[UN];
#pragma unroll
    for (int q = 0; q < UN / 4; ++q) {
      const float4 w4 =
          *reinterpret_cast<const float4*>(w + k * ldw + 4 * q);
      wv[4 * q] = w4.x;
      wv[4 * q + 1] = w4.y;
      wv[4 * q + 2] = w4.z;
      wv[4 * q + 3] = w4.w;
    }
    if constexpr (!SPLIT3) {
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int j = 0; j < UN; ++j) acc[t][j] = fmaf(x[t], wv[j], acc[t][j]);
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float hi = bf16r(x[t]), lo = bf16r(x[t] - hi);
#pragma unroll
        for (int j = 0; j < UN; ++j)
          acc[t][j] = split3_fma(wv[j], hi, lo, acc[t][j]);
      }
    }
  }
}

// Hierarchical softmax (tile_mlp.cuh:hier_softmax) and its tangent dp
// along the logit tangent dc. The maxima only stabilise the exponentials
// and cancel in every ratio, so their tangent is taken as 0.
static __device__ void hier_softmax_jvp(const float* c, const float* dc,
                                        float* p, float* dp) {
  const float m_hip = fmaxf(fmaxf(c[1], c[2]), c[3]);
  float e[3], de[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    e[i] = expf(c[1 + i] - m_hip);
    de[i] = e[i] * dc[1 + i];
  }
  const float den = e[0] + e[1] + e[2], dden = de[0] + de[1] + de[2];
  const float g = sigm(c[0]), dg = g * (1.f - g) * dc[0];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float q = g * e[i], dq = dg * e[i] + g * de[i];
    p[1 + i] = q / den;
    dp[1 + i] = dq / den - q * dden / (den * den);
  }
  p[0] = 1.f - g;
  dp[0] = -dg;
  const int ch1[8] = {4, 5, 6, 7, 8, 9, 10, 11};
  const int pa1[8] = {1, 2, 3, 4, 5, 6, 7, 8};
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const float s = sigm(c[ch1[t]]), ds = s * (1.f - s) * dc[ch1[t]];
    const float pp = p[pa1[t]], dpp = dp[pa1[t]];
    p[ch1[t]] = pp * s;
    dp[ch1[t]] = dpp * s + pp * ds;
    p[pa1[t]] = pp * (1.f - s);
    dp[pa1[t]] = dpp * (1.f - s) - pp * ds;
  }
  const float sg = sigm(c[24]), dsg = sg * (1.f - sg) * dc[24];
  const float m_sp = fmaxf(fmaxf(c[12], c[13]), c[14]);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    e[i] = expf(c[12 + i] - m_sp);
    de[i] = e[i] * dc[12 + i];
  }
  const float dens = e[0] + e[1] + e[2], ddens = de[0] + de[1] + de[2];
  const float p9 = p[9], dp9 = dp[9];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float q = p9 * sg * e[i];
    const float dq = dp9 * sg * e[i] + p9 * dsg * e[i] + p9 * sg * de[i];
    p[12 + i] = q / dens;
    dp[12 + i] = dq / dens - q * ddens / (dens * dens);
  }
  p[9] = p9 * (1.f - sg);
  dp[9] = dp9 * (1.f - sg) - p9 * dsg;
  const int ch2[9] = {15, 16, 17, 18, 19, 20, 21, 22, 23};
  const int pa2[9] = {12, 13, 14, 16, 17, 18, 19, 20, 21};
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    const float s = sigm(c[ch2[t]]), ds = s * (1.f - s) * dc[ch2[t]];
    const float pp = p[pa2[t]], dpp = dp[pa2[t]];
    p[ch2[t]] = pp * s;
    dp[ch2[t]] = dpp * s + pp * ds;
    p[pa2[t]] = pp * (1.f - s);
    dp[pa2[t]] = dpp * (1.f - s) - pp * ds;
  }
}

// J of the tile's points (s.xs, metric canonical) into jac_out rows
// s.idx (3 x 3 each, [i][k] = d xb_i / d x_k at 3 i + k; -1: not
// written). Every thread of the block calls it, after a barrier that
// publishes s.xs, s.idx and `bones`; the first NTH work. act:
// sj_act_floats<JT>() floats of shared memory; ws: under STAGED a shared
// buffer of the widest layer's padded weights, layer 0's copy already
// issued (sj_stage_w), else unused (the weights are read from P). PM: the
// precision of the layers after the first (PREC_*).
template <int JT, int NTH, int PM, bool STAGED>
__device__ void skin_jac_tile(float* act, float* ws, SjScratch<JT>& s,
                              const float* bones,
                              const float* __restrict__ P, const NetMeta& m,
                              const FrameAffine& fa, float softmax_scale,
                              float* __restrict__ jac_out) {
  constexpr int ROWS = 4 * JT, NG = NTH / JT, UNH = SJ_MAXW / NG;
  static_assert(UNH % 4 == 0 && 8 <= NG, "float4 weight loads, 8 groups");
  static_assert(ROWS * SJ_LDL <= SJ_MAXW * ROWS, "logits fit in act");
  const int j = threadIdx.x;
  const bool on_t = j < NTH;
  const int pt = j % JT, grp = j / JT;   // the thread's point, unit group
  if (j < ROWS * 3) {
    const int r = j / 3, c = j % 3, p = r / 4, t = r % 4;
    act[c * ROWS + r] = (t == 0) ? s.xs[p][c] * fa.nscale + fa.noff[c]
                                 : ((c == t - 1) ? fa.nscale : 0.f);
  }
  if constexpr (STAGED) cp_async_wait_all();
  __syncthreads();

  const int L = m.n_skin;
  for (int l = 0; l < L; ++l) {
    const int din = m.skin_dims[l], dout = m.skin_dims[l + 1];
    const int ldw = sj_pad(dout);
    const float* b = P + m.skin_b_off[l];
    const float* W = STAGED ? ws : P + m.skin_wt_off[l];
    const bool split = PM == PREC_SPLIT3 && l > 0;
    if (l < L - 1) {
      // hidden: softplus100 on the primal, its derivative on the tangents
      const bool on = on_t && UNH * grp < ldw;
      float acc[4][UNH];
      if (on) {
        if (split)
          sj_product<UNH, JT, true>(act, W, din, ldw, pt, UNH * grp, acc);
        else
          sj_product<UNH, JT, false>(act, W, din, ldw, pt, UNH * grp, acc);
      }
      __syncthreads();                   // every read of act and ws is done
      if constexpr (STAGED) sj_stage_w(ws, P, m, l + 1);
      if (on) {
#pragma unroll
        for (int u8 = 0; u8 < UNH; ++u8) {
          const int u = UNH * grp + u8;
          const float z = acc[0][u8] + __ldg(b + u);
          const float bz = 100.f * z;
          float d = 1.f;
          if (!(bz > 20.f)) {
            const float ez = expf(bz);
            d = ez / (1.f + ez);
          }
          float4 h = make_float4(softplus100(z), acc[1][u8] * d,
                                 acc[2][u8] * d, acc[3][u8] * d);
          if constexpr (PM == PREC_BF16)     // the next layer's operands
            h = make_float4(bf16r(h.x), bf16r(h.y), bf16r(h.z), bf16r(h.w));
          *reinterpret_cast<float4*>(act + u * ROWS + 4 * pt) = h;
        }
      }
    } else {
      // the logits, scaled: row t * JT + p of stride SJ_LDL
      const bool on = on_t && 4 * grp < ldw;
      float acc[4][4];
      if (on) {
        if (split)
          sj_product<4, JT, true>(act, W, din, ldw, pt, 4 * grp, acc);
        else
          sj_product<4, JT, false>(act, W, din, ldw, pt, 4 * grp, acc);
      }
      __syncthreads();
      if (on) {
#pragma unroll
        for (int u4 = 0; u4 < 4; ++u4) {
          const int u = 4 * grp + u4;
          if (u >= dout) continue;
          const float z = acc[0][u4] + __ldg(b + u);
          act[pt * SJ_LDL + u] = z * softmax_scale;
#pragma unroll
          for (int t = 1; t < 4; ++t)
            act[(t * JT + pt) * SJ_LDL + u] = acc[t][u4] * softmax_scale;
        }
      }
    }
    if constexpr (STAGED) cp_async_wait_all();
    __syncthreads();
  }

  // hierarchical softmax and its three tangents: thread (k, p), its
  // weights and their tangent straight into shared memory (no registers
  // held for the 2 x 24 of them)
  if (j < 3 * JT) {
    const int k = j / JT, p = j % JT;
    hier_softmax_jvp(act + p * SJ_LDL, act + ((1 + k) * JT + p) * SJ_LDL,
                     k == 0 ? s.w[p] : s.pw[k - 1][p], s.dw[k][p]);
  }
  __syncthreads();
  // bone blend of the weights and of their tangents
  for (int e = j; e < 4 * JT * 16; e += blockDim.x) {
    const int t = e / (JT * 16), p = (e / 16) % JT, q = e % 16;
    const float* wv = t == 0 ? s.w[p] : s.dw[t - 1][p];
    float v = 0.f;
#pragma unroll
    for (int bb = 0; bb < N_BONES; ++bb)
      v = fmaf(wv[bb], bones[bb * 16 + q], v);
    if (t == 0)
      s.T[p][q] = v;
    else
      s.dT[t - 1][p][q] = v;
  }
  __syncthreads();
  // LBS tangent: d xb_i / d x_k = T[i][k] + sum_c dT_k[i][c] x_c + dT_k[i][3]
  if (j < JT * 9) {
    const int p = j / 9, i = (j % 9) / 3, k = j % 3;
    if (s.idx[p] >= 0) {
      const float* dT = s.dT[k][p];
      const float v = s.T[p][4 * i + k] + dT[4 * i] * s.xs[p][0]
                      + dT[4 * i + 1] * s.xs[p][1]
                      + dT[4 * i + 2] * s.xs[p][2] + dT[4 * i + 3];
      jac_out[(long long)s.idx[p] * 9 + 3 * i + k] = v;
    }
  }
  __syncthreads();
}
