// Kernel G: the exact forward-skinning Jacobian d fwd_skin / d x_hat at
// given canonical points, for the training step's implicit-diff
// correction. No gradient flows through it (the renderer stops it).
//
// Replaces the TPU kernel arah_tpu/ops/pallas/corr_kernel_t.py:
// skinning_jac_pallas (body _make_jac_kernel): the collapsed skinning MLP
// (softplus100 hidden layers) at x_norm = x * nscale + noff, the
// hierarchical softmax of the scaled logits, the bone blend T = sum_b w_b
// B_b and LBS xb = T[:3,:3] x + T[:3,3], differentiated forward along the
// three input axes: J[i][k] = d xb_i / d x_k.
//
// Bound on the H100: operations. A point costs the MLP's multiply-adds
// four times (the primal and three tangents: 4 x (3x128 + 3x128x128 +
// 128x25) ~ 0.21 M at the flagship) against 12 B in and 36 B out.
//
// Design: C's tile (tile_mlp.cuh): 256 threads over 16 points. The three
// tangents ride along the primal as 48 more rows of one 64-row tile, so
// each layer is one product of the same weights with 64 rows in shared
// memory (ping-pong buffers, [row][unit]); each thread owns one unit of a
// contiguous block of rows, so every weight it loads from L2 feeds up to
// 32 FMAs. A second pass adds the bias to the primal rows and scales the
// tangent rows by softplus100' of the primal pre-activation
// (sigmoid(100 z), exactly 1 above the linear threshold, as JAX's
// derivative of its `where`). The softmax, blend and LBS run per point
// with their tangents in f32; exact expf/log1pf, no fast math. Any N: the
// last tile is masked. No reduction.
#include "tile_mlp.cuh"

#define SJ_PTS TILE_RAYS            // points per tile
#define SJ_ROWS (4 * SJ_PTS)        // row t * SJ_PTS + p: t = 0 primal,
                                    // t = 1 + k the tangent along x_k
#define SJ_CHUNK 32                 // rows per accumulator pass

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

__global__ void __launch_bounds__(TILE_THREADS)
skin_jac_kernel(const float* __restrict__ x_g, int n,
                const float* __restrict__ bones_g,
                const float* __restrict__ frame_g,
                const float* __restrict__ P, NetMeta m, int ld,
                float softmax_scale, float* __restrict__ jac_out) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float bones[N_BONES * 16];
  __shared__ float xs[SJ_PTS][3];
  __shared__ float s_w[SJ_PTS][N_BONES];
  __shared__ float s_dw[3][SJ_PTS][N_BONES];
  __shared__ float s_T[SJ_PTS][16];
  __shared__ float s_dT[3][SJ_PTS][16];
  float* cur = smem;                       // [SJ_ROWS][ld]
  float* nxt = smem + SJ_ROWS * ld;
  const int j = threadIdx.x;
  const int p0 = blockIdx.x * SJ_PTS;
  const FrameAffine fa = frame_affine(frame_g);

  for (int k = j; k < N_BONES * 16; k += blockDim.x) bones[k] = bones_g[k];
  if (j < SJ_PTS * 3) {
    const int p = j / 3, c = j % 3;
    xs[p][c] = (p0 + p < n) ? x_g[(long long)(p0 + p) * 3 + c] : 0.f;
  }
  __syncthreads();
  if (j < SJ_ROWS * 3) {
    const int r = j / 3, c = j % 3, t = r / SJ_PTS, p = r % SJ_PTS;
    cur[r * ld + c] = (t == 0) ? xs[p][c] * fa.nscale + fa.noff[c]
                               : ((c == t - 1) ? fa.nscale : 0.f);
  }
  __syncthreads();

  for (int l = 0; l < m.n_skin; ++l) {
    const int din = m.skin_dims[l], dout = m.skin_dims[l + 1];
    const bool logits = (l == m.n_skin - 1);
    const float* Wt = P + m.skin_wt_off[l];      // (din, dout)
    const int G = TILE_THREADS / dout;            // groups of dout threads
    const int unit = j % dout, grp = j / dout;
    const int R = (SJ_ROWS + G - 1) / G;
    if (grp < G) {
      const int r_end = min(SJ_ROWS, (grp + 1) * R);
      for (int c0 = grp * R; c0 < r_end; c0 += SJ_CHUNK) {
        const int nr = min(SJ_CHUNK, r_end - c0);
        float acc[SJ_CHUNK];
#pragma unroll
        for (int r = 0; r < SJ_CHUNK; ++r) acc[r] = 0.f;
        for (int k = 0; k < din; ++k) {
          const float w = __ldg(Wt + (long long)k * dout + unit);
#pragma unroll
          for (int r = 0; r < SJ_CHUNK; ++r)
            if (r < nr) acc[r] = fmaf(cur[(c0 + r) * ld + k], w, acc[r]);
        }
#pragma unroll
        for (int r = 0; r < SJ_CHUNK; ++r)
          if (r < nr) nxt[(c0 + r) * ld + unit] = acc[r];
      }
    }
    __syncthreads();
    // bias and activation: one thread per (point, unit) owns its 4 rows
    const float* b = P + m.skin_b_off[l];
    for (int e = j; e < SJ_PTS * dout; e += blockDim.x) {
      const int p = e / dout, u = e % dout;
      const float z = nxt[p * ld + u] + __ldg(b + u);
      if (logits) {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float v = t == 0 ? z : nxt[(t * SJ_PTS + p) * ld + u];
          nxt[(t * SJ_PTS + p) * ld + u] = v * softmax_scale;
        }
      } else {
        const float bz = 100.f * z;
        float d = 1.f;
        if (!(bz > 20.f)) {
          const float ez = expf(bz);
          d = ez / (1.f + ez);
        }
        nxt[p * ld + u] = softplus100(z);
#pragma unroll
        for (int t = 1; t < 4; ++t) nxt[(t * SJ_PTS + p) * ld + u] *= d;
      }
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  // hierarchical softmax and its three tangents: thread (k, p)
  if (j < 3 * SJ_PTS) {
    const int k = j / SJ_PTS, p = j % SJ_PTS;
    float w[N_BONES], dw[N_BONES];
    hier_softmax_jvp(cur + p * ld, cur + ((1 + k) * SJ_PTS + p) * ld, w, dw);
#pragma unroll
    for (int bb = 0; bb < N_BONES; ++bb) {
      s_dw[k][p][bb] = dw[bb];
      if (k == 0) s_w[p][bb] = w[bb];
    }
  }
  __syncthreads();
  // bone blend of the weights and of their tangents
  for (int e = j; e < 4 * SJ_PTS * 16; e += blockDim.x) {
    const int t = e / (SJ_PTS * 16), p = (e / 16) % SJ_PTS, q = e % 16;
    const float* wv = t == 0 ? s_w[p] : s_dw[t - 1][p];
    float s = 0.f;
#pragma unroll
    for (int bb = 0; bb < N_BONES; ++bb)
      s = fmaf(wv[bb], bones[bb * 16 + q], s);
    if (t == 0)
      s_T[p][q] = s;
    else
      s_dT[t - 1][p][q] = s;
  }
  __syncthreads();
  // LBS tangent: d xb_i / d x_k = T[i][k] + sum_c dT_k[i][c] x_c + dT_k[i][3]
  if (j < SJ_PTS * 9) {
    const int p = j / 9, i = (j % 9) / 3, k = j % 3;
    if (p0 + p < n) {
      const float* dT = s_dT[k][p];
      const float v = s_T[p][4 * i + k] + dT[4 * i] * xs[p][0]
                      + dT[4 * i + 1] * xs[p][1] + dT[4 * i + 2] * xs[p][2]
                      + dT[4 * i + 3];
      jac_out[(long long)(p0 + p) * 9 + 3 * i + k] = v;
    }
  }
}

extern "C" int arah_skin_jac(const float* x, int n, const float* bones16,
                             const float* frame, const float* params,
                             NetMeta m, float softmax_scale, float* jac,
                             void* stream) {
  if (n <= 0) return 0;
  int ld = 0;
  for (int l = 0; l <= m.n_skin; ++l) ld = max(ld, m.skin_dims[l]);
  ld = (ld + 3) & ~3;
  const size_t smem = (size_t)2 * SJ_ROWS * ld * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      skin_jac_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (n + SJ_PTS - 1) / SJ_PTS;
  skin_jac_kernel<<<blocks, TILE_THREADS, smem, (cudaStream_t)stream>>>(
      x, n, bones16, frame, params, m, ld, softmax_scale, jac);
  return launch_status();
}
