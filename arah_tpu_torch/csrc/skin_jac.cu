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
// 128x25) ~ 0.21 M at the flagship) against 12 B in and 36 B out. G stays
// f32, as the reference is: FMA on the CUDA cores, never TF32.
//
// Design: a block of 256 threads owns SJ_PTS = 16 points. The three
// tangents ride along the primal, so each layer is one (64 rows x din) .
// (din x dout) f32 product of the same weights, written as an SGEMM tile:
// - Row 4p + t is point p's primal (t = 0) or its tangent along x_{t-1}.
//   The activations live in shared memory k-major, act[k][row], so a
//   thread's 4 rows of one k are one float4.
// - The layer's (din, dout) weights, dout zero-padded to a multiple of 32
//   (the 25 logits -> 32: exact zeros; ops/skin_jac.py:pack_skin_jac), are
//   staged whole in shared memory with cp.async (64 KB at 128 x 128); the
//   next layer's copy is in flight during this layer's epilogue.
// - Thread (p, g) computes its point's 4 rows x UN units from unit UN g:
//   UN = 8 on all 256 threads for the hidden layers, 4 on 128 threads for
//   the padded logits. Per k, one LDS.128 of activations and UN / 4 of
//   weights feed 4 UN FMAs (32 or 16: 8 or more a shared load). Each
//   output's sum runs over k in order from 0, as a thread-per-unit loop
//   sums it.
// - The epilogue holds a point's primal and its tangents of a unit in one
//   thread: it adds the bias to the primal, applies softplus100 and scales
//   the tangents by softplus100' = sigmoid(100 z) (exactly 1 above the
//   linear threshold, as JAX's derivative of its `where`), and writes the
//   four back in place (the product's reads are done) as one float4; the
//   logits, scaled, go to the same buffer row-major for the softmax.
// The softmax, blend and LBS run per point with their tangents in f32,
// the softmax on 48 threads (a point's three tangents); exact
// expf/log1pf, no fast math. Shared memory: 32 KB of activations, 64 KB
// of weights and ~12 KB static, two blocks per SM. Any N: the last tile
// is masked. No reduction.
#include "tile_mlp.cuh"

#define SJ_THREADS 256              // threads per block
#define SJ_PTS 16                   // points per tile
#define SJ_ROWS (4 * SJ_PTS)        // row 4p + t: t = 0 primal, t = 1 + k
                                    // the tangent along x_k
#define SJ_MAXW 128                 // widest (padded) layer
#define SJ_LDL 33                   // row stride of the logits rows (odd:
                                    // the softmax's reads miss no bank)

static_assert(SJ_PTS * 16 == SJ_THREADS, "16 unit groups of 16 points");
static_assert(SJ_ROWS * SJ_LDL <= SJ_MAXW * SJ_ROWS, "logits fit in act");

__host__ __device__ inline int sj_pad(int d) { return (d + 31) & ~31; }

// Start the copy of layer l's (din, pad(dout)) weights into ws.
__device__ __forceinline__ void sj_stage_w(float* ws,
                                           const float* __restrict__ P,
                                           const NetMeta& m, int l) {
  const float* src = P + m.skin_wt_off[l];
  const int n4 = m.skin_dims[l] * sj_pad(m.skin_dims[l + 1]) / 4;
  for (int i = threadIdx.x; i < n4; i += blockDim.x)
    cp_async16(ws + 4 * i, src + 4 * i);
}

// acc[t][j] = sum over k < din, in order, of act[k][4p + t] ws[k][u0 + j].
template <int UN>
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
    const float4 x4 = *reinterpret_cast<const float4*>(a + k * SJ_ROWS);
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
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int j = 0; j < UN; ++j) acc[t][j] = fmaf(x[t], wv[j], acc[t][j]);
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

__global__ void __launch_bounds__(SJ_THREADS, 2)
skin_jac_kernel(const float* __restrict__ x_g, int n,
                const float* __restrict__ bones_g,
                const float* __restrict__ frame_g,
                const float* __restrict__ P, NetMeta m, float softmax_scale,
                float* __restrict__ jac_out) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float bones[N_BONES * 16];
  __shared__ float xs[SJ_PTS][3];
  __shared__ float s_w[SJ_PTS][N_BONES];
  __shared__ float s_dw[3][SJ_PTS][N_BONES];
  __shared__ float s_T[SJ_PTS][16];
  __shared__ float s_dT[3][SJ_PTS][16];
  float* act = smem;                       // [SJ_MAXW][SJ_ROWS]
  float* ws = smem + SJ_MAXW * SJ_ROWS;    // [din][pad(dout)]
  const int j = threadIdx.x;
  const int pt = j % SJ_PTS, grp = j / SJ_PTS;   // the thread's point and
                                                 // unit group
  const int p0 = blockIdx.x * SJ_PTS;
  const FrameAffine fa = frame_affine(frame_g);

  sj_stage_w(ws, P, m, 0);
  for (int k = j; k < N_BONES * 16; k += blockDim.x) bones[k] = bones_g[k];
  if (j < SJ_PTS * 3) {
    const int p = j / 3, c = j % 3;
    xs[p][c] = (p0 + p < n) ? x_g[(long long)(p0 + p) * 3 + c] : 0.f;
  }
  __syncthreads();
  if (j < SJ_ROWS * 3) {
    const int r = j / 3, c = j % 3, p = r / 4, t = r % 4;
    act[c * SJ_ROWS + r] = (t == 0) ? xs[p][c] * fa.nscale + fa.noff[c]
                                    : ((c == t - 1) ? fa.nscale : 0.f);
  }
  cp_async_wait_all();
  __syncthreads();

  const int L = m.n_skin;
  for (int l = 0; l < L; ++l) {
    const int din = m.skin_dims[l], dout = m.skin_dims[l + 1];
    const int ldw = sj_pad(dout);
    const float* b = P + m.skin_b_off[l];
    if (l < L - 1) {
      // hidden: softplus100 on the primal, its derivative on the tangents
      const bool on = 8 * grp < ldw;
      float acc[4][8];
      if (on) sj_product<8>(act, ws, din, ldw, pt, 8 * grp, acc);
      __syncthreads();                   // every read of act and ws is done
      sj_stage_w(ws, P, m, l + 1);
      if (on) {
#pragma unroll
        for (int u8 = 0; u8 < 8; ++u8) {
          const int u = 8 * grp + u8;
          const float z = acc[0][u8] + __ldg(b + u);
          const float bz = 100.f * z;
          float d = 1.f;
          if (!(bz > 20.f)) {
            const float ez = expf(bz);
            d = ez / (1.f + ez);
          }
          *reinterpret_cast<float4*>(act + u * SJ_ROWS + 4 * pt) =
              make_float4(softplus100(z), acc[1][u8] * d, acc[2][u8] * d,
                          acc[3][u8] * d);
        }
      }
    } else {
      // the logits, scaled: row t * SJ_PTS + p of stride SJ_LDL
      const bool on = 4 * grp < ldw;
      float acc[4][4];
      if (on) sj_product<4>(act, ws, din, ldw, pt, 4 * grp, acc);
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
            act[(t * SJ_PTS + pt) * SJ_LDL + u] = acc[t][u4] * softmax_scale;
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }

  // hierarchical softmax and its three tangents: thread (k, p)
  if (j < 3 * SJ_PTS) {
    const int k = j / SJ_PTS, p = j % SJ_PTS;
    float w[N_BONES], dw[N_BONES];
    hier_softmax_jvp(act + p * SJ_LDL, act + ((1 + k) * SJ_PTS + p) * SJ_LDL,
                     w, dw);
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

// Bytes of dynamic shared memory a block of kernel G takes: the
// activations and the widest layer's padded weights.
static size_t skin_jac_smem(const NetMeta& m) {
  int w = 0;
  for (int l = 0; l < m.n_skin; ++l)
    w = max(w, m.skin_dims[l] * sj_pad(m.skin_dims[l + 1]));
  return (size_t)(SJ_MAXW * SJ_ROWS + w) * sizeof(float);
}

extern "C" long long arah_skin_jac_smem(NetMeta m) {
  return (long long)skin_jac_smem(m);
}

// J (n, 3, 3) at x (n, 3). `params`: ops/skin_jac.py:pack_skin_jac (each
// layer's (in, pad32(out)) weights and padded bias, 16-byte aligned);
// widths 3, ..., 25 with hidden widths of at most SJ_MAXW.
extern "C" int arah_skin_jac(const float* x, int n, const float* bones16,
                             const float* frame, const float* params,
                             NetMeta m, float softmax_scale, float* jac,
                             void* stream) {
  if (n <= 0) return 0;
  const size_t smem = skin_jac_smem(m);
  cudaError_t e = cudaFuncSetAttribute(
      skin_jac_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (n + SJ_PTS - 1) / SJ_PTS;
  skin_jac_kernel<<<blocks, SJ_THREADS, smem, (cudaStream_t)stream>>>(
      x, n, bones16, frame, params, m, softmax_scale, jac);
  return launch_status();
}
