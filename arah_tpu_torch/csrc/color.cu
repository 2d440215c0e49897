// Kernel D: fused colour-MLP forward.
//
// Replaces the TPU kernel arah_tpu/ops/pallas/color_kernel.py:
// _color_fwd_pallas (body _color_fwd_kernel, wrapper color_mlp_fused): a
// ReLU MLP whose layer 0 and skip layer take x0 = [small | feats | pose]
// as per-component partial products, so the (N, 417) input block is never
// built; a sigmoid at the end.
//
// Bound on the H100: operations. A point costs ~417x256 + 256x256 +
// 256x128 + 545x256 + 256x256 + 256x3 ~ 0.42M multiply-adds against
// ~1.2 KB of inputs (small 33 + feats 256 floats) and 12 B out.
//
// Design: D is the forward chain that kernel I recomputes, on the same
// device functions (color_stage, color_hidden, color_last_z below). A
// block of 256 threads (8 warps) colours a tile of 16 D_MT points; the
// tile's small and feats rows, two hidden-activation rows (ping-pong) and
// the pose row live in shared memory, so neither the concatenated input
// nor any activation reaches device memory. Each hidden layer starts from
// its bias rows and adds its parts in the order of _recompute_chain (x,
// small, feats, pose), then ReLU (and the bf16 rounding under
// bf16_shading).
// - Under bf16_shading every operand of the products is a bf16 value
//   (rows rounded when staged or written, weights from
//   ops/color.py:pack_color_bf16, the pack kernel I reads), so the x,
//   small and feats parts run on the tensor cores (mma.cuh:prod_mma:
//   mma.sync bf16, f32 sums), each weight a warp streams from L2 feeding
//   the tile's 16 D_MT points. D_MT = 2: 32 points, 109 KB at the
//   flagship, two blocks per SM (64 points at one block per SM measured
//   slower on the H100).
// - The pose part is one row for the whole call: its sum for each hidden
//   unit is computed once, before the tiles, by color_pose_sums (a tile
//   summing it again would wait on 128 serial L2 loads a layer). The
//   3-wide last layer (one thread per (point, output), then the sigmoid
//   with expf) stays on the CUDA cores, as does every product of the f32
//   launch (thread = unit, each weight loaded from L2 feeding 32 FMAs;
//   never TF32).
// - The feats rows are staged 16 bytes a load (8 bf16 or 4 f32).
#include "atb.cuh"
#include "common.cuh"
#include "mma.cuh"

#define COLOR_THREADS 256
#define MAX_LAYERS 8
#define MAX_COMP 4
#define D_MT 2                     // D's tile: 16 D_MT points

enum { C_X = 0, C_SMALL = 1, C_FEATS = 2, C_POSE = 3 };

struct ColorMeta {
  int n_layers, S, F, P, hmax, squeeze, bf16, feats_bf16;
  int out[MAX_LAYERS];
  int n_comp[MAX_LAYERS];
  int kind[MAX_LAYERS][MAX_COMP];
  int width[MAX_LAYERS][MAX_COMP];
  long long w_off[MAX_LAYERS][MAX_COMP];  // (width, out) transposed blocks
  long long b_off[MAX_LAYERS];
  // the backward (kernel I) only:
  int start[MAX_LAYERS][MAX_COMP];        // first input column of each part
  long long wo_off[MAX_LAYERS];           // full (out, in) weights
  long long g_off[MAX_LAYERS];            // dW (out, in) in the gradients
  long long gb_off[MAX_LAYERS];           // db in the gradients
  long long gpose_off;                    // dpose (P) in the gradients
  long long gs_off[MAX_LAYERS];           // S_l = sum of rounded tile
                                          // colsums (layers with pose)
  int wd_off[MAX_LAYERS];                 // workspace columns a point: delta
  int wx_off[MAX_LAYERS];                 // and the x input of each layer
  int ws_cols;                            // workspace columns a point
  // under bf16, in the bf16 weight copy: each x, small and feats part of
  // the hidden layers as (out, pad32(width)) and transposed
  long long wf_off[MAX_LAYERS][MAX_COMP];
  long long wb_off[MAX_LAYERS][MAX_COMP];
};

// Partial dot of one component for one output unit `o` over `np` points
// (acc[p] for p < np), a: component rows in shared memory with stride.
template <int NP>
__device__ __forceinline__ void comp_dot(const float* a, int stride,
                                         int width, const float* Wt,
                                         int out, int o, bool bf,
                                         float* acc) {
  if ((width & 3) == 0 && (stride & 3) == 0) {
    for (int k = 0; k < width; k += 4) {
      const float w0 = rnd_if(__ldg(Wt + (long long)k * out + o), bf);
      const float w1 = rnd_if(__ldg(Wt + (long long)(k + 1) * out + o), bf);
      const float w2 = rnd_if(__ldg(Wt + (long long)(k + 2) * out + o), bf);
      const float w3 = rnd_if(__ldg(Wt + (long long)(k + 3) * out + o), bf);
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const float4 v = *reinterpret_cast<const float4*>(a + p * stride + k);
        float s = acc[p];
        s = fmaf(v.x, w0, s);
        s = fmaf(v.y, w1, s);
        s = fmaf(v.z, w2, s);
        s = fmaf(v.w, w3, s);
        acc[p] = s;
      }
    }
  } else {
    for (int k = 0; k < width; ++k) {
      const float w = rnd_if(__ldg(Wt + (long long)k * out + o), bf);
#pragma unroll
      for (int p = 0; p < NP; ++p) acc[p] = fmaf(a[p * stride + k], w, acc[p]);
    }
  }
}

__host__ __device__ inline int cb_pad32(int k) { return (k + 31) & ~31; }
// row strides (floats) of the tile's small, feats and hidden rows
__host__ __device__ inline int cb_sld(const ColorMeta& m) {
  return cb_pad32(m.S) + 4;
}
__host__ __device__ inline int cb_fld(const ColorMeta& m) {
  return ((m.F + 3) & ~3) + 4;
}
__host__ __device__ inline int cb_xld(const ColorMeta& m) {
  return ((m.hmax + 3) & ~3) + 4;
}

// The tile's rows in shared memory, as kernels D and I lay them out:
// small [T][sld] (zero-padded to pad32(S)), feats [T][fld], the pose row
// [P], and the hidden layers' input and output rows [T][xld] (ping-pong).
struct ColorRows {
  float *ss, *fs, *ps;
  int sld, fld, xld;
};

__device__ __forceinline__ float2 to_f2(const float* e) {
  return make_float2(e[0], e[1]);
}
__device__ __forceinline__ float2 to_f2(const __nv_bfloat16* e) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(e));
}

// The feats rows, 16 bytes (V elements of type E) a load.
template <bool BF, int T, typename E>
__device__ __forceinline__ void stage_feats16(const E* __restrict__ feats,
                                              int F, int p0, int n,
                                              const ColorRows& r) {
  constexpr int V = 16 / sizeof(E);
  const int nv = T * F / V;
#pragma unroll 4
  for (int i = threadIdx.x; i < nv; i += blockDim.x) {
    const int t = i * V, p = t / F, k = t - p * F;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (p0 + p < n)
      u = __ldg(reinterpret_cast<const uint4*>(feats + (long long)p0 * F + t));
    const E* e = reinterpret_cast<const E*>(&u);
    float* dst = r.fs + p * r.fld + k;
#pragma unroll
    for (int j = 0; j < V; j += 4) {
      const float2 a = to_f2(e + j), b = to_f2(e + j + 2);
      *reinterpret_cast<float4*>(dst + j) =
          make_float4(rnd_if(a.x, BF), rnd_if(a.y, BF), rnd_if(b.x, BF),
                      rnd_if(b.y, BF));
    }
  }
}

// Stage the small and feats rows of the T points from p0 (zero rows past
// n), rounded to bf16 under BF; feats are bf16 or f32 (m.feats_bf16), read
// 16 bytes a load where their rows allow it.
template <bool BF, int T>
__device__ void color_stage(const ColorMeta& m, const float* __restrict__ small_g,
                            const void* __restrict__ feats_g, int p0, int n,
                            const ColorRows& r) {
  const int S = m.S, F = m.F, tid = threadIdx.x;
#pragma unroll 4
  for (int t = tid; t < T * r.sld; t += blockDim.x) {
    const int p = t / r.sld, k = t - p * r.sld;
    r.ss[t] = (p0 + p < n && k < S)
                  ? rnd_if(small_g[(long long)(p0 + p) * S + k], BF) : 0.f;
  }
  const int V = m.feats_bf16 ? 8 : 4;
  if (F % V == 0 && (reinterpret_cast<size_t>(feats_g) & 15) == 0) {
    if (m.feats_bf16)
      stage_feats16<BF, T>(static_cast<const __nv_bfloat16*>(feats_g), F, p0,
                           n, r);
    else
      stage_feats16<BF, T>(static_cast<const float*>(feats_g), F, p0, n, r);
    return;
  }
  for (int t = tid; t < T * F; t += blockDim.x) {
    const int p = t / F, k = t - p * F;
    float v = 0.f;
    if (p0 + p < n) {
      const long long o = (long long)p0 * F + t;
      v = m.feats_bf16
              ? __bfloat162float(
                    reinterpret_cast<const __nv_bfloat16*>(feats_g)[o])
              : reinterpret_cast<const float*>(feats_g)[o];
    }
    r.fs[p * r.fld + k] = rnd_if(v, BF);
  }
}

// The pose part's sum of every hidden layer that has one (the same for
// every point), once a call of D or I: pose_sum[l * hmax + o] = sum over
// k, in order, of r(pose[k]) r(W_pose[k][o]).
__global__ void color_pose_sums(const float* __restrict__ Pw, ColorMeta m,
                                const float* __restrict__ pose,
                                float* __restrict__ pose_sum) {
  const int l = blockIdx.y, o = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= m.n_layers - 1 || o >= m.out[l]) return;
  const bool bf = m.bf16 != 0;
  const int out = m.out[l];
  for (int c = 0; c < m.n_comp[l]; ++c) {
    if (m.kind[l][c] != C_POSE) continue;
    const float* Wt = Pw + m.w_off[l][c];
    float s = 0.f;
    for (int k = 0; k < m.width[l][c]; ++k)
      s = fmaf(rnd_if(pose[k], bf),
               rnd_if(__ldg(Wt + (long long)k * out + o), bf), s);
    pose_sum[(long long)l * m.hmax + o] = s;
  }
}

// Hidden layer l (< L - 1) of the forward chain over a tile of T = 16 MT
// points, from the x input rows xin to xout: the bias, then the parts in
// _recompute_chain's order (x, small, feats, pose), then ReLU, rounded to
// bf16 under BF. `row(p, o, v)` gets each finished value v of point p and
// unit o (kernel I writes it to its workspace; D needs nothing).
// `pose_sum`: the layer's pose sums (color_pose_sums). Called by every
// thread of the block; ends with a barrier.
// - BF: the x, small and feats parts on the tensor cores (prod_mma adds
//   each into the bias-initialised rows), then the pose part's sum (the
//   same for every point), thread = unit.
// - f32: thread = unit for all T points, each part's partial sum (FMA,
//   comp_dot) added to the bias-initialised pre-activation in registers.
template <bool BF, int MT, typename Row>
__device__ void color_hidden(const ColorMeta& m, int l,
                             const float* __restrict__ Pw,
                             const __nv_bfloat16* __restrict__ Wb,
                             const float* xin, float* xout,
                             const ColorRows& r, const float* pose_sum,
                             Row row) {
  constexpr int T = 16 * MT;
  const int tid = threadIdx.x, out = m.out[l];
  if constexpr (BF) {
    if (tid < out) {
      const float b = __ldg(Pw + m.b_off[l] + tid);
      for (int p = 0; p < T; ++p) xout[p * r.xld + tid] = b;
    }
    bool has_pose = false;
    for (int c = 0; c < m.n_comp[l]; ++c) {
      const int kind = m.kind[l][c];
      if (kind == C_POSE) {
        has_pose = true;
        continue;
      }
      const float* a = kind == C_X ? xin : (kind == C_SMALL ? r.ss : r.fs);
      const int lda = kind == C_X ? r.xld : (kind == C_SMALL ? r.sld : r.fld);
      prod_mma<MT>(a, lda, cb_pad32(m.width[l][c]), Wb + m.wf_off[l][c], out,
                   xout, r.xld, true);
    }
    if (tid < out) {
      const float s_pose = has_pose ? pose_sum[tid] : 0.f;
      for (int p = 0; p < T; ++p) {
        float z = xout[p * r.xld + tid];
        if (has_pose) z = z + s_pose;
        const float v = rnd_if(fmaxf(z, 0.f), BF);
        xout[p * r.xld + tid] = v;
        row(p, tid, v);
      }
    }
  } else {
    const int o = tid;
    if (o < out) {
      float z[T];
      const float b = __ldg(Pw + m.b_off[l] + o);
#pragma unroll
      for (int p = 0; p < T; ++p) z[p] = b;
      for (int c = 0; c < m.n_comp[l]; ++c) {
        const int kind = m.kind[l][c], width = m.width[l][c];
        const float a0 = kind == C_POSE ? pose_sum[o] : 0.f;
        float acc[T];
#pragma unroll
        for (int p = 0; p < T; ++p) acc[p] = a0;
        if (kind != C_POSE) {
          const float* a = kind == C_X ? xin : (kind == C_SMALL ? r.ss : r.fs);
          const int stride =
              kind == C_X ? r.xld : (kind == C_SMALL ? r.sld : r.fld);
          comp_dot<T>(a, stride, width, Pw + m.w_off[l][c], out, o, BF, acc);
        }
#pragma unroll
        for (int p = 0; p < T; ++p) z[p] = z[p] + acc[p];
      }
#pragma unroll
      for (int p = 0; p < T; ++p) {
        const float v = rnd_if(fmaxf(z[p], 0.f), BF);
        xout[p * r.xld + o] = v;
        row(p, o, v);
      }
    }
  }
  __syncthreads();
}

// The last layer's pre-activation z of output o of point pt (bias, then
// the parts in _recompute_chain's order), on the CUDA cores: one thread
// per (point, output).
__device__ float color_last_z(const ColorMeta& m,
                              const float* __restrict__ Pw, const float* xin,
                              const ColorRows& r, int pt, int o, bool bf) {
  const int l = m.n_layers - 1, out = m.out[l];
  float z = __ldg(Pw + m.b_off[l] + o);
  for (int c = 0; c < m.n_comp[l]; ++c) {
    const int kind = m.kind[l][c], width = m.width[l][c];
    const float* Wt = Pw + m.w_off[l][c];
    float acc = 0.f;
    if (kind == C_POSE) {
      for (int k = 0; k < width; ++k)
        acc = fmaf(r.ps[k], rnd_if(__ldg(Wt + (long long)k * out + o), bf),
                   acc);
    } else {
      const float* a = kind == C_X ? xin : (kind == C_SMALL ? r.ss : r.fs);
      const int stride =
          kind == C_X ? r.xld : (kind == C_SMALL ? r.sld : r.fld);
      comp_dot<1>(a + pt * stride, stride, width, Wt, out, o, bf, &acc);
    }
    z = z + acc;
  }
  return z;
}

// Shared memory of a tile of T points: small, feats, two hidden rows.
static size_t color_tile_floats(const ColorMeta& m, int T) {
  return (size_t)T * (cb_sld(m) + cb_fld(m) + 2 * cb_xld(m));
}

template <bool BF, int MT>
__global__ void __launch_bounds__(COLOR_THREADS, (BF && MT <= 2) ? 2 : 1)
color_fwd_kernel(const float* __restrict__ small_g,
                 const void* __restrict__ feats_g,
                 const float* __restrict__ pose_g, int n,
                 const float* __restrict__ Pw,
                 const __nv_bfloat16* __restrict__ Wb, ColorMeta m,
                 const float* __restrict__ pose_sum,
                 float* __restrict__ rgb_out) {
  constexpr int T = 16 * MT;
  extern __shared__ __align__(16) float smem[];
  ColorRows r;
  r.sld = cb_sld(m);
  r.fld = cb_fld(m);
  r.xld = cb_xld(m);
  r.ss = smem;                                   // [T][sld]
  r.fs = r.ss + T * r.sld;                       // [T][fld]
  float* xin = r.fs + T * r.fld;                 // [T][xld]
  float* xout = xin + T * r.xld;                 // [T][xld]
  r.ps = xout + T * r.xld;                       // [P]
  const int p0 = blockIdx.x * T;
  color_stage<BF, T>(m, small_g, feats_g, p0, n, r);
  for (int t = threadIdx.x; t < m.P; t += blockDim.x)
    r.ps[t] = rnd_if(pose_g[t], BF);
  __syncthreads();
  const int L = m.n_layers;
  for (int l = 0; l < L - 1; ++l) {
    color_hidden<BF, MT>(m, l, Pw, Wb, xin, xout, r,
                         pose_sum + (long long)l * m.hmax,
                         [](int, int, float) {});
    float* tmp = xin;
    xin = xout;
    xout = tmp;
  }
  const int out = m.out[L - 1];
  for (int e = threadIdx.x; e < T * out; e += blockDim.x) {
    const int pt = e / out, o = e - pt * out;
    if (p0 + pt >= n) continue;
    const float z = color_last_z(m, Pw, xin, r, pt, o, BF);
    rgb_out[(long long)(p0 + pt) * out + o] =
        m.squeeze ? 1.f / (1.f + expf(-z)) : z;
  }
}

template <bool BF, int MT>
static int color_fwd_run(const float* small, const void* feats,
                         const float* pose, int n, const float* params,
                         const __nv_bfloat16* wb, const ColorMeta& m,
                         float* rgb, float* pose_sum, cudaStream_t st) {
  constexpr int T = 16 * MT;
  const size_t smem = (color_tile_floats(m, T) + m.P) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      color_fwd_kernel<BF, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (m.P > 0 && m.n_layers > 1)
    color_pose_sums<<<dim3((m.hmax + 255) / 256, m.n_layers - 1), 256, 0,
                      st>>>(params, m, pose, pose_sum);
  const int blocks = (n + T - 1) / T;
  color_fwd_kernel<BF, MT><<<blocks, COLOR_THREADS, smem, st>>>(
      small, feats, pose, n, params, wb, m, pose_sum, rgb);
  return launch_status();
}

// rgb (n, out) of the colour MLP. `wbf16`: under bf16, the tensor-core
// weight blocks (ops/color.py:pack_color_bf16, offsets wf_off); null in
// f32. feats are bf16 or f32 (m.feats_bf16). `pose_sum`: n_layers x hmax
// floats of scratch (the hidden layers' pose sums).
extern "C" int arah_color_fwd(const float* small, const void* feats,
                              const float* pose, int n, const float* params,
                              const void* wbf16, ColorMeta m, float* rgb,
                              float* pose_sum, void* stream) {
  if (n <= 0) return 0;
  const __nv_bfloat16* wb = static_cast<const __nv_bfloat16*>(wbf16);
  const cudaStream_t st = (cudaStream_t)stream;
  return m.bf16
             ? color_fwd_run<true, D_MT>(small, feats, pose, n, params, wb,
                                         m, rgb, pose_sum, st)
             : color_fwd_run<false, D_MT>(small, feats, pose, n, params, wb,
                                          m, rgb, pose_sum, st);
}

// Bytes of dynamic shared memory a block of kernel D takes.
extern "C" long long arah_color_fwd_smem(ColorMeta m) {
  return (long long)((color_tile_floats(m, 16 * D_MT) + m.P) * sizeof(float));
}

// Kernel I: the backward of the colour MLP (the training step's rgb).
//
// Replaces the TPU kernel arah_tpu/ops/pallas/color_kernel.py:
// _color_bwd_pallas (body _color_bwd_kernel): recompute the forward chain
// of a tile, then from delta = g_rgb * rgb * (1 - rgb) down the layers:
// db += colsum(delta); per input part, dW += a (x) delta and da = delta W
// (the pose row: dW += pose (x) colsum, dpose += colsum W); the x part's da
// times the ReLU mask (0 at 0) is the next delta; the small and feats
// parts' da sum into dsmall and dfeats, written per point. Under
// bf16_shading every product's operands are rounded as _dot/_dot_nt round
// them, with f32 accumulation; colsum is rounded per group of CB_HALF = 16
// points (ops/color.py:BWD_TILE; the Pallas kernel's group is its grid
// tile).
//
// Bound on the H100: operations. A point costs ~3x D's multiply-adds: the
// recomputed forward, delta W and the rank-1 weight-gradient term.
//
// Design: a block of 256 threads (8 warps) owns a tile of CB_TILE = 32
// points and walks its share of the tiles (a persistent grid). The tile's
// small and feats rows, two activation rows (the current layer's input
// and output), delta, da and the dsmall/dfeats sums stay in shared memory
// (~184 KB at the flagship: one block per SM); each hidden layer's output,
// the next one's x input, goes to the workspace in the recomputed
// forward, where the weight-gradient reduction and the backward's ReLU
// mask read it.
// - The products. Under bf16 every operand is a bf16 value (rows rounded
//   when written, weights from a bf16 copy, ops/color.py:pack_color_bf16),
//   so the hidden layers' x, small and feats parts of the recomputed
//   forward (kernel D's body, color_hidden) and the backward's da = delta
//   W run on the tensor cores (mma.cuh:prod_mma, f32 sums, as in C and
//   H). Each part's weight block
//   has its width zero-padded to a multiple of 32 (small: 33 -> 64, its
//   rows zero-padded alike), which adds exact zeros. The pose part's sums
//   (one row for the call) come from color_pose_sums, once a call, as in
//   D; the 3-wide last layer stays on the CUDA cores, as does every
//   product of the f32 launch (FMA; never TF32). Each partial product is
//   added to the pre-activation in _recompute_chain's order (x, small,
//   feats, pose).
// - The weight gradients (~411 k at the flagship) are summed as kernel H
//   sums its own: the tile kernel writes each point's delta and x-input
//   rows of every layer to a workspace, and atb.cuh reduces delta^T input
//   over the points for each input part (x from the workspace, small and
//   feats from their own buffers) into dW. Under bf16 the workspace rows
//   are bf16: the x rows are rounded by the forward, and each delta row is
//   rounded before it is written (the value every product takes; db and
//   colsum sum it unrounded). The pose part needs only S_l = the sum of
//   the rounded 16-point colsums: dW's pose columns are S_l (x) pose and
//   dpose = sum_l S_l W_l's pose columns (the epilogue). S and db go to
//   per-block partials of the fixed grid, added in block order. Every sum
//   is the same on every run. The points run in chunks of CB_CHUNK.
#define CB_TILE 32
#define CB_HALF 16                 // points per rounded pose colsum
#define CB_CHUNK 65536

static_assert(CB_TILE % CB_HALF == 0, "whole pose colsums a tile");
static_assert(CB_TILE % 16 == 0, "prod_mma: whole 16-point fragments");

// BF: the bf16_shading launch (tensor-core products, bf16 workspace rows);
// otherwise f32 throughout.
template <bool BF>
__global__ void __launch_bounds__(COLOR_THREADS, 1)
color_bwd_kernel(const float* __restrict__ small_g,
                 const float* __restrict__ feats_g,
                 const float* __restrict__ pose_g,
                 const float* __restrict__ g_rgb, int n,
                 const float* __restrict__ Pw,
                 const __nv_bfloat16* __restrict__ Wb, ColorMeta m,
                 const float* __restrict__ pose_sum,
                 float* __restrict__ dsmall_g, float* __restrict__ dfeats_g,
                 float* __restrict__ partial, long long gsize,
                 typename WsRow<BF>::T* __restrict__ ws) {
  extern __shared__ __align__(16) float smem[];
  const int S = m.S, F = m.F, P = m.P, L = m.n_layers;
  ColorRows r;
  r.sld = cb_sld(m);
  r.fld = cb_fld(m);
  r.xld = cb_xld(m);
  const int SLD = r.sld, FLD = r.fld, XLD = r.xld;
  r.ss = smem;                                   // [T][SLD] small, padded
  r.fs = r.ss + CB_TILE * SLD;                   // [T][FLD]
  float* xa = r.fs + CB_TILE * FLD;              // [T][XLD] activations,
  float* xb = xa + CB_TILE * XLD;                // [T][XLD] ping-pong
  float* dbuf = xb + CB_TILE * XLD;              // [T][XLD] delta
  float* xbuf = xa;                              // [T][XLD] da of x
  float* dsm = dbuf + CB_TILE * XLD;             // [T][SLD]
  float* dfe = dsm + CB_TILE * SLD;              // [T][FLD]
  r.ps = dfe + CB_TILE * FLD;                    // [P]
  const int tid = threadIdx.x;
  float* part = partial + (long long)blockIdx.x * gsize;
  const int ntiles = (n + CB_TILE - 1) / CB_TILE;
  for (int t = tid; t < P; t += blockDim.x) r.ps[t] = rnd_if(pose_g[t], BF);

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int p0 = tile * CB_TILE;
    color_stage<BF, CB_TILE>(m, small_g, feats_g, p0, n, r);
    for (int t = tid; t < CB_TILE * SLD; t += blockDim.x) dsm[t] = 0.f;
    for (int t = tid; t < CB_TILE * F; t += blockDim.x) {
      const int p = t / F, k = t - p * F;
      dfe[p * FLD + k] = 0.f;
    }
    __syncthreads();

    // ---- recompute the forward chain (D's body); each hidden layer's
    // output, the next one's x input, also goes to the workspace (the
    // weight gradient and the ReLU mask read it there)
    float* xin = xa;                             // this layer's x input
    float* xout = xb;
    for (int l = 0; l < L - 1; ++l) {
      typename WsRow<BF>::T* wx = ws + (long long)n * m.wx_off[l + 1];
      const int out = m.out[l];
      color_hidden<BF, CB_TILE / 16>(
          m, l, Pw, Wb, xin, xout, r, pose_sum + (long long)l * m.hmax,
          [&](int p, int o, float v) {
            if (p0 + p < n) put(wx + (long long)(p0 + p) * out + o, v);
          });
      float* tmp = xin;
      xin = xout;
      xout = tmp;
    }
    // the last layer: delta = g_rgb * rgb * (1 - rgb), thread = (point,
    // output)
    const int outL = m.out[L - 1];
    for (int e = tid; e < CB_TILE * outL; e += blockDim.x) {
      const int pt = e / outL, o = e - pt * outL;
      const float v = color_last_z(m, Pw, xin, r, pt, o, BF);
      float d = 0.f;
      if (p0 + pt < n) {
        const float g = g_rgb[(long long)(p0 + pt) * outL + o];
        if (m.squeeze) {
          const float rgb = 1.f / (1.f + expf(-v));
          d = g * rgb * (1.f - rgb);
        } else {
          d = g;
        }
      }
      dbuf[pt * XLD + o] = d;
    }
    __syncthreads();

    // ---- backward, delta in dbuf
    for (int l = L - 1; l >= 0; --l) {
      const int out = m.out[l];
      int in_l = 0;
      bool has_pose = false;
      for (int c = 0; c < m.n_comp[l]; ++c) {
        in_l += m.width[l][c];
        has_pose |= m.kind[l][c] == C_POSE;
      }
      if (tid < out) {
        // db, and the pose sums of the rounded 16-point colsums
        float hs[CB_TILE / CB_HALF], db = 0.f;
#pragma unroll
        for (int q = 0; q < CB_TILE / CB_HALF; ++q) {
          float h = 0.f;
          for (int p = q * CB_HALF; p < (q + 1) * CB_HALF; ++p)
            h += dbuf[p * XLD + tid];
          hs[q] = h;
          db += h;
        }
        part[m.gb_off[l] + tid] += db;
        if (has_pose) {
#pragma unroll
          for (int q = 0; q < CB_TILE / CB_HALF; ++q)
            part[m.gs_off[l] + tid] += rnd_if(hs[q], BF);
        }
        // delta as the products take it (rounded under bf16), in place
        // and to this tile's workspace rows
        typename WsRow<BF>::T* wd = ws + (long long)n * m.wd_off[l];
        for (int p = 0; p < CB_TILE; ++p) {
          const float v = rnd_if(dbuf[p * XLD + tid], BF);
          dbuf[p * XLD + tid] = v;
          if (p0 + p < n) put(wd + (long long)(p0 + p) * out + tid, v);
        }
      }
      __syncthreads();
      const float* Wo = Pw + m.wo_off[l];        // (out, in_l)
      for (int c = 0; c < m.n_comp[l]; ++c) {
        const int kind = m.kind[l][c], width = m.width[l][c];
        const int st = m.start[l][c];
        if (kind == C_POSE) continue;
        if (BF && l < L - 1) {
          // da = delta W_part: dst (=) or (+=) on the tensor cores
          float* dst = kind == C_X ? xbuf : (kind == C_SMALL ? dsm : dfe);
          const int ldd = kind == C_X ? XLD : (kind == C_SMALL ? SLD : FLD);
          prod_mma<CB_TILE / 16>(dbuf, XLD, out, Wb + m.wb_off[l][c],
                                 cb_pad32(width), dst, ldd, kind != C_X);
          continue;
        }
        // da[p][k] = sum_o delta[p][o] W[o][st + k], o in order; delta
        // rows read four units at a time
        const bool vec = (out & 3) == 0;
        for (int k = tid; k < width; k += blockDim.x) {
          float acc[CB_TILE];
#pragma unroll
          for (int p = 0; p < CB_TILE; ++p) acc[p] = 0.f;
          const float* wk = Wo + st + k;
          int o = 0;
          if (vec) {
            for (; o < out; o += 4) {
              const float w0 = __ldg(wk + (long long)o * in_l);
              const float w1 = __ldg(wk + (long long)(o + 1) * in_l);
              const float w2 = __ldg(wk + (long long)(o + 2) * in_l);
              const float w3 = __ldg(wk + (long long)(o + 3) * in_l);
#pragma unroll
              for (int p = 0; p < CB_TILE; ++p) {
                const float4 d =
                    *reinterpret_cast<const float4*>(dbuf + p * XLD + o);
                float a = acc[p];
                a = fmaf(d.x, w0, a);
                a = fmaf(d.y, w1, a);
                a = fmaf(d.z, w2, a);
                a = fmaf(d.w, w3, a);
                acc[p] = a;
              }
            }
          }
          for (; o < out; ++o) {
            const float w = __ldg(wk + (long long)o * in_l);
#pragma unroll
            for (int p = 0; p < CB_TILE; ++p)
              acc[p] = fmaf(dbuf[p * XLD + o], w, acc[p]);
          }
#pragma unroll
          for (int p = 0; p < CB_TILE; ++p) {
            if (kind == C_X)
              xbuf[p * XLD + k] = acc[p];
            else if (kind == C_SMALL)
              dsm[p * SLD + k] += acc[p];
            else
              dfe[p * FLD + k] += acc[p];
          }
        }
      }
      __syncthreads();
      if (l > 0) {
        // next delta: da of x times the ReLU mask of the layer's input
        const int w = m.out[l - 1];
        const typename WsRow<BF>::T* wx = ws + (long long)n * m.wx_off[l];
        for (int e = tid; e < CB_TILE * w; e += blockDim.x) {
          const int p = e / w, k = e - p * w;
          const bool on =
              p0 + p < n && get(wx + (long long)(p0 + p) * w + k) > 0.f;
          dbuf[p * XLD + k] = on ? xbuf[p * XLD + k] : 0.f;
        }
      }
      __syncthreads();
    }
    for (int t = tid; t < CB_TILE * S; t += blockDim.x) {
      const int p = t / S, k = t - p * S;
      if (p0 + p < n)
        dsmall_g[(long long)(p0 + p) * S + k] = dsm[p * SLD + k];
    }
    for (int t = tid; t < CB_TILE * F; t += blockDim.x) {
      const int p = t / F, k = t - p * F;
      if (p0 + p < n) dfeats_g[(long long)p0 * F + t] = dfe[p * FLD + k];
    }
    __syncthreads();
  }
}

// The pose part of every layer that takes it: dW's pose columns
// S_l (x) pose and dpose = sum over those layers of S_l W_l's pose
// columns, one thread per pose entry k.
__global__ void color_pose_epilogue(const float* __restrict__ Pw,
                                    ColorMeta m,
                                    const float* __restrict__ pose,
                                    float* __restrict__ g) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= m.P) return;
  const bool bf = m.bf16 != 0;
  const float pk = rnd_if(pose[k], bf);
  float dp = 0.f;
  for (int l = 0; l < m.n_layers; ++l) {
    int in_l = 0;
    for (int c = 0; c < m.n_comp[l]; ++c) in_l += m.width[l][c];
    for (int c = 0; c < m.n_comp[l]; ++c) {
      if (m.kind[l][c] != C_POSE) continue;
      const int col = m.start[l][c] + k;
      const float* Sl = g + m.gs_off[l];
      const float* Wo = Pw + m.wo_off[l];
      for (int o = 0; o < m.out[l]; ++o) {
        g[m.g_off[l] + (long long)o * in_l + col] = Sl[o] * pk;
        dp = fmaf(Sl[o], rnd_if(Wo[(long long)o * in_l + col], bf), dp);
      }
    }
  }
  g[m.gpose_off + k] = dp;
}

static size_t color_bwd_smem(const ColorMeta& m) {
  return ((size_t)CB_TILE * (2 * cb_sld(m) + 2 * cb_fld(m) + 3 * cb_xld(m))
          + m.P) * sizeof(float);
}

// Bytes of dynamic shared memory a block of kernel I's tile kernel takes.
extern "C" long long arah_color_bwd_smem(ColorMeta m) {
  return (long long)color_bwd_smem(m);
}

template <bool BF>
static int color_bwd_blocks(int n, const ColorMeta& m) {
  const size_t smem = color_bwd_smem(m);
  if (cudaFuncSetAttribute(color_bwd_kernel<BF>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return 0;
  int per_sm = 0, dev = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, color_bwd_kernel<BF>, COLOR_THREADS, smem) != cudaSuccess
      || cudaGetDevice(&dev) != cudaSuccess
      || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
             != cudaSuccess)
    return 0;
  const int nc = n < CB_CHUNK ? n : CB_CHUNK;
  const int tiles = (nc + CB_TILE - 1) / CB_TILE;
  const int b = per_sm * sms;
  return b < tiles ? b : tiles;
}

// The persistent grid for n points: as many blocks as fit on the card at
// once, at most one per tile of the first chunk.
extern "C" int arah_color_bwd_blocks(int n, ColorMeta m) {
  return m.bf16 ? color_bwd_blocks<true>(n, m)
                : color_bwd_blocks<false>(n, m);
}

// Floats of a chunk's workspace rows (bf16 under bf16: two to a float),
// rounded up to 16 bytes.
static long long color_rows_floats(long long nc, const ColorMeta& m) {
  const long long e = nc * m.ws_cols;
  const long long f = m.bf16 ? (e + 1) / 2 : e;
  return (f + 3) / 4 * 4;
}

// Floats of the A^T B reduction's split partials.
static long long color_apart_floats(const ColorMeta& m) {
  long long mn = 0;
  for (int l = 0; l < m.n_layers; ++l)
    for (int c = 0; c < m.n_comp[l]; ++c) {
      const long long v = (long long)m.out[l] * m.width[l][c];
      mn = v > mn ? v : mn;
    }
  return (long long)ATB_MAX_SPLITS * mn;
}

// Floats of the workspace for n points: one chunk's delta and x-input
// rows, the A^T B reduction's split partials, the hidden layers' pose
// sums.
extern "C" long long arah_color_bwd_ws(int n, ColorMeta m) {
  const long long nc = n < CB_CHUNK ? n : CB_CHUNK;
  return color_rows_floats(nc, m) + color_apart_floats(m)
         + (long long)m.n_layers * m.hmax;
}

template <bool BF>
static int color_bwd_run(const float* small, const float* feats,
                         const float* pose, const float* g_rgb, int n,
                         const float* params, const __nv_bfloat16* wb,
                         const ColorMeta& m, float* dsmall, float* dfeats,
                         float* partial, int nblocks, long long gsize,
                         float* grads, float* ws, cudaStream_t st) {
  using T = typename WsRow<BF>::T;
  const size_t smem = color_bwd_smem(m);
  cudaError_t e = cudaFuncSetAttribute(
      color_bwd_kernel<BF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long nmax = n < CB_CHUNK ? n : CB_CHUNK;
  T* rows = reinterpret_cast<T*>(ws);
  float* apart = ws + color_rows_floats(nmax, m);
  float* pose_sum = apart + color_apart_floats(m);
  if (m.P > 0 && m.n_layers > 1)
    color_pose_sums<<<dim3((m.hmax + 255) / 256, m.n_layers - 1), 256, 0,
                      st>>>(params, m, pose, pose_sum);
  const int outL = m.out[m.n_layers - 1];
  for (int c0 = 0; c0 < n; c0 += CB_CHUNK) {
    const int nc = n - c0 < CB_CHUNK ? n - c0 : CB_CHUNK;
    color_bwd_kernel<BF><<<nblocks, COLOR_THREADS, smem, st>>>(
        small + (long long)c0 * m.S, feats + (long long)c0 * m.F, pose,
        g_rgb + (long long)c0 * outL, nc, params, wb, m, pose_sum,
        dsmall + (long long)c0 * m.S, dfeats + (long long)c0 * m.F, partial,
        gsize, rows);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    for (int l = 0; l < m.n_layers; ++l) {
      const int out = m.out[l];
      int in_l = 0;
      for (int c = 0; c < m.n_comp[l]; ++c) in_l += m.width[l][c];
      const T* D = rows + (long long)nc * m.wd_off[l];
      for (int c = 0; c < m.n_comp[l]; ++c) {
        const int kind = m.kind[l][c], w = m.width[l][c];
        if (kind == C_POSE) continue;
        float* C = grads + m.g_off[l] + m.start[l][c];
        int r;
        if (kind == C_X) {
          r = atb_accumulate(D, out, rows + (long long)nc * m.wx_off[l], w,
                             nc, out, w, BF, apart, C, in_l, st);
        } else {
          const bool sm = kind == C_SMALL;
          r = atb_accumulate(D, out,
                             sm ? small + (long long)c0 * m.S
                                : feats + (long long)c0 * m.F,
                             sm ? m.S : m.F, nc, out, w, BF, apart, C, in_l,
                             st);
        }
        if (r != 0) return r;
      }
    }
  }
  const long long blocks = (gsize + 255) / 256;
  sum_partials<<<(unsigned)blocks, 256, 0, st>>>(partial, nblocks, gsize,
                                                 grads);
  if (m.P > 0)
    color_pose_epilogue<<<(m.P + 127) / 128, 128, 0, st>>>(params, m, pose,
                                                           grads);
  return launch_status();
}

// Per chunk of CB_CHUNK points: the tile kernel (dsmall, dfeats, the
// workspace rows, the per-block partials of db and S), then per layer
// and input part the A^T B reduction into dW of `grads` (zeroed by the
// caller); last, the partials added into `grads` and the pose epilogue.
// feats are f32 here. `wbf16`: under bf16, the tensor-core weight blocks
// (ops/color.py:pack_color_bf16, offsets wf_off and wb_off); null in f32.
// `partial` holds nblocks x gsize zeroed floats, `ws`
// arah_color_bwd_ws(n, m) floats.
extern "C" int arah_color_bwd(const float* small, const float* feats,
                              const float* pose, const float* g_rgb, int n,
                              const float* params, const void* wbf16,
                              ColorMeta m, float* dsmall, float* dfeats,
                              float* partial, int nblocks, long long gsize,
                              float* grads, float* ws, void* stream) {
  if (n <= 0 || nblocks <= 0) return 0;
  const __nv_bfloat16* wb = static_cast<const __nv_bfloat16*>(wbf16);
  const cudaStream_t st = (cudaStream_t)stream;
  return m.bf16 ? color_bwd_run<true>(small, feats, pose, g_rgb, n, params,
                                      wb, m, dsmall, dfeats, partial,
                                      nblocks, gsize, grads, ws, st)
                : color_bwd_run<false>(small, feats, pose, g_rgb, n, params,
                                       wb, m, dsmall, dfeats, partial,
                                       nblocks, gsize, grads, ws, st);
}
