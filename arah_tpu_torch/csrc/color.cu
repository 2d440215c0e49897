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
// Design: a block of 256 threads (one per output unit) colours a tile of
// 32 points. The tile's `small` and `feats` rows and its current hidden
// activations live in shared memory (~70 KB), so neither the concatenated
// input nor any activation reaches device memory; the pose row is the same
// for every point and is staged once per block. Thread j computes unit j
// for all 32 points, component by component in the order of
// _recompute_chain (x, small, feats, pose), each partial sum added to the
// bias-initialised pre-activation; every weight it loads (coalesced, from
// the transposed per-component blocks) feeds 32 FMAs. Under bf16_shading
// every dot operand is rounded with __float2bfloat16_rn and accumulated in
// f32. The last layer (3 outputs) runs one thread per (point, output).
#include "atb.cuh"
#include "common.cuh"

#define COLOR_THREADS 256
#define COLOR_TILE 32
#define MAX_LAYERS 8
#define MAX_COMP 4

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

__global__ void __launch_bounds__(COLOR_THREADS)
color_fwd_kernel(const float* __restrict__ small_g,
                 const void* __restrict__ feats_g,
                 const float* __restrict__ pose_g, int n,
                 const float* __restrict__ Pw, ColorMeta m,
                 float* __restrict__ rgb_out) {
  extern __shared__ __align__(16) float smem[];
  const int S = m.S, F = m.F, Sp = (m.S + 3) & ~3, Hm = m.hmax;
  const bool bf = m.bf16 != 0;
  float* xs = smem;                          // [TILE][Hm]
  float* fs = xs + COLOR_TILE * Hm;          // [TILE][F]
  float* ss = fs + COLOR_TILE * F;           // [TILE][Sp]
  float* ps = ss + COLOR_TILE * Sp;          // [P]
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * COLOR_TILE;

  for (int t = tid; t < COLOR_TILE * Sp; t += blockDim.x) {
    const int p = t / Sp, k = t % Sp;
    ss[t] = (p0 + p < n && k < S)
                ? rnd_if(small_g[(long long)(p0 + p) * S + k], bf) : 0.f;
  }
  for (int t = tid; t < COLOR_TILE * F; t += blockDim.x) {
    const int p = t / F;
    float v = 0.f;
    if (p0 + p < n) {
      const long long o = (long long)p0 * F + t;
      v = m.feats_bf16
              ? __bfloat162float(
                    reinterpret_cast<const __nv_bfloat16*>(feats_g)[o])
              : reinterpret_cast<const float*>(feats_g)[o];
    }
    fs[t] = rnd_if(v, bf);
  }
  for (int t = tid; t < m.P; t += blockDim.x) ps[t] = rnd_if(pose_g[t], bf);
  __syncthreads();

  const int L = m.n_layers;
  for (int l = 0; l < L; ++l) {
    const int out = m.out[l];
    const bool last = (l == L - 1);
    // hidden layers: thread = unit, all TILE points; last layer: thread =
    // (point, unit)
    const int o = last ? tid % out : tid;
    const int pt = last ? tid / out : 0;
    const bool on = last ? (tid < COLOR_TILE * out) : (tid < out);
    float z[COLOR_TILE];
    if (on) {
      const float b = __ldg(Pw + m.b_off[l] + o);
#pragma unroll
      for (int p = 0; p < COLOR_TILE; ++p) z[p] = b;
      for (int c = 0; c < m.n_comp[l]; ++c) {
        const int kind = m.kind[l][c], width = m.width[l][c];
        const float* Wt = Pw + m.w_off[l][c];
        float acc[COLOR_TILE];
#pragma unroll
        for (int p = 0; p < COLOR_TILE; ++p) acc[p] = 0.f;
        if (kind == C_POSE) {
          float s = 0.f;
          for (int k = 0; k < width; ++k)
            s = fmaf(ps[k], rnd_if(__ldg(Wt + (long long)k * out + o), bf), s);
#pragma unroll
          for (int p = 0; p < COLOR_TILE; ++p) acc[p] = s;
        } else {
          const float* a = kind == C_X ? xs : (kind == C_SMALL ? ss : fs);
          const int stride = kind == C_X ? Hm : (kind == C_SMALL ? Sp : F);
          if (last)
            comp_dot<1>(a + pt * stride, stride, width, Wt, out, o, bf, acc);
          else
            comp_dot<COLOR_TILE>(a, stride, width, Wt, out, o, bf, acc);
        }
#pragma unroll
        for (int p = 0; p < COLOR_TILE; ++p) z[p] = z[p] + acc[p];
      }
    }
    __syncthreads();      // every read of xs for this layer is done
    if (on) {
      if (!last) {
#pragma unroll
        for (int p = 0; p < COLOR_TILE; ++p)
          xs[p * Hm + o] = rnd_if(fmaxf(z[p], 0.f), bf);
      } else if (p0 + pt < n) {
        const float v = z[0];
        rgb_out[(long long)(p0 + pt) * out + o] =
            m.squeeze ? 1.f / (1.f + expf(-v)) : v;
      }
    }
    __syncthreads();
  }
}

extern "C" int arah_color_fwd(const float* small, const void* feats,
                              const float* pose, int n, const float* params,
                              ColorMeta m, float* rgb, void* stream) {
  if (n <= 0) return 0;
  const int Sp = (m.S + 3) & ~3;
  const size_t smem =
      ((size_t)COLOR_TILE * (m.hmax + m.F + Sp) + m.P) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      color_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (n + COLOR_TILE - 1) / COLOR_TILE;
  color_fwd_kernel<<<blocks, COLOR_THREADS, smem, (cudaStream_t)stream>>>(
      small, feats, pose, n, params, m, rgb);
  return launch_status();
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
// them, with f32 accumulation; colsum is rounded per tile of 16 points
// (the kernel's tile; the Pallas kernel's is its grid tile).
//
// Bound on the H100: operations. A point costs ~3x D's multiply-adds: the
// recomputed forward, delta W and the rank-1 weight-gradient term.
//
// Design: D's tile at 16 points (256 threads): the tile's small and feats
// rows, two activation rows (the current layer's input and output),
// delta, da and the dsmall/dfeats sums stay in shared memory (86 KB at
// the flagship, so two blocks share an SM); each hidden layer's output,
// the next one's x input, goes to the workspace in the recomputed
// forward, where the weight-gradient reduction and the backward's ReLU
// mask read it.
// The weight gradients (~411 k at the flagship) are summed as kernel H
// sums its own: the tile kernel writes each point's delta and x-input
// rows of every layer to a workspace, and atb.cuh reduces delta^T input
// over the points for each input part (x from the workspace, small and
// feats from their own buffers) into dW. The pose part needs only
// S_l = sum over tiles of the rounded tile colsum: dW's pose columns are
// S_l (x) pose and dpose = sum_l S_l W_l's pose columns (the epilogue).
// S and db go to per-block partials of a fixed persistent grid, added in
// block order. Every sum is the same on every run. The points run in
// chunks of CB_CHUNK.
#define CB_TILE 16
#define CB_CHUNK 65536

__global__ void __launch_bounds__(COLOR_THREADS)
color_bwd_kernel(const float* __restrict__ small_g,
                 const float* __restrict__ feats_g,
                 const float* __restrict__ pose_g,
                 const float* __restrict__ g_rgb, int n,
                 const float* __restrict__ Pw, ColorMeta m,
                 float* __restrict__ dsmall_g, float* __restrict__ dfeats_g,
                 float* __restrict__ partial, long long gsize,
                 float* __restrict__ ws) {
  extern __shared__ __align__(16) float smem[];
  const int S = m.S, F = m.F, P = m.P, Sp = (m.S + 3) & ~3, Hm = m.hmax;
  const int L = m.n_layers;
  const bool bf = m.bf16 != 0;
  float* ss = smem;                              // [T][Sp]
  float* fs = ss + CB_TILE * Sp;                 // [T][F]
  float* xa = fs + CB_TILE * F;                  // [T][Hm] activations,
  float* xb = xa + CB_TILE * Hm;                 // [T][Hm] ping-pong
  float* dbuf = xb + CB_TILE * Hm;               // [T][Hm] delta
  float* xbuf = xa;                              // [T][Hm] da of x
  float* dsm = dbuf + CB_TILE * Hm;              // [T][Sp]
  float* dfe = dsm + CB_TILE * Sp;               // [T][F]
  float* cs = dfe + CB_TILE * F;                 // [Hm] colsum
  float* ps = cs + Hm;                           // [P]
  const int tid = threadIdx.x;
  float* part = partial + (long long)blockIdx.x * gsize;
  const int ntiles = (n + CB_TILE - 1) / CB_TILE;
  for (int t = tid; t < P; t += blockDim.x) ps[t] = rnd_if(pose_g[t], bf);

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int p0 = tile * CB_TILE;
    for (int t = tid; t < CB_TILE * Sp; t += blockDim.x) {
      const int p = t / Sp, k = t % Sp;
      ss[t] = (p0 + p < n && k < S)
                  ? rnd_if(small_g[(long long)(p0 + p) * S + k], bf) : 0.f;
      dsm[t] = 0.f;
    }
    for (int t = tid; t < CB_TILE * F; t += blockDim.x) {
      const int p = t / F;
      fs[t] = p0 + p < n ? rnd_if(feats_g[(long long)p0 * F + t], bf) : 0.f;
      dfe[t] = 0.f;
    }
    __syncthreads();

    // ---- recompute the forward chain (D's order of the partial sums);
    // each hidden layer's output, the next one's x input, also goes to the
    // workspace (the weight gradient and the ReLU mask read it there)
    float* xin = xa;                             // this layer's x input
    float* xout = xb;
    for (int l = 0; l < L; ++l) {
      const int out = m.out[l];
      const bool last = (l == L - 1);
      const int o = last ? tid % out : tid;
      const int pt = last ? tid / out : 0;
      const bool on = last ? (tid < CB_TILE * out) : (tid < out);
      const int in_w = l > 0 ? m.out[l - 1] : 0;
      float z[CB_TILE];
      if (on) {
        const float b = __ldg(Pw + m.b_off[l] + o);
#pragma unroll
        for (int p = 0; p < CB_TILE; ++p) z[p] = b;
        for (int c = 0; c < m.n_comp[l]; ++c) {
          const int kind = m.kind[l][c], width = m.width[l][c];
          const float* Wt = Pw + m.w_off[l][c];
          float acc[CB_TILE];
#pragma unroll
          for (int p = 0; p < CB_TILE; ++p) acc[p] = 0.f;
          if (kind == C_POSE) {
            float s = 0.f;
            for (int k = 0; k < width; ++k)
              s = fmaf(ps[k], rnd_if(__ldg(Wt + (long long)k * out + o), bf),
                       s);
#pragma unroll
            for (int p = 0; p < CB_TILE; ++p) acc[p] = s;
          } else {
            const float* a = kind == C_X ? xin : (kind == C_SMALL ? ss : fs);
            const int stride = kind == C_X ? in_w : (kind == C_SMALL ? Sp : F);
            if (last)
              comp_dot<1>(a + pt * stride, stride, width, Wt, out, o, bf, acc);
            else
              comp_dot<CB_TILE>(a, stride, width, Wt, out, o, bf, acc);
          }
#pragma unroll
          for (int p = 0; p < CB_TILE; ++p) z[p] = z[p] + acc[p];
        }
        if (!last) {
          float* wx = ws + (long long)n * m.wx_off[l + 1];
#pragma unroll
          for (int p = 0; p < CB_TILE; ++p) {
            const float v = rnd_if(fmaxf(z[p], 0.f), bf);
            xout[p * out + o] = v;
            if (p0 + p < n) wx[(long long)(p0 + p) * out + o] = v;
          }
        } else {
          const float v = z[0];
          float d = 0.f;
          if (p0 + pt < n) {
            const float g = g_rgb[(long long)(p0 + pt) * out + o];
            if (m.squeeze) {
              const float rgb = 1.f / (1.f + expf(-v));
              d = g * rgb * (1.f - rgb);
            } else {
              d = g;
            }
          }
          dbuf[pt * Hm + o] = d;
        }
      }
      __syncthreads();
      float* tmp = xin;
      xin = xout;
      xout = tmp;
    }

    // ---- backward, delta in dbuf
    for (int l = L - 1; l >= 0; --l) {
      const int out = m.out[l];
      int in_l = 0;
      for (int c = 0; c < m.n_comp[l]; ++c) in_l += m.width[l][c];
      if (tid < out) {
        float s = 0.f;
#pragma unroll
        for (int p = 0; p < CB_TILE; ++p) s += dbuf[p * Hm + tid];
        part[m.gb_off[l] + tid] += s;
        cs[tid] = s;
      }
      // this tile's workspace rows of delta
      float* wd = ws + (long long)n * m.wd_off[l];
      for (int e = tid; e < CB_TILE * out; e += blockDim.x) {
        const int p = e / out, o = e - p * out;
        if (p0 + p < n) wd[(long long)(p0 + p) * out + o] = dbuf[p * Hm + o];
      }
      __syncthreads();
      if (bf && tid < out) {             // delta rounded in place
#pragma unroll
        for (int p = 0; p < CB_TILE; ++p)
          dbuf[p * Hm + tid] = bf16r(dbuf[p * Hm + tid]);
      }
      __syncthreads();
      for (int c = 0; c < m.n_comp[l]; ++c) {
        const int kind = m.kind[l][c], width = m.width[l][c];
        const int st = m.start[l][c];
        const float* Wo = Pw + m.wo_off[l];     // (out, in_l)
        if (kind == C_POSE) {
          for (int o = tid; o < out; o += blockDim.x)
            part[m.gs_off[l] + o] += rnd_if(cs[o], bf);
          continue;
        }
        // da[p][k] = sum_o delta[p][o] W[o][st + k], o in order; delta
        // rows read four units at a time
        const bool vec = (out & 3) == 0 && (Hm & 3) == 0;
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
                    *reinterpret_cast<const float4*>(dbuf + p * Hm + o);
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
              acc[p] = fmaf(dbuf[p * Hm + o], w, acc[p]);
          }
#pragma unroll
          for (int p = 0; p < CB_TILE; ++p) {
            if (kind == C_X)
              xbuf[p * Hm + k] = acc[p];
            else if (kind == C_SMALL)
              dsm[p * Sp + k] += acc[p];
            else
              dfe[p * F + k] += acc[p];
          }
        }
      }
      __syncthreads();
      if (l > 0) {
        // next delta: da of x times the ReLU mask of the layer's input
        const int w = m.out[l - 1];
        const float* wx = ws + (long long)n * m.wx_off[l];
        for (int e = tid; e < CB_TILE * w; e += blockDim.x) {
          const int p = e / w, k = e - p * w;
          const bool on = p0 + p < n && wx[(long long)(p0 + p) * w + k] > 0.f;
          dbuf[p * Hm + k] = on ? xbuf[p * Hm + k] : 0.f;
        }
      }
      __syncthreads();
    }
    for (int t = tid; t < CB_TILE * S; t += blockDim.x) {
      const int p = t / S, k = t % S;
      if (p0 + p < n) dsmall_g[(long long)(p0 + p) * S + k] = dsm[p * Sp + k];
    }
    for (int t = tid; t < CB_TILE * F; t += blockDim.x) {
      const int p = t / F;
      if (p0 + p < n) dfeats_g[(long long)p0 * F + t] = dfe[t];
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
  const int Sp = (m.S + 3) & ~3;
  return ((size_t)CB_TILE * (2 * Sp + 2 * m.F + 3 * m.hmax) + m.hmax + m.P)
         * sizeof(float);
}

// The persistent grid for n points: as many blocks as fit on the card at
// once, at most one per tile of the first chunk.
extern "C" int arah_color_bwd_blocks(int n, ColorMeta m) {
  const size_t smem = color_bwd_smem(m);
  if (cudaFuncSetAttribute(color_bwd_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return 0;
  int per_sm = 0, dev = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, color_bwd_kernel, COLOR_THREADS, smem) != cudaSuccess
      || cudaGetDevice(&dev) != cudaSuccess
      || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
             != cudaSuccess)
    return 0;
  const int nc = n < CB_CHUNK ? n : CB_CHUNK;
  const int tiles = (nc + CB_TILE - 1) / CB_TILE;
  const int b = per_sm * sms;
  return b < tiles ? b : tiles;
}

// Floats of the workspace for n points: one chunk's delta and x-input
// rows, then the A^T B reduction's split partials.
extern "C" long long arah_color_bwd_ws(int n, ColorMeta m) {
  const long long nc = n < CB_CHUNK ? n : CB_CHUNK;
  long long mn = 0;
  for (int l = 0; l < m.n_layers; ++l)
    for (int c = 0; c < m.n_comp[l]; ++c) {
      const long long v = (long long)m.out[l] * m.width[l][c];
      mn = v > mn ? v : mn;
    }
  return nc * m.ws_cols + (long long)ATB_MAX_SPLITS * mn;
}

// Per chunk of CB_CHUNK points: the tile kernel (dsmall, dfeats, the
// workspace rows, the per-block partials of db and S), then per layer
// and input part the A^T B reduction into dW of `grads` (zeroed by the
// caller); last, the partials added into `grads` and the pose epilogue.
// feats are f32 here. `partial` holds nblocks x gsize zeroed floats, `ws`
// arah_color_bwd_ws(n, m) floats.
extern "C" int arah_color_bwd(const float* small, const float* feats,
                              const float* pose, const float* g_rgb, int n,
                              const float* params, ColorMeta m,
                              float* dsmall, float* dfeats, float* partial,
                              int nblocks, long long gsize, float* grads,
                              float* ws, void* stream) {
  if (n <= 0 || nblocks <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = color_bwd_smem(m);
  cudaError_t e = cudaFuncSetAttribute(
      color_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long nmax = n < CB_CHUNK ? n : CB_CHUNK;
  float* apart = ws + nmax * m.ws_cols;
  const int outL = m.out[m.n_layers - 1];
  for (int c0 = 0; c0 < n; c0 += CB_CHUNK) {
    const int nc = n - c0 < CB_CHUNK ? n - c0 : CB_CHUNK;
    color_bwd_kernel<<<nblocks, COLOR_THREADS, smem, st>>>(
        small + (long long)c0 * m.S, feats + (long long)c0 * m.F, pose,
        g_rgb + (long long)c0 * outL, nc, params, m,
        dsmall + (long long)c0 * m.S, dfeats + (long long)c0 * m.F, partial,
        gsize, ws);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    for (int l = 0; l < m.n_layers; ++l) {
      const int out = m.out[l];
      int in_l = 0;
      for (int c = 0; c < m.n_comp[l]; ++c) in_l += m.width[l][c];
      const float* D = ws + (long long)nc * m.wd_off[l];
      for (int c = 0; c < m.n_comp[l]; ++c) {
        const int kind = m.kind[l][c], w = m.width[l][c];
        if (kind == C_POSE) continue;
        const float* B;
        int ldb;
        if (kind == C_X) {
          B = ws + (long long)nc * m.wx_off[l];
          ldb = w;
        } else if (kind == C_SMALL) {
          B = small + (long long)c0 * m.S;
          ldb = m.S;
        } else {
          B = feats + (long long)c0 * m.F;
          ldb = m.F;
        }
        const int r = atb_accumulate(D, out, B, ldb, nc, out, w,
                                     m.bf16 != 0, apart,
                                     grads + m.g_off[l] + m.start[l][c],
                                     in_l, st);
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
