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
