// Kernel C: fused generated-SIREN shading — SDF, the penultimate feature
// and the spatial normal d(sdf)/dx in one pass.
//
// Replaces the TPU kernel arah_tpu/ops/pallas/shade_kernel.py:_shade_pallas
// (body _shade_kernel, wrapper siren_shade_pallas): the FiLM-SIREN forward
// h <- sin(30 (f * (h W^T + b) + p)) keeping the 30 f cos(30 z) factors,
// then the reverse chain g <- (g * df_i) W_i from the SDF row of the last
// weight matrix down to the input.
//
// Bound on the H100: operations. A point costs ~2 x 5 x 256^2 multiply-adds
// (forward and reverse through the hidden layers) against 12 B in and
// ~1 KB of features out; the ~1.8 MB of generated weights stay in L2.
//
// Design: a block of 256 threads (one per hidden unit) shades a tile of 16
// points. The TPU kept six (tile, 256) f32 factor arrays in VMEM; here a
// 16-point tile's factors (6 x 16 x 256 x 4 B = 96 KB) and its current
// activations (16 KB) sit in shared memory, so no layer's output goes to
// device memory. Thread j computes unit j for all 16 points: each weight it
// loads (coalesced, from the transposed forward copy or the original
// (out, in) layout for the reverse products) feeds 16 FMAs, and the
// activations come from shared memory as float4 broadcasts. Under
// bf16_shading the operands are rounded with __float2bfloat16_rn at the
// places _shade_kernel rounds them (every dot operand, including g * df
// before each reverse product) and accumulated in f32.
#include "common.cuh"

#define SHADE_THREADS 256
#define SHADE_TILE 16
#define MAX_LAYERS 8

struct ShadeMeta {
  int n_layers, din, hidden, dout, film, bf16;
  long long wt_off[MAX_LAYERS];   // (in, out) copies for the forward
  long long w_off[MAX_LAYERS];    // original (out, in) for the reverse
  long long b_off[MAX_LAYERS];
  long long freq_off, phase_off;  // (L-1, hidden) each, if film
};

__global__ void __launch_bounds__(SHADE_THREADS)
shade_kernel(const float* __restrict__ x_g, int n,
             const float* __restrict__ P, ShadeMeta m,
             float* __restrict__ sdf_out, void* __restrict__ feat_out,
             float* __restrict__ grad_out) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float xs[SHADE_TILE * 4];
  const int H = m.hidden, L = m.n_layers, din = m.din;
  const bool bf = m.bf16 != 0;
  float* hbuf = smem;                          // [TILE][H]
  float* dfs = smem + SHADE_TILE * H;          // [L-1][TILE][H]
  const int j = threadIdx.x;
  const int p0 = blockIdx.x * SHADE_TILE;

  for (int t = j; t < SHADE_TILE * din; t += blockDim.x) {
    const int p = t / din;
    xs[t] = (p0 + p < n) ? rnd_if(x_g[(long long)p0 * din + t], bf) : 0.f;
  }
  __syncthreads();

  // ---- forward through the sine layers
  for (int i = 0; i < L - 1; ++i) {
    const int in = (i == 0) ? din : H;
    const float* Wt = P + m.wt_off[i];       // (in, H)
    float acc[SHADE_TILE];
#pragma unroll
    for (int p = 0; p < SHADE_TILE; ++p) acc[p] = 0.f;
    if (j < H) {
      if (i == 0) {
        for (int k = 0; k < in; ++k) {
          const float w = rnd_if(__ldg(Wt + (long long)k * H + j), bf);
#pragma unroll
          for (int p = 0; p < SHADE_TILE; ++p)
            acc[p] = fmaf(xs[p * din + k], w, acc[p]);
        }
      } else {
        for (int k = 0; k < in; k += 4) {
          const float w0 = rnd_if(__ldg(Wt + (long long)k * H + j), bf);
          const float w1 = rnd_if(__ldg(Wt + (long long)(k + 1) * H + j), bf);
          const float w2 = rnd_if(__ldg(Wt + (long long)(k + 2) * H + j), bf);
          const float w3 = rnd_if(__ldg(Wt + (long long)(k + 3) * H + j), bf);
#pragma unroll
          for (int p = 0; p < SHADE_TILE; ++p) {
            const float4 h4 =
                *reinterpret_cast<const float4*>(hbuf + p * H + k);
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
      float* df = dfs + (long long)i * SHADE_TILE * H;
#pragma unroll
      for (int p = 0; p < SHADE_TILE; ++p) {
        float z = acc[p] + b;
        if (m.film) z = f * z + ph;
        float s, c;
        sincosf(30.f * z, &s, &c);
        df[p * H + j] = m.film ? 30.f * f * c : 30.f * c;
        hbuf[p * H + j] = rnd_if(s, bf);
        if (i == L - 2 && p0 + p < n) {
          const long long o = (long long)(p0 + p) * H + j;
          if (bf)
            reinterpret_cast<__nv_bfloat16*>(feat_out)[o] =
                __float2bfloat16_rn(s);
          else
            reinterpret_cast<float*>(feat_out)[o] = s;
        }
      }
    }
    __syncthreads();
  }

  // ---- last linear layer: one thread per (point, output)
  const float* WL = P + m.w_off[L - 1];      // (dout, H)
  if (j < SHADE_TILE * m.dout) {
    const int p = j / m.dout, o = j % m.dout;
    float a = 0.f;
    for (int k = 0; k < H; ++k)
      a = fmaf(hbuf[p * H + k], rnd_if(__ldg(WL + (long long)o * H + k), bf),
               a);
    if (p0 + p < n)
      sdf_out[(long long)(p0 + p) * m.dout + o] =
          a + __ldg(P + m.b_off[L - 1] + o);
  }
  __syncthreads();

  // ---- reverse chain, seeded with the SDF row of the last weights
  if (j < H) {
    const float g0 = __ldg(WL + j);
#pragma unroll
    for (int p = 0; p < SHADE_TILE; ++p) hbuf[p * H + j] = g0;
  }
  __syncthreads();
  for (int i = L - 2; i >= 0; --i) {
    float* df = dfs + (long long)i * SHADE_TILE * H;
    if (j < H) {
#pragma unroll
      for (int p = 0; p < SHADE_TILE; ++p)
        df[p * H + j] = rnd_if(hbuf[p * H + j] * df[p * H + j], bf);
    }
    __syncthreads();
    const int in = (i == 0) ? din : H;
    const float* W = P + m.w_off[i];         // (H, in)
    if (j < in) {
      float acc[SHADE_TILE];
#pragma unroll
      for (int p = 0; p < SHADE_TILE; ++p) acc[p] = 0.f;
      for (int k = 0; k < H; k += 4) {
        const float w0 = rnd_if(__ldg(W + (long long)k * in + j), bf);
        const float w1 = rnd_if(__ldg(W + (long long)(k + 1) * in + j), bf);
        const float w2 = rnd_if(__ldg(W + (long long)(k + 2) * in + j), bf);
        const float w3 = rnd_if(__ldg(W + (long long)(k + 3) * in + j), bf);
#pragma unroll
        for (int p = 0; p < SHADE_TILE; ++p) {
          const float4 g4 = *reinterpret_cast<const float4*>(df + p * H + k);
          float a = acc[p];
          a = fmaf(g4.x, w0, a);
          a = fmaf(g4.y, w1, a);
          a = fmaf(g4.z, w2, a);
          a = fmaf(g4.w, w3, a);
          acc[p] = a;
        }
      }
#pragma unroll
      for (int p = 0; p < SHADE_TILE; ++p) {
        if (i > 0)
          hbuf[p * H + j] = acc[p];
        else if (p0 + p < n)
          grad_out[(long long)(p0 + p) * din + j] = acc[p];
      }
    }
    __syncthreads();
  }
}

extern "C" int arah_shade(const float* x, int n, const float* params,
                          ShadeMeta m, float* sdf, void* feat, float* grad,
                          void* stream) {
  if (n <= 0) return 0;
  const size_t smem = (size_t)SHADE_TILE * m.hidden * m.n_layers
                      * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      shade_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (n + SHADE_TILE - 1) / SHADE_TILE;
  shade_kernel<<<blocks, SHADE_THREADS, smem, (cudaStream_t)stream>>>(
      x, n, params, m, sdf, feat, grad);
  return launch_status();
}
