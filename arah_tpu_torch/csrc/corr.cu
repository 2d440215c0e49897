// Kernel B: per-point Broyden search of the canonical correspondence,
// fwd_skin(x_hat) = x_bar.
//
// Replaces the TPU kernel arah_tpu/ops/pallas/corr_kernel_t.py:
// corr_search_pallas_t (body _make_kernel): skinning MLP (softplus100
// hidden layers) -> hierarchical softmax of logits*20 -> bone blend ->
// LBS; closed-form 3x3 inverse init Jacobian, good-Broyden rank-1
// updates with +/-eps denominators, best-iterate tracking, convergence at
// |g| < cvg, divergence freeze at |g| >= dvg, masked points frozen at
// their init, and the `active` (still iterating at max_steps) output. The
// init and the per-point step are tile_mlp.cuh's broyden_init and
// broyden_step, which L runs too.
//
// Bound on the H100: operations. Each Broyden iteration of each point
// evaluates the skinning MLP (3x128 + 3x128x128 + 128x25 multiply-adds
// at the flagship widths, ~53k FMAs) plus ~200 flops of softmax and 3x3
// algebra; the bytes are 100 B per point in and out.
//
// Design: one thread per point, so a thread leaves its loop as soon as its
// point converges or diverges (a point's trajectory does not depend on
// the others, so this gives the values of the TPU's per-tile exit). The
// 128-wide hidden activations do not fit in registers; each thread keeps
// its own two activation columns in shared memory (layout [k][thread], so
// a warp's accesses hit 32 banks), and no thread ever waits for another.
// The collapsed MLP weights (~210 KB at the flagship) are read through
// L1/L2 rather than staged in shared memory: every thread of a warp reads
// the same weight, so each load is one broadcast transaction. The bone
// table (24x16) is staged in shared memory. Plain f32 FMAs throughout,
// exact expf/log1pf (no fast math).
#include "tile_mlp.cuh"

#define CORR_THREADS 64
#define MAX_LAYERS 8

struct MlpDims {
  int n_layers;          // linear layers
  int dims[MAX_LAYERS + 1];   // widths: dims[0] = 3, dims[n_layers] = 25
};

// fwd_skin at x (metric canonical): residual xb - x_bar and the blended
// transform T16 (row-major 4x4). hA/hB: this thread's activation columns
// (stride CORR_THREADS).
__device__ void skin_fwd(const float x[3], const float scale,
                         const float off[3], const float xbar[3],
                         const float* __restrict__ P, const MlpDims& md,
                         float* hA, float* hB, const float* bones,
                         float softmax_scale, float g[3], float T[16]) {
  float xn[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) xn[c] = x[c] * scale + off[c];
  const int L = md.n_layers;
  long long wo = 0;
  float* hin = hA;
  float* hout = hB;
  for (int l = 0; l < L; ++l) {
    const int in = md.dims[l], out = md.dims[l + 1];
    const float* W = P + wo;          // (out, in) row-major
    const float* b = W + (long long)out * in;
    for (int j0 = 0; j0 < out; j0 += 8) {
      float acc[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) acc[r] = 0.f;
      for (int k = 0; k < in; ++k) {
        const float hk = (l == 0) ? xn[k] : hin[k * CORR_THREADS];
#pragma unroll
        for (int r = 0; r < 8; ++r)
          if (j0 + r < out)
            acc[r] = fmaf(__ldg(W + (long long)(j0 + r) * in + k), hk,
                          acc[r]);
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        if (j0 + r < out) {
          const float z = acc[r] + __ldg(b + j0 + r);
          hout[(j0 + r) * CORR_THREADS] =
              (l < L - 1) ? softplus100(z) : z * softmax_scale;
        }
      }
    }
    wo += (long long)out * in + out;
    float* t = hin; hin = hout; hout = t;
  }
  // hin now holds the 25 scaled logits
  float c[25], w[N_BONES];
#pragma unroll
  for (int k = 0; k < 25; ++k) c[k] = hin[k * CORR_THREADS];
  hier_softmax(c, w);
#pragma unroll
  for (int m = 0; m < 16; ++m) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < N_BONES; ++j) s = fmaf(bones[j * 16 + m], w[j], s);
    T[m] = s;
  }
#pragma unroll
  for (int r = 0; r < 3; ++r)
    g[r] = T[4 * r] * x[0] + T[4 * r + 1] * x[1] + T[4 * r + 2] * x[2]
           + T[4 * r + 3] - xbar[r];
}

__global__ void __launch_bounds__(CORR_THREADS)
corr_kernel(const float* __restrict__ xbar_g, const float* __restrict__ x0_g,
            const float* __restrict__ t0_g,
            const unsigned char* __restrict__ mask_g, int n,
            const float* __restrict__ P, MlpDims md, int hmax,
            const float* __restrict__ bones_g,
            const float* __restrict__ frame_g, int max_steps, float cvg,
            float dvg, float eps, float softmax_scale, float* xout,
            float* tout, unsigned char* valid_out,
            unsigned char* active_out) {
  extern __shared__ float smem[];
  __shared__ float bones[N_BONES * 16];
  for (int k = threadIdx.x; k < N_BONES * 16; k += blockDim.x)
    bones[k] = bones_g[k];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;   // no block-wide synchronisation below
  float* hA = smem + threadIdx.x;
  float* hB = hA + hmax * CORR_THREADS;

  // normalize: ((x - center - cmin + 0.05 ext) / ext / 1.1 - 0.5) * 2
  const float cmin = frame_g[0], cmax = frame_g[1];
  const float ext = cmax - cmin;
  const float scale = 2.f / (ext * 1.1f);
  float off[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    off[c] = (-frame_g[2 + c] - cmin + 0.05f * ext) * scale - 1.f;

  float xbar[3], x[3], x0[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    xbar[c] = xbar_g[3 * i + c];
    x0[c] = x0_g[3 * i + c];
    x[c] = x0[c];
  }
  const bool mask0 = mask_g[i] != 0;

  float gx[3], T[16], Ji[9], upd[3];
  skin_fwd(x, scale, off, xbar, P, md, hA, hB, bones, softmax_scale, gx, T);
  float gn_opt = broyden_init(T, gx, Ji, upd);
  float x_opt[3] = {x[0], x[1], x[2]};
  float t_opt[16];
#pragma unroll
  for (int m = 0; m < 16; ++m) t_opt[m] = t0_g[16 * i + m];

  bool active = mask0;
  for (int it = 0; it < max_steps && active; ++it) {
    float dx[3], xn[3], gn_v[3], Tn[16];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      dx[c] = upd[c];
      xn[c] = x[c] + dx[c];
    }
    skin_fwd(xn, scale, off, xbar, P, md, hA, hB, bones, softmax_scale,
             gn_v, Tn);
    bool better;
    active = broyden_step(Ji, gx, upd, gn_opt, better, dx, gn_v, cvg, dvg,
                          eps);
    if (better) {
#pragma unroll
      for (int c = 0; c < 3; ++c) x_opt[c] = xn[c];
#pragma unroll
      for (int m = 0; m < 16; ++m) t_opt[m] = Tn[m];
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) x[c] = xn[c];
  }

#pragma unroll
  for (int c = 0; c < 3; ++c) xout[3 * i + c] = mask0 ? x_opt[c] : x0[c];
#pragma unroll
  for (int m = 0; m < 16; ++m)
    tout[16 * i + m] = mask0 ? t_opt[m] : t0_g[16 * i + m];
  valid_out[i] = (mask0 && gn_opt < cvg) ? 1 : 0;
  active_out[i] = active ? 1 : 0;
}

extern "C" int arah_corr(const float* xbar, const float* x0, const float* t0,
                         const unsigned char* mask, int n, const float* params,
                         MlpDims md, int hmax, const float* bones16,
                         const float* frame, int max_steps, float cvg,
                         float dvg, float eps, float softmax_scale,
                         float* xout, float* tout, unsigned char* valid,
                         unsigned char* active, void* stream) {
  if (n <= 0) return 0;
  const size_t smem = 2 * (size_t)hmax * CORR_THREADS * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      corr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (n + CORR_THREADS - 1) / CORR_THREADS;
  corr_kernel<<<blocks, CORR_THREADS, smem, (cudaStream_t)stream>>>(
      xbar, x0, t0, mask, n, params, md, hmax, bones16, frame, max_steps,
      cvg, dvg, eps, softmax_scale, xout, tout, valid, active);
  return launch_status();
}
