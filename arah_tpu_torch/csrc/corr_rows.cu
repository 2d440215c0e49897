// Kernel L: the canonical-correspondence Broyden search,
// fwd_skin(x_hat) = x_bar, in the row layout with a per-tile exit.
//
// Replaces the TPU kernel arah_tpu/ops/pallas/corr_kernel.py:
// corr_search_pallas (body _make_kernel), the (T, k) layout that kernel B
// superseded: the same solve as B (collapsed skinning MLP with softplus100
// hidden layers -> hierarchical softmax of the scaled logits -> bone blend
// -> LBS; adjugate-inverse init Jacobian from the blend at x0; good-Broyden
// rank-1 updates with +/-eps denominators; best-iterate tracking;
// convergence at |g| < cvg, divergence freeze at |g| >= dvg), with the
// weights given pre-transposed (in, out), masked points returning x0 and
// T0, and no `active` output.
//
// Bound on the H100: operations, as B: per Broyden iteration of a point
// the skinning MLP's multiply-adds (3x128 + 3x128x128 + 128x25, ~53 k at
// the flagship) plus ~200 flops of softmax, blend and 3x3 algebra; the
// bytes are ~100 B per point in and out.
//
// Design: the tile of kernel F (csrc/tile_mlp.cuh), where B runs one thread
// per point. 256 threads own 16 points; each Broyden iteration runs the
// skinning MLP as tile products through shared memory (tile_dense: the
// 128-wide layers on all 256 threads, the 25-logit layer on 50), the
// softmax on one thread per point, the bone blend on 16 threads per point,
// then one thread per point does the LBS residual, the rank-1 update and
// the best iterate (tile_mlp.cuh:broyden_init/broyden_step, B's own
// step). The tile loops while any of its points is active
// (__syncthreads_or, as the TPU's per-tile exit); finished points stay
// frozen, so each point's values are those of a per-point exit.
#include "tile_mlp.cuh"

__global__ void __launch_bounds__(TILE_THREADS)
corr_rows_kernel(const float* __restrict__ xbar_g,
                 const float* __restrict__ x0_g,
                 const float* __restrict__ t0_g,
                 const unsigned char* __restrict__ mask_g, int n,
                 const float* __restrict__ bones_g,
                 const float* __restrict__ frame_g,
                 const float* __restrict__ P, NetMeta m, int max_steps,
                 float cvg, float dvg, float eps, float softmax_scale,
                 float* __restrict__ x_out, float* __restrict__ t_out,
                 unsigned char* __restrict__ valid_out) {
  __shared__ __align__(16) float hbuf[TILE_RAYS * TILE_LD];
  __shared__ float bones[N_BONES * 16];
  __shared__ float s_xbar[TILE_RAYS][3], s_x[TILE_RAYS][3];
  __shared__ float s_xn[TILE_RAYS][3], s_dx[TILE_RAYS][3];
  __shared__ float s_gx[TILE_RAYS][3], s_g[TILE_RAYS][3];
  __shared__ float s_J[TILE_RAYS][9], s_upd[TILE_RAYS][3];
  __shared__ float s_xopt[TILE_RAYS][3], s_topt[TILE_RAYS][16];
  __shared__ float s_T[TILE_RAYS][16], s_w[TILE_RAYS][N_BONES];
  __shared__ float s_gnopt[TILE_RAYS];
  __shared__ int s_act[TILE_RAYS], s_mask[TILE_RAYS];

  const int j = threadIdx.x;
  const int r0 = blockIdx.x * TILE_RAYS;
  const int p = j >> 4, lane = j & 15;    // (point, entry) of the blend
  const FrameAffine fa = frame_affine(frame_g);
  for (int k = j; k < N_BONES * 16; k += blockDim.x) bones[k] = bones_g[k];
  if (j < TILE_RAYS) {
    const int r = r0 + j;
    const bool in = r < n;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      s_xbar[j][c] = in ? xbar_g[3 * r + c] : 0.f;
      s_xn[j][c] = s_x[j][c] = s_xopt[j][c] = in ? x0_g[3 * r + c] : 0.f;
    }
    for (int c = 0; c < 16; ++c) s_topt[j][c] = in ? t0_g[16 * r + c] : 0.f;
    s_mask[j] = s_act[j] = in && mask_g[r] != 0;
  }
  __syncthreads();

  // fwd_skin at s_xn -> s_g (residual) and s_T (blended transform)
  auto eval = [&]() {
    if (j < TILE_RAYS) {
#pragma unroll
      for (int c = 0; c < 3; ++c)
        hbuf[j * TILE_LD + c] = s_xn[j][c] * fa.nscale + fa.noff[c];
    }
    __syncthreads();
    for (int l = 0; l < m.n_skin; ++l)
      tile_dense(hbuf, m.skin_dims[l], P + m.skin_wt_off[l],
                 P + m.skin_b_off[l], m.skin_dims[l + 1], l == m.n_skin - 1,
                 softmax_scale);
    if (j < TILE_RAYS) hier_softmax(hbuf + j * TILE_LD, s_w[j]);
    __syncthreads();
    {
      float s = 0.f;
#pragma unroll
      for (int b = 0; b < N_BONES; ++b)
        s = fmaf(s_w[p][b], bones[b * 16 + lane], s);
      s_T[p][lane] = s;
    }
    __syncthreads();
    if (j < TILE_RAYS) {
      const float* T = s_T[j];
      const float* x = s_xn[j];
#pragma unroll
      for (int c = 0; c < 3; ++c)
        s_g[j][c] = T[4 * c] * x[0] + T[4 * c + 1] * x[1]
                    + T[4 * c + 2] * x[2] + T[4 * c + 3] - s_xbar[j][c];
    }
    __syncthreads();
  };

  eval();
  if (j < TILE_RAYS) {
#pragma unroll
    for (int c = 0; c < 3; ++c) s_gx[j][c] = s_g[j][c];
    s_gnopt[j] = broyden_init(s_T[j], s_gx[j], s_J[j], s_upd[j]);
  }

  for (int it = 0; it < max_steps; ++it) {
    if (!__syncthreads_or(j < TILE_RAYS && s_act[j])) break;
    if (j < TILE_RAYS) {
      const bool a = s_act[j] != 0;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        s_dx[j][c] = a ? s_upd[j][c] : 0.f;
        s_xn[j][c] = s_x[j][c] + s_dx[j][c];
      }
    }
    __syncthreads();
    eval();
    // a finished point stays frozen: its x, residual, Ji and step unchanged
    if (j < TILE_RAYS && s_act[j]) {
      bool better;
      s_act[j] = broyden_step(s_J[j], s_gx[j], s_upd[j], s_gnopt[j],
                              better, s_dx[j], s_g[j], cvg, dvg, eps);
      if (better) {
#pragma unroll
        for (int c = 0; c < 3; ++c) s_xopt[j][c] = s_xn[j][c];
        for (int c = 0; c < 16; ++c) s_topt[j][c] = s_T[j][c];
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) s_x[j][c] = s_xn[j][c];
    }
  }
  __syncthreads();
  if (r0 + p < n) {
    const int r = r0 + p;
    const bool mk = s_mask[p] != 0;
    t_out[16 * r + lane] = mk ? s_topt[p][lane] : t0_g[16 * r + lane];
    if (lane < 3) x_out[3 * r + lane] = mk ? s_xopt[p][lane]
                                           : x0_g[3 * r + lane];
    if (lane == 0) valid_out[r] = (mk && s_gnopt[p] < cvg) ? 1 : 0;
  }
}

extern "C" int arah_corr_rows(const float* xbar, const float* x0,
                              const float* t0, const unsigned char* mask,
                              int n, const float* bones16,
                              const float* frame, const float* params,
                              NetMeta m, int max_steps, float cvg, float dvg,
                              float eps, float softmax_scale, float* x_out,
                              float* t_out, unsigned char* valid,
                              void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + TILE_RAYS - 1) / TILE_RAYS;
  corr_rows_kernel<<<blocks, TILE_THREADS, 0, (cudaStream_t)stream>>>(
      xbar, x0, t0, mask, n, bones16, frame, params, m, max_steps, cvg, dvg,
      eps, softmax_scale, x_out, t_out, valid);
  return launch_status();
}
