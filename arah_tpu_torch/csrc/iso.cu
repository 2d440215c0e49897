// Kernel F: the joint (canonical point, depth) iso-surface Broyden of a
// ray tile.
//
// Replaces the TPU kernel arah_tpu/ops/pallas/iso_kernel.py:
// iso_refine_pallas (body _make_kernel). Per ray, Broyden on u = (x_hat,
// z) for g(u) = [sdf(x_hat); fwd_skin(x_hat) - (cam + z dir - trans)]:
// collapsed skinning MLP (softplus100 hidden layers) -> hierarchical
// softmax of the scaled logits -> bone blend -> LBS, and the generated
// SIREN at the same normalised point; starting from the given inverse
// Jacobian, good-Broyden rank-1 updates with +/-eps denominators,
// best-iterate tracking, convergence at |g| < cvg, divergence freeze at
// |g| >= dvg, masked rays frozen at u0/T0, and the `active` (still
// iterating at exit) output. The tile stops when none of its rays is
// active (per-ray values as the TPU's per-tile exit).
//
// Bound on the H100: operations. A ray-iteration costs the SIREN's ~0.33 M
// multiply-adds plus the skinning MLP's ~53 k (3x128 + 3x128x128 +
// 128x25 at the flagship) and ~200 flops of softmax, blend and 4x4
// algebra; the bytes are ~200 B per ray in and out.
//
// Design: kernel C's tile (csrc/tile_mlp.cuh): 256 threads own 16 rays.
// Both networks run on the same threads, one layer at a time, with the
// tile's activations in shared memory (the 128-wide skinning layers split
// the rays between two groups of 128 threads). The rays' Broyden state
// (u, g, J^-1, update, best iterate and T16) lives in shared memory; the
// 4x4 algebra of ray p is done by thread p, the bone blend by 16 threads
// per ray.
#include "tile_mlp.cuh"

__global__ void __launch_bounds__(TILE_THREADS)
iso_kernel(const float* __restrict__ cam_g, const float* __restrict__ dir_g,
           const float* __restrict__ u0_g, const float* __restrict__ t0_g,
           const float* __restrict__ jinv0_g,
           const unsigned char* __restrict__ mask_g, int n,
           const float* __restrict__ bones_g,
           const float* __restrict__ frame_g, const float* __restrict__ P,
           NetMeta m, int max_steps, float cvg, float dvg, float eps,
           float softmax_scale, float* __restrict__ u_out,
           float* __restrict__ t_out, unsigned char* __restrict__ valid_out,
           unsigned char* __restrict__ active_out) {
  __shared__ __align__(16) float hbuf[TILE_RAYS * TILE_LD];
  __shared__ float bones[N_BONES * 16];
  __shared__ float s_cam[TILE_RAYS][3], s_dir[TILE_RAYS][3];
  __shared__ float s_u[TILE_RAYS][4], s_gx[TILE_RAYS][4];
  __shared__ float s_J[TILE_RAYS][16], s_upd[TILE_RAYS][4];
  __shared__ float s_du[TILE_RAYS][4], s_un[TILE_RAYS][4];
  __shared__ float s_uopt[TILE_RAYS][4], s_topt[TILE_RAYS][16];
  __shared__ float s_gnopt[TILE_RAYS];
  __shared__ int s_act[TILE_RAYS], s_mask[TILE_RAYS];
  __shared__ float s_g[TILE_RAYS][4], s_T[TILE_RAYS][16];
  __shared__ float s_w[TILE_RAYS][N_BONES], s_xn[TILE_RAYS][3];
  __shared__ float s_sdf[TILE_RAYS];

  const int j = threadIdx.x;
  const int r0 = blockIdx.x * TILE_RAYS;
  const int p = j >> 4, lane = j & 15;    // (ray, entry) of the bone blend
  const FrameAffine fa = frame_affine(frame_g);
  for (int k = j; k < N_BONES * 16; k += blockDim.x) bones[k] = bones_g[k];
  if (j < TILE_RAYS) {
    const int r = r0 + j;
    const bool in = r < n;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      s_cam[j][c] = in ? cam_g[3 * r + c] : 0.f;
      s_dir[j][c] = in ? dir_g[3 * r + c] : 0.f;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) s_un[j][c] = s_u[j][c] =
        in ? u0_g[4 * r + c] : 0.f;
    for (int c = 0; c < 16; ++c) {
      s_J[j][c] = in ? jinv0_g[16 * r + c] : 0.f;
      s_topt[j][c] = in ? t0_g[16 * r + c] : 0.f;
    }
    s_mask[j] = s_act[j] = in && mask_g[r] != 0;
  }
  __syncthreads();

  // g at s_un -> s_g (residual [sdf, corr]) and s_T (blended transform)
  auto eval = [&]() {
    if (j < TILE_RAYS) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float xn = s_un[j][c] * fa.nscale + fa.noff[c];
        s_xn[j][c] = xn;
        hbuf[j * TILE_LD + c] = xn;
      }
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
      const float* x = s_un[j];
      const float z = x[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float xb = T[4 * c] * x[0] + T[4 * c + 1] * x[1]
                         + T[4 * c + 2] * x[2] + T[4 * c + 3];
        s_g[j][1 + c] = xb - ((s_cam[j][c] + z * s_dir[j][c])
                              - fa.trans[c]);
        hbuf[j * TILE_LD + c] = s_xn[j][c];
      }
    }
    __syncthreads();
    tile_siren(hbuf, P, m, s_sdf);
    if (j < TILE_RAYS) s_g[j][0] = s_sdf[j] * fa.mscale;
    __syncthreads();
  };

  eval();
  if (j < TILE_RAYS) {
    const float* J = s_J[j];
    const float* g = s_g[j];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      s_gx[j][r] = g[r];
      s_upd[j][r] = -(J[4 * r] * g[0] + J[4 * r + 1] * g[1]
                      + J[4 * r + 2] * g[2] + J[4 * r + 3] * g[3]);
      s_uopt[j][r] = s_u[j][r];
    }
    s_gnopt[j] = sqrtf(g[0] * g[0] + g[1] * g[1] + g[2] * g[2]
                       + g[3] * g[3]);
  }

  for (int it = 0; it < max_steps; ++it) {
    if (!__syncthreads_or(j < TILE_RAYS && s_act[j])) break;
    if (j < TILE_RAYS) {
      const bool a = s_act[j] != 0;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s_du[j][c] = a ? s_upd[j][c] : 0.f;
        s_un[j][c] = s_u[j][c] + s_du[j][c];
      }
    }
    __syncthreads();
    eval();
    if (j < TILE_RAYS) {
      const bool a = s_act[j] != 0;
      float* J = s_J[j];
      float gn_v[4], dg[4], du[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        gn_v[c] = a ? s_g[j][c] : s_gx[j][c];
        dg[c] = gn_v[c] - s_gx[j][c];
        du[c] = s_du[j][c];
      }
      const float gn = sqrtf(gn_v[0] * gn_v[0] + gn_v[1] * gn_v[1]
                             + gn_v[2] * gn_v[2] + gn_v[3] * gn_v[3]);
      if (gn < s_gnopt[j] && a) {
#pragma unroll
        for (int c = 0; c < 4; ++c) s_uopt[j][c] = s_un[j][c];
        for (int c = 0; c < 16; ++c) s_topt[j][c] = s_T[j][c];
        s_gnopt[j] = gn;
      }
      const bool act_new = s_gnopt[j] > cvg && gn < dvg && a;
      if (a) {
        float vT[4], av[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          vT[c] = du[0] * J[c] + du[1] * J[4 + c] + du[2] * J[8 + c]
                  + du[3] * J[12 + c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          av[r] = du[r] - (J[4 * r] * dg[0] + J[4 * r + 1] * dg[1]
                           + J[4 * r + 2] * dg[2] + J[4 * r + 3] * dg[3]);
        float bd = vT[0] * dg[0] + vT[1] * dg[1] + vT[2] * dg[2]
                   + vT[3] * dg[3];
        bd = (bd >= 0.f) ? bd + eps : bd - eps;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float uv = av[r] / bd;
#pragma unroll
          for (int c = 0; c < 4; ++c) J[4 * r + c] += uv * vT[c];
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        s_upd[j][r] = -(J[4 * r] * gn_v[0] + J[4 * r + 1] * gn_v[1]
                        + J[4 * r + 2] * gn_v[2] + J[4 * r + 3] * gn_v[3]);
        s_u[j][r] = s_un[j][r];
        s_gx[j][r] = gn_v[r];
      }
      s_act[j] = act_new;
    }
  }
  __syncthreads();
  if (r0 + p < n) {
    const int r = r0 + p;
    const bool mk = s_mask[p] != 0;
    t_out[16 * r + lane] = mk ? s_topt[p][lane] : t0_g[16 * r + lane];
    if (lane < 4) u_out[4 * r + lane] = mk ? s_uopt[p][lane]
                                           : u0_g[4 * r + lane];
    if (lane == 0) {
      valid_out[r] = (mk && s_gnopt[p] < cvg) ? 1 : 0;
      active_out[r] = s_act[p] ? 1 : 0;
    }
  }
}

extern "C" int arah_iso(const float* cam, const float* dirs, const float* u0,
                        const float* t0, const float* jinv0,
                        const unsigned char* mask, int n,
                        const float* bones16, const float* frame,
                        const float* params, NetMeta m, int max_steps,
                        float cvg, float dvg, float eps, float softmax_scale,
                        float* u_out, float* t_out, unsigned char* valid,
                        unsigned char* active, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + TILE_RAYS - 1) / TILE_RAYS;
  iso_kernel<<<blocks, TILE_THREADS, 0, (cudaStream_t)stream>>>(
      cam, dirs, u0, t0, jinv0, mask, n, bones16, frame, params, m,
      max_steps, cvg, dvg, eps, softmax_scale, u_out, t_out, valid, active);
  return launch_status();
}
