// Kernel F: the joint (canonical point, depth) iso-surface Broyden, rays
// from a device-side queue.
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
// iterating at exit) output (per-ray values as the TPU's per-tile exit).
//
// Bound on the H100: operations. A residual evaluation costs the SIREN's
// ~0.33 M multiply-adds plus the skinning MLP's ~53 k (3x128 + 3x128x128 +
// 128x25 at the flagship) and ~200 flops of softmax, blend and 4x4
// algebra; the bytes are ~200 B per ray in and out.
//
// Design (csrc/stream_mlp.cuh): a persistent grid whose CTAs (or
// clusters) own R ray slots each. An empty slot takes the next unmasked
// ray from a global atomic counter (masked rays are written at once, at
// u0/T0); the ray's first pass evaluates g at u0 (the init), every later
// one at u + upd (a Broyden iteration), so a slot just refilled and a slot
// mid-solve share one pass through both networks, which runs on the live
// slots only, compacted. A ray that converges, diverges or reaches
// max_steps writes its outputs and frees its slot. Both
// networks run as one stream_mlp.cuh pass (the skinning layers, the
// softmax, blend and residual, then the SIREN layers) with every layer's
// weights streamed through the shared-memory ring; the slots' Broyden
// state lives in shared memory, its 4x4 algebra on one thread a slot, the
// bone blend on 16.
#include "stream_mlp.cuh"

struct IsoArgs {
  const float *cam, *dir, *u0, *t0, *jinv0;
  const unsigned char* mask;
  int n;
  const float *bones, *frame, *P;
  NetMeta m;
  int max_steps;
  float cvg, dvg, eps, softmax_scale;
  int* counters;          // [0] the ray queue
  float *u_out, *t_out;
  unsigned char *valid_out, *active_out;
  int* iters_out;         // may be null
};

template <class S>
__global__ void __launch_bounds__(S::NT, S::MINB)
iso_kernel(const IsoArgs a) {
  constexpr int R = S::R, C = S::C;
  extern __shared__ __align__(16) float smem[];
  float* act = smem;                       // [2][SM_MAXW][LDA]
  float* ring = smem + 2 * S::ABUF;        // [ST][KC][CU]
  __shared__ PassTable pt;
  __shared__ float bones[N_BONES * 16];
  __shared__ int s_ray[R], s_new[R], s_it[R], s_init[R];
  __shared__ int s_exhausted, s_nl, s_list[R];
  __shared__ float s_cam[R][3], s_dir[R][3];
  __shared__ float s_u[R][4], s_gx[R][4];
  __shared__ float s_J[R][16], s_upd[R][4];
  __shared__ float s_du[R][4], s_un[R][4];
  __shared__ float s_uopt[R][4], s_topt[R][16];
  __shared__ float s_gnopt[R];
  __shared__ float s_g[R][4], s_T[R][16];
  __shared__ float s_w[R][N_BONES], s_xn[R][3];
  __shared__ float s_sdf[R];

  const int j = threadIdx.x;
  int rank = 0;
  if constexpr (C > 1) rank = (int)cg::this_cluster().block_rank();
  const FrameAffine fa = frame_affine(a.frame);
  const NetMeta& m = a.m;
  for (int k = j; k < N_BONES * 16; k += S::NT) bones[k] = a.bones[k];
  if (j < R) s_ray[j] = -1;
  if (j == 0) {
    s_exhausted = 0;
    pass_table(pt, m, true, C, S::KC);
  }
  if constexpr (C > 1) cg::this_cluster().sync();
  else __syncthreads();
  ring_start<S>(ring, pt, a.P, rank);
  int g = 0;                               // the ring's next chunk

  // ray r's outputs (leader only)
  auto write = [&](int r, const float* u, const float* T, bool valid,
                   bool active, int it) {
#pragma unroll
    for (int c = 0; c < 4; ++c) a.u_out[4 * r + c] = u[c];
    for (int c = 0; c < 16; ++c) a.t_out[16 * r + c] = T[c];
    a.valid_out[r] = valid ? 1 : 0;
    a.active_out[r] = active ? 1 : 0;
    if (a.iters_out) a.iters_out[r] = it;
  };

  for (;;) {
    // ---- refill: the leader takes the next unmasked rays for the empty
    // slots (masked rays keep u0 and T0)
    if (rank == 0 && j < R && s_ray[j] < 0) {
      int r = -1;
      while (!*(volatile int*)&s_exhausted) {
        const int c = atomicAdd(a.counters, 1);
        if (c >= a.n) {
          s_exhausted = 1;
          break;
        }
        if (a.mask[c]) {
          r = c;
          break;
        }
        write(c, a.u0 + 4 * c, a.t0 + 16 * c, false, false, 0);
      }
      s_new[j] = r;
    }
    if constexpr (C > 1) cg::this_cluster().sync();
    else __syncthreads();
    if (j < R && s_ray[j] < 0) {
      int r = s_new[j];
      if constexpr (C > 1) r = *cg::this_cluster().map_shared_rank(&s_new[j], 0);
      s_ray[j] = r;
      if (r >= 0) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          s_cam[j][c] = a.cam[3 * r + c];
          s_dir[j][c] = a.dir[3 * r + c];
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) s_un[j][c] = s_u[j][c] = a.u0[4 * r + c];
        for (int c = 0; c < 16; ++c) {
          s_J[j][c] = a.jinv0[16 * r + c];
          s_topt[j][c] = a.t0[16 * r + c];
        }
        s_init[j] = 1;
        s_it[j] = 0;
      }
    }
    if (!__syncthreads_or(j < R && s_ray[j] >= 0)) break;

    // ---- g at s_un -> s_g (residual [sdf, corr]) and s_T (blend), on
    // the live slots compacted to positions [0, nl) of s_list (positions
    // past nl feed zeros; their results are not read)
    const int nl = live_list<S>(s_ray, s_list, &s_nl);
    if (j < R) {
      const int p = j < nl ? s_list[j] : 0;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float xn = j < nl ? s_un[p][c] * fa.nscale + fa.noff[c] : 0.f;
        if (j < nl) s_xn[p][c] = xn;
        act[c * S::LDA + j] = xn;
      }
    }
    const int lg = run_layers<S>(pt, 0, m.n_skin, act, 0, ring, g, a.P, m,
                                 a.softmax_scale, rank, nl);
    if (j < nl) {
      float c25[25];
#pragma unroll
      for (int u = 0; u < 25; ++u) c25[u] = act[lg * S::ABUF + u * S::LDA + j];
      hier_softmax(c25, s_w[s_list[j]]);
    }
    __syncthreads();
    for (int e = j; e < nl * 16; e += S::NT) {
      const int p = s_list[e >> 4], lane = e & 15;
      float s = 0.f;
#pragma unroll
      for (int b = 0; b < N_BONES; ++b)
        s = fmaf(s_w[p][b], bones[b * 16 + lane], s);
      s_T[p][lane] = s;
    }
    __syncthreads();
    float* xin = act + lg * S::ABUF;       // the SIREN's input rows
    if (j < R) {
      if (j < nl) {
        const int p = s_list[j];
        const float* T = s_T[p];
        const float* x = s_un[p];
        const float z = x[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float xb = T[4 * c] * x[0] + T[4 * c + 1] * x[1]
                           + T[4 * c + 2] * x[2] + T[4 * c + 3];
          s_g[p][1 + c] = xb - ((s_cam[p][c] + z * s_dir[p][c])
                                - fa.trans[c]);
        }
#pragma unroll
        for (int c = 0; c < 3; ++c) xin[c * S::LDA + j] = s_xn[p][c];
      } else {
#pragma unroll
        for (int c = 0; c < 3; ++c) xin[c * S::LDA + j] = 0.f;
      }
    }
    // the SIREN starts on the logits' buffer (stream_mlp.cuh's buffer rule:
    // on a cluster its first epilogue must not reach a CTA still reading
    // the logits)
    const int out = run_layers<S>(pt, m.n_skin, pt.n, act, lg, ring, g, a.P,
                                  m, 1.f, rank, nl);
    siren_out<S>(act + out * S::ABUF, a.P, m, s_list, nl, s_sdf);

    // ---- the init step or a Broyden step of each live slot
    if (j < R && s_ray[j] >= 0) {
      s_g[j][0] = s_sdf[j] * fa.mscale;
      float* J = s_J[j];
      bool done = false, active = true;
      if (s_init[j]) {
        const float* gv = s_g[j];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          s_gx[j][r] = gv[r];
          s_upd[j][r] = -(J[4 * r] * gv[0] + J[4 * r + 1] * gv[1]
                          + J[4 * r + 2] * gv[2] + J[4 * r + 3] * gv[3]);
          s_uopt[j][r] = s_u[j][r];
        }
        s_gnopt[j] = sqrtf(gv[0] * gv[0] + gv[1] * gv[1] + gv[2] * gv[2]
                           + gv[3] * gv[3]);
        s_init[j] = 0;
        done = a.max_steps <= 0;
      } else {
        float gn_v[4], dg[4], du[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          gn_v[c] = s_g[j][c];
          dg[c] = gn_v[c] - s_gx[j][c];
          du[c] = s_du[j][c];
        }
        const float gn = sqrtf(gn_v[0] * gn_v[0] + gn_v[1] * gn_v[1]
                               + gn_v[2] * gn_v[2] + gn_v[3] * gn_v[3]);
        if (gn < s_gnopt[j]) {
#pragma unroll
          for (int c = 0; c < 4; ++c) s_uopt[j][c] = s_un[j][c];
          for (int c = 0; c < 16; ++c) s_topt[j][c] = s_T[j][c];
          s_gnopt[j] = gn;
        }
        active = s_gnopt[j] > a.cvg && gn < a.dvg;
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
        bd = (bd >= 0.f) ? bd + a.eps : bd - a.eps;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float uv = av[r] / bd;
#pragma unroll
          for (int c = 0; c < 4; ++c) J[4 * r + c] += uv * vT[c];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          s_upd[j][r] = -(J[4 * r] * gn_v[0] + J[4 * r + 1] * gn_v[1]
                          + J[4 * r + 2] * gn_v[2] + J[4 * r + 3] * gn_v[3]);
          s_u[j][r] = s_un[j][r];
          s_gx[j][r] = gn_v[r];
        }
        const int it = ++s_it[j];
        done = !active || it >= a.max_steps;
      }
      if (done) {
        if (rank == 0)
          write(s_ray[j], s_uopt[j], s_topt[j], s_gnopt[j] < a.cvg, active,
                s_it[j]);
        s_ray[j] = -1;
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s_du[j][c] = s_upd[j][c];
          s_un[j][c] = s_u[j][c] + s_du[j][c];
        }
      }
    }
  }
  cp_async_wait_all();
  if constexpr (C > 1) cg::this_cluster().sync();
}

template <class S>
static int iso_launch(const IsoArgs& a, cudaStream_t st, int* shape,
                      bool run) {
  return launch_tile<S>(iso_kernel<S>, a, a.n, true, st, shape, run);
}

// Launch shape 0 (16-ray clusters of 4 CTAs) or 1 (16-ray clusters of 8).
static int iso_dispatch(int variant, const IsoArgs& a, cudaStream_t st,
                        int* shape, bool run) {
  if (variant == 0) return iso_launch<ShapeC4>(a, st, shape, run);
  if (variant == 1) return iso_launch<ShapeC8>(a, st, shape, run);
  return (int)cudaErrorInvalidValue;
}

// The launch shape `variant` would take for n rays (as arah_march_shape).
extern "C" int arah_iso_shape(int variant, int n, int* shape) {
  IsoArgs a = {};
  a.n = n;
  return iso_dispatch(variant, a, 0, shape, false);
}

// `params`: ops/march.py:pack_trace (the SIREN and the skinning MLP, each
// layer's (in, pad32(out)) transposed weights and padded bias);
// `counters`: 2 ints of scratch (zeroed here); `iters_out` may be null.
extern "C" int arah_iso(const float* cam, const float* dirs, const float* u0,
                        const float* t0, const float* jinv0,
                        const unsigned char* mask, int n,
                        const float* bones16, const float* frame,
                        const float* params, NetMeta m, int max_steps,
                        float cvg, float dvg, float eps, float softmax_scale,
                        int variant, int* counters, float* u_out,
                        float* t_out, unsigned char* valid,
                        unsigned char* active, int* iters_out, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(counters, 0, 2 * sizeof(int), st);
  if (e != cudaSuccess) return (int)e;
  IsoArgs a = {cam, dirs, u0, t0, jinv0, mask, n, bones16, frame, params, m,
               max_steps, cvg, dvg, eps, softmax_scale, counters, u_out,
               t_out, valid, active, iters_out};
  return iso_dispatch(variant, a, st, nullptr, true);
}
