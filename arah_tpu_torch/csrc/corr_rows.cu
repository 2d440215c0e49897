// Kernels B and L: the canonical-correspondence Broyden search,
// fwd_skin(x_hat) = x_bar, one body for both, points from a device-side
// queue.
//
// Replaces the TPU kernels arah_tpu/ops/pallas/corr_kernel_t.py:
// corr_search_pallas_t (B, body _make_kernel, on both main paths) and
// arah_tpu/ops/pallas/corr_kernel.py:corr_search_pallas (L, the (T, k) row
// layout that B superseded, in the corr bench). Both run the same solve:
// collapsed skinning MLP with softplus100 hidden layers -> hierarchical
// softmax of the scaled logits -> bone blend -> LBS; adjugate-inverse init
// Jacobian from the blend at x0; good-Broyden rank-1 updates with +/-eps
// denominators; best-iterate tracking; convergence at |g| < cvg, divergence
// freeze at |g| >= dvg; masked points return x0 and T0, valid = mask &&
// best |g| < cvg. B also returns `active` (still iterating at max_steps,
// false for a masked point), which its straggler split reads; L has no
// such output (active_out is null).
//
// Bound on the H100: operations. Per evaluation of a point (one at init,
// one a Broyden iteration) the skinning MLP's multiply-adds (3x128 +
// 3x128x128 + 128x25, ~53 k at the flagship) plus ~200 flops of softmax,
// blend and 3x3 algebra; the bytes are ~170 B per point in and out.
//
// Design (csrc/stream_mlp.cuh, after kernel F in csrc/iso.cu): a
// persistent grid whose CTAs (or clusters) own R point slots each. An
// empty slot takes the next unmasked point from a global atomic counter
// (masked points are written at once, at x0/T0); the point's first pass
// evaluates the residual at x0 (broyden_init's evaluation), every later
// one at x + upd (a Broyden iteration), so a slot just refilled and a slot
// mid-solve share one pass, which runs on the live slots only, compacted.
// The skinning MLP is stream_mlp.cuh's corr pass (pass_table with no SIREN
// layers), its weights streamed through the shared-memory ring, its
// logits layer in lane groups (TileShape's NG).
// The softmax, the LBS residual and the Broyden step (tile_mlp.cuh:
// broyden_init/broyden_step) run on one thread a slot, the bone blend on
// 16. A point that converges, diverges or reaches max_steps
// writes its outputs (and its own iteration count) and frees its slot, so
// its values depend neither on its neighbours nor on the launch shape.
//
// B's options (the TPU kernel's; variants of shapes 0 and 1, a skinning MLP
// up to 128 wide):
// - precision (PM): every skinning layer after the first takes split3 or
//   bf16 products (tile_mlp.cuh:PREC_*) from the pack's weight halves or
//   rounded weights (ops/corr.py:pack_corr): split3 splits a layer's input
//   where it reads it (stream_mlp.cuh:chunk_fma), bf16 rounds it where the
//   previous layer writes it (run_layer's epilogue).
// - want_jac (JAC): the exact J = d fwd_skin / d x_hat at each returned
//   point (the best iterate; x0 for a masked point), written by this
//   launch in an epilogue: a retiring slot pushes its point and x onto a
//   per-CTA list of pending points; whenever JT of them wait, the CTA (the
//   cluster's leader) runs csrc/skin_tangent.cuh's tangent tile on them
//   (three tangent chains beside the primal, the precision's products
//   too), using the pass's two activation buffers as its shared memory
//   (free between a pass's softmax and the next pass) and the pack's
//   weights from L2; the last ones go when the queue runs dry. A masked
//   point then takes a slot too, for its one pass (at x0), and retires at
//   once with x0 and T0. The list and the tile's per-point scratch sit in
//   dynamic shared memory after the ring (~13 KB at shape 0); the tile
//   runs on all the CTA's threads. The split3 and bf16 JAC variants take
//   launch shapes of their own (CorrJacShape0/1: the shape's cluster and
//   widths, at most one CTA an SM): the tile inlined in the slot loop
//   sat at the 128-register cap of a 512-thread CTA, where ptxas once
//   spilled the bf16 variant; on 256 threads at MINB 1 the cap is 255
//   and bf16 uses ~165 (split3 ~250). The f32 one, never seen to spill
//   at that cap, keeps the faster shape.
// Bound of the want_jac epilogue: operations, the MLP's multiply-adds four
// times a returned point (G's work, without G's launch or its reads of
// x_hat).
#include "skin_tangent.cuh"
#include "stream_mlp.cuh"

struct CorrArgs {
  const float *xbar, *x0, *t0;
  const unsigned char* mask;
  int n;
  const float *bones, *frame, *P;
  NetMeta m;
  int max_steps;
  float cvg, dvg, eps, softmax_scale;
  int* counters;          // [0] the point queue
  float *x_out, *t_out;
  unsigned char *valid_out, *active_out;   // active_out may be null (L)
  int* iters_out;         // may be null
  float* jac_out;         // (n, 9) under want_jac, else null
};

// want_jac's state of a CTA of shape S, in dynamic shared memory after the
// ring: the points waiting for their J (index and x) and the tangent
// tile's scratch; JT points a tile, as many as the pass's activation
// buffers hold.
template <class S>
struct CorrJac {
  static constexpr int JT =
      2 * S::ABUF >= sj_act_floats<16>() ? 16 : 8;
  static_assert(2 * S::ABUF >= sj_act_floats<JT>() && S::NT / JT >= 8
                && (SJ_MAXW * JT / S::NT) % 4 == 0,
                "the tangent tile's activations and thread groups");
  int npend, pt[S::R + JT], masked[S::R];
  float x[S::R + JT][3];
  SjScratch<JT> tile;
};

// J of the last np <= JT pending points of the CTA (all threads call it;
// the leader CTA of a cluster computes and writes, the others wait at the
// next cluster barrier).
template <class S, int PM>
__device__ void corr_jac_flush(CorrJac<S>& js, int np, float* act,
                               const float* bones, const CorrArgs& a,
                               const FrameAffine& fa) {
  constexpr int JT = CorrJac<S>::JT;
  const int j = threadIdx.x, base = js.npend - np;
  if (j < JT * 3) {
    const int p = j / 3, c = j % 3;
    js.tile.xs[p][c] = p < np ? js.x[base + p][c] : 0.f;
  }
  if (j < JT) js.tile.idx[j] = j < np ? js.pt[base + j] : -1;
  __syncthreads();
  skin_jac_tile<JT, S::NT, PM, false>(act, nullptr, js.tile, bones, a.P,
                                      a.m, fa, a.softmax_scale, a.jac_out);
  if (j == 0) js.npend = base;
  __syncthreads();
}

template <class S, int PM, bool JAC>
__global__ void __launch_bounds__(S::NT, S::MINB)
corr_kernel(const CorrArgs a) {
  constexpr int R = S::R, C = S::C;
  static_assert(S::MAXW >= N_BONES, "the softmax's rows");
  extern __shared__ __align__(16) float smem[];
  float* act = smem;                       // [2][MAXW][LDA]
  float* ring = smem + 2 * S::ABUF;        // [ST][KC][CU]
  // want_jac's state (JAC only), after the ring
  CorrJac<S>& js = *reinterpret_cast<CorrJac<S>*>(ring + S::RING);
  __shared__ PassTable pt;
  __shared__ float bones[N_BONES * 16];
  __shared__ int s_ray[R], s_new[R], s_it[R], s_init[R];
  __shared__ int s_exhausted, s_nl, s_list[R];
  __shared__ float s_xbar[R][3], s_x[R][3], s_xn[R][3], s_dx[R][3];
  __shared__ float s_gx[R][3], s_J[R][9], s_upd[R][3];
  __shared__ float s_xopt[R][3], s_topt[R][16], s_gnopt[R];
  __shared__ float s_T[R][16];

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
    if constexpr (JAC) js.npend = 0;
  }
  if constexpr (C > 1) cg::this_cluster().sync();
  else __syncthreads();
  ring_start<S>(ring, pt, a.P, rank);
  int g = 0;                               // the ring's next chunk
  int cur = 0;                             // the pass's input buffer

  // point r's outputs (leader only)
  auto write = [&](int r, const float* x, const float* T, bool valid,
                   bool active, int it) {
#pragma unroll
    for (int c = 0; c < 3; ++c) a.x_out[3 * r + c] = x[c];
    for (int c = 0; c < 16; ++c) a.t_out[16 * r + c] = T[c];
    a.valid_out[r] = valid ? 1 : 0;
    if (a.active_out) a.active_out[r] = active ? 1 : 0;
    if (a.iters_out) a.iters_out[r] = it;
  };

  for (;;) {
    // ---- refill: the leader takes the next unmasked points for the empty
    // slots (masked points keep x0 and T0; under want_jac they take a slot
    // too, for their J at x0)
    if (rank == 0 && j < R && s_ray[j] < 0) {
      int r = -1;
      while (!*(volatile int*)&s_exhausted) {
        const int c = atomicAdd(a.counters, 1);
        if (c >= a.n) {
          s_exhausted = 1;
          break;
        }
        if (JAC || a.mask[c]) {
          r = c;
          break;
        }
        write(c, a.x0 + 3 * c, a.t0 + 16 * c, false, false, 0);
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
          s_xbar[j][c] = a.xbar[3 * r + c];
          s_xn[j][c] = s_x[j][c] = s_xopt[j][c] = a.x0[3 * r + c];
        }
        for (int c = 0; c < 16; ++c) s_topt[j][c] = a.t0[16 * r + c];
        s_init[j] = 1;
        s_it[j] = 0;
        if constexpr (JAC) js.masked[j] = !a.mask[r];
      }
    }
    if (!__syncthreads_or(j < R && s_ray[j] >= 0)) break;

    // ---- fwd_skin at s_xn: the skinning MLP on the live slots compacted
    // to positions [0, nl) of s_list (positions past nl feed zeros; their
    // results are not read), from buffer cur (stream_mlp.cuh's buffer rule)
    const int nl = live_list<S>(s_ray, s_list, &s_nl);
    if (j < R) {
      const int p = j < nl ? s_list[j] : 0;
#pragma unroll
      for (int c = 0; c < 3; ++c)
        act[cur * S::ABUF + c * S::LDA + j] =
            j < nl ? s_xn[p][c] * fa.nscale + fa.noff[c] : 0.f;
    }
    const int lg = run_layers<S, PM>(pt, 0, pt.n, act, cur, ring, g, a.P, m,
                                     a.softmax_scale, rank, nl);
    cur = lg;
    // the hierarchical softmax of a position on one thread, its weights
    // into the free buffer lg ^ 1 (k-major, by position); then the bone
    // blend, 16 threads a position
    {
      const float* lgt = act + lg * S::ABUF;
      float* wts = act + (lg ^ 1) * S::ABUF;
      if (j < nl) {
        float c25[25], w[N_BONES];
#pragma unroll
        for (int u = 0; u < 25; ++u) c25[u] = lgt[u * S::LDA + j];
        hier_softmax(c25, w);
#pragma unroll
        for (int b = 0; b < N_BONES; ++b) wts[b * S::LDA + j] = w[b];
      }
      __syncthreads();
      for (int e = j; e < nl * 16; e += S::NT) {
        const int pos = e >> 4, lane = e & 15;
        float s = 0.f;
#pragma unroll
        for (int b = 0; b < N_BONES; ++b)
          s = fmaf(wts[b * S::LDA + pos], bones[b * 16 + lane], s);
        s_T[s_list[pos]][lane] = s;
      }
    }
    __syncthreads();

    // ---- the LBS residual, then the init step or a Broyden step of each
    // live slot
    if (j < R && s_ray[j] >= 0) {
      const float* T = s_T[j];
      const float* x = s_xn[j];
      float gv[3];
#pragma unroll
      for (int c = 0; c < 3; ++c)
        gv[c] = T[4 * c] * x[0] + T[4 * c + 1] * x[1] + T[4 * c + 2] * x[2]
                + T[4 * c + 3] - s_xbar[j][c];
      bool done, active = true;
      if (s_init[j]) {
#pragma unroll
        for (int c = 0; c < 3; ++c) s_gx[j][c] = gv[c];
        s_gnopt[j] = broyden_init(s_T[j], s_gx[j], s_J[j], s_upd[j]);
        s_init[j] = 0;
        done = a.max_steps <= 0;
        if constexpr (JAC)
          if (js.masked[j]) {
            done = true;
            active = false;
            s_gnopt[j] = a.cvg;              // never valid
          }
      } else {
        bool better;
        active = broyden_step(s_J[j], s_gx[j], s_upd[j], s_gnopt[j], better,
                              s_dx[j], gv, a.cvg, a.dvg, a.eps);
        if (better) {
#pragma unroll
          for (int c = 0; c < 3; ++c) s_xopt[j][c] = s_xn[j][c];
          for (int c = 0; c < 16; ++c) s_topt[j][c] = T[c];
        }
#pragma unroll
        for (int c = 0; c < 3; ++c) s_x[j][c] = s_xn[j][c];
        const int it = ++s_it[j];
        done = !active || it >= a.max_steps;
      }
      if (done) {
        if (rank == 0)
          write(s_ray[j], s_xopt[j], s_topt[j], s_gnopt[j] < a.cvg, active,
                s_it[j]);
        if constexpr (JAC)
          if (rank == 0) {                 // the leader computes the Js
            const int k = atomicAdd(&js.npend, 1);
            js.pt[k] = s_ray[j];
#pragma unroll
            for (int c = 0; c < 3; ++c) js.x[k][c] = s_xopt[j][c];
          }
        s_ray[j] = -1;
      } else {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          s_dx[j][c] = s_upd[j][c];
          s_xn[j][c] = s_x[j][c] + s_dx[j][c];
        }
      }
    }
    if constexpr (JAC) {
      // J of the retired points, JT at a time, in the free activations
      __syncthreads();
      while (js.npend >= CorrJac<S>::JT && rank == 0)
        corr_jac_flush<S, PM>(js, CorrJac<S>::JT, act, bones, a, fa);
    }
  }
  if constexpr (JAC)
    if (rank == 0 && js.npend > 0)
      corr_jac_flush<S, PM>(js, js.npend, act, bones, a, fa);
  cp_async_wait_all();
  if constexpr (C > 1) cg::this_cluster().sync();
}

// The launch shapes: for layers at most 128 wide (the flagship's),
// 128-point CTAs (the logits layer in lane groups of 8), then 16-point
// clusters of 2 CTAs (ops/corr.py:launch_shape picks one by the number of
// points; PERF.md gives the sweep that chose them); for a skinning MLP
// up to 256 wide, 64-point CTAs at every batch size.
//                           R   NT  C  KC MINB ST MAXW NG
using CorrShape0 = TileShape<128, 512, 1, 32, 1, 2, 128, 4>;
using CorrShape1 = TileShape<16, 256, 2, 64, 2, 3, 128>;
using CorrShape2 = TileShape<64, 512, 1, 32, 1, 2>;
// want_jac's shapes at split3 and bf16 for shapes 0 and 1 (corr_options):
// 64-point CTAs of 256 threads, and shape 1 at one cluster an SM
using CorrJacShape0 = TileShape<64, 256, 1, 32, 1, 2, 128, 4>;
using CorrJacShape1 = TileShape<16, 256, 2, 64, 1, 3, 128>;
template <class S> struct JacShape;
template <> struct JacShape<CorrShape0> { using T = CorrJacShape0; };
template <> struct JacShape<CorrShape1> { using T = CorrJacShape1; };

template <class S, int PM, bool JAC>
static int corr_launch(const CorrArgs& a, cudaStream_t st, int* shape,
                       bool run) {
  return launch_tile<S>(corr_kernel<S, PM, JAC>, a, a.n, true, st, shape,
                        run, JAC ? sizeof(CorrJac<S>) : 0);
}

// A launch shape's variants: its precision and want_jac (ops/corr.py:
// VARIANTS: both on shapes 0 and 1), want_jac at split3 and bf16 on the
// shape's JacShape.
template <class S>
static int corr_options(int prec, bool jac, const CorrArgs& a,
                        cudaStream_t st, int* shape, bool run) {
  using J = typename JacShape<S>::T;
  switch (prec * 2 + (int)jac) {
    case 0: return corr_launch<S, PREC_F32, false>(a, st, shape, run);
    case 1: return corr_launch<S, PREC_F32, true>(a, st, shape, run);
    case 2: return corr_launch<S, PREC_SPLIT3, false>(a, st, shape, run);
    case 3: return corr_launch<J, PREC_SPLIT3, true>(a, st, shape, run);
    case 4: return corr_launch<S, PREC_BF16, false>(a, st, shape, run);
    case 5: return corr_launch<J, PREC_BF16, true>(a, st, shape, run);
  }
  return (int)cudaErrorInvalidValue;
}

// A launch shape without the options (a skinning MLP wider than 128).
template <class S>
static int corr_f32_only(int prec, bool jac, const CorrArgs& a,
                         cudaStream_t st, int* shape, bool run) {
  if (prec != PREC_F32 || jac) return (int)cudaErrorInvalidValue;
  return corr_launch<S, PREC_F32, false>(a, st, shape, run);
}

static int corr_dispatch(int variant, int prec, bool jac, const CorrArgs& a,
                         cudaStream_t st, int* shape, bool run) {
  switch (variant) {
    case 0: return corr_options<CorrShape0>(prec, jac, a, st, shape, run);
    case 1: return corr_options<CorrShape1>(prec, jac, a, st, shape, run);
    case 2: return corr_f32_only<CorrShape2>(prec, jac, a, st, shape, run);
  }
  return (int)cudaErrorInvalidValue;
}

// The launch shape `variant` would take for n points (as arah_march_shape).
extern "C" int arah_corr_shape(int variant, int n, int* shape) {
  CorrArgs a = {};
  a.n = n;
  return corr_dispatch(variant, PREC_F32, false, a, 0, shape, false);
}

// B (active != null) and L (active == null). `params`: the skinning
// blocks of ops/march.py:pack_trace (each layer's (in, pad32(out))
// transposed weights and padded bias, 16-byte aligned); the pack's SIREN,
// if any, is not read; under a precision other than f32 (`prec`: PREC_*)
// it is ops/corr.py:pack_corr's at that precision. `counters`: 2 ints of
// scratch (zeroed here); `iters_out` may be null; `jac_out` (n, 9), null
// without want_jac.
extern "C" int arah_corr(const float* xbar, const float* x0, const float* t0,
                         const unsigned char* mask, int n,
                         const float* bones16, const float* frame,
                         const float* params, NetMeta m, int max_steps,
                         float cvg, float dvg, float eps, float softmax_scale,
                         int variant, int prec, int* counters, float* x_out,
                         float* t_out, unsigned char* valid,
                         unsigned char* active, int* iters_out,
                         float* jac_out, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(counters, 0, 2 * sizeof(int), st);
  if (e != cudaSuccess) return (int)e;
  m.n_layers = 0;                          // the corr pass: skinning only
  CorrArgs a = {xbar, x0, t0, mask, n, bones16, frame, params, m, max_steps,
                cvg, dvg, eps, softmax_scale, counters, x_out, t_out, valid,
                active, iters_out, jac_out};
  return corr_dispatch(variant, prec, jac_out != nullptr, a, st, nullptr,
                       true);
}
