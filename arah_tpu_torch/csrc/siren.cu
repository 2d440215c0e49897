// Kernel J: the generated SIREN's forward at a batch of points.
//
// Replaces the TPU kernel arah_tpu/ops/pallas/siren_kernel.py:
// siren_sdf_pallas (body _siren_kernel): h <- sin(30 (f (h W^T + b) + p))
// through the hidden layers (FiLM optional), then the output layer, in
// f32 with exact sinf; (N, 3) -> (N, out_dim).
//
// Bound on the H100: operations. A point costs 3 H + (L - 2) H^2 +
// out_dim H multiply-adds (657 k flops at the flagship's 256 x 5); the
// bytes are 12 B in and 4 out_dim B out per point, and the weights
// (~1.3 MB) stay in L2.
//
// Design (csrc/stream_mlp.cuh): kernel E's network pass without the
// march. A persistent grid of CTAs (or clusters) walks the R-point tiles
// of the batch with a grid stride; each tile is one pass of the SIREN's
// hidden layers, register-blocked, with the weights streamed through the
// shared-memory ring across tiles, and on a cluster each CTA computes
// 1/C of every layer's units. Then each output unit is siren_dot's
// 16-lane dot per point. Every sum runs over k in order from 0, so a
// point's result depends neither on the launch shape nor on its tile.
#include "stream_mlp.cuh"

struct SirenArgs {
  const float* x;
  int n;
  const float* P;
  NetMeta m;
  int out_dim;
  float* out;
};

template <class S>
__global__ void __launch_bounds__(S::NT, S::MINB)
siren_kernel(const SirenArgs a) {
  constexpr int R = S::R, C = S::C;
  extern __shared__ __align__(16) float smem[];
  float* act = smem;                       // [2][MAXW][LDA]
  float* ring = smem + 2 * S::ABUF;        // [ST][KC][CU]
  __shared__ PassTable pt;
  const int j = threadIdx.x;
  int rank = 0;
  if constexpr (C > 1) rank = (int)cg::this_cluster().block_rank();
  const NetMeta& m = a.m;
  if (j == 0) pass_table(pt, m, false, C, S::KC);
  if constexpr (C > 1) cg::this_cluster().sync();
  else __syncthreads();
  ring_start<S>(ring, pt, a.P, rank);
  int g = 0;                               // the ring's next chunk
  int cur = 0;                             // the pass's input buffer
  const long long H = m.hidden;
  const float* bias = a.P + m.b_off[m.n_layers - 1];
  const int tiles = (a.n + R - 1) / R;
  // a cluster's CTAs walk the same tiles (their trip counts agree)
  for (int t = blockIdx.x / C; t < tiles; t += gridDim.x / C) {
    const int base = t * R, nl = min(R, a.n - base);
    if (j < R) {
#pragma unroll
      for (int c = 0; c < 3; ++c)
        act[cur * S::ABUF + c * S::LDA + j] =
            j < nl ? a.x[3 * (long long)(base + j) + c] : 0.f;
    }
    cur = run_layers<S>(pt, 0, pt.n, act, cur, ring, g, a.P, m, 1.f, rank,
                        nl);
    for (int o = 0; o < a.out_dim; ++o)
      siren_dot<S>(act + cur * S::ABUF, a.P + m.wl_off + o * H,
                   __ldg(bias + o), m.hidden, nl, [&](int p, float v) {
                     if (rank == 0)
                       a.out[(long long)(base + p) * a.out_dim + o] = v;
                   });
  }
  cp_async_wait_all();
  if constexpr (C > 1) cg::this_cluster().sync();
}

// The launch shapes: 64-point CTAs, then 16-point clusters of 2 CTAs
// (ops/siren.py:launch_shape picks one by the number of points; PERF.md
// gives the sweep that chose them).
//                            R   NT  C  KC MINB ST
using SirenShape0 = TileShape<64, 512, 1, 32, 1, 2>;
using SirenShape1 = TileShape<16, 256, 2, 64, 2, 3>;

template <class S>
static int siren_launch(const SirenArgs& a, cudaStream_t st, int* shape,
                        bool run) {
  return launch_tile<S>(siren_kernel<S>, a, a.n, false, st, shape, run);
}

static int siren_dispatch(int variant, const SirenArgs& a, cudaStream_t st,
                          int* shape, bool run) {
  switch (variant) {
    case 0: return siren_launch<SirenShape0>(a, st, shape, run);
    case 1: return siren_launch<SirenShape1>(a, st, shape, run);
  }
  return (int)cudaErrorInvalidValue;
}

// The launch shape `variant` would take for n points (as arah_march_shape).
extern "C" int arah_siren_shape(int variant, int n, int* shape) {
  SirenArgs a = {};
  a.n = n;
  return siren_dispatch(variant, a, 0, shape, false);
}

// `params`: ops/march.py:pack_siren with align 4 (ops/siren.py:
// pack_siren_sdf); out (n, out_dim).
extern "C" int arah_siren(const float* x, int n, const float* params,
                          NetMeta m, int out_dim, int variant, float* out,
                          void* stream) {
  if (n <= 0) return 0;
  SirenArgs a = {x, n, params, m, out_dim, out};
  return siren_dispatch(variant, a, (cudaStream_t)stream, nullptr, true);
}
