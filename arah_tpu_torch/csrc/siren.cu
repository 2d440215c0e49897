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
// Design: the SIREN pass of kernels E and F (csrc/tile_mlp.cuh,
// tile_siren_hidden) without the LBS: 256 threads own 16 points, thread j
// computes hidden unit j of every point, the activations sit in shared
// memory [point][unit], the weights come from a transposed (in, out) copy
// through L2. Each output unit is a 16-lane dot per point and a shuffle
// sum. Any N: the last tile is masked.
#include "tile_mlp.cuh"

__global__ void __launch_bounds__(TILE_THREADS)
siren_kernel(const float* __restrict__ x, int n,
             const float* __restrict__ P, NetMeta m, int out_dim,
             float* __restrict__ out) {
  __shared__ __align__(16) float hbuf[TILE_RAYS * TILE_LD];
  const int j = threadIdx.x;
  const int r0 = blockIdx.x * TILE_RAYS;
  if (j < TILE_RAYS) {
    const int r = r0 + j;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      hbuf[j * TILE_LD + c] = r < n ? x[3 * r + c] : 0.f;
  }
  __syncthreads();
  tile_siren_hidden(hbuf, P, m);
  const int r = r0 + (j >> 4);
  const float* b = P + m.b_off[m.n_layers - 1];
  for (int o = 0; o < out_dim; ++o) {
    const float a = tile_row_dot(hbuf, P + m.wl_off + (long long)o * m.hidden,
                                 m.hidden);
    if ((j & 15) == 0 && r < n) out[(long long)r * out_dim + o] =
        a + __ldg(b + o);
  }
}

extern "C" int arah_siren(const float* x, int n, const float* params,
                          NetMeta m, int out_dim, float* out, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + TILE_RAYS - 1) / TILE_RAYS;
  siren_kernel<<<blocks, TILE_THREADS, 0, (cudaStream_t)stream>>>(
      x, n, params, m, out_dim, out);
  return launch_status();
}
