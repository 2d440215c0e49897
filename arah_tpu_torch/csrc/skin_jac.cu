// Kernel G: the exact forward-skinning Jacobian d fwd_skin / d x_hat at
// given canonical points, for the training step's implicit-diff
// correction. No gradient flows through it (the renderer stops it).
//
// Replaces the TPU kernel arah_tpu/ops/pallas/corr_kernel_t.py:
// skinning_jac_pallas (body _make_jac_kernel): the collapsed skinning MLP
// (softplus100 hidden layers) at x_norm = x * nscale + noff, the
// hierarchical softmax of the scaled logits, the bone blend T = sum_b w_b
// B_b and LBS xb = T[:3,:3] x + T[:3,3], differentiated forward along the
// three input axes: J[i][k] = d xb_i / d x_k.
//
// Bound on the H100: operations. A point costs the MLP's multiply-adds
// four times (the primal and three tangents: 4 x (3x128 + 3x128x128 +
// 128x25) ~ 0.21 M at the flagship) against 12 B in and 36 B out. G stays
// f32, as the reference is: FMA on the CUDA cores, never TF32.
//
// Design: a block of 256 threads owns SJ_PTS = 16 points and runs the
// tangent tile of csrc/skin_tangent.cuh on them (shared with kernel B's
// want_jac), each layer's weights staged whole in shared memory with
// cp.async (64 KB at 128 x 128), the next layer's copy in flight during
// this layer's epilogue. Shared memory: 32 KB of activations, 64 KB of
// weights and ~12 KB static, two blocks per SM. Any N: the last tile is
// masked. No reduction.
#include "skin_tangent.cuh"

#define SJ_THREADS 256              // threads per block
#define SJ_PTS 16                   // points per tile

static_assert(SJ_PTS * 16 == SJ_THREADS, "16 unit groups of 16 points");

__global__ void __launch_bounds__(SJ_THREADS, 2)
skin_jac_kernel(const float* __restrict__ x_g, int n,
                const float* __restrict__ bones_g,
                const float* __restrict__ frame_g,
                const float* __restrict__ P, NetMeta m, float softmax_scale,
                float* __restrict__ jac_out) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float bones[N_BONES * 16];
  __shared__ SjScratch<SJ_PTS> s;
  float* act = smem;                               // the tile's activations
  float* ws = smem + sj_act_floats<SJ_PTS>();      // [din][pad(dout)]
  const int j = threadIdx.x;
  const int p0 = blockIdx.x * SJ_PTS;
  const FrameAffine fa = frame_affine(frame_g);

  sj_stage_w(ws, P, m, 0);
  for (int k = j; k < N_BONES * 16; k += blockDim.x) bones[k] = bones_g[k];
  if (j < SJ_PTS * 3) {
    const int p = j / 3, c = j % 3;
    s.xs[p][c] = (p0 + p < n) ? x_g[(long long)(p0 + p) * 3 + c] : 0.f;
  }
  if (j < SJ_PTS) s.idx[j] = p0 + j < n ? p0 + j : -1;
  __syncthreads();
  skin_jac_tile<SJ_PTS, SJ_THREADS, PREC_F32, true>(
      act, ws, s, bones, P, m, fa, softmax_scale, jac_out);
}

// Bytes of dynamic shared memory a block of kernel G takes: the
// activations and the widest layer's padded weights.
static size_t skin_jac_smem(const NetMeta& m) {
  int w = 0;
  for (int l = 0; l < m.n_skin; ++l)
    w = max(w, m.skin_dims[l] * sj_pad(m.skin_dims[l + 1]));
  return (size_t)(sj_act_floats<SJ_PTS>() + w) * sizeof(float);
}

extern "C" long long arah_skin_jac_smem(NetMeta m) {
  return (long long)skin_jac_smem(m);
}

// J (n, 3, 3) at x (n, 3). `params`: ops/skin_jac.py:pack_skin_jac (each
// layer's (in, pad32(out)) weights and padded bias, 16-byte aligned);
// widths 3, ..., 25 with hidden widths of at most SJ_MAXW.
extern "C" int arah_skin_jac(const float* x, int n, const float* bones16,
                             const float* frame, const float* params,
                             NetMeta m, float softmax_scale, float* jac,
                             void* stream) {
  if (n <= 0) return 0;
  const size_t smem = skin_jac_smem(m);
  cudaError_t e = cudaFuncSetAttribute(
      skin_jac_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (n + SJ_PTS - 1) / SJ_PTS;
  skin_jac_kernel<<<blocks, SJ_THREADS, smem, (cudaStream_t)stream>>>(
      x, n, bones16, frame, params, m, softmax_scale, jac);
  return launch_status();
}
