// Kernel iso_init: the inverse of the joint init Jacobian of the iso
// Broyden (kernel F's J_inv0), one launch a solve.
//
// No TPU kernel: the JAX package computes it under XLA with three
// forward-mode tangents (arah_tpu/solver/root_find.py:iso_init_inv_jacobian,
// called by render/ray_tracing.py before iso_refine_pallas). Per ray, at
// its march's canonical point x_hat (metric), all in f32, as
// ops/iso_init.py:iso_init_plain computes it:
// - grad_sdf = d sdf_metric / d x_hat: the generated SIREN's forward at
//   x_norm = x_hat nscale + noff (FiLM or plain, as m.film says), keeping
//   each sine layer's 30 f cos(30 z) factor, then the reverse chain from the
//   SDF row of the output layer down to the input (kernel C's f32 chain,
//   ops/shade.py:siren_shade_plain), times nscale and the metric scale;
// - J_lbs = d fwd_skin / d x_hat through the collapsed skinning MLP, the
//   bone blend and LBS: kernel G's tangent tile (csrc/skin_tangent.cuh);
// - J_inv0 = the inverse of [[grad_sdf, 0], [J_lbs, -dir]] by the cofactor
//   formula of core/linalg.py:inv4x4 in its order of operations, each
//   product and sum rounded on its own (no contraction), row-major.
//
// Bound on the H100: operations. A ray costs the SIREN's products twice
// (forward and reverse: 2 ((L-2) H^2 + 3 H) multiply-adds, 0.66 M at the
// flagship's five 256 x 256 layers) and the skinning MLP four times (G's
// 0.21 M at 128 x 4) against 24 B in and 64 B out; the weights stay in L2.
//
// Design: a block of 256 threads owns JT rays (16, or 8 for a phase-2
// batch: ops/iso_init.py:launch_shape), and every weight it reads feeds
// its JT rays. First G's tile on the JT points, each skinning layer staged
// whole in shared memory with cp.async, its 3x3 Jacobians kept in shared
// memory; then, over the same shared memory, the SIREN chain: one f32
// [ray][unit] row tile, thread j doing unit j's per-unit algebra, the
// products on the CUDA cores (never TF32), the sine layers' factors
// resident in shared memory (the last one's meets the reverse seed at
// once, as in kernel C); last, one thread a ray assembles and inverts
// its 4x4. The weights are the trace's one pack (ops/march.py:pack_trace,
// which E, F and B read): the forward products take its transposed (in, out)
// copies as kernel C takes its own (mma.cuh:prod_fma), and the reverse ones
// read the same copies along their rows (prod_fma_t, dx_rows_t), so no
// second copy of the SIREN is packed.
#include "mma.cuh"
#include "skin_tangent.cuh"

#define II_THREADS 256              // threads per block
#define II_LD (256 + 4)             // row stride of the SIREN's row tile

// rows[p][n] <- sum over k < K of rows[p][k] Wt[n * ldw + k] for the NP
// rays p of the tile and n < N: the product with the transpose of a pack's
// (in, out) copy. Thread n owns unit n and reads row n of Wt, 16 bytes a
// load (K and ldw multiples of 4, Wt 16-byte aligned), each weight feeding
// NP rays. Every sum runs over k in order from 0, as prod_fma's.
template <int NP>
__device__ void prod_fma_t(float* rows, int ld, int K,
                           const float* __restrict__ Wt, int ldw, int N) {
  const int j = threadIdx.x;
  float acc[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p) acc[p] = 0.f;
  if (j < N) {
    const float4* w = reinterpret_cast<const float4*>(Wt + (long long)j * ldw);
    for (int k = 0; k < K; k += 4) {
      const float4 w4 = __ldg(w + k / 4);
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const float4 v = *reinterpret_cast<const float4*>(rows + p * ld + k);
        float a = acc[p];
        a = fmaf(v.x, w4.x, a);
        a = fmaf(v.y, w4.y, a);
        a = fmaf(v.z, w4.z, a);
        a = fmaf(v.w, w4.w, a);
        acc[p] = a;
      }
    }
  }
  __syncthreads();                     // every read of the rows is done
  if (j < N) {
#pragma unroll
    for (int p = 0; p < NP; ++p) rows[p * ld + j] = acc[p];
  }
  __syncthreads();
}

// dx[p][c] = sum over k < K of rows[p][k] Wt[c * K + k], c < 3: the input
// gradient from the first layer's (3, K) copy (mma.cuh:dx_rows, the
// weights read along k), into dx ([NP][3]). 16 lanes a ray whatever NP, so
// that every launch shape sums in one order; threads past 16 NP idle.
template <int NP>
__device__ void dx_rows_t(const float* rows, int ld, int K,
                          const float* __restrict__ Wt, float* dx) {
  constexpr int LN = 16;
  static_assert(NP * LN <= II_THREADS, "dx_rows_t lanes");
  const int p = threadIdx.x / LN, l = threadIdx.x % LN;
  if (p >= NP) return;                 // whole warps
  float acc[3] = {0.f, 0.f, 0.f};
  for (int k = l; k < K; k += LN) {
    const float r = rows[p * ld + k];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      acc[c] = fmaf(r, __ldg(Wt + (long long)c * K + k), acc[c]);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int o = LN / 2; o > 0; o >>= 1)
      acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], o, LN);
  if (l < 3) dx[p * 3 + l] = l == 0 ? acc[0] : (l == 1 ? acc[1] : acc[2]);
}

// Row-major 4x4 inverse by cofactor expansion, in the order of operations
// of core/linalg.py:inv4x4, every product, sum and the reciprocal rounded
// on its own as the plain version's tensor ops round them.
static __device__ void inv4x4_rn(const float* m, float* o) {
  auto mul = [](float a, float b) { return __fmul_rn(a, b); };
  auto add = [](float a, float b) { return __fadd_rn(a, b); };
  auto sub = [](float a, float b) { return __fsub_rn(a, b); };
  const float m00 = m[0], m01 = m[1], m02 = m[2], m03 = m[3];
  const float m10 = m[4], m11 = m[5], m12 = m[6], m13 = m[7];
  const float m20 = m[8], m21 = m[9], m22 = m[10], m23 = m[11];
  const float m30 = m[12], m31 = m[13], m32 = m[14], m33 = m[15];
  const float s0 = sub(mul(m00, m11), mul(m10, m01));
  const float s1 = sub(mul(m00, m12), mul(m10, m02));
  const float s2 = sub(mul(m00, m13), mul(m10, m03));
  const float s3 = sub(mul(m01, m12), mul(m11, m02));
  const float s4 = sub(mul(m01, m13), mul(m11, m03));
  const float s5 = sub(mul(m02, m13), mul(m12, m03));
  const float c5 = sub(mul(m22, m33), mul(m32, m23));
  const float c4 = sub(mul(m21, m33), mul(m31, m23));
  const float c3 = sub(mul(m21, m32), mul(m31, m22));
  const float c2 = sub(mul(m20, m33), mul(m30, m23));
  const float c1 = sub(mul(m20, m32), mul(m30, m22));
  const float c0 = sub(mul(m20, m31), mul(m30, m21));
  const float det = add(sub(add(add(sub(mul(s0, c5), mul(s1, c4)),
                                    mul(s2, c3)), mul(s3, c2)),
                            mul(s4, c1)), mul(s5, c0));
  const float inv_det = __fdiv_rn(1.f, det);
  // a b - c d + e f, and -a b + c d - e f, each term rounded
  auto pmp = [&](float a, float b, float c, float d, float e, float f) {
    return add(sub(mul(a, b), mul(c, d)), mul(e, f));
  };
  auto mpm = [&](float a, float b, float c, float d, float e, float f) {
    return sub(add(mul(-a, b), mul(c, d)), mul(e, f));
  };
  const float r[16] = {
      pmp(m11, c5, m12, c4, m13, c3), mpm(m01, c5, m02, c4, m03, c3),
      pmp(m31, s5, m32, s4, m33, s3), mpm(m21, s5, m22, s4, m23, s3),
      mpm(m10, c5, m12, c2, m13, c1), pmp(m00, c5, m02, c2, m03, c1),
      mpm(m30, s5, m32, s2, m33, s1), pmp(m20, s5, m22, s2, m23, s1),
      pmp(m10, c4, m11, c2, m13, c0), mpm(m00, c4, m01, c2, m03, c0),
      pmp(m30, s4, m31, s2, m33, s0), mpm(m20, s4, m21, s2, m23, s0),
      mpm(m10, c3, m11, c1, m12, c0), pmp(m00, c3, m01, c1, m02, c0),
      mpm(m30, s3, m31, s1, m32, s0), pmp(m20, s3, m21, s1, m22, s0)};
#pragma unroll
  for (int e = 0; e < 16; ++e) o[e] = mul(r[e], inv_det);
}

template <int JT>
__global__ void __launch_bounds__(II_THREADS, 2)   // two blocks an SM
iso_init_kernel(const float* __restrict__ x_g,
                const float* __restrict__ dir_g, int n,
                const float* __restrict__ bones_g,
                const float* __restrict__ frame_g,
                const float* __restrict__ P, NetMeta m, float softmax_scale,
                float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float bones[N_BONES * 16];
  __shared__ SjScratch<JT> s;
  __shared__ float s_jac[JT * 9], s_dx[JT * 3];
  const int j = threadIdx.x;
  const int p0 = blockIdx.x * JT;
  const FrameAffine fa = frame_affine(frame_g);

  // ---- J_lbs: G's tangent tile, layer 0's weights in flight first
  float* act = smem;                                  // the tile's rows
  float* ws = smem + sj_act_floats<JT>();            // [din][pad(dout)]
  sj_stage_w(ws, P, m, 0);
  for (int k = j; k < N_BONES * 16; k += blockDim.x) bones[k] = bones_g[k];
  if (j < JT * 3) {
    const int p = j / 3, c = j % 3;
    s.xs[p][c] = (p0 + p < n) ? x_g[(long long)(p0 + p) * 3 + c] : 0.f;
  }
  if (j < JT) s.idx[j] = p0 + j < n ? j : -1;
  __syncthreads();
  skin_jac_tile<JT, II_THREADS, PREC_F32, true>(
      act, ws, s, bones, P, m, fa, softmax_scale, s_jac);

  // ---- grad_sdf over the same shared memory (the tile ends on a
  // barrier with its copies done): forward through the sine layers
  const int H = m.hidden, NL = m.n_layers - 1;
  const bool film = m.film != 0;
  float* rows = smem;                                 // [JT][II_LD]
  float* dfs = smem + JT * II_LD;                     // [NL - 1][JT][H]
  if (j < JT * 3) {
    const int p = j / 3, c = j % 3;
    rows[p * II_LD + c] = s.xs[p][c] * fa.nscale + fa.noff[c];
  }
  __syncthreads();
  for (int i = 0; i < NL; ++i) {
    prod_fma<JT>(rows, II_LD, i == 0 ? 3 : H, P + m.wt_off[i], H, H);
    if (j < H) {
      const float b = __ldg(P + m.b_off[i] + j);
      const float f = film ? __ldg(P + m.freq_off + (long long)i * H + j)
                           : 1.f;
      const float ph = film ? __ldg(P + m.phase_off + (long long)i * H + j)
                            : 0.f;
      const float cf = film ? 30.f * f : 30.f;
      // the last sine layer's factor meets the reverse chain's seed, the
      // SDF row of the output layer, at once: its rows then hold
      // a_{L-2} = g_top * df_{L-2}, and no sine of it is needed
      const bool top = i == NL - 1;
      const float g_top = top ? __ldg(P + m.wl_off + j) : 0.f;
      float* df = dfs + (long long)i * JT * H;
#pragma unroll
      for (int p = 0; p < JT; ++p) {
        float z = rows[p * II_LD + j] + b;
        if (film) z = f * z + ph;
        float sn, cs;
        sincosf(30.f * z, &sn, &cs);
        const float d = cf * cs;
        if (top) {
          rows[p * II_LD + j] = g_top * d;
        } else {
          df[p * H + j] = d;
          rows[p * II_LD + j] = sn;
        }
      }
    }
    __syncthreads();
  }
  // the reverse chain: g_i = a_i W_i, then a_{i-1} = g_i * df_{i-1}
  for (int i = NL - 1; i >= 1; --i) {
    prod_fma_t<JT>(rows, II_LD, H, P + m.wt_off[i], H, H);
    if (j < H) {
      const float* df = dfs + (long long)(i - 1) * JT * H;
#pragma unroll
      for (int p = 0; p < JT; ++p)
        rows[p * II_LD + j] = rows[p * II_LD + j] * df[p * H + j];
    }
    __syncthreads();
  }
  dx_rows_t<JT>(rows, II_LD, H, P + m.wt_off[0], s_dx);
  __syncthreads();

  // ---- [[grad_sdf, 0], [J_lbs, -dir]] and its inverse, one thread a ray
  if (j < JT && p0 + j < n) {
    const long long r = p0 + j;
    float M[16], R[16];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      M[c] = __fmul_rn(__fmul_rn(s_dx[3 * j + c], fa.nscale), fa.mscale);
    M[3] = 0.f;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int k = 0; k < 3; ++k)
        M[4 * (i + 1) + k] = s_jac[9 * j + 3 * i + k];
      M[4 * (i + 1) + 3] = -dir_g[3 * r + i];
    }
    inv4x4_rn(M, R);
    float4* o = reinterpret_cast<float4*>(out + 16 * r);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      o[q] = make_float4(R[4 * q], R[4 * q + 1], R[4 * q + 2], R[4 * q + 3]);
  }
}

// Bytes of dynamic shared memory a block of JT rays takes: G's tile (the
// activations and the widest skinning layer's padded weights) or the
// SIREN's row tile and its L-2 resident layers of factors, whichever is
// larger.
template <int JT>
static size_t iso_init_smem(const NetMeta& m) {
  int w = 0;
  for (int l = 0; l < m.n_skin; ++l)
    w = max(w, m.skin_dims[l] * sj_pad(m.skin_dims[l + 1]));
  const size_t skin = (size_t)sj_act_floats<JT>() + w;
  const size_t siren = (size_t)JT * II_LD
                       + (size_t)(m.n_layers - 2) * JT * m.hidden;
  return (skin > siren ? skin : siren) * sizeof(float);
}

template <int JT>
static int iso_init_launch(const float* x, const float* dirs, int n,
                           const float* bones16, const float* frame,
                           const float* params, const NetMeta& m,
                           float softmax_scale, float* out, cudaStream_t st) {
  const size_t smem = iso_init_smem<JT>(m);
  const cudaError_t e = cudaFuncSetAttribute(
      iso_init_kernel<JT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (n + JT - 1) / JT;
  iso_init_kernel<JT><<<blocks, II_THREADS, smem, st>>>(
      x, dirs, n, bones16, frame, params, m, softmax_scale, out);
  return launch_status();
}

// The launch of shape JT for n rays of the networks m, without launching:
// shape[0..3] = blocks, rays a block, dynamic shared memory a block, blocks
// resident an SM (the card's occupancy query).
template <int JT>
static int iso_init_query(int n, const NetMeta& m, int* shape) {
  const size_t smem = iso_init_smem<JT>(m);
  cudaError_t e = cudaFuncSetAttribute(
      iso_init_kernel<JT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, iso_init_kernel<JT>, II_THREADS, smem);
  shape[0] = (n + JT - 1) / JT;
  shape[1] = JT;
  shape[2] = (int)smem;
  shape[3] = per_sm;
  return (int)e;
}

// Whether the kernel takes the networks of m: a SIREN 3 -> H x (L-1) ->
// out (2 <= L <= 8, H a multiple of 4 of at most 256; row 0 of the output
// layer is the SDF) and a skinning MLP 3 -> ... -> 25 of at most 8 layers
// with hidden widths of at most SJ_MAXW (G's limits).
static bool iso_init_takes(const NetMeta& m) {
  if (m.n_layers < 2 || m.n_layers > NET_MAX_LAYERS || m.hidden < 4
      || m.hidden > II_THREADS || m.hidden % 4 || m.n_skin < 1
      || m.n_skin > NET_MAX_LAYERS || m.skin_dims[0] != 3
      || m.skin_dims[m.n_skin] != 25)
    return false;
  for (int l = 1; l < m.n_skin; ++l)
    if (m.skin_dims[l] < 1 || m.skin_dims[l] > SJ_MAXW) return false;
  return true;
}

// J_inv0 (n, 16) row-major at the rays' canonical points x (n, 3, metric)
// and directions dirs (n, 3). `params`: ops/march.py:pack_trace with the
// skinning MLP (the SIREN's (in, hidden) copies, its output row and the
// skinning layers' (in, pad32(out)) copies, 16-byte aligned). `variant`:
// the launch shape, 0 (16 rays a block) or 1 (8).
extern "C" int arah_iso_init(const float* x, const float* dirs, int n,
                             const float* bones16, const float* frame,
                             const float* params, NetMeta m,
                             float softmax_scale, int variant, float* out,
                             void* stream) {
  if (n <= 0) return 0;
  if (!iso_init_takes(m)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (variant == 0)
    return iso_init_launch<16>(x, dirs, n, bones16, frame, params, m,
                               softmax_scale, out, st);
  if (variant == 1)
    return iso_init_launch<8>(x, dirs, n, bones16, frame, params, m,
                              softmax_scale, out, st);
  return (int)cudaErrorInvalidValue;
}

// The launch shape `variant` would take for n rays of the networks m
// (iso_init_query; nothing launched).
extern "C" int arah_iso_init_shape(int variant, int n, NetMeta m,
                                   int* shape) {
  if (!iso_init_takes(m)) return (int)cudaErrorInvalidValue;
  if (variant == 0) return iso_init_query<16>(n, m, shape);
  if (variant == 1) return iso_init_query<8>(n, m, shape);
  return (int)cudaErrorInvalidValue;
}
