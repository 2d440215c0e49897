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
// ~0.5 KB of features out; the generated weights stay in L2.
//
// Design. A block of 256 threads (8 warps) shades a tile of SHADE_TILE =
// 16 points; two blocks share an SM (~96 KB of shared memory each at the
// flagship), so one block's per-unit algebra overlaps the other's
// products. (A 32-point tile, one ~193 KB block per SM, halves the weight
// stream from L2 but was slower: PERF.md §6, PR 6.)
// - The products. Under bf16_shading every product operand is a bf16 value
//   (the rows are rounded when written, the hidden weights come as a bf16
//   copy, ops/shade.py:pack_shade_bf16, the one kernel H takes), so each
//   hidden (H x H) product, z = h W_i^T forward and g = a W_i in reverse,
//   runs on the tensor cores (mma.cuh:prod_mma, f32 sums): warp w owns
//   units [32w, 32w + 32) of the tile, and each weight it loads from L2
//   feeds its 16 points. The f32 launch (the eikonal points in training,
//   any config with bf16_shading off) runs the same body with FMA products
//   on the CUDA cores (mma.cuh:prod_fma; never TF32). The din-wide first
//   layer, the dx product and the dout-wide output layer run on the CUDA
//   cores in both.
// - The rows. One f32 [point][unit] tile holds the current product's input;
//   a product writes its result in place, then thread j does the per-unit
//   algebra of unit j over the tile's points in f32 (bias, FiLM, sincosf,
//   30 f cos) and rounds at the plain version's places: r(h), r(g * df).
// - The residents. The df = 30 f cos(30 u) factors of sine layers 0..L-3
//   stay in shared memory (16 KB a layer at H = 256 in f32), each in
//   column j, written and read back by thread j only. The last sine
//   layer's factor meets its reverse seed right away: a_{L-2} =
//   r(W_{L-1}[0] * df_{L-2}) waits in thread j's registers while the
//   output layer reads h_{L-1} from the rows.
// - resid (the TPU kernel's resid_bf16, RES): every df is stored in bf16
//   (8 KB a layer), the last one rounded too, as the TPU kernel's `st`
//   stores them; the forward chain, so the SDF and the features, keeps
//   its f32 bits, and only the normal moves.
// The features are stored in bf16 under bf16_shading (the eval path's
// dtype), or in f32 when `feat_f32` asks (the training op,
// ops/shade_grad.py, as the JAX training op returns them).
#include "mma.cuh"
#include "shade_meta.cuh"

#define SHADE_THREADS 256
#define SHADE_TILE 16
#define SHADE_LD (256 + 4)         // row stride of the tile (floats)

static_assert(SHADE_TILE % 16 == 0, "prod_mma: whole 16-point fragments");

// BF: the bf16_shading launch (tensor-core products); otherwise f32.
// RES: the residents in bf16.
template <bool BF, bool RES>
__global__ void __launch_bounds__(SHADE_THREADS, 2)   // two blocks an SM
shade_kernel(const float* __restrict__ x_g, int n,
             const float* __restrict__ P,
             const __nv_bfloat16* __restrict__ Wb, ShadeMeta m,
             float* __restrict__ sdf_out, void* __restrict__ feat_out,
             int feat_f32, float* __restrict__ grad_out) {
  extern __shared__ __align__(16) float smem[];
  const int H = m.hidden, L = m.n_layers, din = m.din, dout = m.dout;
  const int NL = L - 1;                        // sine layers
  const bool film = m.film != 0;
  float* rows = smem;                          // [TILE][LD]
  ResT<RES>* dfs = reinterpret_cast<ResT<RES>*>(
      smem + SHADE_TILE * SHADE_LD);           // [NL-1][TILE][H]
  const int j = threadIdx.x;
  const bool act = j < H;
  const int p0 = blockIdx.x * SHADE_TILE;

  for (int e = j; e < SHADE_TILE * din; e += blockDim.x) {
    const int p = e / din, k = e - p * din;
    rows[p * SHADE_LD + k] =
        p0 + p < n ? rnd_if(x_g[(long long)(p0 + p) * din + k], BF) : 0.f;
  }
  __syncthreads();

  // ---- forward through the sine layers
  float al[SHADE_TILE];                        // a_{L-2} of unit j
  for (int i = 0; i < NL; ++i) {
    if (i == 0) {
      prod_fma<SHADE_TILE>(rows, SHADE_LD, din, P + m.wt_off[0], H, H);
    } else {
      if constexpr (BF)
        prod_mma<SHADE_TILE / 16>(rows, SHADE_LD, H,
                                  Wb + 2LL * (i - 1) * H * H, H, rows,
                                  SHADE_LD, false);
      else
        prod_fma<SHADE_TILE>(rows, SHADE_LD, H, P + m.wt_off[i], H, H);
    }
    if (act) {
      const float b = __ldg(P + m.b_off[i] + j);
      const float f = film ? __ldg(P + m.freq_off + (long long)i * H + j)
                           : 1.f;
      const float ph = film ? __ldg(P + m.phase_off + (long long)i * H + j)
                            : 0.f;
      const float cf = film ? 30.f * f : 30.f;
      const float g_top = __ldg(P + m.w_off[L - 1] + j);
      const bool top = i == NL - 1;
      ResT<RES>* df = dfs + (long long)i * SHADE_TILE * H;
#pragma unroll
      for (int p = 0; p < SHADE_TILE; ++p) {
        float z = rows[p * SHADE_LD + j] + b;
        if (film) z = f * z + ph;
        float s, c;
        sincosf(30.f * z, &s, &c);
        const float d = cf * c;
        if (top)
          al[p] = rnd_if(g_top * rnd_if(d, RES), BF);
        else
          res_put<RES>(df + p * H + j, d);
        rows[p * SHADE_LD + j] = rnd_if(s, BF);
        if (top && p0 + p < n) {
          const long long o = (long long)(p0 + p) * H + j;
          if (BF && !feat_f32)
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
  for (int e = j; e < SHADE_TILE * dout; e += blockDim.x) {
    const int p = e / dout, o = e - p * dout;
    float a = 0.f;
    for (int k = 0; k < H; ++k)
      a = fmaf(rows[p * SHADE_LD + k],
               rnd_if(__ldg(WL + (long long)o * H + k), BF), a);
    if (p0 + p < n)
      sdf_out[(long long)(p0 + p) * dout + o] =
          a + __ldg(P + m.b_off[L - 1] + o);
  }
  __syncthreads();

  // ---- reverse chain: the rows hold a_i = r(g_{i+1} * df_i)
  if (act) {
#pragma unroll
    for (int p = 0; p < SHADE_TILE; ++p) rows[p * SHADE_LD + j] = al[p];
  }
  __syncthreads();
  for (int i = NL - 1; i >= 1; --i) {
    if constexpr (BF)                        // g_i = a_i W_i
      prod_mma<SHADE_TILE / 16>(rows, SHADE_LD, H,
                                Wb + (2LL * (i - 1) + 1) * H * H, H, rows,
                                SHADE_LD, false);
    else
      prod_fma<SHADE_TILE>(rows, SHADE_LD, H, P + m.w_off[i], H, H);
    if (act) {
      const ResT<RES>* df = dfs + (long long)(i - 1) * SHADE_TILE * H;
#pragma unroll
      for (int p = 0; p < SHADE_TILE; ++p) {
        const float dv = res_get<RES>(df + p * H + j);
        rows[p * SHADE_LD + j] = rnd_if(rows[p * SHADE_LD + j] * dv, BF);
      }
    }
    __syncthreads();
  }
  dx_rows<SHADE_TILE>(rows, SHADE_LD, H, P + m.w_off[0], din, p0, n,
                      grad_out);
}

// Shared memory of a block: the rows, then the df of sine layers 0..L-3
// (bf16 under resid).
static size_t shade_smem(const ShadeMeta& m) {
  return (size_t)SHADE_TILE * SHADE_LD * sizeof(float)
         + (size_t)(m.n_layers - 2) * SHADE_TILE * m.hidden
               * (m.resid ? sizeof(__nv_bfloat16) : sizeof(float));
}

template <bool BF, bool RES>
static int shade_launch(const float* x, int n, const float* params,
                        const __nv_bfloat16* wb, const ShadeMeta& m,
                        float* sdf, void* feat, int feat_f32, float* grad,
                        cudaStream_t st) {
  const size_t smem = shade_smem(m);
  const cudaError_t e = cudaFuncSetAttribute(
      shade_kernel<BF, RES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (n + SHADE_TILE - 1) / SHADE_TILE;
  shade_kernel<BF, RES><<<blocks, SHADE_THREADS, smem, st>>>(
      x, n, params, wb, m, sdf, feat, feat_f32, grad);
  return launch_status();
}

// Bytes of dynamic shared memory a block of kernel C takes for m.
extern "C" long long arah_shade_smem(ShadeMeta m) {
  return (long long)shade_smem(m);
}

// `wbf16`: under bf16, the hidden layers' weights 1..L-2 as bf16
// (L-2, 2, H, H), each (out, in) then transposed
// (ops/shade.py:pack_shade_bf16); null in f32.
extern "C" int arah_shade(const float* x, int n, const float* params,
                          const void* wbf16, ShadeMeta m, float* sdf,
                          void* feat, int feat_f32, float* grad,
                          void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const __nv_bfloat16* wb = static_cast<const __nv_bfloat16*>(wbf16);
  if (m.bf16)
    return m.resid ? shade_launch<true, true>(x, n, params, wb, m, sdf, feat,
                                              feat_f32, grad, st)
                   : shade_launch<true, false>(x, n, params, wb, m, sdf,
                                               feat, feat_f32, grad, st);
  return m.resid ? shade_launch<false, true>(x, n, params, wb, m, sdf, feat,
                                             feat_f32, grad, st)
                 : shade_launch<false, false>(x, n, params, wb, m, sdf, feat,
                                              feat_f32, grad, st);
}
