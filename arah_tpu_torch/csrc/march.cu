// Kernel E: the fused sphere-trace march, rays from a device-side queue.
//
// Replaces the TPU kernel arah_tpu/ops/pallas/march_kernel.py:
// sphere_march_pallas (body _make_kernel). Each iteration of each
// unfinished ray: nearest posed vertex (ties average their skinning
// weights) -> blended bone transform T16 -> adjugate inverse of its 3x3
// -> canonical point x_hat = R^-1 ((p - trans) - t) -> kernel-form
// normalisation -> generated-SIREN SDF -> clamped march step, frozen once
// the ray converges or diverges, at most n_iters iterations (per-ray
// values as the TPU's per-tile exit: a ray's values never depend on the
// rays beside it).
//
// Bound on the H100: operations. A ray-iteration costs the SIREN's
// 3x256 + 5x256x256 + 256 multiply-adds (~0.33 M at the flagship) plus
// ~8 flops per posed vertex of the nearest-vertex scan (6,946 vertices);
// the bytes are ~100 B per ray in and out; the weights (~1.3 MB) stay in
// L2 and every CTA streams them once an iteration.
//
// Design (csrc/stream_mlp.cuh): a persistent grid, as many CTAs (or
// clusters) as fit on the card; each owns R ray slots. A slot whose ray
// stops (converged, diverged, or at its own n_iters) writes that ray's
// outputs and takes the next ray index from a global atomic counter; each
// iteration runs on the live slots only, compacted, so the work follows
// what the rays need instead of each tile's slowest ray. The SIREN runs
// as stream_mlp.cuh's register-blocked pass with its weights streamed
// through a shared-memory ring. The scan
// reads the posed vertices as float4 (x, y, z, |v|^2), built once a launch
// by verts4_kernel with |v|^2's products and sums rounded on their own,
// and staged in shared-memory chunks, each read once by the CTA for all
// its rays; each live ray's lanes walk them with a stride keeping a
// running (min, first index, tie count), merged by shuffles and, on a
// cluster, across the CTAs' vertex ranges (each CTA scans 1/C of them);
// every product and sum of the distance is rounded on its own in the plain
// version's order (as csrc/knn.cu), so a near-tie resolves as in
// ops/march.py. A tie (count > 1) is re-scanned by one lane, which
// averages the tied vertices' weights, and is counted.
#include "stream_mlp.cuh"

struct MarchArgs {
  const float *cam, *dir, *near, *far;
  int n, nv;
  const float4* v4;
  const float *sw, *bones, *frame, *P;
  NetMeta m;
  int n_iters;
  float thresh, clamp_dist;
  int* counters;          // [0] the ray queue, [1] ties re-scanned
  float* t_out;
  unsigned char *unf_out, *div_out;
  float *xnorm_out, *t16_out;
  int* iters_out;         // may be null
};

__global__ void verts4_kernel(const float* __restrict__ v, int nv,
                              float4* __restrict__ v4) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= nv) return;
  const float x = v[3 * k], y = v[3 * k + 1], z = v[3 * k + 2];
  v4[k] = make_float4(x, y, z,
                      __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                                __fmul_rn(z, z)));
}

// The outputs of ray r (t, flags, x_norm, T16 and its iteration count).
__device__ __forceinline__ void march_write(const MarchArgs& a, int r,
                                            float t, bool unf, bool dv,
                                            const float* xn, const float* T,
                                            int it) {
  a.t_out[r] = t;
  a.unf_out[r] = unf ? 1 : 0;
  a.div_out[r] = dv ? 1 : 0;
#pragma unroll
  for (int c = 0; c < 3; ++c) a.xnorm_out[3 * r + c] = xn ? xn[c] : 0.f;
  for (int c = 0; c < 16; ++c) a.t16_out[16 * r + c] = T ? T[c] : 0.f;
  if (a.iters_out) a.iters_out[r] = it;
}

template <class S>
__global__ void __launch_bounds__(S::NT, S::MINB)
march_kernel(const MarchArgs a) {
  constexpr int R = S::R, C = S::C;
  extern __shared__ __align__(16) float smem[];
  float* act = smem;                       // [2][SM_MAXW][LDA]
  float* ring = smem + 2 * S::ABUF;        // [ST][KC][CU]
  __shared__ PassTable pt;
  __shared__ float bones[N_BONES * 16];
  __shared__ int s_ray[R], s_new[R], s_it[R], s_unf[R], s_div[R];
  __shared__ int s_exhausted, s_nl, s_list[R];
  __shared__ float s_cam[R][3], s_dir[R][3], s_pts[R][3], s_far[R], s_t[R];
  __shared__ float s_pbest[C][R];
  __shared__ int s_pidx[C][R], s_pcnt[C][R];
  __shared__ float s_best[R];
  __shared__ int s_idx[R], s_cnt[R];
  __shared__ float s_w[R][N_BONES];
  __shared__ float s_T[R][16], s_Tout[R][16];
  __shared__ float s_xn[R][3], s_xout[R][3];
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
    pass_table(pt, m, false, C, S::KC);
  }
  if constexpr (C > 1) cg::this_cluster().sync();
  else __syncthreads();
  ring_start<S>(ring, pt, a.P, rank);
  int g = 0;                               // the ring's next chunk
  const int vchunk = (a.nv + C - 1) / C;
  const int vbeg = min(a.nv, rank * vchunk),
            vend = min(a.nv, vbeg + vchunk);

  for (;;) {
    // ---- refill: the leader takes the next live rays from the queue for
    // the empty slots (rays that start finished are written at once)
    if (rank == 0 && j < R && s_ray[j] < 0) {
      int r = -1;
      while (!*(volatile int*)&s_exhausted) {
        const int c = atomicAdd(a.counters, 1);
        if (c >= a.n) {
          s_exhausted = 1;
          break;
        }
        const float nr = a.near[c], fr = a.far[c];
        if (a.n_iters > 0 && nr < fr) {
          r = c;
          break;
        }
        march_write(a, c, nr, nr < fr, !(nr < fr), nullptr, nullptr, 0);
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
          s_xout[j][c] = 0.f;
        }
        for (int c = 0; c < 16; ++c) s_Tout[j][c] = 0.f;
        s_t[j] = a.near[r];
        s_far[j] = a.far[r];
        s_unf[j] = 1;
        s_div[j] = 0;
        s_it[j] = 0;
      }
    }
    if (!__syncthreads_or(j < R && s_ray[j] >= 0)) break;
    // the live slots, compacted: every step below runs on positions
    // [0, nl) of s_list
    const int nl = live_list<S>(s_ray, s_list, &s_nl);
    if (j < R && s_ray[j] >= 0) {
#pragma unroll
      for (int c = 0; c < 3; ++c)
        s_pts[j][c] = __fadd_rn(s_cam[j][c], __fmul_rn(s_t[j], s_dir[j][c]));
    }
    __syncthreads();
    // ---- nearest posed vertex over this CTA's range: running (min, first
    // index, tie count) of lpr lanes a live ray, the vertices staged in
    // chunks through activation buffer 1 (free until the pass's first
    // epilogue)
    {
      const int lpr = scan_lanes<S>(nl);
      const int p = j / lpr, lane = j % lpr;
      const int sl = p < nl ? s_list[p] : 0;
      const float px = s_pts[sl][0], py = s_pts[sl][1], pz = s_pts[sl][2];
      float best = __int_as_float(0x7f800000);   // +inf
      int bidx = 0, bcnt = 0;
      float4* vs = reinterpret_cast<float4*>(act + S::ABUF);
      for (int base = vbeg; base < vend; base += S::ABUF / 4) {
        const int cnt = min(S::ABUF / 4, vend - base);
        for (int i = j; i < cnt; i += S::NT) vs[i] = __ldg(a.v4 + base + i);
        __syncthreads();
        if (p < nl) {
          for (int k = lane; k < cnt; k += lpr) {
            const float4 q = vs[k];
            const float dot = __fadd_rn(__fadd_rn(__fmul_rn(px, q.x),
                                                  __fmul_rn(py, q.y)),
                                        __fmul_rn(pz, q.z));
            const float d = __fsub_rn(q.w, __fmul_rn(2.0f, dot));
            if (d < best) {
              best = d;
              bidx = base + k;
              bcnt = 1;
            } else if (d == best) {
              ++bcnt;
            }
          }
        }
        __syncthreads();
      }
      for (int o = lpr / 2; o > 0; o >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, o, lpr);
        const int oi = __shfl_xor_sync(0xffffffffu, bidx, o, lpr);
        const int oc = __shfl_xor_sync(0xffffffffu, bcnt, o, lpr);
        if (ob < best) {
          best = ob;
          bidx = oi;
          bcnt = oc;
        } else if (ob == best) {
          bidx = min(bidx, oi);
          bcnt += oc;
        }
      }
      if (lane == 0 && p < nl) {
        if constexpr (C > 1) {
          cg::cluster_group cl = cg::this_cluster();
#pragma unroll
          for (int q = 0; q < C; ++q) {
            cl.map_shared_rank(&s_pbest[0][0], q)[rank * R + sl] = best;
            cl.map_shared_rank(&s_pidx[0][0], q)[rank * R + sl] = bidx;
            cl.map_shared_rank(&s_pcnt[0][0], q)[rank * R + sl] = bcnt;
          }
        } else {
          s_pbest[0][sl] = best;
          s_pidx[0][sl] = bidx;
          s_pcnt[0][sl] = bcnt;
        }
      }
    }
    if constexpr (C > 1) cg::this_cluster().sync();
    else __syncthreads();
    if (j < R && s_ray[j] >= 0) {     // the ranges in vertex order
      float best = s_pbest[0][j];
      int bidx = s_pidx[0][j], bcnt = s_pcnt[0][j];
#pragma unroll
      for (int q = 1; q < C; ++q) {
        const float ob = s_pbest[q][j];
        if (ob < best) {
          best = ob;
          bidx = s_pidx[q][j];
          bcnt = s_pcnt[q][j];
        } else if (ob == best) {
          bidx = min(bidx, s_pidx[q][j]);
          bcnt += s_pcnt[q][j];
        }
      }
      s_best[j] = best;
      s_idx[j] = bidx;
      s_cnt[j] = bcnt;
    }
    __syncthreads();
    // ---- skinning weights of the nearest vertex; ties averaged
    for (int e = j; e < nl * 16; e += S::NT) {
      const int p = s_list[e >> 4], lane = e & 15;
      if (s_cnt[p] <= 1) {
        for (int c = lane; c < N_BONES; c += 16)
          s_w[p][c] = __ldg(a.sw + (long long)s_idx[p] * N_BONES + c);
      } else if (lane == 0) {
        // rare: sum the tied vertices' rows in vertex order, then divide
        if (rank == 0) atomicAdd(a.counters + 1, 1);
        float acc[N_BONES];
#pragma unroll
        for (int c = 0; c < N_BONES; ++c) acc[c] = 0.f;
        const float px = s_pts[p][0], py = s_pts[p][1], pz = s_pts[p][2];
        const float bst = s_best[p];
        for (int v = 0; v < a.nv; ++v) {
          const float4 q = __ldg(a.v4 + v);
          const float dot = __fadd_rn(__fadd_rn(__fmul_rn(px, q.x),
                                                __fmul_rn(py, q.y)),
                                      __fmul_rn(pz, q.z));
          if (__fsub_rn(q.w, __fmul_rn(2.0f, dot)) == bst) {
#pragma unroll
            for (int c = 0; c < N_BONES; ++c)
              acc[c] += __ldg(a.sw + (long long)v * N_BONES + c);
          }
        }
        const float cntf = (float)s_cnt[p];
#pragma unroll
        for (int c = 0; c < N_BONES; ++c) s_w[p][c] = acc[c] / cntf;
      }
    }
    __syncthreads();
    // ---- blended transform: (live ray, entry)
    for (int e = j; e < nl * 16; e += S::NT) {
      const int p = s_list[e >> 4], lane = e & 15;
      float s = 0.f;
#pragma unroll
      for (int b = 0; b < N_BONES; ++b)
        s = fmaf(s_w[p][b], bones[b * 16 + lane], s);
      s_T[p][lane] = s;
    }
    __syncthreads();
    // ---- backward map to the normalised canonical point, the SIREN's
    // input at position j (positions past nl feed zeros; their results are
    // not read)
    if (j >= nl && j < R) {
#pragma unroll
      for (int c = 0; c < 3; ++c) act[c * S::LDA + j] = 0.f;
    } else if (j < R) {
      const int p = s_list[j];
      const float* T = s_T[p];
      const float Rm[9] = {T[0], T[1], T[2], T[4], T[5], T[6],
                           T[8], T[9], T[10]};
      float Ri[9];
      inv3x3(Rm, Ri);
      float v[3];
#pragma unroll
      for (int c = 0; c < 3; ++c)
        v[c] = (s_pts[p][c] - fa.trans[c]) - T[4 * c + 3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float xh = Ri[3 * c] * v[0] + Ri[3 * c + 1] * v[1]
                         + Ri[3 * c + 2] * v[2];
        const float xn = xh * fa.nscale + fa.noff[c];
        s_xn[p][c] = xn;
        act[c * S::LDA + j] = xn;
      }
    }
    const int out = run_layers<S>(pt, 0, pt.n, act, 0, ring, g, a.P, m, 1.f,
                                  rank, nl);
    siren_out<S>(act + out * S::ABUF, a.P, m, s_list, nl, s_sdf);
    // ---- the march step; a ray that stops writes its outputs and frees
    // its slot
    if (j < R && s_ray[j] >= 0) {
      const float sdf = s_sdf[j] * fa.mscale;
#pragma unroll
      for (int c = 0; c < 3; ++c) s_xout[j][c] = s_xn[j][c];
      for (int c = 0; c < 16; ++c) s_Tout[j][c] = s_T[j][c];
      const float sm = fminf(fmaxf(sdf, -a.clamp_dist), a.clamp_dist);
      const bool update = fabsf(sm) > a.thresh && fabsf(sdf) < 1e6f;
      float t = s_t[j];
      int dv = s_div[j];
      if (update) {
        t = t + sm;
        dv = t >= s_far[j];
      }
      s_t[j] = t;
      s_div[j] = dv;
      if (fabsf(sdf) <= a.thresh || dv) s_unf[j] = 0;
      const int it = ++s_it[j];
      if (!s_unf[j] || it >= a.n_iters) {
        if (rank == 0)
          march_write(a, s_ray[j], t, s_unf[j] != 0, dv != 0, s_xout[j],
                      s_Tout[j], it);
        s_ray[j] = -1;
      }
    }
  }
  cp_async_wait_all();
  if constexpr (C > 1) cg::this_cluster().sync();
}

template <class S>
static int march_launch(const MarchArgs& a, cudaStream_t st, int* shape,
                        bool run) {
  return launch_tile<S>(march_kernel<S>, a, a.n, false, st, shape, run);
}

// Launch shape 0 (64-ray CTAs) or 1 (16-ray clusters of 4 CTAs).
static int march_dispatch(int variant, const MarchArgs& a, cudaStream_t st,
                          int* shape, bool run) {
  if (variant == 0) return march_launch<ShapeWide>(a, st, shape, run);
  if (variant == 1) return march_launch<ShapeC4>(a, st, shape, run);
  return (int)cudaErrorInvalidValue;
}

// The launch shape `variant` would take for n rays (stream_mlp.cuh:
// launch_tile's shape: blocks, cluster size, R, shared memory a CTA, CTAs
// an SM), without launching.
extern "C" int arah_march_shape(int variant, int n, int* shape) {
  MarchArgs a = {};
  a.n = n;
  return march_dispatch(variant, a, 0, shape, false);
}

// `verts4`: (nv, 4) f32 scratch; `counters`: 2 ints of scratch (zeroed
// here; [1] counts the re-scanned ties); `iters_out` may be null.
extern "C" int arah_march(const float* cam, const float* dirs,
                          const float* near, const float* far, int n,
                          const float* verts, int nv, const float* sw,
                          const float* bones16, const float* frame,
                          const float* params, NetMeta m, int n_iters,
                          float thresh, float clamp_dist, int variant,
                          float* verts4, int* counters, float* t_out,
                          unsigned char* unf_out, unsigned char* div_out,
                          float* xnorm_out, float* t16_out, int* iters_out,
                          void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(counters, 0, 2 * sizeof(int), st);
  if (e != cudaSuccess) return (int)e;
  if (nv > 0) {
    verts4_kernel<<<(nv + 255) / 256, 256, 0, st>>>(verts, nv,
                                                    (float4*)verts4);
    const int s = launch_status();
    if (s != 0) return s;
  }
  MarchArgs a = {cam, dirs, near, far, n, nv, (const float4*)verts4,
                 sw, bones16, frame, params, m, n_iters, thresh,
                 clamp_dist, counters, t_out, unf_out, div_out, xnorm_out,
                 t16_out, iters_out};
  return march_dispatch(variant, a, st, nullptr, true);
}
