// Kernel E: the fused sphere-trace march of a ray tile.
//
// Replaces the TPU kernel arah_tpu/ops/pallas/march_kernel.py:
// sphere_march_pallas (body _make_kernel). Each iteration of each
// unfinished ray: nearest posed vertex (ties average their skinning
// weights) -> blended bone transform T16 -> adjugate inverse of its 3x3
// -> canonical point x_hat = R^-1 ((p - trans) - t) -> kernel-form
// normalisation -> generated-SIREN SDF -> clamped march step, frozen once
// the ray converges or diverges, at most n_iters iterations; the tile
// stops when none of its rays is unfinished (per-ray values as the TPU's
// per-tile exit).
//
// Bound on the H100: operations. A ray-iteration costs the SIREN's
// 3x256 + 5x256x256 + 256 multiply-adds (~0.33 M at the flagship) plus
// ~8 flops per posed vertex of the nearest-vertex scan (6,946 vertices);
// the bytes are ~100 B per ray in and out, the weights (~1.3 MB) stay in
// L2.
//
// Design: kernel C's tile (csrc/tile_mlp.cuh): 256 threads own 16 rays;
// the SIREN's activations, the rays' state (t, flags, x_norm, T16) and a
// 1,024-vertex chunk of the posed body (x, y, z, |v|^2) sit in shared
// memory. The scan gives each ray 16 lanes that walk the chunk with a
// stride of 16, keep a running (min, first index, tie count) and merge it
// by shuffles; every product and sum of the distance is rounded on its own
// in the plain version's order (as csrc/knn.cu), so a near-tie resolves
// as in ops/march.py. A tie (count > 1) is re-scanned by one lane, which
// averages the tied vertices' weights. Finished rays skip the scan; the
// tile's SIREN pass covers all 16 rays.
#include "tile_mlp.cuh"

#define KNN_CHUNK 1024

__global__ void __launch_bounds__(TILE_THREADS)
march_kernel(const float* __restrict__ cam_g, const float* __restrict__ dir_g,
             const float* __restrict__ near_g, const float* __restrict__ far_g,
             int n, const float* __restrict__ verts, int nv,
             const float* __restrict__ sw, const float* __restrict__ bones_g,
             const float* __restrict__ frame_g, const float* __restrict__ P,
             NetMeta m, int n_iters, float thresh, float clamp_dist,
             float* __restrict__ t_out, unsigned char* __restrict__ unf_out,
             unsigned char* __restrict__ div_out,
             float* __restrict__ xnorm_out, float* __restrict__ t16_out) {
  __shared__ __align__(16) float hbuf[TILE_RAYS * TILE_LD];
  __shared__ float4 sv[KNN_CHUNK];
  __shared__ float bones[N_BONES * 16];
  __shared__ float s_cam[TILE_RAYS][3], s_dir[TILE_RAYS][3];
  __shared__ float s_pts[TILE_RAYS][3], s_far[TILE_RAYS], s_t[TILE_RAYS];
  __shared__ int s_unf[TILE_RAYS], s_div[TILE_RAYS];
  __shared__ float s_best[TILE_RAYS];
  __shared__ int s_idx[TILE_RAYS], s_cnt[TILE_RAYS];
  __shared__ float s_w[TILE_RAYS][N_BONES];
  __shared__ float s_T[TILE_RAYS][16], s_Tout[TILE_RAYS][16];
  __shared__ float s_xn[TILE_RAYS][3], s_xout[TILE_RAYS][3];
  __shared__ float s_sdf[TILE_RAYS];

  const int j = threadIdx.x;
  const int r0 = blockIdx.x * TILE_RAYS;
  const FrameAffine fa = frame_affine(frame_g);
  for (int k = j; k < N_BONES * 16; k += blockDim.x) bones[k] = bones_g[k];
  if (j < TILE_RAYS) {
    const int r = r0 + j;
    const bool in = r < n;
    const float nr = in ? near_g[r] : 0.f, fr = in ? far_g[r] : 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      s_cam[j][c] = in ? cam_g[3 * r + c] : 0.f;
      s_dir[j][c] = in ? dir_g[3 * r + c] : 0.f;
      s_xout[j][c] = 0.f;
    }
    for (int c = 0; c < 16; ++c) s_Tout[j][c] = 0.f;
    s_t[j] = nr;
    s_far[j] = fr;
    s_unf[j] = in && nr < fr;
    s_div[j] = !(nr < fr);
  }

  const int p = j >> 4, lane = j & 15;   // the scan's (ray, lane)
  for (int it = 0; it < n_iters; ++it) {
    if (!__syncthreads_or(j < TILE_RAYS && s_unf[j])) break;
    if (j < TILE_RAYS) {
#pragma unroll
      for (int c = 0; c < 3; ++c)
        s_pts[j][c] = __fadd_rn(s_cam[j][c], __fmul_rn(s_t[j], s_dir[j][c]));
    }
    // ---- nearest posed vertex: running (min, first index, tie count)
    const bool live = s_unf[p] != 0;
    float best = __int_as_float(0x7f800000);   // +inf
    int bidx = 0, bcnt = 0;
    for (int base = 0; base < nv; base += KNN_CHUNK) {
      const int cnt = min(KNN_CHUNK, nv - base);
      __syncthreads();
      for (int k = j; k < cnt; k += blockDim.x) {
        const float x = verts[3 * (base + k)];
        const float y = verts[3 * (base + k) + 1];
        const float z = verts[3 * (base + k) + 2];
        sv[k] = make_float4(x, y, z,
                            __fadd_rn(__fadd_rn(__fmul_rn(x, x),
                                                __fmul_rn(y, y)),
                                      __fmul_rn(z, z)));
      }
      __syncthreads();
      if (live) {
        const float px = s_pts[p][0], py = s_pts[p][1], pz = s_pts[p][2];
        for (int k = lane; k < cnt; k += 16) {
          const float4 q = sv[k];
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
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, o, 16);
      const int oi = __shfl_xor_sync(0xffffffffu, bidx, o, 16);
      const int oc = __shfl_xor_sync(0xffffffffu, bcnt, o, 16);
      if (ob < best) {
        best = ob;
        bidx = oi;
        bcnt = oc;
      } else if (ob == best) {
        bidx = min(bidx, oi);
        bcnt += oc;
      }
    }
    if (lane == 0) {
      s_best[p] = best;
      s_idx[p] = bidx;
      s_cnt[p] = bcnt;
    }
    __syncthreads();
    // ---- skinning weights of the nearest vertex; ties averaged
    if (live) {
      if (s_cnt[p] <= 1) {
        for (int c = lane; c < N_BONES; c += 16)
          s_w[p][c] = __ldg(sw + (long long)s_idx[p] * N_BONES + c);
      } else if (lane == 0) {
        // rare: sum the tied vertices' rows in vertex order, then divide
        float acc[N_BONES];
#pragma unroll
        for (int c = 0; c < N_BONES; ++c) acc[c] = 0.f;
        const float px = s_pts[p][0], py = s_pts[p][1], pz = s_pts[p][2];
        const float bst = s_best[p];
        for (int v = 0; v < nv; ++v) {
          const float x = verts[3 * v], y = verts[3 * v + 1],
                      z = verts[3 * v + 2];
          const float vsq = __fadd_rn(__fadd_rn(__fmul_rn(x, x),
                                                __fmul_rn(y, y)),
                                      __fmul_rn(z, z));
          const float dot = __fadd_rn(__fadd_rn(__fmul_rn(px, x),
                                                __fmul_rn(py, y)),
                                      __fmul_rn(pz, z));
          if (__fsub_rn(vsq, __fmul_rn(2.0f, dot)) == bst) {
#pragma unroll
            for (int c = 0; c < N_BONES; ++c)
              acc[c] += __ldg(sw + (long long)v * N_BONES + c);
          }
        }
        const float cntf = (float)s_cnt[p];
#pragma unroll
        for (int c = 0; c < N_BONES; ++c) s_w[p][c] = acc[c] / cntf;
      }
    }
    __syncthreads();
    // ---- blended transform: thread (ray p, entry lane)
    if (live) {
      float s = 0.f;
#pragma unroll
      for (int b = 0; b < N_BONES; ++b)
        s = fmaf(s_w[p][b], bones[b * 16 + lane], s);
      s_T[p][lane] = s;
    }
    __syncthreads();
    // ---- backward map to the normalised canonical point (finished rays
    // feed zeros to the SIREN pass; their results are not read)
    if (j < TILE_RAYS && !s_unf[j]) {
#pragma unroll
      for (int c = 0; c < 3; ++c) hbuf[j * TILE_LD + c] = 0.f;
    } else if (j < TILE_RAYS) {
      const float* T = s_T[j];
      const float R[9] = {T[0], T[1], T[2], T[4], T[5], T[6],
                          T[8], T[9], T[10]};
      float Ri[9];
      inv3x3(R, Ri);
      float v[3];
#pragma unroll
      for (int c = 0; c < 3; ++c)
        v[c] = (s_pts[j][c] - fa.trans[c]) - T[4 * c + 3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float xh = Ri[3 * c] * v[0] + Ri[3 * c + 1] * v[1]
                         + Ri[3 * c + 2] * v[2];
        const float xn = xh * fa.nscale + fa.noff[c];
        s_xn[j][c] = xn;
        hbuf[j * TILE_LD + c] = xn;
      }
    }
    __syncthreads();
    tile_siren(hbuf, P, m, s_sdf);
    // ---- the march step
    if (j < TILE_RAYS && s_unf[j]) {
      const float sdf = s_sdf[j] * fa.mscale;
#pragma unroll
      for (int c = 0; c < 3; ++c) s_xout[j][c] = s_xn[j][c];
      for (int c = 0; c < 16; ++c) s_Tout[j][c] = s_T[j][c];
      const float sm = fminf(fmaxf(sdf, -clamp_dist), clamp_dist);
      const bool update = fabsf(sm) > thresh && fabsf(sdf) < 1e6f;
      float t = s_t[j];
      int dv = s_div[j];
      if (update) {
        t = t + sm;
        dv = t >= s_far[j];
      }
      s_t[j] = t;
      s_div[j] = dv;
      if (fabsf(sdf) <= thresh || dv) s_unf[j] = 0;
    }
  }
  __syncthreads();
  if (j < TILE_RAYS && r0 + j < n) {
    const int r = r0 + j;
    t_out[r] = s_t[j];
    unf_out[r] = s_unf[j] ? 1 : 0;
    div_out[r] = s_div[j] ? 1 : 0;
#pragma unroll
    for (int c = 0; c < 3; ++c) xnorm_out[3 * r + c] = s_xout[j][c];
  }
  if (r0 + p < n) t16_out[16 * (r0 + p) + lane] = s_Tout[p][lane];
}

extern "C" int arah_march(const float* cam, const float* dirs,
                          const float* near, const float* far, int n,
                          const float* verts, int nv, const float* sw,
                          const float* bones16, const float* frame,
                          const float* params, NetMeta m, int n_iters,
                          float thresh, float clamp_dist, float* t_out,
                          unsigned char* unf_out, unsigned char* div_out,
                          float* xnorm_out, float* t16_out, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + TILE_RAYS - 1) / TILE_RAYS;
  march_kernel<<<blocks, TILE_THREADS, 0, (cudaStream_t)stream>>>(
      cam, dirs, near, far, n, verts, nv, sw, bones16, frame, params, m,
      n_iters, thresh, clamp_dist, t_out, unf_out, div_out, xnorm_out,
      t16_out);
  return launch_status();
}
