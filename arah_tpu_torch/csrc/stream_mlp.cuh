// The network pass of the persistent slot kernels E (march), F (iso), B/L
// (corr) and J (siren): a tile of R ray (point) slots runs the generated
// SIREN's hidden layers (E, J), the collapsed skinning MLP (B/L) or both
// (F) with the weights streamed through shared memory and the products
// register-blocked; optionally the layer's output units are split across
// the CTAs of a thread-block cluster.
//
// - The live ray slots are compacted to positions [0, nl) every iteration
//   (live_list), and the pass runs on those positions only: a warp whose
//   positions all lie past nl skips the products and epilogues, so a tile
//   costs what its live rays cost, not what its slowest ray costs.
// - Activations live in shared memory k-major, act[k][position] with row
//   stride LDA = R + 4, in two buffers: layer l reads one and writes the
//   other, so a layer needs no barrier between its last read and its first
//   write.
// - Weights: every layer's transposed (in, ld) copy, ld its output width
//   padded to a multiple of 32 for the skinning MLP (zeros) and H for the
//   SIREN, each block 16-byte aligned (ops/march.py:pack_trace). The pass
//   is cut into chunks of KC input rows; a ring of ST chunk buffers is
//   filled with cp.async, ST - 1 chunks ahead, across layer, pass and
//   iteration boundaries (the sequence of chunks repeats every pass). One
//   barrier per chunk: it publishes the chunk and frees the stage that the
//   next copy overwrites.
// - Products: warp w owns RB ray positions and all CU units of its CTA;
//   lane l owns UB units, VW adjacent ones at a time. Per input row k one
//   broadcast load of the RB activations and UB / VW loads of weights feed
//   RB x UB FMAs. Every output's sum runs over k in order from 0 (acc =
//   fmaf(h, w, acc), then + bias), as a thread-per-unit loop sums it: the
//   same bits on every launch shape.
// - Cluster split (C > 1): CTA `rank` of the cluster computes output units
//   [rank wl, (rank + 1) wl) of every layer (wl = ld / C), so it streams
//   only its share of the weights, and writes its units into every CTA's
//   output buffer through distributed shared memory; one cluster barrier
//   per layer. Every other step of the solvers runs redundantly, on the
//   same inputs, in every CTA of the cluster.
// - The buffer rule on a cluster: a layer's epilogue writes buffer `out`
//   of every CTA, ordered only by the previous layer's cluster barrier
//   after each CTA's reads of it, so `out` must be a buffer that no CTA
//   reads after that barrier: the previous layer's input. A pass that
//   follows another with no cluster barrier between them (F's SIREN after
//   its skinning MLP, whose logits are read in between) starts on the
//   buffer the other returned, its inputs written there: its first
//   epilogue then writes the other's last input, never the logits. A
//   kernel whose passes follow each other with no cluster barrier between
//   them (J's tiles) starts each pass on the buffer the last one returned.
#pragma once

#include <cooperative_groups.h>

#include "tile_mlp.cuh"

namespace cg = cooperative_groups;

#define SM_MAXW 256         // widest layer of a SIREN pass
#define SM_MAX_PASS 16      // layers of one pass (skinning + SIREN)

enum { EPI_SINE = 0, EPI_SOFTPLUS = 1, EPI_LOGITS = 2 };


// The launch shape: R ray slots a CTA (a cluster of C CTAs) of NT threads;
// a ring of ST weight chunks of KC input rows; at least MINB CTAs an SM
// (the register budget); layers at most MAXW wide (256 for a SIREN pass,
// 128 for the corr pass). Warp w owns ray positions [w RB, (w + 1) RB) of
// the compacted live slots and all CU = MAXW / C units of its CTA: lane l
// owns UB of them, VW adjacent ones (one shared-memory load) at a time,
// units VW l + 32 VW v + e (v < UB / VW, e < VW). NG > 1: a narrow layer,
// one whose share of the CTA is at most CU / NG units (the 25 logits),
// runs with a warp's lanes in NG groups of 32 / NG, group q taking RB / NG
// of the warp's positions (run_layer), so no lane computes units past the
// layer's width.
template <int R_, int NT_, int C_, int KC_, int MINB_, int ST_,
          int MAXW_ = SM_MAXW, int NG_ = 1>
struct TileShape {
  static constexpr int R = R_, NT = NT_, C = C_, KC = KC_, MINB = MINB_,
                       ST = ST_, MAXW = MAXW_, NG = NG_;
  static constexpr int W = NT / 32;           // warps
  static constexpr int RB = R / W;            // ray positions of a warp
  static constexpr int CU = MAXW / C;         // units of a CTA
  static constexpr int UB = CU / 32;          // units of a lane
  static constexpr int VW = UB < 4 ? UB : 4;  // adjacent units a load
  static constexpr int LDA = R + 4;           // activation row stride
  static constexpr int ABUF = MAXW * LDA;     // floats of one buffer
  static constexpr int RING = ST * KC * CU;
  static size_t smem_bytes() { return (size_t)(2 * ABUF + RING) * 4; }
  static constexpr int RBN = RB / NG;        // positions of a lane group
  static_assert(R % W == 0 && (RB == 1 || RB == 2 || RB % 4 == 0)
                && CU % 32 == 0 && UB % VW == 0 && R <= 128 && ST >= 2
                && RB % NG == 0 && (RBN == 1 || RBN == 2 || RBN % 4 == 0),
                "shape");
};

struct PassLayer {
  long long wt, b;       // offsets into the parameter buffer
  int din, ld, wl, nch;  // input rows, row stride, this CTA's units, chunks
  int kind, film;        // EPI_*, the SIREN layer's index (FiLM rows)
};

struct PassTable {
  int n, nch;            // layers, chunks of one pass
  PassLayer l[SM_MAX_PASS];
};

__host__ __device__ inline int pad32i(int d) { return (d + 31) & ~31; }

// Thread 0: the pass of kernel E or J (SIREN hidden layers), F (skinning
// MLP, then the SIREN hidden layers) or B/L (skin, and m.n_layers = 0: the
// skinning MLP only).
__device__ inline void pass_table(PassTable& pt, const NetMeta& m, bool skin,
                                  int C, int kc) {
  int n = 0, nch = 0;
  auto add = [&](long long wt, long long b, int din, int ld, int kind,
                 int film) {
    PassLayer& L = pt.l[n++];
    L.wt = wt;
    L.b = b;
    L.din = din;
    L.ld = ld;
    L.wl = ld / C;
    L.nch = (din + kc - 1) / kc;
    L.kind = kind;
    L.film = film;
    nch += L.nch;
  };
  if (skin)
    for (int l = 0; l < m.n_skin; ++l)
      add(m.skin_wt_off[l], m.skin_b_off[l], m.skin_dims[l],
          pad32i(m.skin_dims[l + 1]),
          l == m.n_skin - 1 ? EPI_LOGITS : EPI_SOFTPLUS, -1);
  for (int i = 0; i < m.n_layers - 1; ++i)
    add(m.wt_off[i], m.b_off[i], i == 0 ? 3 : m.hidden, m.hidden, EPI_SINE,
        m.film ? i : -1);
  pt.n = n;
  pt.nch = nch;
}

// The widest layer (rows of an activation buffer) of pass_table's pass.
__host__ __device__ inline int pass_widest(const NetMeta& m, bool skin) {
  int w = m.n_layers > 1 ? m.hidden : 0;
  if (skin)
    for (int l = 0; l < m.n_skin; ++l) {
      const int d = pad32i(m.skin_dims[l + 1]);
      w = d > w ? d : w;
    }
  return w;
}

template <int N>
__device__ __forceinline__ void ld_vec(const float* p, float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 t = reinterpret_cast<const float4*>(p)[q];
      v[4 * q] = t.x;
      v[4 * q + 1] = t.y;
      v[4 * q + 2] = t.z;
      v[4 * q + 3] = t.w;
    }
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = p[0];
  }
}

template <int N>
__device__ __forceinline__ void st_vec(float* p, const float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q)
      reinterpret_cast<float4*>(p)[q] =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// Start the copy of chunk g of the pass sequence into its ring stage.
template <class S>
__device__ __forceinline__ void ring_issue(float* ring, const PassTable& pt,
                                           const float* __restrict__ P, int g,
                                           int rank) {
  int c = g % pt.nch, l = 0;
  while (c >= pt.l[l].nch) c -= pt.l[l++].nch;
  const int din = pt.l[l].din, ld = pt.l[l].ld, wl = pt.l[l].wl;
  const int k0 = c * S::KC, rows = min(S::KC, din - k0), q4 = wl >> 2;
  const float* src = P + pt.l[l].wt + (long long)k0 * ld + rank * wl;
  float* dst = ring + (g % S::ST) * (S::KC * S::CU);
  for (int i = threadIdx.x; i < rows * q4; i += S::NT) {
    const int r = i / q4, c4 = i - r * q4;
    cp_async16(dst + r * wl + 4 * c4, src + (long long)r * ld + 4 * c4);
  }
  cp_async_commit();
}

// The first ST - 1 chunks of the sequence; g (the next chunk to consume)
// starts at 0.
template <class S>
__device__ __forceinline__ void ring_start(float* ring, const PassTable& pt,
                                           const float* __restrict__ P,
                                           int rank) {
#pragma unroll
  for (int g = 0; g < S::ST - 1; ++g) ring_issue<S>(ring, pt, P, g, rank);
}

// acc[i][q] += sum over the chunk's rows k, in order, of a[k][i] times
// the lane's unit q of row k, units VW ul + LG VW v + e of the lane's
// index ul in its group of LG lanes (a: the lane's first ray position; w:
// the chunk at the lane's first unit); SPLIT3: the products of split3
// (tile_mlp.cuh:split3_fma; the corr pass's layers after the first).
template <class S, int RN, int LG, bool SPLIT3 = false>
__device__ __forceinline__ void chunk_fma(float (&acc)[RN][S::UB],
                                          const float* a, const float* w,
                                          int wl, int rows) {
  auto step = [&](int k) {
    float av[RN], wv[S::UB];
    ld_vec<RN>(a + k * S::LDA, av);
#pragma unroll
    for (int v = 0; v < S::UB / S::VW; ++v) {
      float t[S::VW];
      ld_vec<S::VW>(w + k * wl + LG * S::VW * v, t);
#pragma unroll
      for (int e = 0; e < S::VW; ++e) wv[S::VW * v + e] = t[e];
    }
    if constexpr (!SPLIT3) {
#pragma unroll
      for (int i = 0; i < RN; ++i)
#pragma unroll
        for (int q = 0; q < S::UB; ++q)
          acc[i][q] = fmaf(av[i], wv[q], acc[i][q]);
    } else {
#pragma unroll
      for (int i = 0; i < RN; ++i) {
        const float hi = bf16r(av[i]), lo = bf16r(av[i] - hi);
#pragma unroll
        for (int q = 0; q < S::UB; ++q)
          acc[i][q] = split3_fma(wv[q], hi, lo, acc[i][q]);
      }
    }
  };
  if (rows == S::KC) {
#pragma unroll
    for (int k = 0; k < S::KC; ++k) step(k);
  } else {
    for (int k = 0; k < rows; ++k) step(k);
  }
}

// Layer l of the pass with a warp's lanes in groups of LG: lane ul of
// group q computes units VW ul + LG VW v + e (v < UB / VW, e < VW) of the
// CTA's share at the RN positions [pos0 + q RN, pos0 + (q + 1) RN) of the
// warp's (LG = 32, RN = RB: one group, the warp's RB positions; a layer
// whose share is at most CU / NG units takes LG = 32 / NG, RN = RB / NG,
// so no lane computes units past the layer's width). Reads buffer in,
// writes and returns in ^ 1. PM: the corr pass's precision of every layer
// but the first (tile_mlp.cuh:PREC_*; E, F and J take f32): split3's
// products, or bf16's rounded softplus outputs (the next layer's inputs).
template <class S, int RN, int LG, int PM = PREC_F32>
__device__ __forceinline__ int run_layer(const PassTable& pt, int l,
                                         float* act, int in, float* ring,
                                         int& g, const float* __restrict__ P,
                                         const NetMeta& m, float scale,
                                         int rank, int nl) {
  const int lane = threadIdx.x & 31, ul = lane % LG;
  const int pos0 = (threadIdx.x >> 5) * S::RB + (lane / LG) * RN;
  const bool live = pos0 < nl;
  const int din = pt.l[l].din, wl = pt.l[l].wl;
  const float* a_in = act + in * S::ABUF + pos0;
  float acc[RN][S::UB];
#pragma unroll
  for (int i = 0; i < RN; ++i)
#pragma unroll
    for (int q = 0; q < S::UB; ++q) acc[i][q] = 0.f;
  for (int k0 = 0; k0 < din; k0 += S::KC) {
    cp_async_wait_group<S::ST - 2>();
    __syncthreads();
    ring_issue<S>(ring, pt, P, g + S::ST - 1, rank);
    const float* ws = ring + (g % S::ST) * (S::KC * S::CU);
    ++g;
    if (live) {
      if (PM == PREC_SPLIT3 && l > 0)
        chunk_fma<S, RN, LG, true>(acc, a_in + k0 * S::LDA, ws + S::VW * ul,
                                   wl, min(S::KC, din - k0));
      else
        chunk_fma<S, RN, LG>(acc, a_in + k0 * S::LDA, ws + S::VW * ul, wl,
                             min(S::KC, din - k0));
    }
  }
  const int out = in ^ 1;
  if (live) {
    const int kind = pt.l[l].kind, film = pt.l[l].film;
    const long long bo = pt.l[l].b;
#pragma unroll
    for (int q = 0; q < S::UB; ++q) {
      const int uc = S::VW * ul + LG * S::VW * (q / S::VW) + q % S::VW;
      if (uc >= wl) break;
      const int u = rank * wl + uc;
      const float b = __ldg(P + bo + u);
      float f = 1.f, ph = 0.f;
      if (film >= 0) {
        f = __ldg(P + m.freq_off + (long long)film * m.hidden + u);
        ph = __ldg(P + m.phase_off + (long long)film * m.hidden + u);
      }
      float v[RN];
#pragma unroll
      for (int i = 0; i < RN; ++i) {
        float z = acc[i][q] + b;
        if (kind == EPI_SINE) {
          if (film >= 0) z = f * z + ph;
          v[i] = sinf(30.f * z);
        } else if (kind == EPI_LOGITS) {
          v[i] = z * scale;
        } else {
          v[i] = softplus100(z);
          if constexpr (PM == PREC_BF16) v[i] = bf16r(v[i]);
        }
      }
      float* dst = act + out * S::ABUF + u * S::LDA + pos0;
      if constexpr (S::C > 1) {
        cg::cluster_group cl = cg::this_cluster();
#pragma unroll
        for (int c = 0; c < S::C; ++c)
          st_vec<RN>(cl.map_shared_rank(dst, c), v);
      } else {
        st_vec<RN>(dst, v);
      }
    }
  }
  if constexpr (S::C > 1) cg::this_cluster().sync();
  return out;
}

// Layers [l0, l1) of the pass over the first nl (compacted) ray positions,
// from activation buffer `in` (its rows 0..din-1 written, published by the
// first chunk's barrier); returns the buffer that holds the last layer's
// output, published to every thread. g: the ring's next chunk. A warp
// whose positions are all past nl skips the products (the ring still
// streams every chunk). PM: as run_layer's.
template <class S, int PM = PREC_F32>
__device__ int run_layers(const PassTable& pt, int l0, int l1, float* act,
                          int in, float* ring, int& g,
                          const float* __restrict__ P, const NetMeta& m,
                          float scale, int rank, int nl) {
  for (int l = l0; l < l1; ++l) {
    if constexpr (S::NG > 1)
      if (pt.l[l].wl * S::NG <= S::CU) {
        in = run_layer<S, S::RBN, 32 / S::NG, PM>(pt, l, act, in, ring, g, P,
                                                   m, scale, rank, nl);
        continue;
      }
    in = run_layer<S, S::RB, 32, PM>(pt, l, act, in, ring, g, P, m, scale,
                                     rank, nl);
  }
  if constexpr (S::C == 1) __syncthreads();
  return in;
}

// One output unit of the SIREN at the first nl ray positions from the
// last hidden activations (buffer a, k-major) and the unit's weight row
// wrow (H): 16 lanes a position over strided k, then a shuffle sum;
// store(p, sum + bias) on one lane. All threads call it.
template <class S, class Store>
__device__ void siren_dot(const float* a, const float* __restrict__ wrow,
                          float bias, int H, int nl, Store store) {
  const int lane = threadIdx.x & 15;
  for (int p0 = 0; p0 < nl; p0 += S::NT / 16) {
    const int p = p0 + (threadIdx.x >> 4);
    float acc = 0.f;
    if (p < nl)
      for (int k = lane; k < H; k += 16)
        acc = fmaf(a[k * S::LDA + p], __ldg(wrow + k), acc);
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o, 16);
    if (lane == 0 && p < nl) store(p, acc + bias);
  }
  __syncthreads();
}

// The SIREN's (one) output unit: sdf[list[p]] = siren_dot at position p.
template <class S>
__device__ void siren_out(const float* a, const float* __restrict__ P,
                          const NetMeta& m, const int* list, int nl,
                          float* sdf) {
  siren_dot<S>(a, P + m.wl_off, __ldg(P + m.b_off[m.n_layers - 1]),
               m.hidden, nl, [&](int p, float v) { sdf[list[p]] = v; });
}

// The live slots of the tile in slot order (s_ray[slot] >= 0) as list[0,
// nl); thread block-wide, publishes list and returns nl.
template <class S>
__device__ int live_list(const int* s_ray, int* list, int* s_nl) {
  if (threadIdx.x < 32) {
    int base = 0;
#pragma unroll
    for (int b = 0; b < S::R; b += 32) {
      const int sl = b + threadIdx.x;
      const bool lv = sl < S::R && s_ray[sl] >= 0;
      const unsigned mk = __ballot_sync(0xffffffffu, lv);
      if (lv) list[base + __popc(mk & ((1u << threadIdx.x) - 1u))] = sl;
      base += __popc(mk);
    }
    if (threadIdx.x == 0) *s_nl = base;
  }
  __syncthreads();
  return *s_nl;
}

// Lanes a live ray of the nearest-vertex scan: the largest power of two
// <= 32 with lanes x nl <= NT.
template <class S>
__device__ __forceinline__ int scan_lanes(int nl) {
  int lpr = 32;
  while (lpr > 1 && lpr * nl > S::NT) lpr >>= 1;
  return lpr;
}

// Host: set up and (if run) launch a persistent grid of kernel on n rays:
// as many CTAs (clusters) as fit on the card at once, at most one a
// ray-slot set's worth of rays; skin: the pass holds the skinning MLP
// (pass_table). shape (if not null): blocks, cluster size, R, dynamic
// shared memory a CTA, CTAs resident an SM. extra: bytes of dynamic shared
// memory the kernel takes after the pass's (S::smem_bytes()).
template <class S, class A>
static int launch_tile(void (*kernel)(A), const A& args, int n, bool skin,
                       cudaStream_t stream, int* shape, bool run,
                       size_t extra = 0) {
  // the pass's widest layer fits the shape, and every CTA of a cluster
  // takes whole warps' lanes of each SIREN layer (a skinning layer's
  // width is a multiple of 32: each CTA's share, a multiple of 4 floats)
  const int hidden = args.m.n_layers > 1 ? args.m.hidden : 0;
  if (pass_widest(args.m, skin) > S::MAXW || hidden % (32 * S::C))
    return (int)cudaErrorInvalidValue;
  const size_t smem = S::smem_bytes() + extra;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, S::NT,
                                                    smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.blockDim = dim3(S::NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  int cap = per_sm * sms;
  if (S::C > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = S::C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cfg.gridDim = dim3(S::C * sms);
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (e != cudaSuccess) return (int)e;
    cap = clusters * S::C;
  }
  if (cap <= 0) return (int)cudaErrorInvalidConfiguration;
  const int want = (n + S::R - 1) / S::R * S::C;
  const int blocks = want < cap ? want : cap;
  cfg.gridDim = dim3(blocks);
  if (shape) {
    shape[0] = blocks;
    shape[1] = S::C;
    shape[2] = S::R;
    shape[3] = (int)smem;
    shape[4] = per_sm;
  }
  if (!run || n <= 0) return 0;
  e = cudaLaunchKernelEx(&cfg, kernel, args);
  if (e != cudaSuccess) return (int)e;
  return launch_status();
}

// The launch shapes of kernels E and F (ops/march.py:launch_shape picks
// index 0 above 2,048 rays, 1 below; PERF.md gives the sweep that chose
// them): E takes ShapeWide, then ShapeC4; F takes ShapeC4, then ShapeC8.
//                           R   NT  C  KC MINB ST
using ShapeWide = TileShape<64, 512, 1, 32, 1, 2>;
using ShapeC4 = TileShape<16, 256, 4, 64, 2, 3>;
using ShapeC8 = TileShape<16, 256, 8, 64, 2, 3>;
