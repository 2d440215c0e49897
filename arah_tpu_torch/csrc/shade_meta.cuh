// The generated SIREN's layout in one f32 buffer, shared by the shading
// kernel C (csrc/shade.cu) and its backward H (csrc/shade_bwd.cu). H also
// describes its gradient buffer with it: w_off the (out, in) dW blocks,
// b_off the db vectors, freq_off and phase_off the (L-1, hidden) FiLM
// gradients. resid: the kernels keep their residents in bf16 (the TPU
// kernels' resid_bf16).
#pragma once

#include <type_traits>

#include "common.cuh"

#define MAX_LAYERS 8

struct ShadeMeta {
  int n_layers, din, hidden, dout, film, bf16, resid;
  long long wt_off[MAX_LAYERS];   // (in, out) copies for the forward
  long long w_off[MAX_LAYERS];    // original (out, in) for the reverse
  long long b_off[MAX_LAYERS];
  long long freq_off, phase_off;  // (L-1, hidden) each, if film
};

// A resident of C and H: stored in bf16 under resid (RES), else in f32.
template <bool RES>
using ResT = typename std::conditional<RES, __nv_bfloat16, float>::type;

template <bool RES>
__device__ __forceinline__ void res_put(ResT<RES>* p, float v) {
  if constexpr (RES) *p = __float2bfloat16_rn(v);
  else *p = v;
}

template <bool RES>
__device__ __forceinline__ float res_get(const ResT<RES>* p) {
  if constexpr (RES) return __bfloat162float(*p);
  else return *p;
}
