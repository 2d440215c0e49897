// The generated SIREN's layout in one f32 buffer, shared by the shading
// kernel C (csrc/shade.cu) and its backward H (csrc/shade_bwd.cu). H also
// describes its gradient buffer with it: w_off the (out, in) dW blocks,
// b_off the db vectors, freq_off and phase_off the (L-1, hidden) FiLM
// gradients.
#pragma once

#include "common.cuh"

#define MAX_LAYERS 8

struct ShadeMeta {
  int n_layers, din, hidden, dout, film, bf16;
  long long wt_off[MAX_LAYERS];   // (in, out) copies for the forward
  long long w_off[MAX_LAYERS];    // original (out, in) for the reverse
  long long b_off[MAX_LAYERS];
  long long freq_off, phase_off;  // (L-1, hidden) each, if film
};
