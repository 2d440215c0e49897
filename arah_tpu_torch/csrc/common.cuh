// Shared helpers of the arah_tpu_torch CUDA kernels (sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Round an f32 operand to bf16 (round-to-nearest-even) and back: the
// bf16_shading contract rounds matmul operands to bf16 and accumulates
// in f32.
__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float rnd_if(float x, bool bf16) {
  return bf16 ? bf16r(x) : x;
}

// Host side: the error state right after a launch (0 = launched).
static inline int launch_status() { return (int)cudaGetLastError(); }
