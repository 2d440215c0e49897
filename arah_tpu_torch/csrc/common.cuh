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

// 16-byte asynchronous copy global -> shared (cp.async, L2 only), its
// commit group and waits.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Host side: the error state right after a launch (0 = launched).
static inline int launch_status() { return (int)cudaGetLastError(); }
