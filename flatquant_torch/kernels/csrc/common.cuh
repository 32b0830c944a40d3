// Shared plumbing of the port's kernels: every library exports its
// launch functions with a plain C interface and returns the launch's
// cudaError_t as an int (0 = launched); the Python wrapper raises on
// anything else and reads the message through fq_error_string.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

extern "C" const char* fq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

__device__ __forceinline__ uint4 ldg16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
