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

// eight bf16 values (16 bytes) as float32
__device__ __forceinline__ void widen_bf16x8(uint4 v, float* f) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

// x + RINT_MAGIC rounds x to an integer (round half to even, |x| < 2^22)
// whose value the float's low bits then hold: bits - RINT_MAGIC_BITS.
// Full-rate adds, where rintf and the int conversions run at a quarter of
// the rate
constexpr float RINT_MAGIC = 12582912.f;  // 1.5 * 2^23
constexpr int RINT_MAGIC_BITS = 0x4B400000;

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
