// w4a4_matmul_i8: int8 activation codes x planar int4 weights, int32
// accumulation, fused dequant epilogue.
//
// Replaces: flatquant_tpu/kernels/int4_matmul.py:w4a4_matmul_i8 (Pallas,
// int8 MXU).
//
//   y[m, n] = (float)(acc[m, n] - 8 * rowsum[m]) * sx[m] * sw[n]
//   acc     = sum_k x_q[m, k] * nib[n, k],   nib = q + 8 in [0, 15]
//   packed  byte c of row n = nib[n, c] | nib[n, c + K/2] << 4
//
// What bounds it on the H100: at decode (M <= 8) the weight stream. Every
// packed byte is read once (N * K/2 bytes: 25 MB for the merged qkv of
// llama-2-7b) against 2*M*N*K integer operations, far below the 1979
// TOP/s int8 rate, so the floor is bytes / 3.35 TB/s.
//
// Design: one warp owns ROWS output rows; each lane streams 16-byte
// chunks of those rows (coalesced, read-only path), unpacks the two
// nibble planes with one mask and one shift per 32-bit word, and feeds
// __dp4a against the matching 16 bytes of activation codes from the low
// and the high half of the row. The activation rows are small and shared
// by every warp, so they come through L1/L2; holding ROWS weight rows per
// warp reuses each activation load ROWS times. A block covers MT
// activation rows; grid.y tiles longer M (prefill here has M < 256, where
// the weights are re-read once per tile from L2 -- a tensor-core rewrite
// is later work). The int32 sums are exact and the epilogue multiplies in
// the plain version's order, so the result is bit-identical to
// w4a8_matmul_ref (float32 products of integers below 2^24, TF32 off).

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int WARPS = 4;  // warps per block
constexpr int ROWS = 4;   // weight rows (outputs n) per warp
constexpr int MT = 8;     // activation rows (outputs m) per block

template <typename OutT>
__device__ __forceinline__ OutT to_out(float v);
template <>
__device__ __forceinline__ float to_out<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ int dot8(uint4 xl, uint4 xh, uint4 w, int acc) {
  const unsigned m = 0x0F0F0F0Fu;
  acc = __dp4a(static_cast<int>(xl.x), static_cast<int>(w.x & m), acc);
  acc = __dp4a(static_cast<int>(xl.y), static_cast<int>(w.y & m), acc);
  acc = __dp4a(static_cast<int>(xl.z), static_cast<int>(w.z & m), acc);
  acc = __dp4a(static_cast<int>(xl.w), static_cast<int>(w.w & m), acc);
  acc = __dp4a(static_cast<int>(xh.x), static_cast<int>((w.x >> 4) & m), acc);
  acc = __dp4a(static_cast<int>(xh.y), static_cast<int>((w.y >> 4) & m), acc);
  acc = __dp4a(static_cast<int>(xh.z), static_cast<int>((w.z >> 4) & m), acc);
  acc = __dp4a(static_cast<int>(xh.w), static_cast<int>((w.w >> 4) & m), acc);
  return acc;
}

__device__ __forceinline__ int sum16(uint4 x, int acc) {
  const int ones = 0x01010101;
  acc = __dp4a(static_cast<int>(x.x), ones, acc);
  acc = __dp4a(static_cast<int>(x.y), ones, acc);
  acc = __dp4a(static_cast<int>(x.z), ones, acc);
  acc = __dp4a(static_cast<int>(x.w), ones, acc);
  return acc;
}

template <typename OutT>
__global__ void __launch_bounds__(WARPS * 32)
w4a4_matmul_i8_kernel(const int8_t* __restrict__ xq,
                      const uint8_t* __restrict__ wp,
                      const float* __restrict__ sx,
                      const float* __restrict__ sw, OutT* __restrict__ y,
                      int M, int N, int K) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n0 = (blockIdx.x * WARPS + warp) * ROWS;
  const int m0 = blockIdx.y * MT;
  if (n0 >= N) return;  // no block-level barrier follows
  const int mt = min(MT, M - m0);
  const int half = K / 2;        // packed bytes per row = hi-plane offset
  const int chunks = half / 16;  // 16-byte chunks per packed row

  int acc[MT][ROWS];
  int rsum[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    rsum[m] = 0;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[m][r] = 0;
  }

  for (int c = lane; c < chunks; c += 32) {
    uint4 w[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      w[r] = (n0 + r < N)
                 ? ldg16(wp + static_cast<size_t>(n0 + r) * half + c * 16)
                 : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m < mt) {
        const int8_t* xr = xq + static_cast<size_t>(m0 + m) * K + c * 16;
        const uint4 xl = ldg16(xr);
        const uint4 xh = ldg16(xr + half);
        rsum[m] = sum16(xh, sum16(xl, rsum[m]));
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[m][r] = dot8(xl, xh, w[r], acc[m][r]);
      }
    }
  }

  // butterfly sums: every lane ends with every total, then lane
  // (m * ROWS + r) % 32 writes output (m, r)
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      rsum[m] += __shfl_xor_sync(0xffffffffu, rsum[m], o);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        acc[m][r] += __shfl_xor_sync(0xffffffffu, acc[m][r], o);
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (lane == ((m * ROWS + r) & 31) && m < mt && n0 + r < N) {
        float v = static_cast<float>(acc[m][r] - 8 * rsum[m]);
        v = v * sx[m0 + m];
        v = v * sw[n0 + r];
        y[static_cast<size_t>(m0 + m) * N + n0 + r] = to_out<OutT>(v);
      }
    }
  }
}

}  // namespace

// x_q int8 [M, K]; w_packed uint8 [N, K/2]; sx f32 [M]; sw f32 [N];
// y [M, N] bf16 (out_is_f32 = 0) or f32. K % 32 == 0 and 16-byte aligned
// rows are the caller's contract (checked in Python).
extern "C" int fq_w4a4_matmul_i8(const void* xq, const void* wp,
                                 const void* sx, const void* sw, void* y,
                                 int M, int N, int K, int out_is_f32,
                                 void* stream) {
  const int rows_per_block = WARPS * ROWS;
  dim3 grid((N + rows_per_block - 1) / rows_per_block, (M + MT - 1) / MT);
  dim3 block(WARPS * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto x = static_cast<const int8_t*>(xq);
  auto w = static_cast<const uint8_t*>(wp);
  auto a = static_cast<const float*>(sx);
  auto b = static_cast<const float*>(sw);
  if (out_is_f32) {
    w4a4_matmul_i8_kernel<float><<<grid, block, 0, s>>>(
        x, w, a, b, static_cast<float*>(y), M, N, K);
  } else {
    w4a4_matmul_i8_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        x, w, a, b, static_cast<__nv_bfloat16*>(y), M, N, K);
  }
  return static_cast<int>(cudaGetLastError());
}
