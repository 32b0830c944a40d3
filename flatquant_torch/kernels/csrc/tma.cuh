// mbarriers and the Tensor Memory Accelerator, shared by the kernels that
// take their operands by TMA (fp8_matmul.cu, int4_matmul.cu's w4a8 tile,
// flash_prefill.cu, flash_prefill_i8.cu, attn_prologue.cu's bf16 body,
// flat_pipeline.cu's left quant): barrier init / arrive / bounded wait,
// 3-d and 4-d tensor copies counted on a barrier, 3-d tensor stores with
// their bulk groups, and the tensor maps, encoded on the host through
// cuTensorMapEncodeTiled, looked up in libcuda.so.1 at run time so the
// libraries link against nothing new.
#pragma once

#include <cuda.h>  // CUtensorMap and its encoder's types
#include <dlfcn.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// wait for the phase of the given parity to complete; a transfer that
// never lands traps (a launch failure) instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = smem_u32(bar);
  unsigned done, spins = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (!done && ++spins == (1u << 26)) __trap();
  } while (!done);
}
// one box of a 3-d tensor map into shared memory, counted on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, int c2,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}

// one box of a 4-d tensor map into shared memory, counted on bar
__device__ __forceinline__ void tma_load4(void* dst, const CUtensorMap* map,
                                          int c0, int c1, int c2, int c3,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// one box from shared memory into a 3-d tensor map, in this thread's bulk
// group; the threads that wrote the box ran fence_proxy_async and a
// barrier before
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's bulk groups still read shared
// memory (the source may be rewritten)
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// wait until at most N of this thread's bulk groups are still in flight
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once in libcuda.so.1 (which the CUDA
// runtime has already loaded)
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!lib) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib)
      fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// a 3-d [d2, d1, d0] tensor map (d0 innermost, contiguous) with boxes of
// [1, b1, b0] and the given swizzle; elements past the tensor's edges
// land as zeros (and count as transferred bytes); false if the encoder
// refuses it
inline bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, int esize,
                       const void* base, long long d0, long long d1,
                       long long d2, long long stride2, int b0, int b1,
                       CUtensorMapSwizzle swizzle =
                           CU_TENSOR_MAP_SWIZZLE_128B) {
  EncodeTiled fn = encoder();
  if (!fn) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d0),
                              static_cast<cuuint64_t>(d1),
                              static_cast<cuuint64_t>(d2)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d0 * esize),
                                 static_cast<cuuint64_t>(stride2 * esize)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(b0),
                             static_cast<cuuint32_t>(b1), 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return fn(map, type, 3, const_cast<void*>(base), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a tensor map of `rank` (3 or 4) dims: d[0] (innermost, contiguous) ..
// d[rank - 1], the byte strides of dims 1 .. rank - 1 (multiples of 16, in
// any order), boxes of [1, .., b1, b0], 128-byte swizzle (b0 * esize <=
// 128); elements past the tensor's edges land as zeros (and count as
// transferred bytes); false if the encoder refuses it
inline bool tensor_map_nd(CUtensorMap* map, CUtensorMapDataType type,
                          const void* base, int rank, const long long* d,
                          const long long* stride_bytes, int b0, int b1) {
  EncodeTiled fn = encoder();
  if (!fn || rank < 2 || rank > 5) return false;
  cuuint64_t dims[5], strides[4];
  cuuint32_t box[5], estr[5];
  for (int i = 0; i < rank; ++i) {
    dims[i] = static_cast<cuuint64_t>(d[i]);
    box[i] = i == 0 ? b0 : i == 1 ? b1 : 1;
    estr[i] = 1;
  }
  for (int i = 0; i < rank - 1; ++i)
    strides[i] = static_cast<cuuint64_t>(stride_bytes[i]);
  return fn(map, type, rank, const_cast<void*>(base), dims, strides, box,
            estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a 4-d bf16 tensor map: dims d[0] (innermost, contiguous) .. d[3], the
// byte strides of dims 1-3 (multiples of 16, in any order), boxes of
// [1, 1, b1, b0], 128-byte swizzle; false if the encoder refuses it
inline bool tensor_map4_bf16(CUtensorMap* map, const void* base,
                             const long long (&d)[4],
                             const long long (&stride_bytes)[3], int b0,
                             int b1) {
  EncodeTiled fn = encoder();
  if (!fn) return false;
  cuuint64_t dims[4], strides[3];
  for (int i = 0; i < 4; ++i) dims[i] = static_cast<cuuint64_t>(d[i]);
  for (int i = 0; i < 3; ++i)
    strides[i] = static_cast<cuuint64_t>(stride_bytes[i]);
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(b0),
                             static_cast<cuuint32_t>(b1), 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
