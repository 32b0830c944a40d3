// FP8 block-scaled serving GEMM (port of flatquant_tpu/kernels/fp8_matmul.py):
//   fp8_matmul -> fq_fp8_matmul
//
// Replaces: flatquant_tpu/kernels/fp8_matmul.py:fp8_matmul (Pallas: e4m3
// weights decoded in-kernel with integer bit arithmetic, bf16 MXU, one
// float32 scale per 128-wide k-chunk and output column).
//
//   y[m, n] = sum_c se[c, n] * (x[m, c] . decode(w8[n, c]))
//
// over the k-chunks c of 128. x is bf16 [M, K] (the wrapper casts float32
// to bf16, as JAX does), w8 float8_e4m3fn [N, K] (row = output channel),
// se float32 [K/128, N], y bf16 or float32 [M, N]; K % 128 == 0 and
// N % 128 == 0. An optional leading expert axis (the MoE's routed
// experts) is grid z; x may be shared by every expert (expert stride 0).
//
// The activations are never quantized: each e4m3 code is decoded to bf16,
// where it embeds exactly (4 exponent and 3 mantissa bits fit bf16's 8 and
// 7), and the products run on the bf16 tensor cores (mma.sync m16n8k16,
// float32 accumulators). Two decodes, as JAX's:
//   EXACT  every code to its IEEE value: a normal code shifts into bf16's
//          fields (bits = sign << 15 | ((em << 4) + 0x3C00)); a subnormal
//          code (em < 8) is m * 2^-9, formed in float32 and narrowed
//          exactly;
//   FTZ    subnormal codes to +0 (JAX's _decode_ftz); exact on weights
//          packed with fp8_block_quantize(ftz=True).
// The two NaN codes decode to +-480 in both, as in JAX's kernel.
//
// Accumulation: each chunk's 128-k partial sum starts from zero on the
// tensor cores, is scaled by se[c, n] (__fmul_rn) and added to the running
// float32 sums with an IEEE add (__fadd_rn), in JAX's order (acc = acc +
// part * se). The tensor cores' own float32 accumulation truncates, and
// chained over all of K it would drift from the plain version.
//
// What bounds it on the H100: at decode (M <= 64) the weight stream, one
// byte per weight (N * K bytes) against 2*M*N*K operations; at prefill
// (the gathered experts, M = 384; a 2048-token prompt) the bf16 tensor
// cores. Two tile shapes behind one entry point:
//   M <= 64  16 x 64 tiles, 4 warps (each 16 x 16): more blocks for a
//            weight-bound stream, little wasted tensor-core work;
//   M > 64   128 x 128 tiles, 8 warps (each 32 x 64).
// Tiles of 128 k (one chunk) are double-buffered in shared memory by
// cp.async. A warp reads its fragments in a k order permuted within each
// 16-k step (thread tq takes k = 4tq .. 4tq+3 for both operands): one
// 32-bit load of four codes per B fragment pair and one 64-bit load per
// A row pair; the products pair up as before, only the order of the
// tensor cores' internal sum changes. wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int CHUNK = 128;        // k per scale chunk and per smem stage
constexpr int LDA = CHUNK + 8;    // padded shared row of x, bf16
constexpr int LDB = CHUNK + 16;   // padded shared row of w8, bytes

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// one e4m3 code (low 8 bits of b) -> bf16 bits
template <bool EXACT>
__device__ __forceinline__ unsigned decode1(unsigned b) {
  const unsigned em = b & 0x7Fu;
  const unsigned sign = (b & 0x80u) << 8;
  if (em >= 8u) return sign | ((em << 4) + 0x3C00u);
  if (!EXACT) return 0u;
  // subnormal (and zero): m * 2^-9, exact in float32 and in bf16
  const float v = static_cast<float>(em) * 0.001953125f;
  return sign | static_cast<unsigned>(__bfloat16_as_ushort(
                    __float2bfloat16_rn(v)));
}

// four codes (bytes of w, lowest k first) -> two bf16 pairs
template <bool EXACT>
__device__ __forceinline__ void decode4(unsigned w, unsigned& lo,
                                        unsigned& hi) {
  lo = decode1<EXACT>(w) | (decode1<EXACT>(w >> 8) << 16);
  hi = decode1<EXACT>(w >> 16) | (decode1<EXACT>(w >> 24) << 16);
}

template <typename OutT>
__device__ __forceinline__ OutT to_out(float v);
template <>
__device__ __forceinline__ float to_out<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 to_out<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

template <int BM, int BN>
constexpr int smem_bytes() {
  return 2 * (BM * LDA * 2 + BN * LDB);
}

// Block tile BM x BN; WM x WN warps, each a (BM/WM) x (BN/WN) warp tile of
// MT x NT mma tiles (16 x 8 each).
template <int BM, int BN, int WM, int WN, bool EXACT, typename OutT>
__global__ void __launch_bounds__(WM * WN * 32)
fp8_matmul_kernel(const bf16* __restrict__ x, long long x_estride,
                  const uint8_t* __restrict__ w8,
                  const float* __restrict__ se, OutT* __restrict__ y, int M,
                  int N, int K) {
  constexpr int THREADS = WM * WN * 32;
  constexpr int MT = BM / WM / 16;
  constexpr int NT = BN / WN / 8;
  static_assert(MT >= 1 && NT >= 1, "warp tile");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* a_s = reinterpret_cast<bf16*>(smem);                 // [2][BM][LDA]
  uint8_t* b_s = smem + 2 * BM * LDA * 2;                    // [2][BN][LDB]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, tq = lane & 3;
  const int wm = warp / WN, wn = warp % WN;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int e = blockIdx.z;
  x += static_cast<size_t>(e) * x_estride;
  w8 += static_cast<size_t>(e) * N * K;
  se += static_cast<size_t>(e) * (K / CHUNK) * N;
  y += static_cast<size_t>(e) * M * N;
  const int nc = K / CHUNK;

  auto load_stage = [&](int c, int buf) {
    bf16* as = a_s + buf * BM * LDA;
    uint8_t* bs = b_s + buf * BN * LDB;
    // x: BM rows x 16 segments of 8 bf16; rows past M re-read row M - 1
    // (their outputs are not stored)
    for (int i = tid; i < BM * 16; i += THREADS) {
      const int r = i >> 4, s = i & 15;
      const int m = min(m0 + r, M - 1);
      cp_async16(as + r * LDA + s * 8,
                 x + static_cast<size_t>(m) * K + c * CHUNK + s * 8);
    }
    // w8: BN rows x 8 segments of 16 codes
    for (int i = tid; i < BN * 8; i += THREADS) {
      const int r = i >> 3, s = i & 7;
      cp_async16(bs + r * LDB + s * 16,
                 w8 + static_cast<size_t>(n0 + r) * K + c * CHUNK + s * 16);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  load_stage(0, 0);
  cp_async_commit();
  for (int c = 0; c < nc; ++c) {
    const int buf = c & 1;
    if (c + 1 < nc) {
      load_stage(c + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const bf16* as = a_s + buf * BM * LDA + (wm * MT * 16) * LDA;
    const uint8_t* bs = b_s + buf * BN * LDB + (wn * NT * 8) * LDB;
    float part[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) part[i][j][q] = 0.f;
#pragma unroll
    for (int kk = 0; kk < CHUNK; kk += 16) {
      // k order within the step: thread tq holds k = kk + 4tq .. 4tq + 3
      // in both operands (fragment slots 2tq, 2tq+1 and 2tq+8, 2tq+9)
      unsigned af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const bf16* ar = as + (i * 16 + g8) * LDA + kk + tq * 4;
        const uint2 r0 = *reinterpret_cast<const uint2*>(ar);
        const uint2 r1 = *reinterpret_cast<const uint2*>(ar + 8 * LDA);
        af[i][0] = r0.x;
        af[i][1] = r1.x;
        af[i][2] = r0.y;
        af[i][3] = r1.y;
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const unsigned wv = *reinterpret_cast<const unsigned*>(
            bs + (j * 8 + g8) * LDB + kk + tq * 4);
        unsigned b0, b1;
        decode4<EXACT>(wv, b0, b1);
#pragma unroll
        for (int i = 0; i < MT; ++i) mma_bf16(part[i][j], af[i], b0, b1);
      }
    }
    // scale the chunk's partial sums by se[c, n] and add them in
    const float* sc = se + static_cast<size_t>(c) * N + n0 + wn * NT * 8;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 s = __ldg(reinterpret_cast<const float2*>(
          sc + j * 8 + tq * 2));
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        acc[i][j][0] = __fadd_rn(acc[i][j][0], __fmul_rn(part[i][j][0], s.x));
        acc[i][j][1] = __fadd_rn(acc[i][j][1], __fmul_rn(part[i][j][1], s.y));
        acc[i][j][2] = __fadd_rn(acc[i][j][2], __fmul_rn(part[i][j][2], s.x));
        acc[i][j][3] = __fadd_rn(acc[i][j][3], __fmul_rn(part[i][j][3], s.y));
      }
    }
    __syncthreads();  // the stage is reloaded two chunks on
  }

#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = m0 + wm * MT * 16 + i * 16 + g8 + (q >= 2 ? 8 : 0);
        const int n = n0 + wn * NT * 8 + j * 8 + tq * 2 + (q & 1);
        if (m < M) y[static_cast<size_t>(m) * N + n] = to_out<OutT>(acc[i][j][q]);
      }
    }
  }
}

// Opt a kernel into `bytes` of dynamic shared memory (above 48 KB), once
// per instantiation: a launch inside a CUDA graph capture then makes no
// runtime call.
template <typename Kern>
cudaError_t allow_smem(Kern kernel, int bytes, int* done) {
  if (bytes <= *done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *done = bytes;
  return err;
}

template <int BM, int BN, int WM, int WN, bool EXACT, typename OutT>
cudaError_t launch(const void* x, long long x_estride, const void* w8,
                   const void* se, void* y, int E, int M, int N, int K,
                   cudaStream_t s) {
  auto kern = fp8_matmul_kernel<BM, BN, WM, WN, EXACT, OutT>;
  constexpr int bytes = smem_bytes<BM, BN>();
  static int done = 0;
  const cudaError_t err = allow_smem(kern, bytes, &done);
  if (err != cudaSuccess) return err;
  dim3 grid(N / BN, (M + BM - 1) / BM, E);
  kern<<<grid, WM * WN * 32, bytes, s>>>(
      static_cast<const bf16*>(x), x_estride,
      static_cast<const uint8_t*>(w8), static_cast<const float*>(se),
      static_cast<OutT*>(y), M, N, K);
  return cudaGetLastError();
}

template <bool EXACT, typename OutT>
cudaError_t dispatch(const void* x, long long x_estride, const void* w8,
                     const void* se, void* y, int E, int M, int N, int K,
                     cudaStream_t s) {
  if (M <= 64)
    return launch<16, 64, 1, 4, EXACT, OutT>(x, x_estride, w8, se, y, E, M,
                                             N, K, s);
  return launch<128, 128, 4, 2, EXACT, OutT>(x, x_estride, w8, se, y, E, M,
                                             N, K, s);
}

}  // namespace

// x bf16 [E?, M, K] (expert stride x_estride elements, 0 = shared);
// w8 e4m3 [E, N, K]; se f32 [E, K/128, N]; y [E, M, N] bf16 (out_is_f32 =
// 0) or f32. K % 128 == 0, N % 128 == 0 and 16-byte aligned rows are the
// caller's contract (checked in Python).
extern "C" int fq_fp8_matmul(const void* x, long long x_estride,
                             const void* w8, const void* se, void* y, int E,
                             int M, int N, int K, int exact, int out_is_f32,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (exact) {
    err = out_is_f32
              ? dispatch<true, float>(x, x_estride, w8, se, y, E, M, N, K, s)
              : dispatch<true, bf16>(x, x_estride, w8, se, y, E, M, N, K, s);
  } else {
    err = out_is_f32
              ? dispatch<false, float>(x, x_estride, w8, se, y, E, M, N, K, s)
              : dispatch<false, bf16>(x, x_estride, w8, se, y, E, M, N, K, s);
  }
  return static_cast<int>(err);
}
