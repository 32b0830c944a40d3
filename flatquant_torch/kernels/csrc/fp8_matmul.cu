// FP8 block-scaled serving GEMM (port of flatquant_tpu/kernels/fp8_matmul.py):
//   fp8_matmul -> fq_fp8_matmul_n8, fq_fp8_matmul_n64, fq_fp8_matmul_n128
//                 (three device bodies; kernels/fp8_matmul.py `fp8_body`
//                 picks one from M)
//
// Replaces: flatquant_tpu/kernels/fp8_matmul.py:fp8_matmul (Pallas: e4m3
// weights decoded in-kernel with integer bit arithmetic, bf16 MXU, one
// float32 scale per 128-wide k-chunk and output column).
//
//   y[m, n] = sum_c se[c, n] * (x[m, c] . decode(w8[n, c]))
//
// over the k-chunks c of 128. x is bf16 [M, K] (the wrapper casts float32
// to bf16, as JAX does), w8 float8_e4m3fn [N, K] (row = output channel),
// se float32 [K/128, N], y bf16 or float32 [M, N]; K % 128 == 0, any N
// (rows past N are zero-filled and not stored). An optional leading
// expert axis (the MoE's routed experts) is grid z; x may be shared by
// every expert (expert stride 0).
//
// The activations are never quantized: each e4m3 code is decoded to bf16,
// where it embeds exactly (4 exponent and 3 mantissa bits fit bf16's 8 and
// 7), and the products run on the bf16 tensor cores. The decode of two
// codes (decode2): one byte permute spreads them into two halfwords, each
// with its sign byte replicated above it; a shift by 4 and a mask leave
// sign << 15 | exponent-and-mantissa << 4, a bf16 whose exponent field is
// the code's; one bf16x2 FMA by 2^120 (plus -0) moves the bias from 7 to
// 127. That is exact for every code: normals, subnormals (a bf16 subnormal
// times 2^120 is m * 2^-9) and +-0; the two NaN codes come out +-480, as
// in JAX's kernel. Two decodes, as JAX's:
//   EXACT  every code to its IEEE value;
//   FTZ    subnormal codes (exponent field 0) to +0 (JAX's _decode_ftz);
//          exact on weights packed with fp8_block_quantize(ftz=True).
//
// Accumulation: each chunk's 128-k partial sum starts from zero on the
// tensor cores (the chunk's first wgmma runs with scale-d 0), is scaled by
// se[c, n] (__fmul_rn) and added to the running float32 sums with an IEEE
// add (__fadd_rn), in JAX's order (acc = acc + part * se). The tensor
// cores' own float32 accumulation truncates, and chained over all of K it
// would drift from the plain version.
//
// What bounds it on the H100: at decode the weight stream, one byte per
// weight (N * K bytes; one DeepSeek-V2-Lite MoE layer's 8 linears at M = 1:
// 600 MB, 0.18 ms) against 2*M*N*K operations; at prefill (the gathered
// experts, M = 384; a 2048-token prompt) the bf16 tensor cores (64
// experts' e_w1 at M = 384: 142 GFLOP, 0.14 ms).
//
// Design: wgmma.mma_async m64nNk16 bf16 -> f32 with the weights as A from
// registers and the tokens as B (wgmma's N) from shared memory. The
// accumulator rows are output channels, so a thread needs only its own
// two rows' se[c, n] per chunk, and M = 1 costs an n8 product instead of
// a 16-row tile. A stage holds one 128-k chunk: the block's raw codes
// ([R rows][128 bytes]) and its tokens' bf16 rows as two 64-k halves,
// K-major 128-byte rows; both come in by TMA (one thread starts three
// tensor copies a chunk, zero-filled past M and N) with the 128-byte
// swizzle, which is the layout wgmma's B descriptor reads and spreads
// the codes' 2-byte fragment loads over distinct banks. A ring of STAGES
// stages has a "full" mbarrier (the copies' bytes) and an "empty" one
// (every warp done with the chunk) each, and no block-wide barrier in the
// loop: the warpgroups drift apart, so one folds while the other's
// wgmmas run. Each warp loads its 16 weight rows' codes two at a time in
// the A fragment's k order and decodes them in registers: every code of
// a stage is loaded and decoded once per block. A chunk runs as two
// groups of four k-steps on two A register sets: the first half's wgmmas
// run while the second half is decoded, and the second half's while the
// next chunk's first half is decoded; the partial sums are folded once
// the chunk's last group is done. Three bodies by M (the tokens of one
// block), each ring as deep as measured best (chip_smoke.py phase 3h;
// PERF.md):
//   n8    M <= 8 (decode): 64 channels (one warpgroup) x 8 tokens, 5
//         stages, so 4 blocks share an SM: the weight stream, 1,408
//         blocks for the 64-expert batch, 22 per expert;
//   n64   M <= 64: 64 channels x 64 tokens, 4 stages;
//   n128  M > 64 (prefill): 128 channels (two warpgroups) x 128 tokens, 3
//         stages.

#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"
#include "tma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int CHUNK = 128;  // k per scale chunk and per smem stage

// PTX prmt in its default mode: result byte i is byte (sel_i & 7) of (a,
// 0), or, where sel_i & 8, that byte's sign bit replicated over 8 bits
// (CUDA's __byte_perm reads only the low 3 bits of each selector)
__device__ __forceinline__ unsigned prmt_sign(unsigned a, unsigned sel) {
  unsigned r;
  asm("prmt.b32 %0, %1, 0, %2;\n" : "=r"(r) : "r"(a), "r"(sel));
  return r;
}

// two e4m3 codes (bytes 0 and 1 of v, the lower k first) -> bf16x2
template <bool EXACT>
__device__ __forceinline__ unsigned decode2(unsigned v) {
  // code, its sign byte, code, its sign byte: sign at bit 15 after << 4
  unsigned t = (prmt_sign(v, 0x9180u) << 4) & 0x87F087F0u;
  if (!EXACT) {  // exponent field 0 (subnormal or zero) -> +0
    const unsigned f = ((t & 0x07800780u) + 0x7F807F80u) & 0x80008000u;
    t &= prmt_sign(f, 0xBB99u);
  }
  unsigned r;  // t * 2^120 + (-0): exact, keeps the sign of a zero
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(r)
      : "r"(t), "r"(0x7B807B80u), "r"(0x80008000u));
  return r;
}

template <typename OutT>
__device__ __forceinline__ OutT to_out(float v);
template <>
__device__ __forceinline__ float to_out<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 to_out<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

template <int R, int BT, int STAGES>
struct Shape {
  static constexpr int THREADS = R * 2;         // R / 64 warpgroups
  static constexpr int X_STAGE = BT * 2 * 128;  // two 64-k halves [BT][128 B]
  static constexpr int W_STAGE = R * CHUNK;     // [R][128 B] codes
  // + 1024: the swizzled tiles start at a multiple of 1024 bytes; then
  // a full and an empty mbarrier per stage
  static constexpr int SMEM = STAGES * (X_STAGE + W_STAGE) + 1024 +
                              STAGES * 16;
  static constexpr int ACC = BT / 2;            // f32 per thread
};

// The body: R output channels x BT tokens per block (blockIdx.x channel
// tiles, fastest, then blockIdx.y token tiles, blockIdx.z experts). xmap:
// x as [XE, M, K] bf16 (XE = 1 when one x serves every expert), boxes of
// 64 k x BT rows; wmap: w8 as [E, N, K] bytes, boxes of 128 k x R rows;
// both with the 128-byte swizzle.
template <int R, int BT, int STAGES, bool EXACT, typename OutT>
__global__ void __launch_bounds__(R * 2)
fp8_matmul_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap wmap, int x_experts,
                  const float* __restrict__ se, OutT* __restrict__ y, int M,
                  int N, int K) {
  using S = Shape<R, BT, STAGES>;
  extern __shared__ __align__(16) uint8_t raw[];
  uint8_t* x_s = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  uint8_t* w_s = x_s + STAGES * S::X_STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(w_s + STAGES * S::W_STAGE);
  uint64_t* empty = full + STAGES;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, tq = lane & 3;
  const int n0 = blockIdx.x * R;
  const int m0 = blockIdx.y * BT;
  const int e = blockIdx.z;
  const int xe = x_experts > 1 ? e : 0;
  se += static_cast<size_t>(e) * (K / CHUNK) * N;
  y += static_cast<size_t>(e) * M * N;
  const int nc = K / CHUNK;
  // this thread's two accumulator rows (output channels) in the block
  const int row = warp * 16 + g8;
  const int na = n0 + row, nb = na + 8;

  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full + st, 1);
      mbar_init(empty + st, S::THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // chunk c into its slot (thread 0): the two x halves and the codes
  auto load_chunk = [&](int c) {
    const int slot = c % STAGES;
    uint8_t* xs = x_s + slot * S::X_STAGE;
    mbar_expect_tx(full + slot, S::X_STAGE + S::W_STAGE);
    tma_load(xs, &xmap, c * CHUNK, m0, xe, full + slot);
    tma_load(xs + BT * 128, &xmap, c * CHUNK + 64, m0, xe, full + slot);
    tma_load(w_s + slot * S::W_STAGE, &wmap, c * CHUNK, n0, e, full + slot);
  };

  // k-steps 4h .. 4h + 3 of the chunk in `slot`, decoded into a: for
  // step s, rows row and row + 8 at k = 16s + 2tq (+1) and 16s + 8 + 2tq
  // (+1), the A fragment's layout; 16-byte chunk s of a row lies at
  // s ^ (row % 8) (the swizzle; row % 8 == (row + 8) % 8 == g8)
  auto decode_half = [&](int slot, int h, unsigned (&a)[4][4]) {
    const uint8_t* wr = w_s + slot * S::W_STAGE + row * CHUNK + 2 * tq;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const uint8_t* p = wr + (((4 * h + s) ^ g8) << 4);
      a[s][0] = decode2<EXACT>(*reinterpret_cast<const unsigned short*>(p));
      a[s][1] = decode2<EXACT>(
          *reinterpret_cast<const unsigned short*>(p + 8 * CHUNK));
      a[s][2] = decode2<EXACT>(*reinterpret_cast<const unsigned short*>(p + 8));
      a[s][3] = decode2<EXACT>(
          *reinterpret_cast<const unsigned short*>(p + 8 * CHUNK + 8));
    }
  };

  float acc[S::ACC], part[S::ACC];
#pragma unroll
  for (int i = 0; i < S::ACC; ++i) acc[i] = 0.f;
  unsigned a0[4][4], a1[4][4];

  // the wgmmas of k-steps 4h .. 4h + 3 of the chunk in `slot` (A set a)
  auto mma_half = [&](int slot, int h, unsigned (&a)[4][4]) {
    const uint8_t* xs = x_s + slot * S::X_STAGE + h * BT * 128;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s)
      Wgmma<BT>::mma(part, a[s], sw128_desc(xs + s * 32), h + s > 0);
    wgmma_commit();
  };

  if (tid == 0)
    for (int c = 0; c < STAGES - 1 && c < nc; ++c) load_chunk(c);
  mbar_wait(full, 0);
  decode_half(0, 0, a0);

  for (int c = 0; c < nc; ++c) {
    const int slot = c % STAGES;
    const float sa = na < N ? __ldg(se + static_cast<size_t>(c) * N + na) : 0.f;
    const float sb = nb < N ? __ldg(se + static_cast<size_t>(c) * N + nb) : 0.f;
    // chunk c + STAGES - 1 into the slot chunk c - 1 held, once every warp
    // is done with it
    if (tid == 0 && c + STAGES - 1 < nc) {
      if (c > 0) mbar_wait(empty + (c - 1) % STAGES, ((c - 1) / STAGES) & 1);
      load_chunk(c + STAGES - 1);
    }
    fence_f32<S::ACC>(part);
    mma_half(slot, 0, a0);
    decode_half(slot, 1, a1);
    mma_half(slot, 1, a1);
    if (c + 1 < nc) {
      mbar_wait(full + (c + 1) % STAGES, ((c + 1) / STAGES) & 1);
      wgmma_wait<1>();  // the first half is done: a0 is free
      fence_u32<16>(&a0[0][0]);
      decode_half((c + 1) % STAGES, 0, a0);
    }
    wgmma_wait<0>();
    // the A sets stay live (unmoved) until the wgmmas that read them are
    // done; part is read only after them
    fence_f32<S::ACC>(part);
    fence_u32<16>(&a0[0][0]);
    fence_u32<16>(&a1[0][0]);
    // the warp is done with chunk c: its reads before the slot's refill
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + slot);
    // part[4i + q]: row na (q < 2) or nb, token 8i + 2tq + (q & 1)
#pragma unroll
    for (int i = 0; i < S::ACC; ++i)
      acc[i] = __fadd_rn(acc[i], __fmul_rn(part[i], (i & 2) ? sb : sa));
  }

#pragma unroll
  for (int i = 0; i < S::ACC; ++i) {
    const int n = (i & 2) ? nb : na;
    const int m = m0 + (i >> 2) * 8 + 2 * tq + (i & 1);
    if (m < M && n < N) y[static_cast<size_t>(m) * N + n] = to_out<OutT>(acc[i]);
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
  if (err == cudaSuccess)
    *done = bytes;
  else
    cudaGetLastError();  // returned to the caller; no later launch sees it
  return err;
}

template <int R, int BT, int STAGES, bool EXACT, typename OutT>
cudaError_t launch_t(const void* x, long long x_estride, const void* w8,
                     const void* se, void* y, int E, int M, int N, int K,
                     cudaStream_t s) {
  using Sh = Shape<R, BT, STAGES>;
  auto kern = fp8_matmul_kernel<R, BT, STAGES, EXACT, OutT>;
  static int done = 0;
  const cudaError_t err = allow_smem(kern, Sh::SMEM, &done);
  if (err != cudaSuccess) return err;
  // x: [XE, M, K] bf16, XE = E when each expert has its rows, else 1
  const int xe = x_estride ? E : 1;
  CUtensorMap xmap, wmap;
  if (!tensor_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, K, M, xe,
                  static_cast<long long>(M) * K, 64, BT) ||
      !tensor_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w8, K, N, E,
                  static_cast<long long>(N) * K, CHUNK, R))
    return cudaErrorInvalidValue;
  dim3 grid((N + R - 1) / R, (M + BT - 1) / BT, E);
  kern<<<grid, Sh::THREADS, Sh::SMEM, s>>>(
      xmap, wmap, xe, static_cast<const float*>(se), static_cast<OutT*>(y), M,
      N, K);
  return cudaGetLastError();
}

template <int R, int BT, int STAGES>
int launch(const void* x, long long x_estride, const void* w8, const void* se,
           void* y, int E, int M, int N, int K, int exact, int out_is_f32,
           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (exact)
    err = out_is_f32 ? launch_t<R, BT, STAGES, true, float>(
                           x, x_estride, w8, se, y, E, M, N, K, s)
                     : launch_t<R, BT, STAGES, true, bf16>(
                           x, x_estride, w8, se, y, E, M, N, K, s);
  else
    err = out_is_f32 ? launch_t<R, BT, STAGES, false, float>(
                           x, x_estride, w8, se, y, E, M, N, K, s)
                     : launch_t<R, BT, STAGES, false, bf16>(
                           x, x_estride, w8, se, y, E, M, N, K, s);
  return static_cast<int>(err);
}

}  // namespace

// x bf16 [E?, M, K] (expert stride x_estride elements, 0 = shared);
// w8 e4m3 [E, N, K]; se f32 [E, K/128, N]; y [E, M, N] bf16 (out_is_f32 =
// 0) or f32. K % 128 == 0 and 16-byte aligned rows are the caller's
// contract (checked in Python); any N and M. One entry point per body.
extern "C" int fq_fp8_matmul_n8(const void* x, long long x_estride,
                                const void* w8, const void* se, void* y,
                                int E, int M, int N, int K, int exact,
                                int out_is_f32, void* stream) {
  return launch<64, 8, 5>(x, x_estride, w8, se, y, E, M, N, K, exact,
                          out_is_f32, stream);
}

extern "C" int fq_fp8_matmul_n64(const void* x, long long x_estride,
                                 const void* w8, const void* se, void* y,
                                 int E, int M, int N, int K, int exact,
                                 int out_is_f32, void* stream) {
  return launch<64, 64, 4>(x, x_estride, w8, se, y, E, M, N, K, exact,
                           out_is_f32, stream);
}

extern "C" int fq_fp8_matmul_n128(const void* x, long long x_estride,
                                  const void* w8, const void* se, void* y,
                                  int E, int M, int N, int K, int exact,
                                  int out_is_f32, void* stream) {
  return launch<128, 128, 3>(x, x_estride, w8, se, y, E, M, N, K, exact,
                             out_is_f32, stream);
}
