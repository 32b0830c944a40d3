// The int4-weight GEMMs of the serving linears and the one-pass
// per-token activation quant (port of flatquant_tpu/kernels/int4_matmul.py):
//   w4a4_matmul_i8  -> fq_w4a4_matmul_i8_stream, fq_w4a4_matmul_i8_tile
//                      (int8 codes x int4 weights; two bodies)
//   quant_acts_i8   -> fq_quant_acts_i8    (per-token symmetric quant)
//   w4a8_matmul     -> fq_w4a8_matmul      (bf16 activations x int4 weights)
//   w4a4_matmul_i8_fusedq -> fq_w4a4_matmul_i8_fusedq_stream, _tile
//                      (quant_acts_i8 fused into w4a4_matmul_i8's bodies)
// and, from flatquant_tpu/kernels/grouped_mlp.py (Pallas), the first two
// on the grouped activation layout [K / 128, M, 128] (flat column c of row
// m at (c / 128) * M * 128 + m * 128 + c % 128):
//   w4a4_matmul_i8_grouped -> fq_w4a4_matmul_i8_grouped_stream, _tile
//   quant_acts_i8_grouped  -> fq_quant_acts_i8_grouped
// Each is its flat twin's body with a layout flag that changes only the
// addresses of 16-byte chunks (each inside one group): the same
// instructions in the same order, so it equals its twin bit for bit on
// group_layout of the same codes or values.
// Weights are planar-packed biased nibbles everywhere:
//   packed byte c of row n = nib[n, c] | nib[n, c + K/2] << 4, nib = q + 8
// and the -8 zero point folds into each epilogue as -8 * rowsum(x), except
// in w4a4_matmul_i8's tile body, which unpacks to signed codes.
//
// ---------------------------------------------------------------------
// w4a4_matmul_i8: int8 activation codes x planar int4 weights, int32
// accumulation, fused dequant epilogue. Two device bodies behind one
// wrapper; kernels/int4_matmul.py `w4a4_body` picks one from (M, N, K).
//
// Replaces: flatquant_tpu/kernels/int4_matmul.py:w4a4_matmul_i8 (Pallas,
// int8 MXU).
//
//   y[m, n] = (float)acc[m, n] * sx[m] * sw[n]
//   acc     = sum_k x_q[m, k] * (nib[n, k] - 8)   (exact int32)
//
// What bounds it on the H100, by regime:
// - decode (M <= 8): bytes. Every packed weight byte is read once, N * K/2
//   bytes (25 MB for llama-2-7b's merged qkv: 7.5 us at 3.35 TB/s) against
//   2 * M * N * K operations, far below the 1,979 TOP/s int8 rate.
// - prefill (M in the hundreds and thousands): int8 operations. At M =
//   2048 the qkv is 206 G operations, 0.104 ms at 1,979 TOP/s, against
//   84 MB (0.025 ms). Only the tensor cores get near that rate.
//
// Stream body (fq_w4a4_matmul_i8_stream, M below the crossover): one warp
// owns ROWS weight rows; each lane streams 16-byte chunks of those rows
// (coalesced, read-only path), unpacks the two nibble planes with one
// mask and one shift per 32-bit word, and feeds __dp4a against the
// matching 16 bytes of activation codes from the low and the high half of
// the row; the -8 zero point folds in as -8 * rowsum(x). A block covers MT
// activation rows; grid.y tiles longer M, and every tile re-reads the
// whole weight from L2 (256 times at M = 2048), on the CUDA cores: that
// is why it lost 21x to torch._int_mm there and now serves decode only.
//
// Tile body (fq_w4a4_matmul_i8_tile): a 128 x 128 output tile per block
// on the tensor cores, wgmma.mma_async m64n128k32 s8 x s8 -> s32 with the
// unpacked weights as A from registers and the activation codes as B
// from a 4-stage cp.async ring of 128-byte-swizzled tiles: the main loop
// of csrc/w4a4_tile.cuh (shared with the swiglu GEMMs), whose note gives
// the layout and the signed-code arithmetic (the int32 sum is 16 * acc
// exactly: no row sum). Weight reuse through L2: blockIdx.x walks the M
// tiles, so all M tiles of one weight N tile run together and the packed
// weight comes from HBM about once per call. Rows past M and N are
// zero-filled and not stored. What is left on the table (PERF.md): the
// epilogue stores 2-byte outputs scattered along N, and no TMA, no warp
// specialisation and no persistent grid yet.
//
// The crossover (int4_matmul.py TILE_MIN_M = 32) is the smallest M from
// which the tile body beats the stream body at all four llama-2-7b shapes
// in chip_smoke.py phase 3a's sweep on an H100 (at M = 16 the o
// projection still streams faster: a 128-row tile is mostly padding and
// 32 blocks cannot pull its 8 MB of weights as fast as 256 streaming
// blocks). Both bodies give the same int32 sums,
// and both epilogues multiply in the plain version's order, so either is
// bit-identical to w4a8_matmul_ref (float32 products of integers below
// 2^24, TF32 off).
//
// ---------------------------------------------------------------------
// quant_acts_i8: x [M, K] (bf16 or f32) -> int8 codes [M, K], f32 scales
// [M, 1], per row: xmax = max(x, 0) * cmax, xmin = min(x, 0) * cmin,
// s = max(|xmin|, xmax) / q_max (1 for a zero row), q = clamp(rint(x / s),
// -q_max - 1, q_max).
//
// Replaces: flatquant_tpu/kernels/int4_matmul.py:quant_acts_i8 (Pallas).
//
// What bounds it on the H100: bytes. One read of x and one write of the
// codes (at Qwen-2.5-7B's down input, [2048, 18944] bf16: 77.6 MB read,
// 38.8 MB written, 35 us at 3.35 TB/s); a few operations per element.
//
// Design: one block per row. The row is read once, 16 bytes a thread,
// into shared memory while the extrema are taken; a block reduction gives
// the scale, and the codes are written from shared memory. The division
// is IEEE ('/', not a reciprocal multiply) and the clip products are
// __fmul_rn, so codes and scales equal the plain version's bit for bit.
//
// ---------------------------------------------------------------------
// w4a4_matmul_i8_fusedq: per-token symmetric int4 quant of bf16 or f32
// activations (LAC clips, q_max 7) fused into w4a4_matmul_i8. Two device
// bodies behind one wrapper; int4_matmul.py `fusedq_body` picks one from
// (M, N, K), from chip_smoke.py phase 3a's sweep.
//
// Replaces: flatquant_tpu/kernels/int4_matmul.py:w4a4_matmul_i8_fusedq
// (Pallas; a measured baseline there, not on JAX's serving path).
//
//   y = w4a4_matmul_i8(quant_acts_i8(x, clip, 7), wp, sw), bit for bit:
// the quant arithmetic is quant_acts_i8_kernel's (IEEE division, rintf,
// __fmul_rn clips) and the GEMM is one of w4a4_matmul_i8's bodies with its
// epilogue, so codes, int32 sums and the epilogue's roundings are the
// composed route's.
//
// What bounds it on the H100: as w4a4_matmul_i8 -- at decode the weight
// stream (N * K/2 bytes; one llama-2-7b layer's four linears: 101 MB,
// 30 us), at prefill the int8 operations (2 M N K).
//
// The Pallas kernel quantizes each m-block once, at the first n step, into
// scratch that the later (sequential) grid steps read. CUDA blocks run in
// parallel, so the two bodies keep the codes elsewhere:
// - stream body (fq_w4a4_matmul_i8_fusedq_stream, decode):
//   every block quantizes its own MT rows into shared memory (MT * K bytes
//   of codes: 88 KB at K = 11008): one pass over its rows for their
//   extrema, a second that writes the codes. It then walks groups of
//   FQ_WARPS * ROWS weight rows with stride gridDim.x through row 1's dp4a
//   warp body. An m-tile's rows are quantized gridDim.x times; the launch
//   sizes gridDim.x so that about FQ_TARGET_BLOCKS blocks run (at M = 4
//   every group is a block, 384 for llama-2-7b's merged qkv).
// - tile body (fq_w4a4_matmul_i8_fusedq_tile): a 128-row tile of codes
//   does not fit shared memory at K = 4096 (512 KB), so L2 takes the place
//   of JAX's VMEM scratch. The wrapper allocates an int8 [M, K] and
//   float32 [M] workspace and 2 zeroed flags per 128-row M tile. The
//   first blocks of an M tile claim its rows from the tile's ticket (an
//   atomic counter) until none is left and quantize each into the
//   workspace (a block on a row with row 12's row body, the least latency
//   a row), counting them done after a device-scope fence; then every
//   block of the tile waits (ld.acquire) for the count, stages the tile's
//   128 scales in shared memory and runs row 1's tile body on the
//   workspace. The grid walks the M tiles of one weight tile together
//   (row 1's order), so the first blocks of each M tile share its rows
//   and the rest find them done: each row is quantized once per launch.
//   Against the composed route (rows 12 + 1) it saves a launch, but the
//   quantization overlaps no GEMM work of its tile (PERF.md gives the
//   times).
//
// ---------------------------------------------------------------------
// w4a8_matmul: bf16 activations x planar int4 weights, float32 sums.
//
// Replaces: flatquant_tpu/kernels/int4_matmul.py:w4a8_matmul (Pallas, the
// weight-only W4A16 linear; the engine passes unit activation scales).
//
//   y[m, n] = (acc[m, n] - 8 * rowsum[m]) * sx[m] * sw[n]
//   acc     = sum_k x[m, k] * nib[n, k]  (float32),  rowsum = sum_k x[m, k]
//
// What bounds it on the H100: at decode (M = 1..4) the weight stream,
// N * K/2 bytes (101 MB per llama-2-7b layer, 30 us); at prefill (M =
// 2048) the bf16 operations, 2*M*N*K (829 GFLOP per llama-2-7b layer,
// 0.84 ms at 989 TFLOP/s).
//
// Design: bodies behind one wrapper; int4_matmul.py w4a8_body picks one
// from M. Stream (fq_w4a8_matmul_stream, M <= 8): a weight stream like
// w4a4_matmul_i8's (four weight rows per warp, a lane per 16-byte chunk),
// with the nibbles and the bf16 activations widened to float32 and summed
// with FMAs. Tile (fq_w4a8_matmul_tile, M > 8): row 16's shape (csrc/
// fp8_matmul.cu) with nibbles for codes: 128 weight rows (two warpgroups,
// wgmma's A, m64n128k16 bf16 with float32 sums) x 128 activation rows
// (wgmma's N, B from shared memory) per block, on a TMA + mbarrier ring
// of W8T_STAGES stages of 64 packed bytes a weight row (128 k); each
// thread decodes its fragments' nibbles to bf16 in registers (two packed
// bytes -> two bf16 pairs, one per plane: a byte permute, a mask, an OR
// into the mantissa of 128.0 and a bf16x2 FMA that subtracts 128, exact),
// so every weight byte of a stage is decoded once per block. The algebra
// stays JAX's (0..15 nibbles, -8 * rowsum(x) in the epilogue): the float32
// row sums of x come from the same wgmmas, whose last A row of a block is
// all ones (so a block computes 127 weight rows).
// The tensor cores' own float32 sums truncate, so the partial sums start
// from zero every W8T_PROMOTE stages and are added to the running sums
// with an IEEE add. The sums run in another order than the plain
// version's, so outputs agree to float32 rounding (bf16 outputs to one
// ulp), bit for bit on integer-valued x.

#include <cuda_bf16.h>

#include <algorithm>

#include "common.cuh"
#include "mma.cuh"
#include "tma.cuh"
#include "w4a4_tile.cuh"

namespace {

typedef __nv_bfloat16 bf16;

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

// One warp's share of w4a4_matmul_i8: ROWS weight rows from n0 against
// the mt <= MT activation rows whose codes start at x (row stride K) and
// whose scales start at sx. Each lane streams 16-byte chunks of the packed
// rows; the int32 sums are exact and the epilogue multiplies in the plain
// version's order. X_SMEM: x lies in shared memory (plain loads), else in
// global memory (read-only path). GROUPED (w4a4_matmul_i8_grouped): the
// codes are the grouped layout [K / 128, M, 128], x points at row m0 of
// group 0 and gstride is M * 128; a 16-byte chunk (16 columns from a
// multiple of 16, K / 2 % 16 == 0) lies inside one group, so only its
// address changes.
template <typename OutT, bool X_SMEM, bool GROUPED = false>
__device__ __forceinline__ void w4a4_warp_rows(
    const int8_t* __restrict__ x, const float* __restrict__ sx,
    const uint8_t* __restrict__ wp, const float* __restrict__ sw,
    OutT* __restrict__ y, int m0, int mt, int n0, int N, int K, int lane,
    size_t gstride = 0) {
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
        uint4 xl, xh;
        if constexpr (GROUPED) {
          const int lo = c * 16, hi = half + c * 16;
          const int8_t* xr = x + static_cast<size_t>(m) * 128;
          xl = ldg16(xr + (lo >> 7) * gstride + (lo & 127));
          xh = ldg16(xr + (hi >> 7) * gstride + (hi & 127));
        } else {
          const int8_t* xr = x + static_cast<size_t>(m) * K + c * 16;
          xl = X_SMEM ? *reinterpret_cast<const uint4*>(xr) : ldg16(xr);
          xh = X_SMEM ? *reinterpret_cast<const uint4*>(xr + half)
                      : ldg16(xr + half);
        }
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
        v = v * sx[m];
        v = v * sw[n0 + r];
        y[static_cast<size_t>(m0 + m) * N + n0 + r] = to_out<OutT>(v);
      }
    }
  }
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
  w4a4_warp_rows<OutT, false>(xq + static_cast<size_t>(m0) * K, sx + m0, wp,
                              sw, y, m0, min(MT, M - m0), n0, N, K, lane);
}

// w4a4_matmul_i8_kernel on the grouped codes [K / 128, M, 128]
template <typename OutT>
__global__ void __launch_bounds__(WARPS * 32)
w4a4_matmul_i8_grouped_kernel(const int8_t* __restrict__ xq,
                              const uint8_t* __restrict__ wp,
                              const float* __restrict__ sx,
                              const float* __restrict__ sw,
                              OutT* __restrict__ y, int M, int N, int K) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n0 = (blockIdx.x * WARPS + warp) * ROWS;
  const int m0 = blockIdx.y * MT;
  if (n0 >= N) return;  // no block-level barrier follows
  w4a4_warp_rows<OutT, false, true>(
      xq + static_cast<size_t>(m0) * 128, sx + m0, wp, sw, y, m0,
      min(MT, M - m0), n0, N, K, lane, static_cast<size_t>(M) * 128);
}

// ---------------------------------------------------------------------------
// w4a4_matmul_i8, tile body: wgmma with the weights as A from registers
// and the activations as B from 128-byte-swizzled shared tiles
// ---------------------------------------------------------------------------

// The tile body; each __global__ below carries its wrapper's name (the
// profiles group kernels by it). GROUPED (w4a4_matmul_i8_grouped): the
// codes are [K / 128, M, 128]; a 16-byte chunk starts at a multiple of 16
// and lies inside one group, so only its address changes. SX_TILE
// (w4a4_matmul_i8_fusedq): sx holds the block's own 128 row scales (sx[m -
// m0], staged in shared memory), not all M.
template <typename OutT, bool GROUPED, bool SX_TILE = false>
__device__ __forceinline__ void w4a4_tile(const int8_t* __restrict__ xq,
                                          const uint8_t* __restrict__ wp,
                                          const float* __restrict__ sx,
                                          const float* __restrict__ sw,
                                          OutT* __restrict__ y, int M, int N,
                                          int K) {
  extern __shared__ __align__(16) uint8_t tl_raw[];
  uint8_t* x_s = tl_raw + ((1024 - (smem_u32(tl_raw) & 1023)) & 1023);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wg = warp >> 2, wi = warp & 3;
  const int m0 = blockIdx.x * TL_BM;  // activation rows, fastest: one
  const int n0 = blockIdx.y * TL_BN;  // weight tile's blocks run together
  int acc[1][64];
  w4a4_mainloop<1, GROUPED>(x_s, xq, wp, M, N, K, m0, n0, acc);

  // acc[4i + e]: weight row 16 wi + g8 (+ 8 for e >= 2) of the
  // warpgroup's 64, activation row 8i + 2 tq + (e & 1); acc / 16 exactly,
  // then x the row scale, then x the column scale (the plain version's
  // order)
  const int g8 = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = n0 + wg * 64 + wi * 16 + g8 + (e >> 1) * 8;
      const int m = m0 + i * 8 + tq * 2 + (e & 1);
      if (m < M && n < N) {
        const float v = static_cast<float>(acc[0][4 * i + e] >> 4) *
                        sx[SX_TILE ? m - m0 : m];
        y[static_cast<size_t>(m) * N + n] = to_out<OutT>(v * sw[n]);
      }
    }
  }
}

template <typename OutT>
__global__ void __launch_bounds__(TL_THREADS)
w4a4_matmul_i8_tile_kernel(const int8_t* __restrict__ xq,
                           const uint8_t* __restrict__ wp,
                           const float* __restrict__ sx,
                           const float* __restrict__ sw, OutT* __restrict__ y,
                           int M, int N, int K) {
  w4a4_tile<OutT, false>(xq, wp, sx, sw, y, M, N, K);
}

template <typename OutT>
__global__ void __launch_bounds__(TL_THREADS)
w4a4_matmul_i8_grouped_tile_kernel(const int8_t* __restrict__ xq,
                                   const uint8_t* __restrict__ wp,
                                   const float* __restrict__ sx,
                                   const float* __restrict__ sw,
                                   OutT* __restrict__ y, int M, int N,
                                   int K) {
  w4a4_tile<OutT, true>(xq, wp, sx, sw, y, M, N, K);
}

// ---------------------------------------------------------------------------
// quant_acts_i8
// ---------------------------------------------------------------------------

constexpr int QA_THREADS = 256;

// the 16 / sizeof(T) values of one 16-byte vector, widened to float32
template <typename T>
__device__ __forceinline__ void widen16(uint4 v, float* f);
template <>
__device__ __forceinline__ void widen16<bf16>(uint4 v, float* f) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}
template <>
__device__ __forceinline__ void widen16<float>(uint4 v, float* f) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}

// GROUPED (quant_acts_i8_grouped): x and xq are [K / 128, M, 128] instead
// of [M, K]; a 16-byte vector lies inside one group (K % 128 == 0), so
// only the addresses of the row's vectors change. The block quantizes row
// `row` (its own blockIdx.x in rows 12 and 24; a claimed row in row 17).
template <typename T, bool GROUPED>
__device__ __forceinline__ void quant_acts_i8_row(
    const T* __restrict__ x, const float* __restrict__ clip,
    int8_t* __restrict__ xq, float* __restrict__ xs, int M, int K,
    float q_max, size_t row) {
  constexpr int E = 16 / sizeof(T);  // values per 16-byte vector
  extern __shared__ uint4 qa_row[];  // the row, as read
  __shared__ float red[2][QA_THREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nvec = K / E;
  // offset of the row's element at column col (a multiple of E)
  auto at = [&](int col) -> size_t {
    if constexpr (GROUPED)
      return ((col >> 7) * static_cast<size_t>(M) + row) * 128 + (col & 127);
    else return row * K + col;
  };

  float mx = 0.f, mn = 0.f;  // max(., 0) and min(., 0) folded in
  for (int i = tid; i < nvec; i += QA_THREADS) {
    const uint4 v = ldg16(x + at(i * E));
    qa_row[i] = v;
    float f[E];
    widen16<T>(v, f);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      mx = fmaxf(mx, f[e]);
      mn = fminf(mn, f[e]);
    }
  }
  mx = warp_max(mx);
  mn = -warp_max(-mn);
  if (lane == 0) {
    red[0][warp] = mx;
    red[1][warp] = mn;
  }
  __syncthreads();
  mx = red[0][0];
  mn = red[1][0];
#pragma unroll
  for (int w = 1; w < QA_THREADS / 32; ++w) {
    mx = fmaxf(mx, red[0][w]);
    mn = fminf(mn, red[1][w]);
  }
  const float xmax = __fmul_rn(mx, clip[0]);
  const float xmin = __fmul_rn(mn, clip[1]);
  const float absmax = fmaxf(fabsf(xmin), xmax);
  const float s = absmax == 0.f ? 1.f : absmax / q_max;
  if (tid == 0) xs[row] = s;

  for (int i = tid; i < nvec; i += QA_THREADS) {
    float f[E];
    widen16<T>(qa_row[i], f);
    unsigned p[E / 4];
#pragma unroll
    for (int j = 0; j < E / 4; ++j) p[j] = 0u;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float q = fminf(fmaxf(rintf(f[e] / s), -q_max - 1.f), q_max);
      p[e / 4] |= (static_cast<unsigned>(static_cast<int>(q)) & 0xFFu)
                  << (8 * (e % 4));
    }
    if constexpr (E == 8) {
      *reinterpret_cast<uint2*>(xq + at(i * 8)) = make_uint2(p[0], p[1]);
    } else {
      *reinterpret_cast<unsigned*>(xq + at(i * 4)) = p[0];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(QA_THREADS)
quant_acts_i8_kernel(const T* __restrict__ x, const float* __restrict__ clip,
                     int8_t* __restrict__ xq, float* __restrict__ xs, int M,
                     int K, float q_max) {
  quant_acts_i8_row<T, false>(x, clip, xq, xs, M, K, q_max, blockIdx.x);
}

template <typename T>
__global__ void __launch_bounds__(QA_THREADS)
quant_acts_i8_grouped_kernel(const T* __restrict__ x,
                             const float* __restrict__ clip,
                             int8_t* __restrict__ xq, float* __restrict__ xs,
                             int M, int K, float q_max) {
  quant_acts_i8_row<T, true>(x, clip, xq, xs, M, K, q_max, blockIdx.x);
}

// ---------------------------------------------------------------------------
// w4a4_matmul_i8_fusedq: quant_acts_i8 (q_max 7) in the prologue of
// w4a4_matmul_i8
// ---------------------------------------------------------------------------

constexpr int FQ_WARPS = 8;  // warps per block: 8 * ROWS weight rows a group
// blocks to aim for: 4 on each of the H100's 132 SMs
constexpr int FQ_TARGET_BLOCKS = 4 * 132;

// Block (gridDim.x blocks per m-tile): quantize the m-tile's mt <= MT rows
// of x into shared memory (pass 1: each warp takes a row's extrema and
// scale; pass 2: 16 codes per thread step), then walk the groups of
// FQ_WARPS * ROWS weight rows g = blockIdx.x, + gridDim.x, ... with
// w4a4_matmul_i8's warp body reading the codes from shared memory.
template <typename T, typename OutT>
__global__ void __launch_bounds__(FQ_WARPS * 32)
w4a4_matmul_i8_fusedq_kernel(const T* __restrict__ x,
                             const float* __restrict__ clip,
                             const uint8_t* __restrict__ wp,
                             const float* __restrict__ sw,
                             OutT* __restrict__ y, int M, int N, int K) {
  constexpr int E = 16 / sizeof(T);  // values per 16-byte vector
  extern __shared__ uint4 fq_codes[];  // [MT][K / 16] 16-code chunks
  __shared__ float fq_scale[MT];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * MT;
  const int mt = min(MT, M - m0);
  const int nvec = K / E;

  // pass 1: quant_acts_i8_kernel's scale rule
  for (int m = warp; m < mt; m += FQ_WARPS) {
    const uint4* xr =
        reinterpret_cast<const uint4*>(x + static_cast<size_t>(m0 + m) * K);
    float mx = 0.f, mn = 0.f;  // max(., 0) and min(., 0) folded in
    for (int i = lane; i < nvec; i += 32) {
      float f[E];
      widen16<T>(ldg16(xr + i), f);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        mx = fmaxf(mx, f[e]);
        mn = fminf(mn, f[e]);
      }
    }
    mx = warp_max(mx);
    mn = -warp_max(-mn);
    if (lane == 0) {
      const float xmax = __fmul_rn(mx, clip[0]);
      const float xmin = __fmul_rn(mn, clip[1]);
      const float absmax = fmaxf(fabsf(xmin), xmax);
      fq_scale[m] = absmax == 0.f ? 1.f : absmax / 7.f;
    }
  }
  __syncthreads();

  // pass 2: codes, IEEE division and round half to even
  const int nc = K / 16;
  for (int i = tid; i < mt * nc; i += FQ_WARPS * 32) {
    const int m = i / nc, c = i - m * nc;
    const float s = fq_scale[m];
    const uint4* xr = reinterpret_cast<const uint4*>(
        x + static_cast<size_t>(m0 + m) * K + c * 16);
    unsigned p[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int v = 0; v < 16 / E; ++v) {
      float f[E];
      widen16<T>(ldg16(xr + v), f);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int j = v * E + e;
        const float q = fminf(fmaxf(rintf(f[e] / s), -8.f), 7.f);
        p[j / 4] |= (static_cast<unsigned>(static_cast<int>(q)) & 0xFFu)
                    << (8 * (j % 4));
      }
    }
    fq_codes[i] = make_uint4(p[0], p[1], p[2], p[3]);
  }
  __syncthreads();

  const int8_t* codes = reinterpret_cast<const int8_t*>(fq_codes);
  const int per_group = FQ_WARPS * ROWS;
  const int groups = (N + per_group - 1) / per_group;
  for (int g = blockIdx.x; g < groups; g += gridDim.x) {
    const int n0 = g * per_group + warp * ROWS;
    if (n0 < N)  // no barrier follows
      w4a4_warp_rows<OutT, true>(codes, fq_scale, wp, sw, y, m0, mt, n0, N,
                                 K, lane);
  }
}

// ---------------------------------------------------------------------------
// w4a4_matmul_i8_fusedq, tile body: each 128-row M tile quantized once per
// launch into a workspace, then w4a4_tile on the workspace
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned ld_acquire_gpu(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Block (M tile blockIdx.x, weight tile blockIdx.y): claim rows of the M
// tile from its ticket (flags[2 mt]) until none is left, quantize each
// claimed row into xq / xs with quant_acts_i8's row body (the whole block
// on one row: the least latency a row) and count it done (flags[2 mt +
// 1], after a device-scope fence); then wait (acquire) until every row of
// the tile is done, stage the tile's 128 row scales in shared memory and
// run w4a4_tile on the codes. A claimant waits only once every row is
// claimed, and each claimed row belongs to a block that is already
// running and does not wait before finishing it: no launch order can
// deadlock. The flags are zeroed by the wrapper for every launch.
template <typename T, typename OutT>
__global__ void __launch_bounds__(TL_THREADS)
w4a4_matmul_i8_fusedq_tile_kernel(const T* __restrict__ x,
                                  const float* __restrict__ clip,
                                  const uint8_t* __restrict__ wp,
                                  const float* __restrict__ sw,
                                  OutT* __restrict__ y, int8_t* xq, float* xs,
                                  unsigned* flags, int M, int N, int K) {
  static_assert(TL_THREADS == QA_THREADS, "quant_acts_i8_row's block");
  __shared__ unsigned claimed;
  __shared__ float sx_tile[TL_BM];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * TL_BM;
  const unsigned rows = min(TL_BM, M - m0);
  unsigned* ticket = flags + 2 * blockIdx.x;
  unsigned* done = ticket + 1;
  for (;;) {
    if (tid == 0) claimed = atomicAdd(ticket, 1u);
    __syncthreads();
    const unsigned r = claimed;
    __syncthreads();  // claimed is rewritten on the next turn
    if (r >= rows) break;
    quant_acts_i8_row<T, false>(x, clip, xq, xs, M, K, 7.f, m0 + r);
    __threadfence();  // this thread's codes (and scale), device-wide
    __syncthreads();  // ... for every thread; the shared row is free
    if (tid == 0) atomicAdd(done, 1u);
  }
  if (tid == 0)
    while (ld_acquire_gpu(done) < rows) __nanosleep(64);
  __syncthreads();
  if (tid < static_cast<int>(rows)) sx_tile[tid] = __ldcg(xs + m0 + tid);
  __syncthreads();
  w4a4_tile<OutT, false, true>(xq, wp, sx_tile, sw, y, M, N, K);
}

// ---------------------------------------------------------------------------
// w4a8_matmul, decode: the weight stream (M <= W8_MT * gridDim.y)
// ---------------------------------------------------------------------------

constexpr int W8_WARPS = 4;  // warps per block
constexpr int W8_ROWS = 4;   // weight rows per warp
constexpr int W8_MT = 4;     // activation rows per block
constexpr int W8_MAX_M = 8;  // the stream kernel serves M up to this

__device__ __forceinline__ void bf16x2_widen(unsigned w, float& a, float& b) {
  a = __uint_as_float(w << 16);
  b = __uint_as_float(w & 0xFFFF0000u);
}

template <typename OutT>
__global__ void __launch_bounds__(W8_WARPS * 32)
w4a8_matmul_stream_kernel(const bf16* __restrict__ x,
                          const uint8_t* __restrict__ wp,
                          const float* __restrict__ sx,
                          const float* __restrict__ sw, OutT* __restrict__ y,
                          int M, int N, int K) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n0 = (blockIdx.x * W8_WARPS + warp) * W8_ROWS;
  const int m0 = blockIdx.y * W8_MT;
  if (n0 >= N) return;  // no block-level barrier follows
  const int mt = min(W8_MT, M - m0);
  const int half = K / 2;
  const int chunks = half / 16;  // 16-byte chunks per packed row

  float acc[W8_MT][W8_ROWS];
  float rsum[W8_MT];
#pragma unroll
  for (int m = 0; m < W8_MT; ++m) {
    rsum[m] = 0.f;
#pragma unroll
    for (int r = 0; r < W8_ROWS; ++r) acc[m][r] = 0.f;
  }

  for (int c = lane; c < chunks; c += 32) {
    unsigned w[W8_ROWS][4];
#pragma unroll
    for (int r = 0; r < W8_ROWS; ++r) {
      const uint4 v =
          (n0 + r < N) ? ldg16(wp + static_cast<size_t>(n0 + r) * half + c * 16)
                       : make_uint4(0u, 0u, 0u, 0u);
      w[r][0] = v.x;
      w[r][1] = v.y;
      w[r][2] = v.z;
      w[r][3] = v.w;
    }
#pragma unroll
    for (int wi = 0; wi < 4; ++wi) {  // packed bytes 4wi..4wi+3 of the chunk
      float nl[W8_ROWS][4], nh[W8_ROWS][4];
#pragma unroll
      for (int r = 0; r < W8_ROWS; ++r) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          nl[r][b] = static_cast<float>((w[r][wi] >> (8 * b)) & 0xFu);
          nh[r][b] = static_cast<float>((w[r][wi] >> (8 * b + 4)) & 0xFu);
        }
      }
#pragma unroll
      for (int m = 0; m < W8_MT; ++m) {
        if (m < mt) {
          // activations k = c*16 + 4wi .. +3 (low plane) and the same
          // offsets past half (high plane): 8 bytes each
          const bf16* xr =
              x + static_cast<size_t>(m0 + m) * K + c * 16 + 4 * wi;
          const uint2 lo = __ldg(reinterpret_cast<const uint2*>(xr));
          const uint2 hi = __ldg(reinterpret_cast<const uint2*>(xr + half));
          float xl[4], xh[4];
          bf16x2_widen(lo.x, xl[0], xl[1]);
          bf16x2_widen(lo.y, xl[2], xl[3]);
          bf16x2_widen(hi.x, xh[0], xh[1]);
          bf16x2_widen(hi.y, xh[2], xh[3]);
#pragma unroll
          for (int b = 0; b < 4; ++b) rsum[m] += xl[b] + xh[b];
#pragma unroll
          for (int r = 0; r < W8_ROWS; ++r) {
            float a = acc[m][r];
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              a = fmaf(xl[b], nl[r][b], a);
              a = fmaf(xh[b], nh[r][b], a);
            }
            acc[m][r] = a;
          }
        }
      }
    }
  }

#pragma unroll
  for (int m = 0; m < W8_MT; ++m) {
    rsum[m] = warp_sum(rsum[m]);
#pragma unroll
    for (int r = 0; r < W8_ROWS; ++r) acc[m][r] = warp_sum(acc[m][r]);
  }
#pragma unroll
  for (int m = 0; m < W8_MT; ++m) {
#pragma unroll
    for (int r = 0; r < W8_ROWS; ++r) {
      if (lane == ((m * W8_ROWS + r) & 31) && m < mt && n0 + r < N) {
        float v = __fsub_rn(acc[m][r], __fmul_rn(8.f, rsum[m]));
        v = __fmul_rn(v, sx[m0 + m]);
        v = __fmul_rn(v, sw[n0 + r]);
        y[static_cast<size_t>(m0 + m) * N + n0 + r] = to_out<OutT>(v);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// w4a8_matmul, prefill: a wgmma bf16 tile on a TMA + mbarrier ring
// ---------------------------------------------------------------------------

constexpr int W8T_R = 128;       // A rows per block: 2 warpgroups x 64
constexpr int W8T_ROWS_OUT = W8T_R - 1;  // weight rows; the last is ones
constexpr int W8T_BT = 128;      // activation rows per block: wgmma's N
constexpr int W8T_KP = 64;       // packed bytes per weight row per stage
// ring depth, and stages summed on the tensor cores before a promotion:
// the fastest of 3-5 stages and of 2-8 (chip_smoke.py's phase 3g shapes,
// PERF.md)
constexpr int W8T_STAGES = 4;
constexpr int W8T_PROMOTE = 8;
constexpr int W8T_THREADS = 256;
constexpr int W8T_X_STAGE = 2 * W8T_BT * 128;  // low | high slice [BT][128 B]
constexpr int W8T_W_STAGE = W8T_R * W8T_KP;    // [R][64 B], 64-byte swizzle
// + 1024: the swizzled tiles start at a multiple of 1024 bytes; then a
// full and an empty mbarrier per stage and the row sums of x
constexpr int W8T_SMEM = W8T_STAGES * (W8T_X_STAGE + W8T_W_STAGE) + 1024 +
                         W8T_STAGES * 16 + W8T_BT * 4;

// Two packed bytes (bytes 0 and 1 of v: k and k + 1) -> the bf16 pair of
// their nibbles of one plane (HI: the high nibbles), the lower k in the
// low half: each nibble ORed into the mantissa of bf16 128.0 (0x4300, a
// unit step there) and 128 subtracted with one bf16x2 FMA: exact for all
// 16 values (tested on all 256 bytes in tests/test_torch_w4a8_tile.py)
template <bool HI>
__device__ __forceinline__ unsigned nib2_bf16(unsigned v) {
  unsigned t = __byte_perm(v, 0u, 0x4140);  // byte 0 | byte 1 << 16
  if (HI) t >>= 4;
  t = (t & 0x000F000Fu) | 0x43004300u;
  unsigned r;  // t * 1 + (-128)
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(r)
      : "r"(t), "r"(0x3F803F80u), "r"(0xC300C300u));
  return r;
}

// the A fragments of a stage's 8 k-steps, a[s] for the low plane's
// k-step s and a[4 + s] for the high plane's: rows row and row + 8 at
// packed bytes 16s + 2tq (+1) and 16s + 8 + 2tq (+1), one load for both
// planes; wr points at byte 2tq of row `row`; 16-byte chunk s of a
// 64-byte row r lies at s ^ ((r >> 1) & 3) (the 64-byte swizzle; rows row
// and row + 8 share it)
__device__ __forceinline__ void w8t_decode(const uint8_t* wr, int wsw,
                                           unsigned (&a)[8][4]) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const uint8_t* p = wr + ((s ^ wsw) << 4);
    const unsigned v[4] = {
        *reinterpret_cast<const unsigned short*>(p),
        *reinterpret_cast<const unsigned short*>(p + 8 * W8T_KP),
        *reinterpret_cast<const unsigned short*>(p + 8),
        *reinterpret_cast<const unsigned short*>(p + 8 * W8T_KP + 8)};
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      a[s][f] = nib2_bf16<false>(v[f]);
      a[4 + s][f] = nib2_bf16<true>(v[f]);
    }
  }
}

// The body: W8T_R A rows (W8T_ROWS_OUT weight rows and a row of ones) x
// W8T_BT activation rows per block (blockIdx.x the activation tiles,
// fastest: one weight tile's blocks run together and the packed weight
// comes from HBM about once). xmap: x as [1, M, K] bf16, boxes of 64 k x
// BT rows, 128-byte swizzle; wmap: the packed weight [1, N, K/2], boxes of
// 64 bytes x R rows (the last one's bytes unused), 64-byte swizzle.
// Stage c holds packed bytes [64c, 64c + 64) of the block's weight rows
// and the x columns they meet: [64c, +64) (low plane) and K/2 + [64c, +64)
// (high plane). The weights are wgmma's A (m64n128k16 bf16, float32 sums),
// decoded in registers from the nibbles; the activations its B. A
// stage's 8 k-steps are one wgmma group, which runs while the next stage
// is decoded into a second A register set; a warp gives a slot back (its
// empty barrier) one group later, once the group that read it is done.
template <typename OutT>
__global__ void __launch_bounds__(W8T_THREADS)
w4a8_matmul_tile_kernel(const __grid_constant__ CUtensorMap xmap,
                        const __grid_constant__ CUtensorMap wmap,
                        const float* __restrict__ sx,
                        const float* __restrict__ sw, OutT* __restrict__ y,
                        int M, int N, int K) {
  extern __shared__ __align__(16) uint8_t w8t_raw[];
  uint8_t* x_s = w8t_raw + ((1024 - (smem_u32(w8t_raw) & 1023)) & 1023);
  uint8_t* w_s = x_s + W8T_STAGES * W8T_X_STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(w_s + W8T_STAGES * W8T_W_STAGE);
  uint64_t* empty = full + W8T_STAGES;
  float* rs = reinterpret_cast<float*>(empty + W8T_STAGES);  // [BT]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, tq = lane & 3;
  // the block's last A row is all ones, so its accumulator row is the row
  // sums of x, summed and promoted as the products are: the block computes
  // W8T_ROWS_OUT = W8T_R - 1 weight rows
  const int m0 = blockIdx.x * W8T_BT;
  const int n0 = blockIdx.y * W8T_ROWS_OUT;
  const int half = K / 2;
  const int nc = (half + W8T_KP - 1) / W8T_KP;
  // this thread's two accumulator rows (weight rows) in the block
  const int row = warp * 16 + g8;
  const int na = n0 + row, nb = na + 8;
  const int wsw = (row >> 1) & 3;
  const uint8_t* w_row = w_s + row * W8T_KP + 2 * tq;
  const bool ones = row + 8 == W8T_R - 1;

  if (tid == 0) {
    for (int st = 0; st < W8T_STAGES; ++st) {
      mbar_init(full + st, 1);
      mbar_init(empty + st, W8T_THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // stage c into its slot (thread 0): x's low and high slice, the codes;
  // past M, N, K/2 (the weight) or K (x) TMA writes zeros
  auto load_stage = [&](int c) {
    const int slot = c % W8T_STAGES;
    uint8_t* xs = x_s + slot * W8T_X_STAGE;
    mbar_expect_tx(full + slot, W8T_X_STAGE + W8T_W_STAGE);
    tma_load(xs, &xmap, c * W8T_KP, m0, 0, full + slot);
    tma_load(xs + W8T_BT * 128, &xmap, half + c * W8T_KP, m0, 0, full + slot);
    tma_load(w_s + slot * W8T_W_STAGE, &wmap, c * W8T_KP, n0, 0, full + slot);
  };

  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;
  // two A register sets, a stage's 8 k-steps each: stage c's group reads
  // set c % 2 while stage c + 1 is decoded into the other
  unsigned a[2][8][4];

  // the 8 k-steps of the stage in `slot` (A set a_) as one group: the low
  // slice's 4, then the high slice's; the first k-step of a promotion
  // group starts the partial sums from zero
  auto mma_stage = [&](int slot, unsigned (&a_)[8][4], bool first) {
    const uint8_t* xs = x_s + slot * W8T_X_STAGE;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 8; ++s)
      Wgmma<128>::mma(part, a_[s],
                      sw128_desc(xs + (s >> 2) * W8T_BT * 128 + (s & 3) * 32),
                      !(first && s == 0));
    wgmma_commit();
  };

  // a warp is done with the slot of stage c: its reads before the refill
  auto give_back = [&](int c) {
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + c % W8T_STAGES);
  };

  // stage c's A fragments into a_; the ones row skips the low slice's
  // columns past K/2 in a last stage of 32 packed bytes (they hold
  // high-plane columns there)
  auto decode = [&](int c, unsigned (&a_)[8][4]) {
    w8t_decode(w_row + (c % W8T_STAGES) * W8T_W_STAGE, wsw, a_);
    if (ones) {
      const int lim = min(W8T_KP, half - c * W8T_KP);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const unsigned lo = 16 * s < lim ? 0x3F803F80u : 0u;
        a_[s][1] = a_[s][3] = lo;
        a_[4 + s][1] = a_[4 + s][3] = 0x3F803F80u;
      }
    }
  };

  // stage c (its A in set `set`, decoded beforehand): issue its group;
  // once stage c - 1's group is done, give that slot back and refill it
  // with stage c + STAGES - 1 (thread 0); the row sums while the group
  // runs; then decode stage c + 1 into the other set. first: stage c
  // starts a promotion group
  auto stage = [&](int c, int set, bool first) {
    const int slot = c % W8T_STAGES;
    mma_stage(slot, a[set], first);
    if (c > 0) {
      wgmma_wait<1>();  // stage c - 1's group is done: its set is free
      fence_u32<32>(&a[set ^ 1][0][0]);
      give_back(c - 1);
    }
    if (tid == 0 && c + W8T_STAGES - 1 < nc) {
      if (c > 0)
        mbar_wait(empty + (c - 1) % W8T_STAGES, ((c - 1) / W8T_STAGES) & 1);
      load_stage(c + W8T_STAGES - 1);
    }
    if (c + 1 < nc) {
      const int next = (c + 1) % W8T_STAGES;
      mbar_wait(full + next, ((c + 1) / W8T_STAGES) & 1);
      decode(c + 1, a[set ^ 1]);
    }
  };
  // the tensor cores' float32 sums truncate: every W8T_PROMOTE stages
  // (W8T_PROMOTE * 128 k) the partial sums are added to acc with an IEEE
  // add, as row 16's chunks are (chained over all of K the truncation
  // biases acc by ~2e-5 of a row's largest output at K = 11008, beyond the
  // "identity" tolerance)
  auto fold = [&]() {
    wgmma_wait<0>();
    fence_f32<64>(part);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
  };

  if (tid == 0)
    for (int c = 0; c < W8T_STAGES - 1 && c < nc; ++c) load_stage(c);
  mbar_wait(full, 0);
  decode(0, a[0]);
  // a promotion group's stages unrolled (W8T_PROMOTE is even: stage c
  // takes set c % 2 statically), so no group is in flight across the
  // loop's back edge (the compiler would wait there); a last group of
  // fewer stages folds each
  static_assert(W8T_PROMOTE % 2 == 0, "the A sets alternate by stage");
  int c = 0;
  for (; c + W8T_PROMOTE <= nc; c += W8T_PROMOTE) {
#pragma unroll
    for (int j = 0; j < W8T_PROMOTE; ++j) stage(c + j, j & 1, j == 0);
    fold();
  }
#pragma unroll
  for (int j = 0; j < W8T_PROMOTE - 1; ++j) {
    if (c + j < nc) {
      stage(c + j, j & 1, true);
      fold();
    }
  }
  // the A sets stay unmoved until the last wgmmas are done
  fence_u32<64>(&a[0][0][0]);

  if (ones) {  // acc[4i + 2 + e]: the row sum of activation row 8i + 2tq + e
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      rs[i * 8 + 2 * tq] = acc[4 * i + 2];
      rs[i * 8 + 2 * tq + 1] = acc[4 * i + 3];
    }
  }
  __syncthreads();
  // acc[4i + q]: weight row na (q < 2) or nb, activation row 8i + 2tq +
  // (q & 1); the plain version's order: (acc - 8 * rowsum) * sx * sw
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int n = (i & 2) ? nb : na;
    const int t = (i >> 2) * 8 + 2 * tq + (i & 1);
    const int m = m0 + t;
    if (m < M && n < N && n - n0 < W8T_ROWS_OUT) {
      float v = __fsub_rn(acc[i], __fmul_rn(8.f, rs[t]));
      v = __fmul_rn(v, sx[m]);
      v = __fmul_rn(v, sw[n]);
      y[static_cast<size_t>(m) * N + n] = to_out<OutT>(v);
    }
  }
}

// Opt a kernel into `bytes` of dynamic shared memory (above 48 KB), once:
// *done remembers the largest size set so far, so a launch inside a CUDA
// graph capture makes no runtime call after the first launch.
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

template <typename T, typename OutT>
int launch_fusedq_stream(const void* x, const void* clip, const void* wp,
                         const void* sw, void* y, int M, int N, int K,
                         cudaStream_t s) {
  static int done = 0;
  const int bytes = MT * K;
  const cudaError_t err =
      allow_smem(w4a4_matmul_i8_fusedq_kernel<T, OutT>, bytes, &done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int mtiles = (M + MT - 1) / MT;
  const int groups = (N + FQ_WARPS * ROWS - 1) / (FQ_WARPS * ROWS);
  const int gx = std::max(1, std::min(groups, FQ_TARGET_BLOCKS / mtiles));
  w4a4_matmul_i8_fusedq_kernel<T, OutT>
      <<<dim3(gx, mtiles), FQ_WARPS * 32, bytes, s>>>(
          static_cast<const T*>(x), static_cast<const float*>(clip),
          static_cast<const uint8_t*>(wp), static_cast<const float*>(sw),
          static_cast<OutT*>(y), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename OutT>
int launch_fusedq_tile(const void* x, const void* clip, const void* wp,
                       const void* sw, void* y, void* xq, void* xs,
                       void* flags, int M, int N, int K, cudaStream_t s) {
  auto kern = &w4a4_matmul_i8_fusedq_tile_kernel<T, OutT>;
  static int done = 0;
  // the ring, or one row of x while a block quantizes it
  const int bytes = std::max(TL_SMEM, K * static_cast<int>(sizeof(T)));
  const cudaError_t err = allow_smem(kern, bytes, &done);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((M + TL_BM - 1) / TL_BM, (N + TL_BN - 1) / TL_BN);
  kern<<<grid, TL_THREADS, bytes, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(clip),
      static_cast<const uint8_t*>(wp), static_cast<const float*>(sw),
      static_cast<OutT*>(y), static_cast<int8_t*>(xq),
      static_cast<float*>(xs), static_cast<unsigned*>(flags), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

template <bool GROUPED>
int launch_w4a4_stream(const void* xq, const void* wp, const void* sx,
                       const void* sw, void* y, int M, int N, int K,
                       int out_is_f32, cudaStream_t s) {
  const int rows_per_block = WARPS * ROWS;
  dim3 grid((N + rows_per_block - 1) / rows_per_block, (M + MT - 1) / MT);
  dim3 block(WARPS * 32);
  auto x = static_cast<const int8_t*>(xq);
  auto w = static_cast<const uint8_t*>(wp);
  auto a = static_cast<const float*>(sx);
  auto b = static_cast<const float*>(sw);
  if (out_is_f32) {
    auto kern = GROUPED ? &w4a4_matmul_i8_grouped_kernel<float>
                        : &w4a4_matmul_i8_kernel<float>;
    kern<<<grid, block, 0, s>>>(x, w, a, b, static_cast<float*>(y), M, N, K);
  } else {
    auto kern = GROUPED ? &w4a4_matmul_i8_grouped_kernel<bf16>
                        : &w4a4_matmul_i8_kernel<bf16>;
    kern<<<grid, block, 0, s>>>(x, w, a, b, static_cast<bf16*>(y), M, N, K);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename OutT, bool GROUPED>
int launch_w4a4_tile_t(const void* xq, const void* wp, const void* sx,
                       const void* sw, void* y, int M, int N, int K,
                       cudaStream_t s) {
  auto kern = GROUPED ? &w4a4_matmul_i8_grouped_tile_kernel<OutT>
                      : &w4a4_matmul_i8_tile_kernel<OutT>;
  static int done = 0;
  const cudaError_t err = allow_smem(kern, TL_SMEM, &done);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((M + TL_BM - 1) / TL_BM, (N + TL_BN - 1) / TL_BN);
  kern<<<grid, TL_THREADS, TL_SMEM, s>>>(
      static_cast<const int8_t*>(xq), static_cast<const uint8_t*>(wp),
      static_cast<const float*>(sx), static_cast<const float*>(sw),
      static_cast<OutT*>(y), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

template <bool GROUPED>
int launch_w4a4_tile(const void* xq, const void* wp, const void* sx,
                     const void* sw, void* y, int M, int N, int K,
                     int out_is_f32, cudaStream_t s) {
  return out_is_f32
             ? launch_w4a4_tile_t<float, GROUPED>(xq, wp, sx, sw, y, M, N, K,
                                                  s)
             : launch_w4a4_tile_t<bf16, GROUPED>(xq, wp, sx, sw, y, M, N, K,
                                                 s);
}

template <typename OutT>
int launch_w4a8_tile(const void* x, const void* wp, const void* sx,
                     const void* sw, void* y, int M, int N, int K,
                     cudaStream_t s) {
  auto kern = &w4a8_matmul_tile_kernel<OutT>;
  static int done = 0;
  const cudaError_t err = allow_smem(kern, W8T_SMEM, &done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int half = K / 2;
  CUtensorMap xmap, wmap;
  if (!tensor_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, K, M, 1,
                  static_cast<long long>(M) * K, W8T_KP, W8T_BT) ||
      !tensor_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, wp, half, N, 1,
                  static_cast<long long>(N) * half, W8T_KP, W8T_R,
                  CU_TENSOR_MAP_SWIZZLE_64B))
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((M + W8T_BT - 1) / W8T_BT,
            (N + W8T_ROWS_OUT - 1) / W8T_ROWS_OUT);
  kern<<<grid, W8T_THREADS, W8T_SMEM, s>>>(
      xmap, wmap, static_cast<const float*>(sx),
      static_cast<const float*>(sw), static_cast<OutT*>(y), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

template <bool GROUPED, typename T>
int launch_quant_acts(const void* x, const void* clip, void* xq, void* xs,
                      int M, int K, float q_max, cudaStream_t s) {
  auto kern = GROUPED ? &quant_acts_i8_grouped_kernel<T>
                      : &quant_acts_i8_kernel<T>;
  static int done = 0;
  const int bytes = K * static_cast<int>(sizeof(T));
  const cudaError_t err = allow_smem(kern, bytes, &done);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<M, QA_THREADS, bytes, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(clip),
      static_cast<int8_t*>(xq), static_cast<float*>(xs), M, K, q_max);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x_q int8 [M, K]; w_packed uint8 [N, K/2]; sx f32 [M]; sw f32 [N];
// y [M, N] bf16 (out_is_f32 = 0) or f32. K % 32 == 0 and 16-byte aligned
// rows are the caller's contract (checked in Python). _stream: the dp4a
// weight stream; _tile: the tensor-core tiles (K < 2^17).
extern "C" int fq_w4a4_matmul_i8_stream(const void* xq, const void* wp,
                                        const void* sx, const void* sw,
                                        void* y, int M, int N, int K,
                                        int out_is_f32, void* stream) {
  return launch_w4a4_stream<false>(xq, wp, sx, sw, y, M, N, K, out_is_f32,
                                   static_cast<cudaStream_t>(stream));
}

extern "C" int fq_w4a4_matmul_i8_tile(const void* xq, const void* wp,
                                      const void* sx, const void* sw,
                                      void* y, int M, int N, int K,
                                      int out_is_f32, void* stream) {
  return launch_w4a4_tile<false>(xq, wp, sx, sw, y, M, N, K, out_is_f32,
                                 static_cast<cudaStream_t>(stream));
}

// the same two with x_q int8 [K / 128, M, 128]; K % 128 == 0.
extern "C" int fq_w4a4_matmul_i8_grouped_stream(const void* xq,
                                                const void* wp,
                                                const void* sx,
                                                const void* sw, void* y,
                                                int M, int N, int K,
                                                int out_is_f32,
                                                void* stream) {
  return launch_w4a4_stream<true>(xq, wp, sx, sw, y, M, N, K, out_is_f32,
                                  static_cast<cudaStream_t>(stream));
}

extern "C" int fq_w4a4_matmul_i8_grouped_tile(const void* xq, const void* wp,
                                              const void* sx, const void* sw,
                                              void* y, int M, int N, int K,
                                              int out_is_f32, void* stream) {
  return launch_w4a4_tile<true>(xq, wp, sx, sw, y, M, N, K, out_is_f32,
                                static_cast<cudaStream_t>(stream));
}

// x [M, K] bf16 (x_is_f32 = 0) or f32, K % 128 == 0, 16-byte aligned;
// clip f32 [2] (cmax, cmin); xq int8 [M, K]; xs f32 [M].
extern "C" int fq_quant_acts_i8(const void* x, const void* clip, void* xq,
                                void* xs, int M, int K, float q_max,
                                int x_is_f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_is_f32
             ? launch_quant_acts<false, float>(x, clip, xq, xs, M, K, q_max, s)
             : launch_quant_acts<false, bf16>(x, clip, xq, xs, M, K, q_max, s);
}

// fq_quant_acts_i8 with x and xq [K / 128, M, 128].
extern "C" int fq_quant_acts_i8_grouped(const void* x, const void* clip,
                                        void* xq, void* xs, int M, int K,
                                        float q_max, int x_is_f32,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_is_f32
             ? launch_quant_acts<true, float>(x, clip, xq, xs, M, K, q_max, s)
             : launch_quant_acts<true, bf16>(x, clip, xq, xs, M, K, q_max, s);
}

// x [M, K] bf16 (x_is_f32 = 0) or f32; clip f32 [2] (cmax, cmin);
// w_packed uint8 [N, K/2]; sw f32 [N]; y [M, N] bf16 (out_is_f32 = 0) or
// f32. K % 32 == 0 and 16-byte aligned rows are the caller's contract
// (checked in Python). _stream: the dp4a body (a K whose MT * K bytes of
// codes exceed the opt-in shared memory returns cudaFuncSetAttribute's
// error); _tile: the tensor-core tile (K < 2^17) on a workspace of xq int8
// [M, K] and xs f32 [M] and 2 * ceil(M / 128) zeroed flags (uint32).
extern "C" int fq_w4a4_matmul_i8_fusedq_stream(const void* x,
                                               const void* clip,
                                               const void* wp, const void* sw,
                                               void* y, int M, int N, int K,
                                               int x_is_f32, int out_is_f32,
                                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_f32)
    return out_is_f32 ? launch_fusedq_stream<float, float>(x, clip, wp, sw,
                                                           y, M, N, K, s)
                      : launch_fusedq_stream<float, bf16>(x, clip, wp, sw, y,
                                                          M, N, K, s);
  return out_is_f32
             ? launch_fusedq_stream<bf16, float>(x, clip, wp, sw, y, M, N, K,
                                                 s)
             : launch_fusedq_stream<bf16, bf16>(x, clip, wp, sw, y, M, N, K,
                                                s);
}

extern "C" int fq_w4a4_matmul_i8_fusedq_tile(
    const void* x, const void* clip, const void* wp, const void* sw, void* y,
    void* xq, void* xs, void* flags, int M, int N, int K, int x_is_f32,
    int out_is_f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_f32)
    return out_is_f32
               ? launch_fusedq_tile<float, float>(x, clip, wp, sw, y, xq, xs,
                                                  flags, M, N, K, s)
               : launch_fusedq_tile<float, bf16>(x, clip, wp, sw, y, xq, xs,
                                                 flags, M, N, K, s);
  return out_is_f32
             ? launch_fusedq_tile<bf16, float>(x, clip, wp, sw, y, xq, xs,
                                               flags, M, N, K, s)
             : launch_fusedq_tile<bf16, bf16>(x, clip, wp, sw, y, xq, xs,
                                              flags, M, N, K, s);
}

// x bf16 [M, K]; w_packed uint8 [N, K/2]; sx f32 [M]; sw f32 [N]; y [M, N]
// bf16 (out_is_f32 = 0) or f32. K % 64 == 0, K > 0 and 16-byte aligned
// rows are the caller's contract (checked in Python). One entry point per
// body (int4_matmul.py w4a8_body picks one): _stream, the weight stream
// (decode); _tile, the wgmma tile (prefill).
extern "C" int fq_w4a8_matmul_stream(const void* x, const void* wp,
                                     const void* sx, const void* sw, void* y,
                                     int M, int N, int K, int out_is_f32,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto x_ = static_cast<const bf16*>(x);
  auto w = static_cast<const uint8_t*>(wp);
  auto a = static_cast<const float*>(sx);
  auto b = static_cast<const float*>(sw);
  const int rows_per_block = W8_WARPS * W8_ROWS;
  dim3 grid((N + rows_per_block - 1) / rows_per_block,
            (M + W8_MT - 1) / W8_MT);
  if (out_is_f32)
    w4a8_matmul_stream_kernel<float><<<grid, W8_WARPS * 32, 0, s>>>(
        x_, w, a, b, static_cast<float*>(y), M, N, K);
  else
    w4a8_matmul_stream_kernel<bf16><<<grid, W8_WARPS * 32, 0, s>>>(
        x_, w, a, b, static_cast<bf16*>(y), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fq_w4a8_matmul_tile(const void* x, const void* wp,
                                   const void* sx, const void* sw, void* y,
                                   int M, int N, int K, int out_is_f32,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_is_f32
             ? launch_w4a8_tile<float>(x, wp, sx, sw, y, M, N, K, s)
             : launch_w4a8_tile<bf16>(x, wp, sx, sw, y, M, N, K, s);
}

