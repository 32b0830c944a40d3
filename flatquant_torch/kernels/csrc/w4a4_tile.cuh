// The main loop of the W4A4 tensor-core tile, shared by row 1's tile body
// (w4a4_matmul_i8, its grouped twin and the fused-quant tile, in
// int4_matmul.cu) and the swiglu GEMMs (w4a4_matmul_i8_swiglu_right,
// w4a4_matmul_i8_swiglu and the grouped twins, in flat_pipeline.cu).
//
// A block owns TL_BM = 128 activation rows (wgmma's N) and, in each of
// NMAT weight matrices, TL_BN = 128 weight rows: two warpgroups of 64
// (wgmma's M). Row 1 has one matrix; the swiglu GEMMs two, the up rows
// and the gate rows of the same output channels, so each warpgroup
// carries up and gate sums for its 64 channels and the epilogue owns both.
// wgmma.mma_async m64n128k32 s8 x s8 -> s32: the weights are A, from
// registers; the activation codes are B, from shared memory (both
// K-major). A stage holds 64 packed bytes of each of the block's weight
// rows (128 k: 64 of the low nibble plane, 64 of the high) and the
// matching two 64-byte slices of its activation rows, at columns c and
// K/2 + c, as one 128-byte row with the 128-byte swizzle (16-byte chunk j
// of row r at j ^ (r % 8)), so that one matrix descriptor per 32-byte
// k-step addresses it. A ring of TL_STAGES stages is filled by cp.async
// 16-byte copies, so the loads of stage k + 3 are in flight while stage
// k's products run; each stage ends with its wgmmas done. Each warp reads
// its 16 packed weight rows of a matrix with ldmatrix, in the A
// fragments' layout, and unpacks them in registers into 16 * (nib - 8) as
// a signed byte: hi = (w & 0xF0) ^ 0x80, lo = ((w << 4) & 0xF0) ^ 0x80 on
// each byte (3 operations per word, both planes). So the int32 sum is
// 16 * (acc - 8 * rowsum) exactly (|x| <= 128: exact for K < 2^17), needs
// no row sum, and >> 4 gives it. With two matrices the up products run
// while the gate rows are unpacked. Rows past M and N are zero-filled; a
// K/2 that is not a multiple of 64 zero-fills the activation chunks past
// K/2, so the weights' filler meets zeros.
#pragma once

#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int TL_BM = 128;       // activation rows per block: wgmma's N
constexpr int TL_BN = 128;       // weight rows per block and matrix
constexpr int TL_BK = 64;        // packed bytes per weight row per stage
constexpr int TL_STAGES = 4;     // cp.async ring depth
constexpr int TL_THREADS = 256;  // 2 warpgroups
constexpr int TL_X_STAGE = TL_BM * 128;  // rows of lo 64 | hi 64 bytes
constexpr int TL_W_LD = TL_BK + 16;      // padded packed weight row
constexpr int TL_W_STAGE = TL_BN * TL_W_LD;
// shared memory of the ring for NMAT weight matrices; + 1024: the
// swizzled tiles start at a multiple of 1024 bytes
template <int NMAT>
constexpr int tl_smem() {
  return TL_STAGES * (TL_X_STAGE + NMAT * TL_W_STAGE) + 1024;
}
constexpr int TL_SMEM = tl_smem<1>();

// 16 * (nib - 8) as signed bytes from four packed bytes: the high nibbles
// in place, the low ones shifted up; xor 0x80 maps the biased nibble v at
// bits 4-7 to v - 8 in two's complement (tested on all 256 bytes in
// tests/test_torch_w4a4_tile.py)
__device__ __forceinline__ unsigned hi_codes16(unsigned w) {
  return (w & 0xF0F0F0F0u) ^ 0x80808080u;
}
__device__ __forceinline__ unsigned lo_codes16(unsigned w) {
  return ((w << 4) & 0xF0F0F0F0u) ^ 0x80808080u;
}

// keep the accumulators' reads and writes on their side of the wgmmas
__device__ __forceinline__ void fence_regs(int* d) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// The main loop: acc[mat][4i + e] = 16 * sum_k x[m, k] * (nib - 8) of
// weight row n0 + 64 wg + 16 (warp % 4) + lane / 4 (+ 8 for e >= 2) of
// matrix mat (rows mat * N + n, mat < NMAT) and activation row m0 + 8i +
// 2 (lane % 4) + (e & 1). x_s: the ring, 1024-aligned (tl_smem<NMAT>()
// bytes from it). GROUPED: the codes are [K / 128, M, 128]; a 16-byte
// chunk starts at a multiple of 16 and lies inside one group, so only its
// address changes. Ends with every copy landed; the caller synchronizes
// before reusing the ring.
template <int NMAT, bool GROUPED>
__device__ __forceinline__ void w4a4_mainloop(
    uint8_t* x_s, const int8_t* __restrict__ xq,
    const uint8_t* __restrict__ wp, int M, int N, int K, int m0, int n0,
    int (&acc)[NMAT][64]) {
  constexpr int W_STAGE = NMAT * TL_W_STAGE;
  uint8_t* w_s = x_s + TL_STAGES * TL_X_STAGE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wi = warp & 3;
  const int half = K / 2;
  const int nk = (half + TL_BK - 1) / TL_BK;

  // stage kb: 16-byte chunks of the activation rows (4 of the low plane at
  // packed column c, 4 of the high at K/2 + c; chunk ch of row r at
  // ch ^ (r % 8), the 128-byte swizzle) and of the packed weight rows;
  // chunks past M, N or K/2 are zero-filled
  auto load_stage = [&](int kb, int slot) {
    const int c0 = kb * TL_BK;
    uint8_t* xs = x_s + slot * TL_X_STAGE;
    uint8_t* ws = w_s + slot * W_STAGE;
#pragma unroll
    for (int i = 0; i < TL_BM * 8 / TL_THREADS; ++i) {
      const int idx = tid + i * TL_THREADS;
      const int r = idx >> 3, ch = idx & 7;
      const int cc = c0 + (ch & 3) * 16;
      const int col = (ch >> 2) * half + cc;
      const int m = m0 + r;
      const bool ok = m < M && cc < half;
      size_t at;
      if constexpr (GROUPED)
        at = ((static_cast<size_t>(col >> 7) * M) + m) * 128 + (col & 127);
      else
        at = static_cast<size_t>(m) * K + col;
      cp_async16_zfill(xs + r * 128 + ((ch ^ (r & 7)) << 4),
                       ok ? xq + at : xq, ok);
    }
#pragma unroll
    for (int i = 0; i < NMAT * TL_BN * 4 / TL_THREADS; ++i) {
      const int idx = tid + i * TL_THREADS;
      const int r = idx >> 2, j = idx & 3;  // r: matrix r / 128, row r % 128
      const int cc = c0 + j * 16;
      const int n = n0 + (r & (TL_BN - 1));
      const bool ok = n < N && cc < half;
      const size_t row = static_cast<size_t>(r / TL_BN) * N + n;
      cp_async16_zfill(ws + r * TL_W_LD + j * 16,
                       ok ? wp + row * half + cc : wp, ok);
    }
  };

#pragma unroll
  for (int mat = 0; mat < NMAT; ++mat)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[mat][i] = 0;

  // stage kb: wait for its copies, refill the slot stage kb - 1 used;
  // then per matrix unpack the warp's 16 weight rows (packed bytes 0-31
  // and 32-63, in the A fragments' layout) into a[mat] and issue its 4
  // k-steps of 32 (low plane c + [0, 64), then high plane K/2 + c +
  // [0, 64)) as one group, so a matrix's products run while the next
  // one's rows are unpacked; end with every group done
  auto step = [&](int kb, unsigned (&a)[NMAT][4][4]) {
    cp_async_wait<TL_STAGES - 2>();  // stage kb has landed
    fence_proxy_async();             // ... visible to the wgmmas
    __syncthreads();                 // ... for every thread
    if (kb + TL_STAGES - 1 < nk)
      load_stage(kb + TL_STAGES - 1, (kb + TL_STAGES - 1) % TL_STAGES);
    cp_async_commit();  // an empty group at the tail keeps the count
    const int slot = kb % TL_STAGES;
    const uint8_t* xs = x_s + slot * TL_X_STAGE;
#pragma unroll
    for (int mat = 0; mat < NMAT; ++mat) {
      unsigned p[2][4];
      const uint8_t* wr =
          w_s + slot * W_STAGE +
          (mat * TL_BN + wg * 64 + wi * 16 + (lane & 15)) * TL_W_LD +
          (lane >> 4) * 16;
      ldmatrix_x4(p[0], wr);
      ldmatrix_x4(p[1], wr + 32);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        a[mat][0][r] = lo_codes16(p[0][r]);  // k = c + [0, 32)
        a[mat][1][r] = lo_codes16(p[1][r]);  // k = c + [32, 64)
        a[mat][2][r] = hi_codes16(p[0][r]);  // k = K/2 + c + [0, 32)
        a[mat][3][r] = hi_codes16(p[1][r]);  // k = K/2 + c + [32, 64)
      }
      fence_regs(acc[mat]);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wgmma_s8_rs_n128(acc[mat], a[mat][j], sw128_desc(xs + j * 32), 1);
      wgmma_commit();
    }
    wgmma_wait<0>();
#pragma unroll
    for (int mat = 0; mat < NMAT; ++mat) fence_regs(acc[mat]);
  };

#pragma unroll
  for (int st = 0; st < TL_STAGES - 1; ++st) {
    if (st < nk) load_stage(st, st);
    cp_async_commit();
  }
  if constexpr (NMAT == 1) {
    // two stages a turn on two A register sets: measured faster than one
    // set and no unroll (phase 3a, PERF.md)
    unsigned a0[1][4][4], a1[1][4][4];
    for (int kb = 0; kb < nk; kb += 2) {
      step(kb, a0);
      if (kb + 1 < nk) step(kb + 1, a1);
    }
  } else {
    unsigned a0[NMAT][4][4];
    for (int kb = 0; kb < nk; ++kb) step(kb, a0);
  }
  cp_async_wait<0>();
}

}  // namespace
