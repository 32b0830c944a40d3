// flash_prefill: causal GQA flash attention over a whole prompt, bf16,
// head_dim 128, one kernel behind both entry points of
// kernels/prefill_attention.py.
//
// Replaces: flatquant_tpu/kernels/prefill_attention.py
//   flash_prefill_attention_kt (K as [B, nkv, hd, S])  and
//   flash_prefill_attention    (K as [B, S, nkv, hd])   (Pallas).
// The kernel reads K through (batch, kv head, token) strides with
// head-dim stride 1, so both layouts -- and the prologue's token-major
// k_rot seen as a [B, nkv, hd, S] view -- arrive without a copy.
//
//   o[b, s, h] = sum_{t <= s} softmax_t(q[b, s, h] . k[b, t, h / n_rep]
//                * sm_scale) v[b, t, h / n_rep]
//
// Rounding points, as in the Pallas body: q is scaled by sm_scale *
// log2(e) in float32 and rounded to bf16; scores are float32 (bf16
// products, float32 sums) and the softmax runs in the exp2 domain with an
// online max m and sum l; p = exp2(s - m) is rounded to bf16 before the
// PV product (float32 sums); o = acc / max(l, 1e-30), rounded to bf16.
// The Pallas kernel walks keys in blocks of 512, this one in tiles of 64,
// so m (and the rounding of p) is taken at other points: the outputs
// agree with the plain version within kernels/tolerance.py's "flash"
// bound, not bit for bit.
//
// What bounds it on the H100: operations. At llama-2-7b's 1 x 2048
// prefill (32 heads) the causal products are 2 * S * (S + 1) * 128 * 32 =
// 34.4 GFLOP, 35 us at 989 bf16 TFLOP/s; the bytes (q, k, v read, o
// written: 67 MB) take 20 us at 3.35 TB/s.
//
// Design: a block owns 64 query rows of one (batch, query head), 4 warps
// of 16 rows each, and loops over the K/V tiles of 64 keys at or below
// its diagonal (tiles above it are never visited; the diagonal tile is
// masked elementwise). Blocks of the longest rows are scheduled first.
// Both products run on the tensor cores through mma.sync.m16n8k16 bf16
// with float32 accumulators (not wgmma): a warp's q fragments stay in
// registers for the whole loop, its S = q k^T accumulators become the
// bf16 A fragments of the PV product without a trip through shared
// memory, and K (ldmatrix) and V (ldmatrix.trans) are read from shared
// memory, double-buffered by cp.async. Shared rows are padded to 272
// bytes so the 8 rows of an ldmatrix hit distinct banks. Q is staged in
// the second K buffer before the loop: 70 KB of shared memory per block.

#include <cuda_bf16.h>
#include <math.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int FP_BQ = 64;  // query rows per block (4 warps x 16)
constexpr int FP_BK = 64;  // keys per tile
constexpr int FP_HD = 128;
constexpr int FP_THREADS = 128;
constexpr int FP_LD = FP_HD + 8;        // padded shared row, bf16
constexpr int FP_TILE = FP_BK * FP_LD;  // one K or V tile, bf16
constexpr int FP_SMEM = 4 * FP_TILE * 2;  // K[2], V[2], bytes

// Fragment layouts of mma.m16n8k16 (g8 = lane / 4, tq = lane % 4):
//   A regs 0..3: (row g8, cols 2tq..), (row g8 + 8, cols 2tq..),
//                (row g8, cols 8 + 2tq..), (row g8 + 8, cols 8 + 2tq..)
//   B regs 0, 1: (k 2tq.., n g8), (k 8 + 2tq.., n g8)
//   C regs 0..3: (row g8, col 2tq), (row g8, 2tq + 1), (row g8 + 8, 2tq),
//                (row g8 + 8, 2tq + 1)
__global__ void __launch_bounds__(FP_THREADS)
flash_prefill_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     int q_sb, int q_ss, int q_sh, int k_sb, int k_sh,
                     int k_ss, int v_sb, int v_ss, int v_sh, int S, int nh,
                     int n_rep, float scale) {
  extern __shared__ float4 smem4[];
  bf16* sk = reinterpret_cast<bf16*>(smem4);  // [2][FP_BK][FP_LD]
  bf16* sv = sk + 2 * FP_TILE;                // [2][FP_BK][FP_LD]
  bf16* sq = sk + FP_TILE;  // Q staging: the second K buffer, before use

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, tq = lane & 3;
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / n_rep;
  const int q0 = qt * FP_BQ;
  const bf16* kb = k + static_cast<size_t>(b) * k_sb +
                   static_cast<size_t>(kvh) * k_sh;
  const bf16* vb = v + static_cast<size_t>(b) * v_sb +
                   static_cast<size_t>(kvh) * v_sh;

  // one K/V tile: 64 rows x 16 chunks of 8 bf16 each, 8 chunks per thread
  auto load_kv = [&](int kt, int buf) {
    const int k0 = kt * FP_BK;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = tid + i * FP_THREADS;
      const int r = c >> 4, col = (c & 15) * 8;
      cp_async16(sk + buf * FP_TILE + r * FP_LD + col,
                 kb + static_cast<size_t>(k0 + r) * k_ss + col);
      cp_async16(sv + buf * FP_TILE + r * FP_LD + col,
                 vb + static_cast<size_t>(k0 + r) * v_ss + col);
    }
  };

  load_kv(0, 0);
  cp_async_commit();

  // Q tile: bf16(float(q) * scale) into shared memory, then each warp's 16
  // rows into A fragments for the 8 k-steps of head_dim
  const bf16* qb = q + static_cast<size_t>(b) * q_sb +
                   static_cast<size_t>(h) * q_sh;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = tid + i * FP_THREADS;
    const int r = c >> 4, col = (c & 15) * 8;
    const uint4 raw = ldg16(qb + static_cast<size_t>(q0 + r) * q_ss + col);
    const bf16* x = reinterpret_cast<const bf16*>(&raw);
    __align__(16) bf16 y[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      y[e] = __float2bfloat16_rn(__fmul_rn(__bfloat162float(x[e]), scale));
    *reinterpret_cast<uint4*>(sq + r * FP_LD + col) =
        *reinterpret_cast<const uint4*>(y);
  }
  __syncthreads();
  unsigned qa[8][4];
  {
    const int mi = lane >> 3;
    const bf16* base =
        sq + (warp * 16 + (mi & 1) * 8 + (lane & 7)) * FP_LD + (mi >> 1) * 8;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) ldmatrix_x4(qa[kk], base + kk * 16);
  }
  __syncthreads();  // Q is read: the second K buffer is free

  float o[16][4];
#pragma unroll
  for (int d = 0; d < 16; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const int row0 = q0 + warp * 16 + g8;  // this thread's rows: row0, +8

  for (int kt = 0; kt <= qt; ++kt) {
    if (kt < qt) load_kv(kt + 1, (kt + 1) & 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const bf16* tk = sk + (kt & 1) * FP_TILE;
    const bf16* tv = sv + (kt & 1) * FP_TILE;

    // S = q k^T for 64 keys: 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    {
      const int mi = lane >> 3;
      const bf16* base =
          tk + ((mi >> 1) * 8 + (lane & 7)) * FP_LD + (mi & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
        for (int j = 0; j < 8; j += 2) {
          unsigned bk[4];
          ldmatrix_x4(bk, base + j * 8 * FP_LD + kk * 16);
          mma_bf16(s[j], qa[kk], bk[0], bk[1]);
          mma_bf16(s[j + 1], qa[kk], bk[2], bk[3]);
        }
      }
    }

    if (kt == qt) {  // diagonal tile: key > row -> -inf
      const int k0 = kt * FP_BK;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + j * 8 + tq * 2 + (e & 1);
          const int row = row0 + (e >= 2 ? 8 : 0);
          if (key > row) s[j][e] = -INFINITY;
        }
    }

    // online softmax in the exp2 domain (scores already carry log2 e)
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float corr0 = exp2f(__fsub_rn(m0, mn0));
    const float corr1 = exp2f(__fsub_rn(m1, mn1));
    float ls0 = 0.f, ls1 = 0.f;
    unsigned pa[4][4];  // p as the A fragments of 4 k-steps of 16 keys
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p0 = exp2f(__fsub_rn(s[j][0], mn0));
      const float p1 = exp2f(__fsub_rn(s[j][1], mn0));
      const float p2 = exp2f(__fsub_rn(s[j][2], mn1));
      const float p3 = exp2f(__fsub_rn(s[j][3], mn1));
      ls0 += p0 + p1;
      ls1 += p2 + p3;
      pa[j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
    l0 = __fadd_rn(__fmul_rn(l0, corr0), quad_sum(ls0));
    l1 = __fadd_rn(__fmul_rn(l1, corr1), quad_sum(ls1));
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int d = 0; d < 16; ++d) {
      o[d][0] = __fmul_rn(o[d][0], corr0);
      o[d][1] = __fmul_rn(o[d][1], corr0);
      o[d][2] = __fmul_rn(o[d][2], corr1);
      o[d][3] = __fmul_rn(o[d][3], corr1);
    }

    // o += p v: 4 k-steps of 16 keys x 16 n-tiles of 8 head-dim columns
    {
      const int mi = lane >> 3;
      const bf16* base =
          tv + ((mi & 1) * 8 + (lane & 7)) * FP_LD + (mi >> 1) * 8;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int d = 0; d < 16; d += 2) {
          unsigned bv[4];
          ldmatrix_x4_trans(bv, base + kk * 16 * FP_LD + d * 8);
          mma_bf16(o[d], pa[kk], bv[0], bv[1]);
          mma_bf16(o[d + 1], pa[kk], bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }

  const float il0 = fmaxf(l0, 1e-30f), il1 = fmaxf(l1, 1e-30f);
  bf16* ob = out + (static_cast<size_t>(b) * S * nh + h) * FP_HD;
  const size_t row_stride = static_cast<size_t>(nh) * FP_HD;
#pragma unroll
  for (int d = 0; d < 16; ++d) {
    const int col = d * 8 + tq * 2;
    *reinterpret_cast<unsigned*>(ob + row0 * row_stride + col) =
        pack_bf16(o[d][0] / il0, o[d][1] / il0);
    *reinterpret_cast<unsigned*>(ob + (row0 + 8) * row_stride + col) =
        pack_bf16(o[d][2] / il1, o[d][3] / il1);
  }
}

}  // namespace

// q [B, S, nh, 128] bf16 through strides (q_sb, q_ss, q_sh); K through
// (k_sb, k_sh, k_ss) as [B, nkv, S, 128]; v through (v_sb, v_ss, v_sh) as
// [B, S, nkv, 128]; every head-dim stride 1, every stride a multiple of 8
// elements and the bases 16-byte aligned; out [B, S, nh, 128] bf16
// contiguous. S % 64 == 0 and nh % nkv == 0 (checked in Python); scale =
// sm_scale * log2(e).
extern "C" int fq_flash_prefill(const void* q, const void* k, const void* v,
                                void* out, int q_sb, int q_ss, int q_sh,
                                int k_sb, int k_sh, int k_ss, int v_sb,
                                int v_ss, int v_sh, int B, int S, int nh,
                                int nkv, float scale, void* stream) {
  // opt into FP_SMEM of dynamic shared memory once, so a launch inside a
  // CUDA graph capture makes no other runtime call
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_prefill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        FP_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  dim3 grid(S / FP_BQ, nh, B);
  flash_prefill_kernel<<<grid, FP_THREADS, FP_SMEM,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), q_sb, q_ss, q_sh,
      k_sb, k_sh, k_ss, v_sb, v_ss, v_sh, S, nh, nh / nkv, scale);
  return static_cast<int>(cudaGetLastError());
}
