// The flat-layout fused transform + quant pipeline of the prefill routes.
//
// Replaces: flatquant_tpu/kernels/flat_pipeline.py (Pallas):
//   rmsnorm_right_flat           -> fq_rmsnorm_right_flat
//   left_quant_i8_flat           -> fq_left_quant_i8_flat
//   w4a4_matmul_i8_swiglu_right  -> fq_w4a4_matmul_i8_swiglu_right
// and flatquant_tpu/kernels/int4_matmul.py (Pallas):
//   w4a4_matmul_i8_swiglu        -> fq_w4a4_matmul_i8_swiglu, the same
//                                   GEMM without the right factor
// and flatquant_tpu/kernels/grouped_mlp.py (Pallas), the same functions on
// the grouped layout [G, T, 128] (flat column c of token t at
// (c / 128) * T * 128 + t * 128 + c % 128):
//   rmsnorm_right_grouped        -> fq_rmsnorm_right_grouped (grouped out)
//   left_quant_i8_grouped        -> fq_left_quant_i8_grouped (in and out)
//   w4a4_swiglu_grouped          -> fq_w4a4_swiglu_grouped (grouped out)
//   w4a4_swiglu_grouped_gx       -> fq_w4a4_swiglu_grouped (x_grouped: in
//                                   and out)
// Each grouped kernel is its flat twin's device body with a layout flag
// that changes only addresses: every 16-byte chunk and every 128-wide
// tile a body touches lies inside one group. So a grouped kernel runs its
// twin's instructions in its twin's order and equals it bit for bit on
// group_layout of the same input.
//
// The flat kernels keep the flat [T, K] layout, K = G * 128, and all
// round to bf16 at the points the JAX kernels do (see
// kernels/flat_pipeline.py). Float
// arithmetic that the plain versions do op by op is written with
// __fmul_rn / __fadd_rn / IEEE '/' where the compiler could otherwise
// contract it into an FMA; only the matrix-product sums use FMAs (their
// order differs from the plain versions anyway, which the checks allow).
//
// What bounds each on the H100 at the prefill shapes (T = 2048 rows):
//   - rmsnorm_right_flat, left_quant_i8_flat: bytes (a read of x and a
//     write of the output, 25-68 MB, ~10-20 us at 3.35 TB/s); their
//     128x128 (resp. GxG) products, 0.5-4 GFLOP, run on wgmma bf16 (each
//     body's note says how it keeps the loads moving).
//   - the swiglu GEMM: int8 operations (2 * 2048 * 22016 * 4096 = 369 G,
//     187 us at 1979 TOP/s). It runs row 1's wgmma s8 tile
//     (w4a4_tile.cuh) with the up and the gate rows of 128 channels per
//     block, and the right factor's 128 x 128 product on the tensor cores
//     too (wgmma bf16). Without the right factor (w4a4_matmul_i8_swiglu,
//     the balanced Kronecker split's MLP, e.g. Qwen-2.5-7B: 2 * 2048 *
//     37888 * 3584 = 556 G, 281 us) the same main loop ends in an
//     epilogue that writes u * silu(g) straight from the accumulators.

#include <cuda_bf16.h>

#include "common.cuh"
#include "mma.cuh"
#include "tma.cuh"
#include "w4a4_tile.cuh"

namespace {

typedef __nv_bfloat16 bf16;




// Opt a kernel into `bytes` of dynamic shared memory (above 48 KB), once:
// *done remembers the largest size set so far, so a launch inside a CUDA
// graph capture makes no runtime call after the first launch.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, int* done) {
  if (bytes <= *done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *done = bytes;
  return err;
}

// ---------------------------------------------------------------------------
// rmsnorm_right_flat, rmsnorm_right_grouped
//
// Replace: flatquant_tpu/kernels/flat_pipeline.py:84 (rmsnorm_right_flat)
// and flatquant_tpu/kernels/grouped_mlp.py:424 (rmsnorm_right_grouped).
//
// y[t, g*128 + c] = bf16(sum_d xn[t, g*128 + d] * R[d, c])   (R in bf16)
// xn = bf16((x * rsqrt(sum(x^2) * (1/H) + eps)) * w)
//
// What bounds it on the H100: bytes. At the llama-2-7b prefill (T = 2048,
// H = 4096) x is 16.8 MB of bf16 read and y 16.8 MB written, 10 us at
// 3.35 TB/s; the 128 x 128 products (2.1 GFLOP) take 2 us at the bf16
// tensor rate. The body it replaces (float32 FMAs on the CUDA cores, the
// factor copied as float32 by each of 256 blocks, x read three times,
// nothing overlapped) took 0.152 ms there, 15x the bound (PERF.md).
//
// Design: the transposed product y^T = R^T xn^T on wgmma m64n16k16 bf16,
// the 16 tokens of a tile as N. A cluster of RN_CL = 2 CTAs owns a tile,
// each CTA half of the column groups, so a CTA's share of the tile is 8
// rows' worth of x (64 KB at H = 4096, bf16) and two CTAs fit an SM. Each
// CTA walks its cluster's tiles and holds R^T as wgmma's register A, staged
// once a CTA from the bf16 factor (beside the first tile's loads) and read
// with ldmatrix: warpgroup wg the output channels 64 wg .. 64 wg + 63, 32
// registers a thread. Per tile:
//   1. the CTA's columns of the tile's rows go to shared memory by
//      cp.async (the slab; its columns of w come with the first tile);
//      each warp sums the squares of 2 rows there, and the CTA stores its
//      partial sums in both CTAs of the cluster (distributed shared
//      memory); after a cluster barrier each CTA adds the partials in rank
//      order, so both hold the same 1/rms;
//   2. by steps of RN_GPS column groups: each warpgroup runs 8 wgmma a
//      group on the step's xn tiles [16][128] bf16 (wgmma's K-major B,
//      128-byte swizzle) while every thread normalizes 16-byte chunks of
//      the slab into the next step's (double-buffered); then the float32
//      sums go to bf16 in a staging tile [16][128] (16-byte chunk n of row
//      r at n ^ (r % 8), double-buffered too), which the CTA stores as
//      16-byte pieces of y's rows after the step's one barrier.
// Measured on the card (PERF.md, tools/rmsnorm_ablate.py): tiles of 8
// tokens without clusters spent 10 of 33 us on the products (their time
// follows the count of wgmma more than their N), 16-token tiles 4 of 28;
// clusters of 4 with 32-token tiles fit 62 at once on the card, fewer
// than T = 2048's 64 tiles, and ran in two waves.
// x crosses to the SM once, and no CTA repeats another's pass 1. Where
// the slab and w do not fit a CTA's shared memory (float32 x from H =
// 5760, bf16 from H = 11136), both are read from device memory instead
// (the second read of a row then hits L2). One body serves bf16 and
// float32 x: only the loads differ. Rows past T are zeros in xn and are
// not stored. GROUPED changes only the output addresses, so the grouped
// kernel runs the flat one's instructions on the same values and is
// bit-identical to it. The tensor cores' float32 sums within a k-step are
// not IEEE sums in order: with identity factors every y is one exact
// product (xn itself); with orthogonal ones y may round to another bf16
// now and then (kernels/tolerance.py).
// ---------------------------------------------------------------------------

constexpr int RN_CL = 2;            // CTAs of a cluster, column halves
constexpr int RN_ROWS = 8 * RN_CL;  // tokens a tile: wgmma's N
constexpr int RN_THREADS = 256;     // warp w sums rows RN_CL w ...
constexpr int RN_GPS = 2;           // column groups a step
constexpr int RN_TILE = RN_ROWS * 256;     // bytes of one [16][128] bf16 tile
constexpr int RN_STEP = RN_GPS * RN_TILE;  // bytes of a step's tiles
constexpr int RN_R_BYTES = 128 * 128 * 2;  // the factor, bf16
// the factor, then two steps' xn and staging tiles
constexpr int RN_TILES =
    4 * RN_STEP > RN_R_BYTES ? 4 * RN_STEP : RN_R_BYTES;
static_assert(RN_ROWS % (RN_THREADS / 32) == 0, "whole rows a warp");

// the column groups [lo, hi) of cluster rank k
__host__ __device__ inline int rn_glo(int G, int k) { return k * G / RN_CL; }
// a CTA's most column groups
__host__ __device__ inline int rn_gmax(int G) {
  return (G + RN_CL - 1) / RN_CL;
}

// bytes of shared memory past the 1024-byte alignment: the factor and
// then the steps' xn and staging tiles, 1/rms of the tile's rows and the
// partial sums [2 tiles][RN_CL][RN_ROWS], and (staged) the CTA's columns
// of w and the slab [RN_ROWS][its columns]
__host__ inline int rn_smem(int H, int esize, bool staged) {
  const int cols = rn_gmax(H / 128) * 128;
  return RN_TILES + RN_ROWS * 4 + 2 * RN_CL * RN_ROWS * 4 +
         (staged ? cols * 4 + RN_ROWS * cols * esize : 0);
}

// 16 bytes of x (8 bf16 or 4 float32 values) as floats
template <typename InT>
struct Chunk;
template <>
struct Chunk<bf16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const bf16* p, float* v) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};
template <>
struct Chunk<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  }
};

// GROUPED: y is [H / 128, T, 128] (rmsnorm_right_grouped) instead of
// [T, H]; nothing else changes. right: R [128][128] bf16. staged: the
// slab and w sit in shared memory (launch_rmsnorm_right sizes it).
template <typename InT, bool GROUPED>
__device__ __forceinline__ void rmsnorm_right(const InT* __restrict__ x,
                                              const float* __restrict__ w,
                                              const bf16* __restrict__ right,
                                              bf16* __restrict__ y, int T,
                                              int H, float eps, int staged) {
  extern __shared__ __align__(16) uint8_t rn_raw[];
  uint8_t* b_s = rn_raw + ((1024 - (smem_u32(rn_raw) & 1023)) & 1023);
  // xn tiles [2][GPS][16][256 B] at b_s, staging tiles likewise at o_s
  uint8_t* o_s = b_s + 2 * RN_STEP;
  float* inv = reinterpret_cast<float*>(b_s + RN_TILES);  // [RN_ROWS]
  float* part = inv + RN_ROWS;  // [2][RN_CL][RN_ROWS], by cluster rank
  float* w_s = part + 2 * RN_CL * RN_ROWS;  // the CTA's columns (staged)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = tid >> 7, wi = warp & 3, g8 = lane >> 2, tq = lane & 3;
  const int G = H / 128;
  const int rank = static_cast<int>(cluster_rank());
  const int glo = rn_glo(G, rank), ghi = rn_glo(G, rank + 1);
  const int ncol = (ghi - glo) * 128;  // the CTA's columns
  // [RN_ROWS][ncol] (staged)
  InT* slab = reinterpret_cast<InT*>(w_s + rn_gmax(G) * 128);
  const int cpr = ncol * static_cast<int>(sizeof(InT)) / 16;  // chunks a row
  const int ntiles = (T + RN_ROWS - 1) / RN_ROWS;

  // R where the tiles go, 16-byte chunk j of row d at j ^ (d % 8) of the
  // row (conflict-free ldmatrix below), and the CTA's columns of w; they
  // land beside the first tile's slab
  for (int i = tid; i < RN_R_BYTES / 16; i += RN_THREADS) {
    const int d = i >> 4, j = i & 15;
    cp_async16(b_s + d * 256 + ((j ^ (d & 7)) << 4),
               reinterpret_cast<const uint8_t*>(right) + 16 * i);
  }
  if (staged)
    for (int i = tid; i < ncol / 4; i += RN_THREADS)
      cp_async16(w_s + 4 * i, w + glo * 128 + 4 * i);
  cp_async_commit();
  const float* wv = staged ? w_s : w + glo * 128;

  const int c = wg * 64 + wi * 16 + g8;  // output channel, + 8 (A's rows)
  unsigned ra[8][4];
  int it = 0;  // the cluster's tiles walked so far: the partials' buffer
  for (int tile = blockIdx.x / RN_CL; tile < ntiles;
       tile += gridDim.x / RN_CL, ++it) {
    const int t0 = tile * RN_ROWS;
    const int nr = min(RN_ROWS, T - t0);
    // the CTA's columns of row r of the tile: the slab's, or x's own
    auto row = [&](int r) -> const InT* {
      return staged ? slab + r * ncol
                    : x + static_cast<size_t>(t0 + r) * H + glo * 128;
    };
    if (staged) {  // the previous tile's last reads of the slab were
                   // behind its last step's barriers
      for (int idx = tid; idx < nr * cpr; idx += RN_THREADS) {
        const int r = idx / cpr, i = idx - r * cpr;
        cp_async16(reinterpret_cast<uint8_t*>(slab + r * ncol) + 16 * i,
                   reinterpret_cast<const uint8_t*>(
                       x + static_cast<size_t>(t0 + r) * H + glo * 128) +
                       16 * i);
      }
      cp_async_commit();
    }
    cp_async_wait<0>();  // the slab; on the first tile R and w too
    __syncthreads();
    if (it == 0) {
      // A: R^T's rows c (+ 8), k-step s over d = 16 s + 2 tq (+ 1) and
      // 16 s + 8 + 2 tq (+ 1), as bf16 pairs (lower d low): R stored
      // [d][c] is A stored [k][m], so ldmatrix .trans gives the fragments;
      // lane l addresses row l % 8 of matrix l / 8: d = 16 s + 8 (matrix
      // / 2) + l % 8, columns 64 wg + 16 wi + 8 (matrix % 2) ...
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        const int d = 16 * s + ((lane >> 4) << 3) + (lane & 7);
        const int j = ((wg * 64 + wi * 16) >> 3) + ((lane >> 3) & 1);
        ldmatrix_x4_trans(ra[s], reinterpret_cast<const bf16*>(
                                     b_s + d * 256 + ((j ^ (d & 7)) << 4)));
      }
      // R is read (the tiles take its place), and every CTA of the
      // cluster runs before any stores in another's shared memory
      cluster_sync();
    }

    // pass 1: warp w sums the squares of its rows' columns here, lane l
    // over the 16-byte chunks l, l + 32, ... in order, then the warp's
    // butterfly; lane k stores the sum in CTA k's partials
    float* pt = part + (it & 1) * RN_CL * RN_ROWS;
#pragma unroll 1
    for (int q = 0; q < RN_ROWS / 8; ++q) {
      const int r = warp * (RN_ROWS / 8) + q;
      float ss = 0.f;
      if (r < nr) {
        const InT* xr = row(r);
#pragma unroll 4
        for (int i = lane; i < cpr; i += 32) {
          float v[Chunk<InT>::N];
          Chunk<InT>::load(xr + i * Chunk<InT>::N, v);
#pragma unroll
          for (int e = 0; e < Chunk<InT>::N; ++e)
            ss = __fadd_rn(ss, __fmul_rn(v[e], v[e]));
        }
      }
      ss = warp_sum(ss);
      if (lane < RN_CL) st_cluster(pt + rank * RN_ROWS + r, lane, ss);
    }
    cluster_sync();  // every CTA's partials are in
    if (tid < RN_ROWS) {
      float ss = pt[tid];
#pragma unroll
      for (int k = 1; k < RN_CL; ++k) ss = __fadd_rn(ss, pt[k * RN_ROWS + tid]);
      // torch.mean multiplies the sum by 1/H; rsqrtf is what torch.rsqrt
      // runs on the card
      inv[tid] = rsqrtf(__fadd_rn(__fmul_rn(ss, 1.0f / H), eps));
    }
    __syncthreads();

    // xn of the step at column group g0 into the tiles at bt: 16-byte
    // chunk j (columns 8 j .. 8 j + 7 of group g0 + gi) of row r at half
    // j / 8 of the group's tile, chunk (j % 8) ^ (r % 8) of the row's 128
    // bytes; zeros for rows past T
    auto build = [&](int g0, uint8_t* bt) {
      const int ng = min(RN_GPS, ghi - g0);
      for (int idx = tid; idx < ng * RN_ROWS * 16; idx += RN_THREADS) {
        const int gi = idx / (RN_ROWS * 16), r = idx / 16 % RN_ROWS;
        const int j = idx % 16;
        const int col = (g0 - glo + gi) * 128 + 8 * j;  // the CTA's
        uint4 out = make_uint4(0u, 0u, 0u, 0u);
        if (r < nr) {
          float v[8];
          Chunk<InT>::load(row(r) + col, v);
          if constexpr (Chunk<InT>::N == 4)
            Chunk<InT>::load(row(r) + col + 4, v + 4);
          const float4 w0 = *reinterpret_cast<const float4*>(wv + col);
          const float4 w1 = *reinterpret_cast<const float4*>(wv + col + 4);
          const float ww[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
          const float s = inv[r];
          auto xn = [&](int e) {  // bf16 pair e: columns 2 e, 2 e + 1
            return pack_bf16(__fmul_rn(__fmul_rn(v[2 * e], s), ww[2 * e]),
                             __fmul_rn(__fmul_rn(v[2 * e + 1], s),
                                       ww[2 * e + 1]));
          };
          out = make_uint4(xn(0), xn(1), xn(2), xn(3));
        }
        *reinterpret_cast<uint4*>(bt + gi * RN_TILE + (j >> 3) * (RN_TILE / 2) +
                                  r * 128 + (((j & 7) ^ (r & 7)) << 4)) = out;
      }
      fence_proxy_async();  // the xn stores, seen by the wgmmas
    };

    // the steps: step st's products (xn tiles st % 2) run while every
    // thread builds step st + 1's xn tiles; its staging tiles (st % 2) are
    // stored after the step's one barrier
    const int nsteps = (ghi - glo + RN_GPS - 1) / RN_GPS;
    if (nsteps > 0) build(glo, b_s);
    __syncthreads();
    for (int st = 0; st < nsteps; ++st) {
      const int g0 = glo + st * RN_GPS, ng = min(RN_GPS, ghi - g0);
      const uint8_t* bt = b_s + (st & 1) * RN_STEP;
      uint8_t* ot = o_s + (st & 1) * RN_STEP;
      float acc[RN_GPS][RN_ROWS / 2];
      wgmma_fence();
      // k-step by k-step over the groups: the groups' products are
      // independent, so consecutive wgmmas never wait on each other
#pragma unroll
      for (int s = 0; s < 8; ++s) {
#pragma unroll
        for (int gi = 0; gi < RN_GPS; ++gi) {
          if (gi < ng)
            Wgmma<RN_ROWS>::mma(acc[gi], ra[s],
                                sw128_desc(bt + gi * RN_TILE +
                                           (s >> 2) * (RN_TILE / 2) +
                                           (s & 3) * 32),
                                s > 0);
        }
      }
      wgmma_commit();
      if (st + 1 < nsteps) build(g0 + RN_GPS, b_s + ((st + 1) & 1) * RN_STEP);
      wgmma_wait<0>();
#pragma unroll
      for (int gi = 0; gi < RN_GPS; ++gi) fence_f32<RN_ROWS / 2>(acc[gi]);

      // acc[gi][4 i + e]: output channel c (+ 8 for e >= 2) of token row
      // 8 i + 2 tq + (e & 1) -> staging tile gi
#pragma unroll
      for (int gi = 0; gi < RN_GPS; ++gi) {
        if (gi < ng) {
#pragma unroll
          for (int e = 0; e < RN_ROWS / 2; ++e) {
            const int r = 8 * (e >> 2) + 2 * tq + (e & 1);
            const int cc = c + ((e >> 1) & 1) * 8;
            *reinterpret_cast<bf16*>(ot + gi * RN_TILE + r * 256 +
                                     (((cc >> 3) ^ (r & 7)) << 4) +
                                     (cc & 7) * 2) =
                __float2bfloat16_rn(acc[gi][e]);
          }
        }
      }
      // the staging tiles are whole, step st + 1's xn tiles too, and
      // both warpgroups' products of step st are done with theirs
      __syncthreads();
      for (int idx = tid; idx < ng * RN_ROWS * 16; idx += RN_THREADS) {
        const int gi = idx / (RN_ROWS * 16), r = idx / 16 % RN_ROWS;
        const int n = idx % 16;
        if (r < nr) {
          const size_t t = t0 + r, g = g0 + gi;
          const size_t at = GROUPED ? (g * T + t) * 128 + 8 * n
                                    : t * H + g * 128 + 8 * n;
          *reinterpret_cast<uint4*>(y + at) = *reinterpret_cast<const uint4*>(
              ot + gi * RN_TILE + r * 256 + ((n ^ (r & 7)) << 4));
        }
      }
    }
  }
}

template <typename InT>
__global__ void __cluster_dims__(RN_CL, 1, 1) __launch_bounds__(RN_THREADS, 2)
rmsnorm_right_flat_kernel(const InT* __restrict__ x,
                          const float* __restrict__ w,
                          const bf16* __restrict__ right,
                          bf16* __restrict__ y, int T, int H, float eps,
                          int staged) {
  rmsnorm_right<InT, false>(x, w, right, y, T, H, eps, staged);
}

template <typename InT>
__global__ void __cluster_dims__(RN_CL, 1, 1) __launch_bounds__(RN_THREADS, 2)
rmsnorm_right_grouped_kernel(const InT* __restrict__ x,
                             const float* __restrict__ w,
                             const bf16* __restrict__ right,
                             bf16* __restrict__ y, int T, int H, float eps,
                             int staged) {
  rmsnorm_right<InT, true>(x, w, right, y, T, H, eps, staged);
}

// ---------------------------------------------------------------------------
// left_quant_i8_flat, left_quant_i8_grouped
//
// z[t, i*128 + d] = bf16(sum_j left_t[i, j] * x[t, j*128 + d])
// xmax = max(max_i,d z, 0) * cmax; xmin = min(min z, 0) * cmin
// s = max(|xmin|, xmax) / q_max (1 when 0); q = clamp(rint(z / s))
//
// What bounds it on the H100: bytes. At the llama-2-7b 1 x 2048 prefill
// the down projection's input (K = 11008, G = 86) is 45 MB of bf16 read
// and 22.5 MB of codes written, 20 us at 3.35 TB/s; its products (2 * T *
// K * G = 3.9 GFLOP, padded to wgmma's tile 6.4) take 6.5 us at the bf16
// rate. The body it replaces (one 128-thread block per token, the G x G
// factor copied to shared memory per token, G^2 * 128 float32 FMAs on the
// CUDA cores) was latency-bound at 11x the bound (PERF.md).
//
// Design: a persistent grid (one block per SM, tokens t = block, block +
// grid, ...). Each block stages the left factor once, as wgmma's A: bf16
// (exact: JAX casts left_t to bf16), K-major with the 128-byte swizzle,
// zero-padded to M = 64 * MT rows and K = KP (G rounded up to 16)
// columns. A producer warp streams each token's slab X_t [G, 128] by TMA
// into a ring of slots, as KP rows of two 64-column halves (rows past G
// land as zeros), which is X_t as wgmma's MN-major B. The consumer
// warpgroups (4 at MT = 1, 2 at MT = 2, where the accumulators take 128
// registers) take the tokens in turn: Z_t = L^T X_t as MT x KP / 16 wgmma
// m64n128k16 (float32 sums, both operands in shared memory); phase 1
// rounds z to bf16 pairs in registers into a z tile in shared memory and
// takes the extrema over the real rows (row < G) with warp shuffles and a
// 4-warp shared-memory reduction; phase 2 spreads the G x 128 values
// evenly over the warpgroup, 8 a thread, and writes the codes into a
// staging tile [G][128] (128-byte swizzle) that one TMA store sends out.
// No z and no float32 value reach device memory. The flat and the grouped
// layouts differ only in the strides of the two tensor maps (token-major
// [T, G, 128] or group-major [G, T, 128]), so both kernels run the same
// instructions on the same values: the grouped twin is bit-identical.
// The tensor cores' float32 sums within a k-step are not IEEE sums in
// order: with identity factors every z is one exact product, so codes and
// scales stay bit-exact; with random orthogonal factors z may round to
// another bf16 now and then (kernels/tolerance.py "orthogonal").
// Tried and dropped (PERF.md, tools/row5_row18_ablate.py): the codes
// straight from the accumulators, 2 bytes a thread per row, with the
// division in the loop (0.0845 ms at K = 11008, the warps of padded rows
// idle); IEEE division or a per-value branch to it in phase 2 (0.065).
// ---------------------------------------------------------------------------

// consumer warpgroups of a block: 4 when the factor is one M tile (G <=
// 64), 2 when it is two (the float32 accumulators of 128 rows take 128
// registers a thread)
template <int MT>
__host__ __device__ constexpr int lq_nwg() {
  return MT == 1 ? 4 : 2;
}
template <int MT>
__host__ __device__ constexpr int lq_threads() {
  return lq_nwg<MT>() * 128 + 32;  // + the producer warp
}
constexpr int LQ_MAX_STAGES = 16;  // slab ring depth, at most

__host__ __device__ inline int lq_kpad(int g) { return (g + 15) / 16 * 16; }
__host__ __device__ inline int lq_round1k(int b) {
  return (b + 1023) / 1024 * 1024;
}
// bytes of the staged left factor: KP / 64 (rounded up) swizzle atoms of
// [64 * mt][128 B]
__host__ __device__ inline int lq_a_bytes(int g, int mt) {
  return (lq_kpad(g) + 63) / 64 * mt * 64 * 128;
}
// bytes of one warpgroup's z tile [G][128] bf16 and codes tile [G][128]
__host__ __device__ inline int lq_wg_bytes(int g) {
  return lq_round1k(g * 256) + lq_round1k(g * 128);
}
// bytes of one slab slot: two halves of [KP][128 B]
__host__ __device__ inline int lq_slab_bytes(int g) { return lq_kpad(g) * 256; }
// barriers and the extrema of 4 warps of each warpgroup
constexpr int LQ_TAIL = 2 * LQ_MAX_STAGES * 8 + 4 * 4 * 2 * 4;
__host__ inline int lq_fixed_smem(int g, int mt) {
  return 1024 + lq_a_bytes(g, mt) + (mt == 1 ? 4 : 2) * lq_wg_bytes(g) +
         LQ_TAIL;
}

// xmap: x bf16 as [T][G][128] through the layout's strides, boxes of [1,
// KP, 64]; qmap: the codes int8 as [T][G][128] likewise, boxes of [1, G,
// 128]; lt: left_t [G][G] bf16.
template <int MT>
__device__ __forceinline__ void left_quant_i8(const CUtensorMap* xmap,
                                              const CUtensorMap* qmap,
                                              const bf16* __restrict__ lt,
                                              const float* __restrict__ clip,
                                              float* __restrict__ xs, int G,
                                              int T, int stages, float q_max) {
  constexpr int NWG = lq_nwg<MT>();
  constexpr int MP = MT * 64;
  extern __shared__ __align__(16) uint8_t lq_raw[];
  uint8_t* a_s = lq_raw + ((1024 - (smem_u32(lq_raw) & 1023)) & 1023);
  const int KP = lq_kpad(G);
  const int wgb = lq_wg_bytes(G), slab = lq_slab_bytes(G);
  uint8_t* w_s = a_s + lq_a_bytes(G, MT);  // [NWG][z tile, codes tile]
  uint8_t* x_s = w_s + NWG * wgb;          // [stages][2 halves][KP][128 B]
  uint64_t* full = reinterpret_cast<uint64_t*>(x_s + stages * slab);
  uint64_t* empty = full + LQ_MAX_STAGES;
  float* red = reinterpret_cast<float*>(empty + LQ_MAX_STAGES);  // [NWG][4][2]
  const int tid = threadIdx.x;
  // this block's tokens: t = blockIdx.x + j * gridDim.x, j < ntok
  const int ntok = (T - 1 - blockIdx.x) / gridDim.x + 1;

  if (tid == 0) {
    for (int st = 0; st < stages; ++st) {
      mbar_init(full + st, 1);
      mbar_init(empty + st, 4);  // the consuming warpgroup's 4 warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= NWG * 128) {  // the producer: one thread issues the loads
    if (tid == NWG * 128) {
      for (int j = 0; j < ntok; ++j) {
        const int slot = j % stages;
        const unsigned ph = ((j / stages) & 1) ^ 1;
        const int t = blockIdx.x + j * gridDim.x;
        uint8_t* dst = x_s + slot * slab;
        mbar_wait(empty + slot, ph);
        mbar_expect_tx(full + slot, slab);
        tma_load(dst, xmap, 0, 0, t, full + slot);
        tma_load(dst + KP * 128, xmap, 64, 0, t, full + slot);
      }
    }
    return;
  }

  // A = left_t in bf16, while the first slabs land: chunk c (8 columns
  // from 64a + 8c) of row i of atom a at chunk c ^ (i % 8); zeros past G
  const int na = (KP + 63) / 64;
  for (int idx = tid; idx < na * MP * 8; idx += NWG * 128) {
    const int a = idx / (MP * 8), i = (idx >> 3) % MP, c = idx & 7;
    __align__(16) bf16 v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int j = 64 * a + 8 * c + e;
      v[e] = i < G && j < G ? lt[i * G + j] : __float2bfloat16_rn(0.f);
    }
    *reinterpret_cast<uint4*>(a_s + a * (MP * 128) + i * 128 +
                              ((c ^ (i & 7)) << 4)) =
        *reinterpret_cast<const uint4*>(v);
  }
  fence_proxy_async();  // the generic-proxy writes, seen by the wgmmas
  bar_sync<NWG * 128>(NWG + 1);  // the consumers

  const int wg = tid >> 7, wt = tid & 127;
  const int warp = wt >> 5, lane = tid & 31;
  const int g8 = lane >> 2, tq = lane & 3;
  uint8_t* z_s = w_s + wg * wgb;                // z [G][256 B] bf16
  uint8_t* c_s = z_s + lq_round1k(G * 256);     // codes [G][128 B]
  const float cmax = clip[0], cmin = clip[1];
  const float lo_q = -q_max - 1.f;
  const int nk = KP / 16;
  for (int j = wg; j < ntok; j += NWG) {
    const int slot = j % stages;
    const int t = blockIdx.x + j * gridDim.x;
    const uint8_t* xt = x_s + slot * slab;
    float acc[MT][64];
    mbar_wait(full + slot, (j / stages) & 1);
    wgmma_fence();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        if (kk < nk)
          WgmmaSS<128>::mma_tb(
              acc[mt],
              sw128_desc(a_s + (kk >> 2) * (MP * 128) + mt * (64 * 128) +
                         (kk & 3) * 32),
              sw128_mn_desc(xt + kk * 2048, KP * 128), kk > 0);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) fence_f32<64>(acc[mt]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + slot);  // the slab is read

    // phase 1: z in bf16 pairs into the z tile (16-byte chunk n of row i
    // at n ^ (i % 8)), the extrema over rows i < G (acc[mt][4n + e]: row
    // 64 mt + 16 warp + g8 + 8 (e >> 1), column 8n + 2tq + (e & 1)); max(.,
    // 0) and min(., 0) folded in
    __nv_bfloat162 mx2 = __floats2bfloat162_rn(0.f, 0.f), mn2 = mx2;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 64 * mt + 16 * warp + g8 + 8 * h;
        if (i < G) {
          uint8_t* row = z_s + i * 256 + 4 * tq;
#pragma unroll
          for (int n = 0; n < 16; ++n) {
            const __nv_bfloat162 z = __floats2bfloat162_rn(
                acc[mt][4 * n + 2 * h], acc[mt][4 * n + 2 * h + 1]);
            mx2 = __hmax2(mx2, z);
            mn2 = __hmin2(mn2, z);
            *reinterpret_cast<__nv_bfloat162*>(row + ((n ^ (i & 7)) << 4)) = z;
          }
        }
      }
    }
    float mx = fmaxf(__low2float(mx2), __high2float(mx2));
    float mn = fminf(__low2float(mn2), __high2float(mn2));
    mx = warp_max(mx);
    mn = -warp_max(-mn);
    if (lane == 0) {
      red[(wg * 4 + warp) * 2] = mx;
      red[(wg * 4 + warp) * 2 + 1] = mn;
    }
    if (wt == 0) bulk_wait_read<0>();  // the codes tile's last store read it
    bar_sync<128>(1 + wg);
    const float* r = red + wg * 8;
    mx = fmaxf(fmaxf(r[0], r[2]), fmaxf(r[4], r[6]));
    mn = fminf(fminf(r[1], r[3]), fminf(r[5], r[7]));
    const float absmax = fmaxf(fabsf(__fmul_rn(mn, cmin)), __fmul_rn(mx, cmax));
    const float sc = absmax == 0.f ? 1.f : absmax / q_max;
    const float inv = __frcp_rn(sc);
    if (wt == 0) xs[t] = sc;

    // phase 2: 8 values a chunk -> 8 codes, clamp(rint(z / s)) (the clamp
    // bounds are integers, so it may come first). z * (1 / s) is within
    // 2^-22 of z / s relative (|z / s| <= 128 after the clamp: 3e-5), so
    // it rounds to the same integer unless it lies within 1e-4 of a half,
    // where z / s decides: one branch a chunk, rarely taken (a branch per
    // value cost 0.024 ms at K = 11008: tools/row5_row18_ablate.py). The
    // rounding adds and takes off 1.5 * 2^23.
    for (int c = wt; c < G * 16; c += 128) {
      const int i = c >> 4, n = c & 15;
      const uint4 raw = *reinterpret_cast<const uint4*>(
          z_s + i * 256 + ((n ^ (i & 7)) << 4));
      float f[8];
      widen_bf16x8(raw, f);
      int q[8];
      bool near_half = false;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float qf = fminf(fmaxf(__fmul_rn(f[e], inv), lo_q), q_max);
        const float y = __fadd_rn(qf, RINT_MAGIC);
        q[e] = __float_as_int(y) - RINT_MAGIC_BITS;
        near_half |= fabsf(__fsub_rn(qf, __fsub_rn(y, RINT_MAGIC))) > 0.4999f;
      }
      if (near_half) {  // the chunk again by the definition
#pragma unroll
        for (int e = 0; e < 8; ++e)
          q[e] = static_cast<int>(fminf(fmaxf(rintf(f[e] / sc), lo_q), q_max));
      }
      const unsigned w0 = __byte_perm(__byte_perm(q[0], q[1], 0x0040),
                                      __byte_perm(q[2], q[3], 0x0040), 0x5410);
      const unsigned w1 = __byte_perm(__byte_perm(q[4], q[5], 0x0040),
                                      __byte_perm(q[6], q[7], 0x0040), 0x5410);
      *reinterpret_cast<uint2*>(c_s + i * 128 + (((n >> 1) ^ (i & 7)) << 4) +
                                8 * (n & 1)) = make_uint2(w0, w1);
    }
    fence_proxy_async();  // the codes, seen by the TMA store
    bar_sync<128>(1 + wg);
    if (wt == 0) {
      tma_store(qmap, c_s, 0, 0, t);
      bulk_commit();
    }
  }
  if (wt == 0) bulk_wait<0>();
}

template <int MT>
__global__ void __launch_bounds__(lq_threads<MT>(), 1)
left_quant_i8_flat_kernel(const __grid_constant__ CUtensorMap xmap,
                          const __grid_constant__ CUtensorMap qmap,
                          const bf16* __restrict__ lt,
                          const float* __restrict__ clip,
                          float* __restrict__ xs, int G, int T, int stages,
                          float q_max) {
  left_quant_i8<MT>(&xmap, &qmap, lt, clip, xs, G, T, stages, q_max);
}

template <int MT>
__global__ void __launch_bounds__(lq_threads<MT>(), 1)
left_quant_i8_grouped_kernel(const __grid_constant__ CUtensorMap xmap,
                             const __grid_constant__ CUtensorMap qmap,
                             const bf16* __restrict__ lt,
                             const float* __restrict__ clip,
                             float* __restrict__ xs, int G, int T,
                             int stages, float q_max) {
  left_quant_i8<MT>(&xmap, &qmap, lt, clip, xs, G, T, stages, q_max);
}

// ---------------------------------------------------------------------------
// w4a4_matmul_i8_swiglu_right (and w4a4_matmul_i8_swiglu, w4a4_swiglu_grouped,
// w4a4_swiglu_grouped_gx)
//
// acc_u[m, n] = sum_k x[m, k] * (nib_u[n, k] - 8) (exact int32), u =
// (float)acc_u * sx[m] * sw[n], g likewise from the gate rows (sw[nh +
// n]); act = bf16(u * (g * (1 / (1 + exp(-g))))); y[m, n] = bf16(sum_d
// act[m, n0 + d] * R[d, n - n0]) per 128-column group.
//
// Main loop: row 1's wgmma s8 tile (w4a4_tile.cuh) with two weight
// matrices, the 128 up rows and the 128 gate rows of the block's 128
// output channels, against its 128 activation rows: each warpgroup
// carries the up and the gate sums of its 64 channels, so the epilogue
// owns whole 128-column groups. The int32 sums equal JAX's acc - 8 *
// rowsum(x) exactly; the dequant and SwiGLU round where the plain version
// does (__fmul_rn, IEEE 1 / (1 + expf(-g)), bf16 act).
// Epilogue (RIGHT): the act tile goes to shared memory as wgmma's B (two
// [128 rows][64 channels] bf16 halves, 128-byte swizzle), the right
// factor's transpose into registers as A (bf16), and 8 wgmma m64n128k16
// give each warpgroup 64 output channels of the group with float32 sums,
// as JAX's bf16 x bf16 dot; the bf16 outputs are staged in shared memory
// and stored as 16-byte rows. Without RIGHT (w4a4_matmul_i8_swiglu):
// out_dtype(u * (g * (1 / (1 + exp(-g))))) straight from the
// accumulators, in bf16 or float32.
// ---------------------------------------------------------------------------

constexpr int SW_SMEM = tl_smem<2>();  // the ring; the epilogue reuses it
constexpr int SW_OUT_LD = 136;         // padded output tile row, bf16

template <typename OutT>
__device__ __forceinline__ OutT to_out(float v);
template <>
__device__ __forceinline__ float to_out<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 to_out<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// The body of the four swiglu GEMMs; each __global__ below carries its
// wrapper's name (the profiles group kernels by it). GROUPED_IN: xq is
// [K / 128, M, 128] (w4a4_swiglu_grouped_gx); GROUPED_OUT (with RIGHT): y
// is [NH / 128, M, 128]. A load's 16-byte chunks start at multiples of 16
// and an output tile is one 128-column group, so only addresses change.
template <bool RIGHT, typename OutT, bool GROUPED_IN = false,
          bool GROUPED_OUT = false>
__device__ __forceinline__ void swiglu_gemm(const int8_t* __restrict__ xq,
                                            const uint8_t* __restrict__ wp,
                                            const float* __restrict__ sx,
                                            const float* __restrict__ sw,
                                            const float* __restrict__ right,
                                            OutT* __restrict__ y, int M,
                                            int NH, int K) {
  extern __shared__ __align__(16) uint8_t sw_raw[];
  uint8_t* sm = sw_raw + ((1024 - (smem_u32(sw_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wi = warp & 3;
  const int g8 = lane >> 2, tq = lane & 3;
  const int m0 = blockIdx.x * TL_BM;  // activation rows, fastest (row 1's
  const int n0 = blockIdx.y * TL_BN;  // order)
  int acc[2][64];
  w4a4_mainloop<2, GROUPED_IN>(sm, xq, wp, M, NH, K, m0, n0, acc);

  // acc[mat][4i + e]: channel c = 64 wg + 16 wi + g8 (+ 8 for e >= 2) of
  // the block's 128, activation row t = 8i + 2 tq + (e & 1); / 16 exactly
  auto chan = [&](int e) {
    return n0 + wg * 64 + wi * 16 + g8 + (e >> 1) * 8;
  };
  auto act = [&](int i, int e, int m) {
    const int n = chan(e);
    const float xsc = sx[m];
    const float u = __fmul_rn(
        __fmul_rn(static_cast<float>(acc[0][4 * i + e] >> 4), xsc), sw[n]);
    const float g = __fmul_rn(
        __fmul_rn(static_cast<float>(acc[1][4 * i + e] >> 4), xsc),
        sw[NH + n]);
    const float sig = 1.0f / __fadd_rn(1.0f, expf(-g));
    return __fmul_rn(u, __fmul_rn(g, sig));
  };

  if constexpr (!RIGHT) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + i * 8 + tq * 2 + (e & 1);
        if (m < M)
          y[static_cast<size_t>(m) * NH + chan(e)] =
              to_out<OutT>(act(i, e, m));
      }
    }
  } else {
    __syncthreads();  // every warp is done with the ring
    // act[t][d] at half d / 64, row t, 16-byte chunk (d % 64) / 8 swizzled
    // with t % 8; rows past M hold the clamped row's values, not stored
#pragma unroll
    for (int i = 0; i < 16; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = i * 8 + tq * 2 + (e & 1);
        const int d = wi * 16 + g8 + (e >> 1) * 8;  // in half wg
        *reinterpret_cast<bf16*>(sm + wg * (TL_BM * 128) + t * 128 +
                                 (((d >> 3) ^ (t & 7)) << 4) + (d & 7) * 2) =
            __float2bfloat16_rn(act(i, e, min(m0 + t, M - 1)));
      }
    }
    // A: R^T's rows c = 64 wg + 16 wi + g8 (+ 8), k-step s over d = 16s +
    // 2tq (+1) and 16s + 8 + 2tq (+1), as bf16 pairs (exact: bf16 values)
    const int c = wg * 64 + wi * 16 + g8;
    unsigned ra[8][4];
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const float* r0 = right + (16 * s + 2 * tq) * 128 + c;
      ra[s][0] = pack_bf16(__ldg(r0), __ldg(r0 + 128));
      ra[s][1] = pack_bf16(__ldg(r0 + 8), __ldg(r0 + 128 + 8));
      ra[s][2] = pack_bf16(__ldg(r0 + 8 * 128), __ldg(r0 + 9 * 128));
      ra[s][3] = pack_bf16(__ldg(r0 + 8 * 128 + 8), __ldg(r0 + 9 * 128 + 8));
    }
    fence_proxy_async();  // the act stores, visible to the wgmmas
    __syncthreads();
    float out[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) out[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 8; ++s)
      Wgmma<128>::mma(out, ra[s],
                      sw128_desc(sm + (s >> 2) * (TL_BM * 128) + (s & 3) * 32),
                      s > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_f32<64>(out);
    __syncthreads();  // every warpgroup is done reading act
    // out[4i + e]: output channel c (+ 8 for e >= 2), activation row 8i +
    // 2tq + (e & 1) -> the tile [128 rows][SW_OUT_LD] bf16
    bf16* o = reinterpret_cast<bf16*>(sm);
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int t = (i >> 2) * 8 + tq * 2 + (i & 1);
      o[t * SW_OUT_LD + c + ((i >> 1) & 1) * 8] =
          __float2bfloat16_rn(out[i]);
    }
    __syncthreads();
    for (int idx = tid; idx < TL_BM * 16; idx += TL_THREADS) {
      const int t = idx >> 4, ch = idx & 15;
      const int m = m0 + t;
      if (m < M) {
        const size_t at =
            GROUPED_OUT ? ((n0 >> 7) * static_cast<size_t>(M) + m) * 128 +
                              ch * 8
                        : static_cast<size_t>(m) * NH + n0 + ch * 8;
        *reinterpret_cast<uint4*>(y + at) =
            *reinterpret_cast<const uint4*>(o + t * SW_OUT_LD + ch * 8);
      }
    }
  }  // RIGHT
}

__global__ void __launch_bounds__(TL_THREADS, 1)
w4a4_matmul_i8_swiglu_right_kernel(const int8_t* __restrict__ xq,
                                   const uint8_t* __restrict__ wp,
                                   const float* __restrict__ sx,
                                   const float* __restrict__ sw,
                                   const float* __restrict__ right,
                                   bf16* __restrict__ y, int M, int NH,
                                   int K) {
  swiglu_gemm<true, bf16>(xq, wp, sx, sw, right, y, M, NH, K);
}

__global__ void __launch_bounds__(TL_THREADS, 1)
w4a4_swiglu_grouped_kernel(const int8_t* __restrict__ xq,
                           const uint8_t* __restrict__ wp,
                           const float* __restrict__ sx,
                           const float* __restrict__ sw,
                           const float* __restrict__ right,
                           bf16* __restrict__ y, int M, int NH, int K) {
  swiglu_gemm<true, bf16, false, true>(xq, wp, sx, sw, right, y, M, NH, K);
}

__global__ void __launch_bounds__(TL_THREADS, 1)
w4a4_swiglu_grouped_gx_kernel(const int8_t* __restrict__ xq,
                              const uint8_t* __restrict__ wp,
                              const float* __restrict__ sx,
                              const float* __restrict__ sw,
                              const float* __restrict__ right,
                              bf16* __restrict__ y, int M, int NH, int K) {
  swiglu_gemm<true, bf16, true, true>(xq, wp, sx, sw, right, y, M, NH, K);
}

template <typename OutT>
__global__ void __launch_bounds__(TL_THREADS, 1)
w4a4_matmul_i8_swiglu_kernel(const int8_t* __restrict__ xq,
                             const uint8_t* __restrict__ wp,
                             const float* __restrict__ sx,
                             const float* __restrict__ sw,
                             OutT* __restrict__ y, int M, int NH, int K) {
  swiglu_gemm<false, OutT>(xq, wp, sx, sw, nullptr, y, M, NH, K);
}

// the SMs of the current device, read once
inline int sm_count() {
  static int n = 0;
  if (!n) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 0;
  }
  return n;
}

template <bool GROUPED>
int launch_rmsnorm_right(const void* x, const void* w, const void* right,
                         void* y, int T, int H, float eps, int x_is_f32,
                         cudaStream_t s) {
  if (T == 0) return 0;
  const int nsm = sm_count();
  if (nsm == 0) return static_cast<int>(cudaErrorInvalidDevice);
  // the slab and w in shared memory where they fit a CTA; CTAs an SM as
  // the shared memory allows (at most the launch bounds' 2); whole
  // clusters, one tile each at least
  const int esize = x_is_f32 ? 4 : 2;
  const int staged = 1024 + rn_smem(H, esize, true) <= 232448;
  const int bytes = 1024 + rn_smem(H, esize, staged);
  const int per_sm = 2 * (bytes + 1024) <= 233472 ? 2 : 1;
  const int ntiles = (T + RN_ROWS - 1) / RN_ROWS;
  const int nclusters = per_sm * nsm / RN_CL;
  const int grid = RN_CL * (ntiles < nclusters ? ntiles : nclusters);
  auto w_ = static_cast<const float*>(w);
  auto r_ = static_cast<const bf16*>(right);
  auto y_ = static_cast<bf16*>(y);
  cudaError_t err;
  if (x_is_f32) {
    auto kern = GROUPED ? &rmsnorm_right_grouped_kernel<float>
                        : &rmsnorm_right_flat_kernel<float>;
    static int done = 0;
    err = allow_smem(kern, bytes, &done);
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<grid, RN_THREADS, bytes, s>>>(static_cast<const float*>(x), w_,
                                         r_, y_, T, H, eps, staged);
  } else {
    auto kern = GROUPED ? &rmsnorm_right_grouped_kernel<bf16>
                        : &rmsnorm_right_flat_kernel<bf16>;
    static int done = 0;
    err = allow_smem(kern, bytes, &done);
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<grid, RN_THREADS, bytes, s>>>(static_cast<const bf16*>(x), w_, r_,
                                         y_, T, H, eps, staged);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool GROUPED>
int launch_left_quant(const void* lt, const void* x, const void* clip,
                      void* xq, void* xs, int T, int G, float q_max,
                      cudaStream_t s) {
  if (T == 0) return 0;
  const int nsm = sm_count();
  if (nsm == 0) return static_cast<int>(cudaErrorInvalidDevice);
  // x and the codes as [T][G][128] (dims innermost first) through the
  // layout's strides: token-major [T, G * 128] or group-major [G, T, 128]
  const long long gs = GROUPED ? 128LL * T : 128;
  const long long ts = GROUPED ? 128 : 128LL * G;
  const long long dims[3] = {128, G, T};
  const long long xst[2] = {2 * gs, 2 * ts}, qst[2] = {gs, ts};
  CUtensorMap xmap, qmap;
  if (!tensor_map_nd(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, 3, dims,
                     xst, 64, lq_kpad(G)) ||
      !tensor_map_nd(&qmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, xq, 3, dims, qst,
                     128, G))
    return static_cast<int>(cudaErrorInvalidValue);
  const int mt = G > 64 ? 2 : 1;
  const int fixed = lq_fixed_smem(G, mt);
  // a multiple of the warpgroups, so that a slot's previous token was
  // the same warpgroup's (its barrier phase then cannot be a lap behind)
  const int nwg = mt == 2 ? lq_nwg<2>() : lq_nwg<1>();
  int stages = (232448 - fixed) / lq_slab_bytes(G);
  stages = (stages < LQ_MAX_STAGES ? stages : LQ_MAX_STAGES) / nwg * nwg;
  const int bytes = fixed + stages * lq_slab_bytes(G);
  auto kern = mt == 2 ? (GROUPED ? &left_quant_i8_grouped_kernel<2>
                                 : &left_quant_i8_flat_kernel<2>)
                      : (GROUPED ? &left_quant_i8_grouped_kernel<1>
                                 : &left_quant_i8_flat_kernel<1>);
  static int done[2] = {0, 0};
  cudaError_t err = allow_smem(kern, bytes, &done[mt - 1]);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<T < nsm ? T : nsm, mt == 2 ? lq_threads<2>() : lq_threads<1>(),
         bytes, s>>>(
      xmap, qmap, static_cast<const bf16*>(lt),
      static_cast<const float*>(clip), static_cast<float*>(xs), G, T, stages,
      q_max);
  return static_cast<int>(cudaGetLastError());
}

template <bool GROUPED>
int launch_swiglu_right(const void* xq, const void* wp, const void* sx,
                        const void* sw, const void* right, void* y, int M,
                        int NH, int K, bool x_grouped, cudaStream_t s) {
  auto kern = !GROUPED   ? &w4a4_matmul_i8_swiglu_right_kernel
              : x_grouped ? &w4a4_swiglu_grouped_gx_kernel
                          : &w4a4_swiglu_grouped_kernel;
  static int done[2] = {0, 0};
  cudaError_t err = allow_smem(kern, SW_SMEM, &done[x_grouped]);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((M + TL_BM - 1) / TL_BM, NH / TL_BN);
  kern<<<grid, TL_THREADS, SW_SMEM, s>>>(
      static_cast<const int8_t*>(xq), static_cast<const uint8_t*>(wp),
      static_cast<const float*>(sx), static_cast<const float*>(sw),
      static_cast<const float*>(right), static_cast<bf16*>(y), M, NH, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [T, H] bf16 (x_is_f32 = 0) or f32; w f32 [H]; right bf16 [128, 128];
// y bf16 [T, H]. H % 128 == 0; x and w 16-byte aligned (checked in
// Python).
extern "C" int fq_rmsnorm_right_flat(const void* x, const void* w,
                                     const void* right, void* y, int T,
                                     int H, float eps, int x_is_f32,
                                     void* stream) {
  return launch_rmsnorm_right<false>(x, w, right, y, T, H, eps, x_is_f32,
                                     static_cast<cudaStream_t>(stream));
}

// fq_rmsnorm_right_flat with y bf16 [H / 128, T, 128].
extern "C" int fq_rmsnorm_right_grouped(const void* x, const void* w,
                                        const void* right, void* y, int T,
                                        int H, float eps, int x_is_f32,
                                        void* stream) {
  return launch_rmsnorm_right<true>(x, w, right, y, T, H, eps, x_is_f32,
                                    static_cast<cudaStream_t>(stream));
}

// lt bf16 [G, G] (left_t); x bf16 [T, G*128]; clip f32 [2] (cmax, cmin);
// xq int8 [T, G*128]; xs f32 [T]. 0 < G <= 128 (checked in Python); x and
// xq 16-byte aligned.
extern "C" int fq_left_quant_i8_flat(const void* lt, const void* x,
                                     const void* clip, void* xq, void* xs,
                                     int T, int G, float q_max,
                                     void* stream) {
  return launch_left_quant<false>(lt, x, clip, xq, xs, T, G, q_max,
                                  static_cast<cudaStream_t>(stream));
}

// fq_left_quant_i8_flat with x bf16 and xq int8 [G, T, 128].
extern "C" int fq_left_quant_i8_grouped(const void* lt, const void* x,
                                        const void* clip, void* xq, void* xs,
                                        int T, int G, float q_max,
                                        void* stream) {
  return launch_left_quant<true>(lt, x, clip, xq, xs, T, G, q_max,
                                 static_cast<cudaStream_t>(stream));
}

// xq int8 [M, K]; wp uint8 [2*NH, K/2] planar (up rows, then gate rows);
// sx f32 [M]; sw f32 [2*NH]; right f32 [128, 128] (bf16 values);
// y bf16 [M, NH]. NH % 128 == 0 and K % 64 == 0 (checked in Python).
extern "C" int fq_w4a4_matmul_i8_swiglu_right(const void* xq, const void* wp,
                                              const void* sx, const void* sw,
                                              const void* right, void* y,
                                              int M, int NH, int K,
                                              void* stream) {
  return launch_swiglu_right<false>(xq, wp, sx, sw, right, y, M, NH, K,
                                    false, static_cast<cudaStream_t>(stream));
}

// fq_w4a4_matmul_i8_swiglu_right with y bf16 [NH / 128, M, 128] and, with
// x_grouped, xq int8 [K / 128, M, 128].
extern "C" int fq_w4a4_swiglu_grouped(const void* xq, const void* wp,
                                      const void* sx, const void* sw,
                                      const void* right, void* y, int M,
                                      int NH, int K, int x_grouped,
                                      void* stream) {
  return launch_swiglu_right<true>(xq, wp, sx, sw, right, y, M, NH, K,
                                   x_grouped != 0,
                                   static_cast<cudaStream_t>(stream));
}

// xq int8 [M, K]; wp uint8 [2*NH, K/2] planar (up rows, then gate rows);
// sx f32 [M]; sw f32 [2*NH]; y [M, NH] bf16 (out_is_f32 = 0) or f32.
// NH % 128 == 0 and K % 64 == 0 (checked in Python).
extern "C" int fq_w4a4_matmul_i8_swiglu(const void* xq, const void* wp,
                                        const void* sx, const void* sw,
                                        void* y, int M, int NH, int K,
                                        int out_is_f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((M + TL_BM - 1) / TL_BM, NH / TL_BN);
  auto x_ = static_cast<const int8_t*>(xq);
  auto w_ = static_cast<const uint8_t*>(wp);
  auto a_ = static_cast<const float*>(sx);
  auto b_ = static_cast<const float*>(sw);
  cudaError_t err;
  if (out_is_f32) {
    auto kern = w4a4_matmul_i8_swiglu_kernel<float>;
    static int done = 0;
    err = allow_smem(kern, SW_SMEM, &done);
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<grid, TL_THREADS, SW_SMEM, s>>>(x_, w_, a_, b_,
                                           static_cast<float*>(y), M, NH, K);
  } else {
    auto kern = w4a4_matmul_i8_swiglu_kernel<bf16>;
    static int done = 0;
    err = allow_smem(kern, SW_SMEM, &done);
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<grid, TL_THREADS, SW_SMEM, s>>>(x_, w_, a_, b_,
                                           static_cast<bf16*>(y), M, NH, K);
  }
  return static_cast<int>(cudaGetLastError());
}
