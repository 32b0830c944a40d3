// attn_prologue: qkv split + RoPE + K-space head transforms + asym-int4
// K/V quantize and pack, in one pass over the merged qkv GEMM output.
//
// Replaces: flatquant_tpu/kernels/attn_prologue.py:attn_prologue (Pallas).
//
//   q_rot[b, s, h]  = dt(rope(q[b, s, h]) @ k_t_inv)        (f32 sums)
//   k_rot[b, s, h]  = dt(rope(k[b, s, h]) @ k_t)
//   K/V codes, params: asym int4 per (token, head) of k_rot and of the raw
//   v, written token-major into the cache at positions [pos, pos + S)
//   rope(x) = x * cos + rotate_half(x) * sin, in dt (qkv's dtype) with a
//   rounding after each op; cos, sin, k_t, k_t_inv hold bf16 values.
//
// What bounds it on the H100: bytes. At B=4, S=512, 32/32 heads it reads
// the 50 MB qkv and writes q_rot and k_rot (34 MB) and the packed cache
// (9 MB): ~28 us at 3.35 TB/s. The head products are 2 * 2048 * 64 *
// 128^2 = 4.3 GFLOP: 4.3 us on the tensor cores in bf16, ~64 us on the
// CUDA cores in float32.
//
// Two bodies (kernels/attn_prologue.py prologue_body picks one):
//
// bf16 qkv, attn_prologue_mma_kernel: the products on the tensor cores
// (wgmma bf16 with float32 sums, as the JAX kernel's MXU dots), so the
// body is bound by its memory traffic. Each head's 64-token slice comes
// by TMA on a ring, every byte of qkv read once; RoPE runs in registers
// in the products' A-fragment layout; outputs leave through staging tiles
// as 16-byte stores. Details above the kernel.
//
// float32 qkv, attn_prologue_kernel: its rope outputs are not bf16
// values, so they are no bf16 operands; the products run on the CUDA
// cores in float32. A block owns PRO_BT tokens of one sequence and a
// slice of the heads (heads z, z + gridDim.z, ...): first its q heads
// against k_t_inv, then its k heads against k_t, then its v heads
// (quantize only), so it loads each 128x128 matrix into shared memory
// once. Thread c owns column c: it ropes column c of the PRO_BT tokens
// into a shared tile and sums its output column over d in order (PRO_BT
// accumulators). For K and V a warp then quantizes 8 tokens: a lane holds
// columns lane + 32i, so the planar pair (c, c + 64) sits in one lane and
// packs without a shuffle.

#include <cuda_bf16.h>

#include "common.cuh"
#include "mma.cuh"
#include "tma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int PRO_BT = 32;  // tokens per block
constexpr int PRO_THREADS = 128;
constexpr int PRO_SMEM = (128 * 128 + PRO_BT * 128) * 4;

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<bf16>(bf16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// a value rounded to T, as float
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return to_f<T>(from_f<T>(v));
}

// asym int4 of one token's head (values in smem row `v`, 128 floats) by
// one warp: codes byte c = q[c] | q[c + 64] << 4, params (scale, zero).
// The arithmetic is kv_cache.quantize_pack_kv's, op for op.
__device__ __forceinline__ void quant_pack_row(const float* v, float cmax,
                                               float cmin, uint8_t* codes,
                                               float* params, int lane) {
  float x[4];
  float mx = 0.f, mn = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[i] = v[lane + 32 * i];
    mx = fmaxf(mx, x[i]);
    mn = fminf(mn, x[i]);
  }
  float tmax = __fmul_rn(warp_max(mx), cmax);
  float tmin = __fmul_rn(-warp_max(-mn), cmin);
  if (tmin == 0.f && tmax == 0.f) {
    tmin = -1.f;
    tmax = 1.f;
  }
  const float scale = __fsub_rn(tmax, tmin) / 15.0f;
  const float zero = rintf(-tmin / scale);
  int q[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    q[i] = static_cast<int>(
        fminf(fmaxf(__fadd_rn(rintf(x[i] / scale), zero), 0.f), 15.f));
  codes[lane] = static_cast<uint8_t>(q[0] | (q[2] << 4));
  codes[lane + 32] = static_cast<uint8_t>(q[1] | (q[3] << 4));
  if (lane == 0) *reinterpret_cast<float2*>(params) = make_float2(scale, zero);
}

template <typename T>
__global__ void __launch_bounds__(PRO_THREADS)
attn_prologue_kernel(const T* __restrict__ qkv, const bf16* __restrict__ cs,
                     const bf16* __restrict__ sn,
                     const float* __restrict__ kt,
                     const float* __restrict__ kti,
                     const float* __restrict__ clip, T* __restrict__ q_out,
                     T* __restrict__ k_out, uint8_t* __restrict__ kc,
                     float* __restrict__ kpar, uint8_t* __restrict__ vc,
                     float* __restrict__ vpar, int S, int nh, int nkv,
                     int L, int pos) {
  extern __shared__ float4 smem4[];
  float* mat = reinterpret_cast<float*>(smem4);  // [128][128]
  float* tile = mat + 128 * 128;                  // [PRO_BT][128]
  const int c = threadIdx.x;
  const int lane = c & 31, warp = c >> 5;
  const int s0 = blockIdx.x * PRO_BT;
  const int b = blockIdx.y;
  const int D = (nh + 2 * nkv) * 128;
  const int nt = min(PRO_BT, S - s0);
  const T* base = qkv + (static_cast<size_t>(b) * S + s0) * D;
  const int partner = c ^ 64;
  const bool low = c < 64;

  // quantize the tile's tokens (head h of K or V) into the cache
  auto quant_tile = [&](int h, uint8_t* codes, float* params, float cmax,
                        float cmin) {
    for (int t = warp; t < nt; t += PRO_THREADS / 32) {
      const size_t row = (static_cast<size_t>(b) * nkv + h) * L + pos + s0 +
                         t;
      quant_pack_row(tile + t * 128, cmax, cmin, codes + row * 64,
                     params + row * 2, lane);
    }
  };

  for (int pass = 0; pass < 2; ++pass) {  // q heads, then k heads
    const int nheads = pass == 0 ? nh : nkv;
    if (blockIdx.z >= nheads) continue;
    __syncthreads();  // the previous pass is done with mat
    const float* m = pass == 0 ? kti : kt;
    for (int i = c; i < 128 * 128 / 4; i += PRO_THREADS)
      smem4[i] = reinterpret_cast<const float4*>(m)[i];
    for (int h = blockIdx.z; h < nheads; h += gridDim.z) {
      const int off = (pass == 0 ? 0 : nh * 128) + h * 128;
      for (int t = 0; t < PRO_BT; ++t) {
        float y = 0.f;
        if (t < nt) {
          const T* xr = base + static_cast<size_t>(t) * D + off;
          const float x = to_f<T>(xr[c]);
          const float xp = to_f<T>(xr[partner]);
          const float rh = low ? -xp : xp;
          const float co = __bfloat162float(cs[(s0 + t) * 128 + c]);
          const float si = __bfloat162float(sn[(s0 + t) * 128 + c]);
          y = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(x, co)),
                               rnd<T>(__fmul_rn(rh, si))));
        }
        tile[t * 128 + c] = y;
      }
      __syncthreads();
      float acc[PRO_BT];
#pragma unroll
      for (int t = 0; t < PRO_BT; ++t) acc[t] = 0.f;
      for (int d = 0; d < 128; d += 4) {
        const float m0 = mat[(d + 0) * 128 + c], m1 = mat[(d + 1) * 128 + c];
        const float m2 = mat[(d + 2) * 128 + c], m3 = mat[(d + 3) * 128 + c];
#pragma unroll
        for (int t = 0; t < PRO_BT; ++t) {
          const float4 a = *reinterpret_cast<const float4*>(tile + t * 128 +
                                                            d);
          acc[t] = fmaf(a.x, m0, acc[t]);
          acc[t] = fmaf(a.y, m1, acc[t]);
          acc[t] = fmaf(a.z, m2, acc[t]);
          acc[t] = fmaf(a.w, m3, acc[t]);
        }
      }
      __syncthreads();  // every thread is done reading the tile
      T* out = pass == 0 ? q_out : k_out;
      const int width = (pass == 0 ? nh : nkv) * 128;
#pragma unroll
      for (int t = 0; t < PRO_BT; ++t) {
        if (t < nt) {
          const T o = from_f<T>(acc[t]);
          out[(static_cast<size_t>(b) * S + s0 + t) * width + h * 128 + c] =
              o;
          tile[t * 128 + c] = to_f<T>(o);
        }
      }
      if (pass == 1) {
        __syncthreads();
        quant_tile(h, kc, kpar, clip[0], clip[1]);
      }
      __syncthreads();  // the tile is reused by the next head
    }
  }

  // v heads: quantize the raw values
  for (int h = blockIdx.z; h < nkv; h += gridDim.z) {
    const int off = (nh + nkv) * 128 + h * 128;
    for (int t = 0; t < nt; ++t)
      tile[t * 128 + c] = to_f<T>(base[static_cast<size_t>(t) * D + off + c]);
    __syncthreads();
    quant_tile(h, vc, vpar, clip[2], clip[3]);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// the bf16 body: head products on wgmma, qkv by TMA
// ---------------------------------------------------------------------------

// head slices in flight: 3 was timed on the card and cost a block an SM
// (PERF.md)
constexpr int PM_STAGES = 2;
constexpr int PM_BT = 64;        // tokens per block: 4 warps x 16
constexpr int PM_THREADS = 128;  // one warpgroup
constexpr int PM_SLOT = PM_BT * 256;  // one head [2 halves][64 tok][128 B]
constexpr int PM_MAT = 128 * 256;     // M^T [2 halves][128 n][128 B]
constexpr int PM_OUT = PM_BT * 256;   // output rows, [64][256 B] swizzled
constexpr int PM_CODES = PM_BT * 64;  // packed codes [64][64 B]
constexpr int PM_STAGE_OUT = PM_OUT + PM_CODES + PM_BT * 8;  // + params
// + 1024: the swizzled tiles start at a multiple of 1024 bytes; the
// output staging is double-buffered
constexpr int PM_SMEM = 1024 + PM_MAT + PM_STAGES * PM_SLOT +
                        2 * PM_STAGE_OUT + (PM_STAGES + 1) * 8;

// asym int4 of one token row held by a quad (each thread: 16 planar-low
// values lo[J][e] at columns 8J + 2tq + e and their partners hi, 64
// columns on): the row's max and min by quad shuffles, then
// quant_pack_row's arithmetic op for op. Bytes 8J + 2tq + e of `codes`;
// (scale, zero) into par by the quad's first thread.
__device__ __forceinline__ void quant_quad(const float (&lo)[8][2],
                                           const float (&hi)[8][2],
                                           float cmax, float cmin,
                                           uint8_t* codes, float* par,
                                           int tq) {
  float mx = 0.f, mn = 0.f;
#pragma unroll
  for (int J = 0; J < 8; ++J)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      mx = fmaxf(mx, fmaxf(lo[J][e], hi[J][e]));
      mn = fminf(mn, fminf(lo[J][e], hi[J][e]));
    }
  float tmax = __fmul_rn(quad_max(mx), cmax);
  float tmin = __fmul_rn(-quad_max(-mn), cmin);
  if (tmin == 0.f && tmax == 0.f) {
    tmin = -1.f;
    tmax = 1.f;
  }
  const float scale = __fsub_rn(tmax, tmin) / 15.0f;
  const float zero = rintf(-tmin / scale);
  auto code = [&](float x) {
    return static_cast<unsigned>(
        fminf(fmaxf(__fadd_rn(rintf(x / scale), zero), 0.f), 15.f));
  };
#pragma unroll
  for (int J = 0; J < 8; ++J) {
    const unsigned b0 = code(lo[J][0]) | (code(hi[J][0]) << 4);
    const unsigned b1 = code(lo[J][1]) | (code(hi[J][1]) << 4);
    *reinterpret_cast<unsigned short*>(codes + 8 * J + 2 * tq) =
        static_cast<unsigned short>(b0 | (b1 << 8));
  }
  if (tq == 0) *reinterpret_cast<float2*>(par) = make_float2(scale, zero);
}

// Block (blockIdx.x: token tiles of 64; y: batch; z: head groups -- the
// first ceil(nh / qh) take qh q heads against k_t_inv, the rest kvh k
// heads against k_t and then as many v heads; kernels/attn_prologue.py
// prologue_heads picks qh and kvh). One
// warpgroup, warp w on tokens 16w .. 16w + 15. M^T (bf16, the product's B,
// K-major) comes into shared memory once by TMA; each head's [64 tok][128] slice
// of qkv comes by TMA (two 128-byte-swizzled boxes) on a PM_STAGES-deep
// ring, and ldmatrix gives each warp its rows as the A fragments of
// m16n8k16 (= wgmma's register A per warp). RoPE runs in registers: column
// c and its rotate_half partner c ^ 64 sit in the same register slot of
// k-steps kk and kk ^ 4 (sign - for kk < 4). The product is 8 wgmma
// m64n128k16 with float32 sums. q_rot / k_rot rows go out through a
// swizzled staging tile as 16-byte stores; K is quantized from the
// rounded k_rot in the accumulators' layout, V from the raw values in the
// A layout (columns 8J + 2tq + e in both), codes staged for 16-byte
// stores. cos / sin live in registers, in the A fragments' layout.
// xmap: qkv as [B][S][D] bf16, boxes of 64 columns x 64 tokens; mtmap,
// mtimap: k_t^T and k_t_inv^T as [128][128] bf16, boxes of 64 x 128.
__global__ void __launch_bounds__(PM_THREADS, 2)
attn_prologue_mma_kernel(const __grid_constant__ CUtensorMap xmap,
                         const __grid_constant__ CUtensorMap mtmap,
                         const __grid_constant__ CUtensorMap mtimap,
                         const bf16* __restrict__ cs,
                         const bf16* __restrict__ sn,
                         const float* __restrict__ clip,
                         bf16* __restrict__ q_out, bf16* __restrict__ k_out,
                         uint8_t* __restrict__ kc, float* __restrict__ kpar,
                         uint8_t* __restrict__ vc, float* __restrict__ vpar,
                         int S, int nh, int nkv, int L, int pos, int qh,
                         int kvh) {
  extern __shared__ __align__(16) uint8_t pm_raw[];
  uint8_t* mat = pm_raw + ((1024 - (smem_u32(pm_raw) & 1023)) & 1023);
  uint8_t* ring = mat + PM_MAT;
  uint8_t* staging = ring + PM_STAGES * PM_SLOT;  // [2][PM_STAGE_OUT]
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + 2 * PM_STAGE_OUT);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, tq = lane & 3;
  const int s0 = blockIdx.x * PM_BT, b = blockIdx.y;
  const int nt = min(PM_BT, S - s0);
  const int gq = (nh + qh - 1) / qh;
  const bool is_q = static_cast<int>(blockIdx.z) < gq;
  const int g = is_q ? blockIdx.z : blockIdx.z - gq;
  // the block's jobs: q heads, or k heads then v heads
  const int h0 = g * (is_q ? qh : kvh);
  const int nheads = min(is_q ? qh : kvh, (is_q ? nh : nkv) - h0);
  const int njobs = is_q ? nheads : 2 * nheads;
  auto job_col = [&](int c) {  // qkv column of job c's head
    if (is_q) return (h0 + c) * 128;
    return c < nheads ? (nh + h0 + c) * 128
                      : (nh + nkv + h0 + c - nheads) * 128;
  };

  uint64_t* mfull = full + PM_STAGES;  // M^T's transfer
  if (tid == 0) {
    for (int st = 0; st <= PM_STAGES; ++st) mbar_init(full + st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto load = [&](int c) {  // thread 0: job c's slice into its slot
    const int slot = c % PM_STAGES;
    uint8_t* d = ring + slot * PM_SLOT;
    mbar_expect_tx(full + slot, PM_SLOT);
    tma_load(d, &xmap, job_col(c), s0, b, full + slot);
    tma_load(d + PM_BT * 128, &xmap, job_col(c) + 64, s0, b, full + slot);
  };
  if (tid == 0) {  // M^T in two 128-byte-swizzled halves of 64 k
    const CUtensorMap* mm = is_q ? &mtimap : &mtmap;
    mbar_expect_tx(mfull, PM_MAT);
    tma_load(mat, mm, 0, 0, 0, mfull);
    tma_load(mat + 16384, mm, 64, 0, 0, mfull);
    for (int c = 0; c < PM_STAGES && c < njobs; ++c) load(c);
  }
  // cos / sin of this thread's fragment positions: rows r0, r0 + 8, columns
  // 16kk + 2tq (slots 0, 1) and 16kk + 8 + 2tq (slots 2, 3)
  const int r0 = warp * 16 + g8;
  unsigned cf[8][4], sf[8][4];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int t = r0 + ((f & 1) ? 8 : 0);
      const int col = 16 * kk + ((f & 2) ? 8 : 0) + 2 * tq;
      const size_t at = static_cast<size_t>(s0 + t) * 128 + col;
      cf[kk][f] = t < nt ? *reinterpret_cast<const unsigned*>(cs + at) : 0u;
      sf[kk][f] = t < nt ? *reinterpret_cast<const unsigned*>(sn + at) : 0u;
    }
  mbar_wait(mfull, 0);

  const float kcmax = clip[0], kcmin = clip[1];
  const float vcmax = clip[2], vcmin = clip[3];
  float acc[64];
  unsigned a[8][4];
  for (int c = 0; c < njobs; ++c) {
    const int slot = c % PM_STAGES;
    const bool is_v = !is_q && c >= nheads;
    const int h = is_q ? h0 + c : h0 + (is_v ? c - nheads : c);
    // job c's output rows, codes and params (double-buffered: job c + 2
    // writes here only after every thread has passed job c + 1's barrier,
    // so after its stores of job c)
    uint8_t* ost = staging + (c & 1) * PM_STAGE_OUT;
    uint8_t* cst = ost + PM_OUT;
    float* pst = reinterpret_cast<float*>(cst + PM_CODES);  // [64][2]
    mbar_wait(full + slot, (c / PM_STAGES) & 1);
    {  // this warp's 16 rows as A fragments of the 8 k-steps
      const int row = warp * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
      const uint8_t* base = ring + slot * PM_SLOT + row * 128;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const int ch = (kk & 3) * 2 + (lane >> 4);
        ldmatrix_x4(a[kk], reinterpret_cast<const bf16*>(
                               base + (kk >> 2) * (PM_BT * 128) +
                               ((ch ^ (row & 7)) << 4)));
      }
    }
    fence_proxy_async();  // the reads before the TMA's refill

    float lo[2][8][2], hi[2][8][2];  // each row's planar pairs, for quant
    if (!is_v) {
      // rope(x) = x * cos + rotate_half(x) * sin, rounded to bf16 after
      // each op: partner of (kk, f) is (kk ^ 4, f), negated for kk < 4
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const float2 xl = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&a[kk][f]));
          const float2 xh = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&a[kk + 4][f]));
          auto rope = [&](float x, float rh, unsigned cc, unsigned ss,
                          int e) {
            const float co = __bfloat162float(
                reinterpret_cast<const bf16*>(&cc)[e]);
            const float si = __bfloat162float(
                reinterpret_cast<const bf16*>(&ss)[e]);
            return rnd<bf16>(__fadd_rn(rnd<bf16>(__fmul_rn(x, co)),
                                       rnd<bf16>(__fmul_rn(rh, si))));
          };
          const float yl0 = rope(xl.x, -xh.x, cf[kk][f], sf[kk][f], 0);
          const float yl1 = rope(xl.y, -xh.y, cf[kk][f], sf[kk][f], 1);
          const float yh0 = rope(xh.x, xl.x, cf[kk + 4][f], sf[kk + 4][f], 0);
          const float yh1 = rope(xh.y, xl.y, cf[kk + 4][f], sf[kk + 4][f], 1);
          a[kk][f] = pack_bf16(yl0, yl1);
          a[kk + 4][f] = pack_bf16(yh0, yh1);
        }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        Wgmma<128>::mma(acc, a[kk],
                        sw128_desc(mat + (kk >> 2) * 16384 + (kk & 3) * 32),
                        kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_f32<64>(acc);
      fence_u32<32>(&a[0][0]);
      // acc[4j + e]: row r0 + 8 (e >> 1), column 8j + 2tq + (e & 1):
      // rounded to bf16, staged (16-byte chunk j of row r at j ^ (r % 8))
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          const int r = r0 + 8 * rh;
          const unsigned pr = pack_bf16(acc[4 * j + 2 * rh],
                                        acc[4 * j + 2 * rh + 1]);
          *reinterpret_cast<unsigned*>(ost + r * 256 +
                                       ((j ^ (r & 7)) << 4) + tq * 4) = pr;
          const float2 v = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&pr));
          if (j < 8) {
            lo[rh][j][0] = v.x;
            lo[rh][j][1] = v.y;
          } else {
            hi[rh][j - 8][0] = v.x;
            hi[rh][j - 8][1] = v.y;
          }
        }
    } else {
      // the raw v in the A layout: slot f of k-step kk holds row r0 + 8
      // (f & 1), columns 16kk + 8 (f >> 1) + 2tq + e = 8J + 2tq + e with
      // J = 2kk + (f >> 1)
#pragma unroll
      for (int J = 0; J < 8; ++J)
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          const int f = 2 * (J & 1) + rh;
          const float2 xl = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&a[J >> 1][f]));
          const float2 xh = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&a[(J >> 1) + 4][f]));
          lo[rh][J][0] = xl.x;
          lo[rh][J][1] = xl.y;
          hi[rh][J][0] = xh.x;
          hi[rh][J][1] = xh.y;
        }
    }
    if (!is_q) {
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const int r = r0 + 8 * rh;
        quant_quad(lo[rh], hi[rh], is_v ? vcmax : kcmax, is_v ? vcmin : kcmin,
                   cst + r * 64, pst + 2 * r, tq);
      }
    }
    __syncthreads();  // the staged rows are complete, the slot read
    if (tid == 0 && c + PM_STAGES < njobs) load(c + PM_STAGES);
    if (!is_v) {
      const int width = (is_q ? nh : nkv) * 128;
      bf16* o = (is_q ? q_out : k_out) +
                static_cast<size_t>(b) * S * width + h * 128;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int idx = tid + i * PM_THREADS;
        const int r = idx >> 4, ch = idx & 15;
        if (r < nt)
          *reinterpret_cast<uint4*>(o + static_cast<size_t>(s0 + r) * width +
                                    ch * 8) =
              *reinterpret_cast<const uint4*>(ost + r * 256 +
                                              ((ch ^ (r & 7)) << 4));
      }
    }
    if (!is_q) {
      const size_t row = (static_cast<size_t>(b) * nkv + h) * L + pos + s0;
      uint8_t* cd = (is_v ? vc : kc) + row * 64;
      float* pd = (is_v ? vpar : kpar) + row * 2;
      for (int i = tid; i < nt * 4; i += PM_THREADS)
        reinterpret_cast<uint4*>(cd)[i] = reinterpret_cast<const uint4*>(cst)[i];
      if (tid < nt)
        reinterpret_cast<float2*>(pd)[tid] =
            reinterpret_cast<const float2*>(pst)[tid];
    }
  }
}

}  // namespace

// qkv [B, S, (nh + 2 nkv) * 128] bf16 (is_f32 = 0) or f32; cos/sin bf16
// [S, 128]; kt/kti f32 [128, 128] (bf16 values); clip f32 [4] (k cmax,
// k cmin, v cmax, v cmin); q_out [B, S, nh*128], k_out [B, S, nkv*128] in
// qkv's dtype; kc/vc uint8 [B, nkv, L, 64] and kpar/vpar f32
// [B, nkv, L, 2], written at positions [pos, pos + S).
extern "C" int fq_attn_prologue(const void* qkv, const void* cs,
                                const void* sn, const void* kt,
                                const void* kti, const void* clip,
                                void* q_out, void* k_out, void* kc,
                                void* kpar, void* vc, void* vpar, int B,
                                int S, int nh, int nkv, int L, int pos,
                                int is_f32, void* stream) {
  const int heads = nh > nkv ? nh : nkv;
  dim3 grid((S + PRO_BT - 1) / PRO_BT, B, heads < 8 ? heads : 8);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto c_ = static_cast<const bf16*>(cs);
  auto s_ = static_cast<const bf16*>(sn);
  auto kt_ = static_cast<const float*>(kt);
  auto kti_ = static_cast<const float*>(kti);
  auto cl_ = static_cast<const float*>(clip);
  auto kc_ = static_cast<uint8_t*>(kc);
  auto kp_ = static_cast<float*>(kpar);
  auto vc_ = static_cast<uint8_t*>(vc);
  auto vp_ = static_cast<float*>(vpar);
  // opt into PRO_SMEM of dynamic shared memory once per instantiation, so
  // a launch inside a CUDA graph capture makes no other runtime call
  static bool ready[2] = {false, false};
  if (!ready[is_f32 ? 1 : 0]) {
    const cudaError_t err =
        is_f32 ? cudaFuncSetAttribute(
                     attn_prologue_kernel<float>,
                     cudaFuncAttributeMaxDynamicSharedMemorySize, PRO_SMEM)
               : cudaFuncSetAttribute(
                     attn_prologue_kernel<bf16>,
                     cudaFuncAttributeMaxDynamicSharedMemorySize, PRO_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[is_f32 ? 1 : 0] = true;
  }
  if (is_f32) {
    attn_prologue_kernel<float><<<grid, PRO_THREADS, PRO_SMEM, s>>>(
        static_cast<const float*>(qkv), c_, s_, kt_, kti_, cl_,
        static_cast<float*>(q_out), static_cast<float*>(k_out), kc_, kp_,
        vc_, vp_, S, nh, nkv, L, pos);
  } else {
    attn_prologue_kernel<bf16><<<grid, PRO_THREADS, PRO_SMEM, s>>>(
        static_cast<const bf16*>(qkv), c_, s_, kt_, kti_, cl_,
        static_cast<bf16*>(q_out), static_cast<bf16*>(k_out), kc_, kp_, vc_,
        vp_, S, nh, nkv, L, pos);
  }
  return static_cast<int>(cudaGetLastError());
}

// the bf16 body: qkv [B, S, (nh + 2 nkv) * 128] bf16 (16-byte aligned);
// cos/sin bf16 [S, 128]; mt / mti: k_t^T and k_t_inv^T, bf16 [128, 128]
// contiguous and 16-byte aligned; qh q heads or kvh k and v heads a
// block; the other arguments as fq_attn_prologue's
extern "C" int fq_attn_prologue_mma(const void* qkv, const void* cs,
                                    const void* sn, const void* mt,
                                    const void* mti, const void* clip,
                                    void* q_out, void* k_out, void* kc,
                                    void* kpar, void* vc, void* vpar, int B,
                                    int S, int nh, int nkv, int L, int pos,
                                    int qh, int kvh, void* stream) {
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        attn_prologue_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        PM_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  const long long D = static_cast<long long>(nh + 2 * nkv) * 128;
  CUtensorMap xmap, mtmap, mtimap;
  if (!tensor_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, qkv, D, S, B,
                  D * S, 64, PM_BT) ||
      !tensor_map(&mtmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, mt, 128, 128,
                  1, 128 * 128, 64, 128) ||
      !tensor_map(&mtimap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, mti, 128, 128,
                  1, 128 * 128, 64, 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const int groups = (nh + qh - 1) / qh + (nkv + kvh - 1) / kvh;
  dim3 grid((S + PM_BT - 1) / PM_BT, B, groups);
  attn_prologue_mma_kernel<<<grid, PM_THREADS, PM_SMEM,
                             static_cast<cudaStream_t>(stream)>>>(
      xmap, mtmap, mtimap, static_cast<const bf16*>(cs),
      static_cast<const bf16*>(sn), static_cast<const float*>(clip), static_cast<bf16*>(q_out),
      static_cast<bf16*>(k_out), static_cast<uint8_t*>(kc),
      static_cast<float*>(kpar), static_cast<uint8_t*>(vc),
      static_cast<float*>(vpar), S, nh, nkv, L, pos, qh, kvh);
  return static_cast<int>(cudaGetLastError());
}
