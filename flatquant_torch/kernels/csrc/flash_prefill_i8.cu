// flash_prefill_i8: causal GQA flash attention with int8 score products,
// bf16 in and out, head_dim 128 (kernels/prefill_attention.py
// flash_prefill_attention_kt_i8).
//
// Replaces: flatquant_tpu/kernels/prefill_attention.py
//   flash_prefill_attention_kt_i8 (Pallas; a measured baseline there, the
//   int8-MXU variant of flash_prefill_attention_kt), both pv_i8 modes.
//
// The function, JAX's to the rounding point:
//   per (batch, kv head): ks = max(max|K|, 1e-30), vs = max(max|V|,
//     1e-30) over the whole prompt; K8 = clip(rint(K * (127 / ks)), -127,
//     127), V8 likewise; sc = (ks / 127, vs / (127 * 127)).
//   per query row: qf = q * (sm_scale * log2 e) in float32, qa =
//     max(max|qf|, 1e-30), Q8 = clip(rint(qf * (127 / qa)), -127, 127),
//     s_scale = qa * (sc[0] / 127).
//   over key blocks of blk_k (JAX's 512, shrunk to a divisor of S), in
//   order: s = float(Q8 . K8) * s_scale, -inf above the diagonal;
//   m' = max(m, max_block s); p = exp2(s - m'); corr = exp2(m - m');
//   l = l * corr + sum_block p; with pv_i8, acc = acc * corr +
//   float(round(p * 127) . V8) * sc[1] (int32 sums over the block), else
//   acc = acc * corr + bf16(p) . V (float32 sums); o = acc / max(l,
//   1e-30) in bf16.
// p is rounded (to int8, or to bf16) against the running max of its key
// block, so the function depends on blk_k: the kernel takes each block's
// row maxima before it forms any p of the block, and its p, codes and
// int32 sums equal the plain version's wherever the two exp2 agree. Only
// the float32 sums of l (and, without pv_i8, of p.V) run in another order.
//
// What bounds it on the H100: operations. At llama-2-7b's 1 x 2048
// prefill (32 heads) the causal products are 2 * S * (S + 1) * 128 * 32 =
// 34.4 G operations: 17.4 us all in int8 at 1,979 TOP/s, 26 us with the PV
// half in bf16 at 989 TFLOP/s; the bytes (q, k, v read, o written, 67 MB)
// take 20 us at 3.35 TB/s. Taking each block's maxima first computes
// Q8 K8^T twice, which at the int8 rate costs what one bf16 product does.
//
// Design: the prepass, then row 8's wgmma body (flash_prefill.cu).
// (1) The prepass in two launches over (token chunk of 128, kv head,
//   batch), 16 x nkv x B blocks at S = 2048 (the first design's one block
//   per head left 100 of 132 SMs idle): kv_amax_i8_kernel writes each
//   chunk's max|K| and max|V|; kv_codes_i8_kernel reduces a head's chunks
//   (max is exact in any order, so the scales and codes stay bit for bit
//   quantize_kv_i8_ref's), writes K8 token-major [B, nkv, S, 128] and V8
//   transposed [B, nkv, 128, S] (4 x 4 byte blocks transposed in
//   registers, 32-bit words through a swizzled shared tile), with the
//   keys of every 32-key group in the order the PV product's register A
//   wants (below), so that TMA reads the tile as it is.
// (2) flash_i8_kernel: a block owns 128 query rows of one (batch, query
//   head): two consumer warpgroups of 64 rows and a producer warp that
//   streams K8 tiles (128 keys) and V tiles by TMA on two mbarrier rings;
//   a key block's K8 tiles stay in the ring for both passes. Each
//   warpgroup quantizes its q rows into shared memory (wgmma's A, 128-byte
//   swizzle). Per key block: pass 1 runs S = Q8 K8^T (wgmma m64n128k32
//   s8, both operands in shared memory) over the block's tiles and keeps
//   the rows' max of the int32 sums; pass 2 runs S again, forms p against
//   the block's max and runs P V: with pv_i8 as
//   wgmma m64n128k32 s8 with p's codes from registers and V8^T (K-major)
//   from shared memory, int32 sums over the whole block folded into a
//   float32 o kept in shared memory (the int32 block sums, the scores and
//   o do not fit in the 168 registers ptxas gives a thread of three
//   warpgroups); without pv_i8 as wgmma m64n128k16 bf16 with p in bf16
//   from registers and V through the MN-major descriptor, into o in
//   registers (rescaled by the block's corr before its first product).
//   The two warpgroups overlap each other's products and softmax; every
//   head's longest rows start first.
// The s32 score accumulator gives a thread keys 8j + 2tq + {0, 1} of each
// 8-key column tile, while the s8 register A wants k = 4tq .. 4tq + 3 (and
// 16 + 4tq ..): so the PV product takes the 32 keys of a k-step in the
// order key(kA) = 16 (kA / 16) + 8 ((kA % 4) / 2) + 2 ((kA / 4) % 4) + kA %
// 2, for p and for V8 alike, and the int32 sums are unchanged
// (tests/test_torch_flash_i8_tile.py holds the map).
// Tried and dropped (PERF.md): the mma.sync body of PRs 7-12 (4 warps per
// 64 rows walking each key block twice from cp.async tiles, after a
// prepass of one block per head: 0.3988 ms pv_i8, 0.2722 bf16 PV at
// 1 x 2048, 32/32); the warpgroups taking turns (~1% slower here); two
// 128-key S tiles in flight (spills at 168 registers: 0.45 ms); a tile's
// S as two 64-key groups, one half's softmax beside the other's product
// (ptxas serialized the wgmmas: 0.194 / 0.171 ms against 0.167 / 0.145).

#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"
#include "tma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int HD = 128;

// clip(rint(x * r), -127, 127) as a byte
__device__ __forceinline__ unsigned code_i8(float x, float r) {
  const float c = fminf(fmaxf(rintf(__fmul_rn(x, r)), -127.f), 127.f);
  return static_cast<unsigned>(static_cast<int>(c)) & 0xFFu;
}

__device__ __forceinline__ unsigned pack4(unsigned a, unsigned b, unsigned c,
                                          unsigned d) {
  return a | (b << 8) | (c << 16) | (d << 24);
}

// rint(x) as an integer through RINT_MAGIC (common.cuh)
__device__ __forceinline__ unsigned rint_u8(float x) {  // 0 <= x < 2^22
  return static_cast<unsigned>(
      __float_as_int(__fadd_rn(x, RINT_MAGIC)) - RINT_MAGIC_BITS);
}

__device__ __forceinline__ int quad_max_s32(int v) {
  v = max(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return max(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// ---------------------------------------------------------------------------
// (1) the prepass: per-head scales, K8 token-major, V8 transposed
// ---------------------------------------------------------------------------

constexpr int PQ_TOK = 128;     // tokens a block
constexpr int PQ_THREADS = 256;

// chunk c's max|K| and max|V| (0 without quant_v) -> part[head][c][2]
__global__ void __launch_bounds__(PQ_THREADS)
kv_amax_i8_kernel(const bf16* __restrict__ k, const bf16* __restrict__ v,
                  float* __restrict__ part, int k_sb, int k_sh, int k_ss,
                  int v_sb, int v_ss, int v_sh, int nkv, int quant_v) {
  __shared__ float red[2][PQ_THREADS / 32];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bf16* kb = k + static_cast<size_t>(b) * k_sb +
                   static_cast<size_t>(h) * k_sh;
  const bf16* vb = v + static_cast<size_t>(b) * v_sb +
                   static_cast<size_t>(h) * v_sh;
  float ka = 0.f, va = 0.f;
  for (int i = tid; i < PQ_TOK * 16; i += PQ_THREADS) {
    const int s = c * PQ_TOK + (i >> 4), col = (i & 15) * 8;
    float f[8];
    widen_bf16x8(ldg16(kb + static_cast<size_t>(s) * k_ss + col), f);
#pragma unroll
    for (int e = 0; e < 8; ++e) ka = fmaxf(ka, fabsf(f[e]));
    if (quant_v) {
      widen_bf16x8(ldg16(vb + static_cast<size_t>(s) * v_ss + col), f);
#pragma unroll
      for (int e = 0; e < 8; ++e) va = fmaxf(va, fabsf(f[e]));
    }
  }
  ka = warp_max(ka);
  va = warp_max(va);
  if (lane == 0) {
    red[0][warp] = ka;
    red[1][warp] = va;
  }
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int w = 1; w < PQ_THREADS / 32; ++w) {
      ka = fmaxf(ka, red[0][w]);
      va = fmaxf(va, red[1][w]);
    }
    float* p = part + ((static_cast<size_t>(b) * nkv + h) * gridDim.x + c) * 2;
    p[0] = ka;
    p[1] = va;
  }
}

// the head's scales from its chunks' extrema; chunk c's codes
__global__ void __launch_bounds__(PQ_THREADS)
kv_codes_i8_kernel(const bf16* __restrict__ k, const bf16* __restrict__ v,
                   const float* __restrict__ part, int8_t* __restrict__ k8,
                   int8_t* __restrict__ v8t, float* __restrict__ sc, int k_sb,
                   int k_sh, int k_ss, int v_sb, int v_ss, int v_sh, int S,
                   int nkv, int quant_v) {
  __shared__ __align__(16) uint8_t vt_s[HD * PQ_TOK];
  __shared__ float amax_s[2];
  // the blocks in the reverse of kv_amax_i8_kernel's order: the chunks it
  // read last are the likeliest still in L2
  const int c = gridDim.x - 1 - blockIdx.x, h = gridDim.y - 1 - blockIdx.y;
  const int b = gridDim.z - 1 - blockIdx.z;
  const int tid = threadIdx.x;
  const size_t head = static_cast<size_t>(b) * nkv + h;
  if (tid < 32) {
    const float* p = part + head * gridDim.x * 2;
    float ka = 0.f, va = 0.f;
    for (int i = tid; i < static_cast<int>(gridDim.x); i += 32) {
      ka = fmaxf(ka, p[2 * i]);
      va = fmaxf(va, p[2 * i + 1]);
    }
    ka = warp_max(ka);
    va = warp_max(va);
    if (tid == 0) {
      amax_s[0] = ka;
      amax_s[1] = va;
    }
  }
  __syncthreads();
  const float ks = fmaxf(amax_s[0], 1e-30f), vs = fmaxf(amax_s[1], 1e-30f);
  const float rk = 127.f / ks, rv = 127.f / vs;
  if (c == 0 && tid == 0) {
    sc[2 * head] = ks / 127.f;
    sc[2 * head + 1] = vs / 16129.f;
  }
  const bf16* kb = k + static_cast<size_t>(b) * k_sb +
                   static_cast<size_t>(h) * k_sh;
  int8_t* kq = k8 + head * S * HD;
  for (int i = tid; i < PQ_TOK * 16; i += PQ_THREADS) {
    const int s = c * PQ_TOK + (i >> 4), col = (i & 15) * 8;
    float f[8];
    widen_bf16x8(ldg16(kb + static_cast<size_t>(s) * k_ss + col), f);
    *reinterpret_cast<uint2*>(kq + static_cast<size_t>(s) * HD + col) =
        make_uint2(pack4(code_i8(f[0], rk), code_i8(f[1], rk),
                         code_i8(f[2], rk), code_i8(f[3], rk)),
                   pack4(code_i8(f[4], rk), code_i8(f[5], rk),
                         code_i8(f[6], rk), code_i8(f[7], rk)));
  }
  if (!quant_v) return;

  // V8^T [128][S]: the chunk's 128 tokens x 128 dims through the shared
  // tile [128 dims][128 positions], then out as 16-byte row pieces. A
  // thread takes 4 tokens (2a, 2a + 1, 2a + 8, 2a + 9 of a 16-token half:
  // positions 4a .. 4a + 3, the key order) x 8 dims, transposes the 4 x 4
  // byte blocks in registers and stores 32-bit words (16-byte chunk c of
  // dim row d at c ^ (d / 8 % 8): at most 2 threads of a warp a bank)
  const bf16* vb = v + static_cast<size_t>(b) * v_sb +
                   static_cast<size_t>(h) * v_sh;
  for (int u = tid; u < PQ_TOK * 128 / 32; u += PQ_THREADS) {
    const int dg = u & 15, tg = u >> 4;  // dims 8dg.., token group
    const int pos = (tg >> 2) * 16 + (tg & 3) * 4;  // its first position
    const int t0 = (tg >> 3) * 32 + ((tg >> 2) & 1) * 16 + (tg & 3) * 2;
    unsigned w[4][2];  // codes of token j, dims 8dg + 4q ..
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = t0 + (j & 1) + (j >> 1) * 8;
      float f[8];
      widen_bf16x8(
          ldg16(vb + static_cast<size_t>(c * PQ_TOK + t) * v_ss + dg * 8), f);
      w[j][0] = pack4(code_i8(f[0], rv), code_i8(f[1], rv), code_i8(f[2], rv),
                      code_i8(f[3], rv));
      w[j][1] = pack4(code_i8(f[4], rv), code_i8(f[5], rv), code_i8(f[6], rv),
                      code_i8(f[7], rv));
    }
#pragma unroll
    for (int qd = 0; qd < 2; ++qd) {
      const unsigned a0 = __byte_perm(w[0][qd], w[1][qd], 0x5140);
      const unsigned a1 = __byte_perm(w[0][qd], w[1][qd], 0x7362);
      const unsigned a2 = __byte_perm(w[2][qd], w[3][qd], 0x5140);
      const unsigned a3 = __byte_perm(w[2][qd], w[3][qd], 0x7362);
      const unsigned o4[4] = {__byte_perm(a0, a2, 0x5410),
                              __byte_perm(a0, a2, 0x7632),
                              __byte_perm(a1, a3, 0x5410),
                              __byte_perm(a1, a3, 0x7632)};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = dg * 8 + qd * 4 + e;
        *reinterpret_cast<unsigned*>(
            vt_s + d * PQ_TOK + (((pos >> 4) ^ (dg & 7)) << 4) + (pos & 15)) =
            o4[e];
      }
    }
  }
  __syncthreads();
  int8_t* vq = v8t + head * HD * S + c * PQ_TOK;
  for (int i = tid; i < HD * PQ_TOK / 16; i += PQ_THREADS) {
    const int d = i >> 3, ch = i & 7;
    *reinterpret_cast<uint4*>(vq + static_cast<size_t>(d) * S + ch * 16) =
        *reinterpret_cast<const uint4*>(vt_s + d * PQ_TOK +
                                        ((ch ^ ((d >> 3) & 7)) << 4));
  }
}

// ---------------------------------------------------------------------------
// (2) the flash kernel
// ---------------------------------------------------------------------------

constexpr int FI_BQ = 128;       // query rows a block: 2 warpgroups x 64
constexpr int FI_BK = 128;       // keys a tile
constexpr int FI_THREADS = 288;  // 2 consumer warpgroups + the producer
constexpr int FI_KST = 5;        // K8 tiles in the ring: a key block's (at
                                 // most 4: blk_k <= 512) stay for pass 2
constexpr int FI_VST = 2;        // V tiles in the ring
constexpr int FI_Q = FI_BQ * 128;   // Q8 [128 rows][128 B]
constexpr int FI_KT = FI_BK * 128;  // K8 tile [128 keys][128 B]
// V8^T tile [128 dims][128 keys] int8, or bf16 V [2 halves][128 keys][128 B]
template <bool PV_I8>
__host__ __device__ constexpr int fi_vt() {
  return PV_I8 ? HD * FI_BK : 2 * FI_BK * 128;
}
constexpr int FI_O = 2 * 64 * HD * 4;  // float32 o of both warpgroups
// + 1024: the swizzled tiles start at a multiple of 1024 bytes
template <bool PV_I8>
constexpr int fi_smem() {
  return 1024 + FI_Q + FI_KST * FI_KT + FI_VST * fi_vt<PV_I8>() +
         (PV_I8 ? FI_O : 0) + 2 * (FI_KST + FI_VST) * 8 + FI_BQ * 4;
}
static_assert(fi_smem<true>() <= 232448, "shared memory of one block");
static_assert(fi_smem<false>() <= 232448, "shared memory of one block");

// Block (blockIdx.x: query head; y: batch; z: query tiles, the longest
// rows first). Warp 8 is the producer: one thread streams, per key block
// jb, its K8 tiles and then its V tiles into the rings (each tile a full
// barrier, the transfer, and an empty one, one arrival per consumer warp);
// a K8 tile serves both passes and is released after pass 2's product.
// kmap: K8 as [B][nkv][S][128], boxes of 128 keys x 128 bytes; vmap: V8^T
// as [B][nkv][128][S], boxes of 128 dims x 128 keys (pv_i8), or bf16 V as
// [B][nkv][S][128] through its strides, boxes of 128 keys x 64 columns.
template <bool PV_I8>
__global__ void __launch_bounds__(FI_THREADS, 1)
flash_i8_kernel(const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                const bf16* __restrict__ q, const float* __restrict__ sc,
                bf16* __restrict__ out, int q_sb, int q_ss, int q_sh, int S,
                int nh, int nkv, int n_rep, int BK, float scale) {
  constexpr int VT = fi_vt<PV_I8>();
  extern __shared__ __align__(16) uint8_t fi_raw[];
  uint8_t* qs = fi_raw + ((1024 - (smem_u32(fi_raw) & 1023)) & 1023);
  uint8_t* ks = qs + FI_Q;
  uint8_t* vs = ks + FI_KST * FI_KT;
  float* o_s = reinterpret_cast<float*>(vs + FI_VST * VT);  // (pv_i8)
  uint64_t* kfull = reinterpret_cast<uint64_t*>(
      reinterpret_cast<uint8_t*>(o_s) + (PV_I8 ? FI_O : 0));
  uint64_t* kempty = kfull + FI_KST;
  uint64_t* vfull = kempty + FI_KST;
  uint64_t* vempty = vfull + FI_VST;
  float* qamax_s = reinterpret_cast<float*>(vempty + FI_VST);  // [128]
  const int tid = threadIdx.x;
  const int qt = gridDim.z - 1 - blockIdx.z;  // longest rows first
  const int h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / n_rep;
  const int q0b = qt * FI_BQ;
  // key blocks 0..last; the last holds row q0b, and its tiles up to the
  // one holding q0b (the diagonal tile) are visited
  const int last = q0b / BK;
  const int nsb = BK / FI_BK;
  const int n_last = (q0b - last * BK) / FI_BK + 1;

  if (tid == 0) {
    for (int st = 0; st < FI_KST; ++st) {
      mbar_init(kfull + st, 1);
      mbar_init(kempty + st, 8);  // the consumers' 8 warps
    }
    for (int st = 0; st < FI_VST; ++st) {
      mbar_init(vfull + st, 1);
      mbar_init(vempty + st, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {  // the producer: one thread issues the loads
    if (tid == 256) {
      int jk = 0, jv = 0;
      auto load_k = [&](int k0) {
        const int slot = jk % FI_KST;
        mbar_wait(kempty + slot, ((jk / FI_KST) & 1) ^ 1);
        mbar_expect_tx(kfull + slot, FI_KT);
        tma_load4(ks + slot * FI_KT, &kmap, 0, k0, kvh, b, kfull + slot);
        ++jk;
      };
      auto load_v = [&](int k0) {
        const int slot = jv % FI_VST;
        uint8_t* vd = vs + slot * VT;
        mbar_wait(vempty + slot, ((jv / FI_VST) & 1) ^ 1);
        mbar_expect_tx(vfull + slot, VT);
        if constexpr (PV_I8) {
          tma_load4(vd, &vmap, k0, 0, kvh, b, vfull + slot);
        } else {
          tma_load4(vd, &vmap, 0, k0, kvh, b, vfull + slot);
          tma_load4(vd + FI_BK * 128, &vmap, 64, k0, kvh, b, vfull + slot);
        }
        ++jv;
      };
      for (int jb = 0; jb <= last; ++jb) {
        const int n = jb == last ? n_last : nsb;
        for (int t = 0; t < n; ++t) load_k(jb * BK + t * FI_BK);
        for (int t = 0; t < n; ++t) load_v(jb * BK + t * FI_BK);
      }
    }
    return;
  }

  // a consumer warpgroup
  const int cw = tid >> 7;  // 0, 1
  const int wt = tid & 127;
  const int warp = wt >> 5, lane = tid & 31;
  const int g8 = lane >> 2, tq = lane & 3;
  const int q0 = q0b + cw * 64;
  const int row0 = q0 + warp * 16 + g8;  // this thread's rows: row0, +8
  const size_t head = static_cast<size_t>(b) * nkv + kvh;

  // q codes: each warp quantizes its 16 rows, 4 dims a lane; byte d of row
  // r at chunk (d / 16) ^ (r % 8) of the row's 128 (the 128-byte swizzle)
  uint8_t* qw = qs + cw * (64 * 128);
  {
    const bf16* qb = q + static_cast<size_t>(b) * q_sb +
                     static_cast<size_t>(h) * q_sh;
    for (int rr = 0; rr < 16; ++rr) {
      const int r = warp * 16 + rr;
      const uint2 raw = *reinterpret_cast<const uint2*>(
          qb + static_cast<size_t>(q0 + r) * q_ss + lane * 4);
      float f[4] = {__uint_as_float(raw.x << 16),
                    __uint_as_float(raw.x & 0xFFFF0000u),
                    __uint_as_float(raw.y << 16),
                    __uint_as_float(raw.y & 0xFFFF0000u)};
      float a = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        f[e] = __fmul_rn(f[e], scale);
        a = fmaxf(a, fabsf(f[e]));
      }
      const float qa = fmaxf(warp_max(a), 1e-30f);
      const float rq = 127.f / qa;
      *reinterpret_cast<unsigned*>(qw + r * 128 +
                                   (((lane >> 2) ^ (r & 7)) << 4) +
                                   (lane & 3) * 4) =
          pack4(code_i8(f[0], rq), code_i8(f[1], rq), code_i8(f[2], rq),
                code_i8(f[3], rq));
      if (lane == 0) qamax_s[cw * 64 + r] = qa;
    }
  }
  fence_proxy_async();  // the generic-proxy writes, seen by the wgmmas
  bar_sync<128>(1 + cw);
  const float s_k = sc[2 * head] / 127.f;
  const float pv_scale = sc[2 * head + 1];
  const float ss0 = __fmul_rn(qamax_s[cw * 64 + warp * 16 + g8], s_k);
  const float ss1 = __fmul_rn(qamax_s[cw * 64 + warp * 16 + g8 + 8], s_k);

  // o: with pv_i8 in shared memory (value i of thread wt at i * 128 +
  // wt), touched once a key block (o = o * corr + the block's P V): the
  // block's int32 P V, the scores and o do not fit in the 168 registers
  // ptxas gives a thread of three warpgroups; without pv_i8 in registers,
  // the P V products accumulating into it (measured faster than in shared
  // memory, PERF.md)
  float* ow = o_s + cw * (64 * HD);
  float o[PV_I8 ? 1 : 64];
#pragma unroll
  for (int i = 0; i < (PV_I8 ? 1 : 64); ++i) o[i] = 0.f;
  if constexpr (PV_I8) {
#pragma unroll 8
    for (int i = 0; i < 64; ++i) ow[i * 128 + wt] = 0.f;
  }
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  int si[64];  // S of a tile: row row0 (+ 8 for i % 4 >= 2), key k0 + 8
               // (i / 4) + 2 tq + i % 2

  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  int jk = 0, jv = 0;  // the key block's first K8 and V loads
  // S = Q8 K8^T of the block's tile t into si (pass 1 first waits for the
  // tile to land; pass 2 then releases it)
  auto scores = [&](int t, bool pass2) {
    const int slot = (jk + t) % FI_KST;
    if (!pass2) mbar_wait(kfull + slot, ((jk + t) / FI_KST) & 1);
    const uint8_t* kt = ks + slot * FI_KT;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_s8_ss_n128(si, sw128_desc(qw + kk * 32), sw128_desc(kt + kk * 32),
                       kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_s32<64>(si);
    if (pass2) release(kempty + slot);
  };
  // key of si[i] above its row (tiles that reach above a row only)
  auto above = [&](int k0, int i) {
    return k0 + (i >> 2) * 8 + tq * 2 + (i & 1) > row0 + ((i & 2) ? 8 : 0);
  };

  for (int jb = 0; jb <= last; ++jb) {
    const int n = jb == last ? n_last : nsb;
    const int kb0 = jb * BK;
    // pass 1: the rows' max, taken on the int32 sums: s = rn(float(si) *
    // ss) rises with si (ss > 0), so the max of s is the s of the max
    int bi0 = INT_MIN, bi1 = INT_MIN;
    for (int t = 0; t < n; ++t) {
      const int k0 = kb0 + t * FI_BK;
      scores(t, false);
      if (k0 + FI_BK - 1 > q0) {  // the tile reaches above some row
#pragma unroll
        for (int i = 0; i < 64; ++i)
          if (!above(k0, i)) {
            if (i & 2) bi1 = max(bi1, si[i]);
            else bi0 = max(bi0, si[i]);
          }
      } else {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          if (i & 2) bi1 = max(bi1, si[i]);
          else bi0 = max(bi0, si[i]);
        }
      }
    }
    bi0 = quad_max_s32(bi0);
    bi1 = quad_max_s32(bi1);
    const float mn0 = fmaxf(m0, bi0 == INT_MIN
                                    ? -INFINITY
                                    : __fmul_rn(static_cast<float>(bi0), ss0));
    const float mn1 = fmaxf(m1, bi1 == INT_MIN
                                    ? -INFINITY
                                    : __fmul_rn(static_cast<float>(bi1), ss1));
    const float c0 = exp2f(__fsub_rn(m0, mn0));
    const float c1 = exp2f(__fsub_rn(m1, mn1));
    m0 = mn0;
    m1 = mn1;
    if constexpr (!PV_I8) {
#pragma unroll
      for (int i = 0; i < 64; ++i) o[i] = __fmul_rn(o[i], (i & 2) ? c1 : c0);
    }

    // pass 2: p against the block's max, P V over the block: with pv_i8
    // into the int32 pvi, else into o (rescaled above)
    float ls0 = 0.f, ls1 = 0.f;
    int pvi[PV_I8 ? 64 : 1];
    for (int t = 0; t < n; ++t) {
      const int k0 = kb0 + t * FI_BK;
      scores(t, true);
      // p's codes as the A fragments of 4 k-steps of 32 keys (pv_i8), or
      // p in bf16 as those of 8 k-steps of 16 keys; si[i], si[i + 1] (i
      // even) are keys 2tq, 2tq + 1 of n-tile i / 4 in one row
      unsigned pa[PV_I8 ? 4 : 8][4];
      auto softmax = [&](auto masked) {
#pragma unroll
        for (int i = 0; i < 64; i += 2) {
          const float ss = (i & 2) ? ss1 : ss0, m = (i & 2) ? m1 : m0;
          float x0 = __fmul_rn(static_cast<float>(si[i]), ss);
          float x1 = __fmul_rn(static_cast<float>(si[i + 1]), ss);
          if (decltype(masked)::value) {
            if (above(k0, i)) x0 = -INFINITY;
            if (above(k0, i + 1)) x1 = -INFINITY;
          }
          const float p0 = exp2f(__fsub_rn(x0, m));
          const float p1 = exp2f(__fsub_rn(x1, m));
          if (i & 2) ls1 += p0 + p1;
          else ls0 += p0 + p1;
          const int nt = i >> 2;
          if constexpr (PV_I8) {
            // k-step nt / 4: n-tiles 4ks, 4ks + 1 in registers 0, 1 (rows
            // g8, g8 + 8), 4ks + 2, 4ks + 3 in 2, 3; an odd n-tile's pair
            // in the upper half
            const unsigned pair = rint_u8(__fmul_rn(p0, 127.f)) |
                                  (rint_u8(__fmul_rn(p1, 127.f)) << 8);
            const int reg = ((nt >> 1) & 1) * 2 + ((i & 2) >> 1);
            if (nt & 1) pa[nt >> 2][reg] |= pair << 16;
            else pa[nt >> 2][reg] = pair;
          } else {
            // k-step nt / 2: n-tile 2kk in registers 0, 1, 2kk + 1 in 2, 3
            pa[nt >> 1][(nt & 1) * 2 + ((i & 2) >> 1)] = pack_bf16(p0, p1);
          }
        }
      };
      if (k0 + FI_BK - 1 > q0) softmax(std::true_type());
      else softmax(std::false_type());
      const int slot = (jv + t) % FI_VST;
      mbar_wait(vfull + slot, ((jv + t) / FI_VST) & 1);
      const uint8_t* vt = vs + slot * VT;
      wgmma_fence();
      if constexpr (PV_I8) {
#pragma unroll
        for (int k2 = 0; k2 < 4; ++k2)
          wgmma_s8_rs_n128(pvi, pa[k2], sw128_desc(vt + k2 * 32),
                           t > 0 || k2 > 0);
      } else {
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          Wgmma<128>::mma_tb(o, pa[kk],
                             sw128_mn_desc(vt + kk * 2048, FI_BK * 128), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      if constexpr (PV_I8) fence_s32<64>(pvi);
      else fence_f32<64>(o);
      fence_u32<(PV_I8 ? 4 : 8) * 4>(&pa[0][0]);
      release(vempty + slot);
    }
    jk += n;
    jv += n;
    l0 = __fadd_rn(__fmul_rn(l0, c0), quad_sum(ls0));
    l1 = __fadd_rn(__fmul_rn(l1, c1), quad_sum(ls1));
    if constexpr (PV_I8) {  // o = o * corr + float(p.V) * sc[1] (plain order)
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        float* p = ow + i * 128 + wt;
        *p = __fadd_rn(__fmul_rn(*p, (i & 2) ? c1 : c0),
                       __fmul_rn(static_cast<float>(pvi[i]), pv_scale));
      }
    }
  }

  const float il0 = fmaxf(l0, 1e-30f), il1 = fmaxf(l1, 1e-30f);
  bf16* ob = out + (static_cast<size_t>(b) * S * nh + h) * HD;
  const size_t row_stride = static_cast<size_t>(nh) * HD;
#pragma unroll
  for (int d = 0; d < 16; ++d) {
    const int col = d * 8 + tq * 2;
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (PV_I8) v[e] = ow[(4 * d + e) * 128 + wt];
      else v[e] = o[4 * d + e];
    }
    *reinterpret_cast<unsigned*>(ob + row0 * row_stride + col) =
        pack_bf16(v[0] / il0, v[1] / il0);
    *reinterpret_cast<unsigned*>(ob + (row0 + 8) * row_stride + col) =
        pack_bf16(v[2] / il1, v[3] / il1);
  }
}

// K8 [B][nkv][S][128] and the V tiles' map (see flash_i8_kernel)
template <bool PV_I8>
int launch_flash(const void* q, const void* k8, const void* v8t,
                 const void* v, const void* sc, void* out, int q_sb, int q_ss,
                 int q_sh, int v_sb, int v_ss, int v_sh, int B, int S, int nh,
                 int nkv, int blk_k, float scale, cudaStream_t s) {
  // opt into the dynamic shared memory once, so a launch inside a CUDA
  // graph capture makes no other runtime call
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_i8_kernel<PV_I8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        fi_smem<PV_I8>());
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  CUtensorMap kmap, vmap;
  const long long kd[4] = {HD, S, nkv, B};
  const long long kst[3] = {HD, 1LL * S * HD, 1LL * nkv * S * HD};
  if (!tensor_map_nd(&kmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, k8, 4, kd, kst,
                     HD, FI_BK))
    return static_cast<int>(cudaErrorInvalidValue);
  bool ok;
  if (PV_I8) {
    const long long vd[4] = {S, HD, nkv, B};
    const long long vst[3] = {S, 1LL * HD * S, 1LL * nkv * HD * S};
    ok = tensor_map_nd(&vmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, v8t, 4, vd, vst,
                       FI_BK, HD);
  } else {
    const long long vd[4] = {HD, S, nkv, B};
    const long long vst[3] = {2LL * v_ss, 2LL * v_sh, 2LL * v_sb};
    ok = tensor_map4_bf16(&vmap, v, vd, vst, 64, FI_BK);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  flash_i8_kernel<PV_I8>
      <<<dim3(nh, B, S / FI_BQ), FI_THREADS, fi_smem<PV_I8>(), s>>>(
          kmap, vmap, static_cast<const bf16*>(q),
          static_cast<const float*>(sc), static_cast<bf16*>(out), q_sb, q_ss,
          q_sh, S, nh, nkv, nh / nkv, blk_k, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_prepass(const void* k, const void* v, void* k8, void* v8t,
                   void* sc, void* part, int k_sb, int k_sh, int k_ss,
                   int v_sb, int v_ss, int v_sh, int B, int S, int nkv,
                   int quant_v, cudaStream_t s) {
  const dim3 grid(S / PQ_TOK, nkv, B);
  kv_amax_i8_kernel<<<grid, PQ_THREADS, 0, s>>>(
      static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<float*>(part), k_sb, k_sh, k_ss, v_sb, v_ss, v_sh, nkv,
      quant_v);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kv_codes_i8_kernel<<<grid, PQ_THREADS, 0, s>>>(
      static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(part), static_cast<int8_t*>(k8),
      static_cast<int8_t*>(v8t), static_cast<float*>(sc), k_sb, k_sh, k_ss,
      v_sb, v_ss, v_sh, S, nkv, quant_v);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The prepass alone (phase 3i times it on its own): k through (k_sb, k_sh,
// k_ss) as [B, nkv, S, 128]; v through (v_sb, v_ss, v_sh) as [B, S, nkv,
// 128], bf16, head-dim stride 1, 16-byte aligned rows. Writes k8 int8
// [B, nkv, S, 128], v8t int8 [B, nkv, 128, S] (keys permuted within each
// 32-key group; only with quant_v), sc f32 [B, nkv, 2]; part f32 [B, nkv,
// S / 128, 2] is scratch. S % 128 == 0 (checked in Python).
extern "C" int fq_kv_quant_i8(const void* k, const void* v, void* k8,
                              void* v8t, void* sc, void* part, int k_sb,
                              int k_sh, int k_ss, int v_sb, int v_ss,
                              int v_sh, int B, int S, int nkv, int quant_v,
                              void* stream) {
  return launch_prepass(k, v, k8, v8t, sc, part, k_sb, k_sh, k_ss, v_sb,
                        v_ss, v_sh, B, S, nkv, quant_v,
                        static_cast<cudaStream_t>(stream));
}

// q [B, S, nh, 128] bf16 through strides (q_sb, q_ss, q_sh); K through
// (k_sb, k_sh, k_ss) as [B, nkv, S, 128]; v through (v_sb, v_ss, v_sh) as
// [B, S, nkv, 128]; every head-dim stride 1, every stride a multiple of 8
// elements and the bases 16-byte aligned. Scratch: k8, v8t, sc, part as
// fq_kv_quant_i8's. out [B, S, nh, 128] bf16 contiguous. S % 128 == 0,
// blk_k a multiple of 128 dividing S, nh % nkv == 0 (checked in Python);
// scale = sm_scale * log2(e).
extern "C" int fq_flash_prefill_i8(const void* q, const void* k,
                                   const void* v, void* k8, void* v8t,
                                   void* sc, void* part, void* out, int q_sb,
                                   int q_ss, int q_sh, int k_sb, int k_sh,
                                   int k_ss, int v_sb, int v_ss, int v_sh,
                                   int B, int S, int nh, int nkv, int blk_k,
                                   int pv_i8, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = launch_prepass(k, v, k8, v8t, sc, part, k_sb, k_sh, k_ss,
                                 v_sb, v_ss, v_sh, B, S, nkv, pv_i8, s);
  if (err != 0) return err;
  return pv_i8 ? launch_flash<true>(q, k8, v8t, v, sc, out, q_sb, q_ss, q_sh,
                                    v_sb, v_ss, v_sh, B, S, nh, nkv, blk_k,
                                    scale, s)
               : launch_flash<false>(q, k8, v8t, v, sc, out, q_sb, q_ss, q_sh,
                                     v_sb, v_ss, v_sh, B, S, nh, nkv, blk_k,
                                     scale, s);
}
