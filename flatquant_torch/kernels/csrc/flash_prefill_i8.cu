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
// take 20 us at 3.35 TB/s.
//
// Design, two launches.
// (1) kv_quant_i8_kernel, one block of 1024 threads per (batch, kv head):
//   the scales reduce over all S, including keys a causal row never sees,
//   and blocks of the flash launch run in no order, so this is a prepass.
//   It reads K and V twice (extrema, then codes) and writes K8 token-major
//   [B, nkv, S, 128] and V8 transposed [B, nkv, 128, S] (through a shared
//   64-token tile), plus the two scales. One block per head leaves most
//   SMs idle at 8 kv heads; splitting S is later work.
// (2) flash_prefill_i8_kernel: a block owns 64 query rows of one (batch,
//   query head), 4 warps of 16 rows; q is quantized into shared memory and
//   held as int8 A fragments. For each key block it walks the block's
//   64-key tiles twice: pass 1 computes the scores (mma.sync m16n8k32 s8,
//   int32 sums) and keeps the row maxima; pass 2 recomputes them (cheaper
//   than a 64 x 512 float32 score tile in shared memory, which would leave
//   room for one block per SM), forms p against the block's max and
//   accumulates p.V over the whole block -- in int32 with pv_i8 (p's
//   codes as s8 A fragments, V8 as B), else in float32 on bf16 mma.sync
//   with V read from the bf16 input through ldmatrix.trans -- before it
//   scales into acc. Keys above the block's last row are never visited.
//   Tiles are double-buffered by cp.async; int8 rows are padded (144 and
//   80 bytes) so the 32-bit fragment loads hit distinct banks.
//   The score accumulator gives each thread keys 2tq, 2tq + 1 of every
//   8-key column tile, where the s8 A fragment wants 4 consecutive k: the
//   PV product takes its 32 keys in the order (2tq, 2tq + 1, 8 + 2tq,
//   9 + 2tq) for kA = 4tq .. 4tq + 3 (and + 16), for p and for V8 alike, so
//   the int32 sums are unchanged.

#include <cuda_bf16.h>
#include <math.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int HD = 128;
constexpr int BQ = 64;       // query rows per block (4 warps x 16)
constexpr int TK = 64;       // keys per tile
constexpr int THREADS = 128;
constexpr int K_LD = HD + 16;   // padded int8 K row (one key), bytes
constexpr int VI_LD = TK + 16;  // padded int8 V8 row (one dim), bytes
constexpr int VB_LD = HD + 8;   // padded bf16 V row (one key), elements
constexpr int Q_LD = HD / 4 + 4;  // padded q code row, 32-bit words
constexpr int K_TILE = TK * K_LD;       // bytes
constexpr int VI_TILE = HD * VI_LD;     // bytes
constexpr int VB_TILE = TK * VB_LD * 2;  // bytes
constexpr int PRE_THREADS = 1024;
constexpr int PRE_TILE = 64;  // tokens per transposed V tile of the prepass
constexpr int PRE_LD = PRE_TILE + 16;

constexpr int smem_bytes(bool pv_i8) {
  return 2 * K_TILE + 2 * (pv_i8 ? VI_TILE : VB_TILE) + BQ * Q_LD * 4;
}

__device__ __forceinline__ void widen8(uint4 v, float* f) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

// clip(rint(x * r), -127, 127) as a byte
__device__ __forceinline__ unsigned code_i8(float x, float r) {
  const float c = fminf(fmaxf(rintf(__fmul_rn(x, r)), -127.f), 127.f);
  return static_cast<unsigned>(static_cast<int>(c)) & 0xFFu;
}

__device__ __forceinline__ unsigned pack4(unsigned a, unsigned b, unsigned c,
                                          unsigned d) {
  return a | (b << 8) | (c << 16) | (d << 24);
}

// ---------------------------------------------------------------------------
// (1) the prepass: per-head scales, K8 token-major, V8 transposed
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(PRE_THREADS)
kv_quant_i8_kernel(const bf16* __restrict__ k, const bf16* __restrict__ v,
                   int8_t* __restrict__ k8, int8_t* __restrict__ v8t,
                   float* __restrict__ sc, int k_sb, int k_sh, int k_ss,
                   int v_sb, int v_ss, int v_sh, int S, int nkv, int quant_v) {
  __shared__ float red[2][PRE_THREADS / 32];
  __shared__ __align__(16) uint8_t vt_s[HD * PRE_LD];
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bf16* kb = k + static_cast<size_t>(b) * k_sb +
                   static_cast<size_t>(h) * k_sh;
  const bf16* vb = v + static_cast<size_t>(b) * v_sb +
                   static_cast<size_t>(h) * v_sh;
  const int nchunk = S * (HD / 8);  // 16-byte chunks of a head's K (or V)

  float ka = 0.f, va = 0.f;
  for (int i = tid; i < nchunk; i += PRE_THREADS) {
    const int s = i >> 4, col = (i & 15) * 8;
    float f[8];
    widen8(ldg16(kb + static_cast<size_t>(s) * k_ss + col), f);
#pragma unroll
    for (int e = 0; e < 8; ++e) ka = fmaxf(ka, fabsf(f[e]));
    if (quant_v) {
      widen8(ldg16(vb + static_cast<size_t>(s) * v_ss + col), f);
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
#pragma unroll
  for (int w = 0; w < PRE_THREADS / 32; ++w) {
    ka = fmaxf(ka, red[0][w]);
    va = fmaxf(va, red[1][w]);
  }
  const float ks = fmaxf(ka, 1e-30f), vs = fmaxf(va, 1e-30f);
  const float rk = 127.f / ks, rv = 127.f / vs;
  const size_t head = static_cast<size_t>(b) * nkv + h;
  if (tid == 0) {
    sc[2 * head] = ks / 127.f;
    sc[2 * head + 1] = vs / 16129.f;
  }

  int8_t* kq = k8 + head * S * HD;
  for (int i = tid; i < nchunk; i += PRE_THREADS) {
    const int s = i >> 4, col = (i & 15) * 8;
    float f[8];
    widen8(ldg16(kb + static_cast<size_t>(s) * k_ss + col), f);
    const uint2 w = make_uint2(
        pack4(code_i8(f[0], rk), code_i8(f[1], rk), code_i8(f[2], rk),
              code_i8(f[3], rk)),
        pack4(code_i8(f[4], rk), code_i8(f[5], rk), code_i8(f[6], rk),
              code_i8(f[7], rk)));
    *reinterpret_cast<uint2*>(kq + static_cast<size_t>(s) * HD + col) = w;
  }
  if (!quant_v) return;

  // V8 [128][S]: a tile of 64 tokens x 128 dims (one 16-byte chunk per
  // thread) goes through shared memory transposed, then out as 64-byte
  // dim rows
  int8_t* vq = v8t + head * HD * S;
  for (int s0 = 0; s0 < S; s0 += PRE_TILE) {
    {
      const int t = tid >> 4, col = (tid & 15) * 8;
      float f[8];
      widen8(ldg16(vb + static_cast<size_t>(s0 + t) * v_ss + col), f);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        vt_s[(col + e) * PRE_LD + t] = static_cast<uint8_t>(code_i8(f[e], rv));
    }
    __syncthreads();
    if (tid < HD * PRE_TILE / 16) {
      const int d = tid >> 2, seg = (tid & 3) * 16;
      *reinterpret_cast<uint4*>(vq + static_cast<size_t>(d) * S + s0 + seg) =
          *reinterpret_cast<const uint4*>(vt_s + d * PRE_LD + seg);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// (2) the flash launch
// ---------------------------------------------------------------------------

// Fragment layouts (g8 = lane / 4, tq = lane % 4):
//   s8 m16n8k32:   A regs 0..3: (row g8, k 4tq..), (row g8 + 8, k 4tq..),
//                  (row g8, k 16 + 4tq..), (row g8 + 8, k 16 + 4tq..);
//                  B regs 0, 1: (k 4tq.., n g8), (k 16 + 4tq.., n g8)
//   bf16 m16n8k16: as in flash_prefill.cu
//   C (both):      (row g8, n 2tq), (row g8, 2tq + 1), (row g8 + 8, 2tq),
//                  (row g8 + 8, 2tq + 1)
template <bool PV_I8>
__global__ void __launch_bounds__(THREADS)
flash_prefill_i8_kernel(const bf16* __restrict__ q,
                        const int8_t* __restrict__ k8,
                        const int8_t* __restrict__ v8t,
                        const bf16* __restrict__ v,
                        const float* __restrict__ sc, bf16* __restrict__ out,
                        int q_sb, int q_ss, int q_sh, int v_sb, int v_ss,
                        int v_sh, int S, int nh, int nkv, int n_rep, int BK,
                        float scale) {
  extern __shared__ float4 smem4[];
  uint8_t* sk = reinterpret_cast<uint8_t*>(smem4);  // [2][TK][K_LD] int8
  uint8_t* sv = sk + 2 * K_TILE;  // [2] V8 [HD][VI_LD] or bf16 V [TK][VB_LD]
  unsigned* sq = reinterpret_cast<unsigned*>(
      sv + 2 * (PV_I8 ? VI_TILE : VB_TILE));  // [BQ][Q_LD] q codes
  __shared__ float qamax_s[BQ];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, tq = lane & 3;
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / n_rep;
  const int q0 = qt * BQ;
  const size_t head = static_cast<size_t>(b) * nkv + kvh;
  const int8_t* kq = k8 + head * S * HD;
  const int8_t* vq = v8t + head * HD * S;
  const bf16* vb = v + static_cast<size_t>(b) * v_sb +
                   static_cast<size_t>(kvh) * v_sh;
  const float s_k = sc[2 * head] / 127.f;
  const float pv_scale = sc[2 * head + 1];

  // key blocks 0..last; the last holds q0 (BK is a multiple of TK and q0 of
  // BQ = TK), and its tiles up to the one holding row q0 + 63 are visited
  const int last = q0 / BK;
  const int nsb = BK / TK;
  const int n_last = (q0 - last * BK) / TK + 1;
  const int nsteps = 2 * (last * nsb + n_last);  // two passes per block

  // step -> key block jb, pass (0: maxima, 1: p and PV), tile t
  auto decode_step = [&](int st, int& jb, int& pass, int& t) {
    jb = st / (2 * nsb);
    const int rem = st - jb * 2 * nsb;
    const int n = jb == last ? n_last : nsb;
    pass = rem >= n;
    t = rem - pass * n;
  };
  auto prefetch = [&](int st) {
    int jb, pass, t;
    decode_step(st, jb, pass, t);
    const int k0 = jb * BK + t * TK;
    const int buf = st & 1;
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // K8: 64 keys x 8 chunks
      const int c = tid + i * THREADS;
      const int r = c >> 3, col = (c & 7) * 16;
      cp_async16(sk + buf * K_TILE + r * K_LD + col,
                 kq + static_cast<size_t>(k0 + r) * HD + col);
    }
    if (!pass) return;
    if (PV_I8) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // V8: 128 dims x 4 chunks
        const int c = tid + i * THREADS;
        const int d = c >> 2, col = (c & 3) * 16;
        cp_async16(sv + buf * VI_TILE + d * VI_LD + col,
                   vq + static_cast<size_t>(d) * S + k0 + col);
      }
    } else {
      bf16* tv = reinterpret_cast<bf16*>(sv + buf * VB_TILE);
#pragma unroll
      for (int i = 0; i < 8; ++i) {  // bf16 V: 64 keys x 16 chunks
        const int c = tid + i * THREADS;
        const int r = c >> 4, col = (c & 15) * 8;
        cp_async16(tv + r * VB_LD + col,
                   vb + static_cast<size_t>(k0 + r) * v_ss + col);
      }
    }
  };

  prefetch(0);
  cp_async_commit();

  // q codes: each warp quantizes its 16 rows, 4 dims per lane
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
    sq[r * Q_LD + lane] = pack4(code_i8(f[0], rq), code_i8(f[1], rq),
                                code_i8(f[2], rq), code_i8(f[3], rq));
    if (lane == 0) qamax_s[r] = qa;
  }
  __syncwarp();
  unsigned qa_f[4][4];
  {
    const unsigned* r0 = sq + (warp * 16 + g8) * Q_LD;
    const unsigned* r1 = r0 + 8 * Q_LD;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      qa_f[kk][0] = r0[kk * 8 + tq];
      qa_f[kk][1] = r1[kk * 8 + tq];
      qa_f[kk][2] = r0[kk * 8 + 4 + tq];
      qa_f[kk][3] = r1[kk * 8 + 4 + tq];
    }
  }
  const float ss0 = __fmul_rn(qamax_s[warp * 16 + g8], s_k);
  const float ss1 = __fmul_rn(qamax_s[warp * 16 + g8 + 8], s_k);
  const int row0 = q0 + warp * 16 + g8;  // this thread's rows: row0, +8

  float o[16][4];
  int pvi[16][4];    // the block's int32 p.V (PV_I8)
  float pvf[16][4];  // the block's float32 p.V (bf16)
#pragma unroll
  for (int d = 0; d < 16; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float bm0 = -INFINITY, bm1 = -INFINITY;  // the block's row maxima
  float c0 = 0.f, c1 = 0.f;                // corr of the block
  float ls0 = 0.f, ls1 = 0.f;              // the block's p sums

  for (int st = 0; st < nsteps; ++st) {
    if (st + 1 < nsteps) prefetch(st + 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    int jb, pass, t;
    decode_step(st, jb, pass, t);
    const int n = jb == last ? n_last : nsb;
    const int k0 = jb * BK + t * TK;
    const int buf = st & 1;

    // scores of the tile: 8 column tiles of 8 keys
    float s[8][4];
    {
      int si[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) si[j][e] = 0;
      const uint8_t* tk = sk + buf * K_TILE + g8 * K_LD + tq * 4;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint8_t* kr = tk + j * 8 * K_LD + kk * 32;
          mma_s8(si[j], qa_f[kk], *reinterpret_cast<const unsigned*>(kr),
                 *reinterpret_cast<const unsigned*>(kr + 16));
        }
      }
      const bool diag = k0 + TK - 1 > q0;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = __fmul_rn(static_cast<float>(si[j][e]),
                              e < 2 ? ss0 : ss1);
          if (diag && k0 + j * 8 + tq * 2 + (e & 1) > row0 + (e >= 2 ? 8 : 0))
            x = -INFINITY;
          s[j][e] = x;
        }
    }

    if (!pass) {  // pass 1: the block's row maxima
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        bm0 = fmaxf(bm0, fmaxf(s[j][0], s[j][1]));
        bm1 = fmaxf(bm1, fmaxf(s[j][2], s[j][3]));
      }
      if (t == n - 1) {
        const float mn0 = fmaxf(m0, quad_max(bm0));
        const float mn1 = fmaxf(m1, quad_max(bm1));
        c0 = exp2f(__fsub_rn(m0, mn0));
        c1 = exp2f(__fsub_rn(m1, mn1));
        m0 = mn0;
        m1 = mn1;
        bm0 = bm1 = -INFINITY;
        ls0 = ls1 = 0.f;
#pragma unroll
        for (int d = 0; d < 16; ++d)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            pvi[d][e] = 0;
            pvf[d][e] = 0.f;
          }
      }
    } else {  // pass 2: p against the block's max, then p.V
      float p[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        p[j][0] = exp2f(__fsub_rn(s[j][0], m0));
        p[j][1] = exp2f(__fsub_rn(s[j][1], m0));
        p[j][2] = exp2f(__fsub_rn(s[j][2], m1));
        p[j][3] = exp2f(__fsub_rn(s[j][3], m1));
        ls0 += p[j][0] + p[j][1];
        ls1 += p[j][2] + p[j][3];
      }
      if (PV_I8) {
        unsigned ci[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            ci[j][e] = static_cast<unsigned>(static_cast<int>(
                           rintf(__fmul_rn(p[j][e], 127.f)))) & 0xFFu;
        const uint8_t* tv = sv + buf * VI_TILE + g8 * VI_LD + 2 * tq;
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {  // 32 keys: column tiles 4ks..4ks+3
          const int j = 4 * ks;
          unsigned pa[4];
          pa[0] = pack4(ci[j][0], ci[j][1], ci[j + 1][0], ci[j + 1][1]);
          pa[1] = pack4(ci[j][2], ci[j][3], ci[j + 1][2], ci[j + 1][3]);
          pa[2] = pack4(ci[j + 2][0], ci[j + 2][1], ci[j + 3][0],
                        ci[j + 3][1]);
          pa[3] = pack4(ci[j + 2][2], ci[j + 2][3], ci[j + 3][2],
                        ci[j + 3][3]);
#pragma unroll
          for (int d = 0; d < 16; ++d) {
            const uint8_t* vr = tv + d * 8 * VI_LD + ks * 32;
            const unsigned b0 =
                *reinterpret_cast<const unsigned short*>(vr) |
                (static_cast<unsigned>(
                     *reinterpret_cast<const unsigned short*>(vr + 8))
                 << 16);
            const unsigned b1 =
                *reinterpret_cast<const unsigned short*>(vr + 16) |
                (static_cast<unsigned>(
                     *reinterpret_cast<const unsigned short*>(vr + 24))
                 << 16);
            mma_s8(pvi[d], pa, b0, b1);
          }
        }
      } else {
        unsigned pa[4][4];  // p in bf16 as the A fragments of 4 k-steps
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          pa[j >> 1][(j & 1) * 2] = pack_bf16(p[j][0], p[j][1]);
          pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[j][2], p[j][3]);
        }
        const bf16* tv = reinterpret_cast<const bf16*>(sv + buf * VB_TILE);
        const int mi = lane >> 3;
        const bf16* base =
            tv + ((mi & 1) * 8 + (lane & 7)) * VB_LD + (mi >> 1) * 8;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int d = 0; d < 16; d += 2) {
            unsigned bv[4];
            ldmatrix_x4_trans(bv, base + kk * 16 * VB_LD + d * 8);
            mma_bf16(pvf[d], pa[kk], bv[0], bv[1]);
            mma_bf16(pvf[d + 1], pa[kk], bv[2], bv[3]);
          }
        }
      }
      if (t == n - 1) {  // the block is done: fold it into l and acc
        l0 = __fadd_rn(__fmul_rn(l0, c0), quad_sum(ls0));
        l1 = __fadd_rn(__fmul_rn(l1, c1), quad_sum(ls1));
#pragma unroll
        for (int d = 0; d < 16; ++d)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float add =
                PV_I8 ? __fmul_rn(static_cast<float>(pvi[d][e]), pv_scale)
                      : pvf[d][e];
            o[d][e] = __fadd_rn(__fmul_rn(o[d][e], e < 2 ? c0 : c1), add);
          }
      }
    }
    __syncthreads();  // this buffer is refilled two steps on
  }

  const float il0 = fmaxf(l0, 1e-30f), il1 = fmaxf(l1, 1e-30f);
  bf16* ob = out + (static_cast<size_t>(b) * S * nh + h) * HD;
  const size_t row_stride = static_cast<size_t>(nh) * HD;
#pragma unroll
  for (int d = 0; d < 16; ++d) {
    const int col = d * 8 + tq * 2;
    *reinterpret_cast<unsigned*>(ob + row0 * row_stride + col) =
        pack_bf16(o[d][0] / il0, o[d][1] / il0);
    *reinterpret_cast<unsigned*>(ob + (row0 + 8) * row_stride + col) =
        pack_bf16(o[d][2] / il1, o[d][3] / il1);
  }
}

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
        flash_prefill_i8_kernel<PV_I8>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(PV_I8));
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  flash_prefill_i8_kernel<PV_I8>
      <<<dim3(S / BQ, nh, B), THREADS, smem_bytes(PV_I8), s>>>(
          static_cast<const bf16*>(q), static_cast<const int8_t*>(k8),
          static_cast<const int8_t*>(v8t), static_cast<const bf16*>(v),
          static_cast<const float*>(sc), static_cast<bf16*>(out), q_sb, q_ss,
          q_sh, v_sb, v_ss, v_sh, S, nh, nkv, nh / nkv, blk_k, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, S, nh, 128] bf16 through strides (q_sb, q_ss, q_sh); K through
// (k_sb, k_sh, k_ss) as [B, nkv, S, 128]; v through (v_sb, v_ss, v_sh) as
// [B, S, nkv, 128]; every head-dim stride 1, every stride a multiple of 8
// elements and the bases 16-byte aligned. Scratch: k8 int8 [B, nkv, S,
// 128], v8t int8 [B, nkv, 128, S] (written only with pv_i8), sc f32
// [B, nkv, 2]. out [B, S, nh, 128] bf16 contiguous. S % 128 == 0, blk_k a
// multiple of 64 dividing S, nh % nkv == 0 (checked in Python); scale =
// sm_scale * log2(e).
extern "C" int fq_flash_prefill_i8(const void* q, const void* k,
                                   const void* v, void* k8, void* v8t,
                                   void* sc, void* out, int q_sb, int q_ss,
                                   int q_sh, int k_sb, int k_sh, int k_ss,
                                   int v_sb, int v_ss, int v_sh, int B, int S,
                                   int nh, int nkv, int blk_k, int pv_i8,
                                   float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  kv_quant_i8_kernel<<<dim3(nkv, B), PRE_THREADS, 0, s>>>(
      static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<int8_t*>(k8), static_cast<int8_t*>(v8t),
      static_cast<float*>(sc), k_sb, k_sh, k_ss, v_sb, v_ss, v_sh, S, nkv,
      pv_i8);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return pv_i8 ? launch_flash<true>(q, k8, v8t, v, sc, out, q_sb, q_ss, q_sh,
                                    v_sb, v_ss, v_sh, B, S, nh, nkv, blk_k,
                                    scale, s)
               : launch_flash<false>(q, k8, v8t, v, sc, out, q_sb, q_ss, q_sh,
                                     v_sb, v_ss, v_sh, B, S, nh, nkv, blk_k,
                                     scale, s);
}
