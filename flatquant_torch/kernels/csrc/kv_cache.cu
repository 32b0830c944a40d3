// Kernels over the packed asymmetric-int4 KV cache, token-major layout:
//   slot cache  codes  [B, nkv, S, hd/2] uint8, byte c = q[c] | q[c + hd/2] << 4
//               params [B, nkv, S, 2]    f32 (scale, zero) per (token, head)
//   block pool  codes  [n_blocks, nkv, bs, hd/2], params [n_blocks, nkv, bs, 2]
//               (each block token-major like the slot cache), read through a
//               block table tbl [B, mb] int32: token t of slot b lies in pool
//               block tbl[b, t / bs] at offset t % bs
// A cached value is (q - zero) * scale with q in [0, 15].
//
// Every attention kernel here walks tiles of TS = 128 tokens. A tile is
// addressed through `tile_offset<PAGED>`: its first token's index into the
// codes/params arrays, contiguous for the next TS tokens. In the pool that
// holds because the wrappers require bs % 128 == 0, so a tile never
// straddles a block. The slot and paged twins of each kernel are one body
// instantiated twice and sum in the same order, so slot-cache and paged
// serving agree bit for bit.
//
// ---------------------------------------------------------------------
// decode_attention_int4 / paged_decode_attention_int4
//
// Replace: flatquant_tpu/kernels/kv_cache.py:decode_attention_int4_v4 and
// flatquant_tpu/kernels/paged_kv.py:paged_decode_attention_int4 (Pallas;
// the v4 lane-transposed layout is a TPU VMEM choice and is not carried
// over; the paged kernel's clamped index map becomes the skipped tiles).
//
// One query token per slot, GQA: query head h*n_rep + r reads kv head h,
// for every n_rep from 1 to 8 (a template instance each).
// Scale and zero fold into the epilogues (no per-element dequant):
//   score[r, t] = (q_r . c_t - sum(q_r) * z_t) * s_t * sm_scale
//   out[r]      = (sum_t p'_t c_t - sum_t p'_t zv_t) / l,  p' = p * sv_t
// with an online softmax over tiles of TS tokens. Tokens at or past
// valid_len[b] are masked; a slot with valid_len 0 gives 0, like
// decode_attention_ref.
//
// What bounds it on the H100: bytes. Each valid token reads 64 B of K
// codes, 64 B of V codes and 16 B of params per kv head, against ~4*hd
// float operations per query head -- far below the compute roof, so the
// floor is the valid cache bytes / 3.35 TB/s.
//
// Design: one CTA per (b, kv head), 128 threads looping over the tiles up
// to valid_len (tiles past it are skipped: they would add nothing).
// Thread t scores token t of the tile against the n_rep query heads held
// in shared memory (broadcast reads) and stages the token's V codes in
// shared memory; after a barrier each warp runs the softmax update of its
// query heads; after another, thread d accumulates output dimension d.
// At B=1 with MHA that is only 32 CTAs on 132 SMs, so a single slot sits
// far below the bandwidth bound; splitting S across CTAs is later work.
//
// The same body, with DEQUANT, also replaces the JAX package's measured
// baselines flatquant_tpu/kernels/kv_cache.py:decode_attention_int4 (the
// port's decode_attention_int4_v1) and decode_attention_int4_wide: both
// dequantize every K/V element, (code - zero) * scale, before the q.k and
// p.v products, which rounds otherwise than the folded epilogues. Their
// blocks of 128 (v1) and 512 keys (wide) and the wide kernel's one grid
// step per batch element are TPU grid choices: the block only moves where
// the online max is taken, which the float32 softmax absorbs, so one
// launch serves both. kv_cache.py:decode_attention_int4_v3 (scale and
// zero folded, on this same token-major layout) is the body without
// DEQUANT, i.e. fq_decode_attention_int4 itself.
// ---------------------------------------------------------------------
// chunk_attention_int4 / paged_chunk_attention_int4
//
// Replace: flatquant_tpu/kernels/kv_cache.py:chunk_attention_int4_v4 and
// flatquant_tpu/kernels/paged_kv.py:paged_chunk_attention_int4 (Pallas).
//
// A prefill chunk of Sq query tokens starting at position pos[b] attends
// the cache, which already holds the chunk's own K/V: query row s sees
// cache ids <= pos + s. Per kv head the n_rep * Sq rows are flattened,
// row r = rep * Sq + s, for any n_rep (R = n_rep * Sq is a runtime count
// and each row's limit is pos + r % Sq). Same algebraic dequant and online softmax as the
// decode kernel, float32 throughout (q arrives in float32).
//
// What bounds it on the H100: operations. At the serving chunk (Sq = 256
// rows per head after a history of up to 1792 tokens) each row does ~4*hd
// float32 operations per key it sees, about 8 GFLOP for llama-2-7b's 32
// heads at pos 1792 against 13 MB of cache, q and output: 0.12 ms at the
// 67 TFLOP/s float32 rate of the CUDA cores, 0.004 ms of bytes.
//
// Design: one CTA per (block of RB = 32 rows, kv head, slot), 128
// threads. The rows' queries sit in shared memory; the CTA walks key tiles
// of 128 up to the largest limit among its rows (later tiles are fully
// masked for every row and are skipped; a tile masked for some rows adds
// exactly 0 to them, since the running max is floored at -1e30). Thread t
// scores key t against all 32 rows (float4 broadcast reads of q: one
// shared load per four FMAs), the softmax update runs one warp per row,
// and thread d accumulates output dimension d of all 32 rows (float4
// broadcast reads of p). K/V are re-read once per row block (8 blocks per
// head at Sq = 256, MHA), mostly from L2. The float32 CUDA-core rate
// bounds it; tensor cores (q split into bf16 hi + lo) are later work.
// ---------------------------------------------------------------------
// write_token
//
// Replaces: flatquant_tpu/kernels/kv_cache.py:write_token_v4 (Pallas
// windowed DMA read-modify-write; the 128-lane window exists only for the
// TPU's lane rules).
//
// In place, slot b's one new token (K and V codes and (scale, zero)) lands
// at position pos[b]; a position outside [0, S) writes nothing, exactly
// like the masked select it must equal bit for bit. Bound: bytes, B * nkv
// * (2*hd/2 + 16) written; it is a plain scatter, one CTA per slot.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int HD = 128;        // head dim the attention kernels take
constexpr int HB = HD / 2;     // packed bytes per (token, head)
constexpr int TS = 128;        // tokens per tile = threads per CTA
constexpr int VROW = HB + 16;  // padded shared-memory row of V codes
constexpr int RB = 32;         // query rows per CTA of the chunk kernels

// Index (in tokens) of token t0 of (slot b, kv head h) in the codes/params
// arrays; the next TS tokens follow contiguously. Slot cache: S tokens per
// (b, h). Pool: through this slot's row of the block table.
template <bool PAGED>
__device__ __forceinline__ size_t tile_offset(int b, int h, int t0, int nkv,
                                              int S, const int* tbl, int mb,
                                              int bs) {
  if (PAGED)
    return (static_cast<size_t>(tbl[static_cast<size_t>(b) * mb + t0 / bs]) *
                nkv + h) * bs + (t0 % bs);
  return (static_cast<size_t>(b) * nkv + h) * S + t0;
}

// S_eff: tokens per slot (the slot cache's S, or mb * bs for the pool).
// DEQUANT: every K/V element is dequantized, (code - zero) * scale, before
// both products (rows 19 and 20 of the kernel table); else scale and zero
// fold into the epilogues.
template <int NREP, bool PAGED, bool DEQUANT>
__global__ void __launch_bounds__(TS)
decode_attention_int4_kernel(const float* __restrict__ q,
                             const uint8_t* __restrict__ kp,
                             const float* __restrict__ kpar,
                             const uint8_t* __restrict__ vp,
                             const float* __restrict__ vpar,
                             const int* __restrict__ valid_len,
                             const int* __restrict__ tbl,
                             float* __restrict__ out, int nkv, int S_eff,
                             int mb, int bs, float sm_scale) {
  constexpr int NWARP = TS / 32;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  __shared__ float q_s[NREP][HD];
  __shared__ float p_s[NREP][TS];  // scores, then p * v_scale
  __shared__ float qsum_s[NREP], m_s[NREP], l_s[NREP], z_s[NREP],
      corr_s[NREP];
  __shared__ float vs_s[TS], vz_s[TS];
  __shared__ __align__(16) uint8_t v_s[TS * VROW];

  const size_t head = static_cast<size_t>(b) * nkv + h;
  const float* qh = q + head * NREP * HD;
#pragma unroll
  for (int r = 0; r < NREP; ++r) q_s[r][tid] = qh[r * HD + tid];
  __syncthreads();
  for (int r = warp; r < NREP; r += NWARP) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < HD / 32; ++i) s += q_s[r][lane + 32 * i];
    s = warp_sum(s);
    if (lane == 0) {
      qsum_s[r] = s;
      m_s[r] = -1e30f;
      l_s[r] = 0.f;
      z_s[r] = 0.f;
    }
  }
  float acc[NREP];
#pragma unroll
  for (int r = 0; r < NREP; ++r) acc[r] = 0.f;
  __syncthreads();

  const int valid = min(valid_len[b], S_eff);
  const float2* kpar2 = reinterpret_cast<const float2*>(kpar);
  const float2* vpar2 = reinterpret_cast<const float2*>(vpar);

  for (int s0 = 0; s0 < valid; s0 += TS) {
    const size_t tok =
        tile_offset<PAGED>(b, h, s0, nkv, S_eff, tbl, mb, bs) + tid;
    const int t = s0 + tid;
    // ---- scores of token t, and its V codes staged in shared memory
    float sc[NREP];
    if (t < valid) {
      float raw[NREP];
#pragma unroll
      for (int r = 0; r < NREP; ++r) raw[r] = 0.f;
      const float2 kpr = kpar2[tok];  // (scale, zero)
      const uint8_t* kt = kp + tok * HB;
#pragma unroll
      for (int j16 = 0; j16 < HB / 16; ++j16) {
        const uint4 w = ldg16(kt + 16 * j16);
        const unsigned words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int wi = 0; wi < 4; ++wi) {
#pragma unroll
          for (int bi = 0; bi < 4; ++bi) {
            const int d = 16 * j16 + 4 * wi + bi;
            const unsigned byte = (words[wi] >> (8 * bi)) & 0xFFu;
            float lo = static_cast<float>(byte & 0xFu);
            float hi = static_cast<float>(byte >> 4);
            if (DEQUANT) {
              lo = (lo - kpr.y) * kpr.x;
              hi = (hi - kpr.y) * kpr.x;
            }
#pragma unroll
            for (int r = 0; r < NREP; ++r)
              raw[r] = fmaf(q_s[r][d], lo, fmaf(q_s[r][d + HB], hi, raw[r]));
          }
        }
      }
#pragma unroll
      for (int r = 0; r < NREP; ++r)
        sc[r] = DEQUANT ? raw[r] * sm_scale
                        : (raw[r] - qsum_s[r] * kpr.y) * kpr.x * sm_scale;
      const uint8_t* vt = vp + tok * HB;
#pragma unroll
      for (int j16 = 0; j16 < HB / 16; ++j16)
        *reinterpret_cast<uint4*>(v_s + tid * VROW + 16 * j16) =
            ldg16(vt + 16 * j16);
      const float2 vpr = vpar2[tok];
      vs_s[tid] = vpr.x;
      vz_s[tid] = vpr.y;
    } else {
#pragma unroll
      for (int r = 0; r < NREP; ++r) sc[r] = -INFINITY;
      vs_s[tid] = 0.f;
      vz_s[tid] = 0.f;
    }
#pragma unroll
    for (int r = 0; r < NREP; ++r) p_s[r][tid] = sc[r];
    __syncthreads();

    // ---- online-softmax update, one warp per query head
    for (int r = warp; r < NREP; r += NWARP) {
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < TS / 32; ++i) mx = fmaxf(mx, p_s[r][lane + 32 * i]);
      mx = warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(fmaxf(m_old, mx), -1e30f);
      float ps = 0.f, zs = 0.f;
#pragma unroll
      for (int i = 0; i < TS / 32; ++i) {
        const int j = lane + 32 * i;
        const float p = expf(p_s[r][j] - m_new);
        ps += p;
        if (DEQUANT) {
          p_s[r][j] = p;
        } else {
          const float pv = p * vs_s[j];
          zs += pv * vz_s[j];
          p_s[r][j] = pv;
        }
      }
      ps = warp_sum(ps);
      zs = warp_sum(zs);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        corr_s[r] = corr;
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + ps;
        z_s[r] = z_s[r] * corr + zs;
      }
    }
    __syncthreads();

    // ---- P'V: thread tid owns output dimension d = tid
    {
      const int d = tid;
      const int col = d & (HB - 1);
      const int shift = (d >= HB) ? 4 : 0;
      const int n = min(TS, valid - s0);
      float part[NREP];
#pragma unroll
      for (int r = 0; r < NREP; ++r) part[r] = 0.f;
      for (int j = 0; j < n; ++j) {
        float c = static_cast<float>((v_s[j * VROW + col] >> shift) & 0xF);
        if (DEQUANT) c = (c - vz_s[j]) * vs_s[j];
#pragma unroll
        for (int r = 0; r < NREP; ++r) part[r] = fmaf(p_s[r][j], c, part[r]);
      }
#pragma unroll
      for (int r = 0; r < NREP; ++r) acc[r] = acc[r] * corr_s[r] + part[r];
    }
    __syncthreads();
  }

  float* oh = out + head * NREP * HD;
#pragma unroll
  for (int r = 0; r < NREP; ++r)
    oh[r * HD + tid] = (acc[r] - z_s[r]) / fmaxf(l_s[r], 1e-30f);
}

// q f32 [B, nkv, R, HD] (row r = rep * Sq + s); out the same.
template <bool PAGED>
__global__ void __launch_bounds__(TS)
chunk_attention_int4_kernel(const float* __restrict__ q,
                            const uint8_t* __restrict__ kp,
                            const float* __restrict__ kpar,
                            const uint8_t* __restrict__ vp,
                            const float* __restrict__ vpar,
                            const int* __restrict__ pos_b,
                            const int* __restrict__ tbl,
                            float* __restrict__ out, int nkv, int R, int Sq,
                            int S_eff, int mb, int bs, float sm_scale) {
  constexpr int NWARP = TS / 32;
  const int r0 = blockIdx.x * RB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nrows = min(RB, R - r0);

  __shared__ __align__(16) float q_s[RB][HD];
  __shared__ __align__(16) float p_s[RB][TS];  // scores, then p * v_scale
  __shared__ float qsum_s[RB], m_s[RB], l_s[RB], z_s[RB], corr_s[RB];
  __shared__ int lim_s[RB];
  __shared__ float vs_s[TS], vz_s[TS];
  __shared__ __align__(16) uint8_t v_s[TS * VROW];

  const size_t head = static_cast<size_t>(b) * nkv + h;
  const float* qh = q + (head * R + r0) * HD;
  for (int i = tid; i < RB * HD; i += TS)
    q_s[i / HD][i % HD] = (i / HD < nrows) ? qh[i] : 0.f;
  const int pos = pos_b[b];
  // row r sees ids <= pos + s; rows past the last one see nothing
  int kend = 0;
  for (int r = 0; r < nrows; ++r) kend = max(kend, pos + (r0 + r) % Sq + 1);
  kend = min(kend, S_eff);
  if (tid < RB) lim_s[tid] = (tid < nrows) ? pos + (r0 + tid) % Sq : -1;
  __syncthreads();
  for (int r = warp; r < RB; r += NWARP) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < HD / 32; ++i) s += q_s[r][lane + 32 * i];
    s = warp_sum(s);
    if (lane == 0) {
      qsum_s[r] = s;
      m_s[r] = -1e30f;
      l_s[r] = 0.f;
      z_s[r] = 0.f;
    }
  }
  float acc[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) acc[r] = 0.f;
  __syncthreads();

  const float2* kpar2 = reinterpret_cast<const float2*>(kpar);
  const float2* vpar2 = reinterpret_cast<const float2*>(vpar);

  for (int s0 = 0; s0 < kend; s0 += TS) {
    const size_t tok =
        tile_offset<PAGED>(b, h, s0, nkv, S_eff, tbl, mb, bs) + tid;
    const int t = s0 + tid;
    // ---- scores of key t against every row; its V codes to shared memory
    if (t < kend) {
      float raw[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) raw[r] = 0.f;
      const uint8_t* kt = kp + tok * HB;
#pragma unroll 1
      for (int j16 = 0; j16 < HB / 16; ++j16) {
        const uint4 w = ldg16(kt + 16 * j16);
        const unsigned words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int wi = 0; wi < 4; ++wi) {
          const int c = 16 * j16 + 4 * wi;  // dims c..c+3 and c+HB..c+HB+3
          float lo[4], hi[4];
#pragma unroll
          for (int bi = 0; bi < 4; ++bi) {
            const unsigned byte = (words[wi] >> (8 * bi)) & 0xFFu;
            lo[bi] = static_cast<float>(byte & 0xFu);
            hi[bi] = static_cast<float>(byte >> 4);
          }
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            const float4 ql = *reinterpret_cast<const float4*>(&q_s[r][c]);
            const float4 qu =
                *reinterpret_cast<const float4*>(&q_s[r][c + HB]);
            float a = raw[r];
            a = fmaf(ql.x, lo[0], fmaf(qu.x, hi[0], a));
            a = fmaf(ql.y, lo[1], fmaf(qu.y, hi[1], a));
            a = fmaf(ql.z, lo[2], fmaf(qu.z, hi[2], a));
            a = fmaf(ql.w, lo[3], fmaf(qu.w, hi[3], a));
            raw[r] = a;
          }
        }
      }
      const float2 kpr = kpar2[tok];  // (scale, zero)
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float sc = (raw[r] - qsum_s[r] * kpr.y) * kpr.x * sm_scale;
        p_s[r][tid] = (t <= lim_s[r]) ? sc : -INFINITY;
      }
      const uint8_t* vt = vp + tok * HB;
#pragma unroll
      for (int j16 = 0; j16 < HB / 16; ++j16)
        *reinterpret_cast<uint4*>(v_s + tid * VROW + 16 * j16) =
            ldg16(vt + 16 * j16);
      const float2 vpr = vpar2[tok];
      vs_s[tid] = vpr.x;
      vz_s[tid] = vpr.y;
    } else {
#pragma unroll
      for (int r = 0; r < RB; ++r) p_s[r][tid] = -INFINITY;
      vs_s[tid] = 0.f;
      vz_s[tid] = 0.f;
    }
    __syncthreads();

    // ---- online-softmax update, one warp per row
    for (int r = warp; r < RB; r += NWARP) {
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < TS / 32; ++i) mx = fmaxf(mx, p_s[r][lane + 32 * i]);
      mx = warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(fmaxf(m_old, mx), -1e30f);
      float ps = 0.f, zs = 0.f;
#pragma unroll
      for (int i = 0; i < TS / 32; ++i) {
        const int j = lane + 32 * i;
        const float p = expf(p_s[r][j] - m_new);
        const float pv = p * vs_s[j];
        ps += p;
        zs += pv * vz_s[j];
        p_s[r][j] = pv;
      }
      ps = warp_sum(ps);
      zs = warp_sum(zs);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        corr_s[r] = corr;
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + ps;
        z_s[r] = z_s[r] * corr + zs;
      }
    }
    __syncthreads();

    // ---- P'V: thread tid owns output dimension d = tid of every row
    {
      const int d = tid;
      const int col = d & (HB - 1);
      const int shift = (d >= HB) ? 4 : 0;
      const int n = min(TS, kend - s0);  // later keys have p = 0
      float part[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) part[r] = 0.f;
      int j = 0;
      for (; j + 4 <= n; j += 4) {
        float c[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          c[k] = static_cast<float>((v_s[(j + k) * VROW + col] >> shift) & 0xF);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const float4 p = *reinterpret_cast<const float4*>(&p_s[r][j]);
          float a = part[r];
          a = fmaf(p.x, c[0], a);
          a = fmaf(p.y, c[1], a);
          a = fmaf(p.z, c[2], a);
          a = fmaf(p.w, c[3], a);
          part[r] = a;
        }
      }
      for (; j < n; ++j) {
        const float c =
            static_cast<float>((v_s[j * VROW + col] >> shift) & 0xF);
#pragma unroll
        for (int r = 0; r < RB; ++r) part[r] = fmaf(p_s[r][j], c, part[r]);
      }
#pragma unroll
      for (int r = 0; r < RB; ++r) acc[r] = acc[r] * corr_s[r] + part[r];
    }
    __syncthreads();
  }

  float* oh = out + (head * R + r0) * HD;
#pragma unroll
  for (int r = 0; r < RB; ++r)
    if (r < nrows)
      oh[r * HD + tid] = (acc[r] - z_s[r]) / fmaxf(l_s[r], 1e-30f);
}

__global__ void write_token_kernel(uint8_t* __restrict__ kp,
                                   float* __restrict__ kpar,
                                   uint8_t* __restrict__ vp,
                                   float* __restrict__ vpar,
                                   const uint8_t* __restrict__ kq,
                                   const float* __restrict__ kpn,
                                   const uint8_t* __restrict__ vq,
                                   const float* __restrict__ vpn,
                                   const int* __restrict__ pos, int nkv,
                                   int S, int hdh) {
  const int b = blockIdx.x;
  const int p = pos[b];
  if (p < 0 || p >= S) return;
  for (int i = threadIdx.x; i < nkv * hdh; i += blockDim.x) {
    const int h = i / hdh, j = i - h * hdh;
    const size_t dst = ((static_cast<size_t>(b) * nkv + h) * S + p) * hdh + j;
    const size_t src = static_cast<size_t>(b) * nkv * hdh + i;
    kp[dst] = kq[src];
    vp[dst] = vq[src];
  }
  for (int i = threadIdx.x; i < nkv * 2; i += blockDim.x) {
    const int h = i >> 1, e = i & 1;
    const size_t dst = ((static_cast<size_t>(b) * nkv + h) * S + p) * 2 + e;
    const size_t src = static_cast<size_t>(b) * nkv * 2 + i;
    kpar[dst] = kpn[src];
    vpar[dst] = vpn[src];
  }
}

template <bool PAGED, bool DEQUANT>
int launch_decode(const void* q, const void* kp, const void* kpar,
                  const void* vp, const void* vpar, const void* tbl,
                  const void* valid, void* out, int B, int nkv, int n_rep,
                  int S_eff, int mb, int bs, float sm_scale, void* stream) {
  dim3 grid(nkv, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FQ_LAUNCH(NR)                                                       \
  decode_attention_int4_kernel<NR, PAGED, DEQUANT><<<grid, TS, 0, s>>>(    \
      static_cast<const float*>(q), static_cast<const uint8_t*>(kp),       \
      static_cast<const float*>(kpar), static_cast<const uint8_t*>(vp),    \
      static_cast<const float*>(vpar), static_cast<const int*>(valid),     \
      static_cast<const int*>(tbl), static_cast<float*>(out), nkv, S_eff,  \
      mb, bs, sm_scale)
  // every GQA group size of the registered models: Qwen-2.5-7B has 7
  // query heads per kv head, Qwen-2.5-32B 5
  switch (n_rep) {
    case 1: FQ_LAUNCH(1); break;
    case 2: FQ_LAUNCH(2); break;
    case 3: FQ_LAUNCH(3); break;
    case 4: FQ_LAUNCH(4); break;
    case 5: FQ_LAUNCH(5); break;
    case 6: FQ_LAUNCH(6); break;
    case 7: FQ_LAUNCH(7); break;
    case 8: FQ_LAUNCH(8); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FQ_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

template <bool PAGED>
int launch_chunk(const void* q, const void* kp, const void* kpar,
                 const void* vp, const void* vpar, const void* tbl,
                 const void* pos, void* out, int B, int nkv, int R, int Sq,
                 int S_eff, int mb, int bs, float sm_scale, void* stream) {
  dim3 grid((R + RB - 1) / RB, nkv, B);
  chunk_attention_int4_kernel<PAGED>
      <<<grid, TS, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(q), static_cast<const uint8_t*>(kp),
          static_cast<const float*>(kpar), static_cast<const uint8_t*>(vp),
          static_cast<const float*>(vpar), static_cast<const int*>(pos),
          static_cast<const int*>(tbl), static_cast<float*>(out), nkv, R, Sq,
          S_eff, mb, bs, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q f32 [B, nkv*n_rep, 128]; kp/vp u8 [B, nkv, S, 64]; kpar/vpar f32
// [B, nkv, S, 2]; valid int32 [B]; out f32 [B, nkv*n_rep, 128].
extern "C" int fq_decode_attention_int4(const void* q, const void* kp,
                                        const void* kpar, const void* vp,
                                        const void* vpar, const void* valid,
                                        void* out, int B, int nkv, int n_rep,
                                        int S, float sm_scale, void* stream) {
  return launch_decode<false, false>(q, kp, kpar, vp, vpar, nullptr, valid,
                                     out, B, nkv, n_rep, S, 0, 1, sm_scale,
                                     stream);
}

// fq_decode_attention_int4's arguments; every K/V element dequantized
// before the products (decode_attention_int4_v1 and _wide).
extern "C" int fq_decode_attention_int4_dequant(
    const void* q, const void* kp, const void* kpar, const void* vp,
    const void* vpar, const void* valid, void* out, int B, int nkv, int n_rep,
    int S, float sm_scale, void* stream) {
  return launch_decode<false, true>(q, kp, kpar, vp, vpar, nullptr, valid,
                                    out, B, nkv, n_rep, S, 0, 1, sm_scale,
                                    stream);
}

// q, valid, out as above; kp/vp u8 [nb, nkv, bs, 64]; kpar/vpar f32
// [nb, nkv, bs, 2]; tbl int32 [B, mb]; bs % 128 == 0.
extern "C" int fq_paged_decode_attention_int4(
    const void* q, const void* kp, const void* kpar, const void* vp,
    const void* vpar, const void* tbl, const void* valid, void* out, int B,
    int nkv, int n_rep, int mb, int bs, float sm_scale, void* stream) {
  if (bs % TS != 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_decode<true, false>(q, kp, kpar, vp, vpar, tbl, valid, out,
                                    B, nkv, n_rep, mb * bs, mb, bs, sm_scale,
                                    stream);
}

// q f32 [B, nkv, R, 128] (R = n_rep * Sq, row r = rep * Sq + s); caches as
// fq_decode_attention_int4; pos int32 [B]; out f32 like q.
extern "C" int fq_chunk_attention_int4(const void* q, const void* kp,
                                       const void* kpar, const void* vp,
                                       const void* vpar, const void* pos,
                                       void* out, int B, int nkv, int R,
                                       int Sq, int S, float sm_scale,
                                       void* stream) {
  return launch_chunk<false>(q, kp, kpar, vp, vpar, nullptr, pos, out, B, nkv,
                             R, Sq, S, 0, 1, sm_scale, stream);
}

// q, pos, out as fq_chunk_attention_int4; pools and tbl as
// fq_paged_decode_attention_int4.
extern "C" int fq_paged_chunk_attention_int4(
    const void* q, const void* kp, const void* kpar, const void* vp,
    const void* vpar, const void* tbl, const void* pos, void* out, int B,
    int nkv, int R, int Sq, int mb, int bs, float sm_scale, void* stream) {
  if (bs % TS != 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_chunk<true>(q, kp, kpar, vp, vpar, tbl, pos, out, B, nkv, R,
                            Sq, mb * bs, mb, bs, sm_scale, stream);
}

// caches as above (updated in place); kq/vq u8 [B, nkv, 1, hdh]; kpn/vpn
// f32 [B, nkv, 1, 2]; pos int32 [B].
extern "C" int fq_write_token(void* kp, void* kpar, void* vp, void* vpar,
                              const void* kq, const void* kpn, const void* vq,
                              const void* vpn, const void* pos, int B,
                              int nkv, int S, int hdh, void* stream) {
  write_token_kernel<<<B, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(kp), static_cast<float*>(kpar),
      static_cast<uint8_t*>(vp), static_cast<float*>(vpar),
      static_cast<const uint8_t*>(kq), static_cast<const float*>(kpn),
      static_cast<const uint8_t*>(vq), static_cast<const float*>(vpn),
      static_cast<const int*>(pos), nkv, S, hdh);
  return static_cast<int>(cudaGetLastError());
}
