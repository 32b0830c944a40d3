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
// floor is the valid cache bytes / 3.35 TB/s. At one slot and few kv heads
// (Qwen-2.5-7B's B = 1: 4) the cache is small and the time is the latency
// of the tiles one CTA walks in turn.
//
// Design: a split over the sequence (flash decoding). The grid is
// (kv head, slot, n_span), so every slot's first span is dispatched before
// any later one; CTA j owns the absolute positions [j * span,
// (j + 1) * span), span a multiple of TS set by the wrapper
// (kernels/kv_cache.py DECODE_SPAN). It loads q together with valid_len,
// and a tile's K and V rows into registers while q (or the tile before) is
// being worked on. It walks its tiles with 256 threads: threads 2t and
// 2t + 1 score token t of the tile against the n_rep query heads held in
// shared memory (half the code bytes each, then a shuffle) and stage the
// token's V codes; after a barrier warp r runs the softmax update of query
// head r; after another, thread (d, th) accumulates output dimension d
// over the tile's token half th (four tokens a step), the halves added at
// the span's end.
//   A CTA whose span starts at or past valid_len exits at once (the host
// never reads valid_len), except span 0, which writes the zeros of a slot
// with valid_len 0. When valid_len fits in one span, that span writes the
// output itself. Otherwise every span writes its partial (m, l, z, acc) to
// a float32 workspace and takes an int32 ticket of its (slot, head) with
// one acquire-release atomic after a barrier (its partial is visible to
// the spans that draw later tickets, theirs to it). The span that draws
// the last ticket resets it to 0 (no memset per launch) and merges the
// partials in a fixed order: spans in chunks of 32, a lane each, the
// weights exp(m_j - M) in parallel, l and z as warp sums, acc over the
// even and the odd spans in turn (the first 16 spans' acc loaded before
// their weights are known), then the two sums added. So the result
// depends on the positions alone, not on the order the CTAs ran in, and
// the slot and paged instances stay bit-identical. One launch per call, no
// host sync, no state allocated per launch that must start zeroed (the
// tickets live across launches in a per-device array), so the launch can
// be captured in a CUDA graph. Launches that share a ticket array must run
// in stream order.
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
// and each row's limit is pos + r % Sq). Same algebraic dequant as the
// decode kernel, an online softmax in the exp2 domain (log2 e folded into
// each key's scale).
//
// What bounds it on the H100: operations. At the serving chunk (Sq = 256
// rows per head after a history of up to 1792 tokens) each row does ~4*hd
// operations per key it sees, about 8 GFLOP for llama-2-7b's 32 heads at
// pos 1792 against 13 MB of cache, q and output: 0.008 ms at the 989
// TFLOP/s bf16 rate of the tensor cores, 0.004 ms of bytes.
//
// Design: both products on wgmma bf16 with float32 sums. A CTA owns
// CH_ROWS = 64 rows of one (kv head, slot) and two consumer warpgroups,
// which take the 128-key tiles up to the block's largest limit (later
// tiles are masked for every row and are skipped) in turn, t = w, w + 2,
// ..., each with its own buffers and online softmax; their states merge at
// the end. One warpgroup alone on an SM left it idle on the latency of each
// step (S, epilogue, P V and decode in series); two overlap.
//   The rows' q is split once into bf16 hi + lo tiles in shared memory
// (128-byte swizzle, wgmma's K-major A); the lo pass is skipped when every
// lo is 0, as for the batcher's bf16 queries. A warpgroup's tile of K and
// V codes and params arrives by cp.async while it works on its previous
// tile, and it decodes both code tiles once into bf16 tiles (the codes
// 0-15 are exact) in the layout the descriptors read: [2 halves of 64
// dims][128 keys][128 B], 128-byte swizzle, which is K-major for S's B and
// MN-major for P V's B. S = q k^T on wgmma (hi, then lo); then in
// registers (raw - qsum * z_k) * s_k * sm_scale * log2 e, the per-row
// causal limit, the online max and sum; p' = p * s_v, z += sum p' z_v per
// row; p' is split into bf16 hi + lo (one bf16 rounding of p', ~2^-9,
// would break the float32 tolerance) and o += p'_hi V + p'_lo V as wgmma
// with p' from registers (the S accumulators pack into the A fragments in
// place, as in flash_prefill.cu). The rows of a block may have different
// limits: each thread masks its own two rows.
//
// write_token: see its kernel below.

#include <cuda_bf16.h>
#include <math.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int HD = 128;        // head dim the attention kernels take
constexpr int HB = HD / 2;     // packed bytes per (token, head)
constexpr int TS = 128;        // tokens per tile
constexpr int DT = 2 * TS;     // threads of a decode CTA: two a token
constexpr int VROW = HB + 16;  // padded shared-memory row of V codes

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
// fold into the epilogues. Grid (kv head, slot, span): every slot's first
// span is dispatched before any later one. ws: the spans' partials,
// [B * nkv][gridDim.z][NREP * (HD + 3)] float32 (acc [NREP][HD], then m,
// l, z [NREP]); tickets: [B * nkv] int32, 0 between launches.
template <int NREP, bool PAGED, bool DEQUANT>
__global__ void __launch_bounds__(DT)
decode_attention_int4_kernel(const float* __restrict__ q,
                             const uint8_t* __restrict__ kp,
                             const float* __restrict__ kpar,
                             const uint8_t* __restrict__ vp,
                             const float* __restrict__ vpar,
                             const int* __restrict__ valid_len,
                             const int* __restrict__ tbl, float* ws,
                             int* tickets, float* __restrict__ out, int nkv,
                             int S_eff, int mb, int bs, int span,
                             float sm_scale) {
  constexpr int NWARP = DT / 32;         // 8: a warp per query head
  constexpr int PART = NREP * (HD + 3);  // floats of one span's partial
  static_assert(NREP <= NWARP, "a warp per query head");
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int j = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tt = tid >> 1, kh = tid & 1;    // scores: token tt, bytes half kh
  const int d = tid & (HD - 1), th = tid >> 7;  // P V: dim d, tokens half th

  // q and valid_len in flight together
  constexpr int QPT = (NREP * HD + DT - 1) / DT;  // q values a thread
  const size_t head = static_cast<size_t>(b) * nkv + h;
  const float* qh = q + head * NREP * HD;
  float qv[QPT];
#pragma unroll
  for (int i = 0; i < QPT; ++i)
    qv[i] = tid + i * DT < NREP * HD ? qh[tid + i * DT] : 0.f;
  const int s_lo = j * span;
  const int valid = max(min(valid_len[b], S_eff), 0);
  if (j > 0 && s_lo >= valid) return;  // nothing of this span is valid
  const int nspan = max(1, (valid + span - 1) / span);
  const int s_hi = min(s_lo + span, valid);
  const float2* kpar2 = reinterpret_cast<const float2*>(kpar);
  const float2* vpar2 = reinterpret_cast<const float2*>(vpar);

  // token tt's half kh of its K and V code rows and its params, for the
  // tile at s0, in registers: the first tile's load while q is staged, the
  // next tile's under the current one's softmax and P V
  uint4 kw[2], vw[2];
  float2 kpr = make_float2(0.f, 0.f), vpr = make_float2(0.f, 0.f);
  auto load_tile = [&](int s0) {
    if (s0 + tt < s_hi) {
      const size_t tok =
          tile_offset<PAGED>(b, h, s0, nkv, S_eff, tbl, mb, bs) + tt;
#pragma unroll
      for (int j16 = 0; j16 < 2; ++j16) {
        kw[j16] = ldg16(kp + tok * HB + 32 * kh + 16 * j16);
        vw[j16] = ldg16(vp + tok * HB + 32 * kh + 16 * j16);
      }
      kpr = kpar2[tok];  // (scale, zero)
      vpr = vpar2[tok];
    }
  };
  load_tile(s_lo);

  __shared__ float q_s[NREP][HD];
  // scores, then p * v_scale; at the end the upper token half's acc
  __shared__ __align__(16) float p_s[NREP][TS];
  __shared__ float qsum_s[NREP], m_s[NREP], l_s[NREP], z_s[NREP],
      corr_s[NREP];
  __shared__ float vs_s[TS], vz_s[TS];
  __shared__ __align__(16) uint8_t v_s[TS * VROW];
  __shared__ int last_s;
  __shared__ float w_s[NREP][32], big_s[NREP], lm_s[NREP], zm_s[NREP];

#pragma unroll
  for (int i = 0; i < QPT; ++i)
    if (tid + i * DT < NREP * HD)
      q_s[(tid + i * DT) / HD][(tid + i * DT) % HD] = qv[i];
  __syncthreads();
  if (warp < NREP) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < HD / 32; ++i) s += q_s[warp][lane + 32 * i];
    s = warp_sum(s);
    if (lane == 0) {
      qsum_s[warp] = s;
      m_s[warp] = -1e30f;
      l_s[warp] = 0.f;
      z_s[warp] = 0.f;
    }
  }
  float acc[NREP];  // dim d over the tokens of half th of every tile
#pragma unroll
  for (int r = 0; r < NREP; ++r) acc[r] = 0.f;
  __syncthreads();

  for (int s0 = s_lo; s0 < s_hi; s0 += TS) {
    const bool live = s0 + tt < s_hi;
    // ---- scores of token tt, its 32 code bytes kh (dims 32 kh .. and
    // 64 + 32 kh ..) by each thread of the pair; its V codes staged
    float raw[NREP];
#pragma unroll
    for (int r = 0; r < NREP; ++r) raw[r] = 0.f;
    const float2 kz = kpr;  // (scale, zero)
    const float2 vz = vpr;
    if (live) {
#pragma unroll
      for (int j16 = 0; j16 < 2; ++j16) {
        const uint4 w = kw[j16];
        const unsigned words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int wi = 0; wi < 4; ++wi) {
#pragma unroll
          for (int bi = 0; bi < 4; ++bi) {
            const int dd = 32 * kh + 16 * j16 + 4 * wi + bi;
            const unsigned byte = (words[wi] >> (8 * bi)) & 0xFFu;
            float lo = static_cast<float>(byte & 0xFu);
            float hi = static_cast<float>(byte >> 4);
            if (DEQUANT) {
              lo = (lo - kz.y) * kz.x;
              hi = (hi - kz.y) * kz.x;
            }
#pragma unroll
            for (int r = 0; r < NREP; ++r)
              raw[r] = fmaf(q_s[r][dd], lo, fmaf(q_s[r][dd + HB], hi, raw[r]));
          }
        }
      }
#pragma unroll
      for (int j16 = 0; j16 < 2; ++j16)
        *reinterpret_cast<uint4*>(v_s + tt * VROW + 32 * kh + 16 * j16) =
            vw[j16];
    }
    if (s0 + TS < s_hi) load_tile(s0 + TS);
#pragma unroll
    for (int r = 0; r < NREP; ++r)
      raw[r] += __shfl_xor_sync(0xffffffffu, raw[r], 1);
    if (kh == 0) {
#pragma unroll
      for (int r = 0; r < NREP; ++r)
        p_s[r][tt] = !live ? -INFINITY
                     : DEQUANT
                         ? raw[r] * sm_scale
                         : (raw[r] - qsum_s[r] * kz.y) * kz.x * sm_scale;
      vs_s[tt] = live ? vz.x : 0.f;
      vz_s[tt] = live ? vz.y : 0.f;
    }
    __syncthreads();

    // ---- online-softmax update, a warp per query head
    if (warp < NREP) {
      const int r = warp;
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < TS / 32; ++i) mx = fmaxf(mx, p_s[r][lane + 32 * i]);
      mx = warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(fmaxf(m_old, mx), -1e30f);
      float ps = 0.f, zs = 0.f;
#pragma unroll
      for (int i = 0; i < TS / 32; ++i) {
        const int jj = lane + 32 * i;
        const float p = expf(p_s[r][jj] - m_new);
        ps += p;
        if (DEQUANT) {
          p_s[r][jj] = p;
        } else {
          const float pv = p * vs_s[jj];
          zs += pv * vz_s[jj];
          p_s[r][jj] = pv;
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

    // ---- P'V: thread (d, th) sums the tokens of half th for dim d
    {
      const int col = d & (HB - 1);
      const int shift = (d >= HB) ? 4 : 0;
      const int j1 = min(TS / 2 * (th + 1), s_hi - s0);
      float part[NREP];
#pragma unroll
      for (int r = 0; r < NREP; ++r) part[r] = 0.f;
      int jj = TS / 2 * th;
      for (; jj + 4 <= j1; jj += 4) {  // float4 reads of p, 4 tokens a step
        float c[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          c[k] = static_cast<float>((v_s[(jj + k) * VROW + col] >> shift) &
                                    0xF);
          if (DEQUANT) c[k] = (c[k] - vz_s[jj + k]) * vs_s[jj + k];
        }
#pragma unroll
        for (int r = 0; r < NREP; ++r) {
          const float4 p = *reinterpret_cast<const float4*>(&p_s[r][jj]);
          float a = part[r];
          a = fmaf(p.x, c[0], a);
          a = fmaf(p.y, c[1], a);
          a = fmaf(p.z, c[2], a);
          a = fmaf(p.w, c[3], a);
          part[r] = a;
        }
      }
      for (; jj < j1; ++jj) {
        float c = static_cast<float>((v_s[jj * VROW + col] >> shift) & 0xF);
        if (DEQUANT) c = (c - vz_s[jj]) * vs_s[jj];
#pragma unroll
        for (int r = 0; r < NREP; ++r) part[r] = fmaf(p_s[r][jj], c, part[r]);
      }
#pragma unroll
      for (int r = 0; r < NREP; ++r) acc[r] = acc[r] * corr_s[r] + part[r];
    }
    __syncthreads();
  }

  // ---- the two token halves: acc = half 0 + half 1
  if (th == 1) {
#pragma unroll
    for (int r = 0; r < NREP; ++r) p_s[r][d] = acc[r];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < NREP; ++r) acc[r] += p_s[r][d];  // used by th == 0

  float* oh = out + head * NREP * HD;
  if (nspan == 1) {  // the whole valid length is this span's
    if (th == 0) {
#pragma unroll
      for (int r = 0; r < NREP; ++r)
        oh[r * HD + d] = (acc[r] - z_s[r]) / fmaxf(l_s[r], 1e-30f);
    }
    return;
  }

  // ---- this span's partial, then the ticket of (b, h)
  float* part = ws + (head * gridDim.z + j) * PART;
  if (th == 0) {
#pragma unroll
    for (int r = 0; r < NREP; ++r) part[r * HD + d] = acc[r];
  }
  if (tid < NREP) {
    part[NREP * HD + tid] = m_s[tid];
    part[NREP * HD + NREP + tid] = l_s[tid];
    part[NREP * HD + 2 * NREP + tid] = z_s[tid];
  }
  __syncthreads();
  if (tid == 0) {
    // release: the block's partial (ordered before by the barrier) is
    // visible to whoever draws a later ticket; acquire: the partials of
    // the spans that drew earlier ones are visible to this block after
    // the barrier below
    int ticket;
    asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;\n"
                 : "=r"(ticket)
                 : "l"(tickets + head)
                 : "memory");
    last_s = ticket == nspan - 1;
    if (last_s) tickets[head] = 0;  // ready for the next launch
  }
  __syncthreads();
  if (!last_s) return;

  // ---- the last span merges the partials in a fixed order, spans in
  // chunks of 32: warp r takes query head r, a lane a span: the weights
  // w_j = exp(m_j - M) (M = max m_j), L and Z as warp sums; then thread
  // (d, th) adds w_j acc_j[d] over the chunk's spans j = th, th + 2, ...
  // in turn, and the halves are added last. __ldcg: other CTAs wrote the
  // partials during this launch, so not through the non-coherent path.
  const float* p0 = ws + head * gridDim.z * PART;
  const float* pm = p0 + NREP * HD;  // m, l, z of span 0, then PART apart
  if (warp < NREP) {
    float mx = -1e30f;
    if (nspan > 32)  // M before the first chunk's weights
      for (int jj = lane; jj < nspan; jj += 32)
        mx = fmaxf(mx, __ldcg(pm + jj * PART + warp));
    mx = warp_max(mx);
    if (lane == 0) {
      big_s[warp] = mx;
      lm_s[warp] = 0.f;
      zm_s[warp] = 0.f;
    }
  }
  // the first spans' acc, loaded before their weights are known
  constexpr int PRE = 8;  // spans a thread prefetches: j = th, th + 2, ...
  float pre[PRE][NREP];
#pragma unroll
  for (int k = 0; k < PRE; ++k) {
    const int jj = th + 2 * k;
#pragma unroll
    for (int r = 0; r < NREP; ++r)
      pre[k][r] = jj < min(nspan, 32) ? __ldcg(p0 + jj * PART + r * HD + d)
                                      : 0.f;
  }
  float A[NREP];
#pragma unroll
  for (int r = 0; r < NREP; ++r) A[r] = 0.f;
  for (int j0 = 0; j0 < nspan; j0 += 32) {
    __syncthreads();  // big_s is set; the last chunk's weights are used
    if (warp < NREP) {
      const int r = warp, jj = j0 + lane;
      const bool in = jj < nspan;
      const float* pj = pm + jj * PART;
      const float mj = in ? __ldcg(pj + r) : -1e30f;
      const float lj = in ? __ldcg(pj + NREP + r) : 0.f;
      const float zj = in ? __ldcg(pj + 2 * NREP + r) : 0.f;
      const float big = nspan > 32 ? big_s[r] : warp_max(mj);
      const float w = in ? expf(mj - big) : 0.f;
      w_s[r][lane] = w;
      const float lw = warp_sum(w * lj), zw = warp_sum(w * zj);
      if (lane == 0) {
        lm_s[r] += lw;
        zm_s[r] += zw;
      }
    }
    __syncthreads();
    const int n = min(32, nspan - j0);
    int k = th;
    if (j0 == 0) {  // the prefetched spans (0 past the last)
#pragma unroll
      for (int i = 0; i < PRE; ++i, k += 2) {
#pragma unroll
        for (int r = 0; r < NREP; ++r)
          A[r] = fmaf(k < n ? w_s[r][k] : 0.f, pre[i][r], A[r]);
      }
    }
#pragma unroll 8
    for (; k < n; k += 2) {
      const float* pj = p0 + (j0 + k) * PART + d;
#pragma unroll
      for (int r = 0; r < NREP; ++r)
        A[r] = fmaf(w_s[r][k], __ldcg(pj + r * HD), A[r]);
    }
  }
  if (th == 1) {  // p_s was last read before the barriers above
#pragma unroll
    for (int r = 0; r < NREP; ++r) p_s[r][d] = A[r];
  }
  __syncthreads();
  if (th == 0) {
#pragma unroll
    for (int r = 0; r < NREP; ++r)
      oh[r * HD + d] = (A[r] + p_s[r][d] - zm_s[r]) / fmaxf(lm_s[r], 1e-30f);
  }
}

// ---- chunk attention on wgmma ------------------------------------------

constexpr int CH_WG = 2;               // consumer warpgroups a block
constexpr int CH_ROWS = 64;            // query rows a block
constexpr int CH_THREADS = 128 * CH_WG;
constexpr int CH_QT = CH_ROWS * 256;   // q hi or lo: [2 halves][rows][128 B]
constexpr int CH_KV = TS * 256;        // decoded K or V: [2][128 keys][128 B]
constexpr int CH_RAWC = TS * HB;       // a tile's K or V codes
constexpr int CH_RAW = 2 * CH_RAWC + 2 * TS * 8;  // codes, then params
constexpr int CH_PAR = 4 * TS * 4;     // s_k * scale2, z_k, s_v, z_v
// a warpgroup's buffers: decoded K and V, the raw tile, the params
constexpr int CH_WGB = 2 * CH_KV + CH_RAW + CH_PAR;
// + 1024: the swizzled tiles start at a multiple of 1024 bytes
constexpr int CH_SMEM = 1024 + 2 * CH_QT + CH_WG * CH_WGB + CH_ROWS * 4;
static_assert(CH_SMEM <= 232448, "shared memory of one block");
static_assert(2 * CH_KV >= CH_ROWS * HD * 4 + 3 * CH_ROWS * 4,
              "a warpgroup's state fits its decoded tiles for the merge");

// cp.async of 8 bytes, `valid ? 8 : 0` of them read (the rest zeros)
__device__ __forceinline__ void cp_async8_zfill(void* smem, const void* gmem,
                                                bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(valid ? 8 : 0));
}

// bf16 pairs (128 + n0, 128 + n1) - 128 = (n0, n1), exactly
__device__ __forceinline__ unsigned bf16x2_minus128(unsigned x) {
  unsigned r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(r)
      : "r"(x), "r"(0x3F803F80u), "r"(0xC300C300u));
  return r;
}

// the four codes n (0-15) in the bytes of w as bf16: {n0, n1}, {n2, n3}.
// 0x43 over n in a bf16's bytes is 128 + n
__device__ __forceinline__ uint2 codes_bf16(unsigned w) {
  return make_uint2(bf16x2_minus128(__byte_perm(w, 0x43434343u, 0x4140)),
                    bf16x2_minus128(__byte_perm(w, 0x43434343u, 0x4342)));
}

// 8 packed bytes (columns c .. c + 7 of one token) -> the bf16 chunk of
// dims c .. c + 7 (low nibbles) at lo and of dims 64 + c .. (high) at hi
__device__ __forceinline__ void decode_chunk(uint2 w, uint8_t* lo,
                                             uint8_t* hi) {
  const uint2 a = codes_bf16(w.x & 0x0F0F0F0Fu);
  const uint2 b = codes_bf16(w.y & 0x0F0F0F0Fu);
  const uint2 c = codes_bf16((w.x >> 4) & 0x0F0F0F0Fu);
  const uint2 d = codes_bf16((w.y >> 4) & 0x0F0F0F0Fu);
  *reinterpret_cast<uint4*>(lo) = make_uint4(a.x, a.y, b.x, b.y);
  *reinterpret_cast<uint4*>(hi) = make_uint4(c.x, c.y, d.x, d.y);
}

// q f32 [B, nkv, R, HD] (row r = rep * Sq + s); out the same. Grid
// (row blocks, kv head, slot), the blocks with the latest rows first.
// Warpgroup w takes the block's key tiles t = w, w + CH_WG, ... with its
// own buffers and online softmax; the states merge at the end.
// scale2 = sm_scale * log2(e).
template <bool PAGED>
__global__ void __launch_bounds__(CH_THREADS, 1)
chunk_attention_int4_kernel(const float* __restrict__ q,
                            const uint8_t* __restrict__ kp,
                            const float* __restrict__ kpar,
                            const uint8_t* __restrict__ vp,
                            const float* __restrict__ vpar,
                            const int* __restrict__ pos_b,
                            const int* __restrict__ tbl,
                            float* __restrict__ out, int nkv, int R, int Sq,
                            int S_eff, int mb, int bs, float scale2) {
  extern __shared__ __align__(16) uint8_t ch_smem[];
  uint8_t* qhi = ch_smem + ((1024 - (smem_u32(ch_smem) & 1023)) & 1023);
  uint8_t* qlo = qhi + CH_QT;
  float* qsum_s = reinterpret_cast<float*>(qlo + CH_QT + CH_WG * CH_WGB);

  const int tid = threadIdx.x;
  const int cw = tid >> 7;  // this thread's warpgroup
  const int wt = tid & 127;
  const int warp = wt >> 5, lane = tid & 31;
  const int g8 = lane >> 2, tq = lane & 3;
  // this warpgroup's buffers
  uint8_t* kd = qlo + CH_QT + cw * CH_WGB;  // decoded K, then V
  uint8_t* vd = kd + CH_KV;
  uint8_t* rk = vd + CH_KV;  // raw K codes [TS][HB], then V codes
  uint8_t* rv = rk + CH_RAWC;
  float2* rkp = reinterpret_cast<float2*>(rv + CH_RAWC);  // raw params
  float2* rvp = rkp + TS;
  float* ks2 = reinterpret_cast<float*>(rvp + TS);  // s_k * scale2
  float* zk = ks2 + TS;
  float* sv = zk + TS;
  float* zv = sv + TS;

  const int r0 = (gridDim.x - 1 - blockIdx.x) * CH_ROWS;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t head = static_cast<size_t>(b) * nkv + h;
  const int pos = pos_b[b];
  // the block's largest limit: the largest r % Sq among its rows
  const int r_last = min(r0 + CH_ROWS, R) - 1;
  const int s_max = (r_last / Sq != r0 / Sq) ? Sq - 1 : r_last % Sq;
  const int kend = min(pos + s_max + 1, S_eff);
  const int ntiles = (kend + TS - 1) / TS;

  // tile t's codes and params into this warpgroup's raw buffer (keys past
  // the cache land as zeros; they are masked)
  auto fetch = [&](int t) {
    const int t0 = t * TS;
    const size_t base = tile_offset<PAGED>(b, h, t0, nkv, S_eff, tbl, mb, bs);
#pragma unroll
    for (int i = 0; i < TS * HB / 16 / 128; ++i) {
      const int c = wt + i * 128;  // 16-byte chunk: 4 a token
      const int tok = c >> 2;
      const bool ok = t0 + tok < S_eff;
      const size_t src = (base + (ok ? tok : 0)) * HB + (c & 3) * 16;
      cp_async16_zfill(rk + c * 16, kp + src, ok);
      cp_async16_zfill(rv + c * 16, vp + src, ok);
    }
    {
      const int tok = wt;
      const bool ok = t0 + tok < S_eff;
      const size_t src = 2 * (base + (ok ? tok : 0));
      cp_async8_zfill(rkp + tok, kpar + src, ok);
      cp_async8_zfill(rvp + tok, vpar + src, ok);
    }
    cp_async_commit();
  };
  if (cw < ntiles) fetch(cw);

  // ---- q rows as bf16 hi + lo tiles (16-byte chunk c of row r at half
  // c / 8, chunk (c % 8) ^ (r % 8)), and their float32 sums
  bool any_lo = false;
  const float* qh = q + (head * R + r0) * HD;
#pragma unroll
  for (int i = 0; i < CH_ROWS * 16 / CH_THREADS; ++i) {
    const int c = tid + i * CH_THREADS;  // 16 lanes hold one row
    const int r = c >> 4, ch = c & 15;
    float x[8];
    if (r0 + r < R) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(
          qh + static_cast<size_t>(r) * HD + ch * 8));
      const float4 e = __ldg(reinterpret_cast<const float4*>(
          qh + static_cast<size_t>(r) * HD + ch * 8 + 4));
      x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
      x[4] = e.x; x[5] = e.y; x[6] = e.z; x[7] = e.w;
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) x[k] = 0.f;
    }
    unsigned hw[4], lw[4];
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const __nv_bfloat162 hv = __floats2bfloat162_rn(x[2 * k], x[2 * k + 1]);
      hw[k] = *reinterpret_cast<const unsigned*>(&hv);
      lw[k] = pack_bf16(x[2 * k] - __low2float(hv),
                        x[2 * k + 1] - __high2float(hv));
      any_lo |= ((lw[k] & 0x7FFF7FFFu) != 0u);
      s += x[2 * k] + x[2 * k + 1];
    }
    const int off = (ch >> 3) * (CH_ROWS * 128) + r * 128 +
                    (((ch & 7) ^ (r & 7)) << 4);
    *reinterpret_cast<uint4*>(qhi + off) = make_uint4(hw[0], hw[1], hw[2], hw[3]);
    *reinterpret_cast<uint4*>(qlo + off) = make_uint4(lw[0], lw[1], lw[2], lw[3]);
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (ch == 0) qsum_s[r] = s;
  }
  fence_proxy_async();  // the generic-proxy writes, seen by the wgmmas
  const bool use_lo = __syncthreads_or(any_lo) != 0;

  const int rr0 = warp * 16 + g8;  // block rows rr0, rr0 + 8
  // a row sees keys <= lim (keys past the cache are masked too)
  const int lim0 = min(pos + (r0 + rr0) % Sq, S_eff - 1);
  const int lim1 = min(pos + (r0 + rr0 + 8) % Sq, S_eff - 1);
  const float qs0 = qsum_s[rr0], qs1 = qsum_s[rr0 + 8];

  float s[64], o[64];
  unsigned ph[8][4], pl[8][4];  // p' hi and lo: the A fragments of P V
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float m0 = -1e30f, m1 = -1e30f, l0 = 0.f, l1 = 0.f, z0 = 0.f, z1 = 0.f;

  for (int t = cw; t < ntiles; t += CH_WG) {
    cp_async_wait<0>();
    bar_sync<128>(1 + cw);  // tile t's raw codes are in; tile t - 2's
                            // products are done
    // ---- decode: 8 code bytes of a token -> two bf16 chunks, K and V
#pragma unroll
    for (int i = 0; i < TS * 8 / 128; ++i) {
      const int c = wt + i * 128;
      const int tok = c >> 3, c8 = c & 7;
      const int off = tok * 128 + ((c8 ^ (tok & 7)) << 4);
      decode_chunk(*reinterpret_cast<const uint2*>(rk + tok * HB + c8 * 8),
                   kd + off, kd + TS * 128 + off);
      decode_chunk(*reinterpret_cast<const uint2*>(rv + tok * HB + c8 * 8),
                   vd + off, vd + TS * 128 + off);
    }
    {
      const float2 a = rkp[wt], e = rvp[wt];  // (scale, zero)
      ks2[wt] = a.x * scale2;
      zk[wt] = a.y;
      sv[wt] = e.x;
      zv[wt] = e.y;
    }
    fence_proxy_async();
    bar_sync<128>(1 + cw);  // decoded tiles visible; the raw buffer is free
    if (t + CH_WG < ntiles) fetch(t + CH_WG);

    // ---- S = q k^T: hi, then lo
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      WgmmaSS<128>::mma(
          s, sw128_desc(qhi + (kk >> 2) * (CH_ROWS * 128) + (kk & 3) * 32),
          sw128_desc(kd + (kk >> 2) * (TS * 128) + (kk & 3) * 32), kk > 0);
    if (use_lo) {
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        WgmmaSS<128>::mma(
            s, sw128_desc(qlo + (kk >> 2) * (CH_ROWS * 128) + (kk & 3) * 32),
            sw128_desc(kd + (kk >> 2) * (TS * 128) + (kk & 3) * 32), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_f32<64>(s);

    // ---- scores, the causal limit, the online softmax (exp2 domain)
    const int k0 = t * TS;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int n = 8 * (i >> 2) + 2 * tq;  // the pair's first key
      const float2 ka = *reinterpret_cast<const float2*>(ks2 + n);
      const float2 kz = *reinterpret_cast<const float2*>(zk + n);
      const bool up = (i & 2) != 0;
      const float qsr = up ? qs1 : qs0;
      const int lim = up ? lim1 : lim0;
      const float a = fmaf(-qsr, kz.x, s[i]) * ka.x;
      const float e = fmaf(-qsr, kz.y, s[i + 1]) * ka.y;
      s[i] = (k0 + n > lim) ? -INFINITY : a;
      s[i + 1] = (k0 + n + 1 > lim) ? -INFINITY : e;
      if (up)
        mx1 = fmaxf(mx1, fmaxf(s[i], s[i + 1]));
      else
        mx0 = fmaxf(mx0, fmaxf(s[i], s[i + 1]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float corr0 = exp2f(m0 - mn0), corr1 = exp2f(m1 - mn1);
    float ls0 = 0.f, ls1 = 0.f, zs0 = 0.f, zs1 = 0.f;
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int n = 8 * (i >> 2) + 2 * tq;
      const float2 vs = *reinterpret_cast<const float2*>(sv + n);
      const float2 vz = *reinterpret_cast<const float2*>(zv + n);
      const bool up = (i & 2) != 0;
      const float mn = up ? mn1 : mn0;
      const float pa = exp2f(s[i] - mn), pb = exp2f(s[i + 1] - mn);
      const float va = pa * vs.x, vb = pb * vs.y;
      if (up) {
        ls1 += pa + pb;
        zs1 = fmaf(va, vz.x, fmaf(vb, vz.y, zs1));
      } else {
        ls0 += pa + pb;
        zs0 = fmaf(va, vz.x, fmaf(vb, vz.y, zs0));
      }
      s[i] = va;
      s[i + 1] = vb;
    }
    l0 = l0 * corr0 + quad_sum(ls0);
    l1 = l1 * corr1 + quad_sum(ls1);
    z0 = z0 * corr0 + quad_sum(zs0);
    z1 = z1 * corr1 + quad_sum(zs1);
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int i = 0; i < 64; i += 4) {
      o[i] *= corr0;
      o[i + 1] *= corr0;
      o[i + 2] *= corr1;
      o[i + 3] *= corr1;
    }
    // p' as bf16 hi + lo; n-tiles 2kk and 2kk + 1 are k-step kk's A
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float a = s[8 * kk + 2 * e], c = s[8 * kk + 2 * e + 1];
        const __nv_bfloat162 hv = __floats2bfloat162_rn(a, c);
        ph[kk][e] = *reinterpret_cast<const unsigned*>(&hv);
        pl[kk][e] = pack_bf16(a - __low2float(hv), c - __high2float(hv));
      }
    }

    // ---- o += p'_hi V + p'_lo V (V MN-major, the halves TS * 128 apart)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      Wgmma<128>::mma_tb(o, ph[kk], sw128_mn_desc(vd + kk * 2048, TS * 128),
                         1);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      Wgmma<128>::mma_tb(o, pl[kk], sw128_mn_desc(vd + kk * 2048, TS * 128),
                         1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_f32<64>(o);
    fence_u32<32>(&ph[0][0]);
    fence_u32<32>(&pl[0][0]);
  }
  cp_async_wait<0>();  // no copy in flight at exit (a warpgroup with no tile)

  // ---- merge the warpgroups' states (warpgroup w > 0 through its decoded
  // tiles, in the order w = 1, 2, ...), then out = (o - z) / max(l, 1e-30)
  // for dims 8 nt + 2 tq, + 1 of each of the thread's rows
  for (int w = 1; w < CH_WG; ++w) {
    float* st = reinterpret_cast<float*>(qlo + CH_QT + w * CH_WGB);
    float* mlz = st + CH_ROWS * HD;  // m, l, z [CH_ROWS] each
    __syncthreads();  // every warpgroup's products are done
    if (cw == w) {
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int row = rr0 + ((i & 2) ? 8 : 0);
        *reinterpret_cast<float2*>(st + row * HD + 8 * (i >> 2) + 2 * tq) =
            make_float2(o[i], o[i + 1]);
      }
      if (tq == 0) {
        mlz[rr0] = m0;
        mlz[rr0 + 8] = m1;
        mlz[CH_ROWS + rr0] = l0;
        mlz[CH_ROWS + rr0 + 8] = l1;
        mlz[2 * CH_ROWS + rr0] = z0;
        mlz[2 * CH_ROWS + rr0 + 8] = z1;
      }
    }
    __syncthreads();
    if (cw == 0) {
      const float n0 = fmaxf(m0, mlz[rr0]), n1 = fmaxf(m1, mlz[rr0 + 8]);
      const float a0 = exp2f(m0 - n0), c0 = exp2f(mlz[rr0] - n0);
      const float a1 = exp2f(m1 - n1), c1 = exp2f(mlz[rr0 + 8] - n1);
      l0 = a0 * l0 + c0 * mlz[CH_ROWS + rr0];
      l1 = a1 * l1 + c1 * mlz[CH_ROWS + rr0 + 8];
      z0 = a0 * z0 + c0 * mlz[2 * CH_ROWS + rr0];
      z1 = a1 * z1 + c1 * mlz[2 * CH_ROWS + rr0 + 8];
      m0 = n0;
      m1 = n1;
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const bool up = (i & 2) != 0;
        const int row = rr0 + (up ? 8 : 0);
        const float2 ow = *reinterpret_cast<const float2*>(
            st + row * HD + 8 * (i >> 2) + 2 * tq);
        o[i] = (up ? a1 : a0) * o[i] + (up ? c1 : c0) * ow.x;
        o[i + 1] = (up ? a1 : a0) * o[i + 1] + (up ? c1 : c0) * ow.y;
      }
    }
  }
  if (cw != 0) return;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int rg = r0 + rr0 + 8 * hf;
    if (rg >= R) continue;
    const float il = fmaxf(hf ? l1 : l0, 1e-30f);
    const float zz = hf ? z1 : z0;
    float* orow = out + (head * R + rg) * HD;
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      const int i = 4 * nt + 2 * hf;
      *reinterpret_cast<float2*>(orow + 8 * nt + 2 * tq) =
          make_float2((o[i] - zz) / il, (o[i + 1] - zz) / il);
    }
  }
}

// ---------------------------------------------------------------------
// write_token
//
// Replaces: flatquant_tpu/kernels/kv_cache.py:735 (write_token_v4; its
// 128-lane windows and masked select are a TPU DMA choice, not carried
// over). Slot b's one new token, K and V codes [nkv, hdh] u8 and their
// (scale, zero) float32 pairs, lands in place at pos[b]; a position
// outside [0, S) writes nothing.
//
// What bounds it on the H100: latency. At B = 4 and 32 kv heads it moves
// 18 KB, ~11 ns of bytes, far below a launch. The body it replaced (a
// block a slot, pos[b] read first, then the codes copied one byte at a
// time in 16 rounds with an integer division each) took 5.1 us (PERF.md).
//
// Design: a warp per (slot, kv head), WT_WARPS a block. Its lanes take the
// 16-byte chunks of the K and the V code rows and the two float2 params,
// one each (hdh = 64: 10 lanes), load them beside pos[b] (they do not
// depend on it) and store them at pos[b]: one round of loads, one of
// stores. Code rows whose width or address is not a multiple of 16 bytes
// (vec = 0) take a byte-wise path in the same kernel.
// ---------------------------------------------------------------------

constexpr int WT_WARPS = 4;

__global__ void __launch_bounds__(WT_WARPS * 32)
write_token_kernel(uint8_t* __restrict__ kp, float* __restrict__ kpar,
                   uint8_t* __restrict__ vp, float* __restrict__ vpar,
                   const uint8_t* __restrict__ kq,
                   const float* __restrict__ kpn,
                   const uint8_t* __restrict__ vq,
                   const float* __restrict__ vpn,
                   const int* __restrict__ pos, int B, int nkv, int S,
                   int hdh, int vec) {
  const int item = blockIdx.x * WT_WARPS + (threadIdx.x >> 5);  // b nkv + h
  if (item >= B * nkv) return;
  const int lane = threadIdx.x & 31;
  const int p = pos[item / nkv];
  const bool hit = p >= 0 && p < S;
  const size_t src = static_cast<size_t>(item) * hdh;
  const size_t at = static_cast<size_t>(item) * S + p;  // used when hit
  if (vec) {
    const int nc = hdh >> 4;  // 16-byte chunks of a code row
    for (int i = lane; i < 2 * nc + 2; i += 32) {
      if (i < 2 * nc) {
        const bool v = i >= nc;
        const int off = 16 * (v ? i - nc : i);
        const uint4 d =
            *reinterpret_cast<const uint4*>((v ? vq : kq) + src + off);
        if (hit)
          *reinterpret_cast<uint4*>((v ? vp : kp) + at * hdh + off) = d;
      } else {
        const bool v = i > 2 * nc;
        const float2 d =
            *reinterpret_cast<const float2*>((v ? vpn : kpn) + 2 * item);
        if (hit) *reinterpret_cast<float2*>((v ? vpar : kpar) + 2 * at) = d;
      }
    }
  } else {
    for (int j = lane; j < hdh; j += 32) {
      const uint8_t dk = kq[src + j], dv = vq[src + j];
      if (hit) {
        kp[at * hdh + j] = dk;
        vp[at * hdh + j] = dv;
      }
    }
    if (lane < 4) {
      const float d = (lane < 2 ? kpn : vpn)[2 * item + (lane & 1)];
      if (hit) (lane < 2 ? kpar : vpar)[2 * at + (lane & 1)] = d;
    }
  }
}

template <bool PAGED, bool DEQUANT>
int launch_decode(const void* q, const void* kp, const void* kpar,
                  const void* vp, const void* vpar, const void* tbl,
                  const void* valid, void* ws, void* tickets, void* out,
                  int B, int nkv, int n_rep, int S_eff, int mb, int bs,
                  int span, float sm_scale, void* stream) {
  if (span <= 0 || span % TS != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(nkv, B, (S_eff + span - 1) / span);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FQ_LAUNCH(NR)                                                       \
  decode_attention_int4_kernel<NR, PAGED, DEQUANT><<<grid, DT, 0, s>>>(    \
      static_cast<const float*>(q), static_cast<const uint8_t*>(kp),       \
      static_cast<const float*>(kpar), static_cast<const uint8_t*>(vp),    \
      static_cast<const float*>(vpar), static_cast<const int*>(valid),     \
      static_cast<const int*>(tbl), static_cast<float*>(ws),               \
      static_cast<int*>(tickets), static_cast<float*>(out), nkv, S_eff,    \
      mb, bs, span, sm_scale)
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
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        chunk_attention_int4_kernel<PAGED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, CH_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  dim3 grid((R + CH_ROWS - 1) / CH_ROWS, nkv, B);
  chunk_attention_int4_kernel<PAGED>
      <<<grid, CH_THREADS, CH_SMEM, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(q), static_cast<const uint8_t*>(kp),
          static_cast<const float*>(kpar), static_cast<const uint8_t*>(vp),
          static_cast<const float*>(vpar), static_cast<const int*>(pos),
          static_cast<const int*>(tbl), static_cast<float*>(out), nkv, R, Sq,
          S_eff, mb, bs, sm_scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q f32 [B, nkv*n_rep, 128]; kp/vp u8 [B, nkv, S, 64]; kpar/vpar f32
// [B, nkv, S, 2]; valid int32 [B]; ws f32 [B * nkv * ceil(S / span) *
// n_rep * 131] (the spans' partials, no initial value); tickets int32
// [B * nkv], 0 before the launch and after it; out f32 [B, nkv*n_rep,
// 128]; span a multiple of 128.
extern "C" int fq_decode_attention_int4(const void* q, const void* kp,
                                        const void* kpar, const void* vp,
                                        const void* vpar, const void* valid,
                                        void* ws, void* tickets, void* out,
                                        int B, int nkv, int n_rep, int S,
                                        int span, float sm_scale,
                                        void* stream) {
  return launch_decode<false, false>(q, kp, kpar, vp, vpar, nullptr, valid,
                                     ws, tickets, out, B, nkv, n_rep, S, 0, 1,
                                     span, sm_scale, stream);
}

// fq_decode_attention_int4's arguments; every K/V element dequantized
// before the products (decode_attention_int4_v1 and _wide).
extern "C" int fq_decode_attention_int4_dequant(
    const void* q, const void* kp, const void* kpar, const void* vp,
    const void* vpar, const void* valid, void* ws, void* tickets, void* out,
    int B, int nkv, int n_rep, int S, int span, float sm_scale,
    void* stream) {
  return launch_decode<false, true>(q, kp, kpar, vp, vpar, nullptr, valid, ws,
                                    tickets, out, B, nkv, n_rep, S, 0, 1,
                                    span, sm_scale, stream);
}

// q, valid, ws, tickets, out, span as above (ws over ceil(mb * bs / span)
// spans); kp/vp u8 [nb, nkv, bs, 64]; kpar/vpar f32 [nb, nkv, bs, 2]; tbl
// int32 [B, mb]; bs % 128 == 0.
extern "C" int fq_paged_decode_attention_int4(
    const void* q, const void* kp, const void* kpar, const void* vp,
    const void* vpar, const void* tbl, const void* valid, void* ws,
    void* tickets, void* out, int B, int nkv, int n_rep, int mb, int bs,
    int span, float sm_scale, void* stream) {
  if (bs % TS != 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_decode<true, false>(q, kp, kpar, vp, vpar, tbl, valid, ws,
                                    tickets, out, B, nkv, n_rep, mb * bs, mb,
                                    bs, span, sm_scale, stream);
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
  if (B * nkv == 0) return 0;
  auto aligned = [](const void* p, unsigned n) {
    return reinterpret_cast<uintptr_t>(p) % n == 0;
  };
  // 16-byte code chunks and float2 params where every row allows them
  const int vec = hdh % 16 == 0 && aligned(kp, 16) && aligned(vp, 16) &&
                  aligned(kq, 16) && aligned(vq, 16) && aligned(kpar, 8) &&
                  aligned(vpar, 8) && aligned(kpn, 8) && aligned(vpn, 8);
  const int grid = (B * nkv + WT_WARPS - 1) / WT_WARPS;
  write_token_kernel<<<grid, WT_WARPS * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(kp), static_cast<float*>(kpar),
      static_cast<uint8_t*>(vp), static_cast<float*>(vpar),
      static_cast<const uint8_t*>(kq), static_cast<const float*>(kpn),
      static_cast<const uint8_t*>(vq), static_cast<const float*>(vpn),
      static_cast<const int*>(pos), B, nkv, S, hdh, vec);
  return static_cast<int>(cudaGetLastError());
}
