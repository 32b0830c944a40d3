// Kernels over the packed asymmetric-int4 KV cache, token-major layout:
//   codes  [B, nkv, S, hd/2] uint8, byte c = q[c] | q[c + hd/2] << 4
//   params [B, nkv, S, 2]    f32 (scale, zero) per (token, head)
// A cached value is (q - zero) * scale with q in [0, 15].
//
// ---------------------------------------------------------------------
// decode_attention_int4
//
// Replaces: flatquant_tpu/kernels/kv_cache.py:decode_attention_int4_v4
// (Pallas; the v4 lane-transposed layout is a TPU VMEM choice and is not
// carried over).
//
// One query token per slot, GQA: query head h*n_rep + r reads kv head h.
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
// Design: one CTA per (b, kv head), 128 threads looping over the S tiles
// up to valid_len (tiles past it are skipped: they would add nothing).
// Thread t scores token t of the tile against the n_rep query heads held
// in shared memory (broadcast reads) and stages the token's V codes in
// shared memory; after a barrier each warp runs the softmax update of its
// query heads; after another, thread d accumulates output dimension d.
// At B=1 with MHA that is only 32 CTAs on 132 SMs, so a single slot sits
// far below the bandwidth bound; splitting S across CTAs is later work.
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

constexpr int HD = 128;        // head dim the decode kernel takes
constexpr int HB = HD / 2;     // packed bytes per (token, head)
constexpr int TS = 128;        // tokens per tile = threads per CTA
constexpr int VROW = HB + 16;  // padded shared-memory row of V codes

template <int NREP>
__global__ void __launch_bounds__(TS)
decode_attention_int4_kernel(const float* __restrict__ q,
                             const uint8_t* __restrict__ kp,
                             const float* __restrict__ kpar,
                             const uint8_t* __restrict__ vp,
                             const float* __restrict__ vpar,
                             const int* __restrict__ valid_len,
                             float* __restrict__ out, int nkv, int S,
                             float sm_scale) {
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

  const int valid = min(valid_len[b], S);
  const uint8_t* kph = kp + head * S * HB;
  const uint8_t* vph = vp + head * S * HB;
  const float2* kparh = reinterpret_cast<const float2*>(kpar) + head * S;
  const float2* vparh = reinterpret_cast<const float2*>(vpar) + head * S;

  for (int s0 = 0; s0 < valid; s0 += TS) {
    const int t = s0 + tid;
    // ---- scores of token t, and its V codes staged in shared memory
    float sc[NREP];
    if (t < valid) {
      float raw[NREP];
#pragma unroll
      for (int r = 0; r < NREP; ++r) raw[r] = 0.f;
      const uint8_t* kt = kph + static_cast<size_t>(t) * HB;
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
            const float lo = static_cast<float>(byte & 0xFu);
            const float hi = static_cast<float>(byte >> 4);
#pragma unroll
            for (int r = 0; r < NREP; ++r)
              raw[r] = fmaf(q_s[r][d], lo, fmaf(q_s[r][d + HB], hi, raw[r]));
          }
        }
      }
      const float2 kpr = kparh[t];  // (scale, zero)
#pragma unroll
      for (int r = 0; r < NREP; ++r)
        sc[r] = (raw[r] - qsum_s[r] * kpr.y) * kpr.x * sm_scale;
      const uint8_t* vt = vph + static_cast<size_t>(t) * HB;
#pragma unroll
      for (int j16 = 0; j16 < HB / 16; ++j16)
        *reinterpret_cast<uint4*>(v_s + tid * VROW + 16 * j16) =
            ldg16(vt + 16 * j16);
      const float2 vpr = vparh[t];
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
        const float c =
            static_cast<float>((v_s[j * VROW + col] >> shift) & 0xF);
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

}  // namespace

// q f32 [B, nkv*n_rep, 128]; kp/vp u8 [B, nkv, S, 64]; kpar/vpar f32
// [B, nkv, S, 2]; valid int32 [B]; out f32 [B, nkv*n_rep, 128].
extern "C" int fq_decode_attention_int4(const void* q, const void* kp,
                                        const void* kpar, const void* vp,
                                        const void* vpar, const void* valid,
                                        void* out, int B, int nkv, int n_rep,
                                        int S, float sm_scale, void* stream) {
  dim3 grid(nkv, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FQ_LAUNCH(NR)                                                     \
  decode_attention_int4_kernel<NR><<<grid, TS, 0, s>>>(                  \
      static_cast<const float*>(q), static_cast<const uint8_t*>(kp),     \
      static_cast<const float*>(kpar), static_cast<const uint8_t*>(vp),  \
      static_cast<const float*>(vpar), static_cast<const int*>(valid),   \
      static_cast<float*>(out), nkv, S, sm_scale)
  switch (n_rep) {
    case 1: FQ_LAUNCH(1); break;
    case 2: FQ_LAUNCH(2); break;
    case 4: FQ_LAUNCH(4); break;
    case 8: FQ_LAUNCH(8); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FQ_LAUNCH
  return static_cast<int>(cudaGetLastError());
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
