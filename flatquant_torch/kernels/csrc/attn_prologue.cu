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
// (9 MB): ~28 us at 3.35 TB/s. The head products, 2 * 2048 * 64 * 128^2
// = 4.3 GFLOP, run here on the CUDA cores in float32 (~64 us at 67
// TFLOP/s), so this simple version sits above the bytes bound.
//
// Design: a block owns PRO_BT tokens of one sequence and a slice of the
// heads (heads z, z + gridDim.z, ...): first its q heads against k_t_inv,
// then its k heads against k_t, then its v heads (quantize only), so it
// loads each 128x128 matrix into shared memory once. Thread c owns
// column c: it ropes column c of the PRO_BT tokens into a shared tile and
// sums its output column over d in order (PRO_BT accumulators). For K
// and V a warp then quantizes 8 tokens: a lane holds columns lane + 32i,
// so the planar pair (c, c + 64) sits in one lane and packs without a
// shuffle.

#include <cuda_bf16.h>

#include "common.cuh"

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
