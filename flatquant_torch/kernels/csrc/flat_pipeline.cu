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
//     128x128 (resp. GxG) products, 0.5-4 GFLOP, run on the CUDA cores
//     here, so these simple versions sit above the bytes bound.
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
#include "w4a4_tile.cuh"

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__device__ __forceinline__ float load_f(const T* p);
template <>
__device__ __forceinline__ float load_f<float>(const float* p) {
  return *p;
}
template <>
__device__ __forceinline__ float load_f<bf16>(const bf16* p) {
  return __bfloat162float(*p);
}

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
// y[t, g*128 + c] = bf16(sum_d xn[t, g*128 + d] * R[d, c])
// xn = bf16((x * rsqrt(sum(x^2) * (1/H) + eps)) * w)
//
// A block owns RMS_ROWS rows and every gridDim.y-th column group. Pass 1:
// one warp per row computes the inverse RMS. Pass 2, per group: the
// normalized [RMS_ROWS, 128] tile goes to shared memory and each thread
// computes an 8-row x 1-column strip against R (float32, in shared
// memory), summing over d in order.
// ---------------------------------------------------------------------------

constexpr int RMS_ROWS = 16;
constexpr int RMS_THREADS = 256;
constexpr int RMS_SMEM = (128 * 128 + RMS_ROWS * 128 + RMS_ROWS) * 4;

// GROUPED: y is [H / 128, T, 128] (rmsnorm_right_grouped) instead of
// [T, H]; nothing else changes.
template <typename InT, bool GROUPED>
__device__ __forceinline__ void rmsnorm_right(const InT* __restrict__ x,
                                              const float* __restrict__ w,
                                              const float* __restrict__ right,
                                              bf16* __restrict__ y, int T,
                                              int H, float eps) {
  extern __shared__ float4 smem4[];
  float* rs = reinterpret_cast<float*>(smem4);  // [128][128]
  float* xn = rs + 128 * 128;                   // [RMS_ROWS][128]
  float* inv = xn + RMS_ROWS * 128;             // [RMS_ROWS]
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int t0 = blockIdx.x * RMS_ROWS;

  for (int i = tid; i < 128 * 128 / 4; i += RMS_THREADS)
    smem4[i] = reinterpret_cast<const float4*>(right)[i];

  for (int r = warp; r < RMS_ROWS; r += RMS_THREADS / 32) {
    float ss = 0.f;
    if (t0 + r < T) {
      const InT* xr = x + static_cast<size_t>(t0 + r) * H;
      for (int c = lane; c < H; c += 32) {
        const float v = load_f(xr + c);
        ss += v * v;
      }
    }
    ss = warp_sum(ss);
    // torch.mean multiplies the sum by 1/H; rsqrtf is what torch.rsqrt
    // runs on the card
    if (lane == 0) inv[r] = rsqrtf(__fadd_rn(__fmul_rn(ss, 1.0f / H), eps));
  }
  __syncthreads();

  const int c = tid & 127;
  const int rb = (tid >> 7) * (RMS_ROWS / 2);  // first of this thread's rows
  const int G = H / 128;
  for (int g = blockIdx.y; g < G; g += gridDim.y) {
    for (int i = tid; i < RMS_ROWS * 128; i += RMS_THREADS) {
      const int r = i >> 7, col = g * 128 + (i & 127);
      float v = 0.f;
      if (t0 + r < T) {
        v = load_f(x + static_cast<size_t>(t0 + r) * H + col);
        v = bf16_round(__fmul_rn(__fmul_rn(v, inv[r]), w[col]));
      }
      xn[i] = v;
    }
    __syncthreads();
    float acc[RMS_ROWS / 2];
#pragma unroll
    for (int r = 0; r < RMS_ROWS / 2; ++r) acc[r] = 0.f;
    for (int d = 0; d < 128; d += 4) {
      const float m0 = rs[(d + 0) * 128 + c], m1 = rs[(d + 1) * 128 + c];
      const float m2 = rs[(d + 2) * 128 + c], m3 = rs[(d + 3) * 128 + c];
#pragma unroll
      for (int r = 0; r < RMS_ROWS / 2; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(
            xn + (rb + r) * 128 + d);
        acc[r] = fmaf(a.x, m0, acc[r]);
        acc[r] = fmaf(a.y, m1, acc[r]);
        acc[r] = fmaf(a.z, m2, acc[r]);
        acc[r] = fmaf(a.w, m3, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < RMS_ROWS / 2; ++r) {
      if (t0 + rb + r < T) {
        const size_t t = t0 + rb + r;
        const size_t at = GROUPED ? (g * static_cast<size_t>(T) + t) * 128 + c
                                  : t * H + g * 128 + c;
        y[at] = __float2bfloat16_rn(acc[r]);
      }
    }
    __syncthreads();  // xn is overwritten by the next group
  }
}

template <typename InT>
__global__ void __launch_bounds__(RMS_THREADS)
rmsnorm_right_flat_kernel(const InT* __restrict__ x,
                          const float* __restrict__ w,
                          const float* __restrict__ right,
                          bf16* __restrict__ y, int T, int H, float eps) {
  rmsnorm_right<InT, false>(x, w, right, y, T, H, eps);
}

template <typename InT>
__global__ void __launch_bounds__(RMS_THREADS)
rmsnorm_right_grouped_kernel(const InT* __restrict__ x,
                             const float* __restrict__ w,
                             const float* __restrict__ right,
                             bf16* __restrict__ y, int T, int H, float eps) {
  rmsnorm_right<InT, true>(x, w, right, y, T, H, eps);
}

// ---------------------------------------------------------------------------
// left_quant_i8_flat, left_quant_i8_grouped
//
// z[t, i*128 + d] = bf16(sum_j left_t[i, j] * x[t, j*128 + d])
// xmax = max(max_i,d z, 0) * cmax; xmin = min(min z, 0) * cmin
// s = max(|xmin|, xmax) / q_max (1 when 0); q = clamp(rint(z / s))
//
// One block (128 threads) per row: thread d owns column d of every group,
// so it reads only its own column of x and z (shared memory, no
// conflicts); left_t is shared, stored transposed and zero-padded to a
// multiple of LQ_IC so a thread reads four coefficients per float4. Each
// output group's sum runs over j in order. The row's extrema are taken
// over the bf16-rounded z (as the JAX kernel does), then a block
// reduction gives the scale, and the same thread writes its codes.
// ---------------------------------------------------------------------------

constexpr int LQ_THREADS = 128;
constexpr int LQ_IC = 16;  // output groups per register chunk

__host__ __device__ inline int lq_pad(int g) {
  return (g + LQ_IC - 1) / LQ_IC * LQ_IC;
}

__host__ inline int lq_smem(int g) {
  return g * lq_pad(g) * 4 + 2 * lq_pad(g) * 128 * 2 + 2 * 4 * 4;
}

// GROUPED: x and xq are [G, T, 128] (left_quant_i8_grouped) instead of
// [T, G * 128]; only the row's addresses change.
template <bool GROUPED>
__device__ __forceinline__ void left_quant_i8(const float* __restrict__ ltT,
                                              const bf16* __restrict__ x,
                                              const float* __restrict__ clip,
                                              int8_t* __restrict__ xq,
                                              float* __restrict__ xs, int G,
                                              int T, float q_max) {
  extern __shared__ float4 smem4[];
  const int GP = lq_pad(G);
  float* lt = reinterpret_cast<float*>(smem4);            // [G][GP]: ltT
  bf16* xc = reinterpret_cast<bf16*>(lt + G * GP);        // [GP][128]
  bf16* zc = xc + GP * 128;                               // [GP][128]
  float* red = reinterpret_cast<float*>(zc + GP * 128);   // [2][4]
  const int d = threadIdx.x;
  const int lane = d & 31, warp = d >> 5;
  const size_t row = blockIdx.x;
  const int K = G * 128;

  for (int i = d; i < G * GP; i += LQ_THREADS) {
    const int j = i / GP, c = i % GP;
    lt[i] = c < G ? ltT[j * G + c] : 0.f;
  }
  // offset of (this row, column group j, column 0) in x and xq
  auto at = [&](int j) -> size_t {
    if constexpr (GROUPED) return (j * static_cast<size_t>(T) + row) * 128;
    else return row * K + j * 128;
  };
  for (int j = 0; j < G; ++j) xc[j * 128 + d] = x[at(j) + d];
  __syncthreads();

  float mx = 0.f, mn = 0.f;  // max(., 0) and min(., 0) folded in
  for (int i0 = 0; i0 < G; i0 += LQ_IC) {
    float acc[LQ_IC];
#pragma unroll
    for (int ii = 0; ii < LQ_IC; ++ii) acc[ii] = 0.f;
    for (int j = 0; j < G; ++j) {
      const float xv = __bfloat162float(xc[j * 128 + d]);
      const float4* l4 = reinterpret_cast<const float4*>(lt + j * GP + i0);
#pragma unroll
      for (int q = 0; q < LQ_IC / 4; ++q) {
        const float4 l = l4[q];
        acc[4 * q + 0] = fmaf(l.x, xv, acc[4 * q + 0]);
        acc[4 * q + 1] = fmaf(l.y, xv, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(l.z, xv, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(l.w, xv, acc[4 * q + 3]);
      }
    }
#pragma unroll
    for (int ii = 0; ii < LQ_IC; ++ii) {
      if (i0 + ii < G) {
        const bf16 z = __float2bfloat16_rn(acc[ii]);
        zc[(i0 + ii) * 128 + d] = z;
        const float zf = __bfloat162float(z);
        mx = fmaxf(mx, zf);
        mn = fminf(mn, zf);
      }
    }
  }
  mx = warp_max(mx);
  mn = -warp_max(-mn);
  if (lane == 0) {
    red[warp] = mx;
    red[4 + warp] = mn;
  }
  __syncthreads();
  mx = fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3]));
  mn = fminf(fminf(red[4], red[5]), fminf(red[6], red[7]));
  const float xmax = __fmul_rn(mx, clip[0]);
  const float xmin = __fmul_rn(mn, clip[1]);
  const float absmax = fmaxf(fabsf(xmin), xmax);
  const float s = absmax == 0.f ? 1.f : absmax / q_max;
  if (d == 0) xs[row] = s;
  for (int i = 0; i < G; ++i) {
    const float q = rintf(__bfloat162float(zc[i * 128 + d]) / s);
    xq[at(i) + d] =
        static_cast<int8_t>(fminf(fmaxf(q, -q_max - 1.f), q_max));
  }
}

__global__ void __launch_bounds__(LQ_THREADS)
left_quant_i8_flat_kernel(const float* __restrict__ ltT,
                          const bf16* __restrict__ x,
                          const float* __restrict__ clip,
                          int8_t* __restrict__ xq, float* __restrict__ xs,
                          int G, int T, float q_max) {
  left_quant_i8<false>(ltT, x, clip, xq, xs, G, T, q_max);
}

__global__ void __launch_bounds__(LQ_THREADS)
left_quant_i8_grouped_kernel(const float* __restrict__ ltT,
                             const bf16* __restrict__ x,
                             const float* __restrict__ clip,
                             int8_t* __restrict__ xq, float* __restrict__ xs,
                             int G, int T, float q_max) {
  left_quant_i8<true>(ltT, x, clip, xq, xs, G, T, q_max);
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

template <bool GROUPED>
int launch_rmsnorm_right(const void* x, const void* w, const void* right,
                         void* y, int T, int H, float eps, int x_is_f32,
                         cudaStream_t s) {
  const int G = H / 128;
  dim3 grid((T + RMS_ROWS - 1) / RMS_ROWS, G < 2 ? G : 2);
  auto w_ = static_cast<const float*>(w);
  auto r_ = static_cast<const float*>(right);
  auto y_ = static_cast<bf16*>(y);
  cudaError_t err;
  if (x_is_f32) {
    auto kern = GROUPED ? &rmsnorm_right_grouped_kernel<float>
                        : &rmsnorm_right_flat_kernel<float>;
    static int done = 0;
    err = allow_smem(kern, RMS_SMEM, &done);
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<grid, RMS_THREADS, RMS_SMEM, s>>>(static_cast<const float*>(x),
                                             w_, r_, y_, T, H, eps);
  } else {
    auto kern = GROUPED ? &rmsnorm_right_grouped_kernel<bf16>
                        : &rmsnorm_right_flat_kernel<bf16>;
    static int done = 0;
    err = allow_smem(kern, RMS_SMEM, &done);
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<grid, RMS_THREADS, RMS_SMEM, s>>>(static_cast<const bf16*>(x),
                                             w_, r_, y_, T, H, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool GROUPED>
int launch_left_quant(const void* ltT, const void* x, const void* clip,
                      void* xq, void* xs, int T, int G, float q_max,
                      cudaStream_t s) {
  auto kern = GROUPED ? &left_quant_i8_grouped_kernel
                      : &left_quant_i8_flat_kernel;
  const int bytes = lq_smem(G);
  static int done = 0;
  cudaError_t err = allow_smem(kern, bytes, &done);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<T, LQ_THREADS, bytes, s>>>(
      static_cast<const float*>(ltT), static_cast<const bf16*>(x),
      static_cast<const float*>(clip), static_cast<int8_t*>(xq),
      static_cast<float*>(xs), G, T, q_max);
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

// x [T, H] bf16 (x_is_f32 = 0) or f32; w f32 [H]; right f32 [128, 128]
// (bf16 values); y bf16 [T, H]. H % 128 == 0 (checked in Python).
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

// ltT f32 [G, G] (left_t transposed, bf16 values); x bf16 [T, G*128];
// clip f32 [2] (cmax, cmin); xq int8 [T, G*128]; xs f32 [T].
extern "C" int fq_left_quant_i8_flat(const void* ltT, const void* x,
                                     const void* clip, void* xq, void* xs,
                                     int T, int G, float q_max,
                                     void* stream) {
  return launch_left_quant<false>(ltT, x, clip, xq, xs, T, G, q_max,
                                  static_cast<cudaStream_t>(stream));
}

// fq_left_quant_i8_flat with x bf16 and xq int8 [G, T, 128].
extern "C" int fq_left_quant_i8_grouped(const void* ltT, const void* x,
                                        const void* clip, void* xq, void* xs,
                                        int T, int G, float q_max,
                                        void* stream) {
  return launch_left_quant<true>(ltT, x, clip, xq, xs, T, G, q_max,
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
