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
// The Pallas kernel walks keys in blocks of 512, this one in tiles of
// FW_BK (128), so m (and the rounding of p) is taken at other points: the
// outputs agree with the plain version within kernels/tolerance.py's
// "flash" bound, not bit for bit.
//
// What bounds it on the H100: operations. At llama-2-7b's 1 x 2048
// prefill (32 heads) the causal products are 2 * S * (S + 1) * 128 * 32 =
// 34.4 GFLOP, 35 us at 989 bf16 TFLOP/s; the bytes (q, k, v read, o
// written: 67 MB) take 20 us at 3.35 TB/s.
//
// Design (FlashAttention-3's shape): both products on wgmma, the only
// path to the tensor cores' full rate. A block owns 128 query rows of one
// (batch, query head): two consumer warpgroups of 64 rows and a producer
// warp that keeps K and V tiles in flight by TMA on an mbarrier ring
// (128-byte swizzle), so the loads cost the consumers no instructions.
// S = q k^T reads both operands from shared memory (a K tile stored
// [key][hd] is K-major); o += p v takes p from registers -- the S
// accumulators, rounded to bf16, are the A fragments in place -- and V
// through the MN-major descriptor. The two warpgroups take turns issuing
// their products (named barriers), so one's softmax runs while the
// other's products hold the tensor cores. Tiles above a block's diagonal
// are never visited; the diagonal tile is masked elementwise; the longest
// rows are scheduled first. The outputs leave through the q tile's shared
// memory as 16-byte stores.
// Details above the kernel.

#include <cuda_bf16.h>
#include <math.h>

#include "common.cuh"
#include "mma.cuh"
#include "tma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

// Timed on the card and dropped (PERF.md): 64-key tiles and a 3-stage
// ring (both slower than 128 keys and 2 stages); issuing tile j's q k^T
// before tile j - 1's p v (under the 168 registers a thread ptxas allots
// to three warpgroups, tile j's scores and tile j - 1's p and o do not
// fit together: the wgmmas spilled and were serialized, and it ran
// slower); a producer warpgroup that hands its registers to the
// consumers through setmaxnreg (ptxas still allotted 168; no faster).
constexpr int FW_BK = 128;       // keys a tile
constexpr int FW_STAGES = 2;     // K and V tiles in the ring
constexpr int FW_BQ = 128;       // query rows per block: 2 warpgroups x 64
constexpr int FW_THREADS = 288;  // 2 consumer warpgroups + the producer
constexpr int FW_Q = FW_BQ * 256;     // q [2 halves][128 rows][128 B]
constexpr int FW_TILE = FW_BK * 256;  // K or V [2 halves][BK rows][128 B]
constexpr int FW_NS = FW_BK / 2;      // score accumulators a thread
// + 1024: the swizzled tiles start at a multiple of 1024 bytes
constexpr int FW_SMEM = 1024 + FW_Q + 2 * FW_STAGES * FW_TILE +
                        4 * FW_STAGES * 8;
static_assert(FW_SMEM <= 232448, "shared memory of one block");

// Block (blockIdx.x: query head; y: batch; z: query tiles, the longest
// rows first: the grid is dispatched in that order, so every head's
// longest blocks start before any shorter one). Warp 8 is the producer:
// one thread streams the K and V tiles of keys [0, 128 (qt + 1)) by TMA
// into a FW_STAGES-deep ring, each tile a full barrier (the transfer) and
// an empty one (one arrival per consumer warp). Warpgroups 0 and 1 own
// query rows q0 = 128 qt + 64 w: they stage their q (scaled, rounded to
// bf16, 128-byte swizzled) in shared memory and run S = q k^T as wgmma
// m64nBKk16 with both operands
// there (K [key][hd] is K-major), the online softmax on S's accumulators,
// and o += p v as wgmma m64n128k16 with p (bf16) from registers -- the
// accumulators of S are mma.sync's C fragments per warp, so they pack
// into the A fragments of p v in place -- and V through the MN-major
// descriptor. The warpgroups take turns issuing their products, so one's
// softmax runs while the other's products hold the tensor cores.
// kmap, vmap: K and V as [B][nkv][S][128] through their strides, boxes of
// 64 head-dim columns x FW_BK keys.
__global__ void __launch_bounds__(FW_THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const bf16* __restrict__ q, bf16* __restrict__ out,
                   int q_sb, int q_ss, int q_sh, int S, int nh, int n_rep,
                   float scale) {
  extern __shared__ __align__(16) uint8_t fw_raw[];
  uint8_t* qs = fw_raw + ((1024 - (smem_u32(fw_raw) & 1023)) & 1023);
  uint8_t* ks = qs + FW_Q;
  uint8_t* vs = ks + FW_STAGES * FW_TILE;
  uint64_t* kfull = reinterpret_cast<uint64_t*>(vs + FW_STAGES * FW_TILE);
  uint64_t* kempty = kfull + FW_STAGES;
  uint64_t* vfull = kempty + FW_STAGES;
  uint64_t* vempty = vfull + FW_STAGES;
  const int tid = threadIdx.x;
  const int qt = gridDim.z - 1 - blockIdx.z;  // longest rows first
  const int h = blockIdx.x, b = blockIdx.y;
  const int ntiles = (qt + 1) * (FW_BQ / FW_BK);

  if (tid == 0) {
    for (int st = 0; st < FW_STAGES; ++st) {
      mbar_init(kfull + st, 1);
      mbar_init(vfull + st, 1);
      mbar_init(kempty + st, 8);  // the consumers' 8 warps
      mbar_init(vempty + st, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {  // the producer: one thread issues the loads
    if (tid == 256) {
      const int kvh = h / n_rep;
      for (int j = 0; j < ntiles; ++j) {
        const int slot = j % FW_STAGES;
        const unsigned ph = ((j / FW_STAGES) & 1) ^ 1;
        uint8_t* kd = ks + slot * FW_TILE;
        uint8_t* vd = vs + slot * FW_TILE;
        mbar_wait(kempty + slot, ph);
        mbar_expect_tx(kfull + slot, FW_TILE);
        tma_load4(kd, &kmap, 0, j * FW_BK, kvh, b, kfull + slot);
        tma_load4(kd + FW_BK * 128, &kmap, 64, j * FW_BK, kvh, b,
                  kfull + slot);
        mbar_wait(vempty + slot, ph);
        mbar_expect_tx(vfull + slot, FW_TILE);
        tma_load4(vd, &vmap, 0, j * FW_BK, kvh, b, vfull + slot);
        tma_load4(vd + FW_BK * 128, &vmap, 64, j * FW_BK, kvh, b,
                  vfull + slot);
      }
    }
  } else {  // a consumer warpgroup
    const int cw = tid >> 7;  // 0, 1
    const int wt = tid & 127;
    const int warp = wt >> 5, lane = tid & 31;
    const int g8 = lane >> 2, tq = lane & 3;
    const int q0 = qt * FW_BQ + cw * 64;
    const int row0 = q0 + warp * 16 + g8;  // this thread's rows: row0, +8

    // q tile: bf16(float(q) * scale), 16-byte chunk c of row r (of 16) at
    // half c / 8, chunk (c % 8) ^ (r % 8)
    const bf16* qb = q + static_cast<size_t>(b) * q_sb +
                     static_cast<size_t>(h) * q_sh;
    uint8_t* qw = qs + cw * 64 * 128;  // this warpgroup's rows, half 0
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = wt + i * 128;
      const int r = c >> 4, ch = c & 15;
      const uint4 raw =
          ldg16(qb + static_cast<size_t>(q0 + r) * q_ss + ch * 8);
      const bf16* x = reinterpret_cast<const bf16*>(&raw);
      __align__(16) bf16 y[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        y[e] = __float2bfloat16_rn(__fmul_rn(__bfloat162float(x[e]), scale));
      *reinterpret_cast<uint4*>(qw + (ch >> 3) * (FW_BQ * 128) + r * 128 +
                                (((ch & 7) ^ (r & 7)) << 4)) =
          *reinterpret_cast<const uint4*>(y);
    }
    fence_proxy_async();  // the generic-proxy writes, seen by the wgmmas
    bar_sync<128>(1 + cw);

    float s[FW_NS], o[64];
    unsigned pa[FW_BK / 16][4];  // p as the A fragments of p v's k-steps
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    float corr0 = 0.f, corr1 = 0.f;

    // S = q k^T of the tile in `slot` (one group)
    auto issue_s = [&](int slot) {
      const uint8_t* kt = ks + slot * FW_TILE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        WgmmaSS<128>::mma(
            s, sw128_desc(qw + (kk >> 2) * (FW_BQ * 128) + (kk & 3) * 32),
            sw128_desc(kt + (kk >> 2) * (FW_BK * 128) + (kk & 3) * 32),
            kk > 0);
      wgmma_commit();
    };
    // o += p v of the tile in `slot` (one group)
    auto issue_pv = [&](int slot) {
      const uint8_t* vt = vs + slot * FW_TILE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < FW_BK / 16; ++kk)
        Wgmma<128>::mma_tb(o, pa[kk],
                           sw128_mn_desc(vt + kk * 2048, FW_BK * 128), 1);
      wgmma_commit();
    };
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    // tile j's scores in s: the causal mask, then the online softmax in
    // the exp2 domain (q carries log2 e): m, l and corr updated, s -> p
    auto softmax = [&](int j) {
      const int k0 = j * FW_BK;
      if (k0 + FW_BK - 1 > q0) {  // the tile reaches above some row
#pragma unroll
        for (int i = 0; i < FW_NS; ++i) {
          const int key = k0 + (i >> 2) * 8 + tq * 2 + (i & 1);
          const int row = row0 + ((i & 2) ? 8 : 0);
          if (key > row) s[i] = -INFINITY;
        }
      }
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int i = 0; i < FW_NS; i += 4) {
        mx0 = fmaxf(mx0, fmaxf(s[i], s[i + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[i + 2], s[i + 3]));
      }
      const float mn0 = fmaxf(m0, quad_max(mx0));
      const float mn1 = fmaxf(m1, quad_max(mx1));
      corr0 = exp2f(__fsub_rn(m0, mn0));
      corr1 = exp2f(__fsub_rn(m1, mn1));
      float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
      for (int i = 0; i < FW_NS; i += 4) {
        s[i] = exp2f(__fsub_rn(s[i], mn0));
        s[i + 1] = exp2f(__fsub_rn(s[i + 1], mn0));
        s[i + 2] = exp2f(__fsub_rn(s[i + 2], mn1));
        s[i + 3] = exp2f(__fsub_rn(s[i + 3], mn1));
        ls0 += s[i] + s[i + 1];
        ls1 += s[i + 2] + s[i + 3];
      }
      l0 = __fadd_rn(__fmul_rn(l0, corr0), quad_sum(ls0));
      l1 = __fadd_rn(__fmul_rn(l1, corr1), quad_sum(ls1));
      m0 = mn0;
      m1 = mn1;
    };
    auto rescale = [&]() {
#pragma unroll
      for (int i = 0; i < 64; i += 4) {
        o[i] = __fmul_rn(o[i], corr0);
        o[i + 1] = __fmul_rn(o[i + 1], corr0);
        o[i + 2] = __fmul_rn(o[i + 2], corr1);
        o[i + 3] = __fmul_rn(o[i + 3], corr1);
      }
    };
    // n-tiles 2kk and 2kk + 1 of s are k-step kk of p's A fragments
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < FW_BK / 16; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
    };

    // the warpgroups take turns issuing their products (named barriers 3
    // and 4 of both warpgroups' 256 threads), so one's softmax runs while
    // the other's products hold the tensor cores
    auto my_turn = [&]() { bar_sync<256>(3 + cw); };
    auto your_turn = [&]() { bar_arrive<256>(4 - cw); };
    if (cw == 1) bar_arrive<256>(3);  // warpgroup 0 first

    for (int j = 0; j < ntiles; ++j) {
      const int slot = j % FW_STAGES;
      const unsigned ph = (j / FW_STAGES) & 1;
      mbar_wait(kfull + slot, ph);
      my_turn();
      issue_s(slot);
      your_turn();
      wgmma_wait<0>();
      fence_f32<FW_NS>(s);
      release(kempty + slot);
      softmax(j);
      rescale();
      pack_p();
      mbar_wait(vfull + slot, ph);
      my_turn();
      issue_pv(slot);
      your_turn();
      wgmma_wait<0>();
      fence_f32<64>(o);
      fence_u32<FW_BK / 4>(&pa[0][0]);
      release(vempty + slot);
    }
    // warpgroup 1's last arrival on barrier 3 is taken here
    if (cw == 0) bar_sync<256>(3);

    // o / max(l, 1e-30) in bf16, staged in this warpgroup's q rows (the
    // q tile's layout), then 16-byte stores
    const float il0 = fmaxf(l0, 1e-30f), il1 = fmaxf(l1, 1e-30f);
    bar_sync<128>(1 + cw);  // every warp's wgmmas are done with q
    {
      const int r = warp * 16 + g8;
#pragma unroll
      for (int d = 0; d < 16; ++d) {
        uint8_t* p = qw + (d >> 3) * (FW_BQ * 128) + r * 128 +
                     (((d & 7) ^ (r & 7)) << 4) + tq * 4;
        *reinterpret_cast<unsigned*>(p) =
            pack_bf16(o[4 * d] / il0, o[4 * d + 1] / il0);
        *reinterpret_cast<unsigned*>(p + 8 * 128) =
            pack_bf16(o[4 * d + 2] / il1, o[4 * d + 3] / il1);
      }
    }
    bar_sync<128>(1 + cw);
    bf16* ob = out + (static_cast<size_t>(b) * S * nh + h) * 128;
    const size_t row_stride = static_cast<size_t>(nh) * 128;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = wt + i * 128;
      const int r = c >> 4, ch = c & 15;
      *reinterpret_cast<uint4*>(ob + (q0 + r) * row_stride + ch * 8) =
          *reinterpret_cast<const uint4*>(qw + (ch >> 3) * (FW_BQ * 128) +
                                          r * 128 +
                                          (((ch & 7) ^ (r & 7)) << 4));
    }
  }
}

}  // namespace

// q [B, S, nh, 128] bf16 through strides (q_sb, q_ss, q_sh); K through
// (k_sb, k_sh, k_ss) as [B, nkv, S, 128]; v through (v_sb, v_ss, v_sh) as
// [B, S, nkv, 128]; every head-dim stride 1, every stride a multiple of 8
// elements and the bases 16-byte aligned (K and V come by TMA); out
// [B, S, nh, 128] bf16 contiguous. S % 128 == 0 and nh % nkv == 0
// (checked in Python); scale = sm_scale * log2(e).
extern "C" int fq_flash_prefill(const void* q, const void* k,
                                      const void* v, void* out, int q_sb,
                                      int q_ss, int q_sh, int k_sb, int k_sh,
                                      int k_ss, int v_sb, int v_ss, int v_sh,
                                      int B, int S, int nh, int nkv,
                                      float scale, void* stream) {
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        FW_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  // K and V as [B][nkv][S][128] through their element strides
  const long long dims[4] = {128, S, nkv, B};
  const long long ks[3] = {2LL * k_ss, 2LL * k_sh, 2LL * k_sb};
  const long long vs[3] = {2LL * v_ss, 2LL * v_sh, 2LL * v_sb};
  CUtensorMap kmap, vmap;
  if (!tensor_map4_bf16(&kmap, k, dims, ks, 64, FW_BK) ||
      !tensor_map4_bf16(&vmap, v, dims, vs, 64, FW_BK))
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(nh, B, S / FW_BQ);
  flash_wgmma_kernel<<<grid, FW_THREADS, FW_SMEM,
                       static_cast<cudaStream_t>(stream)>>>(
      kmap, vmap, static_cast<const bf16*>(q), static_cast<bf16*>(out), q_sb,
      q_ss, q_sh, S, nh, nh / nkv, scale);
  return static_cast<int>(cudaGetLastError());
}
