// Split flash attention on (B, S, H, d) bf16 q/k/v, any head dim d with
// d % 8 == 0 up to 512, any Sq and Sk.  d <= 64 goes to the kernel of
// flash_hopper.cu; the kernel in this file runs 64 < d <= 512 on wgmma, TMA
// and mbarriers, instantiated at the panel widths D = 128 ... 512 (D = d
// rounded up to a multiple of 64: d = 80 runs the 128-wide kernel, 160 the
// 192-wide one).
//
// Replaces gswm/ops/attention.py:414 flash_attention -> _flash_bhsd (:250),
// whose three Pallas tiers (_flash_kernel :212 head-resident,
// _flash_kernel_kvres :231 KV-resident, _flash_kernel_streamk :355
// streaming K/V) are VMEM-fit choices of one computation.  Its user on the
// port's path is the VAE mid-block attention above 4096 tokens: one head with
// D = C = 512 over 9216 tokens at 768x768, in the encoder and the decoder
// (gswm/models/layers.py:692-725), and the core of SD 1.x's fused-qkv
// self-attention (fused_qkv.cu) at d = 80 and 160.  The JAX wrapper transposes to
// (B*H, S, D) and pads to its blocks; here q/k/v are read strided in their
// natural layout, ragged keys are masked and ragged query rows dropped.
//
// Semantics: the `use_max` branch of the TPU kernels' recurrence
// (_attend_kv_loop / _flash_kernel_streamk): q scaled by d^-0.5 in fp32 and
// rounded to bf16, fp32 logits, an exact running row max, p = exp(s - m)
// rounded to bf16 for the PV product, fp32 row sums of the rounded p and an
// fp32 accumulator.  The TPU bf16 path drops the max and clamps logits at
// 60; the two differ above that (tests/test_torch_attention.py and
// tests/test_torch_gpu.py pin both sides).
//
// What bounds it on an H100: at the VAE shape (B=2, S=9216, D=512) the two
// products are 2 * 2 * 9216^2 * 512 * 2 = 348 GFLOP against 4 * 2 * 9216 *
// 512 * 2 = 75 MB of q/k/v/out, some 4,600 FLOP a byte: the tensor cores
// bound it, and the 9216^2 logits (340 MB in fp32 per image, what the plain
// version materializes) must never reach device memory.  Every block walks
// all of k and v (18.9 MB at that shape), so what the blocks read from L2 is
// the second roof: the more query rows a block takes, the less of it.
//
// Design.  The D = 64 kernel's design (flash_hopper.cu) with one change: a
// 64 x 512 fp32 accumulator is 256 registers a thread for one warpgroup, so
// D is split across the consumer warpgroups instead of the query rows.
//   * A block is one producer warpgroup (one thread issues TMA) and two
//     consumer warpgroups that share the same 64 query rows.  A D-wide row
//     is D / 64 panels of 64 columns; consumer 0 owns the output columns of
//     the first ceil(D / 128) panels, consumer 1 the rest (4 + 4 at D = 512:
//     128 accumulator registers a thread; 2 + 1 at D = 192).
//   * Tiles are sets of 64 x 64 panels in hopper.cuh's one layout (rows of
//     128 bytes under the 128-byte swizzle), one TMA box each: the tensor
//     maps are (d, H, S, B) over the true head width and panel j is the box
//     at x = 64 j, so a tile never crosses into the next batch or head, rows
//     past S arrive as zeros, and so do the columns from d to D (the last
//     panel of d = 80 holds 16 real columns, of d = 160 32).  Zero columns
//     add nothing to the logits and give zero output columns, which the
//     store drops.  A transaction still counts the whole box.
//   * The scale d^-0.5 (the true d, not the panel width) is no power of two
//     here, so the stated semantics are kept literally: once the q tile has
//     landed, the consumers scale it in shared memory (hopper.cuh
//     scale_tile: fp32 multiply, rounded to bf16).
//   * S = q k^T reduces over all of D, so each consumer needs the whole
//     64 x 64 logits tile: both compute it (D / 16 wgmma m64n64k16, q and k
//     panels K-major from shared memory).  The product is done twice (1.5x
//     the work in all), and in return the two warpgroups never synchronise
//     inside a tile and the softmax runs in registers exactly as at D = 64
//     (hopper.cuh softmax_tile); both hold the same p and the same row sums.
//   * O += p v: p is wgmma's register A fragment; panel j of v (keys x 64)
//     is the MN-major B operand of output columns [64 j, 64 j + 64): four
//     wgmma m64n64k16 per owned panel per tile.
//   * 64-key tiles of k and v go through a ring whose depth follows from D
//     at compile time: 4 stages at D <= 192, 3 at 256, 2 at 320, and from 384
//     up one k and one v buffer (q, k and v are 64 KB each at D = 512).  k
//     and v have their own full and empty mbarriers, so with one buffer k of
//     tile t + 1 loads under the softmax and p v of tile t, and v of tile
//     t + 1 under the logits of tile t + 1.
//   * The output goes, normalised and rounded, through the q tile's panels
//     and one TMA store per panel, which drops rows at or past Sq.
// The log-sum-exp variant (gswm_flash_split_lse, every d this file and
// flash_hopper.cu take): a template flag adds, after the output tile is
// written, the store of each row's lse = m * c * ln 2 + ln l (hopper.cuh
// store_lse) into an fp32 (B, H, Sq) array, masked past Sq by hand since no
// TMA store drops those rows.  Sequence-parallel ring attention
// (ops/ring_attention.py) merges its per-shard partials by it; with the flag
// off the kernels are what they were.
// Not done here: a cluster of two blocks along the query axis sharing each k
// and v tile by multicast (halves the L2 traffic), and a split of the keys
// across blocks for the second wave's tail at batch 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_core.cuh"
#include "hopper.cuh"

namespace {

using namespace gswm_hopper;

constexpr int BM = 64;  // query rows per block
constexpr int BN = 64;  // keys per tile
constexpr int PANEL = 64 * ROW_ELEMS;  // elements of one 64 x 64 panel (8 KB)
constexpr int PANEL_BYTES = PANEL * (int)sizeof(bf16);
constexpr int CONSUMERS = 2;
constexpr int THREADS = (1 + CONSUMERS) * 128;
constexpr int SMEM_LIMIT = 232448;  // the 227 KB a block may opt into
constexpr int MAX_STAGES = 4;

template <int D>
struct Tile {
  static_assert(D % 64 == 0 && D >= 128 && D <= 512,
                "the panel width D is a multiple of 64, 128 to 512");
  static constexpr int NP = D / 64;          // panels of a row
  static constexpr int NP0 = (NP + 1) / 2;   // consumer 0's; consumer 1 takes the rest
  static constexpr int ELEMS = NP * PANEL;   // a 64-row tile of q, k or v
  static constexpr int BYTES = ELEMS * (int)sizeof(bf16);
  // the ring's depth: what fits beside the q tile, the barriers and the
  // room to align
  static constexpr int FIT = (SMEM_LIMIT - SWIZZLE_SPAN - 256 - BYTES) / (2 * BYTES);
  static constexpr int STAGES = FIT > MAX_STAGES ? MAX_STAGES : FIT;
  static_assert(STAGES >= 1, "q, one k and one v tile must fit");
};

template <int D>
struct Smem {
  static constexpr int STAGES = Tile<D>::STAGES;
  bf16 q[Tile<D>::ELEMS];  // scaled in place; later the output tile
  bf16 k[STAGES][Tile<D>::ELEMS];
  bf16 v[STAGES][Tile<D>::ELEMS];
  uint64_t full_q;
  uint64_t full_k[STAGES];
  uint64_t full_v[STAGES];
  uint64_t empty_k[STAGES];  // every consumer warp has its logits of the stage's k
  uint64_t empty_v[STAGES];  // every consumer warp has added the stage's p v
};

// One consumer warpgroup: the logits and softmax of the block's 64 rows, and
// the output columns of panels [P0, P0 + PN).  LSE: consumer 0 also stores
// the rows' log-sum-exp (both hold the same m and l).
template <int D, int P0, int PN, bool LSE>
__device__ __forceinline__ void consume(Smem<D>& sm, const CUtensorMap* map_o, int Sk,
                                        int row0, int h, int b, float scale, float* lse,
                                        int Sq) {
  constexpr int NP = Tile<D>::NP;
  constexpr int STAGES = Tile<D>::STAGES;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int tiles = (Sk + BN - 1) / BN;

  // rows 16 * warp + g (lo) and + 8 (hi) of the block's 64
  float o[PN][32];
#pragma unroll
  for (int j = 0; j < PN; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[j][i] = 0.0f;
  float s[32];
  float m_lo = -INFINITY, m_hi = -INFINITY;  // running max of the logits
  float l_lo = 0.0f, l_hi = 0.0f;            // this thread's share of the row sums

  // q scaled by d^-0.5 in fp32 and rounded to bf16, by both consumers
  mbar_wait(&sm.full_q, 0);
  scale_tile(sm.q, Tile<D>::ELEMS, scale, threadIdx.x - 128, CONSUMERS * 128);
  fence_async_smem();
  named_barrier(1, CONSUMERS * 128);

  const float log2e = 1.4426950408889634f;
  int stage = 0;
  uint32_t phase = 0;
  for (int t = 0; t < tiles; ++t) {
    mbar_wait(&sm.full_k[stage], phase);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      const uint64_t dq = smem_desc_sw128(sm.q + j * PANEL);
      const uint64_t dk = smem_desc_sw128(sm.k[stage] + j * PANEL);
#pragma unroll
      for (int kk = 0; kk < ROW_ELEMS / 16; ++kk)
        wgmma_m64n64k16_ss<0, 0>(s, dq + kk * DESC_K_STEP, dk + kk * DESC_K_STEP,
                                 j + kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    if (lane == 0) mbar_arrive(&sm.empty_k[stage]);

    // p rounded to bf16, in wgmma's A layout; keys past Sk masked
    uint32_t p[BN / 16][4];
    float a_lo, a_hi;
    softmax_tile<BN / 8>(s, p, m_lo, m_hi, l_lo, l_hi, a_lo, a_hi, Sk - t * BN, log2e, t4);
#pragma unroll
    for (int j = 0; j < PN; ++j) scale_rows(o[j], a_lo, a_hi);

    mbar_wait(&sm.full_v[stage], phase);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < PN; ++j) {
      const uint64_t dv = smem_desc_sw128(sm.v[stage] + (P0 + j) * PANEL);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_m64n64k16_rs(o[j], p[kk], dv + kk * DESC_MN_STEP);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < PN; ++j) fence_regs(o[j]);
    if (lane == 0) mbar_arrive(&sm.empty_v[stage]);
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }

  // the other consumer may still read q for its last logits: wait for it,
  // then the owned panels of the q tile take the output
  named_barrier(1, CONSUMERS * 128);
  const float sum_lo = quad_sum(l_lo);
  const float sum_hi = quad_sum(l_hi);
  const float inv_lo = 1.0f / sum_lo;
  const float inv_hi = 1.0f / sum_hi;
#pragma unroll
  for (int j = 0; j < PN; ++j)
    store_tile_sw128(sm.q + (P0 + j) * PANEL, o[j], inv_lo, inv_hi, warp, g, t4);
  if constexpr (LSE && P0 == 0)
    store_lse(lse, Sq, row0 + warp * 16 + g, m_lo, m_hi, sum_lo, sum_hi, log2e, t4);
  fence_async_smem();
  named_barrier(2 + (P0 > 0), 128);
  if ((threadIdx.x & 127) == 0) {
#pragma unroll
    for (int j = 0; j < PN; ++j)
      tma_store_4d(map_o, sm.q + (P0 + j) * PANEL, (P0 + j) * ROW_ELEMS, h, row0, b);
    tma_store_wait();
  }
}

// Grid (query blocks of 64 rows, H, B).  scale = d^-0.5 of the true d <= D.
// LSE: each row's log-sum-exp into lse (B, H, Sq) fp32; else lse and Sq are
// not read.
template <int D, bool LSE>
__global__ void __launch_bounds__(THREADS, 1)
flash_split_kernel(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   const __grid_constant__ CUtensorMap map_o, int Sk, float scale,
                   float* lse, int Sq) {
  constexpr int NP = Tile<D>::NP;
  constexpr int NP0 = Tile<D>::NP0;
  constexpr int STAGES = Tile<D>::STAGES;
  extern __shared__ unsigned char smem_raw[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(align_smem(smem_raw));

  const int group = threadIdx.x >> 7;  // 0: producer, 1, 2: consumers
  const int row0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  if (threadIdx.x == 0) {
    mbar_init(&sm.full_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full_k[s], 1);
      mbar_init(&sm.full_v[s], 1);
      mbar_init(&sm.empty_k[s], CONSUMERS * 4);
      mbar_init(&sm.empty_v[s], CONSUMERS * 4);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (group == 0) {
    reg_dec<40>();
    if (threadIdx.x == 0) {
      const int tiles = (Sk + BN - 1) / BN;
      mbar_expect_tx(&sm.full_q, Tile<D>::BYTES);
      for (int j = 0; j < NP; ++j)
        tma_load_4d(sm.q + j * PANEL, &map_q, &sm.full_q, j * ROW_ELEMS, h, row0, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int t = 0; t < tiles; ++t) {
        mbar_wait(&sm.empty_k[stage], phase ^ 1);
        mbar_expect_tx(&sm.full_k[stage], Tile<D>::BYTES);
        for (int j = 0; j < NP; ++j)
          tma_load_4d(sm.k[stage] + j * PANEL, &map_k, &sm.full_k[stage], j * ROW_ELEMS, h,
                      t * BN, b);
        mbar_wait(&sm.empty_v[stage], phase ^ 1);
        mbar_expect_tx(&sm.full_v[stage], Tile<D>::BYTES);
        for (int j = 0; j < NP; ++j)
          tma_load_4d(sm.v[stage] + j * PANEL, &map_v, &sm.full_v[stage], j * ROW_ELEMS, h,
                      t * BN, b);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    reg_inc<232>();
    if (group == 1)
      consume<D, 0, NP0, LSE>(sm, &map_o, Sk, row0, h, b, scale, lse, Sq);
    else
      consume<D, NP0, NP - NP0, LSE>(sm, &map_o, Sk, row0, h, b, scale, lse, Sq);
  }
}

// d, the true head dim: D - 64 < d <= D, d % 8 == 0.
template <int D, bool LSE>
cudaError_t start(const bf16* q, const bf16* k, const bf16* v, bf16* out, int B, int Sq,
                  int Sk, int H, int d, cudaStream_t stream, float* lse) {
  constexpr int smem = (int)sizeof(Smem<D>) + SWIZZLE_SPAN;
  static_assert(smem <= SMEM_LIMIT, "above the 227 KB a block may opt into");
  static_assert(PANEL_BYTES % SWIZZLE_SPAN == 0, "panels keep the tiles' alignment");
  // natural layout: q, k, v and out share one row pitch of H heads of d
  const int ld = H * d;
  CUtensorMap mq, mk, mv, mo;
  cudaError_t e = head_map(&mq, q, B, Sq, H, d, ld, BM);
  if (e == cudaSuccess) e = head_map(&mk, k, B, Sk, H, d, ld, BN);
  if (e == cudaSuccess) e = head_map(&mv, v, B, Sk, H, d, ld, BN);
  if (e == cudaSuccess) e = head_map(&mo, out, B, Sq, H, d, ld, BM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(flash_split_kernel<D, LSE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Sq + BM - 1) / BM, H, B);
  flash_split_kernel<D, LSE><<<grid, THREADS, smem, stream>>>(
      mq, mk, mv, mo, Sk, 1.0f / sqrtf((float)d), lse, Sq);
  return cudaGetLastError();
}

// lse nullptr: the kernel without the lse store
template <int D>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* out, int B, int Sq,
                   int Sk, int H, int d, cudaStream_t stream, float* lse) {
  return lse ? start<D, true>(q, k, v, out, B, Sq, Sk, H, d, stream, lse)
             : start<D, false>(q, k, v, out, B, Sq, Sk, H, d, stream, lse);
}

}  // namespace

cudaError_t gswm_launch_flash_split(const bf16* q, const bf16* k, const bf16* v,
                                    bf16* out, int B, int Sq, int Sk, int H, int D,
                                    cudaStream_t stream, float* lse) {
  if (B < 1 || Sq < 1 || Sk < 1 || H < 1 || B > 65535 || H > 65535 || D < 8 || D % 8 ||
      D > 512)
    return cudaErrorInvalidValue;
  if (D <= ROW_ELEMS)
    return gswm_launch_flash_hopper(q, k, v, out, B, Sq, Sk, H, D, H * D, H * D, H * D,
                                    stream, lse);
  // the panel width: D rounded up to a multiple of 64
  switch ((D + ROW_ELEMS - 1) / ROW_ELEMS * ROW_ELEMS) {
    case 128: return launch<128>(q, k, v, out, B, Sq, Sk, H, D, stream, lse);
    case 192: return launch<192>(q, k, v, out, B, Sq, Sk, H, D, stream, lse);
    case 256: return launch<256>(q, k, v, out, B, Sq, Sk, H, D, stream, lse);
    case 320: return launch<320>(q, k, v, out, B, Sq, Sk, H, D, stream, lse);
    case 384: return launch<384>(q, k, v, out, B, Sq, Sk, H, D, stream, lse);
    case 448: return launch<448>(q, k, v, out, B, Sq, Sk, H, D, stream, lse);
    case 512: return launch<512>(q, k, v, out, B, Sq, Sk, H, D, stream, lse);
    default: return cudaErrorInvalidValue;
  }
}

// q, out: (B, Sq, H, D); k, v: (B, Sk, H, D); bf16 device pointers, rows
// 16-byte aligned; D % 8 == 0, 8 <= D <= 512.  out = softmax(q k^T /
// sqrt(D)) v per (batch, head).
extern "C" int gswm_flash_split(const void* q, const void* k, const void* v, void* out,
                                int B, int Sq, int Sk, int H, int D, void* stream) {
  return static_cast<int>(gswm_launch_flash_split(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), B, Sq, Sk, H, D,
      static_cast<cudaStream_t>(stream)));
}

// The same, and lse: fp32 (B, H, Sq), each row's log-sum-exp of the true
// logits q k^T / sqrt(D) in natural-log units, so that partial outputs over
// disjoint key sets merge exactly (ops.ring_attention).  The kernels are the
// ones above, instantiated with the store of lse in their epilogue.
extern "C" int gswm_flash_split_lse(const void* q, const void* k, const void* v, void* out,
                                    void* lse, int B, int Sq, int Sk, int H, int D,
                                    void* stream) {
  if (lse == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(gswm_launch_flash_split(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), B, Sq, Sk, H, D,
      static_cast<cudaStream_t>(stream), static_cast<float*>(lse)));
}
