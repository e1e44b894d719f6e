// Flash self-attention on the transposed stacked projection output, any
// head dim d with d % 8 == 0, 8 <= d <= 512.
//
// Replaces gswm/ops/attention.py:1428 flash_attention_transposed ->
// _flash_kernel_T (:1281, pallas_call :1470), which the JAX UNet routes its
// self-attention to under GSWM_TRANSPOSED_ATTN=1 (gswm/models/layers.py
// :465-482; any head_dim % 8 == 0, layers.py:369): the ('nc,bsc->nbs') qkv
// matmul writes (3 * H * d, B, S), q, k and v are row bands of that one
// array, and to_out contracts the (H * d, B, S) output over dim 0, so no
// split, reshape or transpose exists around the kernel.  Element (r, s) of
// head h and batch b of q lies at (h * d + r) * B * S + b * S + s; k's band
// starts at row H * d, v's at 2 * H * d; the output uses q's indexing.
//
// Semantics: exact softmax, the `use_max` recurrence of the TPU kernels, as
// in flash_hopper.cu: at d = 64 the scale 2^-3 folded with log2(e) into the
// exponent (exact); at any other d, q scaled by the true d^-0.5 in fp32 and
// rounded to bf16 in shared memory (hopper.cuh scale_tile), the exponent
// folding log2(e) alone.  The TPU kernel drops the running max and clamps
// logits at 60 on every dtype (:1305-1307); the two agree within rounding
// below that (tests/test_torch_tiers.py and tests/test_torch_gpu.py pin
// both sides).
//
// What bounds it on an H100: the products of the natural-layout kernels, 4 *
// B * H * S^2 * d FLOP over 8 * B * H * S * d bytes (S / 2 FLOP a byte,
// 4,600 at 9216 tokens), and B * H * S^2 exponentials at 16 a clock an SM:
// the exponentials below d = 64, the tensor cores above (roofline.py).  The
// layout only changes how tiles arrive and which way round wgmma reads them.
//
// Tensor maps over the true d: (S, B, d, heads), tokens innermost, boxes of
// (64 tokens, 1, 64 rows, 1) (hopper.cuh band_map).  Panel j of a head is
// the box at row 64 j: rows from d to the panel's end arrive as zeros on a
// load and are dropped on a store, and no box reaches into the next head's
// rows; tokens past S arrive as zeros and never from batch b + 1.  A panel
// lands as 64 rows (d) of 128 bytes (64 tokens) in hopper.cuh's one layout.
//
// Five kernels, chosen by the shape alone (launch_tma and the C entry):
//
//   S % 8 != 0            flash_transposed_masked_kernel (below)
//   d <= 48               flash_hopper.cu's flash_narrow_kernel, transposed
//   48 < d <= 64          flash_transposed_kernel (below)
//   64 < d <= 160         flash_mid.cu's flash_mid_kernel, transposed
//   d > 160               flash_transposed_split_kernel (below), 192 ... 512
//
// S % 8 == 0, d <= 48 (SD 1.x's 40 at level 0) and 64 < d <= 160 (its 80
// and 160 at levels 1 and 2): the natural layout's own designs, the layout a
// template parameter of their one body (hopper.cuh Layout; launchers in
// flash_core.cuh): the narrow kernel's three warpgroups in turns, logits of
// tile t + 1 with p v of tile t, row sums on the tensor cores and p v at N =
// 48; the mid kernel's one warpgroup owning 64 tokens across the whole d,
// full 64-row panels and a tail rounded up to 16 rows.
//
// S % 8 == 0, 48 < d <= 64 (SD 2.x's 64): flash_transposed_kernel,
// flash_hopper.cu's d <= 64 design (one producer thread, one or two consumer
// warpgroups of 64 query tokens chosen from the card's SM count, 128-key
// tiles in a 2-stage ring with separate k and v mbarriers, hopper.cuh's
// softmax in registers) on the operands as they lie:
//   * a head is one panel; a 128-key tile is two panels side by side;
//   * S = q k^T reduces over d, which runs down the rows of both tiles: q
//     and k are both MN-major operands (wgmma's transpose-A bit exists only
//     with A in shared memory, which q is), one wgmma m64n64k16 per 64-key
//     panel and 16 rows of d; the two panels' logits are the two halves of
//     the 64 x 128 fragment;
//   * O += p v reduces over keys, which run along the rows of the v tile: a
//     K-major B operand as it lies, p from registers;
//   * the accumulator (tokens x d) goes transposed, normalised and rounded,
//     into the warpgroup's q tile (d rows of 64 tokens under the swizzle)
//     and out by one TMA store, which drops tokens at or past S and rows at
//     or past d.
//
// S % 8 == 0, 160 < d <= 512: flash_transposed_split_kernel, flash_split.cu's
// design on the transposed maps, instantiated at the panel widths D = 192
// ... 512 (d rounded up to a multiple of 64).  A 64 x 512 fp32 accumulator
// would be 256 registers a thread for one warpgroup, so two consumer
// warpgroups share 64 query tokens: both compute the whole 64 x 64 logits
// tile, reducing over all D / 64 panels of d (each panel as above), and
// each owns half of the output's panels (consumer 0 the first ceil(D / 128)),
// adding p v for its panels and storing them.  64-key tiles of k and v go
// through a ring whose depth follows from D, as in flash_split.cu (4 stages
// at D <= 192, 1 from D = 384 up).
//
// S % 8 != 0 (S = 1000, say): token rows are not 16-byte aligned, which TMA's
// global strides (S * 2 and B * S * 2 bytes) must be, so these shapes cannot
// go through a tensor map at all.  flash_transposed_masked_kernel serves
// them: one block of eight warps, 32 query tokens, 64-key tiles loaded and
// stored element by element, masked; mma.sync m16n8k16 on tiles read with
// ldmatrix(.trans), logits and p through shared memory; d is walked in
// 64-row panels (zeros written past d, only rows < d stored).  It is a
// second hand-written kernel for shapes the others cannot address, not a
// fallback: no shape they take ever reaches it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_core.cuh"
#include "hopper.cuh"

namespace {

using namespace gswm_hopper;

constexpr int D = 64;  // rows of a panel: one head of d <= 64, zero-padded
constexpr int NARROW_D = 48;  // the widest head of flash_hopper.cu's narrow kernel
constexpr int MID_D = 160;    // and of flash_mid.cu's
constexpr int PANEL = D * ROW_ELEMS;  // elements of a (64 d, 64 tokens) panel
constexpr int PANEL_BYTES = PANEL * (int)sizeof(bf16);

// ------------------------------- S % 8 == 0, 48 < d <= 64: wgmma + TMA ----

constexpr int BM = 64;    // query tokens per consumer warpgroup
constexpr int BN = 128;   // keys per tile: two 64-key panels
constexpr int STAGES = 2;
constexpr int KV_PANELS = BN / ROW_ELEMS;

template <int NWG>
struct Smem {
  bf16 q[NWG][PANEL];  // later the output tile
  bf16 k[STAGES][KV_PANELS * PANEL];
  bf16 v[STAGES][KV_PANELS * PANEL];
  uint64_t full_q;
  uint64_t full_k[STAGES];
  uint64_t full_v[STAGES];
  uint64_t empty[STAGES];  // every consumer warp is done with the stage's k and v
};

// Grid (query blocks, H, B).  map_in: (S, B, d, 3 H); map_out: (S, B, d, H).
// SCALE_Q: q is scaled by q_scale = d^-0.5 in shared memory and exp_scale =
// log2(e); else (d = 64) exp_scale = 2^-3 * log2(e) and q_scale is not read.
template <int NWG, bool SCALE_Q>
__global__ void __launch_bounds__((NWG + 1) * 128, NWG == 1 ? 2 : 1)
flash_transposed_kernel(const __grid_constant__ CUtensorMap map_in,
                        const __grid_constant__ CUtensorMap map_out, int S, int H,
                        float exp_scale, float q_scale) {
  extern __shared__ unsigned char smem_raw[];
  Smem<NWG>& sm = *reinterpret_cast<Smem<NWG>*>(align_smem(smem_raw));

  const int group = threadIdx.x >> 7;  // 0: producer, 1..NWG: consumers
  const int tok0 = blockIdx.x * (NWG * BM);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tiles = (S + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(&sm.full_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full_k[s], 1);
      mbar_init(&sm.full_v[s], 1);
      mbar_init(&sm.empty[s], NWG * 4);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (group == 0) {
    reg_dec<NWG == 1 ? 24 : 40>();
    if (threadIdx.x == 0) {
      // the bands' heads: q at h, k at H + h, v at 2 H + h
      mbar_expect_tx(&sm.full_q, NWG * PANEL_BYTES);
      for (int w = 0; w < NWG; ++w)
        tma_load_4d(sm.q[w], &map_in, &sm.full_q, tok0 + w * BM, b, 0, h);
      int stage = 0;
      uint32_t phase = 0;
      for (int t = 0; t < tiles; ++t) {
        mbar_wait(&sm.empty[stage], phase ^ 1);
        mbar_expect_tx(&sm.full_k[stage], KV_PANELS * PANEL_BYTES);
        for (int pn = 0; pn < KV_PANELS; ++pn)
          tma_load_4d(sm.k[stage] + pn * PANEL, &map_in, &sm.full_k[stage],
                      t * BN + pn * ROW_ELEMS, b, 0, H + h);
        mbar_expect_tx(&sm.full_v[stage], KV_PANELS * PANEL_BYTES);
        for (int pn = 0; pn < KV_PANELS; ++pn)
          tma_load_4d(sm.v[stage] + pn * PANEL, &map_in, &sm.full_v[stage],
                      t * BN + pn * ROW_ELEMS, b, 0, 2 * H + h);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    reg_inc<232>();
    const int cw = group - 1;
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t4 = lane & 3;

    // tokens 16 * warp + g (lo) and + 8 (hi) of this warpgroup's 64
    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.0f;
    float s[64];  // keys 0-63 of the tile in s[0..31], keys 64-127 in s[32..63]
    float m_lo = -INFINITY, m_hi = -INFINITY;  // running max of the raw logits
    float l_lo = 0.0f, l_hi = 0.0f;            // this thread's share of the row sums

    const uint64_t dq = smem_desc_sw128(sm.q[cw]);
    mbar_wait(&sm.full_q, 0);
    if constexpr (SCALE_Q) {  // this warpgroup's own q tile
      scale_tile(sm.q[cw], PANEL, q_scale, threadIdx.x & 127, 128);
      fence_async_smem();
      named_barrier(1 + cw, 128);
    }

    int stage = 0;
    uint32_t phase = 0;
    for (int t = 0; t < tiles; ++t) {
      mbar_wait(&sm.full_k[stage], phase);
      wgmma_fence();
#pragma unroll
      for (int pn = 0; pn < KV_PANELS; ++pn) {
        const uint64_t dk = smem_desc_sw128(sm.k[stage] + pn * PANEL);
        float(&s_pn)[32] = *reinterpret_cast<float(*)[32]>(&s[32 * pn]);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_m64n64k16_ss<1, 1>(s_pn, dq + kk * DESC_MN_STEP, dk + kk * DESC_MN_STEP,
                                   kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      // p rounded to bf16, in wgmma's A layout; keys past S masked
      uint32_t p[BN / 16][4];
      float a_lo, a_hi;
      softmax_tile<BN / 8>(s, p, m_lo, m_hi, l_lo, l_hi, a_lo, a_hi, S - t * BN, exp_scale,
                           t4);
      scale_rows(o, a_lo, a_hi);

      mbar_wait(&sm.full_v[stage], phase);
      wgmma_fence();
#pragma unroll
      for (int pn = 0; pn < KV_PANELS; ++pn) {
        const uint64_t dv = smem_desc_sw128(sm.v[stage] + pn * PANEL);
#pragma unroll
        for (int kk = 0; kk < ROW_ELEMS / 16; ++kk)
          wgmma_m64n64k16_rs<0>(o, p[pn * (ROW_ELEMS / 16) + kk], dv + kk * DESC_K_STEP);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(&sm.empty[stage]);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

    // normalised, rounded and transposed into the warpgroup's q tile: row r,
    // token c at 16-byte chunk (c / 8) ^ (r % 8) of the row, as TMA's
    // 128-byte swizzle wants it; rows at or past d are dropped by the store
    store_tile_transposed(sm.q[cw], o, 1.0f / quad_sum(l_lo), 1.0f / quad_sum(l_hi), warp,
                          g, t4);
    fence_async_smem();
    named_barrier(1 + cw, 128);
    if ((threadIdx.x & 127) == 0) {
      tma_store_4d(&map_out, sm.q[cw], tok0 + cw * BM, b, 0, h);
      tma_store_wait();
    }
  }
}

template <int NWG, bool SCALE_Q>
cudaError_t launch(const CUtensorMap& m_in, const CUtensorMap& m_out, int B, int S, int H,
                   int d, cudaStream_t stream) {
  constexpr int smem = (int)sizeof(Smem<NWG>) + SWIZZLE_SPAN;
  cudaError_t e = cudaFuncSetAttribute(flash_transposed_kernel<NWG, SCALE_Q>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((S + NWG * BM - 1) / (NWG * BM), H, B);
  const float log2e = 1.4426950408889634f;
  flash_transposed_kernel<NWG, SCALE_Q><<<grid, (NWG + 1) * 128, smem, stream>>>(
      m_in, m_out, S, H, SCALE_Q ? log2e : 0.125f * log2e, 1.0f / sqrtf((float)d));
  return cudaGetLastError();
}

// ----------------------------- S % 8 == 0, 160 < d <= 512: D split in two ----

namespace split {

constexpr int BN = 64;  // keys per tile: one panel wide
constexpr int CONSUMERS = 2;
constexpr int THREADS = (1 + CONSUMERS) * 128;
constexpr int SMEM_LIMIT = 232448;  // the 227 KB a block may opt into
constexpr int MAX_STAGES = 4;

template <int DP>
struct Tile {
  static_assert(DP % 64 == 0 && DP >= 192 && DP <= 512,
                "the panel width is a multiple of 64, 192 to 512");
  static constexpr int NP = DP / 64;         // panels of a head
  static constexpr int NP0 = (NP + 1) / 2;   // consumer 0's; consumer 1 takes the rest
  static constexpr int ELEMS = NP * PANEL;   // a 64-token tile of q, k or v
  static constexpr int BYTES = ELEMS * (int)sizeof(bf16);
  static constexpr int FIT = (SMEM_LIMIT - SWIZZLE_SPAN - 256 - BYTES) / (2 * BYTES);
  static constexpr int STAGES = FIT > MAX_STAGES ? MAX_STAGES : FIT;
  static_assert(STAGES >= 1, "q, one k and one v tile must fit");
};

template <int DP>
struct Smem {
  static constexpr int STAGES = Tile<DP>::STAGES;
  bf16 q[Tile<DP>::ELEMS];  // scaled in place; later the output tile
  bf16 k[STAGES][Tile<DP>::ELEMS];
  bf16 v[STAGES][Tile<DP>::ELEMS];
  uint64_t full_q;
  uint64_t full_k[STAGES];
  uint64_t full_v[STAGES];
  uint64_t empty_k[STAGES];  // every consumer warp has its logits of the stage's k
  uint64_t empty_v[STAGES];  // every consumer warp has added the stage's p v
};

// One consumer warpgroup: the logits and softmax of the block's 64 tokens,
// and the output rows of d in panels [P0, P0 + PN).
template <int DP, int P0, int PN>
__device__ __forceinline__ void consume(Smem<DP>& sm, const CUtensorMap* map_out, int S,
                                        int tok0, int h, int b, float scale) {
  constexpr int NP = Tile<DP>::NP;
  constexpr int STAGES = Tile<DP>::STAGES;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int tiles = (S + BN - 1) / BN;

  float o[PN][32];  // tokens 16 * warp + g (lo) and + 8 (hi), 64 rows of d a panel
#pragma unroll
  for (int j = 0; j < PN; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[j][i] = 0.0f;
  float s[32];
  float m_lo = -INFINITY, m_hi = -INFINITY;
  float l_lo = 0.0f, l_hi = 0.0f;

  // q scaled by d^-0.5 in fp32 and rounded to bf16, by both consumers
  mbar_wait(&sm.full_q, 0);
  scale_tile(sm.q, Tile<DP>::ELEMS, scale, threadIdx.x - 128, CONSUMERS * 128);
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
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_m64n64k16_ss<1, 1>(s, dq + kk * DESC_MN_STEP, dk + kk * DESC_MN_STEP,
                                 j + kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    if (lane == 0) mbar_arrive(&sm.empty_k[stage]);

    // p rounded to bf16, in wgmma's A layout; keys past S masked
    uint32_t p[BN / 16][4];
    float a_lo, a_hi;
    softmax_tile<BN / 8>(s, p, m_lo, m_hi, l_lo, l_hi, a_lo, a_hi, S - t * BN, log2e, t4);
#pragma unroll
    for (int j = 0; j < PN; ++j) scale_rows(o[j], a_lo, a_hi);

    mbar_wait(&sm.full_v[stage], phase);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < PN; ++j) {
      const uint64_t dv = smem_desc_sw128(sm.v[stage] + (P0 + j) * PANEL);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_m64n64k16_rs<0>(o[j], p[kk], dv + kk * DESC_K_STEP);
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
  const float inv_lo = 1.0f / quad_sum(l_lo);
  const float inv_hi = 1.0f / quad_sum(l_hi);
#pragma unroll
  for (int j = 0; j < PN; ++j)
    store_tile_transposed(sm.q + (P0 + j) * PANEL, o[j], inv_lo, inv_hi, warp, g, t4);
  fence_async_smem();
  named_barrier(2 + (P0 > 0), 128);
  if ((threadIdx.x & 127) == 0) {
#pragma unroll
    for (int j = 0; j < PN; ++j)
      tma_store_4d(map_out, sm.q + (P0 + j) * PANEL, tok0, b, (P0 + j) * D, h);
    tma_store_wait();
  }
}

// Grid (query blocks of 64 tokens, H, B).  scale = d^-0.5 of the true d.
template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
flash_transposed_split_kernel(const __grid_constant__ CUtensorMap map_in,
                              const __grid_constant__ CUtensorMap map_out, int S, int H,
                              float scale) {
  constexpr int NP = Tile<DP>::NP;
  constexpr int NP0 = Tile<DP>::NP0;
  constexpr int STAGES = Tile<DP>::STAGES;
  extern __shared__ unsigned char smem_raw[];
  Smem<DP>& sm = *reinterpret_cast<Smem<DP>*>(align_smem(smem_raw));

  const int group = threadIdx.x >> 7;  // 0: producer, 1, 2: consumers
  const int tok0 = blockIdx.x * BM;
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
      const int tiles = (S + BN - 1) / BN;
      mbar_expect_tx(&sm.full_q, Tile<DP>::BYTES);
      for (int j = 0; j < NP; ++j)
        tma_load_4d(sm.q + j * PANEL, &map_in, &sm.full_q, tok0, b, j * D, h);
      int stage = 0;
      uint32_t phase = 0;
      for (int t = 0; t < tiles; ++t) {
        mbar_wait(&sm.empty_k[stage], phase ^ 1);
        mbar_expect_tx(&sm.full_k[stage], Tile<DP>::BYTES);
        for (int j = 0; j < NP; ++j)
          tma_load_4d(sm.k[stage] + j * PANEL, &map_in, &sm.full_k[stage], t * BN, b, j * D,
                      H + h);
        mbar_wait(&sm.empty_v[stage], phase ^ 1);
        mbar_expect_tx(&sm.full_v[stage], Tile<DP>::BYTES);
        for (int j = 0; j < NP; ++j)
          tma_load_4d(sm.v[stage] + j * PANEL, &map_in, &sm.full_v[stage], t * BN, b, j * D,
                      2 * H + h);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    reg_inc<232>();
    if (group == 1)
      consume<DP, 0, NP0>(sm, &map_out, S, tok0, h, b, scale);
    else
      consume<DP, NP0, NP - NP0>(sm, &map_out, S, tok0, h, b, scale);
  }
}

template <int DP>
cudaError_t launch(const CUtensorMap& m_in, const CUtensorMap& m_out, int B, int S, int H,
                   int d, cudaStream_t stream) {
  constexpr int smem = (int)sizeof(Smem<DP>) + SWIZZLE_SPAN;
  static_assert(smem <= SMEM_LIMIT, "above the 227 KB a block may opt into");
  cudaError_t e = cudaFuncSetAttribute(flash_transposed_split_kernel<DP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((S + BM - 1) / BM, H, B);
  flash_transposed_split_kernel<DP><<<grid, THREADS, smem, stream>>>(
      m_in, m_out, S, H, 1.0f / sqrtf((float)d));
  return cudaGetLastError();
}

}  // namespace split

cudaError_t launch_tma(const bf16* in, bf16* out, int B, int S, int H, int d,
                       cudaStream_t stream) {
  if (d <= NARROW_D) return gswm_launch_flash_narrow_transposed(in, out, B, S, H, d, stream);
  if (d > D && d <= MID_D) return gswm_launch_flash_mid_transposed(in, out, B, S, H, d, stream);
  CUtensorMap m_in, m_out;
  cudaError_t e = band_map(&m_in, in, 3 * H, d, B, S);
  if (e == cudaSuccess) e = band_map(&m_out, out, H, d, B, S);
  if (e != cudaSuccess) return e;
  if (d > D) {  // the panel width: d rounded up to a multiple of 64
    switch ((d + D - 1) / D * D) {
      case 192: return split::launch<192>(m_in, m_out, B, S, H, d, stream);
      case 256: return split::launch<256>(m_in, m_out, B, S, H, d, stream);
      case 320: return split::launch<320>(m_in, m_out, B, S, H, d, stream);
      case 384: return split::launch<384>(m_in, m_out, B, S, H, d, stream);
      case 448: return split::launch<448>(m_in, m_out, B, S, H, d, stream);
      case 512: return split::launch<512>(m_in, m_out, B, S, H, d, stream);
      default: return cudaErrorInvalidValue;
    }
  }
  // 128-token blocks unless they would leave SMs of this card without one
  int sm_count = 0;
  e = multiprocessors(&sm_count);
  if (e != cudaSuccess) return e;
  const bool wide = (long)((S + 2 * BM - 1) / (2 * BM)) * H * B >= sm_count;
  if (d == D)  // the 2^-3 scale folded into the exponent, exact
    return wide ? launch<2, false>(m_in, m_out, B, S, H, d, stream)
                : launch<1, false>(m_in, m_out, B, S, H, d, stream);
  return wide ? launch<2, true>(m_in, m_out, B, S, H, d, stream)
              : launch<1, true>(m_in, m_out, B, S, H, d, stream);
}

// ------------------------------------- S % 8 != 0: mma.sync, masked tiles ----

namespace masked {

// One block of eight warps takes BQ query tokens and walks BK-key tiles;
// each warp computes a 16 x 16 tile of logits (2 row groups x 4 key groups)
// and owns BQ / WARPS softmax rows.
constexpr int BQ = 32;
constexpr int BK = 64;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int LDS = BK + 4;  // fp32 logits row pitch
constexpr int LDP = BK + 8;  // bf16 p row pitch
constexpr int ROWS_PER_WARP = BQ / WARPS;
constexpr int LQ = BQ + 8;  // bf16 row pitch of the d-major q (and output) panel
constexpr int LK = BK + 8;  // bf16 row pitch of the d-major k and v panels
constexpr int DS = D / 4;   // d slice of one warp's accumulator in a panel
constexpr int NT = DS / 8;  // n8 tiles in that slice

static_assert(BQ == 2 * 16 && BK == 4 * 16, "8 warps = 2 x 4 tiles of 16 x 16 logits");

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c (16 x 8 fp32) += a (16 x 16 bf16, row) * b (16 x 8 bf16, col).
// Fragment layout (PTX ISA, mma.m16n8k16), g = lane / 4, t = lane % 4:
//   a: {A[g][2t..], A[g+8][2t..], A[g][2t+8..], A[g+8][2t+8..]}
//   b: {B[2t..][g], B[2t+8..][g]}
//   c: {C[g][2t], C[g][2t+1], C[g+8][2t], C[g+8][2t+1]}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The two 16 x 8 logits fragments (s0: keys 0-7, s1: keys 8-15 of this
// warp's 16 x 16 tile at rows 16 * wr, keys 16 * wc) into the fp32 logits
// tile `ss`.
__device__ __forceinline__ void store_logits(float* ss, const float (&s0)[4],
                                             const float (&s1)[4], int wr, int wc, int g,
                                             int t4) {
  float* srow = ss + (wr * 16 + g) * LDS + wc * 16 + 2 * t4;
  srow[0] = s0[0];
  srow[1] = s0[1];
  srow[8 * LDS] = s0[2];
  srow[8 * LDS + 1] = s0[3];
  srow[8] = s1[0];
  srow[9] = s1[1];
  srow[8 * LDS + 8] = s1[2];
  srow[8 * LDS + 9] = s1[3];
}

// Online softmax over one BQ x BK logits tile of which the first `valid`
// keys are real: the `use_max` recurrence of the TPU kernels
// (_attend_kv_loop body_max).  Each warp owns ROWS_PER_WARP rows, lane owns
// keys `lane` and `lane + 32`.  p = exp(s - m) is rounded to bf16 into `ps`
// and the row sums add the rounded p; each row's rescale factor goes to
// alpha_s for the PV step.
__device__ __forceinline__ void online_softmax_tile(
    const float* ss, bf16* ps, float* alpha_s, float (&m_r)[ROWS_PER_WARP],
    float (&l_r)[ROWS_PER_WARP], int valid, int warp, int lane) {
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    const int row = warp * ROWS_PER_WARP + r;
    const float x0 = lane < valid ? ss[row * LDS + lane] : -INFINITY;
    const float x1 = lane + 32 < valid ? ss[row * LDS + lane + 32] : -INFINITY;
    const float m_new = fmaxf(m_r[r], warp_max(fmaxf(x0, x1)));
    const bf16 p0 = __float2bfloat16(expf(x0 - m_new));
    const bf16 p1 = __float2bfloat16(expf(x1 - m_new));
    ps[row * LDP + lane] = p0;
    ps[row * LDP + lane + 32] = p1;
    const float psum = warp_sum(__bfloat162float(p0) + __bfloat162float(p1));
    const float alpha = expf(m_r[r] - m_new);
    l_r[r] = l_r[r] * alpha + psum;
    m_r[r] = m_new;
    if (lane == 0) alpha_s[row] = alpha;
  }
}

// Tokens [t0, t0 + COLS) of the 64 rows [r0, r0 + 64) of one (band, head,
// batch) block (`pitch` = B * S elements between rows) into a 64 x ld panel
// of shared memory, element by element; tokens at or past S and rows at or
// past d are zero.
template <int COLS>
__device__ __forceinline__ void load_panel(bf16* dst, int ld, const bf16* __restrict__ src,
                                           int r0, int d, int t0, int S, size_t pitch,
                                           int tid) {
  for (int i = tid; i < D * COLS; i += THREADS) {
    const int r = i / COLS;
    const int c = i % COLS;
    dst[r * ld + c] = r0 + r < d && t0 + c < S ? src[(r0 + r) * pitch + t0 + c]
                                               : __float2bfloat16(0.0f);
  }
}

// q's 64 x BQ panel times `scale` in fp32, rounded to bf16, as the TPU
// kernels scale q.
__device__ __forceinline__ void scale_panel(bf16* qs, float scale, int tid) {
  for (int i = tid; i < D * (BQ / 2); i += THREADS) {
    __nv_bfloat162* p =
        reinterpret_cast<__nv_bfloat162*>(qs + (i / (BQ / 2)) * LQ) + (i % (BQ / 2));
    const float2 f = __bfloat1622float2(*p);
    *p = __floats2bfloat162_rn(f.x * scale, f.y * scale);
  }
}

// Panels are d-major: q is 64 rows of 32 tokens, k and v 64 rows of 64.
// ldmatrix.trans turns the d-major q and k panels into the row-major A and
// column-major B fragments of S = q k^T, and plain ldmatrix reads the d-major
// v panel as the column-major B fragment of O = p v.  NP = ceil(d / 64)
// panels: the logits of a key tile reduce over all of them (one q and one k
// panel in shared memory at a time; with one panel q is loaded once), and
// each warp keeps the accumulator of its d slice of every panel.  The output
// goes through shared memory (in q's panel).  37 KiB of static shared memory.
template <int NP>
__global__ void __launch_bounds__(THREADS)
flash_transposed_masked_kernel(const bf16* __restrict__ qkv_t, bf16* __restrict__ out_t,
                               int B, int S, int H, int d, float scale) {
  __shared__ __align__(128) bf16 qs[D * LQ];
  __shared__ __align__(128) bf16 ks[D * LK];
  __shared__ __align__(128) bf16 vs[D * LK];
  __shared__ __align__(128) float ss[BQ * LDS];
  __shared__ __align__(128) bf16 ps[BQ * LDP];
  __shared__ float alpha_s[BQ];
  __shared__ float l_s[BQ];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t pitch = (size_t)B * S;
  const size_t band = (size_t)H * d * pitch;
  const bf16* qh = qkv_t + (size_t)h * d * pitch + (size_t)b * S;
  const bf16* kh = qh + band;
  const bf16* vh = kh + band;
  bf16* oh = out_t + (size_t)h * d * pitch + (size_t)b * S;

  if constexpr (NP == 1) {  // q once, scaled by d^-0.5 in fp32, rounded to bf16
    load_panel<BQ>(qs, LQ, qh, 0, d, q0, S, pitch, tid);
    __syncthreads();
    scale_panel(qs, scale, tid);
  }

  // logits tile of this warp: rows 16 * wr, keys 16 * wc; accumulator: rows
  // 16 * wr, d rows DS * wc of every panel
  const int wr = warp >> 2;
  const int wc = warp & 3;
  float acc[NP][NT][4];
#pragma unroll
  for (int j = 0; j < NP; ++j)
#pragma unroll
    for (int n = 0; n < NT; ++n) acc[j][n][0] = acc[j][n][1] = acc[j][n][2] = acc[j][n][3] = 0.0f;
  float m_r[ROWS_PER_WARP];
  float l_r[ROWS_PER_WARP];
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    m_r[r] = -INFINITY;
    l_r[r] = 0.0f;
  }

  // ldmatrix row addresses; lane l feeds row l % 8 of 8x8 matrix m = l / 8.
  // q (A of q k^T, d-major, .trans): m = {d 0-7 | d 8-15} x {rows 0-7 | 8-15}
  // as a0..a3 want: rows step with m & 1, d with m >> 1.
  const bf16* a_q = qs + ((lane & 7) + ((lane >> 4) << 3)) * LQ + wr * 16 +
                    ((lane >> 3) & 1) * 8;
  // k (B of q k^T, d-major, .trans): b0, b1 of keys 0-7, then of keys 8-15
  const bf16* b_k = ks + ((lane & 7) + (((lane >> 3) & 1) << 3)) * LK + wc * 16 +
                    (lane >> 4) * 8;
  // p (A of p v, row-major)
  const bf16* a_p = ps + (wr * 16 + (lane & 15)) * LDP + (lane >> 4) * 8;
  // v (B of p v, d-major = column-major B, plain ldmatrix): b0, b1 of d 0-7,
  // then of d 8-15
  const bf16* b_v = vs + (wc * DS + (lane & 7) + ((lane >> 4) << 3)) * LK +
                    ((lane >> 3) & 1) * 8;

  for (int k0 = 0; k0 < S; k0 += BK) {
    float s0[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float s1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 1
    for (int j = 0; j < NP; ++j) {
      __syncthreads();  // the panels before, and the last tile's p and v, are consumed
      if constexpr (NP > 1) load_panel<BQ>(qs, LQ, qh, j * D, d, q0, S, pitch, tid);
      load_panel<BK>(ks, LK, kh, j * D, d, k0, S, pitch, tid);
      if constexpr (NP == 1) load_panel<BK>(vs, LK, vh, 0, d, k0, S, pitch, tid);
      __syncthreads();
      if constexpr (NP > 1) {
        scale_panel(qs, scale, tid);
        __syncthreads();
      }
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        uint32_t a[4], bb[4];
        ldmatrix_x4_trans(a, a_q + kk * LQ);
        ldmatrix_x4_trans(bb, b_k + kk * LK);
        mma_bf16(s0, a, bb[0], bb[1]);
        mma_bf16(s1, a, bb[2], bb[3]);
      }
    }
    store_logits(ss, s0, s1, wr, wc, g, t4);
    __syncthreads();

    online_softmax_tile(ss, ps, alpha_s, m_r, l_r, min(BK, S - k0), warp, lane);
    __syncthreads();

    const float a_lo = alpha_s[wr * 16 + g];
    const float a_hi = alpha_s[wr * 16 + g + 8];
#pragma unroll
    for (int j = 0; j < NP; ++j) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[j][n][0] *= a_lo;
        acc[j][n][1] *= a_lo;
        acc[j][n][2] *= a_hi;
        acc[j][n][3] *= a_hi;
      }
    }
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      if constexpr (NP > 1) {  // one panel: v came with k
        if (j > 0) __syncthreads();  // every warp is done with the panel before
        load_panel<BK>(vs, LK, vh, j * D, d, k0, S, pitch, tid);
        __syncthreads();
      }
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t a[4], bb[4];
        ldmatrix_x4(a, a_p + kk);
        ldmatrix_x4(bb, b_v + kk);
        mma_bf16(acc[j][0], a, bb[0], bb[1]);
        mma_bf16(acc[j][1], a, bb[2], bb[3]);
      }
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) l_s[warp * ROWS_PER_WARP + r] = l_r[r];
  }
  __syncthreads();  // every warp is also done reading qs: it takes the output
  const float l_lo = l_s[wr * 16 + g];
  const float l_hi = l_s[wr * 16 + g + 8];
  const int r_lo = wr * 16 + g;
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    if (j > 0) __syncthreads();  // the panel before is stored
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int r = wc * DS + n * 8 + 2 * t4;
      qs[r * LQ + r_lo] = __float2bfloat16(acc[j][n][0] / l_lo);
      qs[(r + 1) * LQ + r_lo] = __float2bfloat16(acc[j][n][1] / l_lo);
      qs[r * LQ + r_lo + 8] = __float2bfloat16(acc[j][n][2] / l_hi);
      qs[(r + 1) * LQ + r_lo + 8] = __float2bfloat16(acc[j][n][3] / l_hi);
    }
    __syncthreads();
    for (int i = tid; i < D * BQ; i += THREADS) {
      const int r = i / BQ;
      const int c = i % BQ;
      if (j * D + r < d && q0 + c < S) oh[(j * D + r) * pitch + q0 + c] = qs[r * LQ + c];
    }
  }
}

}  // namespace masked

}  // namespace

// qkv_t: (3 * H * d, B, S) bf16, 16-byte aligned; out_t: (H * d, B, S); d %
// 8 == 0, 8 <= d <= 512.  out = softmax(q k^T / sqrt(d)) v per (batch, head)
// in the transposed layout.
extern "C" int gswm_flash_transposed(const void* qkv_t, void* out_t, int B, int S, int H,
                                     int d, void* stream) {
  if (B < 1 || S < 1 || H < 1 || B > 65535 || H > 65535 || d < 8 || d % 8 || d > 512)
    return static_cast<int>(cudaErrorInvalidValue);
  const bf16* in = static_cast<const bf16*>(qkv_t);
  bf16* out = static_cast<bf16*>(out_t);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S % 8 == 0) return static_cast<int>(launch_tma(in, out, B, S, H, d, st));
  typedef void (*Masked)(const bf16*, bf16*, int, int, int, int, float);
  static const Masked by_panels[8] = {  // NP = ceil(d / 64) panels
      masked::flash_transposed_masked_kernel<1>, masked::flash_transposed_masked_kernel<2>,
      masked::flash_transposed_masked_kernel<3>, masked::flash_transposed_masked_kernel<4>,
      masked::flash_transposed_masked_kernel<5>, masked::flash_transposed_masked_kernel<6>,
      masked::flash_transposed_masked_kernel<7>, masked::flash_transposed_masked_kernel<8>};
  const dim3 grid((S + masked::BQ - 1) / masked::BQ, H, B);
  by_panels[(d + 63) / 64 - 1]<<<grid, masked::THREADS, 0, st>>>(in, out, B, S, H, d,
                                                                  1.0f / sqrtf((float)d));
  return static_cast<int>(cudaGetLastError());
}
