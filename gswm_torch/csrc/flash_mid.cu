// Flash attention at head dims 64 < d <= 160 for Hopper: wgmma, TMA and
// mbarriers.  q, out: (B, Sq, H, d); k, v: (B, Sk, H, d); bf16, d % 8 == 0,
// any Sq and Sk, a row pitch and a base pointer per operand.
//
// Replaces, at these widths (SD 1.x's 80 and 160), the TPU kernels that
// flash_split.cu's 128- and 192-wide templates served before:
//   * the attention core of gswm/ops/attention.py:689
//     flash_attention_fused_qkv (_fused_qkv_kernel, pallas_call :732; the
//     seqhead layout :775), after the projection GEMM of fused_qkv.cu: SD
//     1.x's level 1 (1024 tokens, 8 heads of 80) and level 2 (256 tokens, 8
//     heads of 160);
//   * gswm/ops/attention.py:414 flash_attention -> _flash_bhsd (:250,
//     pallas_calls :278, :307, :332), with and without the log-sum-exp output
//     (gswm_flash_split_lse: the ring's per-step kernel, ops/ring_attention.py).
//
// Semantics, flash_split.cu's: q scaled by the true d^-0.5 in fp32 and
// rounded to bf16, fp32 logits, an exact running row max, p = exp(s - m)
// rounded to bf16 for the p v product, fp32 row sums of the rounded p, an
// fp32 accumulator; keys at or past Sk are masked, rows at or past Sq are
// never written; with LSE each row's log-sum-exp goes to fp32 (B, H, Sq),
// masked past Sq by hand (hopper.cuh store_lse).
//
// What bounds it on an H100: per logit the tensor cores need 4 d FLOP (0.32
// ns at d = 80 at 989 TFLOP/s) and the SFUs one ex2 (0.26 ns at 3.865e12/s):
// at d = 80 the two roofs are close, at 160 the tensor cores bind.  The
// 128-wide template of flash_split.cu that ran d = 80 did 2.4x the
// tensor-core work the head needs (panels padded to 128 columns, the logits
// computed by both consumer warpgroups) and never ran the exponentials under
// a product.
//
// Design: flash_hopper.cu's narrow kernel (d <= 48) widened.
//   * One consumer warpgroup owns 64 query rows across the whole d: FULL
//     64-column panels of accumulator (32 registers a thread each) and a tail
//     of TAIL columns (TAIL / 2 registers): 40 registers at d = 80, 80 at 160.
//     Nothing is split across warpgroups and no logit is computed twice.
//   * hopper.cuh's one layout: 64-column panels of 128-byte swizzled rows,
//     tensor maps over the true d, zeros past d.  The logits take
//     4 FULL + TAIL / 16 = ceil(d / 16) k16 steps across the panels (5 at
//     d = 80, 10 at 160), each a DESC_K_STEP inside its panel; p v runs N = 64
//     on every full panel and N = TAIL (d mod 64, rounded up to 16) on the
//     last, reading the first TAIL columns of each swizzled v row in place:
//     no tensor-core work on padding wider than 15 columns.
//   * Tile t + 1's logits are issued together with tile t's p v, and tile
//     t + 1's exponentials run while both are on the tensor cores
//     (wgmma_wait<1> retires the logits, the older group); two consumer
//     warpgroups issue their products in turns on named barriers, so one's
//     softmax runs under the other's products; the row sums of the rounded p
//     are p times a column of ones on the tensor cores (wgmma m64n8k16).
//   * Keys a tile: 128 where a row is two panels and two warpgroups share
//     the block (k and v are 32 KB a tile each), else 64 (three panels: 24 KB;
//     q of two warpgroups takes 48 KB more).  Stages: as many as fit, at most
//     3.
//   * Warpgroups a block: two (128 query rows) where the grid then fills
//     7/8 of the SMs, else one (64 rows, 64-key tiles, two blocks an SM where
//     their shared memory fits: SD 1.x's level 2, 256 tokens, takes 64 blocks
//     of two warpgroups, 128 of one).
// Measured and not kept (PERF.md, section 6): three warpgroups at d = 80
// (160 registers a thread: 2.2x slower), 64-key tiles at two panels (11%
// slower).
// q is scaled in shared memory once it has landed (hopper.cuh scale_tile), as
// flash_split.cu does: d^-0.5 is no power of two at these widths.
//
// The same kernel serves the transposed layout at 64 < d <= 160 (K7,
// gswm/ops/attention.py:1428 flash_attention_transposed, pallas_call :1470;
// gswm_launch_flash_mid_transposed, which flash_transposed.cu's launcher
// calls at every S): one body, the layout a template parameter (hopper.cuh
// Layout; Layout::rows where S % 8 != 0: the boxes loaded and stored by hand
// by hopper.cuh's produce_rows and store_box_rows into and out of the same
// tiles, with 32 registers more for the producer and 32 (one warpgroup) or
// 16 (two) fewer for each consumer, and side buffers of 16 bytes a row after
// the ring, which can take a stage).  q, k and v are read in place as bands of
// the stacked (3 H d, B, S) projection output: panel j of a tile is rows
// 64 j ... of d (rows past d zero-filled by the tensor map), a 128-key tile
// two 64-token boxes a panel; the logits take the same ceil(d / 16) k16
// steps down the rows of MN-major q and k (one wgmma m64n64k16 a box and
// step, one commit group a tile), p v reads K-major v, N = 64 on full
// panels and the tail's first TAIL rows (no in-place read of partial
// swizzled rows arises), and each panel of the output goes transposed into
// the q tile and out by a 4-D TMA store.  Both layouts compute the same
// products in the same order: on the same q, k and v their outputs are equal
// bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_core.cuh"
#include "hopper.cuh"

namespace {

using namespace gswm_hopper;

constexpr int BM = 64;                 // query rows a consumer warpgroup
constexpr int SMEM_LIMIT = 232448;     // the 227 KB one block may opt into
constexpr int SMEM_HALF = 115712;      // each of two blocks on one SM's 228 KB
constexpr int MAX_STAGES = 3;
constexpr int TURN_BAR = 4;            // named barriers 4, 5: the turns (1, 2: each
                                       // warpgroup's own)
constexpr int ONES_ELEMS = 16 * ROW_ELEMS;  // the row sums' B operand: 16 rows of 1.0

template <int FULL, int TAIL, int NWG, bool ROWS = false>
struct Mid {
  static_assert(FULL >= 1 && TAIL % 16 == 0 && TAIL < ROW_ELEMS && FULL * 64 + TAIL <= 160,
                "FULL whole panels and a tail of TAIL < 64 columns, at most 160 in all");
  static constexpr int NP = FULL + (TAIL > 0);       // 64-column panels a row
  static constexpr int KS = 4 * FULL + TAIL / 16;    // k16 steps of the logits
  static_assert(NWG == 1 || NWG == 2, "one or two consumer warpgroups");
  static constexpr int BN = NWG == 2 && NP == 2 ? 128 : 64;  // keys a tile
  static constexpr int Q_PANEL = BM * ROW_ELEMS;     // elements
  static constexpr int KV_PANEL = BN * ROW_ELEMS;
  static constexpr int Q_BYTES = NP * Q_PANEL * (int)sizeof(bf16);   // a warpgroup's q
  static constexpr int KV_BYTES = NP * KV_PANEL * (int)sizeof(bf16);  // a k or v tile
  // boxes by hand (ROWS): the side buffers of q's boxes and of a k or v
  // tile's (hopper.cuh ROWS_SIDE), and 16 bytes to align them
  static constexpr int KV_BOXES = NP * (BN / ROW_ELEMS);  // of a k or v tile
  static constexpr int SIDE_Q = ROWS ? NWG * NP * ROWS_SIDE_BYTES + 16 : 0;
  static constexpr int SIDE_KV = ROWS ? KV_BOXES * ROWS_SIDE_BYTES : 0;
  // q, the ones, the barriers and the room to align, then the stages:
  // within half an SM for one warpgroup where two stages fit there
  static constexpr int FIXED = NWG * Q_BYTES + ONES_ELEMS * (int)sizeof(bf16) + 256 +
                               SWIZZLE_SPAN + SIDE_Q;
  static constexpr int STAGE_BYTES = 2 * (KV_BYTES + SIDE_KV);
  static constexpr int BUDGET =
      NWG == 1 && (SMEM_HALF - FIXED) / STAGE_BYTES >= 2 ? SMEM_HALF : SMEM_LIMIT;
  static constexpr int FIT = (BUDGET - FIXED) / STAGE_BYTES;
  static constexpr int STAGES = FIT > MAX_STAGES ? MAX_STAGES : FIT;
  static_assert(STAGES >= 2, "two stages of k and v must fit");
};

template <int FULL, int TAIL, int NWG, bool ROWS = false>
struct SmemMid {
  using M = Mid<FULL, TAIL, NWG, ROWS>;
  bf16 q[NWG][M::NP * M::Q_PANEL];  // scaled in place; later the output tile
  bf16 k[M::STAGES][M::NP * M::KV_PANEL];
  bf16 v[M::STAGES][M::NP * M::KV_PANEL];
  bf16 ones[ONES_ELEMS];
  uint64_t full_q;
  uint64_t full_k[M::STAGES];
  uint64_t full_v[M::STAGES];
  uint64_t empty_k[M::STAGES];  // every consumer warp has the logits of the stage's k
  uint64_t empty_v[M::STAGES];  // every consumer warp has added the stage's p v
};

// One k16 step of the logits, 64 rows by BN keys.
template <int BN>
__device__ __forceinline__ void logits_step(float (&s)[BN / 2], uint64_t dq, uint64_t dk,
                                            int accumulate) {
  if constexpr (BN == 128)
    wgmma_m64n128k16_ss(s, dq, dk, accumulate);
  else
    wgmma_m64n64k16_ss<0, 0>(s, dq, dk, accumulate);
}

// One k16 step of p v on the tail panel: the first N columns (TRANS_B = 1,
// MN-major v) or rows (0, K-major v) of v.
template <int N, int TRANS_B>
__device__ __forceinline__ void pv_tail(float (&o)[N / 2], const uint32_t (&a)[4],
                                        uint64_t dv) {
  if constexpr (N == 16)
    wgmma_m64n16k16_rs<TRANS_B>(o, a, dv);
  else if constexpr (N == 32)
    wgmma_m64n32k16_rs<TRANS_B>(o, a, dv);
  else
    wgmma_m64n48k16_rs<TRANS_B>(o, a, dv);
}

// Grid (query blocks of NWG * 64 rows, H, B).  q_scale = d^-0.5 of the true
// d; the exponent folds log2(e).  LSE: each row's log-sum-exp into lse
// (B, H, Sq) fp32; else lse and Sq are not read.  L (hopper.cuh Layout):
// natural, head_map's (B, S, H, d) maps; transposed, band_map's over
// flash_transposed.cu's stacked bands (Sq = Sk = S, no LSE), where panel j
// of a tile is rows 64 j ... of d, a 128-key tile two 64-token boxes a
// panel, the logits reduce down the rows of MN-major q and k (one wgmma a
// box and k16 step) and p v reads K-major v, the tail its first TAIL rows.
// The layout changes no arithmetic.
template <Layout L, int FULL, int TAIL, int NWG, bool LSE>
__global__ void __launch_bounds__((NWG + 1) * 128, NWG == 1 ? 2 : 1)
flash_mid_kernel(const __grid_constant__ Operand<L> map_q,
                 const __grid_constant__ Operand<L> map_k,
                 const __grid_constant__ Operand<L> map_v,
                 const __grid_constant__ Operand<L> map_o, int Sk, float q_scale,
                 float* lse, int Sq) {
  static_assert(L == Layout::natural || !LSE, "the transposed layout has no lse output");
  constexpr bool T = L != Layout::natural;  // transposed tiles, by TMA or by hand
  constexpr bool ROWS = L == Layout::rows;
  using M = Mid<FULL, TAIL, NWG, ROWS>;
  constexpr int NP = M::NP;
  constexpr int BN = M::BN;
  constexpr int STAGES = M::STAGES;
  constexpr int BOXES = T ? BN / ROW_ELEMS : 1;  // TMA boxes a panel of a k or v tile
  constexpr int BOX = M::KV_PANEL / BOXES;       // elements of one
  constexpr int VT = T ? 0 : 1;                  // v's transpose bit: K- or MN-major
  extern __shared__ unsigned char smem_raw[];
  SmemMid<FULL, TAIL, NWG, ROWS>& sm =
      *reinterpret_cast<SmemMid<FULL, TAIL, NWG, ROWS>*>(align_smem(smem_raw));

  const int group = threadIdx.x >> 7;  // 0: producer, 1..NWG: consumers
  const int row0 = blockIdx.x * (NWG * BM);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tiles = (Sk + BN - 1) / BN;

  if (threadIdx.x == 0) {  // by hand, each producer thread arrives on a full barrier
    mbar_init(&sm.full_q, ROWS ? 128 : 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full_k[s], ROWS ? 128 : 1);
      mbar_init(&sm.full_v[s], ROWS ? 128 : 1);
      mbar_init(&sm.empty_k[s], NWG * 4);
      mbar_init(&sm.empty_v[s], NWG * 4);
    }
    fence_mbar_init();
  }
  {  // the ones, by every thread, seen by wgmma after the barrier
    uint4* ones = reinterpret_cast<uint4*>(sm.ones);
    const uint4 one8 = {0x3f803f80u, 0x3f803f80u, 0x3f803f80u, 0x3f803f80u};
    for (int i = threadIdx.x; i < ONES_ELEMS / 8; i += (NWG + 1) * 128) ones[i] = one8;
    fence_async_smem();
  }
  __syncthreads();

  if (group == 0) {
    reg_dec<ROWS ? ROWS_PRODUCER_REGS<NWG> : NWG == 2 ? 40 : 24>();
    if constexpr (ROWS) {  // the warpgroup's 128 threads (hopper.cuh produce_rows)
      constexpr int NQ = NWG * NP, NKV = M::KV_BOXES;
      unsigned char* room = reinterpret_cast<unsigned char*>(&sm) + (sizeof(sm) + 15) / 16 * 16;
      // box i of tile t's k (kv = 0) or v (1): panel i / BOXES, its box i % BOXES
      auto kv_box = [&](int kv) {
        return [=, &sm](int t, int i) {
          return RowsBox{(kv ? sm.v[t % STAGES] : sm.k[t % STAGES]) +
                             (i / BOXES) * M::KV_PANEL + (i % BOXES) * BOX,
                         rows_side<NQ, NKV>(room, t % STAGES, kv, i), h,
                         (i / BOXES) * ROW_ELEMS, t * BN + (i % BOXES) * ROW_ELEMS};
        };
      };
      produce_rows<NQ, NKV, STAGES>(
          map_q, map_k, map_v, b, tiles,
          [&](int i) {  // warpgroup i / NP's q, panel i % NP
            return RowsBox{sm.q[i / NP] + (i % NP) * M::Q_PANEL, room + i * ROWS_SIDE_BYTES, h,
                           (i % NP) * ROW_ELEMS, row0 + (i / NP) * BM};
          },
          kv_box(0), kv_box(1),
          [&](int t) { mbar_wait(&sm.empty_k[t % STAGES], ((t / STAGES) & 1) ^ 1); },
          [&](int t) { mbar_wait(&sm.empty_v[t % STAGES], ((t / STAGES) & 1) ^ 1); },
          &sm.full_q, sm.full_k, sm.full_v);
    } else if (threadIdx.x == 0) {
      mbar_expect_tx(&sm.full_q, NWG * M::Q_BYTES);
      for (int w = 0; w < NWG; ++w)
        for (int j = 0; j < NP; ++j)
          tma_load_panel<L>(sm.q[w] + j * M::Q_PANEL, &map_q, &sm.full_q, j, h,
                            row0 + w * BM, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int t = 0; t < tiles; ++t) {
        mbar_wait(&sm.empty_k[stage], phase ^ 1);
        mbar_expect_tx(&sm.full_k[stage], M::KV_BYTES);
        for (int j = 0; j < NP; ++j)
          for (int i = 0; i < BOXES; ++i)
            tma_load_panel<L>(sm.k[stage] + j * M::KV_PANEL + i * BOX, &map_k,
                              &sm.full_k[stage], j, h, t * BN + i * ROW_ELEMS, b);
        mbar_wait(&sm.empty_v[stage], phase ^ 1);
        mbar_expect_tx(&sm.full_v[stage], M::KV_BYTES);
        for (int j = 0; j < NP; ++j)
          for (int i = 0; i < BOXES; ++i)
            tma_load_panel<L>(sm.v[stage] + j * M::KV_PANEL + i * BOX, &map_v,
                              &sm.full_v[stage], j, h, t * BN + i * ROW_ELEMS, b);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }
  reg_inc<ROWS ? ROWS_CONSUMER_REGS<NWG> : 232>();
  const int cw = group - 1;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const float exp_scale = 1.4426950408889634f;

  // rows 16 * warp + g (lo) and + 8 (hi): the full panels' columns, the
  // tail's, and the row sums of the rounded p (l[0], l[1] the lo row's, l[2],
  // l[3] the hi's)
  float o[FULL][32];
  float ot[TAIL > 0 ? TAIL / 2 : 4];
  float l[4];
#pragma unroll
  for (int j = 0; j < FULL; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[j][i] = 0.0f;
#pragma unroll
  for (int i = 0; i < (TAIL > 0 ? TAIL / 2 : 4); ++i) ot[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) l[i] = 0.0f;
  float s[BN / 2];
  uint32_t p[BN / 16][4];
  float m_lo = -INFINITY, m_hi = -INFINITY;  // running max of the raw logits
  float a_lo, a_hi;

  bf16* qt = sm.q[cw];
  const uint64_t dq = smem_desc_sw128(qt);
  const uint64_t d1 = smem_desc_sw128(sm.ones);
  wait_full<ROWS>(&sm.full_q, 0);
  scale_tile(qt, NP * M::Q_PANEL, q_scale, threadIdx.x & 127, 128);
  fence_async_smem();
  named_barrier(1 + cw, 128);

  // a panel's offset in a descriptor's start address (16-byte units)
  constexpr int Q_PANEL_DESC = M::Q_PANEL * (int)sizeof(bf16) >> 4;
  constexpr int KV_PANEL_DESC = M::KV_PANEL * (int)sizeof(bf16) >> 4;
  constexpr int BOX_DESC = BOX * (int)sizeof(bf16) >> 4;
  // the logits of a tile, one commit group (the transposed layout's two
  // boxes too: wgmma_wait counts groups)
  auto logits = [&](int stage) {
    const uint64_t dk = smem_desc_sw128(sm.k[stage]);
#pragma unroll
    for (int kk = 0; kk < M::KS; ++kk) {  // panel kk / 4, its step kk % 4
      if constexpr (T) {  // 16 rows of d a step; box i's keys into s[32 i ...]
#pragma unroll
        for (int i = 0; i < BOXES; ++i)
          wgmma_m64n64k16_ss<1, 1>(
              *reinterpret_cast<float(*)[32]>(&s[32 * i]),
              dq + (kk / 4) * Q_PANEL_DESC + (kk % 4) * DESC_MN_STEP,
              dk + (kk / 4) * KV_PANEL_DESC + i * BOX_DESC + (kk % 4) * DESC_MN_STEP, kk > 0);
      } else {
        logits_step<BN>(s, dq + (kk / 4) * Q_PANEL_DESC + (kk % 4) * DESC_K_STEP,
                        dk + (kk / 4) * KV_PANEL_DESC + (kk % 4) * DESC_K_STEP, kk > 0);
      }
    }
    wgmma_commit();
  };
  // panel j's B operand of p v at key step kk: 16 keys down the rows of an
  // MN-major panel (natural), along the rows of box kk / 4 of a K-major one
  // (transposed)
  auto v_step = [&](uint64_t dv, int j, int kk) -> uint64_t {
    if constexpr (T)
      return dv + j * KV_PANEL_DESC + (kk / 4) * BOX_DESC + (kk % 4) * DESC_K_STEP;
    else
      return dv + j * KV_PANEL_DESC + kk * DESC_MN_STEP;
  };
  // p v on every panel, and p times a column of ones: the fp32 row sums of
  // the rounded p
  auto pv = [&](int stage) {
    const uint64_t dv = smem_desc_sw128(sm.v[stage]);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < FULL; ++j) wgmma_m64n64k16_rs<VT>(o[j], p[kk], v_step(dv, j, kk));
      if constexpr (TAIL > 0) pv_tail<TAIL, VT>(ot, p[kk], v_step(dv, FULL, kk));
      wgmma_m64n8k16_rs(l, p[kk], d1);
    }
    wgmma_commit();
  };
  auto fence_acc = [&] {
#pragma unroll
    for (int j = 0; j < FULL; ++j) fence_regs(o[j]);
    if constexpr (TAIL > 0) fence_regs(ot);
    fence_regs(l);
  };
  auto rescale = [&] {
#pragma unroll
    for (int j = 0; j < FULL; ++j) scale_rows(o[j], a_lo, a_hi);
    if constexpr (TAIL > 0) scale_rows(ot, a_lo, a_hi);
    scale_rows(l, a_lo, a_hi);
  };
  // this warpgroup's turn to issue its products, and the next one's after it
  constexpr bool TURNS = NWG > 1;
  auto my_turn = [&] {
    if constexpr (TURNS) named_barrier(TURN_BAR + cw, 2 * 128);
  };
  auto next_turn = [&] {
    if constexpr (TURNS) named_barrier_arrive(TURN_BAR + (cw + 1) % NWG, 2 * 128);
  };
  if (TURNS && cw == NWG - 1) named_barrier_arrive(TURN_BAR, 2 * 128);  // 0 goes first

  // tile 0's logits and softmax (the accumulators are still zero: no rescale)
  wait_full<ROWS>(&sm.full_k[0], 0);
  my_turn();
  wgmma_fence();
  logits(0);
  next_turn();
  wgmma_wait<0>();
  fence_regs(s);
  if (lane == 0) mbar_arrive(&sm.empty_k[0]);
  softmax_exp<BN / 8>(s, m_lo, m_hi, a_lo, a_hi, Sk, exp_scale, t4);
  softmax_pack<BN / 8>(s, p);

  // tiles 0 .. tiles - 2: tile t + 1's logits and tile t's p v in flight
  // together, tile t + 1's exponentials under both (no product is issued
  // under a condition: ptxas serializes wgmma it cannot prove retired before
  // its accumulator is read)
  int stage = 0;  // tile t's
  uint32_t phase = 0;
  for (int t = 0; t + 1 < tiles; ++t) {
    const int next = stage + 1 == STAGES ? 0 : stage + 1;
    const uint32_t next_phase = next == 0 ? phase ^ 1 : phase;
    wait_full<ROWS>(&sm.full_k[next], next_phase);
    wait_full<ROWS>(&sm.full_v[stage], phase);
    my_turn();
    wgmma_fence();
    logits(next);
    pv(stage);
    next_turn();
    wgmma_wait<1>();  // the logits, the older group; p v still runs
    fence_regs(s);
    if (lane == 0) mbar_arrive(&sm.empty_k[next]);
    softmax_exp<BN / 8>(s, m_lo, m_hi, a_lo, a_hi, Sk - (t + 1) * BN, exp_scale, t4);
    wgmma_wait<0>();
    fence_acc();
    fence_regs(p);
    if (lane == 0) mbar_arrive(&sm.empty_v[stage]);
    rescale();
    softmax_pack<BN / 8>(s, p);
    stage = next;
    phase = next_phase;
  }
  // the last tile's p v
  wait_full<ROWS>(&sm.full_v[stage], phase);
  my_turn();
  wgmma_fence();
  pv(stage);
  next_turn();
  wgmma_wait<0>();
  fence_acc();
  // the last warpgroup's last turn is over: its final arrival is taken
  if (TURNS && cw == 0) named_barrier(TURN_BAR, 2 * 128);

  // normalised and rounded, through the warpgroup's own q tile (transposed:
  // rows of d, 64 tokens); the tail panel's columns (rows) past TAIL keep q
  // and are dropped by the store with the rest past d
  const float inv_lo = 1.0f / l[0];
  const float inv_hi = 1.0f / l[2];
#pragma unroll
  for (int j = 0; j < FULL; ++j)
    store_tile_out<L>(qt + j * M::Q_PANEL, o[j], inv_lo, inv_hi, warp, g, t4);
  if constexpr (TAIL > 0)
    store_tile_out<L>(qt + FULL * M::Q_PANEL, ot, inv_lo, inv_hi, warp, g, t4);
  if constexpr (LSE)  // l[0], l[2]: the tensor cores' whole-row sums
    store_lse(lse, Sq, row0 + cw * BM + warp * 16 + g, m_lo, m_hi, l[0], l[2], exp_scale,
              t4);
  fence_async_smem();
  named_barrier(1 + cw, 128);
  if constexpr (ROWS) {  // by hand: every thread of the warpgroup
#pragma unroll
    for (int j = 0; j < NP; ++j)
      tma_store_panel<L>(&map_o, qt + j * M::Q_PANEL, j, h, row0 + cw * BM, b);
  } else if ((threadIdx.x & 127) == 0) {
#pragma unroll
    for (int j = 0; j < NP; ++j)
      tma_store_panel<L>(&map_o, qt + j * M::Q_PANEL, j, h, row0 + cw * BM, b);
    tma_store_wait();
  }
}

// The operands: natural, a base pointer and a row pitch each (ld_*); the
// transposed layout's q, k and v are the three bands of the stacked
// projection output, out its (H d, B, S) output, and the pitches unused.
struct Args {
  const bf16 *q, *k, *v;
  bf16* out;
  int B, Sq, Sk, H, d, ld_q, ld_kv, ld_o;
  float* lse;  // nullptr: the kernels without its store
  cudaStream_t stream;
};

template <Layout L, int FULL, int TAIL, int NWG, bool LSE>
cudaError_t start(const Args& a) {
  constexpr bool ROWS = L == Layout::rows;
  using M = Mid<FULL, TAIL, NWG, ROWS>;
  constexpr int smem = (int)sizeof(SmemMid<FULL, TAIL, NWG, ROWS>) + SWIZZLE_SPAN +
                       M::SIDE_Q + M::STAGES * 2 * M::SIDE_KV;
  static_assert(smem <= M::BUDGET, "above the shared memory the block was sized for");
  Operand<L> mq, mk, mv, mo;
  cudaError_t e = cudaSuccess;
  if constexpr (L == Layout::natural) {
    e = head_map(&mq, a.q, a.B, a.Sq, a.H, a.d, a.ld_q, BM);
    if (e == cudaSuccess) e = head_map(&mk, a.k, a.B, a.Sk, a.H, a.d, a.ld_kv, M::BN);
    if (e == cudaSuccess) e = head_map(&mv, a.v, a.B, a.Sk, a.H, a.d, a.ld_kv, M::BN);
    if (e == cudaSuccess) e = head_map(&mo, a.out, a.B, a.Sq, a.H, a.d, a.ld_o, BM);
  } else if constexpr (L == Layout::rows) {  // the bands addressed by hand
    mq = BandRows{const_cast<bf16*>(a.q), a.B, a.Sq, a.d};
    mk = BandRows{const_cast<bf16*>(a.k), a.B, a.Sk, a.d};
    mv = BandRows{const_cast<bf16*>(a.v), a.B, a.Sk, a.d};
    mo = BandRows{a.out, a.B, a.Sq, a.d};
  } else {
    e = band_map(&mq, a.q, a.H, a.d, a.B, a.Sq);
    if (e == cudaSuccess) e = band_map(&mk, a.k, a.H, a.d, a.B, a.Sk);
    if (e == cudaSuccess) e = band_map(&mv, a.v, a.H, a.d, a.B, a.Sk);
    if (e == cudaSuccess) e = band_map(&mo, a.out, a.H, a.d, a.B, a.Sq);
  }
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(flash_mid_kernel<L, FULL, TAIL, NWG, LSE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.Sq + NWG * BM - 1) / (NWG * BM), a.H, a.B);
  flash_mid_kernel<L, FULL, TAIL, NWG, LSE><<<grid, (NWG + 1) * 128, smem, a.stream>>>(
      mq, mk, mv, mo, a.Sk, 1.0f / sqrtf((float)a.d), a.lse, a.Sq);
  return cudaGetLastError();
}

template <Layout L, int FULL, int TAIL, int NWG>
cudaError_t start_any(const Args& a) {
  if constexpr (L != Layout::natural)
    return start<L, FULL, TAIL, NWG, false>(a);
  else
    return a.lse ? start<L, FULL, TAIL, NWG, true>(a) : start<L, FULL, TAIL, NWG, false>(a);
}

template <Layout L, int FULL, int TAIL>
cudaError_t launch(const Args& a, bool wide) {
  return wide ? start_any<L, FULL, TAIL, 2>(a) : start_any<L, FULL, TAIL, 1>(a);
}

template <Layout L>
cudaError_t dispatch(const Args& a) {
  // two warpgroups (128 rows) a block where the grid then fills 7/8 of this
  // card's SMs
  int sm_count = 0;
  const cudaError_t e = multiprocessors(&sm_count);
  if (e != cudaSuccess) return e;
  const bool wide = 8L * ((a.Sq + 2 * BM - 1) / (2 * BM)) * a.H * a.B >= 7L * sm_count;
  // whole panels, and the last panel's columns rounded up to 16 (a last
  // panel of 64 is a whole one)
  const int d = a.d;
  const int last = d - ROW_ELEMS * ((d - 1) / ROW_ELEMS);
  const int tail = (last + 15) / 16 * 16 % ROW_ELEMS;
  const int full = (d - 1) / ROW_ELEMS + (tail == 0);
  switch (full * 100 + tail) {
    case 116: return launch<L, 1, 16>(a, wide);  // d = 72, 80
    case 132: return launch<L, 1, 32>(a, wide);  // 88, 96
    case 148: return launch<L, 1, 48>(a, wide);  // 104, 112
    case 200: return launch<L, 2, 0>(a, wide);   // 120, 128
    case 216: return launch<L, 2, 16>(a, wide);  // 136, 144
    case 232: return launch<L, 2, 32>(a, wide);  // 152, 160
    default: return cudaErrorInvalidValue;
  }
}

bool takes(int B, int Sq, int Sk, int H, int d) {
  return B >= 1 && Sq >= 1 && Sk >= 1 && H >= 1 && B <= 65535 && H <= 65535 && d % 8 == 0 &&
         d > ROW_ELEMS && d <= 160;
}

}  // namespace

cudaError_t gswm_launch_flash_mid(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                                  int B, int Sq, int Sk, int H, int d, int ld_q, int ld_kv,
                                  int ld_o, cudaStream_t stream, float* lse) {
  if (!takes(B, Sq, Sk, H, d)) return cudaErrorInvalidValue;
  return dispatch<Layout::natural>(
      Args{q, k, v, out, B, Sq, Sk, H, d, ld_q, ld_kv, ld_o, lse, stream});
}

cudaError_t gswm_launch_flash_mid_transposed(const bf16* qkv_t, bf16* out_t, int B, int S,
                                             int H, int d, bool rows, cudaStream_t stream) {
  if (!takes(B, S, S, H, d) || (!rows && S % 8)) return cudaErrorInvalidValue;
  const size_t band = (size_t)H * d * B * S;  // elements: q's rows, then k's, then v's
  const Args a{qkv_t, qkv_t + band, qkv_t + 2 * band, out_t, B, S, S, H, d, 0, 0, 0, nullptr,
               stream};
  return rows ? dispatch<Layout::rows>(a) : dispatch<Layout::transposed>(a);
}
