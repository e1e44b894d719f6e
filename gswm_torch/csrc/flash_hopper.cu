// Flash attention at head dims up to 64 for Hopper: wgmma, TMA and mbarriers.
// q, out: (B, Sq, H, d); k, v: (B, Sk, H, d); bf16, d % 8 == 0, 8 <= d <= 64,
// any Sq and Sk, a row pitch and a base pointer per operand.  The kernel
// computes on one 64-column panel a head: its tensor maps are over the true
// d (hopper.cuh head_map), so columns d ... 63 arrive as zeros and the
// store drops them.
//
// Replaces, at d <= 64, every TPU kernel the split kernel of flash_split.cu
// served there:
//   * gswm/ops/attention.py:1211 flash_attention_cres (_flash_kernel_cres)
//     and the default xla_flash_attention (:1540): the UNet's level-0
//     self-attention, 4096 tokens at 512x512 and 9216 at 768x768, 5 heads of
//     64 (SD 2.x), 8 heads of 40 (SD 1.x) (ops.attention.flash_attention,
//     gswm_flash_split);
//   * the attention core of gswm/ops/attention.py:689
//     flash_attention_fused_qkv (_fused_qkv_kernel, _attend_kv_loop), after
//     the projection GEMM of fused_qkv.cu;
//   * gswm/ops/attention.py:414 flash_attention (_flash_bhsd) at d <= 64;
//   * gswm/ops/attention.py:959 flash_attention_packed (_flash_kernel_pair,
//     _pair_kvres, _pair_streamk): q, k and v are three strided
//     (B, S, 2P, 64) views of one (B, S, 3 * P * 128) array, so
//     gswm_flash_packed passes a row pitch of 3 * P * 128 and three base
//     pointers.  A zero pad head (odd head counts) has zero logits and zero
//     v, so its output is exactly zero.
//
// Semantics, unchanged: the `use_max` recurrence of the TPU kernels
// (_attend_kv_loop): q scaled by D^-0.5 in fp32 and rounded to bf16, fp32
// logits, an exact running row max, p = exp(s - m) rounded to bf16 for the
// PV product, fp32 row sums of the rounded p, an fp32 accumulator; keys at
// or past Sk are masked, rows at or past Sq are never written.  At d = 64
// the scale is 2^-3: scaling q and rounding to bf16 is exact, and so is
// scaling the fp32 logits instead, which is what the kernel does, folded
// with log2(e) into the exponent's one multiply-add (p = exp2(s * c - m * c),
// the reference's GSWM_ATTN_EXP2 reparametrisation).  At any other d, d^-0.5
// is no power of two (d = 40: 0.158...): each consumer scales its q tile in
// shared memory once it has landed (fp32 multiply, rounded to bf16, as
// xla_flash_attention and flash_split.cu do) and the exponent folds log2(e)
// alone.  That pass is a template switch, so the d = 64 kernel is what it
// was.
//
// What bounds it on an H100: (B, S, H) = (2, 9216, 5) is 4 * B * H * S^2 *
// 64 = 217 GFLOP over 47 MB of q, k, v and out, ~4,600 FLOP a byte: the
// tensor cores bound it (0.22 ms at 989 TFLOP/s), and B * H * S^2
// exponentials at 16 a clock an SM take about as long again.  The kernel
// before this one (mma.sync on 16 x 16 logits tiles, logits and p through
// shared memory, five __syncthreads a tile) reached 8% of that bound.
//
// Design.  A block is one producer warpgroup, of which one thread works, and
// NWG consumer warpgroups of 64 query rows each: NWG = 2 (128 rows a block)
// where that gives every SM of the card a block (132 on an H100 SXM, read
// from the device), else NWG = 1.
//   * The producer loads the q tiles once and walks 128-key tiles of k and
//     v through a ring of STAGES stages by TMA: 4-D tensor maps (64, H, S,
//     B), so a tile never crosses into the next batch and rows past S arrive
//     as zeros; rows are exactly 128 bytes, stored under the 128-byte
//     swizzle.  k and v of a stage complete on separate mbarriers, so the
//     logits of a tile do not wait for its v.
//   * S = q k^T: four wgmma m64n128k16 per tile, q and k from shared memory
//     (both K-major), the 64 x 128 fp32 logits in registers.
//   * The online softmax runs on that fragment: a thread holds two rows'
//     columns of each 8-column group, so row max and row sum are two
//     shuffles inside the quad, and the running sum stays per thread until
//     the end.  No logits, p or rescale factor touches shared memory.
//   * O += p v: p rounded to bf16 is already wgmma's register A fragment;
//     eight wgmma m64n64k16 per tile with v from shared memory as the
//     MN-major B operand (v is (keys, 64): the reduction runs down the rows).
//   * The output goes, normalised and rounded, through the warpgroup's own q
//     tile and one TMA store, which drops rows at or past Sq.
// setmaxnreg hands the producer's registers to the consumers (64 logits +
// 32 accumulator + 32 p registers a thread).  This kernel serves 48 < d <= 64:
// at d = 64 the tensor cores and the exponentials are equal roofs.
//
// Narrow heads, d <= 48 (SD 1.x's 40): flash_narrow_kernel.  There the
// exponentials are the higher roof: per logit the tensor cores need 4 * d
// FLOP at 989 TFLOP/s, the SFUs one ex2 at 16 a clock an SM (132 x 16 x
// 1.83 GHz = 3.865e12/s), equal at d = 64, so at d = 40 the exponentials
// take 1.6x the tensor cores' time.  The kernel above waits for its logits
// before each softmax and for its p v before the next tile, so a
// warpgroup's exponentials never overlap its own products.  The narrow
// kernel, same producer, tiles and maps:
//   * issues tile t + 1's logits (q k^T) and tile t's p v together, then
//     runs tile t + 1's exponentials while both are on the tensor cores
//     (wgmma_wait<1> retires the logits, the older group); the exponentials
//     are taken in place in fp32 and rounded into p only after p v of tile
//     t is retired, and the accumulator takes tile t + 1's rescale then;
//   * three consumer warpgroups (192 query rows a block, 160 registers a
//     thread) issue their products in turns, on named barriers: a
//     warpgroup's softmax runs while the others' products do;
//   * the row sums of the rounded p are p times a column of ones on the
//     tensor cores (wgmma m64n8k16 against a ones tile written once), not
//     two integer and one fp32 instruction a logit in the softmax;
//   * ceil(d / 16) k16 steps of logits (3 at d = 40; columns 40-47 arrive
//     as zeros) and p v at N = 48: wgmma reads the first 48 columns of each
//     128-byte swizzled v row in place (3% faster than N = 64);
//   * 3 stages, separate empty barriers for k and v.
// Measured and not kept (PERF.md, section 6): a fourth and fifth stage (no
// change), two warpgroups (14% slower), the consumers not taking turns
// (11% slower), a quarter of the exponentials on the FMA units by a degree-5
// polynomial (no change: the SFUs are not what binds), row sums in the
// softmax (11% slower), a tree for the row max (its array went to local
// memory: 2x slower).
// Its output differs from the kernel above's in the row sums' summation
// order alone.
//
// The narrow kernel also serves the transposed layout at d <= 48 (K7,
// gswm/ops/attention.py:1428 flash_attention_transposed, pallas_call :1470;
// gswm_launch_flash_narrow_transposed, which flash_transposed.cu's launcher
// calls at every S): one body, the layout a template parameter (hopper.cuh
// Layout; Layout::rows where S % 8 != 0, the boxes loaded and stored by hand
// into and out of the same tiles), so both layouts get the overlap, the turns, the row
// sums on the tensor cores and p v at N = 48.  There q, k and v are read in
// place as bands of the stacked (3 H d, B, S) projection output: a head is
// one 64-row panel of d (rows past d zero-filled by the tensor map), a
// 128-key tile two 64-token boxes side by side; the logits reduce down the
// rows of MN-major q and k (ceil(d / 16) k16 steps, one wgmma m64n64k16 a
// box and step, one commit group a tile), p v reads the first 48 rows of
// each K-major v box, and the output goes transposed into the q tile and
// out by one 4-D TMA store.  Both layouts compute the same products in the
// same order: on the same q, k and v their outputs are equal bit for bit.
//
// Both kernels take an LSE template flag (gswm_flash_split_lse, the ring's
// per-step kernel): after the output tile, each row's log-sum-exp of the
// true logits goes to an fp32 (B, H, Sq) array (hopper.cuh store_lse; c the
// exponent's scale, 2^-3 log2(e) at d = 64, else log2(e)).  Off, the kernels
// compile as they did.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_core.cuh"
#include "hopper.cuh"

namespace {

using namespace gswm_hopper;

constexpr int D = 64;      // the panel: one head of d <= 64 columns, zero-padded
constexpr int BM = 64;    // query rows per consumer warpgroup
constexpr int BN = 128;   // keys per tile
constexpr int STAGES = 2;
constexpr int Q_BYTES = BM * D * (int)sizeof(bf16);
constexpr int KV_BYTES = BN * D * (int)sizeof(bf16);
static_assert(D == ROW_ELEMS, "one head row is one 128-byte swizzled row");

template <int NWG>
struct Smem {
  bf16 q[NWG][BM * D];  // later the output tile
  bf16 k[STAGES][BN * D];
  bf16 v[STAGES][BN * D];
  uint64_t full_q;
  uint64_t full_k[STAGES];
  uint64_t full_v[STAGES];
  uint64_t empty[STAGES];  // every consumer warp is done with the stage's k and v
};

// Grid (query blocks, H, B).  SCALE_Q: q is scaled by q_scale = d^-0.5 in
// shared memory and exp_scale = log2(e); else (d = 64) exp_scale = 2^-3 *
// log2(e) and q_scale is not read.  LSE: each row's log-sum-exp of the true
// logits goes to lse (B, H, Sq) fp32 (hopper.cuh store_lse); else lse and Sq
// are not read.
template <int NWG, bool SCALE_Q, bool LSE>
__global__ void __launch_bounds__((NWG + 1) * 128, NWG == 1 ? 2 : 1)
flash_hopper_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_o, int Sk, float exp_scale,
                    float q_scale, float* lse, int Sq) {
  extern __shared__ unsigned char smem_raw[];
  Smem<NWG>& sm = *reinterpret_cast<Smem<NWG>*>(align_smem(smem_raw));

  const int group = threadIdx.x >> 7;  // 0: producer, 1..NWG: consumers
  const int row0 = blockIdx.x * (NWG * BM);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tiles = (Sk + BN - 1) / BN;

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
      mbar_expect_tx(&sm.full_q, NWG * Q_BYTES);
      for (int w = 0; w < NWG; ++w)
        tma_load_4d(sm.q[w], &map_q, &sm.full_q, 0, h, row0 + w * BM, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int t = 0; t < tiles; ++t) {
        mbar_wait(&sm.empty[stage], phase ^ 1);
        mbar_expect_tx(&sm.full_k[stage], KV_BYTES);
        tma_load_4d(sm.k[stage], &map_k, &sm.full_k[stage], 0, h, t * BN, b);
        mbar_expect_tx(&sm.full_v[stage], KV_BYTES);
        tma_load_4d(sm.v[stage], &map_v, &sm.full_v[stage], 0, h, t * BN, b);
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

    // rows 16 * warp + g (lo) and + 8 (hi) of this warpgroup's 64
    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.0f;
    float s[64];
    float m_lo = -INFINITY, m_hi = -INFINITY;  // running max of the raw logits
    float l_lo = 0.0f, l_hi = 0.0f;            // this thread's share of the row sums

    const uint64_t dq = smem_desc_sw128(sm.q[cw]);
    mbar_wait(&sm.full_q, 0);
    if constexpr (SCALE_Q) {  // this warpgroup's own q tile
      scale_tile(sm.q[cw], BM * D, q_scale, threadIdx.x & 127, 128);
      fence_async_smem();
      named_barrier(1 + cw, 128);
    }

    int stage = 0;
    uint32_t phase = 0;
    for (int t = 0; t < tiles; ++t) {
      mbar_wait(&sm.full_k[stage], phase);
      const uint64_t dk = smem_desc_sw128(sm.k[stage]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_m64n128k16_ss(s, dq + kk * DESC_K_STEP, dk + kk * DESC_K_STEP, kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      // p rounded to bf16, in wgmma's A layout; keys past Sk masked
      uint32_t p[BN / 16][4];
      float a_lo, a_hi;
      softmax_tile<BN / 8>(s, p, m_lo, m_hi, l_lo, l_hi, a_lo, a_hi, Sk - t * BN, exp_scale,
                           t4);
      scale_rows(o, a_lo, a_hi);

      mbar_wait(&sm.full_v[stage], phase);
      const uint64_t dv = smem_desc_sw128(sm.v[stage]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_m64n64k16_rs(o, p[kk], dv + kk * DESC_MN_STEP);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(&sm.empty[stage]);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

    // normalised and rounded, through the warpgroup's own q tile
    bf16* tile = sm.q[cw];
    const float sum_lo = quad_sum(l_lo);
    const float sum_hi = quad_sum(l_hi);
    store_tile_sw128(tile, o, 1.0f / sum_lo, 1.0f / sum_hi, warp, g, t4);
    if constexpr (LSE)
      store_lse(lse, Sq, row0 + cw * BM + warp * 16 + g, m_lo, m_hi, sum_lo, sum_hi,
                exp_scale, t4);
    fence_async_smem();
    named_barrier(1 + cw, 128);
    if ((threadIdx.x & 127) == 0) {
      tma_store_4d(&map_o, tile, 0, h, row0 + cw * BM, b);
      tma_store_wait();
    }
  }
}

// ------------------------------------------------- narrow heads, d <= 48 ----

constexpr int NARROW_D = 48;   // the widest head the narrow kernel takes; its p v's N
constexpr int NARROW_WGS = 3;  // consumer warpgroups where the grid fills the card
constexpr int TURN_BAR = 4;    // named barriers 4 .. 4 + NARROW_WGS - 1: the turns

template <int NWG>
struct SmemNarrow {
  static constexpr int STAGES = NWG == 1 ? 2 : 3;  // one consumer: two blocks an SM
  bf16 q[NWG][BM * D];  // later the output tile
  bf16 k[STAGES][BN * D];
  bf16 v[STAGES][BN * D];
  bf16 ones[BN * D];    // the row sums' B operand: 1.0 everywhere
  uint64_t full_q;
  uint64_t full_k[STAGES];
  uint64_t full_v[STAGES];
  uint64_t empty_k[STAGES];  // every consumer warp has the logits of the stage's k
  uint64_t empty_v[STAGES];  // every consumer warp has added the stage's p v
};

// Grid (query blocks, H, B); KS = ceil(d / 16) k16 steps of logits.  q is
// scaled by q_scale = d^-0.5 in shared memory; the exponent folds log2(e).
// LSE as flash_hopper_kernel's.  L (hopper.cuh Layout): natural, head_map's
// (B, S, H, d) maps; transposed, band_map's over flash_transposed.cu's
// stacked (3 H d, B, S) bands (q, k and v each their band's map, Sq = Sk =
// S), where a k or v tile is two 64-token boxes, the logits reduce down the
// rows of MN-major q and k, one wgmma a box and k16 step, and p v reads the
// first 48 rows of each K-major v box.  The layout changes no arithmetic.
template <Layout L, int NWG, int KS, bool LSE>
__global__ void __launch_bounds__((NWG + 1) * 128, NWG == 1 ? 2 : 1)
flash_narrow_kernel(const __grid_constant__ Operand<L> map_q,
                    const __grid_constant__ Operand<L> map_k,
                    const __grid_constant__ Operand<L> map_v,
                    const __grid_constant__ Operand<L> map_o, int Sk, float q_scale,
                    float* lse, int Sq) {
  static_assert(KS >= 1 && 16 * KS <= NARROW_D, "at most 3 k16 steps");
  static_assert(L == Layout::natural || !LSE, "the transposed layout has no lse output");
  constexpr int STAGES = SmemNarrow<NWG>::STAGES;
  constexpr bool T = L != Layout::natural;  // transposed tiles, by TMA or by hand
  constexpr bool ROWS = L == Layout::rows;
  constexpr int BOXES = T ? BN / ROW_ELEMS : 1;  // TMA boxes a k or v tile
  constexpr int BOX = BN * D / BOXES;            // elements of one
  constexpr int BOX_DESC = BOX * (int)sizeof(bf16) >> 4;
  extern __shared__ unsigned char smem_raw[];
  SmemNarrow<NWG>& sm = *reinterpret_cast<SmemNarrow<NWG>*>(align_smem(smem_raw));

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
    for (int i = threadIdx.x; i < BN * D / 8; i += (NWG + 1) * 128) ones[i] = one8;
    fence_async_smem();
  }
  __syncthreads();

  if (group == 0) {
    reg_dec<ROWS ? ROWS_PRODUCER_REGS<NWG> : NWG == 2 ? 40 : 24>();
    if constexpr (ROWS) {  // the warpgroup's 128 threads (hopper.cuh produce_rows)
      unsigned char* room = reinterpret_cast<unsigned char*>(&sm) + (sizeof(sm) + 15) / 16 * 16;
      auto kv_box = [&](int kv) {  // box i of tile t's k (kv = 0) or v (1)
        return [=, &sm](int t, int i) {
          return RowsBox{(kv ? sm.v[t % STAGES] : sm.k[t % STAGES]) + i * BOX,
                         rows_side<NWG, BOXES>(room, t % STAGES, kv, i), h, 0,
                         t * BN + i * ROW_ELEMS};
        };
      };
      produce_rows<NWG, BOXES, STAGES>(
          map_q, map_k, map_v, b, tiles,
          [&](int w) {
            return RowsBox{sm.q[w], room + w * ROWS_SIDE_BYTES, h, 0, row0 + w * BM};
          },
          kv_box(0), kv_box(1),
          [&](int t) { mbar_wait(&sm.empty_k[t % STAGES], ((t / STAGES) & 1) ^ 1); },
          [&](int t) { mbar_wait(&sm.empty_v[t % STAGES], ((t / STAGES) & 1) ^ 1); },
          &sm.full_q, sm.full_k, sm.full_v);
    } else if (threadIdx.x == 0) {
      mbar_expect_tx(&sm.full_q, NWG * Q_BYTES);
      for (int w = 0; w < NWG; ++w)
        tma_load_panel<L>(sm.q[w], &map_q, &sm.full_q, 0, h, row0 + w * BM, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int t = 0; t < tiles; ++t) {
        mbar_wait(&sm.empty_k[stage], phase ^ 1);
        mbar_expect_tx(&sm.full_k[stage], KV_BYTES);
        for (int i = 0; i < BOXES; ++i)
          tma_load_panel<L>(sm.k[stage] + i * BOX, &map_k, &sm.full_k[stage], 0, h,
                            t * BN + i * ROW_ELEMS, b);
        mbar_wait(&sm.empty_v[stage], phase ^ 1);
        mbar_expect_tx(&sm.full_v[stage], KV_BYTES);
        for (int i = 0; i < BOXES; ++i)
          tma_load_panel<L>(sm.v[stage] + i * BOX, &map_v, &sm.full_v[stage], 0, h,
                            t * BN + i * ROW_ELEMS, b);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }
  reg_inc<ROWS ? ROWS_CONSUMER_REGS<NWG> : NWG == 3 ? 160 : 232>();
  const int cw = group - 1;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const float exp_scale = 1.4426950408889634f;

  float o[NARROW_D / 2];  // rows 16 * warp + g (lo) and + 8 (hi), 48 columns
  float l[4];  // their row sums of the rounded p: l[0], l[1] the lo row's, l[2], l[3] the hi's
#pragma unroll
  for (int i = 0; i < NARROW_D / 2; ++i) o[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) l[i] = 0.0f;
  float s[64];
  uint32_t p[BN / 16][4];
  float m_lo = -INFINITY, m_hi = -INFINITY;
  float a_lo, a_hi;

  const uint64_t dq = smem_desc_sw128(sm.q[cw]);
  const uint64_t d1 = smem_desc_sw128(sm.ones);
  wait_full<ROWS>(&sm.full_q, 0);
  scale_tile(sm.q[cw], BM * D, q_scale, threadIdx.x & 127, 128);
  fence_async_smem();
  named_barrier(1 + cw, 128);

  // the logits of a tile, one commit group (the transposed layout's two
  // boxes too: wgmma_wait counts groups)
  auto logits = [&](int stage) {
    const uint64_t dk = smem_desc_sw128(sm.k[stage]);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if constexpr (T) {  // 16 rows of d a step; box i's keys into s[32 i ...]
#pragma unroll
        for (int i = 0; i < BOXES; ++i)
          wgmma_m64n64k16_ss<1, 1>(*reinterpret_cast<float(*)[32]>(&s[32 * i]),
                                   dq + kk * DESC_MN_STEP,
                                   dk + i * BOX_DESC + kk * DESC_MN_STEP, kk > 0);
      } else {
        wgmma_m64n128k16_ss(s, dq + kk * DESC_K_STEP, dk + kk * DESC_K_STEP, kk > 0);
      }
    }
    wgmma_commit();
  };
  // p v, and p times a column of ones: the fp32 row sums of the rounded p.
  // v's key step kk: 16 rows down an MN-major tile (natural), 16 keys along
  // the rows of box kk / 4 of a K-major one (transposed)
  auto pv = [&](int stage) {
    const uint64_t dv = smem_desc_sw128(sm.v[stage]);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      if constexpr (T)
        wgmma_m64n48k16_rs<0>(o, p[kk], dv + (kk / 4) * BOX_DESC + (kk % 4) * DESC_K_STEP);
      else
        wgmma_m64n48k16_rs(o, p[kk], dv + kk * DESC_MN_STEP);
      wgmma_m64n8k16_rs(l, p[kk], d1 + kk * DESC_MN_STEP);
    }
    wgmma_commit();
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
    fence_regs(o);
    fence_regs(l);
    fence_regs(p);
    if (lane == 0) mbar_arrive(&sm.empty_v[stage]);
    scale_rows(o, a_lo, a_hi);
    scale_rows(l, a_lo, a_hi);
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
  fence_regs(o);
  fence_regs(l);
  // the last warpgroup's last turn is over: its final arrival is taken
  if (TURNS && cw == 0) named_barrier(TURN_BAR, 2 * 128);

  // normalised and rounded, through the warpgroup's own q tile (transposed:
  // d rows of 64 tokens); columns (rows) 48 and up keep q and are dropped by
  // the store with the rest past d
  bf16* tile = sm.q[cw];
  store_tile_out<L>(tile, o, 1.0f / l[0], 1.0f / l[2], warp, g, t4);
  if constexpr (LSE)  // l[0], l[2]: the tensor cores' whole-row sums
    store_lse(lse, Sq, row0 + cw * BM + warp * 16 + g, m_lo, m_hi, l[0], l[2], exp_scale,
              t4);
  fence_async_smem();
  named_barrier(1 + cw, 128);
  if constexpr (ROWS) {  // by hand: every thread of the warpgroup
    tma_store_panel<L>(&map_o, tile, 0, h, row0 + cw * BM, b);
  } else if ((threadIdx.x & 127) == 0) {
    tma_store_panel<L>(&map_o, tile, 0, h, row0 + cw * BM, b);
    tma_store_wait();
  }
}

// The launches share their arguments: the four tensor maps (by hand: the
// four bands), the shape, the lse output (nullptr: none, the kernels without
// its store) and the stream.
template <Layout L = Layout::natural>
struct Args {
  Operand<L> mq, mk, mv, mo;
  int B, Sq, Sk, H, d;
  float* lse;
  cudaStream_t stream;
};

template <Layout L, int NWG, int KS, bool LSE>
cudaError_t start_narrow(const Args<L>& a) {
  // by hand (rows), the side buffers of the boxes' ninth words after the struct
  constexpr int side =
      L == Layout::rows ? ROWS_SIDE<NWG, BN / ROW_ELEMS, SmemNarrow<NWG>::STAGES> + 16 : 0;
  constexpr int smem = (int)sizeof(SmemNarrow<NWG>) + SWIZZLE_SPAN + side;
  cudaError_t e = cudaFuncSetAttribute(flash_narrow_kernel<L, NWG, KS, LSE>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.Sq + NWG * BM - 1) / (NWG * BM), a.H, a.B);
  flash_narrow_kernel<L, NWG, KS, LSE><<<grid, (NWG + 1) * 128, smem, a.stream>>>(
      a.mq, a.mk, a.mv, a.mo, a.Sk, 1.0f / sqrtf((float)a.d), a.lse, a.Sq);
  return cudaGetLastError();
}

template <Layout L, int NWG, int KS>
cudaError_t launch_narrow(const Args<L>& a) {
  if constexpr (L != Layout::natural)
    return start_narrow<L, NWG, KS, false>(a);
  else
    return a.lse ? start_narrow<L, NWG, KS, true>(a) : start_narrow<L, NWG, KS, false>(a);
}

template <Layout L, int NWG>
cudaError_t launch_narrow_ks(const Args<L>& a) {
  switch ((a.d + 15) / 16) {
    case 1: return launch_narrow<L, NWG, 1>(a);
    case 2: return launch_narrow<L, NWG, 2>(a);
    default: return launch_narrow<L, NWG, 3>(a);
  }
}

// NARROW_WGS warpgroups a block where that fills this card's SMs, else one
template <Layout L>
cudaError_t launch_narrow_filling(const Args<L>& a) {
  int sm_count = 0;
  const cudaError_t e = multiprocessors(&sm_count);
  if (e != cudaSuccess) return e;
  const int rows = NARROW_WGS * BM;
  return (long)((a.Sq + rows - 1) / rows) * a.H * a.B >= sm_count
             ? launch_narrow_ks<L, NARROW_WGS>(a)
             : launch_narrow_ks<L, 1>(a);
}

template <int NWG, bool SCALE_Q, bool LSE>
cudaError_t start(const Args<>& a) {
  constexpr int smem = (int)sizeof(Smem<NWG>) + SWIZZLE_SPAN;
  cudaError_t e = cudaFuncSetAttribute(flash_hopper_kernel<NWG, SCALE_Q, LSE>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.Sq + NWG * BM - 1) / (NWG * BM), a.H, a.B);
  const float log2e = 1.4426950408889634f;
  flash_hopper_kernel<NWG, SCALE_Q, LSE><<<grid, (NWG + 1) * 128, smem, a.stream>>>(
      a.mq, a.mk, a.mv, a.mo, a.Sk, SCALE_Q ? log2e : 0.125f * log2e,
      1.0f / sqrtf((float)a.d), a.lse, a.Sq);
  return cudaGetLastError();
}

template <int NWG, bool SCALE_Q>
cudaError_t launch(const Args<>& a) {
  return a.lse ? start<NWG, SCALE_Q, true>(a) : start<NWG, SCALE_Q, false>(a);
}

}  // namespace

cudaError_t gswm_launch_flash_hopper(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                                     int B, int Sq, int Sk, int H, int d, int ld_q,
                                     int ld_kv, int ld_o, cudaStream_t stream, float* lse) {
  if (B < 1 || Sq < 1 || Sk < 1 || H < 1 || B > 65535 || H > 65535 || d < 8 || d % 8 ||
      d > D)
    return cudaErrorInvalidValue;
  Args<> a;
  a.B = B, a.Sq = Sq, a.Sk = Sk, a.H = H, a.d = d, a.lse = lse, a.stream = stream;
  cudaError_t e = head_map(&a.mq, q, B, Sq, H, d, ld_q, BM);
  if (e == cudaSuccess) e = head_map(&a.mk, k, B, Sk, H, d, ld_kv, BN);
  if (e == cudaSuccess) e = head_map(&a.mv, v, B, Sk, H, d, ld_kv, BN);
  if (e == cudaSuccess) e = head_map(&a.mo, out, B, Sq, H, d, ld_o, BM);
  if (e != cudaSuccess) return e;
  if (d <= NARROW_D) return launch_narrow_filling<Layout::natural>(a);
  // 128-row blocks unless they would leave SMs of this card without one
  int sm_count = 0;
  e = multiprocessors(&sm_count);
  if (e != cudaSuccess) return e;
  const long blocks128 = (long)((Sq + 2 * BM - 1) / (2 * BM)) * H * B;
  const bool wide = blocks128 >= sm_count;
  if (d == D)  // the 2^-3 scale folded into the exponent, exact
    return wide ? launch<2, false>(a) : launch<1, false>(a);
  return wide ? launch<2, true>(a) : launch<1, true>(a);
}

cudaError_t gswm_launch_flash_narrow_transposed(const bf16* qkv_t, bf16* out_t, int B, int S,
                                                int H, int d, bool rows, cudaStream_t stream) {
  if (B < 1 || S < 1 || H < 1 || B > 65535 || H > 65535 || d < 8 || d % 8 || d > NARROW_D ||
      (!rows && S % 8))
    return cudaErrorInvalidValue;
  const size_t band = (size_t)H * d * B * S;  // elements: q's rows, then k's, then v's
  if (rows) {  // the bands addressed by hand
    bf16* in = const_cast<bf16*>(qkv_t);
    Args<Layout::rows> r;
    r.mq = BandRows{in, B, S, d};
    r.mk = BandRows{in + band, B, S, d};
    r.mv = BandRows{in + 2 * band, B, S, d};
    r.mo = BandRows{out_t, B, S, d};
    r.B = B, r.Sq = S, r.Sk = S, r.H = H, r.d = d, r.lse = nullptr, r.stream = stream;
    return launch_narrow_filling<Layout::rows>(r);
  }
  Args<Layout::transposed> a;
  a.B = B, a.Sq = S, a.Sk = S, a.H = H, a.d = d, a.lse = nullptr, a.stream = stream;
  cudaError_t e = band_map(&a.mq, qkv_t, H, d, B, S);
  if (e == cudaSuccess) e = band_map(&a.mk, qkv_t + band, H, d, B, S);
  if (e == cudaSuccess) e = band_map(&a.mv, qkv_t + 2 * band, H, d, B, S);
  if (e == cudaSuccess) e = band_map(&a.mo, out_t, H, d, B, S);
  if (e != cudaSuccess) return e;
  return launch_narrow_filling<Layout::transposed>(a);
}

// Pair-packed self-attention: qkv (B, S, 3 * P * 128) with q, k and v at
// columns [0, P * 128), [P * 128, 2 * P * 128) and [2 * P * 128, 3 * P * 128),
// each 2 * P heads of 64; out (B, S, P * 128).
extern "C" int gswm_flash_packed(const void* qkv, void* out, int B, int S, int P,
                                 void* stream) {
  if (P < 1) return static_cast<int>(cudaErrorInvalidValue);
  const bf16* q = static_cast<const bf16*>(qkv);
  const int width = P * 128;
  return static_cast<int>(gswm_launch_flash_hopper(
      q, q + width, q + 2 * width, static_cast<bf16*>(out), B, S, S, 2 * P, D, 3 * width,
      3 * width, width, static_cast<cudaStream_t>(stream)));
}
