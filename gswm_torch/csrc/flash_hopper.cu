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
// 32 accumulator + 32 p registers a thread).  Not done here: overlapping one
// warpgroup's softmax with the other's wgmma, which the exponentials' roof
// above asks for.

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
// log2(e) and q_scale is not read.
template <int NWG, bool SCALE_Q>
__global__ void __launch_bounds__((NWG + 1) * 128, NWG == 1 ? 2 : 1)
flash_hopper_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_o, int Sk, float exp_scale,
                    float q_scale) {
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
    store_tile_sw128(tile, o, 1.0f / quad_sum(l_lo), 1.0f / quad_sum(l_hi), warp, g, t4);
    fence_async_smem();
    named_barrier(1 + cw, 128);
    if ((threadIdx.x & 127) == 0) {
      tma_store_4d(&map_o, tile, 0, h, row0 + cw * BM, b);
      tma_store_wait();
    }
  }
}

template <int NWG, bool SCALE_Q>
cudaError_t launch(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
                   const CUtensorMap& mo, int B, int Sq, int Sk, int H, int d,
                   cudaStream_t stream) {
  constexpr int smem = (int)sizeof(Smem<NWG>) + SWIZZLE_SPAN;
  cudaError_t e = cudaFuncSetAttribute(flash_hopper_kernel<NWG, SCALE_Q>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Sq + NWG * BM - 1) / (NWG * BM), H, B);
  const float log2e = 1.4426950408889634f;
  flash_hopper_kernel<NWG, SCALE_Q><<<grid, (NWG + 1) * 128, smem, stream>>>(
      mq, mk, mv, mo, Sk, SCALE_Q ? log2e : 0.125f * log2e, 1.0f / sqrtf((float)d));
  return cudaGetLastError();
}

}  // namespace

cudaError_t gswm_launch_flash_hopper(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                                     int B, int Sq, int Sk, int H, int d, int ld_q,
                                     int ld_kv, int ld_o, cudaStream_t stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || H < 1 || B > 65535 || H > 65535 || d < 8 || d % 8 ||
      d > D)
    return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv, mo;
  cudaError_t e = head_map(&mq, q, B, Sq, H, d, ld_q, BM);
  if (e == cudaSuccess) e = head_map(&mk, k, B, Sk, H, d, ld_kv, BN);
  if (e == cudaSuccess) e = head_map(&mv, v, B, Sk, H, d, ld_kv, BN);
  if (e == cudaSuccess) e = head_map(&mo, out, B, Sq, H, d, ld_o, BM);
  if (e != cudaSuccess) return e;
  // 128-row blocks unless they would leave SMs of this card without one
  int dev = 0, sm_count = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long blocks128 = (long)((Sq + 2 * BM - 1) / (2 * BM)) * H * B;
  const bool wide = blocks128 >= sm_count;
  if (d == D)  // the 2^-3 scale folded into the exponent, exact
    return wide ? launch<2, false>(mq, mk, mv, mo, B, Sq, Sk, H, d, stream)
                : launch<1, false>(mq, mk, mv, mo, B, Sq, Sk, H, d, stream);
  return wide ? launch<2, true>(mq, mk, mv, mo, B, Sq, Sk, H, d, stream)
              : launch<1, true>(mq, mk, mv, mo, B, Sq, Sk, H, d, stream);
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
