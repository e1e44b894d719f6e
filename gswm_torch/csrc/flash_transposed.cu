// Flash self-attention on the transposed stacked projection output, any
// head dim d with d % 8 == 0, 8 <= d <= 512, any token count S.
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
// Tensor maps over the true d where S % 8 == 0: (S, B, d, heads), tokens
// innermost, boxes of (64 tokens, 1, 64 rows, 1) (hopper.cuh band_map).
// Panel j of a head is the box at row 64 j: rows from d to the panel's end
// arrive as zeros on a load and are dropped on a store, and no box reaches
// into the next head's rows; tokens past S arrive as zeros and never from
// batch b + 1.  A panel lands as 64 rows (d) of 128 bytes (64 tokens) in
// hopper.cuh's one layout.  Where S % 8 != 0 (324 tokens at SD 1.x's and
// SD 2.x's level 2 at 576x576, 988 at SDXL's 832x1216 level 2) the rows
// start at any even byte address and no tensor map can address them: at d
// <= 160 the same boxes are loaded and stored by hand (hopper.cuh
// Layout::rows, "boxes by hand"), into the same tiles, and every design's
// wgmma loop runs as it is; above 160 a pre-pass copies the input into
// scratch whose token pitch is rounded up to 8 (align_tokens_kernel, below)
// and the tensor maps read that.  Four designs, chosen by d alone
// (launch_design):
//
//   d <= 48               flash_hopper.cu's flash_narrow_kernel, transposed
//   48 < d <= 64          flash_transposed_kernel (below)
//   64 < d <= 160         flash_mid.cu's flash_mid_kernel, transposed
//   d > 160               flash_split.cu's flash_split_kernel, transposed,
//                         by tensor maps at every S (the pre-pass first
//                         where S % 8 != 0)
//
// d <= 48 (SD 1.x's 40 at level 0), 64 < d <= 160 (its 80 and 160 at
// levels 1 and 2) and d > 160: the natural layout's own designs, the layout
// a template parameter of their one body (hopper.cuh Layout; launchers in
// flash_core.cuh): the narrow kernel's three warpgroups in turns, logits of
// tile t + 1 with p v of tile t, row sums on the tensor cores and p v at N =
// 48; the mid kernel's one warpgroup owning 64 tokens across the whole d,
// full 64-row panels and a tail rounded up to 16 rows; the split kernel's
// two consumer warpgroups sharing 64 query tokens, each owning half of d's
// panels.  Their output equals the natural layout's kernel's on the same q,
// k and v bit for bit, in every form.
//
// 48 < d <= 64 (SD 2.x's and SDXL's 64): flash_transposed_kernel,
// flash_hopper.cu's d <= 64 design (one producer warpgroup, one or two
// consumer warpgroups of 64 query tokens chosen from the card's SM count,
// 128-key tiles in a 2-stage ring with separate k and v mbarriers,
// hopper.cuh's softmax in registers) on the operands as they lie:
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
//     and out by one TMA store (or by hand), which drops tokens at or past S
//     and rows at or past d.
//
// d > 160 where S % 8 != 0 (boxes copied by hand, the earlier form, ran 16x
// the natural kernel's time at (1, 1001, 1, 512): the copies, not the
// products): align_tokens_kernel copies the (3 H d, B, S) input into
// scratch from the stream's pool (cudaMallocAsync, the pool's policy left
// as it is) with a token pitch of S rounded up to 8, 16 bytes a thread on
// the scratch's side, and the split kernel's tensor maps read it at the
// true S (tokens past S arrive as zeros whatever the pitch holds); the
// output is stored by hand into the true array (a TMA store into scratch
// copied back timed slower at d = 192 and 256).  What bounds the pre-pass
// is its bytes: the input read once and written once, 3 / 4 of K7's own
// bytes twice over, microseconds against the products' tens.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "flash_core.cuh"
#include "hopper.cuh"

namespace {

using namespace gswm_hopper;

constexpr int D = 64;  // rows of a panel: one head of d <= 64, zero-padded
constexpr int NARROW_D = 48;  // the widest head of flash_hopper.cu's narrow kernel
constexpr int MID_D = 160;    // and of flash_mid.cu's
constexpr int PANEL = D * ROW_ELEMS;  // elements of a (64 d, 64 tokens) panel
constexpr int PANEL_BYTES = PANEL * (int)sizeof(bf16);

// The operands: tensor maps, or the bands addressed by hand (ROWS)
template <bool ROWS>
using Band = Operand<ROWS ? Layout::rows : Layout::transposed>;

// ---------------------------------------------------- 48 < d <= 64: wgmma ----

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

// Grid (query blocks, H, B).  map_in: (S, B, d, 3 H); map_out: (S, B, d, H);
// ROWS: the same arrays addressed by hand, boxes loaded and stored by the
// warpgroups' threads.  SCALE_Q: q is scaled by q_scale = d^-0.5 in shared
// memory and exp_scale = log2(e); else (d = 64) exp_scale = 2^-3 * log2(e)
// and q_scale is not read.
template <int NWG, bool SCALE_Q, bool ROWS>
__global__ void __launch_bounds__((NWG + 1) * 128, NWG == 1 ? 2 : 1)
flash_transposed_kernel(const __grid_constant__ Band<ROWS> map_in,
                        const __grid_constant__ Band<ROWS> map_out, int S, int H,
                        float exp_scale, float q_scale) {
  extern __shared__ unsigned char smem_raw[];
  Smem<NWG>& sm = *reinterpret_cast<Smem<NWG>*>(align_smem(smem_raw));

  const int group = threadIdx.x >> 7;  // 0: producer, 1..NWG: consumers
  const int tok0 = blockIdx.x * (NWG * BM);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tiles = (S + BN - 1) / BN;

  if (threadIdx.x == 0) {  // by hand, each producer thread arrives on a full barrier
    mbar_init(&sm.full_q, ROWS ? 128 : 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full_k[s], ROWS ? 128 : 1);
      mbar_init(&sm.full_v[s], ROWS ? 128 : 1);
      mbar_init(&sm.empty[s], NWG * 4);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (group == 0) {
    reg_dec<ROWS ? ROWS_PRODUCER_REGS<NWG> : NWG == 1 ? 24 : 40>();
    if constexpr (ROWS) {  // the warpgroup's 128 threads (hopper.cuh produce_rows)
      unsigned char* room = reinterpret_cast<unsigned char*>(&sm) + (sizeof(sm) + 15) / 16 * 16;
      auto kv_box = [&](int kv) {  // panel pn of tile t's k (kv = 0, head H + h) or v (1, 2 H + h)
        return [=, &sm](int t, int pn) {
          return RowsBox{(kv ? sm.v[t % STAGES] : sm.k[t % STAGES]) + pn * PANEL,
                         rows_side<NWG, KV_PANELS>(room, t % STAGES, kv, pn), (1 + kv) * H + h,
                         0, t * BN + pn * ROW_ELEMS};
        };
      };
      // one empty barrier a stage: k and v are released together
      auto wait_empty = [&](int t) { mbar_wait(&sm.empty[t % STAGES], ((t / STAGES) & 1) ^ 1); };
      produce_rows<NWG, KV_PANELS, STAGES>(
          map_in, map_in, map_in, b, tiles,
          [&](int w) {
            return RowsBox{sm.q[w], room + w * ROWS_SIDE_BYTES, h, 0, tok0 + w * BM};
          },
          kv_box(0), kv_box(1), wait_empty, wait_empty, &sm.full_q, sm.full_k, sm.full_v);
    } else if (threadIdx.x == 0) {
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
    reg_inc<ROWS ? ROWS_CONSUMER_REGS<NWG> : 232>();
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
    wait_full<ROWS>(&sm.full_q, 0);
    if constexpr (SCALE_Q) {  // this warpgroup's own q tile
      scale_tile(sm.q[cw], PANEL, q_scale, threadIdx.x & 127, 128);
      fence_async_smem();
      named_barrier(1 + cw, 128);
    }

    int stage = 0;
    uint32_t phase = 0;
    for (int t = 0; t < tiles; ++t) {
      wait_full<ROWS>(&sm.full_k[stage], phase);
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

      wait_full<ROWS>(&sm.full_v[stage], phase);
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
    if constexpr (ROWS) {  // by hand: every thread of the warpgroup
      store_box_rows(sm.q[cw], map_out, h, 0, tok0 + cw * BM, b);
    } else if ((threadIdx.x & 127) == 0) {
      tma_store_4d(&map_out, sm.q[cw], tok0 + cw * BM, b, 0, h);
      tma_store_wait();
    }
  }
}

template <int NWG, bool SCALE_Q, bool ROWS>
cudaError_t launch(const Band<ROWS>& m_in, const Band<ROWS>& m_out, int B, int S, int H,
                   int d, cudaStream_t stream) {
  // by hand, the side buffers of the boxes' ninth words after the struct
  constexpr int side = ROWS ? ROWS_SIDE<NWG, KV_PANELS, STAGES> + 16 : 0;
  constexpr int smem = (int)sizeof(Smem<NWG>) + SWIZZLE_SPAN + side;
  cudaError_t e = cudaFuncSetAttribute(flash_transposed_kernel<NWG, SCALE_Q, ROWS>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((S + NWG * BM - 1) / (NWG * BM), H, B);
  const float log2e = 1.4426950408889634f;
  flash_transposed_kernel<NWG, SCALE_Q, ROWS><<<grid, (NWG + 1) * 128, smem, stream>>>(
      m_in, m_out, S, H, SCALE_Q ? log2e : 0.125f * log2e, 1.0f / sqrtf((float)d));
  return cudaGetLastError();
}

// ------------------------------------- 160 < d <= 512: the aligning pre-pass ----

constexpr int MOVE_THREADS = 256;

// rows of S bf16 tokens at any even address (src) into rows of `pitch`
// (pitch % 8 == 0, pitch >= S), tokens S ... pitch - 1 zero: a thread a
// 16-byte chunk of the destination, read as 4-byte pairs where S is even
// and as elements where it is odd.
__global__ void __launch_bounds__(MOVE_THREADS)
align_tokens_kernel(const bf16* __restrict__ src, bf16* __restrict__ dst, long long rows, int S,
                    int pitch) {
  const int chunks = pitch / 8;
  const long long n = rows * chunks;
  const unsigned short* in = reinterpret_cast<const unsigned short*>(src);
  for (long long i = blockIdx.x * (long long)MOVE_THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * MOVE_THREADS) {
    const long long r = i / chunks;
    const int t0 = (int)(i - r * chunks) * 8;
    const long long at = r * S + t0;
    uint32_t w[4];
    if ((S & 1) == 0 && t0 + 8 <= S) {  // four aligned pairs
      const uint32_t* pairs = reinterpret_cast<const uint32_t*>(in + at);
#pragma unroll
      for (int k = 0; k < 4; ++k) w[k] = __ldg(pairs + k);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t lo = t0 + 2 * k < S ? __ldg(in + at + 2 * k) : 0u;
        const uint32_t hi = t0 + 2 * k + 1 < S ? __ldg(in + at + 2 * k + 1) : 0u;
        w[k] = lo | hi << 16;
      }
    }
    *reinterpret_cast<uint4*>(dst + r * pitch + t0) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

static inline unsigned move_grid(long long chunks) {
  return (unsigned)std::min<long long>((chunks + MOVE_THREADS - 1) / MOVE_THREADS, 1 << 20);
}

cudaError_t align_tokens(const bf16* src, bf16* dst, long long rows, int S, int pitch,
                         cudaStream_t stream) {
  if (rows < 1 || S < 1 || pitch < S || pitch % 8) return cudaErrorInvalidValue;
  align_tokens_kernel<<<move_grid(rows * (pitch / 8)), MOVE_THREADS, 0, stream>>>(src, dst, rows,
                                                                                  S, pitch);
  return cudaGetLastError();
}

// K7 at d > 160 over a token pitch rounded up to 8: the pre-pass into
// scratch from the stream's pool, the split kernel by tensor maps, the
// output by hand
cudaError_t launch_split_aligned(const bf16* in, bf16* out, int B, int S, int H, int d,
                                 cudaStream_t stream) {
  const int pitch = (S + 7) / 8 * 8;
  const long long rows = 3ll * H * d * B;  // the stacked bands' rows
  void* scratch = nullptr;
  cudaError_t e = cudaMallocAsync(&scratch, (size_t)rows * pitch * sizeof(bf16), stream);
  if (e != cudaSuccess) return e;
  bf16* padded = static_cast<bf16*>(scratch);
  e = align_tokens(in, padded, rows, S, pitch, stream);
  if (e == cudaSuccess)
    e = gswm_launch_flash_split_transposed(padded, pitch, out, true, B, S, H, d, stream);
  const cudaError_t f = cudaFreeAsync(scratch, stream);
  return e != cudaSuccess ? e : f;
}

// The design of head dim d, whatever S: its boxes by tensor maps, or by hand
// (ROWS) where S % 8 != 0 leaves the rows where no tensor map reaches; above
// d = 160 (ROWS: the pre-pass, then tensor maps) the split kernel.
template <bool ROWS>
cudaError_t launch_form(const bf16* in, bf16* out, int B, int S, int H, int d,
                        cudaStream_t stream) {
  if (d <= NARROW_D) return gswm_launch_flash_narrow_transposed(in, out, B, S, H, d, ROWS, stream);
  if (d > D && d <= MID_D)
    return gswm_launch_flash_mid_transposed(in, out, B, S, H, d, ROWS, stream);
  if (d > MID_D)
    return ROWS ? launch_split_aligned(in, out, B, S, H, d, stream)
                : gswm_launch_flash_split_transposed(in, S, out, false, B, S, H, d, stream);
  Band<ROWS> m_in, m_out;
  cudaError_t e = cudaSuccess;
  if constexpr (ROWS) {  // the stacked bands (3 H heads) and the output, by hand
    m_in = BandRows{const_cast<bf16*>(in), B, S, d};
    m_out = BandRows{out, B, S, d};
  } else {
    e = band_map(&m_in, in, 3 * H, d, B, S);
    if (e == cudaSuccess) e = band_map(&m_out, out, H, d, B, S);
    if (e != cudaSuccess) return e;
  }
  // 128-token blocks unless they would leave SMs of this card without one
  int sm_count = 0;
  e = multiprocessors(&sm_count);
  if (e != cudaSuccess) return e;
  const bool wide = (long)((S + 2 * BM - 1) / (2 * BM)) * H * B >= sm_count;
  if (d == D)  // the 2^-3 scale folded into the exponent, exact
    return wide ? launch<2, false, ROWS>(m_in, m_out, B, S, H, d, stream)
                : launch<1, false, ROWS>(m_in, m_out, B, S, H, d, stream);
  return wide ? launch<2, true, ROWS>(m_in, m_out, B, S, H, d, stream)
              : launch<1, true, ROWS>(m_in, m_out, B, S, H, d, stream);
}

cudaError_t launch_design(const bf16* in, bf16* out, int B, int S, int H, int d, bool rows,
                          cudaStream_t stream) {
  return rows ? launch_form<true>(in, out, B, S, H, d, stream)
              : launch_form<false>(in, out, B, S, H, d, stream);
}

}  // namespace

// qkv_t: (3 * H * d, B, S) bf16, 16-byte aligned; out_t: (H * d, B, S); d %
// 8 == 0, 8 <= d <= 512.  out = softmax(q k^T / sqrt(d)) v per (batch, head)
// in the transposed layout: by tensor maps where S % 8 == 0, by hand where no
// tensor map can address the rows, the one design of d either way.
extern "C" int gswm_flash_transposed(const void* qkv_t, void* out_t, int B, int S, int H,
                                     int d, void* stream) {
  if (B < 1 || S < 1 || H < 1 || B > 65535 || H > 65535 || d < 8 || d % 8 || d > 512)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_design(static_cast<const bf16*>(qkv_t),
                                        static_cast<bf16*>(out_t), B, S, H, d, S % 8 != 0,
                                        static_cast<cudaStream_t>(stream)));
}

// The same function with every box loaded and stored by hand at any S (at d
// > 160: the pre-pass into scratch of an aligned pitch, then the tensor
// maps, at any S): the tests hold it against the tensor maps' form at S % 8
// == 0, which separates the loads and stores from the arithmetic.
extern "C" int gswm_flash_transposed_rows(const void* qkv_t, void* out_t, int B, int S, int H,
                                          int d, void* stream) {
  if (B < 1 || S < 1 || H < 1 || B > 65535 || H > 65535 || d < 8 || d % 8 || d > 512)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_design(static_cast<const bf16*>(qkv_t),
                                        static_cast<bf16*>(out_t), B, S, H, d, true,
                                        static_cast<cudaStream_t>(stream)));
}

// The pre-pass alone, which chip_smoke.py times and holds to its plain
// version: `rows` rows of S bf16 tokens (the stacked bands' 3 H d B) into
// rows of `pitch` (pitch % 8 == 0, pitch >= S), the tokens from S zero.
extern "C" int gswm_flash_transposed_align(const void* src, void* dst, long long rows, int S,
                                           int pitch, void* stream) {
  return static_cast<int>(align_tokens(static_cast<const bf16*>(src), static_cast<bf16*>(dst),
                                       rows, S, pitch, static_cast<cudaStream_t>(stream)));
}
