// Flash self-attention on the transposed stacked projection output.
//
// Replaces gswm/ops/attention.py:1428 flash_attention_transposed ->
// _flash_kernel_T (:1281, pallas_call :1470), which the JAX UNet routes its
// self-attention to under GSWM_TRANSPOSED_ATTN=1 (gswm/models/layers.py
// :465-482): the ('nc,bsc->nbs') qkv matmul writes (3 * H * D, B, S), q, k
// and v are row bands of that one array, and to_out contracts the (H * D, B,
// S) output over dim 0, so no split, reshape or transpose exists around the
// kernel.  Element (d, s) of head h and batch b of q lies at
// (h * D + d) * B * S + b * S + s; k's band starts at row H * D, v's at
// 2 * H * D; the output uses q's indexing.  D = 64.
//
// Semantics: exact softmax, the `use_max` recurrence of the TPU kernels, as
// in flash_split.cu.  The TPU kernel drops the running max and clamps logits
// at 60 on every dtype (:1305-1307); the two agree within rounding below
// that (tests/test_torch_tiers.py and tests/test_torch_gpu.py pin both
// sides).
//
// What bounds it on an H100: the same products as the split kernel at
// D = 64, 4 * B * H * S^2 * 64 FLOP over 8 * B * H * S * 64 bytes (S / 2
// FLOP a byte, 4,600 at 9216 tokens): the tensor cores.  The layout only
// changes how tiles arrive.
//
// Design: flash_split.cu's tiling at D = 64 (one block of eight warps, 32
// query rows, 64-key tiles, mma.sync m16n8k16, the fp32 accumulator in
// registers, flash_core.cuh's online softmax), with the tiles D-major: q
// is 64 rows of 32 contiguous tokens, k and v 64 rows of 64.  The products
// read them as they lie: ldmatrix.trans turns the D-major q and k tiles into
// the row-major A and column-major B fragments of S = q k^T, and plain
// ldmatrix reads the D-major v tile as the column-major B fragment of O =
// p v.  The output goes through shared memory (in q's tile) so each row d
// is stored as contiguous tokens.  When S is a multiple of 8 every row of
// 8 tokens is 16-byte aligned and tiles arrive by cp.async; otherwise (S =
// 1000, say) a second instance loads and stores element by element, masked.
// 37 KiB of static shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_core.cuh"

namespace {

using namespace gswm_flash;

constexpr int D = 64;
constexpr int LQ = BQ + 8;  // bf16 row pitch of the D-major q (and output) tile
constexpr int LK = BK + 8;  // bf16 row pitch of the D-major k and v tiles
constexpr int DS = D / 4;   // D slice of one warp's accumulator
constexpr int NT = DS / 8;  // n8 tiles in that slice

// Tokens [t0, t0 + cols) of the D rows of one (band, head, batch) block
// (`pitch` = B * S elements between rows) into a D x ld tile of shared
// memory; tokens at or past S are zero.  ALIGNED: S % 8 == 0, so each run of
// 8 tokens is one 16-byte copy, wholly in or out of range.
template <bool ALIGNED, int COLS>
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* __restrict__ src,
                                          int t0, int S, size_t pitch, int tid) {
  if (ALIGNED) {
    constexpr int CH = COLS / 8;
    for (int i = tid; i < D * CH; i += THREADS) {
      const int d = i / CH;
      const int c = (i % CH) * 8;
      const bool ok = t0 + c < S;
      cp_async16(dst + d * ld + c, src + d * pitch + (ok ? t0 + c : 0), ok);
    }
  } else {
    for (int i = tid; i < D * COLS; i += THREADS) {
      const int d = i / COLS;
      const int c = i % COLS;
      dst[d * ld + c] = t0 + c < S ? src[d * pitch + t0 + c] : __float2bfloat16(0.0f);
    }
  }
}

template <bool ALIGNED>
__global__ void __launch_bounds__(THREADS)
flash_transposed_kernel(const bf16* __restrict__ qkv_t, bf16* __restrict__ out_t, int B,
                        int S, int H, float scale) {
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
  const size_t band = (size_t)H * D * pitch;
  const bf16* qh = qkv_t + (size_t)h * D * pitch + (size_t)b * S;
  const bf16* kh = qh + band;
  const bf16* vh = kh + band;
  bf16* oh = out_t + (size_t)h * D * pitch + (size_t)b * S;

  load_tile<ALIGNED, BQ>(qs, LQ, qh, q0, S, pitch, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // q is scaled by D^-0.5 in fp32 and rounded to bf16, as the TPU kernels do
  for (int i = tid; i < D * (BQ / 2); i += THREADS) {
    __nv_bfloat162* p =
        reinterpret_cast<__nv_bfloat162*>(qs + (i / (BQ / 2)) * LQ) + (i % (BQ / 2));
    const float2 f = __bfloat1622float2(*p);
    *p = __floats2bfloat162_rn(f.x * scale, f.y * scale);
  }

  // logits tile of this warp: rows 16 * wr, keys 16 * wc; accumulator: rows
  // 16 * wr, D columns DS * wc
  const int wr = warp >> 2;
  const int wc = warp & 3;
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  float m_r[ROWS_PER_WARP];
  float l_r[ROWS_PER_WARP];
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    m_r[r] = -INFINITY;
    l_r[r] = 0.0f;
  }

  // ldmatrix row addresses; lane l feeds row l % 8 of 8x8 matrix m = l / 8.
  // q (A of q k^T, D-major, .trans): m = {d 0-7 | d 8-15} x {rows 0-7 | 8-15}
  // as a0..a3 want: rows step with m & 1, d with m >> 1.
  const bf16* a_q = qs + ((lane & 7) + ((lane >> 4) << 3)) * LQ + wr * 16 +
                    ((lane >> 3) & 1) * 8;
  // k (B of q k^T, D-major, .trans): b0, b1 of keys 0-7, then of keys 8-15
  const bf16* b_k = ks + ((lane & 7) + (((lane >> 3) & 1) << 3)) * LK + wc * 16 +
                    (lane >> 4) * 8;
  // p (A of p v, row-major), as in flash_split.cu
  const bf16* a_p = ps + (wr * 16 + (lane & 15)) * LDP + (lane >> 4) * 8;
  // v (B of p v, D-major = column-major B, plain ldmatrix): b0, b1 of d 0-7,
  // then of d 8-15
  const bf16* b_v = vs + (wc * DS + (lane & 7) + ((lane >> 4) << 3)) * LK +
                    ((lane >> 3) & 1) * 8;

  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();  // the previous tile's k, v, p and alpha are consumed
    load_tile<ALIGNED, BK>(ks, LK, kh, k0, S, pitch, tid);
    cp_async_commit();
    load_tile<ALIGNED, BK>(vs, LK, vh, k0, S, pitch, tid);
    cp_async_commit();
    cp_async_wait<1>();  // this thread's k copies have landed
    __syncthreads();

    {
      float s0[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float s1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        uint32_t a[4], bb[4];
        ldmatrix_x4_trans(a, a_q + kk * LQ);
        ldmatrix_x4_trans(bb, b_k + kk * LK);
        mma_bf16(s0, a, bb[0], bb[1]);
        mma_bf16(s1, a, bb[2], bb[3]);
      }
      store_logits(ss, s0, s1, wr, wc, g, t4);
    }
    __syncthreads();

    online_softmax_tile(ss, ps, alpha_s, m_r, l_r, min(BK, S - k0), warp, lane);
    cp_async_wait<0>();  // this thread's v copies have landed
    __syncthreads();

    {
      const float a_lo = alpha_s[wr * 16 + g];
      const float a_hi = alpha_s[wr * 16 + g + 8];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        acc[j][0] *= a_lo;
        acc[j][1] *= a_lo;
        acc[j][2] *= a_hi;
        acc[j][3] *= a_hi;
      }
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t a[4], bb[4];
        ldmatrix_x4(a, a_p + kk);
        ldmatrix_x4(bb, b_v + kk);
        mma_bf16(acc[0], a, bb[0], bb[1]);
        mma_bf16(acc[1], a, bb[2], bb[3]);
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
  for (int j = 0; j < NT; ++j) {
    const int d = wc * DS + j * 8 + 2 * t4;
    qs[d * LQ + r_lo] = __float2bfloat16(acc[j][0] / l_lo);
    qs[(d + 1) * LQ + r_lo] = __float2bfloat16(acc[j][1] / l_lo);
    qs[d * LQ + r_lo + 8] = __float2bfloat16(acc[j][2] / l_hi);
    qs[(d + 1) * LQ + r_lo + 8] = __float2bfloat16(acc[j][3] / l_hi);
  }
  __syncthreads();
  if (ALIGNED) {
    constexpr int CH = BQ / 8;
    for (int i = tid; i < D * CH; i += THREADS) {
      const int d = i / CH;
      const int c = (i % CH) * 8;
      if (q0 + c < S)
        *reinterpret_cast<uint4*>(oh + d * pitch + q0 + c) =
            *reinterpret_cast<const uint4*>(qs + d * LQ + c);
    }
  } else {
    for (int i = tid; i < D * BQ; i += THREADS) {
      const int d = i / BQ;
      const int c = i % BQ;
      if (q0 + c < S) oh[d * pitch + q0 + c] = qs[d * LQ + c];
    }
  }
}

}  // namespace

// qkv_t: (3 * H * 64, B, S) bf16, 16-byte aligned; out_t: (H * 64, B, S).
// out = softmax(q k^T / 8) v per (batch, head) in the transposed layout.
extern "C" int gswm_flash_transposed(const void* qkv_t, void* out_t, int B, int S, int H,
                                     void* stream) {
  if (B < 1 || S < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  const bf16* in = static_cast<const bf16*>(qkv_t);
  bf16* out = static_cast<bf16*>(out_t);
  const float scale = 1.0f / sqrtf((float)D);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S % 8 == 0)
    flash_transposed_kernel<true><<<grid, THREADS, 0, st>>>(in, out, B, S, H, scale);
  else
    flash_transposed_kernel<false><<<grid, THREADS, 0, st>>>(in, out, B, S, H, scale);
  return static_cast<int>(cudaGetLastError());
}
