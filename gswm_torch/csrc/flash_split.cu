// Split flash attention on (B, S, H, D) bf16 q/k/v, D a multiple of 64 up
// to 512, any Sq and Sk.  D = 64 goes to the wgmma kernel of flash_hopper.cu;
// the kernel in this file runs D = 128 ... 512.
//
// Replaces gswm/ops/attention.py:414 flash_attention -> _flash_bhsd (:250),
// whose three Pallas tiers (_flash_kernel :212 head-resident,
// _flash_kernel_kvres :231 KV-resident, _flash_kernel_streamk :355
// streaming K/V) are VMEM-fit choices of one computation.  Its user on the
// port's path is the VAE mid-block attention above 4096 tokens: one head with
// D = C = 512 over 9216 tokens at 768x768, in the encoder and the decoder
// (gswm/models/layers.py:692-725).  The JAX wrapper transposes to
// (B*H, S, D) and pads to its blocks; here q/k/v are read strided in their
// natural layout, ragged keys are masked and ragged query rows skipped.
//
// Semantics: the `use_max` branch of the TPU kernels' recurrence
// (_attend_kv_loop / _flash_kernel_streamk): q scaled by D^-0.5 in fp32 and
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
// version materializes) must never reach device memory.
//
// Design.  At D = 512 a 64-row q tile, 64-key k and v tiles and a 64 x 512
// fp32 accumulator in shared memory would be 320 KiB, above the 227 KiB a
// block may have.  So one block of eight warps takes 32 query rows and walks
// 64-key tiles:
//   * shared memory holds the q tile, one k and one v tile (bf16, row pitch
//     D + 8 so ldmatrix rows fall in distinct banks), the 32 x 64 fp32 logits
//     and the bf16 p tile: 176 KiB at D = 512;
//   * S = q k^T: each warp computes one 16 x 16 tile of logits over the
//     whole of D with mma.sync m16n8k16 (bf16 in, fp32 accumulate);
//   * the online softmax: each warp owns 4 rows, lanes split the 64 keys,
//     warp shuffles reduce; the rescale factor of each row goes to shared
//     memory;
//   * O += p v: the 32 x D fp32 accumulator lives in registers, split by
//     warps into 2 row groups x 4 slices of D (16 x D/4 each: 64 floats a
//     thread at D = 512).  mma.sync's documented fragment layout tells each
//     thread which two rows it holds, so the rescale needs no shared memory.
// k and v tiles arrive by cp.async in two groups, so the logits and the
// softmax of a tile overlap the v tile's copy.  No TMA, no wgmma, no
// multi-stage pipeline here: this is the simple first kernel, still to be
// redesigned for the card as the D = 64 one was.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_core.cuh"

namespace {

using namespace gswm_flash;

template <int D>
struct Tile {
  static constexpr int LDH = D + 8;     // bf16 row pitch of q, k, v tiles
  static constexpr int DS = D / 4;      // D slice of one warp's accumulator
  static constexpr int NT = DS / 8;     // n8 tiles in that slice
  static constexpr int SMEM = (BQ + 2 * BK) * LDH * (int)sizeof(bf16) +
                              BQ * LDS * (int)sizeof(float) +
                              BQ * LDP * (int)sizeof(bf16) +
                              2 * BQ * (int)sizeof(float);
  static_assert(D % 64 == 0 && D >= 128 && D <= 512, "D is a multiple of 64, 128 to 512");
  static_assert(SMEM <= 232448, "above the 227 KiB a block may opt into");
};

// Rows [row0, row0 + rows) of one head (D columns, `pitch` elements between
// rows) into shared memory; rows at or past S are zero.
template <int D>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* __restrict__ src,
                                                int row0, int rows, int S, int pitch,
                                                int tid) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int i = tid; i < rows * CH; i += THREADS) {
    const int r = i / CH;
    const int c = (i % CH) * 8;
    const int g = row0 + r;
    const bool ok = g < S;
    cp_async16(dst + r * Tile<D>::LDH + c, src + (size_t)(ok ? g : 0) * pitch + c, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_split_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ out, int Sq,
                   int Sk, int ld, float scale) {
  constexpr int LDH = Tile<D>::LDH;
  constexpr int DS = Tile<D>::DS;
  constexpr int NT = Tile<D>::NT;

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + BQ * LDH;
  bf16* vs = ks + BK * LDH;
  float* ss = reinterpret_cast<float*>(vs + BK * LDH);
  bf16* ps = reinterpret_cast<bf16*>(ss + BQ * LDS);
  float* alpha_s = reinterpret_cast<float*>(ps + BQ * LDP);
  float* l_s = alpha_s + BQ;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bf16* qh = q + (size_t)b * Sq * ld + (size_t)h * D;
  const bf16* kh = k + (size_t)b * Sk * ld + (size_t)h * D;
  const bf16* vh = v + (size_t)b * Sk * ld + (size_t)h * D;
  bf16* oh = out + (size_t)b * Sq * ld + (size_t)h * D;

  load_tile_async<D>(qs, qh, q0, BQ, Sq, ld, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // q is scaled by D^-0.5 in fp32 and rounded to bf16, as the TPU kernels do
  for (int i = tid; i < BQ * (D / 2); i += THREADS) {
    __nv_bfloat162* p =
        reinterpret_cast<__nv_bfloat162*>(qs + (i / (D / 2)) * LDH) + (i % (D / 2));
    const float2 f = __bfloat1622float2(*p);
    *p = __floats2bfloat162_rn(f.x * scale, f.y * scale);
  }

  // logits tile of this warp: rows 16 * wr, keys 16 * wc
  const int wr = warp >> 2;
  const int wc = warp & 3;
  // accumulator of this warp: rows 16 * wr, D columns DS * wc (same split)
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

  // ldmatrix row addresses (lane l feeds row l % 8 of 8x8 matrix l / 8)
  const bf16* a_q = qs + (wr * 16 + (lane & 15)) * LDH + (lane >> 4) * 8;
  const bf16* b_k = ks + (wc * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDH +
                    ((lane >> 3) & 1) * 8;
  const bf16* a_p = ps + (wr * 16 + (lane & 15)) * LDP + (lane >> 4) * 8;
  const bf16* b_v = vs + ((lane & 7) + (((lane >> 3) & 1) << 3)) * LDH + wc * DS +
                    (lane >> 4) * 8;

  for (int k0 = 0; k0 < Sk; k0 += BK) {
    __syncthreads();  // the previous tile's k, v, p and alpha are consumed
    load_tile_async<D>(ks, kh, k0, BK, Sk, ld, tid);
    cp_async_commit();
    load_tile_async<D>(vs, vh, k0, BK, Sk, ld, tid);
    cp_async_commit();
    cp_async_wait<1>();  // this thread's k copies have landed
    __syncthreads();

    // S = q k^T for this warp's 16 x 16 tile (two n8 tiles of keys)
    {
      float s0[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float s1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 8
      for (int kk = 0; kk < D; kk += 16) {
        uint32_t a[4], bb[4];
        ldmatrix_x4(a, a_q + kk);
        ldmatrix_x4(bb, b_k + kk);
        mma_bf16(s0, a, bb[0], bb[1]);
        mma_bf16(s1, a, bb[2], bb[3]);
      }
      store_logits(ss, s0, s1, wr, wc, g, t4);
    }
    __syncthreads();

    online_softmax_tile(ss, ps, alpha_s, m_r, l_r, min(BK, Sk - k0), warp, lane);
    cp_async_wait<0>();  // this thread's v copies have landed
    __syncthreads();

    // acc = acc * alpha + p v over this warp's 16 rows and D slice
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
        uint32_t a[4];
        ldmatrix_x4(a, a_p + kk);
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t bb[4];
          ldmatrix_x4_trans(bb, b_v + kk * LDH + j * 8);
          mma_bf16(acc[j], a, bb[0], bb[1]);
          mma_bf16(acc[j + 1], a, bb[2], bb[3]);
        }
      }
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) l_s[warp * ROWS_PER_WARP + r] = l_r[r];
  }
  __syncthreads();
  const float l_lo = l_s[wr * 16 + g];
  const float l_hi = l_s[wr * 16 + g + 8];
  const int r_lo = q0 + wr * 16 + g;
  const int r_hi = r_lo + 8;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = wc * DS + j * 8 + 2 * t4;
    if (r_lo < Sq)
      *reinterpret_cast<__nv_bfloat162*>(oh + (size_t)r_lo * ld + col) =
          __floats2bfloat162_rn(acc[j][0] / l_lo, acc[j][1] / l_lo);
    if (r_hi < Sq)
      *reinterpret_cast<__nv_bfloat162*>(oh + (size_t)r_hi * ld + col) =
          __floats2bfloat162_rn(acc[j][2] / l_hi, acc[j][3] / l_hi);
  }
}

// ld: elements between rows of q, k, v and out; head h starts at column
// h * D of each.
template <int D>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* out, int B,
                   int Sq, int Sk, int H, int ld, cudaStream_t stream) {
  constexpr int smem = Tile<D>::SMEM;
  // above the 48 KiB a launch gets without asking
  cudaError_t e = cudaFuncSetAttribute(
      flash_split_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_split_kernel<D><<<grid, THREADS, smem, stream>>>(
      q, k, v, out, Sq, Sk, ld, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

}  // namespace

cudaError_t gswm_launch_flash_split(const bf16* q, const bf16* k, const bf16* v,
                                    bf16* out, int B, int Sq, int Sk, int H, int D,
                                    cudaStream_t stream) {
  if (Sq < 1 || Sk < 1) return cudaErrorInvalidValue;
  const int ld = H * D;  // natural layout: q, k, v and out share one row pitch
  switch (D) {
    case 64:
      return gswm_launch_flash_hopper(q, k, v, out, B, Sq, Sk, H, ld, ld, ld, stream);
    case 128: return launch<128>(q, k, v, out, B, Sq, Sk, H, ld, stream);
    case 192: return launch<192>(q, k, v, out, B, Sq, Sk, H, ld, stream);
    case 256: return launch<256>(q, k, v, out, B, Sq, Sk, H, ld, stream);
    case 320: return launch<320>(q, k, v, out, B, Sq, Sk, H, ld, stream);
    case 384: return launch<384>(q, k, v, out, B, Sq, Sk, H, ld, stream);
    case 448: return launch<448>(q, k, v, out, B, Sq, Sk, H, ld, stream);
    case 512: return launch<512>(q, k, v, out, B, Sq, Sk, H, ld, stream);
    default: return cudaErrorInvalidValue;
  }
}

// q, out: (B, Sq, H, D); k, v: (B, Sk, H, D); bf16 device pointers, rows
// 16-byte aligned.  out = softmax(q k^T / sqrt(D)) v per (batch, head).
extern "C" int gswm_flash_split(const void* q, const void* k, const void* v, void* out,
                                int B, int Sq, int Sk, int H, int D, void* stream) {
  return static_cast<int>(gswm_launch_flash_split(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), B, Sq, Sk, H, D,
      static_cast<cudaStream_t>(stream)));
}
