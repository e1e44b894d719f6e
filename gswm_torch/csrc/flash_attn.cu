// Natural-layout flash attention, head dim 64, bf16 in and out.
//
// Replaces, for the UNet's level-0 self-attention (4096 tokens, 5 heads of
// 64 at 512x512), what the TPU path runs there: gswm/ops/attention.py:
// xla_flash_attention (plain XLA, the default) and the Pallas kernel it
// displaced, flash_attention_cres (_flash_kernel_cres), which stays
// reachable with GSWM_XF_ATTN=0.  It is also the attention core of the
// fused-qkv kernel (fused_qkv.cu), the port of flash_attention_fused_qkv.
//
// Semantics: the `use_max` branch of the TPU kernels' shared recurrence
// (gswm/ops/attention.py:_attend_kv_loop, body_max): exact softmax with a
// running row max, fp32 logits, p = exp(s - m) rounded to bf16 for the PV
// product, fp32 row sums of the rounded p and an fp32 accumulator.  The TPU
// bf16 path (body_nomax and xla_flash_attention) instead drops the max and
// clamps logits at 60.  The two agree within bf16 rounding while every
// |logit| < 60; above that the clamp flattens the largest logits and this
// kernel does not (tests/test_torch_attention.py pins both sides).
//
// What bounds it on an H100: at level 0 (B=4, S=4096, H=5) the two products
// are 4 * 5 * 4096^2 * 64 * 4 = 21.5 GFLOP, against 4 * 3 * 4096 * 320 * 2 =
// 31 MB of q/k/v read and 10 MB written: some 500 FLOP a byte, far above the
// card's ~295, so the tensor cores bound it and the logits must never reach
// device memory.  Design: one block of four warps per (batch, head, 64-row
// query tile) keeps the query tile, one 64-key tile of k and v, the logits
// and the output accumulator in shared memory (70 KiB), and walks the keys
// with an online softmax.  Products run on the tensor cores through WMMA
// (16x16x16 bf16, fp32 accumulate); each warp owns 16 query rows, so the
// softmax needs only warp shuffles.  No TMA, no wgmma, no pipelining of the
// tile loads yet: this is the simple first kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "flash_core.cuh"

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int D = 64;        // head dim
constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // keys per tile
constexpr int LDH = D + 8;   // bf16 row pitch in shared memory (72)
constexpr int LDF = BK + 4;  // fp32 row pitch in shared memory (68)
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int SMEM_BYTES =
    4 * BQ * LDH * (int)sizeof(bf16) + 2 * BQ * LDF * (int)sizeof(float);

static_assert(BQ == WARPS * 16, "each warp owns 16 query rows");
static_assert(BK == D, "p and the k/v tiles share the bf16 row pitch");

// Copy rows [row0, row0 + 64) of one head (64 columns starting at col0) into
// shared memory; rows at or past S are zero.  Scales by `scale` in fp32 and
// rounds back to bf16 when scale != 1 (the query tile).
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src,
                                          int row0, int S, int pitch, int col0,
                                          float scale, int tid) {
  for (int i = tid; i < 64 * (D / 8); i += THREADS) {
    const int r = i / (D / 8);
    const int c = (i % (D / 8)) * 8;
    const int g = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (g < S) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)g * pitch + col0 + c);
      if (scale != 1.0f) {
        bf16* h = reinterpret_cast<bf16*>(&val);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          h[j] = __float2bfloat16(__bfloat162float(h[j]) * scale);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * LDH + c) = val;
  }
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

__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out, int S,
                 int H) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + BQ * LDH;
  bf16* vs = ks + BK * LDH;
  bf16* ps = vs + BK * LDH;
  float* ss = reinterpret_cast<float*>(ps + BQ * LDH);
  float* os = ss + BQ * LDF;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int pitch = H * D;
  const size_t base = (size_t)b * S * pitch;
  const int col0 = h * D;
  const int row_base = warp * 16;

  // q is scaled by D^-0.5 in fp32 and rounded to bf16, as the TPU kernels do.
  load_tile(qs, q + base, q0, S, pitch, col0, 0.125f, tid);
  for (int i = tid; i < BQ * LDF; i += THREADS) os[i] = 0.0f;
  __syncthreads();

  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qf[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wmma::load_matrix_sync(qf[kk], qs + row_base * LDH + kk * 16, LDH);

  float m_r[16];
  float l_r[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    m_r[r] = -INFINITY;
    l_r[r] = 0.0f;
  }

  for (int k0 = 0; k0 < S; k0 += BK) {
    load_tile(ks, k + base, k0, S, pitch, col0, 1.0f, tid);
    load_tile(vs, v + base, k0, S, pitch, col0, 1.0f, tid);
    __syncthreads();

    // logits of this warp's 16 rows against the 64 keys of the tile
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
      wmma::fill_fragment(sf, 0.0f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, ks + j * 16 * LDH + kk * 16, LDH);
        wmma::mma_sync(sf, qf[kk], kf, sf);
      }
      wmma::store_matrix_sync(ss + row_base * LDF + j * 16, sf, LDF,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax; lane owns key columns `lane` and `lane + 32`
    const int valid = min(BK, S - k0);
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int row = row_base + r;
      const float s0 = lane < valid ? ss[row * LDF + lane] : -INFINITY;
      const float s1 = lane + 32 < valid ? ss[row * LDF + lane + 32] : -INFINITY;
      const float m_new = fmaxf(m_r[r], warp_max(fmaxf(s0, s1)));
      const bf16 p0 = __float2bfloat16(expf(s0 - m_new));
      const bf16 p1 = __float2bfloat16(expf(s1 - m_new));
      ps[row * LDH + lane] = p0;
      ps[row * LDH + lane + 32] = p1;
      const float psum = warp_sum(__bfloat162float(p0) + __bfloat162float(p1));
      const float alpha = expf(m_r[r] - m_new);
      l_r[r] = l_r[r] * alpha + psum;
      m_r[r] = m_new;
      os[row * LDF + lane] *= alpha;
      os[row * LDF + lane + 32] *= alpha;
    }
    __syncwarp();

    // acc += p v
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> of;
      wmma::load_matrix_sync(of, os + row_base * LDF + j * 16, LDF,
                             wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(pf, ps + row_base * LDH + kk * 16, LDH);
        wmma::load_matrix_sync(vf, vs + kk * 16 * LDH + j * 16, LDH);
        wmma::mma_sync(of, pf, vf, of);
      }
      wmma::store_matrix_sync(os + row_base * LDF + j * 16, of, LDF,
                              wmma::mem_row_major);
    }
    __syncthreads();  // every warp is done with ks / vs before the next tile
  }

#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int row = row_base + r;
    const int g = q0 + row;
    if (g < S) {
      bf16* dst = out + base + (size_t)g * pitch + col0;
      dst[lane] = __float2bfloat16(os[row * LDF + lane] / l_r[r]);
      dst[lane + 32] = __float2bfloat16(os[row * LDF + lane + 32] / l_r[r]);
    }
  }
}

}  // namespace

cudaError_t gswm_launch_flash(const bf16* q, const bf16* k, const bf16* v,
                              bf16* out, int B, int S, int H,
                              cudaStream_t stream) {
  // 70 KiB is above the 48 KiB a launch gets without asking.
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (e != cudaSuccess) return e;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(q, k, v, out, S, H);
  return cudaGetLastError();
}

// q, k, v, out: (B, S, H * 64) bf16 device pointers.
extern "C" int gswm_flash_attn(const void* q, const void* k, const void* v,
                               void* out, int B, int S, int H, void* stream) {
  return static_cast<int>(gswm_launch_flash(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), B, S, H,
      static_cast<cudaStream_t>(stream)));
}
