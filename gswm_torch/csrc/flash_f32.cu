// Flash attention in float32 at head dim 64: out = softmax(q k^T 64^-0.5) v
// on (B, Sq, H, 64) q and out, (B, Sk, H, 64) k and v, a row pitch of H *
// 64 floats, any Sq and Sk.  Every product, sum and exponential in fp32,
// the softmax with a running max; nothing is rounded to a narrower type.
//
// Replaces, in float32, the attention of the Pallas TPU kernels that take
// fp32 and then keep the running max (gswm/ops/attention.py:720-721,
// use_max = x.dtype != bfloat16):
//   * gswm/ops/attention.py:689 flash_attention_fused_qkv (_fused_qkv_kernel,
//     _attend_kv_loop): its core, after qkv_proj_f32.cu's projections (SD
//     2.x's levels 1 and 2 at 512x512: 1024 tokens of 10 heads, 256 of 20);
//   * gswm/ops/attention.py:1211 flash_attention_cres, which K2
//     (ops.attention.flash_attention) serves: the UNet's level 0, 4096
//     tokens of 5 heads at 512x512 (the JAX package's default there is the
//     plain-XLA xla_flash_attention, which clamps its logits at 60 and
//     drops the max in every dtype; this kernel keeps the exact softmax, as
//     every kernel of the port does);
//   * gswm/ops/attention.py:414 flash_attention at d = 64 without the
//     log-sum-exp (ops.attention.flash_attention_split).
//
// What bounds it on an H100: (B, S, H) = (4, 4096, 5) is 4 * B * H * S^2 *
// 64 = 85.9 GFLOP over 84 MB of q, k, v and out, ~1,000 FLOP a byte, so the
// products bound it.  Products of fp32 accuracy on the tensor cores are
// 3xTF32 (each operand split into a big and a small TF32 part, three
// products), a third of the dense TF32 rate, 165 TFLOP/s: 0.52 ms there,
// gswm_torch/roofline.py's bound.  This design runs on the CUDA cores, whose
// FFMA peak of 67 TFLOP/s (1.28 ms there) is its own ceiling.  The B * H *
// S^2 exponentials (ex2.approx, relative error ~2^-22) take a sixth of the
// FFMA time.
//
// Design: right and simple first.  A block owns 64 query rows of one (b, h)
// and walks the keys 64 at a time; 256 threads, thread (ty, tx) = (thread /
// 16, thread % 16) owning rows ty + 16 i (i < 4).  q's tile stays in shared
// memory; k's and v's tiles of 64 keys x 64 columns (16 KB each) come by
// cp.async of 16 bytes, two stages deep, the next tile's copies in flight
// while this one is computed; rows past Sq and Sk arrive as zeros.
//   * Logits: a thread computes keys tx + 16 j (j < 4) of its four rows,
//     four d at a time from 16-byte loads of q and k rows: 64 FFMA per 8
//     loads.  Keys at or past Sk are masked to -inf.
//   * Online softmax in registers: a row's tile max is a shuffle reduction
//     over the 16 threads that share the row; its running max m, the
//     rescale exp2((m_old - m) c) and p = exp2((s - m) c), c = 64^-0.5
//     log2(e), are computed alike by all 16; each keeps its own share of
//     the row sum, rescaled with the row, and the shares are summed once at
//     the end.  p goes to a 64 x 64 tile in shared memory.
//   * p v: a thread owns output columns 4 tx .. 4 tx + 3 of its four rows
//     and reads p (16 bytes of its rows) and v (16 bytes of a key's row)
//     four keys at a time: 64 FFMA per 8 loads.
// Rows of q, k and v hold 64 floats and 4 of padding (272 bytes), p's 64
// and 16 (320): each 16-byte load of eight neighbouring threads falls in
// eight distinct bank groups, and p's stores of a warp's two rows miss each
// other's banks.  Two barriers a tile: before the logits (the tile landed,
// everyone is done with the last p) and before p v (p written).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using gswm_hopper::cp_async_16;
using gswm_hopper::cp_async_commit;
using gswm_hopper::cp_async_wait;
using gswm_hopper::exp2_approx;

constexpr int D = 64;            // the head dim
constexpr int BM = 64;           // query rows a block
constexpr int BN = 64;           // keys a tile
constexpr int PITCH = D + 4;     // floats a staged q, k or v row
constexpr int P_PITCH = BN + 16; // floats a row of p
constexpr int THREADS = 256;
constexpr int ROWS = BM / 16;    // rows a thread owns
constexpr int KEYS = BN / 16;    // logits of a row a thread computes
constexpr int CHUNKS = BM * D / 4;  // 16-byte pieces of a tile
constexpr float LOG2E = 1.4426950408889634f;

struct Smem {
  float q[BM * PITCH];
  float k[2][BN * PITCH];
  float v[2][BN * PITCH];
  float p[BM * P_PITCH];
};
constexpr int SMEM_BYTES = (int)sizeof(Smem);  // 107,520: two blocks an SM

// Rows [row0, row0 + 64) of one head of a (B, S, H, 64) array (`base` at
// batch b, head h; `pitch` floats between rows), into a staged tile; rows at
// or past S as zeros.
__device__ __forceinline__ void stage_tile(float* dst, const float* __restrict__ base,
                                           int row0, int S, size_t pitch) {
#pragma unroll
  for (int it = 0; it < CHUNKS / THREADS; ++it) {
    const int c = threadIdx.x + it * THREADS;
    const int r = c / (D / 4);
    const int col = (c % (D / 4)) * 4;
    const bool in = row0 + r < S;
    cp_async_16(dst + r * PITCH + col, base + (in ? row0 + r : 0) * pitch + col,
                in ? 16 : 0);
  }
}

// the largest / the sum over the 16 threads that share a row
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__global__ void __launch_bounds__(THREADS, 2)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int Sq, int Sk,
                 int H) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t pitch = (size_t)H * D;
  const float* qb = q + (size_t)b * Sq * pitch + h * D;
  const float* kb = k + (size_t)b * Sk * pitch + h * D;
  const float* vb = v + (size_t)b * Sk * pitch + h * D;
  const float c = LOG2E * 0.125f;  // 64^-0.5 log2(e)
  const int tiles = (Sk + BN - 1) / BN;

  float o[ROWS][4], m[ROWS], l[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.0f;
  }

  stage_tile(sm.q, qb, q0, Sq, pitch);
  stage_tile(sm.k[0], kb, 0, Sk, pitch);
  stage_tile(sm.v[0], vb, 0, Sk, pitch);
  cp_async_commit();
  for (int t = 0; t < tiles; ++t) {
    const int cur = t % 2;
    cp_async_wait<0>();  // this thread's copies of tile t have landed
    __syncthreads();     // every thread's; and everyone is done with p and
                         // with tile t - 1's stage, which tile t + 1 takes
    if (t + 1 < tiles) {
      stage_tile(sm.k[cur ^ 1], kb, (t + 1) * BN, Sk, pitch);
      stage_tile(sm.v[cur ^ 1], vb, (t + 1) * BN, Sk, pitch);
    }
    cp_async_commit();

    // logits s[i][j] of row ty + 16 i, key tx + 16 j
    float s[ROWS][KEYS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < KEYS; ++j) s[i][j] = 0.0f;
    const float* ks = sm.k[cur];
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 a[ROWS], bk[KEYS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
        a[i] = *reinterpret_cast<const float4*>(sm.q + (ty + 16 * i) * PITCH + d);
#pragma unroll
      for (int j = 0; j < KEYS; ++j)
        bk[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * PITCH + d);
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < KEYS; ++j) {
          s[i][j] = fmaf(a[i].x, bk[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, bk[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, bk[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, bk[j].w, s[i][j]);
        }
    }

    // online softmax; every tile holds a key below Sk, so each row's tile
    // max, and with it m, is finite from the first tile on
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < KEYS; ++j) {
        if (t * BN + tx + 16 * j >= Sk) s[i][j] = -INFINITY;
        tmax = fmaxf(tmax, s[i][j]);
      }
      const float mn = fmaxf(m[i], row_max(tmax));
      const float alpha = exp2_approx((m[i] - mn) * c);  // 0 on the first tile
      m[i] = mn;
      l[i] *= alpha;
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][e] *= alpha;
      float* prow = sm.p + (ty + 16 * i) * P_PITCH;
#pragma unroll
      for (int j = 0; j < KEYS; ++j) {
        const float p = exp2_approx((s[i][j] - mn) * c);
        l[i] += p;
        prow[tx + 16 * j] = p;
      }
    }
    __syncthreads();  // p is written

    const float* vs = sm.v[cur];
#pragma unroll 4
    for (int j = 0; j < BN; j += 4) {
      float4 pa[ROWS], vv[4];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
        pa[i] = *reinterpret_cast<const float4*>(sm.p + (ty + 16 * i) * P_PITCH + j);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        vv[e] = *reinterpret_cast<const float4*>(vs + (j + e) * PITCH + 4 * tx);
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float pe[4] = {pa[i].x, pa[i].y, pa[i].z, pa[i].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          o[i][0] = fmaf(pe[e], vv[e].x, o[i][0]);
          o[i][1] = fmaf(pe[e], vv[e].y, o[i][1]);
          o[i][2] = fmaf(pe[e], vv[e].z, o[i][2]);
          o[i][3] = fmaf(pe[e], vv[e].w, o[i][3]);
        }
      }
    }
  }

  float* ob = out + (size_t)b * Sq * pitch + h * D;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const float inv = 1.0f / row_sum(l[i]);
    const int row = q0 + ty + 16 * i;
    if (row < Sq)
      *reinterpret_cast<float4*>(ob + row * pitch + 4 * tx) =
          make_float4(o[i][0] * inv, o[i][1] * inv, o[i][2] * inv, o[i][3] * inv);
  }
}

}  // namespace

// q, out: (B, Sq, H, D) float32; k, v: (B, Sk, H, D) float32; contiguous,
// 16-byte aligned; D == 64, Sq, Sk >= 1.
extern "C" int gswm_flash_f32(const void* q, const void* k, const void* v, void* out, int B,
                              int Sq, int Sk, int H, int D_, void* stream) {
  if (D_ != D || B < 1 || Sq < 1 || Sk < 1 || H < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      flash_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Sq + BM - 1) / BM, H, B);
  flash_f32_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Sq, Sk, H);
  return static_cast<int>(cudaGetLastError());
}
