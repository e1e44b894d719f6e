// Fused-qkv's q/k/v projections in float32: q, k, v (M, N) = x (M, C) @
// wq, wk, wv (N, C)^T, every product and sum in fp32 (FFMA), nothing
// rounded to a narrower type.  The float32 form of fused_qkv.cu's GEMM.
//
// Replaces, in float32, the projection step of the Pallas TPU kernel
// gswm/ops/attention.py:689 flash_attention_fused_qkv (_fused_qkv_kernel),
// which takes fp32 as it takes bf16 (its dots accumulate in fp32 from the
// input dtype): the UNet's self-attention at 256..2304 tokens, levels 1
// (1024 tokens, C = N = 640) and 2 (256 tokens, C = N = 1280) of SD 2.x at
// 512x512.  ops.attention.fused_qkv_attention launches it and then
// flash_f32.cu's core; ops.attention.qkv_projection launches it alone.
//
// What bounds it on an H100: at level 1, batch 4, the three products are
// 2 * 4096 * 640 * 1920 = 10.1 GFLOP over 10.5 MB of x and weights read and
// 31.5 MB of q, k and v written, ~240 FLOP a byte.  Products of fp32
// accuracy have two ceilings on the card: the CUDA cores' FFMA at 67 TFLOP/s
// (this design's own ceiling, 0.15 ms there), and 3xTF32 on the tensor
// cores (each operand split into a big and a small TF32 part, three
// products) at a third of the dense TF32 rate, 494.5 / 3 = 165 TFLOP/s,
// which gswm_torch/roofline.py takes as the bound (0.061 ms there, the
// operations roof).  wgmma has no fp32 form, only kind::tf32, whose ~10-bit
// mantissa alone misses float32 by three orders of magnitude.
//
// Design: right and simple first, FFMA on the CUDA cores.  A block computes
// a 128 x 128 output tile of one projection (grid z picks q, k or v) with
// 256 threads, each owning 8 x 8 outputs: rows ty + 16 i and columns tx +
// 16 j (tx, ty = thread % 16, thread / 16).  x and the weight are both
// K-major (C runs along the row), and 16-deep slices of both go to shared
// memory as they lie, by cp.async of 16 bytes, two stages deep, so the next
// slice lands while this one is multiplied.  A staged row holds 16 floats
// and 4 of padding (80 bytes): the eight rows a quarter warp reads with one
// 16-byte load then fall in eight distinct bank groups.  Each thread reads
// four k at a time, one 16-byte load per row and per column it owns, and
// does 256 FFMA on them: 8 FFMA a shared-memory load.  Rows past M and
// weight rows past N arrive as zeros (the copy's source size 0) and are not
// stored.  Every sum runs over k in order, one FFMA a term.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using gswm_hopper::cp_async_16;
using gswm_hopper::cp_async_commit;
using gswm_hopper::cp_async_wait;

constexpr int TILE = 128;         // output rows and columns a block
constexpr int TK = 16;            // reduction depth of a stage
constexpr int PITCH = TK + 4;     // floats a staged row: 80 bytes
constexpr int THREADS = 256;      // 16 x 16 threads
constexpr int PER = TILE / 16;    // rows (and columns) a thread owns
constexpr int CHUNKS = TILE * TK / 4;  // 16-byte pieces of a staged tile

struct Stage {
  float x[TILE * PITCH];
  float w[TILE * PITCH];
};

// Rows [row0, row0 + TILE) of a K-major (rows, C) array, columns [k0, k0 +
// TK), into a staged tile; rows at or past `rows` as zeros.
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src,
                                           int rows, int row0, int C, int k0) {
#pragma unroll
  for (int it = 0; it < CHUNKS / THREADS; ++it) {
    const int c = threadIdx.x + it * THREADS;
    const int r = c / (TK / 4);
    const int col = (c % (TK / 4)) * 4;
    const bool in = row0 + r < rows;
    cp_async_16(dst + r * PITCH + col, src + (size_t)(in ? row0 + r : 0) * C + k0 + col,
                in ? 16 : 0);
  }
}

__global__ void __launch_bounds__(THREADS)
qkv_proj_f32_kernel(const float* __restrict__ x, const float* __restrict__ wq,
                    const float* __restrict__ wk, const float* __restrict__ wv,
                    float* __restrict__ q, float* __restrict__ k, float* __restrict__ v,
                    int M, int C, int N) {
  __shared__ __align__(16) Stage st[2];
  const float* w = blockIdx.z == 0 ? wq : (blockIdx.z == 1 ? wk : wv);
  float* y = blockIdx.z == 0 ? q : (blockIdx.z == 1 ? k : v);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * TILE;
  const int n0 = blockIdx.x * TILE;
  const int steps = C / TK;

  float acc[PER][PER];
#pragma unroll
  for (int i = 0; i < PER; ++i)
#pragma unroll
    for (int j = 0; j < PER; ++j) acc[i][j] = 0.0f;

  stage_rows(st[0].x, x, M, m0, C, 0);
  stage_rows(st[0].w, w, N, n0, C, 0);
  cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    // stage s % 2 was last read in step s - 1, which every thread left
    // through the barrier at its end
    if (s + 1 < steps) {
      stage_rows(st[(s + 1) % 2].x, x, M, m0, C, (s + 1) * TK);
      stage_rows(st[(s + 1) % 2].w, w, N, n0, C, (s + 1) * TK);
    }
    cp_async_commit();  // (an empty group in the last step)
    cp_async_wait<1>();  // this thread's copies of stage s have landed
    __syncthreads();     // and every thread's
    const float* xs = st[s % 2].x;
    const float* ws = st[s % 2].w;
#pragma unroll
    for (int kk = 0; kk < TK; kk += 4) {
      float4 a[PER], b[PER];
#pragma unroll
      for (int i = 0; i < PER; ++i)
        a[i] = *reinterpret_cast<const float4*>(xs + (ty + 16 * i) * PITCH + kk);
#pragma unroll
      for (int j = 0; j < PER; ++j)
        b[j] = *reinterpret_cast<const float4*>(ws + (tx + 16 * j) * PITCH + kk);
#pragma unroll
      for (int i = 0; i < PER; ++i)
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
        }
    }
    __syncthreads();  // every thread is done with stage s % 2
  }

#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row < M) {
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int col = n0 + tx + 16 * j;
        if (col < N) y[(size_t)row * N + col] = acc[i][j];
      }
    }
  }
}

}  // namespace

// q, k, v (M, N) = x (M, C) @ wq, wk, wv (N, C)^T, all float32 and
// contiguous, 16-byte aligned; C and N multiples of 64 (C % 16 == 0 is what
// the staging needs), any M >= 1.
extern "C" int gswm_qkv_proj_f32(const void* x, const void* wq, const void* wk,
                                 const void* wv, void* q, void* k, void* v, int M, int C,
                                 int N, void* stream) {
  if (M < 1 || C < 64 || C % 64 || N < 64 || N % 64)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + TILE - 1) / TILE, (M + TILE - 1) / TILE, 3);
  qkv_proj_f32_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(wq),
      static_cast<const float*>(wk), static_cast<const float*>(wv), static_cast<float*>(q),
      static_cast<float*>(k), static_cast<float*>(v), M, C, N);
  return static_cast<int>(cudaGetLastError());
}
