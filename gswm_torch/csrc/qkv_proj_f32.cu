// Fused-qkv's q/k/v projections in float32: q, k, v (M, N) = x (M, C) @
// wq, wk, wv (N, C)^T, every product of float32 accuracy on the tensor cores
// (3xTF32 wgmma, hopper.cuh), every sum in fp32.  The float32 form of
// fused_qkv.cu's GEMM.
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
// 31.5 MB of q, k and v written, ~240 FLOP a byte.  A product of fp32
// accuracy on the tensor cores is three TF32 products (each operand split
// into a big and a small TF32 part), so the ceiling is a third of the dense
// TF32 rate, 494.5 / 3 = 165 TFLOP/s: 0.061 ms there, gswm_torch/roofline.py's
// bound (the operations roof).  The CUDA cores' FFMA (67 TFLOP/s, 0.15 ms),
// which the first design ran on and cuBLAS's fp32 GEMM runs on, cannot
// reach it.
//
// Design: a block computes a 128 x 128 output tile of one projection (grid z
// picks q, k or v) with two consumer warpgroups of 64 rows each, its
// accumulator 64 x 128 fp32 in registers (64 a thread), one
// wgmma.m64n128k8 a product.  Both operands are K-major (C runs along the
// row), as tf32 wgmma needs.  The reduction runs in slices of 32 (one
// 128-byte row of floats) through a ring of four stages filled by cp.async
// of 16 bytes, each row's 16-byte chunks swizzled (chunk c of row r at c ^
// (r % 8)), which is the 128-byte swizzle wgmma reads B in and spreads A's
// register loads over all 32 banks.  A slice of w lands as floats and is
// split in place (big over the float, small into a tile of its own), then
// fenced to the async proxy: the next slice's split runs while this slice's
// products do.  x's A fragments are loaded from its slice and split in
// registers, all four steps' first, then the slice's 12 products issued back
// to back behind one fence and retired by one wait.  Each slice's products go to a fresh accumulator that is added to
// the tile's in fp32 once they retire: the tensor cores' own sums run 32
// deep (12 products), the long sum over C is FADD.  (Summed in the tensor
// cores all along, C = 1280 missed the float32 bound against float64: their
// sums lose bits that FADD keeps.)  Rows past
// M and weight rows past N arrive as zeros (the copy's source size 0) and
// are not stored.  One block an SM (193 KB of shared memory, two
// accumulators of 64 registers a thread).  The output is not bit-equal to
// cuBLAS's FFMA GEMM: both are within the float32 bound of a float64
// product (chip_smoke.py phase 13a).

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using gswm_hopper::align_smem;
using gswm_hopper::cp_async_16;
using gswm_hopper::cp_async_commit;
using gswm_hopper::cp_async_wait;
using gswm_hopper::fence_async_smem;
using gswm_hopper::fence_regs;
using gswm_hopper::smem_desc_sw128;
using gswm_hopper::split_fragment;
using gswm_hopper::split_tf32;
using gswm_hopper::wgmma_3xtf32_rs;
using gswm_hopper::wgmma_commit;
using gswm_hopper::wgmma_fence;
using gswm_hopper::wgmma_wait;

constexpr int TILE = 128;                   // output rows and columns a block
constexpr int TK = 32;                      // reduction depth of a slice: one 128-byte row
constexpr int THREADS = 256;                // two consumer warpgroups
constexpr int TILE_BYTES = TILE * TK * 4;   // 16 KB: 128 rows of 128 bytes
constexpr int STAGE_BYTES = 3 * TILE_BYTES; // x, w's big part, w's small part
constexpr int STAGES = 4;
constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES;
static_assert(SMEM_BYTES <= 232448, "the ring fits one block's shared memory");

// Rows [row0, row0 + TILE) of a K-major (rows, C) array, columns [k0, k0 +
// TK), into a tile of 128-byte rows, chunk c of row r at c ^ (r % 8); rows
// at or past `rows` as zeros.
__device__ __forceinline__ void stage_rows(unsigned char* dst, const float* __restrict__ src,
                                           int rows, int row0, int C, int k0) {
#pragma unroll
  for (int it = 0; it < TILE * (TK / 4) / THREADS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    const int r = i / (TK / 4);
    const int c = i % (TK / 4);
    const bool in = row0 + r < rows;
    cp_async_16(dst + r * 128 + ((c ^ (r % 8)) * 16),
                src + (size_t)(in ? row0 + r : 0) * C + k0 + c * 4, in ? 16 : 0);
  }
}

// w's slice in a stage split in place: big over the float, small into its
// own tile.  The swizzle moves whole chunks, so an elementwise pass does not
// care where an element sits.
__device__ __forceinline__ void split_w(unsigned char* stage) {
  float* wbig = reinterpret_cast<float*>(stage + TILE_BYTES);
  float* wsmall = reinterpret_cast<float*>(stage + 2 * TILE_BYTES);
#pragma unroll
  for (int it = 0; it < TILE * TK / THREADS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    uint32_t big, small;
    split_tf32(wbig[i], big, small);
    wbig[i] = __uint_as_float(big);
    wsmall[i] = __uint_as_float(small);
  }
  fence_async_smem();  // the split parts, written by this thread, to wgmma
}

__global__ void __launch_bounds__(THREADS, 1)
qkv_proj_f32_kernel(const float* __restrict__ x, const float* __restrict__ wq,
                    const float* __restrict__ wk, const float* __restrict__ wv,
                    float* __restrict__ q, float* __restrict__ k, float* __restrict__ v,
                    int M, int C, int N) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  const float* w = blockIdx.z == 0 ? wq : (blockIdx.z == 1 ? wk : wv);
  float* y = blockIdx.z == 0 ? q : (blockIdx.z == 1 ? k : v);
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int m0 = blockIdx.y * TILE;
  const int n0 = blockIdx.x * TILE;
  const int slices = C / TK;
  const int r_lo = wg * 64 + warp * 16 + g;  // this thread's rows of the tile: r_lo, r_lo + 8

  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

  auto stage = [&](int s) { return smem + (s % STAGES) * STAGE_BYTES; };
  auto load = [&](int s) {
    if (s < slices) {
      stage_rows(stage(s), x, M, m0, C, s * TK);
      stage_rows(stage(s) + TILE_BYTES, w, N, n0, C, s * TK);
    }
    cp_async_commit();  // one group a slice, empty past the last
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load(s);
  cp_async_wait<STAGES - 2>();  // slice 0
  __syncthreads();
  split_w(stage(0));
  __syncthreads();
  for (int s = 0; s < slices; ++s) {
    // the stage of slice s - 1: its products retired before the barrier
    // that ended it
    load(s + STAGES - 1);
    unsigned char* xs = stage(s);
    const float* xf = reinterpret_cast<const float*>(xs);
    // the slice's A fragments loaded and split, then its 12 products issued
    // back to back behind one fence
    uint32_t fb[TK / 8][4], fs[TK / 8][4];
#pragma unroll
    for (int ks = 0; ks < TK / 8; ++ks) {
      // A[r][8 ks + t] and A[r][8 ks + t + 4]: chunk 2 ks and 2 ks + 1 of row r
      const int c0 = ((2 * ks) ^ g) * 4 + t4;
      const int c1 = ((2 * ks + 1) ^ g) * 4 + t4;
      const float* lo = xf + r_lo * TK;
      const float* hi = lo + 8 * TK;  // (r_lo + 8) % 8 == g: the same swizzle
      split_fragment(lo[c0], hi[c0], lo[c1], hi[c1], fb[ks], fs[ks]);
    }
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < TK / 8; ++ks) {
      const uint64_t off = ks * gswm_hopper::DESC_K_STEP;
      wgmma_3xtf32_rs<TILE>(part, fb[ks], fs[ks], smem_desc_sw128(xs + TILE_BYTES) + off,
                            smem_desc_sw128(xs + 2 * TILE_BYTES) + off, ks > 0);
    }
    wgmma_commit();
    // while they run: the next slice's w split, in another stage
    if (s + 1 < slices) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();
      split_w(stage(s + 1));
    }
    wgmma_wait<0>();
    fence_regs(part);
    fence_regs(fb);
    fence_regs(fs);
    // the slice's sum, 32 deep, added in fp32: the tensor cores' own sums
    // stay short
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
    __syncthreads();  // the next slice's split seen by all; stage s free
  }

  // accumulator fragment: acc[4 j + e] at row r_lo (e < 2) or r_lo + 8,
  // column 8 j + 2 t4 + (e % 2)
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = m0 + r_lo + 8 * half;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {
      const int col = n0 + 8 * j + 2 * t4;
      if (col < N)
        *reinterpret_cast<float2*>(y + (size_t)row * N + col) =
            make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
    }
  }
}

}  // namespace

// q, k, v (M, N) = x (M, C) @ wq, wk, wv (N, C)^T, all float32 and
// contiguous, 16-byte aligned; C and N multiples of 64 (C % 32 == 0 is what
// the slices need), any M >= 1.
extern "C" int gswm_qkv_proj_f32(const void* x, const void* wq, const void* wk,
                                 const void* wv, void* q, void* k, void* v, int M, int C,
                                 int N, void* stream) {
  if (M < 1 || C < 64 || C % 64 || N < 64 || N % 64)
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t e = cudaFuncSetAttribute(
      qkv_proj_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((N + TILE - 1) / TILE, (M + TILE - 1) / TILE, 3);
  qkv_proj_f32_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(wq),
      static_cast<const float*>(wk), static_cast<const float*>(wv), static_cast<float*>(q),
      static_cast<float*>(k), static_cast<float*>(v), M, C, N);
  return static_cast<int>(cudaGetLastError());
}
