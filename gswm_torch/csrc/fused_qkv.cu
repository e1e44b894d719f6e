// Fused-qkv self-attention: q/k/v projections in a hand-written GEMM, then
// the split flash-attention kernel of flash_split.cu at D = 64.
//
// Replaces the Pallas TPU kernel gswm/ops/attention.py:
// flash_attention_fused_qkv (body _fused_qkv_kernel, softmax core
// _attend_kv_loop), which the UNet routes its self-attention to at 256..2304
// tokens: levels 1 (1024 tokens, C=640, 10 heads) and 2 (256 tokens,
// C=1280, 20 heads) at 512x512.  The TPU kernel projects x inside its own
// body to avoid relayout copies between the projection and the attention;
// here the projection is a separate launch that writes q, k and v directly
// in the (B, S, H*64) layout the core reads, so no relayout exists either.
//
// What bounds it on an H100: at level 1, batch 4, the projections are
// 4096 x 640 x 1920 x 2 = 10 GFLOP over 5 MB of x and 2.5 MB of weights, and
// the attention 4 * 10 * 1024^2 * 64 * 4 = 10.7 GFLOP; both are well above
// the ~295 FLOP a byte where the tensor cores, not memory, are the limit.
// Design: the GEMM gives each block of four warps a 64x64 output tile of one
// of the three projections (grid z picks q, k or v), stages 64x32 tiles of x
// and of the weight in shared memory, multiplies them with WMMA
// (16x16x16 bf16, fp32 accumulate; each warp a 32x32 sub-tile) and rounds
// the fp32 result to bf16 on the store, as the TPU kernel does.  Weights are
// taken in torch.nn.Linear's (out, in) layout, so x @ W^T like F.linear.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "flash_core.cuh"

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TM = 64;        // output rows per block
constexpr int TN = 64;        // output columns per block
constexpr int TK = 32;        // reduction step
constexpr int LDA = TK + 8;   // bf16 row pitch of the staged tiles (40)
constexpr int LDC = TN + 4;   // fp32 row pitch of the output tile (68)
constexpr int THREADS = 128;  // four warps, 2 x 2 over the 64x64 tile

// y = x @ w^T for the projection selected by blockIdx.z.
// x: (M, C); w*: (N, C); q/k/v: (M, N); C % 64 == 0, N % 64 == 0.
__global__ void __launch_bounds__(THREADS)
qkv_proj_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wq,
                const bf16* __restrict__ wk, const bf16* __restrict__ wv,
                bf16* __restrict__ q, bf16* __restrict__ k,
                bf16* __restrict__ v, int M, int C, int N) {
  __shared__ __align__(128) bf16 as[TM * LDA];
  __shared__ __align__(128) bf16 bs[TN * LDA];
  __shared__ __align__(128) float cs[TM * LDC];

  const bf16* w = blockIdx.z == 0 ? wq : (blockIdx.z == 1 ? wk : wv);
  bf16* y = blockIdx.z == 0 ? q : (blockIdx.z == 1 ? k : v);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int m0 = blockIdx.y * TM;
  const int n0 = blockIdx.x * TN;
  const int wm = (warp >> 1) * 32;
  const int wn = (warp & 1) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < C; k0 += TK) {
    // 64 rows x 32 columns of x and of w: 256 16-byte chunks each
    for (int i = tid; i < TM * (TK / 8); i += THREADS) {
      const int r = i / (TK / 8);
      const int c = (i % (TK / 8)) * 8;
      const int g = m0 + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (g < M) val = *reinterpret_cast<const uint4*>(x + (size_t)g * C + k0 + c);
      *reinterpret_cast<uint4*>(as + r * LDA + c) = val;
      *reinterpret_cast<uint4*>(bs + r * LDA + c) =
          *reinterpret_cast<const uint4*>(w + (size_t)(n0 + r) * C + k0 + c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bf[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(af[i], as + (wm + i * 16) * LDA + kk * 16, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bf[j], bs + (wn + j * 16) * LDA + kk * 16, LDA);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(cs + (wm + i * 16) * LDC + wn + j * 16, acc[i][j],
                              LDC, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < TM * (TN / 2); i += THREADS) {
    const int r = i / (TN / 2);
    const int c = (i % (TN / 2)) * 2;
    const int g = m0 + r;
    if (g < M) {
      *reinterpret_cast<__nv_bfloat162*>(y + (size_t)g * N + n0 + c) =
          __floats2bfloat162_rn(cs[r * LDC + c], cs[r * LDC + c + 1]);
    }
  }
}

}  // namespace

// x: (B, S, C) bf16; wq/wk/wv: (H*64, C) bf16; q/k/v: (B, S, H*64) bf16
// scratch the caller allocates; out: (B, S, H*64) bf16.
extern "C" int gswm_fused_qkv_attn(const void* x, const void* wq, const void* wk,
                                   const void* wv, void* q, void* k, void* v,
                                   void* out, int B, int S, int C, int H,
                                   void* stream) {
  const int M = B * S;
  const int N = H * 64;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(N / TN, (M + TM - 1) / TM, 3);
  qkv_proj_kernel<<<grid, THREADS, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wq),
      static_cast<const bf16*>(wk), static_cast<const bf16*>(wv),
      static_cast<bf16*>(q), static_cast<bf16*>(k), static_cast<bf16*>(v), M, C,
      N);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(gswm_launch_flash_split(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), B, S, S, H, 64, st));
}
