// Fused-qkv self-attention: q/k/v projections in a hand-written GEMM, then
// the D = 64 flash-attention kernel of flash_hopper.cu.
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
// So the GEMM is built to keep wgmma fed.  A block takes a 128 x 128 output
// tile of one projection (grid z picks q, k or v).  One producer thread
// keeps a ring of STAGES (x tile, weight tile) pairs, 128 x 64 each, in
// flight by TMA; both are K-major (x is (M, C), torch.nn.Linear's weight is
// (N, C): y = x @ w^T like F.linear), rows of 128 bytes under the 128-byte
// swizzle.  Two consumer warpgroups each own 64 output rows: four
// wgmma m64n128k16 per stage, operands read from shared memory, the fp32
// accumulator in registers, one wgmma group kept in flight while the stage
// before it is handed back.  Rows past M arrive as zeros and are not
// stored; the fp32 result is rounded to bf16 on the store, as the TPU
// kernel does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_core.cuh"
#include "hopper.cuh"

namespace {

using namespace gswm_hopper;

constexpr int TM = 128;      // output rows per block: 64 per consumer warpgroup
constexpr int TN = 128;      // output columns per block
constexpr int TK = ROW_ELEMS;  // reduction step: one swizzled row
constexpr int STAGES = 4;
constexpr int CONSUMERS = 2;   // consumer warpgroups
constexpr int THREADS = (1 + CONSUMERS) * 128;
constexpr int TILE_BYTES = TM * TK * (int)sizeof(bf16);  // x tile = weight tile
static_assert(TM == TN && TM == CONSUMERS * 64, "square tiles, 64 rows a warpgroup");

struct Smem {
  bf16 x[STAGES][TM * TK];
  bf16 w[STAGES][TN * TK];
  uint64_t full[STAGES];   // the stage's two tiles have landed
  uint64_t empty[STAGES];  // every consumer warp is done with the stage
};
constexpr int SMEM_BYTES = (int)sizeof(Smem) + SWIZZLE_SPAN;  // room to align

// y = x @ w^T for the projection selected by blockIdx.z.
// x: (M, C); w*: (N, C); q/k/v: (M, N); C % 64 == 0, N % 64 == 0.
__global__ void __launch_bounds__(THREADS, 1)
qkv_proj_kernel(const __grid_constant__ CUtensorMap map_x,
                const __grid_constant__ CUtensorMap map_wq,
                const __grid_constant__ CUtensorMap map_wk,
                const __grid_constant__ CUtensorMap map_wv, bf16* __restrict__ q,
                bf16* __restrict__ k, bf16* __restrict__ v, int M, int C, int N) {
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(align_smem(smem_raw));

  const int group = threadIdx.x >> 7;  // 0: producer, 1..: consumers
  const int m0 = blockIdx.y * TM;
  const int n0 = blockIdx.x * TN;
  const int steps = C / TK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], CONSUMERS * 4);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (group == 0) {
    reg_dec<40>();
    if (threadIdx.x == 0) {
      const CUtensorMap* map_w =
          blockIdx.z == 0 ? &map_wq : (blockIdx.z == 1 ? &map_wk : &map_wv);
      int stage = 0;
      uint32_t phase = 0;
      for (int i = 0; i < steps; ++i) {
        mbar_wait(&sm.empty[stage], phase ^ 1);
        mbar_expect_tx(&sm.full[stage], 2 * TILE_BYTES);
        tma_load_2d(sm.x[stage], &map_x, &sm.full[stage], i * TK, m0);
        tma_load_2d(sm.w[stage], map_w, &sm.full[stage], i * TK, n0);
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
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

    int stage = 0;
    uint32_t phase = 0;
    int prev = -1;  // the stage whose wgmma group is still in flight
    for (int i = 0; i < steps; ++i) {
      mbar_wait(&sm.full[stage], phase);
      const uint64_t da = smem_desc_sw128(sm.x[stage] + cw * 64 * TK);
      const uint64_t db = smem_desc_sw128(sm.w[stage]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk)
        wgmma_m64n128k16_ss(acc, da + kk * DESC_K_STEP, db + kk * DESC_K_STEP, 1);
      wgmma_commit();
      wgmma_wait<1>();  // the group before this one is done: its stage is free
      if (prev >= 0 && lane == 0) mbar_arrive(&sm.empty[prev]);
      prev = stage;
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);

    bf16* y = blockIdx.z == 0 ? q : (blockIdx.z == 1 ? k : v);
    const int r_lo = m0 + cw * 64 + warp * 16 + (lane >> 2);
    const int r_hi = r_lo + 8;
#pragma unroll
    for (int j = 0; j < TN / 8; ++j) {
      const int col = n0 + j * 8 + 2 * (lane & 3);
      if (col < N) {
        if (r_lo < M)
          *reinterpret_cast<__nv_bfloat162*>(y + (size_t)r_lo * N + col) =
              __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
        if (r_hi < M)
          *reinterpret_cast<__nv_bfloat162*>(y + (size_t)r_hi * N + col) =
              __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  }
}

// q, k, v (M, N) = x (M, C) @ wq, wk, wv (N, C)^T.
cudaError_t launch_qkv_proj(const bf16* x, const bf16* wq, const bf16* wk, const bf16* wv,
                            bf16* q, bf16* k, bf16* v, int M, int C, int N,
                            cudaStream_t stream) {
  if (M < 1 || C < TK || C % TK || N < 64 || N % 64) return cudaErrorInvalidValue;
  CUtensorMap map_x, map_w[3];
  const cuuint64_t stride[1] = {(cuuint64_t)C * sizeof(bf16)};
  const cuuint32_t box[2] = {TK, TM};
  const cuuint64_t dims_x[2] = {(cuuint64_t)C, (cuuint64_t)M};
  const cuuint64_t dims_w[2] = {(cuuint64_t)C, (cuuint64_t)N};
  cudaError_t e = encode_map(&map_x, x, 2, dims_x, stride, box);
  const bf16* ws[3] = {wq, wk, wv};
  for (int i = 0; i < 3 && e == cudaSuccess; ++i)
    e = encode_map(&map_w[i], ws[i], 2, dims_w, stride, box);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(qkv_proj_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SMEM_BYTES);
  if (e != cudaSuccess) return e;
  dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM, 3);
  qkv_proj_kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(map_x, map_w[0], map_w[1],
                                                         map_w[2], q, k, v, M, C, N);
  return cudaGetLastError();
}

}  // namespace

// The projections alone.  x: (M, C) bf16; wq/wk/wv: (N, C) bf16; q/k/v:
// (M, N) bf16; C and N multiples of 64.
extern "C" int gswm_qkv_proj(const void* x, const void* wq, const void* wk, const void* wv,
                             void* q, void* k, void* v, int M, int C, int N, void* stream) {
  return static_cast<int>(launch_qkv_proj(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wq),
      static_cast<const bf16*>(wk), static_cast<const bf16*>(wv), static_cast<bf16*>(q),
      static_cast<bf16*>(k), static_cast<bf16*>(v), M, C, N,
      static_cast<cudaStream_t>(stream)));
}

// x: (B, S, C) bf16; wq/wk/wv: (H*64, C) bf16; q/k/v: (B, S, H*64) bf16
// scratch the caller allocates; out: (B, S, H*64) bf16.
extern "C" int gswm_fused_qkv_attn(const void* x, const void* wq, const void* wk,
                                   const void* wv, void* q, void* k, void* v,
                                   void* out, int B, int S, int C, int H,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = launch_qkv_proj(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wq),
      static_cast<const bf16*>(wk), static_cast<const bf16*>(wv), static_cast<bf16*>(q),
      static_cast<bf16*>(k), static_cast<bf16*>(v), B * S, C, H * 64, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(gswm_launch_flash_split(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), B, S, S, H, 64, st));
}
