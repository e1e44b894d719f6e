// Shared pieces of the flash-attention kernels: the declarations of the split
// launcher (flash_split.cu), which the fused-qkv kernel (fused_qkv.cu)
// launches after its projections, and of the D = 64 launcher
// (flash_hopper.cu) it dispatches to; and the device helpers that
// flash_split.cu (D = 128 ... 512) and flash_transposed.cu both use.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// q, out: (B, Sq, H, D); k, v: (B, Sk, H, D); bf16, natural layout, rows
// 16-byte aligned; D a multiple of 64 up to 512.  out = softmax(q k^T /
// sqrt(D)) v per (batch, head), exact softmax (running max).
cudaError_t gswm_launch_flash_split(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                    const __nv_bfloat16* v, __nv_bfloat16* out,
                                    int B, int Sq, int Sk, int H, int D,
                                    cudaStream_t stream);

// The same function at D = 64 with a base pointer per operand and ld_q,
// ld_kv, ld_o elements (multiples of 8) between rows of q, of k and v, and
// of out; head h starts at column h * 64 of each.
cudaError_t gswm_launch_flash_hopper(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                     const __nv_bfloat16* v, __nv_bfloat16* out,
                                     int B, int Sq, int Sk, int H, int ld_q, int ld_kv,
                                     int ld_o, cudaStream_t stream);

namespace gswm_flash {

typedef __nv_bfloat16 bf16;

// The tiling both kernels share: one block of eight warps takes BQ query
// rows and walks BK-key tiles; each warp computes a 16 x 16 tile of logits
// (2 row groups x 4 key groups) and owns BQ / WARPS softmax rows.
constexpr int BQ = 32;
constexpr int BK = 64;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int LDS = BK + 4;  // fp32 logits row pitch
constexpr int LDP = BK + 8;  // bf16 p row pitch
constexpr int ROWS_PER_WARP = BQ / WARPS;

static_assert(BQ == 2 * 16 && BK == 4 * 16, "8 warps = 2 x 4 tiles of 16 x 16 logits");

static __device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when !valid (src is then not read).
static __device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(n));
}

static __device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
static __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

static __device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

static __device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c (16 x 8 fp32) += a (16 x 16 bf16, row) * b (16 x 8 bf16, col).
// Fragment layout (PTX ISA, mma.m16n8k16), g = lane / 4, t = lane % 4:
//   a: {A[g][2t..], A[g+8][2t..], A[g][2t+8..], A[g+8][2t+8..]}
//   b: {B[2t..][g], B[2t+8..][g]}
//   c: {C[g][2t], C[g][2t+1], C[g+8][2t], C[g+8][2t+1]}
static __device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                                uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

static __device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

static __device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The two 16 x 8 logits fragments (s0: keys 0-7, s1: keys 8-15 of this
// warp's 16 x 16 tile at rows 16 * wr, keys 16 * wc) into the fp32 logits
// tile `ss`.
static __device__ __forceinline__ void store_logits(float* ss, const float (&s0)[4],
                                                    const float (&s1)[4], int wr, int wc,
                                                    int g, int t4) {
  float* srow = ss + (wr * 16 + g) * LDS + wc * 16 + 2 * t4;
  srow[0] = s0[0];
  srow[1] = s0[1];
  srow[8 * LDS] = s0[2];
  srow[8 * LDS + 1] = s0[3];
  srow[8] = s1[0];
  srow[9] = s1[1];
  srow[8 * LDS + 8] = s1[2];
  srow[8 * LDS + 9] = s1[3];
}

// Online softmax over one BQ x BK logits tile of which the first `valid`
// keys are real: the `use_max` recurrence of the TPU kernels
// (_attend_kv_loop body_max).  Each warp owns ROWS_PER_WARP rows, lane owns
// keys `lane` and `lane + 32`.  p = exp(s - m) is rounded to bf16 into `ps`
// and the row sums add the rounded p; each row's rescale factor goes to
// alpha_s for the PV step.
static __device__ __forceinline__ void online_softmax_tile(
    const float* ss, bf16* ps, float* alpha_s, float (&m_r)[ROWS_PER_WARP],
    float (&l_r)[ROWS_PER_WARP], int valid, int warp, int lane) {
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    const int row = warp * ROWS_PER_WARP + r;
    const float x0 = lane < valid ? ss[row * LDS + lane] : -INFINITY;
    const float x1 = lane + 32 < valid ? ss[row * LDS + lane + 32] : -INFINITY;
    const float m_new = fmaxf(m_r[r], warp_max(fmaxf(x0, x1)));
    const bf16 p0 = __float2bfloat16(expf(x0 - m_new));
    const bf16 p1 = __float2bfloat16(expf(x1 - m_new));
    ps[row * LDP + lane] = p0;
    ps[row * LDP + lane + 32] = p1;
    const float psum = warp_sum(__bfloat162float(p0) + __bfloat162float(p1));
    const float alpha = expf(m_r[r] - m_new);
    l_r[r] = l_r[r] * alpha + psum;
    m_r[r] = m_new;
    if (lane == 0) alpha_s[row] = alpha;
  }
}

}  // namespace gswm_flash
