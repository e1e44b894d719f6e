// Flash attention in float32 at head dims d % 8 == 0, 8 <= d <= 512:
// out = softmax(q k^T d^-0.5) v on (B, Sq, H, d) q and out, (B, Sk, H, d) k
// and v, a row pitch of H * d floats, any Sq and Sk.  Every product, sum and
// exponential in fp32, the softmax with a running max; nothing is rounded to
// a narrower type.
//
// Replaces, in float32, the attention of the Pallas TPU kernels that take
// fp32 and then keep the running max (gswm/ops/attention.py:720-721,
// use_max = x.dtype != bfloat16; the same rule in _flash_bhsd :250-340):
//   * gswm/ops/attention.py:689 flash_attention_fused_qkv (_fused_qkv_kernel,
//     _attend_kv_loop): its core, after qkv_proj_f32.cu's projections (SD
//     2.x's levels 1 and 2: 10 heads of 64, 20 of 64; SD 1.x's: 8 of 80, 8
//     of 160);
//   * gswm/ops/attention.py:1211 flash_attention_cres, which K2
//     (ops.attention.flash_attention) serves: the UNet's level 0, 5 heads of
//     64 (SD 2.x), 8 of 40 (SD 1.x), and SDXL's level 1, 10 of 64 (the JAX
//     package's default there is the plain-XLA xla_flash_attention, which
//     clamps its logits at 60 and drops the max in every dtype; this kernel
//     keeps the exact softmax, as every kernel of the port does);
//   * gswm/ops/attention.py:414 flash_attention (_flash_bhsd) without the
//     log-sum-exp (ops.attention.flash_attention_split): the VAE's mid
//     attention, one head of 512 over 9216 tokens at 768x768 and 16,384 at
//     1024x1024.
//
// What bounds it on an H100: (B, S, H, d) = (4, 4096, 5, 64) is 4 * B * H *
// S^2 * d = 85.9 GFLOP over 84 MB of q, k, v and out, ~1,000 FLOP a byte;
// (1, 9216, 1, 512) is 173.9 GFLOP over 75 MB, ~2,300: the products bound
// both.  Products of fp32 accuracy on the tensor cores are 3xTF32 (each
// operand split into a big and a small TF32 part, three products), a third
// of the dense TF32 rate, 165 TFLOP/s: 0.52 and 1.055 ms there,
// gswm_torch/roofline.py's bound.  This design runs on the CUDA cores (FFMA;
// wgmma has no fp32 form and TF32 misses float32 by 30-90x), whose 67
// TFLOP/s peak (1.28 and 2.6 ms) is its own ceiling.  The B * H * S^2
// exponentials (ex2.approx, relative error ~2^-22) take a sixth of the FFMA
// time at d = 64, more below it and less above.
//
// Design: right and simple first.  P = ceil(d / 64) panels of 64 columns is
// a template parameter (1 up to d = 64, 8 at 512); at P = 1 so is d itself
// (every loop over it unrolls, and the row pitch and the zero-fill tests
// fold), above it d is an argument.
//   * A block owns 64 query rows of one (b, h) and walks the keys 64 at a
//     time; 256 threads, thread (ty, tx) = (thread / 16, thread % 16)
//     owning rows ty + 16 i (i < 4).  q's 64 rows stay in shared memory
//     across the whole d (128 KB at d = 512, 48 KB at 160).
//   * k and v stream in panels of 64 keys x 64 columns (16 KB) through a
//     ring of cp.async stages: a key tile's P k panels, then its P v panels,
//     then the next tile's; the copies of the panels ahead are in flight
//     while one is computed, one barrier a panel.  Rows past Sq and Sk and
//     columns at or past d arrive as zeros (a copy of source size 0).
//     Where a 64 x 512 tile of k or v (128 KB) and a 64 x 512 accumulator
//     spread over 256 threads (128 registers each) would not fit, panels do.
//   * Logits: a thread's 4 x 4 logits (keys tx + 16 j) are summed over the
//     P k panels, four d at a time from 16-byte loads of q and k rows, the
//     last panel over its true columns alone: 64 FFMA per 8 loads.  Keys at
//     or past Sk are masked to -inf.
//   * Online softmax in registers: a row's tile max is a shuffle reduction
//     over the 16 threads that share the row; its running max m, the
//     rescale exp2((m_old - m) c) and p = exp2((s - m) c), c = d^-0.5
//     log2(e) (computed by the host in double), are computed alike by all
//     16; each keeps its own share of the row sum, rescaled with the row,
//     and the shares are summed once at the end.  p goes to a 64 x 64 tile
//     in shared memory.
//   * p v: the output accumulator in registers, split into column groups: a
//     thread owns columns 64 p + 4 tx .. + 3 of its four rows in every panel
//     p, 16 P floats (128 at d = 512), and adds p times each v panel as it
//     arrives, reading p (16 bytes of its rows) and v (16 bytes of a key's
//     row) four keys at a time: 64 FFMA per 8 loads.  Columns past d in the
//     last panel are v's zeros, computed and not stored (at d = 40 p v does
//     64 columns' work for 40, at 80 128, at 160 192: first design).
// Rows of k and v panels hold 64 floats and 4 of padding (272 bytes), q's
// 64 P and 4, p's 64 and 16 (320): each 16-byte load of eight neighbouring
// threads falls in eight distinct bank groups, and p's stores of a warp's
// two rows miss each other's banks.  P = 1 keeps 4 stages (two key tiles of
// k and v, 105 KB), P = 2 three (104 KB), P = 3 two (103 KB): two blocks an
// SM; P >= 4 keeps 4 stages, one block an SM (217 KB at d = 512).  At d = 64
// the arithmetic is, operation for operation and in the same order, that of
// the d = 64 kernel this file held before it took other head dims: its
// outputs are unchanged.
//
// Tails: 64-row blocks leave waves part full.  (1, 9216, 1, 512) is 144
// blocks on 132 SMs, a second wave of 12; (1, 16384, 1, 512) 256, a second
// of 124.  A key split with a combine pass would fill them: later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using gswm_hopper::cp_async_16;
using gswm_hopper::cp_async_commit;
using gswm_hopper::cp_async_wait;
using gswm_hopper::exp2_approx;

constexpr int BM = 64;            // query rows a block
constexpr int BN = 64;            // keys a tile
constexpr int PW = 64;            // columns of a panel
constexpr int PITCH = PW + 4;     // floats a staged k or v panel row
constexpr int P_PITCH = BN + 16;  // floats a row of p
constexpr int THREADS = 256;
constexpr int ROWS = BM / 16;     // rows a thread owns
constexpr int KEYS = BN / 16;     // logits of a row a thread computes
constexpr int PANEL_FLOATS = BN * PITCH;
constexpr int PANEL_CHUNKS = BN * PW / 4;  // 16-byte pieces of a panel
constexpr int MAX_P = 8;          // d <= 512

// P panels of 64 columns: d in (64 (P - 1), 64 P]
template <int P>
struct Cfg {
  static constexpr int QPITCH = P * PW + 4;  // floats a staged q row
  static constexpr int STAGES = P == 2 ? 3 : P == 3 ? 2 : 4;
  static constexpr int BLOCKS = P <= 3 ? 2 : 1;  // blocks an SM
  static constexpr int SMEM_BYTES =
      (BM * QPITCH + STAGES * PANEL_FLOATS + BM * P_PITCH) * (int)sizeof(float);
};
static_assert(Cfg<MAX_P>::SMEM_BYTES <= 232448, "d = 512 must fit one block's shared memory");
static_assert(Cfg<1>::SMEM_BYTES <= 232448 / 2 - 1024 &&
                  Cfg<2>::SMEM_BYTES <= 232448 / 2 - 1024 &&
                  Cfg<3>::SMEM_BYTES <= 232448 / 2 - 1024,
              "P <= 3 keeps two blocks an SM");

// q's rows [q0, q0 + 64) of one head (`qb` at batch b, head h; `pitch`
// floats between rows) across the whole d; rows at or past Sq and columns
// at or past d as zeros (the source then is the head's first element,
// which a copy of size 0 never reads).
template <int P>
__device__ __forceinline__ void stage_q(float* dst, const float* __restrict__ qb, int q0,
                                        int Sq, int d, size_t pitch) {
  constexpr int PER_ROW = P * PW / 4;
#pragma unroll
  for (int it = 0; it < BM * PER_ROW / THREADS; ++it) {
    const int c = threadIdx.x + it * THREADS;
    const int r = c / PER_ROW;
    const int col = (c % PER_ROW) * 4;
    const bool in = q0 + r < Sq && col < d;
    cp_async_16(dst + r * Cfg<P>::QPITCH + col, qb + (in ? (q0 + r) * pitch + col : 0),
                in ? 16 : 0);
  }
}

// Panel n of the block's sequence into a stage: key tile n / (2 P), whose
// k panels 0 .. P - 1 come first, then its v panels 0 .. P - 1; rows at or
// past Sk and columns at or past d as zeros.
template <int P>
__device__ __forceinline__ void stage_panel(float* dst, const float* __restrict__ kb,
                                            const float* __restrict__ vb, int n, int Sk,
                                            int d, size_t pitch) {
  const int r = n % (2 * P);
  const float* base = r < P ? kb : vb;
  const int col0 = (r < P ? r : r - P) * PW;
  const int row0 = n / (2 * P) * BN;
#pragma unroll
  for (int it = 0; it < PANEL_CHUNKS / THREADS; ++it) {
    const int c = threadIdx.x + it * THREADS;
    const int row = c / (PW / 4);
    const int col = col0 + (c % (PW / 4)) * 4;
    const bool in = row0 + row < Sk && col < d;
    cp_async_16(dst + row * PITCH + col - col0, base + (in ? (row0 + row) * pitch + col : 0),
                in ? 16 : 0);
  }
}

// Panel n's stage once every thread's copies of it have landed; the panel
// STAGES - 1 ahead is put in flight into the stage that panel n - 1 used,
// which every thread is done with (the barrier).  One commit group a call,
// empty past the last panel, so the wait counts stay as they are.
template <int P>
__device__ __forceinline__ const float* next_panel(float* ring, int n, int total,
                                                   const float* __restrict__ kb,
                                                   const float* __restrict__ vb, int Sk,
                                                   int d, size_t pitch) {
  constexpr int STAGES = Cfg<P>::STAGES;
  cp_async_wait<STAGES - 2>();
  __syncthreads();
  const int ahead = n + STAGES - 1;
  if (ahead < total)
    stage_panel<P>(ring + (ahead % STAGES) * PANEL_FLOATS, kb, vb, ahead, Sk, d, pitch);
  cp_async_commit();
  return ring + (n % STAGES) * PANEL_FLOATS;
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

// DC: d where it is a template parameter (P = 1), else 0 and d_arg is d
template <int P, int DC>
__global__ void __launch_bounds__(THREADS, Cfg<P>::BLOCKS)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int Sq, int Sk,
                 int H, int d_arg, float c) {
  const int d = DC > 0 ? DC : d_arg;
  constexpr int QPITCH = Cfg<P>::QPITCH;
  constexpr int STAGES = Cfg<P>::STAGES;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                             // BM x QPITCH
  float* ring = qs + BM * QPITCH;               // STAGES x BN x PITCH
  float* ps = ring + STAGES * PANEL_FLOATS;     // BM x P_PITCH
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t pitch = (size_t)H * d;
  const float* qb = q + (size_t)b * Sq * pitch + (size_t)h * d;
  const float* kb = k + (size_t)b * Sk * pitch + (size_t)h * d;
  const float* vb = v + (size_t)b * Sk * pitch + (size_t)h * d;
  const int tiles = (Sk + BN - 1) / BN;
  const int total = tiles * 2 * P;        // panels the block stages
  const int last = d - (P - 1) * PW;      // true columns of the last panel

  float o[P][ROWS][4], m[ROWS], l[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[p][i][e] = 0.0f;
  }

  stage_q<P>(qs, qb, q0, Sq, d, pitch);  // in the first group, with panel 0
#pragma unroll
  for (int n = 0; n < STAGES - 1; ++n) {
    if (n < total) stage_panel<P>(ring + n * PANEL_FLOATS, kb, vb, n, Sk, d, pitch);
    cp_async_commit();
  }

  int n = 0;  // the next panel of the sequence
  for (int t = 0; t < tiles; ++t) {
    // logits s[i][j] of row ty + 16 i, key tx + 16 j, over the k panels
    float s[ROWS][KEYS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < KEYS; ++j) s[i][j] = 0.0f;
#pragma unroll
    for (int p = 0; p < P; ++p, ++n) {
      const float* ks = next_panel<P>(ring, n, total, kb, vb, Sk, d, pitch);
      const float* qp = qs + p * PW;
      const int width = p < P - 1 ? PW : last;
#pragma unroll 4
      for (int dd = 0; dd < width; dd += 4) {
        float4 a[ROWS], bk[KEYS];
#pragma unroll
        for (int i = 0; i < ROWS; ++i)
          a[i] = *reinterpret_cast<const float4*>(qp + (ty + 16 * i) * QPITCH + dd);
#pragma unroll
        for (int j = 0; j < KEYS; ++j)
          bk[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * PITCH + dd);
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
    }

    // online softmax; every tile holds a key below Sk, so each row's tile
    // max, and with it m, is finite from the first tile on.  The barrier of
    // the last k panel parted these writes of p from the reads of the tile
    // before
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
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[p][i][e] *= alpha;
      float* prow = ps + (ty + 16 * i) * P_PITCH;
#pragma unroll
      for (int j = 0; j < KEYS; ++j) {
        const float pj = exp2_approx((s[i][j] - mn) * c);
        l[i] += pj;
        prow[tx + 16 * j] = pj;
      }
    }

    // p v, a v panel at a time; the first panel's barrier makes p visible
#pragma unroll
    for (int p = 0; p < P; ++p, ++n) {
      const float* vs = next_panel<P>(ring, n, total, kb, vb, Sk, d, pitch);
#pragma unroll 4
      for (int j = 0; j < BN; j += 4) {
        float4 pa[ROWS], vv[4];
#pragma unroll
        for (int i = 0; i < ROWS; ++i)
          pa[i] = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * P_PITCH + j);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          vv[e] = *reinterpret_cast<const float4*>(vs + (j + e) * PITCH + 4 * tx);
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          const float pe[4] = {pa[i].x, pa[i].y, pa[i].z, pa[i].w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            o[p][i][0] = fmaf(pe[e], vv[e].x, o[p][i][0]);
            o[p][i][1] = fmaf(pe[e], vv[e].y, o[p][i][1]);
            o[p][i][2] = fmaf(pe[e], vv[e].z, o[p][i][2]);
            o[p][i][3] = fmaf(pe[e], vv[e].w, o[p][i][3]);
          }
        }
      }
    }
  }

  float* ob = out + (size_t)b * Sq * pitch + (size_t)h * d;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const float inv = 1.0f / row_sum(l[i]);
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int col = p * PW + 4 * tx;
      if (col < d)
        *reinterpret_cast<float4*>(ob + row * pitch + col) =
            make_float4(o[p][i][0] * inv, o[p][i][1] * inv, o[p][i][2] * inv,
                        o[p][i][3] * inv);
    }
  }
}

template <int P, int DC = 0>
cudaError_t launch(const float* q, const float* k, const float* v, float* out, int B,
                   int Sq, int Sk, int H, int d, float c, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(flash_f32_kernel<P, DC>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       Cfg<P>::SMEM_BYTES);
  if (e != cudaSuccess) return e;
  const dim3 grid((Sq + BM - 1) / BM, H, B);
  flash_f32_kernel<P, DC><<<grid, THREADS, Cfg<P>::SMEM_BYTES, stream>>>(
      q, k, v, out, Sq, Sk, H, d, c);
  return cudaGetLastError();
}

}  // namespace

// q, out: (B, Sq, H, D) float32; k, v: (B, Sk, H, D) float32; contiguous,
// 16-byte aligned; D % 8 == 0, 8 <= D <= 512; Sq, Sk >= 1.
extern "C" int gswm_flash_f32(const void* q, const void* k, const void* v, void* out, int B,
                              int Sq, int Sk, int H, int D, void* stream) {
  if (D < 8 || D % 8 || D > MAX_P * PW || B < 1 || Sq < 1 || Sk < 1 || H < 1 ||
      B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // d^-0.5 log2(e), rounded once; at d = 64 the float of 0.125 log2(e)
  const float c = static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(D)));
  switch (D) {  // one panel: d a template parameter
    case 8: return static_cast<int>(launch<1, 8>(qf, kf, vf, of, B, Sq, Sk, H, D, c, st));
    case 16: return static_cast<int>(launch<1, 16>(qf, kf, vf, of, B, Sq, Sk, H, D, c, st));
    case 24: return static_cast<int>(launch<1, 24>(qf, kf, vf, of, B, Sq, Sk, H, D, c, st));
    case 32: return static_cast<int>(launch<1, 32>(qf, kf, vf, of, B, Sq, Sk, H, D, c, st));
    case 40: return static_cast<int>(launch<1, 40>(qf, kf, vf, of, B, Sq, Sk, H, D, c, st));
    case 48: return static_cast<int>(launch<1, 48>(qf, kf, vf, of, B, Sq, Sk, H, D, c, st));
    case 56: return static_cast<int>(launch<1, 56>(qf, kf, vf, of, B, Sq, Sk, H, D, c, st));
    case 64: return static_cast<int>(launch<1, 64>(qf, kf, vf, of, B, Sq, Sk, H, D, c, st));
  }
  switch ((D + PW - 1) / PW) {
    case 2: return static_cast<int>(launch<2>(qf, kf, vf, of, B, Sq, Sk, H, D, c, st));
    case 3: return static_cast<int>(launch<3>(qf, kf, vf, of, B, Sq, Sk, H, D, c, st));
    case 4: return static_cast<int>(launch<4>(qf, kf, vf, of, B, Sq, Sk, H, D, c, st));
    case 5: return static_cast<int>(launch<5>(qf, kf, vf, of, B, Sq, Sk, H, D, c, st));
    case 6: return static_cast<int>(launch<6>(qf, kf, vf, of, B, Sq, Sk, H, D, c, st));
    case 7: return static_cast<int>(launch<7>(qf, kf, vf, of, B, Sq, Sk, H, D, c, st));
    default: return static_cast<int>(launch<8>(qf, kf, vf, of, B, Sq, Sk, H, D, c, st));
  }
}
