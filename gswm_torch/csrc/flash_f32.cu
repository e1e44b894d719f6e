// Flash attention in float32 at head dims d % 8 == 0, 8 <= d <= 512, any Sq
// and Sk: out = softmax(q k^T d^-0.5) v, every product, sum and exponential
// in fp32, the softmax with a running max; nothing is rounded to a narrower
// type.  One kernel body in two layouts (a template parameter) and four
// forms, each a C entry below:
//   * natural (gswm_flash_f32): (B, Sq, H, d) q and out, (B, Sk, H, d) k and
//     v, a row pitch of H * d floats;
//   * with the log-sum-exp (gswm_flash_f32_lse): the same, and each row's
//     log-sum-exp of its logits, natural log, into fp32 (B, H, Sq);
//   * pair-packed (gswm_flash_f32_packed): the natural layout with pitches of
//     its own, q, k and v the column bands of one (B, S, 3 * P * 128) array,
//     2 P heads of 64, the output (B, S, P * 128);
//   * transposed (gswm_flash_f32_transposed): q, k and v the row bands of one
//     (3 * H * d, B, S) array, head h's column c at row h * d + c of its
//     band, the output (H * d, B, S).
//
// Replaces, in float32, the attention of the Pallas TPU kernels that take
// fp32 (gswm/ops/attention.py; those that keep a running max do so when the
// dtype is not bf16: :261, :720, :982, :1231):
//   * :689 flash_attention_fused_qkv (_fused_qkv_kernel, _attend_kv_loop):
//     its core, after qkv_proj_f32.cu's projections (SD 2.x's levels 1 and
//     2: 10 heads of 64, 20 of 64; SD 1.x's: 8 of 80, 8 of 160);
//   * :1211 flash_attention_cres, which K2 (ops.attention.flash_attention)
//     serves: the UNet's level 0, 5 heads of 64 (SD 2.x), 8 of 40 (SD 1.x),
//     and SDXL's level 1, 10 of 64 (the JAX package's default there is the
//     plain-XLA xla_flash_attention, which clamps its logits at 60 and drops
//     the max in every dtype; this kernel keeps the exact softmax, as every
//     kernel of the port does);
//   * :414 flash_attention (_flash_bhsd) (ops.attention.flash_attention_split):
//     the VAE's mid attention, one head of 512 over 9216 tokens at 768x768
//     and 16,384 at 1024x1024; with the log-sum-exp, the per-step kernel of
//     ops.ring_attention;
//   * :959 flash_attention_packed (K6): switch set (b);
//   * :1428 flash_attention_transposed (_flash_kernel_T :1281, K7): switch
//     sets (c) and (t).  The TPU kernel drops the max and clamps its logits
//     at 60 in every dtype; this one keeps the exact softmax.
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
// (every loop over it unrolls, and the zero-fill tests fold), above it d is
// an argument.
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
//     P k panels, four d at a time, the last panel over its true columns
//     alone: 64 FFMA per 8 loads (16-byte loads of q and k rows).  Keys at
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
//     arrives, four keys at a time: 64 FFMA per 8 loads.  Columns past d in
//     the last panel are v's zeros, computed and not stored (at d = 40 p v
//     does 64 columns' work for 40, at 80 128, at 160 192: first design).
//   * The log-sum-exp, where asked for (a pointer, null: none): one thread
//     of a row's 16 stores m c ln 2 + ln l, the kernels' convention
//     (hopper.cuh store_lse), for rows below Sq.
// Rows of k and v panels hold 64 floats and 4 of padding (272 bytes), q's
// 64 P and 4, p's 64 and 16 (320): each 16-byte load of eight neighbouring
// threads falls in eight distinct bank groups, and p's stores of a warp's
// two rows miss each other's banks.  P = 1 keeps 4 stages (two key tiles of
// k and v, 105 KB), P = 2 three (104 KB), P = 3 two (103 KB): two blocks an
// SM; P >= 4 keeps 4 stages, one block an SM (217 KB at d = 512).
//
// The transposed layout runs the same loops on the same threads, rows and
// keys, every sum in the same order; only the addresses differ.  Its tiles
// lie in shared memory as they lie in device memory, [column][token]: a
// column's 64 tokens are one run of 256 bytes there (B * S floats between a
// head's columns, S between batches), copied by 16-byte cp.async where S %
// 4 == 0 (every row and band then starts 16-byte aligned: every SD and SDXL
// token count) and by 4-byte cp.async elsewhere (gswm_flash_f32_transposed_4byte
// forces that form at any S), into rows of 68 floats, no second buffer (at d
// = 512 q^T, the ring and p take 224 KB of the 227 KB).  The reads:
//   * q^T[c][row]: a float a row, the same for the row's 16 threads;
//   * k^T[c][tx + 16 j]: 16 neighbouring floats;
//   * v^T[4 tx + e][j .. j + 3]: a 16-byte load of four keys of each of a
//     thread's four columns, transposed in registers into the natural
//     layout's four key rows.  At a pitch of 68, columns 4 tx + e of eight
//     neighbouring threads would share two bank groups; so a k or v panel's
//     column cc is stored at row (cc % 4) * 16 + cc / 4 (`panel_row`), which
//     puts them in eight distinct ones, and k^T's reads, of one column at a
//     time, do not care.
// The output is stored to (h * d + col, b * S + row), a float at a time.  So
// the transposed form's output is, bit for bit, the natural form's on the
// same q, k and v; its logits read a float a load where the natural form
// reads 16 bytes (32 loads per 64 FFMA against 8), so it is the slower.
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
using gswm_hopper::cp_async_4;
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

enum class Layout { natural, transposed };

// P panels of 64 columns: d in (64 (P - 1), 64 P]
template <int P, Layout L>
struct Cfg {
  static constexpr bool T = L == Layout::transposed;
  // floats a staged q row: natural, a token's P * 64 columns; transposed, a
  // column's 64 tokens (P * 64 such rows)
  static constexpr int QPITCH = T ? BM + 4 : P * PW + 4;
  static constexpr int Q_FLOATS = T ? P * PW * QPITCH : BM * QPITCH;
  static constexpr int STAGES = P == 2 ? 3 : P == 3 ? 2 : 4;
  static constexpr int BLOCKS = P <= 3 ? 2 : 1;  // blocks an SM
  static constexpr int SMEM_BYTES =
      (Q_FLOATS + STAGES * PANEL_FLOATS + BM * P_PITCH) * (int)sizeof(float);
};

template <Layout L>
constexpr bool fits() {
  return Cfg<MAX_P, L>::SMEM_BYTES <= 232448 && Cfg<1, L>::SMEM_BYTES <= 232448 / 2 - 1024 &&
         Cfg<2, L>::SMEM_BYTES <= 232448 / 2 - 1024 && Cfg<3, L>::SMEM_BYTES <= 232448 / 2 - 1024;
}
static_assert(fits<Layout::natural>() && fits<Layout::transposed>(),
              "d = 512 must fit one block's shared memory, P <= 3 two blocks an SM");

// Where a launch's tensors lie.  Natural: element (token r, column c) of
// head h of batch b at base + (b * S + r) * pitch + h * d + c; transposed: at
// base + (h * d + c) * pitch + b * S + r, pitch = B * S.
struct Args {
  const float* q;
  const float* k;
  const float* v;
  float* out;
  float* lse;  // (B, H, Sq) fp32, natural log; null: no store
  size_t q_pitch, kv_pitch, out_pitch;
  int Sq, Sk, H, d;
  float c;   // d^-0.5 log2(e)
  bool vec;  // transposed: 16-byte copies (S % 4 == 0), else 4-byte ones
};

// head h's column 0 at batch b's token 0, its tokens S a batch
template <Layout L, typename F>
__device__ __forceinline__ F* head_base(F* t, size_t pitch, int b, int S, int h, int d) {
  if (L == Layout::natural) return t + (size_t)b * S * pitch + (size_t)h * d;
  return t + (size_t)h * d * pitch + (size_t)b * S;
}

// The row of a transposed k or v panel that column cc (< 64) is kept in
__device__ __forceinline__ int panel_row(int cc) { return (cc % 4) * 16 + cc / 4; }

// Transposed layout: columns col0 .. col0 + COLS - 1 of one head (`src` its
// column 0 at the batch's token 0, `pitch` floats between columns) at tokens
// t0 .. t0 + 63, each column a row of PITCH floats (at panel_row(cc) where
// SWIZZLE); tokens at or past S and columns at or past d as zeros.
template <int COLS, bool SWIZZLE>
__device__ __forceinline__ void stage_columns(float* dst, const float* __restrict__ src, int t0,
                                              int S, int col0, int d, size_t pitch, bool vec) {
  static_assert(Cfg<1, Layout::transposed>::QPITCH == PITCH, "one row pitch for q, k and v");
  if (vec) {
#pragma unroll
    for (int it = 0; it < COLS * (BN / 4) / THREADS; ++it) {
      const int i = threadIdx.x + it * THREADS;
      const int cc = i / (BN / 4);
      const int t = (i % (BN / 4)) * 4;
      const bool in = col0 + cc < d && t0 + t < S;  // S % 4 == 0: all four or none
      cp_async_16(dst + (SWIZZLE ? panel_row(cc) : cc) * PITCH + t,
                  src + (in ? (col0 + cc) * pitch + t0 + t : 0), in ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int it = 0; it < COLS * BN / THREADS; ++it) {
      const int i = threadIdx.x + it * THREADS;
      const int cc = i / BN;
      const int t = i % BN;
      const bool in = col0 + cc < d && t0 + t < S;
      cp_async_4(dst + (SWIZZLE ? panel_row(cc) : cc) * PITCH + t,
                 src + (in ? (col0 + cc) * pitch + t0 + t : 0), in ? 4 : 0);
    }
  }
}

// q's rows [q0, q0 + 64) of one head (`qb` from head_base) across the whole
// d; rows at or past Sq and columns at or past d as zeros (the source then
// is the head's first element, which a copy of size 0 never reads).
template <int P, Layout L>
__device__ __forceinline__ void stage_q(float* dst, const float* __restrict__ qb, int q0,
                                        int Sq, int d, size_t pitch, bool vec) {
  if (L == Layout::transposed) {
    stage_columns<P * PW, false>(dst, qb, q0, Sq, 0, d, pitch, vec);
    return;
  }
  constexpr int PER_ROW = P * PW / 4;
#pragma unroll
  for (int it = 0; it < BM * PER_ROW / THREADS; ++it) {
    const int c = threadIdx.x + it * THREADS;
    const int r = c / PER_ROW;
    const int col = (c % PER_ROW) * 4;
    const bool in = q0 + r < Sq && col < d;
    cp_async_16(dst + r * Cfg<P, L>::QPITCH + col, qb + (in ? (q0 + r) * pitch + col : 0),
                in ? 16 : 0);
  }
}

// Panel n of the block's sequence into a stage: key tile n / (2 P), whose
// k panels 0 .. P - 1 come first, then its v panels 0 .. P - 1; rows at or
// past Sk and columns at or past d as zeros.
template <int P, Layout L>
__device__ __forceinline__ void stage_panel(float* dst, const float* __restrict__ kb,
                                            const float* __restrict__ vb, int n, int Sk,
                                            int d, size_t pitch, bool vec) {
  const int r = n % (2 * P);
  const float* base = r < P ? kb : vb;
  const int col0 = (r < P ? r : r - P) * PW;
  const int row0 = n / (2 * P) * BN;
  if (L == Layout::transposed) {
    stage_columns<PW, true>(dst, base, row0, Sk, col0, d, pitch, vec);
    return;
  }
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
template <int P, Layout L>
__device__ __forceinline__ const float* next_panel(float* ring, int n, int total,
                                                   const float* __restrict__ kb,
                                                   const float* __restrict__ vb, int Sk,
                                                   int d, size_t pitch, bool vec) {
  constexpr int STAGES = Cfg<P, L>::STAGES;
  cp_async_wait<STAGES - 2>();
  __syncthreads();
  const int ahead = n + STAGES - 1;
  if (ahead < total)
    stage_panel<P, L>(ring + (ahead % STAGES) * PANEL_FLOATS, kb, vb, ahead, Sk, d, pitch,
                      vec);
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

// DC: d where it is a template parameter (P = 1), else 0 and a.d is d
template <int P, int DC, Layout L>
__global__ void __launch_bounds__(THREADS, Cfg<P, L>::BLOCKS)
flash_f32_kernel(const Args a) {
  constexpr bool T = L == Layout::transposed;
  const int d = DC > 0 ? DC : a.d;
  const int Sq = a.Sq, Sk = a.Sk;
  const float c = a.c;
  constexpr int QPITCH = Cfg<P, L>::QPITCH;
  constexpr int STAGES = Cfg<P, L>::STAGES;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                             // Q_FLOATS
  float* ring = qs + Cfg<P, L>::Q_FLOATS;       // STAGES x PANEL_FLOATS
  float* ps = ring + STAGES * PANEL_FLOATS;     // BM x P_PITCH
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const float* qb = head_base<L>(a.q, a.q_pitch, b, Sq, h, d);
  const float* kb = head_base<L>(a.k, a.kv_pitch, b, Sk, h, d);
  const float* vb = head_base<L>(a.v, a.kv_pitch, b, Sk, h, d);
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

  stage_q<P, L>(qs, qb, q0, Sq, d, a.q_pitch, a.vec);  // in the first group, with panel 0
#pragma unroll
  for (int n = 0; n < STAGES - 1; ++n) {
    if (n < total)
      stage_panel<P, L>(ring + n * PANEL_FLOATS, kb, vb, n, Sk, d, a.kv_pitch, a.vec);
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
      const float* ks = next_panel<P, L>(ring, n, total, kb, vb, Sk, d, a.kv_pitch, a.vec);
      const float* qp = qs + p * PW * (T ? QPITCH : 1);
      const int width = p < P - 1 ? PW : last;
#pragma unroll 4
      for (int dd = 0; dd < width; dd += 4) {
        // columns dd .. dd + 3 of q's rows and of k's keys
        float4 a4[ROWS], bk[KEYS];
        if (T) {
#pragma unroll
          for (int i = 0; i < ROWS; ++i) {
            const float* col = qp + dd * QPITCH + ty + 16 * i;
            a4[i] = make_float4(col[0], col[QPITCH], col[2 * QPITCH], col[3 * QPITCH]);
          }
#pragma unroll
          for (int j = 0; j < KEYS; ++j) {
            // panel_row(dd + e) = 16 e + dd / 4
            const float* col = ks + panel_row(dd) * PITCH + tx + 16 * j;
            bk[j] = make_float4(col[0], col[16 * PITCH], col[32 * PITCH], col[48 * PITCH]);
          }
        } else {
#pragma unroll
          for (int i = 0; i < ROWS; ++i)
            a4[i] = *reinterpret_cast<const float4*>(qp + (ty + 16 * i) * QPITCH + dd);
#pragma unroll
          for (int j = 0; j < KEYS; ++j)
            bk[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * PITCH + dd);
        }
#pragma unroll
        for (int i = 0; i < ROWS; ++i)
#pragma unroll
          for (int j = 0; j < KEYS; ++j) {
            s[i][j] = fmaf(a4[i].x, bk[j].x, s[i][j]);
            s[i][j] = fmaf(a4[i].y, bk[j].y, s[i][j]);
            s[i][j] = fmaf(a4[i].z, bk[j].z, s[i][j]);
            s[i][j] = fmaf(a4[i].w, bk[j].w, s[i][j]);
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
      const float* vs = next_panel<P, L>(ring, n, total, kb, vb, Sk, d, a.kv_pitch, a.vec);
#pragma unroll 4
      for (int j = 0; j < BN; j += 4) {
        // vv[e]: key j + e's columns 4 tx .. 4 tx + 3
        float4 pa[ROWS], vv[4];
#pragma unroll
        for (int i = 0; i < ROWS; ++i)
          pa[i] = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * P_PITCH + j);
        if (T) {
          float4 vt[4];  // column 4 tx + e's keys j .. j + 3 (at panel_row 16 e + tx)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            vt[e] = *reinterpret_cast<const float4*>(vs + (16 * e + tx) * PITCH + j);
          vv[0] = make_float4(vt[0].x, vt[1].x, vt[2].x, vt[3].x);
          vv[1] = make_float4(vt[0].y, vt[1].y, vt[2].y, vt[3].y);
          vv[2] = make_float4(vt[0].z, vt[1].z, vt[2].z, vt[3].z);
          vv[3] = make_float4(vt[0].w, vt[1].w, vt[2].w, vt[3].w);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            vv[e] = *reinterpret_cast<const float4*>(vs + (j + e) * PITCH + 4 * tx);
        }
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

  constexpr float LN2 = 0.6931471805599453f;
  float* ob = head_base<L>(a.out, a.out_pitch, b, Sq, h, d);
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const float sum = row_sum(l[i]);
    const float inv = 1.0f / sum;
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    if (a.lse != nullptr && tx == 0)
      a.lse[((size_t)b * a.H + h) * Sq + row] = m[i] * c * LN2 + logf(sum);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int col = p * PW + 4 * tx;
      if (col >= d) continue;
      const float4 y = make_float4(o[p][i][0] * inv, o[p][i][1] * inv, o[p][i][2] * inv,
                                   o[p][i][3] * inv);
      if (T) {
        float* at = ob + (size_t)col * a.out_pitch + row;
        at[0] = y.x;
        at[a.out_pitch] = y.y;
        at[2 * a.out_pitch] = y.z;
        at[3 * a.out_pitch] = y.w;
      } else {
        *reinterpret_cast<float4*>(ob + row * a.out_pitch + col) = y;
      }
    }
  }
}

template <int P, int DC, Layout L>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(flash_f32_kernel<P, DC, L>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       Cfg<P, L>::SMEM_BYTES);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.Sq + BM - 1) / BM, a.H, B);
  flash_f32_kernel<P, DC, L><<<grid, THREADS, Cfg<P, L>::SMEM_BYTES, stream>>>(a);
  return cudaGetLastError();
}

// The kernel of head dim a.d in layout L: at P = 1 d a template parameter.
template <Layout L>
int run(Args a, int B, void* stream) {
  const int D = a.d;
  if (D < 8 || D % 8 || D > MAX_P * PW || B < 1 || a.Sq < 1 || a.Sk < 1 || a.H < 1 ||
      B > 65535 || a.H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  // d^-0.5 log2(e), rounded once; at d = 64 the float of 0.125 log2(e)
  a.c = static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(D)));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 8: return static_cast<int>(launch<1, 8, L>(a, B, st));
    case 16: return static_cast<int>(launch<1, 16, L>(a, B, st));
    case 24: return static_cast<int>(launch<1, 24, L>(a, B, st));
    case 32: return static_cast<int>(launch<1, 32, L>(a, B, st));
    case 40: return static_cast<int>(launch<1, 40, L>(a, B, st));
    case 48: return static_cast<int>(launch<1, 48, L>(a, B, st));
    case 56: return static_cast<int>(launch<1, 56, L>(a, B, st));
    case 64: return static_cast<int>(launch<1, 64, L>(a, B, st));
  }
  switch ((D + PW - 1) / PW) {
    case 2: return static_cast<int>(launch<2, 0, L>(a, B, st));
    case 3: return static_cast<int>(launch<3, 0, L>(a, B, st));
    case 4: return static_cast<int>(launch<4, 0, L>(a, B, st));
    case 5: return static_cast<int>(launch<5, 0, L>(a, B, st));
    case 6: return static_cast<int>(launch<6, 0, L>(a, B, st));
    case 7: return static_cast<int>(launch<7, 0, L>(a, B, st));
    default: return static_cast<int>(launch<8, 0, L>(a, B, st));
  }
}

int natural_form(const void* q, const void* k, const void* v, void* out, void* lse, int B, int Sq,
            int Sk, int H, int D, void* stream) {
  const size_t pitch = (size_t)H * D;
  const Args a = {static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), static_cast<float*>(out),
                  static_cast<float*>(lse), pitch, pitch, pitch, Sq, Sk, H, D, 0.0f, true};
  return run<Layout::natural>(a, B, stream);
}

int transposed_form(const void* qkv_t, void* out_t, int B, int S, int H, int D, bool vec,
               void* stream) {
  if (B < 1 || S < 1 || H < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bs = (size_t)B * S;
  const float* q = static_cast<const float*>(qkv_t);
  const size_t band = (size_t)H * D * bs;  // q's, k's and v's rows
  const Args a = {q, q + band, q + 2 * band, static_cast<float*>(out_t), nullptr, bs, bs, bs,
                  S, S, H, D, 0.0f, vec};
  return run<Layout::transposed>(a, B, stream);
}

}  // namespace

// q, out: (B, Sq, H, D) float32; k, v: (B, Sk, H, D) float32; contiguous,
// 16-byte aligned; D % 8 == 0, 8 <= D <= 512; Sq, Sk >= 1.
extern "C" int gswm_flash_f32(const void* q, const void* k, const void* v, void* out, int B,
                              int Sq, int Sk, int H, int D, void* stream) {
  return natural_form(q, k, v, out, nullptr, B, Sq, Sk, H, D, stream);
}

// The same, and lse (B, H, Sq) float32: each row's log-sum-exp of its
// logits q k^T D^-0.5, natural log.
extern "C" int gswm_flash_f32_lse(const void* q, const void* k, const void* v, void* out,
                                  void* lse, int B, int Sq, int Sk, int H, int D,
                                  void* stream) {
  if (lse == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return natural_form(q, k, v, out, lse, B, Sq, Sk, H, D, stream);
}

// qkv: (B, S, 3 * P * 128) float32, q, k and v its column bands [0, P * 128),
// [P * 128, 2 P * 128), [2 P * 128, 3 P * 128), each 2 P heads of 64; out:
// (B, S, P * 128); 16-byte aligned.
extern "C" int gswm_flash_f32_packed(const void* qkv, void* out, int B, int S, int pairs,
                                     void* stream) {
  if (pairs < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t width = (size_t)pairs * 128;
  const float* q = static_cast<const float*>(qkv);
  const Args a = {q, q + width, q + 2 * width, static_cast<float*>(out), nullptr, 3 * width,
                  3 * width, width, S, S, 2 * pairs, 64, 0.0f, true};
  return run<Layout::natural>(a, B, stream);
}

// qkv_t: (3 * H * D, B, S) float32, q, k and v its row bands, head h's
// column c at row h * D + c of its band; out_t: (H * D, B, S); 16-byte
// aligned; D % 8 == 0, 8 <= D <= 512; any S (16-byte copies where S % 4 ==
// 0, 4-byte ones elsewhere).
extern "C" int gswm_flash_f32_transposed(const void* qkv_t, void* out_t, int B, int S, int H,
                                         int D, void* stream) {
  return transposed_form(qkv_t, out_t, B, S, H, D, S % 4 == 0, stream);
}

// The same with 4-byte copies at any S (the tests hold it to the 16-byte form).
extern "C" int gswm_flash_f32_transposed_4byte(const void* qkv_t, void* out_t, int B, int S,
                                               int H, int D, void* stream) {
  return transposed_form(qkv_t, out_t, B, S, H, D, false, stream);
}
