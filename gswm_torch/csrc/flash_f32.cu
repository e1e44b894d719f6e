// Flash attention in float32 at head dims d % 8 == 0, 8 <= d <= 512, any Sq
// and Sk: out = softmax(q k^T d^-0.5) v, every product of float32 accuracy
// on the tensor cores (3xTF32 wgmma, hopper.cuh), every sum and exponential
// in fp32, the softmax with a running max.  One kernel body in two layouts
// (a template parameter of q's loads and of the output's stores) and four
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
// Those entries keep the first design's signatures and run unsplit, their
// scratch from the stream's own pool.  The wrappers (ops.attention) call the
// three steps themselves, scratch and workspace from PyTorch: the split
// pre-pass (gswm_flash_f32_prepass), the core (gswm_flash_f32_core, over s
// key chunks) and, where s > 1, the combine (gswm_flash_f32_combine).
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
// both.  A product of fp32 accuracy on the tensor cores is three TF32 ones
// (3xTF32), a third of the dense TF32 rate, 165 TFLOP/s: 0.52 and 1.055 ms
// there, gswm_torch/roofline.py's bound.  The first design ran on the CUDA
// cores' FFMA, whose 67 TFLOP/s (1.28 and 2.6 ms) was its ceiling.
//
// Design.
//   * The pre-pass (split_kv_kernel) reads k and v once, in either layout
//     at any pitch, and writes four scratch arrays, each (b, h) a block of
//     them, rows padded with zeros to Skp = 64 ceil(Sk / 64) keys and Dp =
//     64 P columns (P = ceil(d / 64) panels): k's big and small parts
//     K-major ([key][column]) and v's big and small parts K-major for p v
//     ([column][key], v transposed).  tf32 wgmma has no transpose bit, so
//     one of the two needs a transpose in either layout (v in the natural
//     one, k in the transposed one): it is done here once a call, not once
//     a block, and the core reads one layout of k and v whatever the form.
//   * The core: a block of two consumer warpgroups (256 threads) owns a key
//     chunk of one (b, h) and 128 query rows, 64 a warpgroup, where P <= 4
//     (d <= 256).  Above ("WIDE"), the accumulator of 64 rows by 512
//     columns would be 256 registers a thread, twice what a thread has: the
//     block owns 64 rows that both warpgroups share, and every product's B
//     rows are split between them, the keys of a k panel (each warpgroup
//     the logits of 32 of a tile's 64 keys) and the columns of a v panel
//     (each 32 of its 64).  The row maxima and p are traded through shared
//     memory, p in A-fragment order (a thread's 16 bytes a step, where the
//     warpgroup that reads them wants them), the row sums once at the end.
//     No product is computed twice.  q's rows stay in shared memory across
//     the whole d as floats, as they lie in the form's layout: natural rows
//     padded by 4 floats, transposed 4-token runs swizzled, so that the A
//     fragment's loads hit 32 banks from one base address a thread.
//   * k and v stream from the scratch in panels of 64 keys by 64 columns
//     (big and small, 32 KB) through a ring of stages (2 to 5, as many as
//     fit beside q), a key tile's P k panels, then its P v panels, each
//     four TMA boxes in the 128-byte swizzle wgmma reads.  A third
//     warpgroup produces them (one thread, tensor maps over the scratch), a
//     full and an empty mbarrier a stage; the consumers never meet at a
//     block-wide barrier, so one runs its products while the other splits
//     fragments or runs its softmax (copies by every thread and a barrier
//     a panel kept the two in step, the tensor cores idle through both's
//     gaps).
//   * Logits: each k panel, 8 steps of 8 columns (the last panel to the
//     true d), q's A fragment loaded from shared memory and split in
//     registers, three wgmma.m64n64k8 (WIDE: m64n32k8) a step into a panel
//     accumulator,
//     which is added to the tile's logits once the panel retires: the
//     tensor core's own sums run over 64 columns at most.  The steps go in
//     batches (a panel's 8; 4 or 2 where the accumulators leave fewer
//     registers): the batch's fragments loaded and split first, its
//     products issued back to back behind one fence and retired by one
//     wait, while the other warpgroup's batch fills the tensor cores' gaps.
//   * Online softmax in registers (hopper.cuh softmax_exp, keys at or past
//     Sk masked to -inf), p kept in fp32.
//   * p v: p is the A operand from registers (WIDE: from the traded
//     fragments), split per step.  The
//     accumulator holds keys 2t and 2t + 1 of each group of 8 where the tf32
//     A fragment wants keys t and t + 4, so the pre-pass stores v's keys in
//     each group of 8 in the order 0, 2, 4, 6, 1, 3, 5, 7: p needs no
//     shuffle.  Each v panel's products go to a fresh accumulator that is
//     added to the running output once it retires (the tensor core's sums
//     run over one key tile; the long sum over the keys is fp32 FADD).
//   * Widths: P a template parameter, and N, the last panel's width in p v:
//     exact at the widths users run (d = 40: N 40; 80: 16; 160: 32; 64 and
//     512 whole panels), 64 at every other width, which computes v's zero
//     columns.  Logits run to the true d at every width.
//   * Key split: the host splits the keys into s chunks of whole tiles
//     (ops.attention.f32_key_splits picks s from the shape and the SM
//     count, so that waves fill); each (row block, chunk) writes its
//     unnormalised output, running max and row sum to a workspace, and
//     combine_kernel merges them (each chunk weighted by exp2((m_i - M) c)),
//     writing the output in the form's layout and, where asked, the
//     log-sum-exp.  At s = 1 the core normalises and stores itself.
//   * The log-sum-exp, where asked for (a pointer, null: none): m c ln 2 +
//     ln l, the kernels' convention (hopper.cuh store_lse), for rows below
//     Sq.
// So every form runs the same instance on the same q values, k and v
// scratch and sums in the same order: the packed and transposed forms and
// the form with the log-sum-exp are, bit for bit, the natural form's on the
// same q, k and v, split or not (s depends on the shape alone).
// Shared memory, one block an SM: the ring (stages of 32 KB), q (128 rows of
// 64 P + 4 floats; WIDE 64), the mbarriers and, WIDE, p (16 KB) and the row
// maxima: 5 stages at P = 1, 2 at P = 4 and at P = 8.  Registers:
// setmaxnreg gives the consumers 232 a thread, the producer 40.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using gswm_hopper::align_smem;
using gswm_hopper::cp_async_16;
using gswm_hopper::cp_async_4;
using gswm_hopper::cp_async_commit;
using gswm_hopper::cp_async_wait;
using gswm_hopper::DESC_K_STEP;
using gswm_hopper::encode_map;
using gswm_hopper::exp2_approx;
using gswm_hopper::fence_mbar_init;
using gswm_hopper::fence_regs;
using gswm_hopper::mbar_arrive;
using gswm_hopper::mbar_expect_tx;
using gswm_hopper::mbar_init;
using gswm_hopper::mbar_wait;
using gswm_hopper::named_barrier;
using gswm_hopper::quad_max;
using gswm_hopper::quad_sum;
using gswm_hopper::reg_dec;
using gswm_hopper::reg_inc;
using gswm_hopper::scale_rows;
using gswm_hopper::smem_desc_sw128;
using gswm_hopper::softmax_exp;
using gswm_hopper::split_fragment;
using gswm_hopper::tma_load_2d;
using gswm_hopper::wgmma_3xtf32_rs;
using gswm_hopper::wgmma_commit;
using gswm_hopper::wgmma_fence;
using gswm_hopper::wgmma_wait;

constexpr int BM = 64;                        // query rows a warpgroup
constexpr int BN = 64;                        // keys a tile
constexpr int PW = 64;                        // columns a panel
constexpr int CONSUMERS = 256;                // two consumer warpgroups
constexpr int THREADS = 128 + CONSUMERS;      // and the producer's
constexpr int STEP_THREADS = 256;             // the pre-pass's and the combine's blocks
constexpr int PRODUCER_REGS = 40;             // setmaxnreg: 128 x 40 + 256 x 232 <= 65536
constexpr int CONSUMER_REGS = 232;
constexpr int ATOM_BYTES = 64 * 128;          // 64 rows of one 128-byte row (32 floats)
constexpr int PART_BYTES = 2 * ATOM_BYTES;    // a 64 x 64 panel's big (or small) part
constexpr int PANEL_BYTES = 2 * PART_BYTES;   // both parts
constexpr int MAX_P = 8;                      // d <= 512
constexpr int SMEM_LIMIT = 232448;
constexpr int MAX_STAGES = 6;
constexpr int BAR_BYTES = 2 * MAX_STAGES * 8;  // a full and an empty mbarrier a stage

enum class Layout { natural, transposed };

// P panels of 64 columns: d in (64 (P - 1), 64 P]
template <int P>
struct Cfg {
  // above 4 panels the warpgroups share 64 rows and split every product's
  // B rows (keys of a k panel, columns of a v panel) between them
  static constexpr bool WIDE = P > 4;
  static constexpr int ROWS = WIDE ? BM : 2 * BM;     // query rows a block
  static constexpr int NK = WIDE ? BN / 2 : BN;       // keys of a tile a warpgroup's logits hold
  static constexpr int OW = WIDE ? PW / 2 : PW;       // a panel's columns a warpgroup's output holds
  // steps of 8 whose A fragments (8 registers each) are live at once: a
  // whole panel's where the accumulators leave room, half of one where they
  // take 128 registers a thread
  static constexpr int KB = P <= 2 ? 8 : P == 4 ? 2 : 4;
  static constexpr int QP = P * PW + 4;               // floats a natural q row
  static constexpr int Q_BYTES = ROWS * QP * 4;       // (transposed: P 64 rows of ROWS, less)
  // WIDE: p of a key tile in A-fragment order (8 steps x 4 warps x 32
  // lanes x 4 floats), and each warpgroup's row maxima (later its row sums)
  static constexpr int P_BYTES = WIDE ? (BN / 8) * 128 * 4 * 4 : 0;
  static constexpr int RED_BYTES = WIDE ? 2 * BM * 4 : 0;
  static constexpr int FIT =
      (SMEM_LIMIT - 1024 - Q_BYTES - P_BYTES - RED_BYTES - BAR_BYTES) / PANEL_BYTES;
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  static constexpr int SMEM_BYTES =
      1024 + STAGES * PANEL_BYTES + Q_BYTES + P_BYTES + RED_BYTES + BAR_BYTES;
};
static_assert(Cfg<1>::STAGES >= 4 && Cfg<4>::STAGES >= 2 && Cfg<MAX_P>::STAGES >= 2,
              "d = 512 must keep two stages beside q");

// Where a launch's tensors lie.  q and out in the form's layout: natural,
// element (token r, column c) of head h of batch b at base + (b * S + r) *
// pitch + h * d + c; transposed, at base + (h * d + c) * pitch + b * S + r,
// pitch = B * S.  k and v as the pre-pass wrote them, read through tensor
// maps (flash_f32_kernel's map_k and map_v).
struct Args {
  const float* q;
  float* out;
  float* lse;   // (B, H, Sq) fp32, natural log; null: no store
  float* ws_o;  // [s][B H][Sq][d] partial outputs; null: unsplit
  float* ws_m;  // [s][B H][Sq] running maxima of the raw logits
  float* ws_l;  // [s][B H][Sq] row sums
  size_t q_pitch, out_pitch;
  int Sq, Sk, H, d, Skp, Dp;
  int splits, chunk_tiles;  // key chunks, key tiles a chunk
  float c;                  // d^-0.5 log2(e)
  bool vec;                 // transposed q: 16-byte copies (S % 4 == 0), else 4-byte ones
};

// head h's column 0 at batch b's token 0, its tokens S a batch
template <Layout L, typename F>
__device__ __forceinline__ F* head_base(F* t, size_t pitch, int b, int S, int h, int d) {
  if (L == Layout::natural) return t + (size_t)b * S * pitch + (size_t)h * d;
  return t + (size_t)h * d * pitch + (size_t)b * S;
}

// q's element (row r, column c) in shared memory: natural, rows of 64 P + 4
// floats; transposed, a row of ROWS tokens a column, each 4-token run moved
// by 8 (c % 4).  The A fragment's 32 loads of a warp then hit 32 banks, and
// a thread's addresses are one base plus constants (c's part of them is the
// step's), which the loads take as immediates.
template <int P, Layout L>
__device__ __forceinline__ int q_index(int r, int c) {
  if (L == Layout::natural) return r * Cfg<P>::QP + c;
  return c * Cfg<P>::ROWS + (r ^ ((c & 3) << 3));
}

// q's rows [q0, q0 + ROWS) of one head (`qb` from head_base) across the
// whole 64 P columns; rows at or past Sq and columns at or past d as zeros
// (the source then is the head's first element, which a copy of size 0
// never reads).
template <int P, Layout L>
__device__ __forceinline__ void stage_q(float* dst, const float* __restrict__ qb, int q0,
                                        int Sq, int d, size_t pitch, bool vec, int tid) {
  constexpr int ROWS = Cfg<P>::ROWS;
  if (L == Layout::transposed) {
    if (vec) {
      for (int i = tid; i < P * PW * ROWS / 4; i += CONSUMERS) {
        const int c = i / (ROWS / 4);
        const int t = (i % (ROWS / 4)) * 4;
        const bool in = c < d && q0 + t < Sq;  // S % 4 == 0: all four or none
        cp_async_16(dst + q_index<P, L>(t, c), qb + (in ? c * pitch + q0 + t : 0), in ? 16 : 0);
      }
    } else {
      for (int i = tid; i < P * PW * ROWS; i += CONSUMERS) {
        const int c = i / ROWS;
        const int t = i % ROWS;
        const bool in = c < d && q0 + t < Sq;
        cp_async_4(dst + q_index<P, L>(t, c), qb + (in ? c * pitch + q0 + t : 0), in ? 4 : 0);
      }
    }
    return;
  }
  for (int i = tid; i < ROWS * P * PW / 4; i += CONSUMERS) {
    const int r = i / (P * PW / 4);
    const int c = (i % (P * PW / 4)) * 4;
    const bool in = q0 + r < Sq && c < d;
    cp_async_16(dst + q_index<P, L>(r, c), qb + (in ? (q0 + r) * pitch + c : 0), in ? 16 : 0);
  }
}

// The producer's copies of the block's panel n into its stage: key tile t0
// + n / (2 P), whose k panels 0 .. P - 1 come first, then its v panels 0 ..
// P - 1; a panel four TMA boxes of 64 rows by 32 floats (big, small; two
// atoms each) in the 128-byte swizzle wgmma reads.  map_k is over k's
// parts, 2 B H Skp rows of Dp floats (the small part's rows from B H Skp
// on); map_v over v's, 2 B H Dp rows of Skp.
template <int P>
__device__ __forceinline__ void produce_panel(unsigned char* dst, uint64_t* full,
                                              const CUtensorMap* map_k,
                                              const CUtensorMap* map_v, int n, int t0,
                                              const Args& a, int bh, int BH) {
  const int r = n % (2 * P);
  const int t = t0 + n / (2 * P);
  mbar_expect_tx(full, PANEL_BYTES);
  const CUtensorMap* map = r < P ? map_k : map_v;
  // k: rows the tile's keys, columns the panel's; v: rows the panel's
  // columns, columns the tile's keys
  const int row = r < P ? bh * a.Skp + t * BN : bh * a.Dp + (r - P) * PW;
  const int col = r < P ? r * PW : t * BN;
  const int small = r < P ? BH * a.Skp : BH * a.Dp;
#pragma unroll
  for (int part = 0; part < 2; ++part)
#pragma unroll
    for (int atom = 0; atom < 2; ++atom)
      tma_load_2d(dst + part * PART_BYTES + atom * ATOM_BYTES, map, full, col + atom * 32,
                  row + part * small);
}

// The wgmma descriptors of step ks (8 columns or keys) of a staged panel's
// big and small parts.
__device__ __forceinline__ uint64_t step_desc(const unsigned char* stage, int part, int ks) {
  return smem_desc_sw128(stage + part * PART_BYTES + (ks / 4) * ATOM_BYTES) +
         (ks % 4) * DESC_K_STEP;
}

// The logits of this warpgroup's 64 rows against NK keys of k panel j (the
// staged panel's rows from `stage` on), over its `steps` steps of 8 columns,
// into s: added to it past the first panel, so the tensor cores' own sums
// run over 64 columns.  Rows r_lo and r_lo + 8 of the block are this
// thread's.  The steps go in batches of KB: the batch's A fragments loaded
// and split first, then all its products issued behind one fence and
// retired by one wait, so the tensor cores take them back to back.
template <int P, Layout L, int NK, int KB>
__device__ __forceinline__ void logits_panel(float (&s)[NK / 2], const float* qs,
                                             const unsigned char* stage, int j, int steps,
                                             int r_lo, int t4) {
  float acc[NK / 2];
#pragma unroll
  for (int k0 = 0; k0 < PW / 8; k0 += KB) {
    if (k0 < steps) {
      uint32_t fb[KB][4], fs[KB][4];
#pragma unroll
      for (int kk = 0; kk < KB; ++kk) {
        const int c = j * PW + (k0 + kk) * 8 + t4;
        if (k0 + kk < steps)
          split_fragment(qs[q_index<P, L>(r_lo, c)], qs[q_index<P, L>(r_lo + 8, c)],
                         qs[q_index<P, L>(r_lo, c + 4)], qs[q_index<P, L>(r_lo + 8, c + 4)],
                         fb[kk], fs[kk]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KB; ++kk)
        if (k0 + kk < steps)
          wgmma_3xtf32_rs<NK>(acc, fb[kk], fs[kk], step_desc(stage, 0, k0 + kk),
                              step_desc(stage, 1, k0 + kk), k0 + kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(fb);
      fence_regs(fs);
    }
  }
  fence_regs(acc);
#pragma unroll
  for (int i = 0; i < NK / 2; ++i) s[i] = j == 0 ? acc[i] : s[i] + acc[i];
}

// o (its first N / 2) += p (64 rows x 64 keys) times N columns of a v
// panel (the staged panel's rows from `stage` on), summed apart and then
// added.  p's A fragment of step ks comes from `frag` (four floats: row lo
// and hi of key 2 t, row lo and hi of key 2 t + 1 of the step's group of 8,
// the slots t and t + 4 where the pre-pass put those keys in v); the steps
// in batches of KB, as the logits'.
template <int N, int OW, int KB, typename Frag>
__device__ __forceinline__ void pv_panel(float (&o)[OW / 2], Frag frag,
                                         const unsigned char* stage) {
  float acc[N / 2];
#pragma unroll
  for (int k0 = 0; k0 < BN / 8; k0 += KB) {
    uint32_t fb[KB][4], fs[KB][4];
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) {
      const float4 f = frag(k0 + kk);
      split_fragment(f.x, f.y, f.z, f.w, fb[kk], fs[kk]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KB; ++kk)
      wgmma_3xtf32_rs<N>(acc, fb[kk], fs[kk], step_desc(stage, 0, k0 + kk),
                         step_desc(stage, 1, k0 + kk), k0 + kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(fb);
    fence_regs(fs);
  }
  fence_regs(acc);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) o[i] += acc[i];
}

// N: p v's width of the last panel (the others 64); WIDE: each warpgroup
// takes half of every panel's B rows.  Warpgroup 0 produces (one thread's
// TMA copies, a full and an empty mbarrier a stage), 1 and 2 consume.
template <int P, int N, Layout L>
__global__ void __launch_bounds__(THREADS, 1)
flash_f32_kernel(const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v, const Args a) {
  using C = Cfg<P>;
  constexpr bool WIDE = C::WIDE;
  constexpr int STAGES = C::STAGES;
  static_assert(!WIDE || N == PW, "WIDE instances take whole panels");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align_smem(smem_raw);  // STAGES panels
  float* qs = reinterpret_cast<float*>(ring + STAGES * PANEL_BYTES);
  float4* pf = reinterpret_cast<float4*>(ring + STAGES * PANEL_BYTES + C::Q_BYTES);
  float* red = reinterpret_cast<float*>(ring + STAGES * PANEL_BYTES + C::Q_BYTES +
                                        C::P_BYTES);  // [2][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * PANEL_BYTES + C::Q_BYTES +
                                               C::P_BYTES + C::RED_BYTES);
  uint64_t* empty = full + MAX_STAGES;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int chunk = blockIdx.x % a.splits;
  const int q0 = blockIdx.x / a.splits * C::ROWS;
  const size_t bh = (size_t)b * a.H + h;
  const int tiles = (a.Sk + BN - 1) / BN;
  const int t0 = chunk * a.chunk_tiles;
  const int t1 = min(tiles, t0 + a.chunk_tiles);
  const int total = (t1 - t0) * 2 * P;  // panels the block stages

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], CONSUMERS / 32);  // each consumer warp once it is done
    }
    fence_mbar_init();
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    reg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0)
      for (int n = 0; n < total; ++n) {
        mbar_wait(&empty[n % STAGES], ((n / STAGES) & 1) ^ 1);
        produce_panel<P>(ring + (n % STAGES) * PANEL_BYTES, &full[n % STAGES], &map_k,
                         &map_v, n, t0, a, (int)bh, gridDim.z * a.H);
      }
    return;
  }
  reg_inc<CONSUMER_REGS>();
  const int ctid = threadIdx.x - 128;
  const int wg = ctid / 128;
  const int warp = (ctid / 32) % 4;
  const int lane = ctid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int rw = warp * 16 + g;         // this thread's rows of its warpgroup: rw, rw + 8
  const int r_lo = (WIDE ? 0 : wg * BM) + rw;  // and of the block
  const int boff = WIDE ? wg * (BN / 2) * 128 : 0;  // this warpgroup's B rows of a panel
  const float c = a.c;

  float o[P][C::OW / 2];
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.0f, l_hi = 0.0f;
#pragma unroll
  for (int j = 0; j < P; ++j)
#pragma unroll
    for (int i = 0; i < C::OW / 2; ++i) o[j][i] = 0.0f;

  stage_q<P, L>(qs, head_base<L>(a.q, a.q_pitch, b, a.Sq, h, a.d), q0, a.Sq, a.d, a.q_pitch,
                a.vec, ctid);
  cp_async_commit();
  cp_async_wait<0>();
  named_barrier(2, CONSUMERS);  // q whole

  // panel n's stage once its copies landed; its release once this
  // warpgroup's products reading it retired (lane 0 of each warp)
  auto acquire = [&](int n) {
    mbar_wait(&full[n % STAGES], (n / STAGES) & 1);
    return ring + (n % STAGES) * PANEL_BYTES;
  };
  auto release = [&](int n) {
    if (lane == 0) mbar_arrive(&empty[n % STAGES]);
  };

  int n = 0;  // the next panel of the sequence
  for (int t = t0; t < t1; ++t) {
    float s[C::NK / 2];
#pragma unroll
    for (int j = 0; j < P; ++j, ++n) {
      const unsigned char* stage = acquire(n);
      const int steps = min(PW / 8, (a.d - j * PW) / 8);
      logits_panel<P, L, C::NK, C::KB>(s, qs, stage + boff, j, steps, r_lo, t4);
      release(n);
    }
    float a_lo, a_hi;
    const int valid = min(BN, a.Sk - t * BN);  // keys of the tile below Sk
    if constexpr (WIDE) {
      // this warpgroup's keys 32 wg + ..; the row maxima traded through
      // shared memory (both sides then hold the same), p in A-fragment
      // order for both
      const int mine = valid - wg * (BN / 2);
#pragma unroll
      for (int j = 0; j < C::NK / 8; ++j) {
        const int col = j * 8 + 2 * t4;
        if (col >= mine) s[4 * j] = s[4 * j + 2] = -INFINITY;
        if (col + 1 >= mine) s[4 * j + 1] = s[4 * j + 3] = -INFINITY;
      }
      float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
      for (int j = 0; j < C::NK / 8; ++j) {
        mx_lo = fmaxf(mx_lo, fmaxf(s[4 * j], s[4 * j + 1]));
        mx_hi = fmaxf(mx_hi, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      mx_lo = quad_max(mx_lo);
      mx_hi = quad_max(mx_hi);
      if (t4 == 0) {
        red[wg * BM + rw] = mx_lo;
        red[wg * BM + rw + 8] = mx_hi;
      }
      named_barrier(1, CONSUMERS);
      const float n_lo = fmaxf(m_lo, fmaxf(red[rw], red[BM + rw]));
      const float n_hi = fmaxf(m_hi, fmaxf(red[rw + 8], red[BM + rw + 8]));
      a_lo = exp2_approx((m_lo - n_lo) * c);
      a_hi = exp2_approx((m_hi - n_hi) * c);
      m_lo = n_lo;
      m_hi = n_hi;
#pragma unroll
      for (int j = 0; j < C::NK / 8; ++j) {
        s[4 * j] = exp2_approx(fmaf(s[4 * j], c, -m_lo * c));
        s[4 * j + 1] = exp2_approx(fmaf(s[4 * j + 1], c, -m_lo * c));
        s[4 * j + 2] = exp2_approx(fmaf(s[4 * j + 2], c, -m_hi * c));
        s[4 * j + 3] = exp2_approx(fmaf(s[4 * j + 3], c, -m_hi * c));
        pf[((wg * (C::NK / 8) + j) * 4 + warp) * 32 + lane] =
            make_float4(s[4 * j], s[4 * j + 2], s[4 * j + 1], s[4 * j + 3]);
      }
      named_barrier(1, CONSUMERS);  // p whole
    } else {
      softmax_exp<BN / 8>(s, m_lo, m_hi, a_lo, a_hi, valid, c, t4);
    }
    float sum_lo = 0.0f, sum_hi = 0.0f;
#pragma unroll
    for (int j = 0; j < C::NK / 8; ++j) {
      sum_lo += s[4 * j] + s[4 * j + 1];
      sum_hi += s[4 * j + 2] + s[4 * j + 3];
    }
    l_lo = l_lo * a_lo + sum_lo;
    l_hi = l_hi * a_hi + sum_hi;
#pragma unroll
    for (int j = 0; j < P; ++j) scale_rows<C::OW / 2>(o[j], a_lo, a_hi);
#pragma unroll
    for (int j = 0; j < P; ++j, ++n) {
      const unsigned char* stage = acquire(n) + boff;
      if constexpr (WIDE) {
        pv_panel<PW / 2, C::OW, C::KB>(
            o[j], [&](int ks) { return pf[(ks * 4 + warp) * 32 + lane]; }, stage);
      } else {
        auto frag = [&](int ks) {
          return make_float4(s[4 * ks], s[4 * ks + 2], s[4 * ks + 1], s[4 * ks + 3]);
        };
        if (j == P - 1)
          pv_panel<N, C::OW, C::KB>(o[j], frag, stage);
        else
          pv_panel<PW, C::OW, C::KB>(o[j], frag, stage);
      }
      release(n);
    }
  }

  // the row sums over the quad's four threads (WIDE: and both warpgroups'
  // keys, added in one order); the rows of this thread
  float l[2] = {quad_sum(l_lo), quad_sum(l_hi)};
  if constexpr (WIDE) {
    if (t4 == 0) {
      red[wg * BM + rw] = l[0];
      red[wg * BM + rw + 8] = l[1];
    }
    named_barrier(1, CONSUMERS);
    l[0] = red[rw] + red[BM + rw];
    l[1] = red[rw + 8] + red[BM + rw + 8];
  }
  const float m[2] = {m_lo, m_hi};
  const bool row_owner = t4 == 0 && (!WIDE || wg == 0);
  const int col0 = WIDE ? wg * (PW / 2) : 0;  // this warpgroup's first column of a panel
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + r_lo + 8 * half;
    if (row >= a.Sq) continue;
    const float inv = 1.0f / l[half];
    if (a.ws_o != nullptr) {  // a key chunk's partial output
      const size_t at = ((size_t)chunk * gridDim.z * a.H + bh) * a.Sq + row;
      if (row_owner) {
        a.ws_m[at] = m[half];
        a.ws_l[at] = l[half];
      }
#pragma unroll
      for (int j = 0; j < P; ++j)
#pragma unroll
        for (int grp = 0; grp < C::OW / 8; ++grp) {
          const int col = j * PW + col0 + 8 * grp + 2 * t4;
          if (col < a.d)
            *reinterpret_cast<float2*>(a.ws_o + at * a.d + col) =
                make_float2(o[j][4 * grp + 2 * half], o[j][4 * grp + 2 * half + 1]);
        }
      continue;
    }
    if (a.lse != nullptr && row_owner) {
      constexpr float LN2 = 0.6931471805599453f;
      a.lse[bh * a.Sq + row] = m[half] * c * LN2 + logf(l[half]);
    }
    float* ob = head_base<L>(a.out, a.out_pitch, b, a.Sq, h, a.d);
#pragma unroll
    for (int j = 0; j < P; ++j)
#pragma unroll
      for (int grp = 0; grp < C::OW / 8; ++grp) {
        const int col = j * PW + col0 + 8 * grp + 2 * t4;
        if (col >= a.d) continue;
        const float y0 = o[j][4 * grp + 2 * half] * inv;
        const float y1 = o[j][4 * grp + 2 * half + 1] * inv;
        if (L == Layout::transposed) {
          ob[(size_t)col * a.out_pitch + row] = y0;
          ob[(size_t)(col + 1) * a.out_pitch + row] = y1;
        } else {
          *reinterpret_cast<float2*>(ob + (size_t)row * a.out_pitch + col) = make_float2(y0, y1);
        }
      }
  }
}

// The pre-pass: one 64-key by 64-column tile of k and of v of one head a
// block, read in the layout L (zeros at or past Sk and d), written split
// into the scratch: k's parts as [key][column] rows, v's as [column][key]
// rows, keys in each group of 8 in the order 0, 2, 4, 6, 1, 3, 5, 7.
template <Layout L>
__global__ void __launch_bounds__(STEP_THREADS)
split_kv_kernel(const float* __restrict__ k, const float* __restrict__ v, size_t pitch,
                int Sk, int H, int d, int Skp, int Dp, float* __restrict__ kb,
                float* __restrict__ ks, float* __restrict__ vb, float* __restrict__ vs) {
  __shared__ float kt[BN][PW + 1], vt[BN][PW + 1];
  const int key0 = blockIdx.x * BN;
  const int col0 = blockIdx.y * PW;
  const int bh = blockIdx.z;
  const int b = bh / H, h = bh % H;
  const float* kh = head_base<L>(k, pitch, b, Sk, h, d);
  const float* vh = head_base<L>(v, pitch, b, Sk, h, d);
  if (L == Layout::natural) {
    for (int i = threadIdx.x; i < BN * PW / 4; i += STEP_THREADS) {
      const int r = i / (PW / 4);
      const int c = (i % (PW / 4)) * 4;
      const bool in = key0 + r < Sk && col0 + c < d;  // d % 8 == 0: four columns or none
      const size_t at = (size_t)(key0 + r) * pitch + col0 + c;
      const float4 x = in ? *reinterpret_cast<const float4*>(kh + at) : make_float4(0, 0, 0, 0);
      const float4 y = in ? *reinterpret_cast<const float4*>(vh + at) : make_float4(0, 0, 0, 0);
      kt[r][c] = x.x, kt[r][c + 1] = x.y, kt[r][c + 2] = x.z, kt[r][c + 3] = x.w;
      vt[r][c] = y.x, vt[r][c + 1] = y.y, vt[r][c + 2] = y.z, vt[r][c + 3] = y.w;
    }
  } else {
    for (int i = threadIdx.x; i < BN * PW; i += STEP_THREADS) {
      const int c = i / BN;
      const int r = i % BN;
      const bool in = key0 + r < Sk && col0 + c < d;
      const size_t at = (size_t)(col0 + c) * pitch + key0 + r;
      kt[r][c] = in ? kh[at] : 0.0f;
      vt[r][c] = in ? vh[at] : 0.0f;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < BN * PW / 4; i += STEP_THREADS) {
    const int r = i / (PW / 4);
    const int c = (i % (PW / 4)) * 4;
    uint32_t big[4], small[4];
    split_fragment(kt[r][c], kt[r][c + 1], kt[r][c + 2], kt[r][c + 3], big, small);
    const size_t at = ((size_t)bh * Skp + key0 + r) * Dp + col0 + c;
    *reinterpret_cast<uint4*>(kb + at) = make_uint4(big[0], big[1], big[2], big[3]);
    *reinterpret_cast<uint4*>(ks + at) = make_uint4(small[0], small[1], small[2], small[3]);
    // v's row `r` of this tile is column col0 + r; its slots c .. c + 3
    // hold keys perm(c % 8 + e) of the group
    float x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int slot = (c + e) % 8;
      x[e] = vt[(c + e) - slot + (slot < 4 ? 2 * slot : 2 * (slot - 4) + 1)][r];
    }
    split_fragment(x[0], x[1], x[2], x[3], big, small);
    const size_t vt_at = ((size_t)bh * Dp + col0 + r) * Skp + key0 + c;
    *reinterpret_cast<uint4*>(vb + vt_at) = make_uint4(big[0], big[1], big[2], big[3]);
    *reinterpret_cast<uint4*>(vs + vt_at) = make_uint4(small[0], small[1], small[2], small[3]);
  }
}

// The combine: a (row, 4 columns) a thread; the s partial outputs of the
// row weighted by exp2((m_i - M) c), M the largest m_i, over the weighted
// row sums; the log-sum-exp M c ln 2 + ln L where asked for.  Threads run
// along the columns in the natural layout and along the rows in the
// transposed one, where the output's columns are rows.
template <Layout L>
__global__ void __launch_bounds__(STEP_THREADS)
combine_kernel(const float* __restrict__ ws_o, const float* __restrict__ ws_m,
               const float* __restrict__ ws_l, float* __restrict__ out, float* __restrict__ lse,
               size_t out_pitch, int B, int Sq, int H, int d, int splits, float c) {
  const size_t quads = (size_t)d / 4;
  const size_t total = (size_t)B * H * Sq * quads;
  const size_t i = (size_t)blockIdx.x * STEP_THREADS + threadIdx.x;
  if (i >= total) return;
  size_t row, cq, bh;
  if (L == Layout::natural) {
    cq = i % quads;
    row = (i / quads) % Sq;
    bh = i / quads / Sq;
  } else {
    row = i % Sq;
    cq = (i / Sq) % quads;
    bh = i / Sq / quads;
  }
  const size_t rows = (size_t)B * H * Sq;
  const size_t at = bh * Sq + row;
  float mx = -INFINITY;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, ws_m[s * rows + at]);
  float sum = 0.0f;
  float4 acc = make_float4(0, 0, 0, 0);
  for (int s = 0; s < splits; ++s) {
    const float w = exp2_approx((ws_m[s * rows + at] - mx) * c);
    sum += ws_l[s * rows + at] * w;
    const float4 x = *reinterpret_cast<const float4*>(ws_o + (s * rows + at) * d + 4 * cq);
    acc.x += x.x * w, acc.y += x.y * w, acc.z += x.z * w, acc.w += x.w * w;
  }
  const float inv = 1.0f / sum;
  const int b = (int)(bh / H), h = (int)(bh % H);
  float* ob = head_base<L>(out, out_pitch, b, Sq, h, d);
  const size_t col = 4 * cq;
  if (L == Layout::natural) {
    *reinterpret_cast<float4*>(ob + row * out_pitch + col) =
        make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv);
  } else {
    ob[col * out_pitch + row] = acc.x * inv;
    ob[(col + 1) * out_pitch + row] = acc.y * inv;
    ob[(col + 2) * out_pitch + row] = acc.z * inv;
    ob[(col + 3) * out_pitch + row] = acc.w * inv;
  }
  if (lse != nullptr && cq == 0) {
    constexpr float LN2 = 0.6931471805599453f;
    lse[at] = mx * c * LN2 + logf(sum);
  }
}

// d^-0.5 log2(e), rounded once; at d = 64 the float of 0.125 log2(e)
float scale_log2(int d) {
  return static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(d)));
}

bool takes(int B, int S, int H, int d) {
  return d >= 8 && d % 8 == 0 && d <= MAX_P * PW && B >= 1 && S >= 1 && H >= 1 &&
         B <= 65535 && H <= 65535;
}

int panels(int d) { return (d + PW - 1) / PW; }
int padded_keys(int Sk) { return (Sk + BN - 1) / BN * BN; }

// The kernel's two tensor maps over the scratch (prepass's layout): k's
// parts as 2 B H Skp rows of Dp floats, v's as 2 B H Dp rows of Skp; boxes of
// 32 floats (one 128-byte swizzled row) by 64 rows.
struct Maps {
  CUtensorMap k, v;
};

template <int P, int N, Layout L>
cudaError_t launch(const Maps& m, const Args& a, int B, cudaStream_t stream) {
  // once an instance (and a process: the attribute holds on every device)
  static const cudaError_t e = cudaFuncSetAttribute(
      flash_f32_kernel<P, N, L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Cfg<P>::SMEM_BYTES);
  if (e != cudaSuccess) return e;
  const int row_blocks = (a.Sq + Cfg<P>::ROWS - 1) / Cfg<P>::ROWS;
  const dim3 grid(row_blocks * a.splits, a.H, B);
  flash_f32_kernel<P, N, L><<<grid, THREADS, Cfg<P>::SMEM_BYTES, stream>>>(m.k, m.v, a);
  return cudaGetLastError();
}

// The instance of head dim a.d in layout L: exact widths at the d users run
// (40, 80, 160; 64 and 512 are whole panels), 64-column panels elsewhere.
template <Layout L>
cudaError_t run(const Maps& m, const Args& a, int B, cudaStream_t st) {
  switch (a.d) {
    case 40: return launch<1, 40, L>(m, a, B, st);
    case 80: return launch<2, 16, L>(m, a, B, st);
    case 160: return launch<3, 32, L>(m, a, B, st);
  }
  switch (panels(a.d)) {
    case 1: return launch<1, 64, L>(m, a, B, st);
    case 2: return launch<2, 64, L>(m, a, B, st);
    case 3: return launch<3, 64, L>(m, a, B, st);
    case 4: return launch<4, 64, L>(m, a, B, st);
    case 5: return launch<5, 64, L>(m, a, B, st);
    case 6: return launch<6, 64, L>(m, a, B, st);
    case 7: return launch<7, 64, L>(m, a, B, st);
    default: return launch<8, 64, L>(m, a, B, st);
  }
}

// Scratch: four arrays of B H Skp Dp floats (k big, k small, v big, v small).
size_t scratch_floats(int B, int Sk, int H, int d) {
  return (size_t)B * H * padded_keys(Sk) * panels(d) * PW;
}

int prepass(const float* k, const float* v, float* scratch, int B, int Sk, int H, int d,
            size_t pitch, bool transposed, cudaStream_t st) {
  if (!takes(B, Sk, H, d) || scratch == nullptr || (size_t)B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t n = scratch_floats(B, Sk, H, d);
  const int Skp = padded_keys(Sk), Dp = panels(d) * PW;
  const dim3 grid(Skp / BN, Dp / PW, B * H);
  if (transposed)
    split_kv_kernel<Layout::transposed><<<grid, STEP_THREADS, 0, st>>>(
        k, v, pitch, Sk, H, d, Skp, Dp, scratch, scratch + n, scratch + 2 * n, scratch + 3 * n);
  else
    split_kv_kernel<Layout::natural><<<grid, STEP_THREADS, 0, st>>>(
        k, v, pitch, Sk, H, d, Skp, Dp, scratch, scratch + n, scratch + 2 * n, scratch + 3 * n);
  return static_cast<int>(cudaGetLastError());
}

int core(const float* q, const float* scratch, float* out, float* lse, float* ws, int B, int Sq,
         int Sk, int H, int d, size_t q_pitch, size_t out_pitch, bool transposed, bool vec,
         int splits, cudaStream_t st) {
  const int tiles = padded_keys(Sk) / BN;
  if (!takes(B, Sq, H, d) || Sk < 1 || scratch == nullptr || splits < 1 || splits > tiles ||
      (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t n = scratch_floats(B, Sk, H, d);
  const size_t rows = (size_t)splits * B * H * Sq;
  const int Skp = padded_keys(Sk), Dp = panels(d) * PW;
  Args a = {q, out, lse, splits > 1 ? ws : nullptr, splits > 1 ? ws + rows * d : nullptr,
            splits > 1 ? ws + rows * (d + 1) : nullptr, q_pitch, out_pitch, Sq, Sk, H, d,
            Skp, Dp, splits, (tiles + splits - 1) / splits, scale_log2(d), vec};
  if ((tiles + a.chunk_tiles - 1) / a.chunk_tiles != splits)  // no chunk may be empty
    return static_cast<int>(cudaErrorInvalidValue);
  Maps m;
  const cuuint32_t box[2] = {32, 64};
  const cuuint64_t dims_k[2] = {(cuuint64_t)Dp, 2 * (cuuint64_t)B * H * Skp};
  const cuuint64_t dims_v[2] = {(cuuint64_t)Skp, 2 * (cuuint64_t)B * H * Dp};
  const cuuint64_t stride_k[1] = {(cuuint64_t)Dp * sizeof(float)};
  const cuuint64_t stride_v[1] = {(cuuint64_t)Skp * sizeof(float)};
  cudaError_t e = encode_map(&m.k, scratch, 2, dims_k, stride_k, box,
                             CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (e == cudaSuccess)
    e = encode_map(&m.v, scratch + 2 * n, 2, dims_v, stride_v, box,
                   CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(transposed ? run<Layout::transposed>(m, a, B, st)
                                     : run<Layout::natural>(m, a, B, st));
}

int combine(const float* ws, float* out, float* lse, int B, int Sq, int H, int d,
            size_t out_pitch, bool transposed, int splits, cudaStream_t st) {
  if (!takes(B, Sq, H, d) || ws == nullptr || splits < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t rows = (size_t)splits * B * H * Sq;
  const size_t threads = (size_t)B * H * Sq * (d / 4);
  const unsigned blocks = (unsigned)((threads + STEP_THREADS - 1) / STEP_THREADS);
  const float* m = ws + rows * d;
  const float* l = m + rows;
  if (transposed)
    combine_kernel<Layout::transposed><<<blocks, STEP_THREADS, 0, st>>>(
        ws, m, l, out, lse, out_pitch, B, Sq, H, d, splits, scale_log2(d));
  else
    combine_kernel<Layout::natural><<<blocks, STEP_THREADS, 0, st>>>(
        ws, m, l, out, lse, out_pitch, B, Sq, H, d, splits, scale_log2(d));
  return static_cast<int>(cudaGetLastError());
}

// The first design's entries: the pre-pass and the unsplit core on scratch
// from the stream's pool (its policy left as it is), freed in stream order
// after the core.
int unsplit(const float* q, const float* k, const float* v, float* out, float* lse, int B,
            int Sq, int Sk, int H, int d, size_t q_pitch, size_t kv_pitch, size_t out_pitch,
            bool transposed, bool vec, void* stream) {
  if (!takes(B, Sq, H, d) || Sk < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  void* scratch = nullptr;
  cudaError_t e = cudaMallocAsync(&scratch, 4 * scratch_floats(B, Sk, H, d) * sizeof(float), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  float* sc = static_cast<float*>(scratch);
  int r = prepass(k, v, sc, B, Sk, H, d, kv_pitch, transposed, st);
  if (r == 0)
    r = core(q, sc, out, lse, nullptr, B, Sq, Sk, H, d, q_pitch, out_pitch, transposed, vec, 1,
             st);
  e = cudaFreeAsync(scratch, st);
  return r != 0 ? r : static_cast<int>(e);
}

}  // namespace

// q, out: (B, Sq, H, D) float32; k, v: (B, Sk, H, D) float32; contiguous,
// 16-byte aligned; D % 8 == 0, 8 <= D <= 512; Sq, Sk >= 1.
extern "C" int gswm_flash_f32(const void* q, const void* k, const void* v, void* out, int B,
                              int Sq, int Sk, int H, int D, void* stream) {
  const size_t pitch = (size_t)H * D;
  return unsplit(static_cast<const float*>(q), static_cast<const float*>(k),
                 static_cast<const float*>(v), static_cast<float*>(out), nullptr, B, Sq, Sk, H,
                 D, pitch, pitch, pitch, false, true, stream);
}

// The same, and lse (B, H, Sq) float32: each row's log-sum-exp of its
// logits q k^T D^-0.5, natural log.
extern "C" int gswm_flash_f32_lse(const void* q, const void* k, const void* v, void* out,
                                  void* lse, int B, int Sq, int Sk, int H, int D,
                                  void* stream) {
  if (lse == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t pitch = (size_t)H * D;
  return unsplit(static_cast<const float*>(q), static_cast<const float*>(k),
                 static_cast<const float*>(v), static_cast<float*>(out),
                 static_cast<float*>(lse), B, Sq, Sk, H, D, pitch, pitch, pitch, false, true,
                 stream);
}

// qkv: (B, S, 3 * P * 128) float32, q, k and v its column bands [0, P * 128),
// [P * 128, 2 P * 128), [2 P * 128, 3 P * 128), each 2 P heads of 64; out:
// (B, S, P * 128); 16-byte aligned.
extern "C" int gswm_flash_f32_packed(const void* qkv, void* out, int B, int S, int pairs,
                                     void* stream) {
  if (pairs < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t width = (size_t)pairs * 128;
  const float* q = static_cast<const float*>(qkv);
  return unsplit(q, q + width, q + 2 * width, static_cast<float*>(out), nullptr, B, S, S,
                 2 * pairs, 64, 3 * width, 3 * width, width, false, true, stream);
}

// qkv_t: (3 * H * D, B, S) float32, q, k and v its row bands, head h's
// column c at row h * D + c of its band; out_t: (H * D, B, S); 16-byte
// aligned; D % 8 == 0, 8 <= D <= 512; any S (q by 16-byte copies where S %
// 4 == 0, 4-byte ones elsewhere).
extern "C" int gswm_flash_f32_transposed(const void* qkv_t, void* out_t, int B, int S, int H,
                                         int D, void* stream) {
  const size_t bs = (size_t)B * S;
  const size_t band = (size_t)H * D * bs;  // q's, k's and v's rows
  const float* q = static_cast<const float*>(qkv_t);
  return unsplit(q, q + band, q + 2 * band, static_cast<float*>(out_t), nullptr, B, S, S, H, D,
                 bs, bs, bs, true, S % 4 == 0, stream);
}

// The same with q's 4-byte copies at any S (the tests hold it to the 16-byte
// form).
extern "C" int gswm_flash_f32_transposed_4byte(const void* qkv_t, void* out_t, int B, int S,
                                               int H, int D, void* stream) {
  const size_t bs = (size_t)B * S;
  const size_t band = (size_t)H * D * bs;
  const float* q = static_cast<const float*>(qkv_t);
  return unsplit(q, q + band, q + 2 * band, static_cast<float*>(out_t), nullptr, B, S, S, H, D,
                 bs, bs, bs, true, false, stream);
}

// The split pre-pass: k and v of (B, Sk, H, D) heads in the natural layout
// (row pitch `pitch` floats) or of the transposed one (`transposed`, pitch
// B * S), into `scratch`, 4 B H Skp Dp floats (Skp = 64 ceil(Sk / 64), Dp =
// 64 ceil(D / 64)): k's big and small parts [key][column], then v's
// [column][key].
extern "C" int gswm_flash_f32_prepass(const void* k, const void* v, void* scratch, int B,
                                      int Sk, int H, int D, long long pitch, int transposed,
                                      void* stream) {
  return prepass(static_cast<const float*>(k), static_cast<const float*>(v),
                 static_cast<float*>(scratch), B, Sk, H, D, (size_t)pitch, transposed != 0,
                 static_cast<cudaStream_t>(stream));
}

// The core over `splits` key chunks of whole 64-key tiles (every chunk
// non-empty): q in the form's layout (`q_pitch`; transposed: `vec` 16-byte
// copies), k and v from the pre-pass's scratch.  splits == 1: the output
// (and lse, null: none) in q's layout at `out_pitch`; splits > 1: the
// partials into `ws`, splits B H Sq (D + 2) floats, for the combine.
extern "C" int gswm_flash_f32_core(const void* q, const void* scratch, void* out, void* lse,
                                   void* ws, int B, int Sq, int Sk, int H, int D,
                                   long long q_pitch, long long out_pitch, int transposed,
                                   int vec, int splits, void* stream) {
  return core(static_cast<const float*>(q), static_cast<const float*>(scratch),
              static_cast<float*>(out), static_cast<float*>(lse), static_cast<float*>(ws), B,
              Sq, Sk, H, D, (size_t)q_pitch, (size_t)out_pitch, transposed != 0, vec != 0,
              splits, static_cast<cudaStream_t>(stream));
}

// The combine of the core's `splits` > 1 partials in `ws` into out (and
// lse, null: none) in the form's layout at `out_pitch`.
extern "C" int gswm_flash_f32_combine(const void* ws, void* out, void* lse, int B, int Sq,
                                      int H, int D, long long out_pitch, int transposed,
                                      int splits, void* stream) {
  return combine(static_cast<const float*>(ws), static_cast<float*>(out),
                 static_cast<float*>(lse), B, Sq, H, D, (size_t)out_pitch, transposed != 0,
                 splits, static_cast<cudaStream_t>(stream));
}
