// ChaCha20 keystream words on the card.
//
// Replaces the Pallas TPU kernel gswm/core/chacha.py:_keystream_words_pallas
// (body _chacha_pallas_kernel): the ChaCha20 block function, 20 rounds and
// the feed-forward, for blocks counter0 .. counter0 + n_blocks - 1 of
// D. J. Bernstein's layout (constants, key[8], 64-bit counter as lo/hi words,
// nonce[2]).  The 64-bit counter is counter0 + block index with the carry into
// the high word, as chacha.py:143-145 computes it.
//
// What bounds it on an H100: nothing at the watermark's sizes.  A 512x512
// image needs 16384 bits, 32 blocks: one launch of one small block, so the
// launch itself is the cost.  At 2^20 blocks the kernel writes 64 MiB and
// executes about 80 quarter-rounds * 12 integer instructions (add, xor, funnel
// shift) per 64-byte block, some 15 instructions a byte.  The card retires
// roughly 4 integer instructions per byte of device-memory bandwidth
// (132 SMs * 64 lanes * ~1.7 GHz against 3.35 TB/s), so large keystreams are
// bound by the integer pipes, not by the store.
//
// Design: one thread per 64-byte block keeps its 16 state words in
// registers and writes its 16 output words as four 16-byte stores.  The 12
// key/counter/nonce words travel by value in the kernel's parameters, so the
// launch needs no host-to-device copy.
//
// A second kernel, chacha20_batch_kernel, serves per-user keys
// (gswm/core/multikey.py:29 _keystream_words_batch, which the JAX package
// vmaps over rows in plain XLA, and :43 batch_keystream_bits): a device
// table of R rows of the same 12 words, one thread per (row, block), and the
// output is what every consumer wants, the bits themselves, one byte a bit
// in stream order (bytes little-endian in a word, bits MSB-first in a byte):
// 512 bytes a block.  One launch makes 10,000 keystreams of 16,384 bits:
// 164 MB written against 0.31 M blocks of ~1,000 integer operations, so it is
// bound by the store, 8x the bytes of the words.  A thread's 512 bytes are
// contiguous but a warp's threads lie 512 bytes apart, so the block stages
// its WORDS in shared memory (64 bytes a thread, rows padded to 17 words
// against bank conflicts) and expands them on the way out, neighbouring
// threads writing neighbouring 16 bytes: 16 KB a block of 256 threads, so
// enough warps are resident to hide the rounds behind the stores.
//
// A third kernel, chacha20_vote_kernel, serves the two consumers of a key
// table that never need the keystream itself: attribution
// (gswm/eval/trace.py:51 find_source_device, whose jitted score at :88-92
// XLA fuses with the vmapped keystream of gswm/core/multikey.py:30) and the
// per-row decode (gswm/core/multikey.py:103 recover_message_bits_multikey).
// It computes quantized bits ^ keystream -> majority vote -> (== expected)
// .mean in one launch, from the latent's bits packed 32 to a word in stream
// order (bit i of the stream is bit i ^ 7 of word i / 32, so one XOR with a
// keystream word decrypts 32 bits).  What bounds it is ChaCha20's integer
// arithmetic: at 10,000 rows of 16,384 bits it reads 0.84 MB and writes 40 KB
// against 3.1e8 integer operations.  Design: a warp takes a row (a thread
// block of 256 threads where a row's payload outgrows a warp's 16 KB share);
// its lanes make the row's 64-byte blocks in registers, XOR them with the
// latent's words (staged in shared memory once a thread block where every
// row shares one latent) and store the payload in the warp's slice of shared
// memory, byte-swapped so that the stream reads as one big-endian bit string,
// so no keystream or payload reaches device memory.  The vote counts from
// there, 32 positions at a time: a segment's word q is the 32 stream bits
// from segment start + 32 q (one funnel shift of two payload words where the
// segment does not start on a word), added into bit-sliced counters (plane i
// holds bit i of 32 positions' counts; two words added by one full adder and
// a ripple of the carry); the segments are split among the lanes and the
// partial counts added across them by shuffles.  A popcount of the voted
// bits against the expected ones gives the matches, and the score is
// matches * fl(1 / message_bits) in float32, which is what the JAX package's
// jitted mean computes (XLA folds the division by a constant into a
// multiplication by its reciprocal).
//
// Rows past VOTE_MAX_BLOCKS (1,835,008 bits: a 2048x2048 image at l = 8 is
// 2,097,152) have no room for their payload in shared memory, so
// chacha20_vote_stream_kernel walks them: a cluster of `splits` thread
// blocks a row (1 to 8), each block counting the windows that start in its
// share of the row's stream, its payload made a chunk of at most
// STREAM_FILL blocks at a time into shared memory (32 KB; the latent's words
// read through L2, where one latent shared by every row stays), and each
// thread's bit-sliced counts carried in registers from one chunk to the
// next.  Thread (g, q) counts word q of the segments g, g + gs, ... (gs =
// 256 / the message's words, at least 1); a chunk starts at the block of the
// smallest window any thread still has to count, so a message longer than
// 256 words, whose words are counted 256 at a time, skips the stream between
// the windows it needs; the cluster's counts meet in the first block's
// shared memory, each thread adding its peers' through distributed shared
// memory, and then the gs groups' in a tree, before the vote.  A block is
// latency-bound (its ChaCha20 blocks made in turn, two blocks an SM at 114
// registers a thread), so fewer rows than SMs (a probe against a few
// records, a decode of a few images) leave SMs idle with a block a row: the
// split puts a row on up to 8 while rows * splits stays within the SM count
// (``chacha.vote_splits``); from there on a block a row is fastest.  It
// writes no keystream or payload either.
//
// chacha20_embed_kernel is K3's table ending in the multikey embed
// (gswm/core/multikey.py:65 embed_latents_multikey, whose keystream, XOR and
// _bits_to_latent XLA runs apart): per (key, nonce) row, the keystream XOR
// the row's diffused payload packed 32 bits a word, the l-bit big-endian
// windows y, p = clamp((u + y) 2^-l, 1e-7, 1 - 1e-7) and z = ndtri(p), in
// one launch, so neither the keystream nor the cipher bits reach device
// memory (the table kernel wrote them a byte a bit: 164 MB at 10,000 rows of
// 16,384 bits).  What bounds it is the bytes of u read and z written, 8 an
// element, against 640 XORs and rotations a ChaCha20 block and some 40
// floating-point operations an element.  Design: a thread block takes 2048
// elements of a row, 4 l whole ChaCha20 blocks (2048 l bits); its first 4 l
// threads make them, XOR the payload's words and leave the cipher words
// byte-swapped in shared memory (every thread's u already in flight); then
// every thread takes 4 elements twice, their 4 l bits one funnel shift of
// two words, u read and z written as 16-byte vectors.  ndtri is cephes'
// rational approximation as torch.special.ndtri computes it on the card in
// float32 (the same coefficients rounded to float, the same operations in
// the same order); its tails, a third of the elements and most of the
// arithmetic, are packed a warp at a time so no lane waits on another's
// branch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

struct ChachaParams {
  uint32_t key[8];
  uint32_t counter_lo;
  uint32_t counter_hi;
  uint32_t nonce[2];
};

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int n) {
  return (x << n) | (x >> (32 - n));
}

#define GSWM_QR(a, b, c, d)      \
  a += b; d = rotl32(d ^ a, 16); \
  c += d; b = rotl32(b ^ c, 12); \
  a += b; d = rotl32(d ^ a, 8);  \
  c += d; b = rotl32(b ^ c, 7);

// The 20 rounds and the feed-forward on x, whose entry values are the block's
// initial state.
__device__ __forceinline__ void chacha20_block(uint32_t (&x)[16]) {
  uint32_t init[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) init[i] = x[i];
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    GSWM_QR(x[0], x[4], x[8], x[12]);
    GSWM_QR(x[1], x[5], x[9], x[13]);
    GSWM_QR(x[2], x[6], x[10], x[14]);
    GSWM_QR(x[3], x[7], x[11], x[15]);
    GSWM_QR(x[0], x[5], x[10], x[15]);
    GSWM_QR(x[1], x[6], x[11], x[12]);
    GSWM_QR(x[2], x[7], x[8], x[13]);
    GSWM_QR(x[3], x[4], x[9], x[14]);
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] += init[i];
}

#undef GSWM_QR

__global__ void chacha20_words_kernel(ChachaParams p, uint4* __restrict__ out,
                                      int n_blocks) {
  const int blk = blockIdx.x * blockDim.x + threadIdx.x;
  if (blk >= n_blocks) return;
  const uint32_t idx = static_cast<uint32_t>(blk);
  const uint32_t lo = p.counter_lo + idx;
  const uint32_t hi = p.counter_hi + (lo < idx ? 1u : 0u);  // carry

  uint32_t x[16] = {0x61707865u, 0x3320646Eu, 0x79622D32u, 0x6B206574u,
                    p.key[0], p.key[1], p.key[2], p.key[3],
                    p.key[4], p.key[5], p.key[6], p.key[7],
                    lo, hi, p.nonce[0], p.nonce[1]};
  chacha20_block(x);
  uint4* dst = out + static_cast<size_t>(blk) * 4;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    dst[q] = make_uint4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
}

// The 4 bits of a nibble as 4 bytes of 0 or 1, most significant bit in the
// lowest byte: the copies n, n << 9, n << 18, n << 27 do not overlap, and bits
// 3, 11, 19, 27 of their sum are the nibble's bits 3, 2, 1, 0.
__device__ __forceinline__ uint32_t nibble_bits(uint32_t nibble) {
  return ((nibble * 0x08040201u) >> 3) & 0x01010101u;
}

constexpr int BATCH_THREADS = 256;  // ChaCha20 blocks a thread block makes
constexpr int STAGE_PITCH = 17;     // words a staged block: 16 and one of padding

// table: R rows of key[8], counter lo, counter hi, nonce[2].  out: (R, n_bits)
// bytes.  Thread block b makes the flat (row, block) indices b * 256 ... + 255;
// rows * n_blocks is below 2^31.
template <bool VEC>
__global__ void __launch_bounds__(BATCH_THREADS)
chacha20_batch_kernel(const uint32_t* __restrict__ table, uint8_t* __restrict__ out,
                      int rows, int n_blocks, int n_bits) {
  __shared__ uint32_t stage[BATCH_THREADS * STAGE_PITCH];
  const int t = threadIdx.x;
  const uint32_t total = (uint32_t)rows * (uint32_t)n_blocks;
  const uint32_t first = blockIdx.x * BATCH_THREADS;
  const uint32_t flat = first + t;
  if (flat < total) {
    const uint32_t row = flat / n_blocks;
    const uint32_t idx = flat - row * n_blocks;
    const uint32_t* p = table + (size_t)row * 12;
    const uint32_t lo = p[8] + idx;
    const uint32_t hi = p[9] + (lo < idx ? 1u : 0u);  // carry
    uint32_t x[16] = {0x61707865u, 0x3320646Eu, 0x79622D32u, 0x6B206574u,
                      p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7],
                      lo, hi, p[10], p[11]};
    chacha20_block(x);
#pragma unroll
    for (int w = 0; w < 16; ++w) stage[t * STAGE_PITCH + w] = x[w];
  }
  __syncthreads();
  // chunk g of this thread block: 16 bits, the half c % 2 of word c / 2 (c = g %
  // 32) of the block that thread g / 32 staged; a warp writes 512 bytes in a row
#pragma unroll 4
  for (int g = t; g < BATCH_THREADS * 32; g += BATCH_THREADS) {
    const int src = g >> 5, c = g & 31;
    const uint32_t f = first + src;
    if (f >= total) break;
    const uint32_t row = f / n_blocks;
    const int bit0 = (int)(f - row * n_blocks) * 512 + c * 16;  // first bit, in its row
    if (bit0 >= n_bits) continue;
    const uint32_t half = stage[src * STAGE_PITCH + (c >> 1)] >> (16 * (c & 1));
    // two bytes in stream order; each byte's high nibble comes first
    const uint4 v = make_uint4(nibble_bits((half >> 4) & 15u), nibble_bits(half & 15u),
                               nibble_bits((half >> 12) & 15u), nibble_bits((half >> 8) & 15u));
    uint8_t* dst = out + (size_t)row * n_bits + bit0;
    if (VEC && bit0 + 16 <= n_bits) {
      *reinterpret_cast<uint4*>(dst) = v;
    } else {
      const uint8_t* b = reinterpret_cast<const uint8_t*>(&v);
      for (int i = 0; i < 16 && bit0 + i < n_bits; ++i) dst[i] = b[i];
    }
  }
}

// ---- the table kernel that ends in the vote ---------------------------------

constexpr int VOTE_THREADS = 128;      // warp mode: a row a warp, four a thread block
constexpr int VOTE_ROW_THREADS = 256;  // block mode: a row a thread block
constexpr int VOTE_WARP_BLOCKS = 256;  // ChaCha20 blocks a row in warp mode (16 KB)
constexpr int VOTE_MAX_BLOCKS = 3584;  // block mode: 224 KB of payload a row

__device__ __forceinline__ uint32_t maj3(uint32_t a, uint32_t b, uint32_t c) {
  return (a & b) | (c & (a ^ b));
}

// a packed word (stream bit i at bit i ^ 7) with stream bit i at bit 31 - i
__device__ __forceinline__ uint32_t big_endian(uint32_t w) { return __byte_perm(w, 0, 0x0123); }

// c: D bit planes, plane i bit j = bit i of position j's count; adds x1 + x2
template <int D>
__device__ __forceinline__ void add_two(uint32_t (&c)[D], uint32_t x1, uint32_t x2) {
  uint32_t carry = maj3(c[0], x1, x2);
  c[0] ^= x1 ^ x2;
#pragma unroll
  for (int i = 1; i < D; ++i) {
    const uint32_t t = c[i] & carry;
    c[i] ^= carry;
    carry = t;
  }
}

// the positions whose count exceeds k (k < 2^D)
template <int D>
__device__ __forceinline__ uint32_t greater_than(const uint32_t (&c)[D], uint32_t k) {
  uint32_t gt = 0, eq = ~0u;
#pragma unroll
  for (int i = D - 1; i >= 0; --i) {
    if ((k >> i) & 1u) {
      eq &= c[i];
    } else {
      gt |= eq & c[i];
      eq &= ~c[i];
    }
  }
  return gt;
}

// A voted word v (message bit 32 q + i at bit 31 - i) at word position q of
// the message: its valid bits written as bytes in stream order, and its
// matches with the expected word returned.
__device__ __forceinline__ int finish_word(uint32_t v, int q, int mb, const uint32_t* exp_row,
                                           uint8_t* out_row) {
  const int valid = min(32, mb - 32 * q);
  if (out_row) {
    uint8_t* dst = out_row + 32 * q;
    if (valid == 32 && (mb & 15) == 0) {  // 16-byte aligned
      uint32_t w[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) w[j] = nibble_bits((v >> (28 - 4 * j)) & 15u);
      reinterpret_cast<uint4*>(dst)[0] = make_uint4(w[0], w[1], w[2], w[3]);
      reinterpret_cast<uint4*>(dst)[1] = make_uint4(w[4], w[5], w[6], w[7]);
    } else {
      for (int i = 0; i < valid; ++i) dst[i] = static_cast<uint8_t>((v >> (31 - i)) & 1u);
    }
  }
  if (!exp_row) return 0;
  const uint32_t mask = valid == 32 ? ~0u : ~(~0u >> valid);  // the top `valid` bits
  return __popc(~(v ^ big_endian(exp_row[q])) & mask);
}

// table: rows x 12 words.  latent: one row (shared_latent) or one a table
// row, each n_blocks * 16 words (the packed bits, zero-filled).  expected:
// rows x ceil(mb / 32) words, or null; with it, scores[row] = matches / mb.
// voted: rows x mb bytes, or null.  GROUP threads take a row; D bit planes
// count a position's votes (segments < 2^D).  A payload slice holds
// n_blocks * 16 words and 4 more, which a window past the last segment may
// read (its bits beyond the message are masked).
template <int GROUP, int D>
__global__ void __launch_bounds__(GROUP == 32 ? VOTE_THREADS : VOTE_ROW_THREADS)
chacha20_vote_kernel(const uint32_t* __restrict__ table, const uint32_t* __restrict__ latent,
                     int shared_latent, const uint32_t* __restrict__ expected,
                     float* __restrict__ scores, uint8_t* __restrict__ voted, int rows,
                     int n_bits, int mb) {
  constexpr int THREADS = GROUP == 32 ? VOTE_THREADS : VOTE_ROW_THREADS;
  constexpr int GROUPS = THREADS / GROUP;
  extern __shared__ __align__(16) uint32_t smem[];
  const int n_blocks = (n_bits + 511) >> 9;
  const int slice = n_blocks * 16;  // words a latent row
  const int segs = n_bits / mb;     // only complete segments vote
  const int vote_words = (int)(((long long)segs * mb + 31) >> 5);
  const bool stage = GROUPS > 1 && shared_latent;
  int* sums = reinterpret_cast<int*>(smem + (stage ? slice : 0));  // 4 words
  const int grp = threadIdx.x / GROUP, t = threadIdx.x % GROUP;
  uint32_t* pay = smem + (stage ? slice : 0) + 4 + grp * (slice + 4);
  const int row = blockIdx.x * GROUPS + grp;
  if (stage) {
    const uint4* src = reinterpret_cast<const uint4*>(latent);
    uint4* dst = reinterpret_cast<uint4*>(smem);
    for (int i = threadIdx.x; i < slice / 4; i += THREADS) dst[i] = src[i];
  }
  if (threadIdx.x < GROUPS) sums[threadIdx.x] = 0;
  __syncthreads();
  if (row >= rows) return;  // a whole warp (warp mode); no block barrier follows

  const uint32_t* p = table + (size_t)row * 12;
  uint32_t key[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) key[i] = __ldg(p + i);
  const uint4* lat = stage ? reinterpret_cast<const uint4*>(smem)
                           : reinterpret_cast<const uint4*>(
                                 latent + (shared_latent ? 0 : (size_t)row * slice));
  // the blocks that hold voting bits, a block a thread at a time
  for (int b = t; 16 * b < vote_words; b += GROUP) {
    const uint32_t idx = static_cast<uint32_t>(b);
    const uint32_t lo = key[8] + idx;
    const uint32_t hi = key[9] + (lo < idx ? 1u : 0u);  // carry
    uint32_t x[16] = {0x61707865u, 0x3320646Eu, 0x79622D32u, 0x6B206574u,
                      key[0], key[1], key[2], key[3], key[4], key[5], key[6], key[7],
                      lo, hi, key[10], key[11]};
    chacha20_block(x);
    uint4* dst = reinterpret_cast<uint4*>(pay) + 4 * b;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 l = lat[4 * b + q];
      dst[q] = make_uint4(big_endian(x[4 * q] ^ l.x), big_endian(x[4 * q + 1] ^ l.y),
                          big_endian(x[4 * q + 2] ^ l.z), big_endian(x[4 * q + 3] ^ l.w));
    }
  }
  if (GROUP == 32) __syncwarp(); else __syncthreads();

  const uint32_t* exp_row = expected ? expected + (size_t)row * ((mb + 31) >> 5) : nullptr;
  uint8_t* out_row = voted ? voted + (size_t)row * mb : nullptr;
  const uint32_t half = (uint32_t)segs >> 1;  // a 1 needs a count above segs / 2
  const int mbw = (mb + 31) >> 5;             // words a segment
  // word q of segment s: the 32 stream bits from s * mb + 32 q
  auto window = [&](int s, int q) -> uint32_t {
    const int o = s * mb + 32 * q, k = o >> 5, sh = o & 31;
    return sh ? __funnelshift_l(pay[k + 1], pay[k], sh) : pay[k];
  };
  int matches = 0;
  if (mbw <= 32) {
    if (t < 32) {
      // the group's first warp: lane (g, q) counts word q of segments g,
      // g + gs, g + 2 gs, ... and the gs partial counts meet by shuffles
      const int gs = 32 / mbw, q = t % mbw, g = t / mbw;
      uint32_t c[D];
#pragma unroll
      for (int i = 0; i < D; ++i) c[i] = 0;
      if (g < gs) {
        for (int s = g; s < segs; s += 2 * gs)
          add_two(c, window(s, q), s + gs < segs ? window(s + gs, q) : 0u);
      }
      for (int st = 1; st < gs; st <<= 1) {
        const bool take = g % (2 * st) == 0 && g + st < gs;
        uint32_t carry = 0;
#pragma unroll
        for (int i = 0; i < D; ++i) {
          const uint32_t o = __shfl_down_sync(0xffffffffu, c[i], st * mbw);
          if (take) {
            const uint32_t a = c[i];
            c[i] = a ^ o ^ carry;
            carry = maj3(a, o, carry);
          }
        }
      }
      if (g == 0) matches += finish_word(greater_than(c, half), q, mb, exp_row, out_row);
    }
  } else {
    for (int q = t; q < mbw; q += GROUP) {
      uint32_t c[D];
#pragma unroll
      for (int i = 0; i < D; ++i) c[i] = 0;
      for (int s = 0; s < segs; s += 2)
        add_two(c, window(s, q), s + 1 < segs ? window(s + 1, q) : 0u);
      matches += finish_word(greater_than(c, half), q, mb, exp_row, out_row);
    }
  }
  if (exp_row) {
    // matches * fl(1 / mb): the JAX package's jitted mean, bit for bit
    const float inv = __frcp_rn(static_cast<float>(mb));
    matches = __reduce_add_sync(0xffffffffu, matches);
    if (GROUP == 32) {
      if (t == 0) scores[row] = __fmul_rn(static_cast<float>(matches), inv);
    } else {
      if ((t & 31) == 0) atomicAdd(&sums[grp], matches);
      __syncthreads();
      if (t == 0) scores[row] = __fmul_rn(static_cast<float>(sums[grp]), inv);
    }
  }
}

// ---- the vote past VOTE_MAX_BLOCKS: the payload a chunk at a time ------------

constexpr int STREAM_THREADS = 256;
constexpr int STREAM_FILL = 512;  // blocks of payload a chunk at most: 32 KB
constexpr int STREAM_MAX_SPLITS = 8;  // thread blocks a row: a portable cluster
constexpr int NO_BLOCK = 0x7fffffff;

// the big-endian payload words of stream blocks [b0, b0 + fill) of the row
// into pay: past n_blocks zeros; past `need` (no window reads there) not
// made
__device__ __forceinline__ void fill_chunk(uint32_t* pay, const uint32_t (&key)[12],
                                           const uint4* lat, int b0, int fill, int n_blocks,
                                           int need) {
  for (int i = threadIdx.x; i < fill; i += STREAM_THREADS) {
    const int b = b0 + i;
    uint4* dst = reinterpret_cast<uint4*>(pay) + 4 * i;
    if (b >= need) {
      if (b >= n_blocks) {
#pragma unroll
        for (int q = 0; q < 4; ++q) dst[q] = make_uint4(0u, 0u, 0u, 0u);
      }
      continue;
    }
    const uint32_t idx = static_cast<uint32_t>(b);
    const uint32_t lo = key[8] + idx;
    const uint32_t hi = key[9] + (lo < idx ? 1u : 0u);  // carry
    uint32_t x[16] = {0x61707865u, 0x3320646Eu, 0x79622D32u, 0x6B206574u,
                      key[0], key[1], key[2], key[3], key[4], key[5], key[6], key[7],
                      lo, hi, key[10], key[11]};
    chacha20_block(x);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 l = __ldg(lat + 4 * (size_t)b + q);
      dst[q] = make_uint4(big_endian(x[4 * q] ^ l.x), big_endian(x[4 * q + 1] ^ l.y),
                          big_endian(x[4 * q + 2] ^ l.z), big_endian(x[4 * q + 3] ^ l.w));
    }
  }
}

// c += the D planes at `b` (a plane every STREAM_THREADS words)
template <int D>
__device__ __forceinline__ void add_planes(uint32_t (&c)[D], const uint32_t* b) {
  uint32_t carry = 0;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    const uint32_t a = c[i], x = b[i * STREAM_THREADS];
    c[i] = a ^ x ^ carry;
    carry = maj3(a, x, carry);
  }
}

// The vote kernel's function (chacha20_vote_kernel's arguments) at any row
// length: grid (rows * splits) of STREAM_THREADS threads in clusters of
// splits, a cluster a row; rank r counts the windows that start in stream
// blocks [r span, (r + 1) span), `fill` blocks of payload a chunk (fill <=
// STREAM_FILL; a window reads a word past its start only where mb % 32 !=
// 0, and a chunk then holds the block past its windows); D bit planes
// (segments < 2^D).
template <int D>
__global__ void __launch_bounds__(STREAM_THREADS)
chacha20_vote_stream_kernel(const uint32_t* __restrict__ table,
                            const uint32_t* __restrict__ latent, int shared_latent,
                            const uint32_t* __restrict__ expected, float* __restrict__ scores,
                            uint8_t* __restrict__ voted, int n_bits, int mb, int span,
                            int fill) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* pay = smem;                                  // fill * 16 words
  uint32_t* red = smem + fill * 16;                      // D planes a thread
  int* first = reinterpret_cast<int*>(red + STREAM_THREADS * D);  // the chunk's block
  int* sums = first + 1;                                 // the row's matches
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int t = threadIdx.x, row = blockIdx.x / splits;
  const int n_blocks = (n_bits + 511) >> 9;
  const int segs = n_bits / mb;  // only complete segments vote
  const long long vote_bits = (long long)segs * mb;
  // blocks a window reads: the voting bits and one word past them
  const int need = (int)min((long long)n_blocks, (vote_bits + 32 + 511) >> 9);
  // the stream bits where this block's windows start
  const long long lo = (long long)rank * span * 512, hi = lo + (long long)span * 512;
  const int mbw = (mb + 31) >> 5;
  const int past = (mb & 31) ? 1 : 0;         // the block past a chunk's windows
  const uint32_t half = (uint32_t)segs >> 1;  // a 1 needs a count above segs / 2
  const uint32_t* p = table + (size_t)row * 12;
  uint32_t key[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) key[i] = __ldg(p + i);
  const uint4* lat = reinterpret_cast<const uint4*>(
      latent + (shared_latent ? 0 : (size_t)row * n_blocks * 16));
  const uint32_t* exp_row = expected ? expected + (size_t)row * mbw : nullptr;
  uint8_t* out_row = voted ? voted + (size_t)row * mb : nullptr;
  if (t == 0) *sums = 0;

  const int qt = min(mbw, STREAM_THREADS);  // message words a pass
  const int gs = STREAM_THREADS / qt;       // segment groups
  const int grp = t / qt, qi = t % qt;
  int matches = 0;
  for (int q0 = 0; q0 < mbw; q0 += qt) {
    const int q = q0 + qi;
    const bool mine = grp < gs && q < mbw;
    uint32_t c[D];
#pragma unroll
    for (int i = 0; i < D; ++i) c[i] = 0;
    // the first segment whose word q starts at or past lo, then every gs-th
    const long long q_bits = 32ll * q;
    int s = (int)(lo > q_bits ? (lo - q_bits + mb - 1) / mb : 0) + grp;
    // the next window this thread counts: word q of segment s
    auto start = [&](int seg) -> long long {
      const long long at = (long long)seg * mb + q_bits;
      return mine && seg < segs && at < hi ? at : LLONG_MAX;
    };
    long long o = start(s);
    for (;;) {
      __syncthreads();  // the last chunk's windows are read; `first` is free
      if (t == 0) *first = NO_BLOCK;
      __syncthreads();
      const int mine_block = o == LLONG_MAX ? NO_BLOCK : (int)(o >> 9);
      const int warp_first = __reduce_min_sync(0xffffffffu, mine_block);
      if ((t & 31) == 0) atomicMin(first, warp_first);
      __syncthreads();
      const int b0 = *first;
      if (b0 == NO_BLOCK) break;  // every thread's windows are counted
      fill_chunk(pay, key, lat, b0, fill, n_blocks, need);
      __syncthreads();
      // the windows that start in the chunk's first fill - past blocks
      const long long end = (long long)(b0 + fill - past) * 512;
      const long long w0 = (long long)b0 * 16;  // the stream word of pay[0]
      auto window = [&](long long at) -> uint32_t {
        const int k = (int)((at >> 5) - w0), sh = (int)(at & 31);
        return sh ? __funnelshift_l(pay[k + 1], pay[k], sh) : pay[k];
      };
      while (o < end) {
        const uint32_t x1 = window(o);
        s += gs;
        o = start(s);
        uint32_t x2 = 0u;
        if (o < end) {
          x2 = window(o);
          s += gs;
          o = start(s);
        }
        add_two(c, x1, x2);
      }
    }
    // every thread's planes in its slot; the cluster's meet in rank 0, each
    // thread adding its peers' slot, then the groups' in a tree into group 0
#pragma unroll
    for (int i = 0; i < D; ++i) red[i * STREAM_THREADS + t] = c[i];
    if (splits > 1) {
      cluster.sync();
      if (rank == 0) {
        for (int r = 1; r < splits; ++r) add_planes(c, cluster.map_shared_rank(red, r) + t);
#pragma unroll
        for (int i = 0; i < D; ++i) red[i * STREAM_THREADS + t] = c[i];
      }
      cluster.sync();  // every rank keeps its planes until rank 0 has read them
    }
    if (rank == 0) {
      int top = 1;
      while (2 * top < gs) top *= 2;
      for (int st = top; st >= 1 && gs > 1; st >>= 1) {
        __syncthreads();  // the slots of the step before are written
        if (grp < st && grp + st < gs) {
          add_planes(c, red + (grp + st) * qt + qi);
#pragma unroll
          for (int i = 0; i < D; ++i) red[i * STREAM_THREADS + t] = c[i];
        }
      }
    }
    if (rank == 0 && grp == 0 && q < mbw)
      matches += finish_word(greater_than(c, half), q, mb, exp_row, out_row);
  }
  if (exp_row && rank == 0) {
    // matches * fl(1 / mb): the JAX package's jitted mean, bit for bit
    matches = __reduce_add_sync(0xffffffffu, matches);
    if ((t & 31) == 0) atomicAdd(sums, matches);
    __syncthreads();
    if (t == 0) scores[row] = __fmul_rn(static_cast<float>(*sums), __frcp_rn(static_cast<float>(mb)));
  }
}

// ---- the table kernel that ends in the multikey embed -----------------------

constexpr int EMBED_THREADS = 256;
constexpr int EMBED_ELEMS = 2048;  // elements a thread block: 4 l ChaCha20 blocks

// cephes' polevl as torch's ndtri on the card runs it: coef[0] the highest
// power, len coefficients
template <int LEN>
__device__ __forceinline__ float polevl(float x, const float (&a)[LEN]) {
  float r = 0.0f;
#pragma unroll
  for (int i = 0; i < LEN; ++i) r = r * x + a[i];
  return r;
}

// ndtri on float32: aten/src/ATen/native/cuda/Math.cuh's ndtri_string, which
// torch.special.ndtri compiles for a CUDA float tensor, by hand: the same
// float coefficients and the same operations in the same order, in its two
// parts.  y0 lies in [1e-7, 1 - 1e-7] here (the clamp), so the ends' cases
// (0, 1, outside [0, 1]) never arise.  The central part takes exp(-2) < y0
// <= 1 - exp(-2); the tails take the rest, y0 folded to y = 1 - y0 above
// 1 - exp(-2), the side as the sign of s = y (left) or -y (right).
constexpr float EXP_M2 = (float)0.13533528323661269189;  // exp(-2)

__device__ __forceinline__ bool ndtri_is_tail(float y0) {
  return y0 > 1.0f - EXP_M2 || !(y0 > EXP_M2);
}

__device__ __forceinline__ float ndtri_center(float y0) {
  constexpr float P0[5] = {-5.99633501014107895267E1, 9.80010754185999661536E1,
                           -5.66762857469070293439E1, 1.39312609387279679503E1,
                           -1.23916583867381258016E0};
  constexpr float Q0[9] = {1.00000000000000000000E0,  1.95448858338141759834E0,
                           4.67627912898881538453E0,  8.63602421390890590575E1,
                           -2.25462687854119370527E2, 2.00260212380060660359E2,
                           -8.20372256168333339912E1, 1.59056225126211695515E1,
                           -1.18331621121330003142E0};
  constexpr float s2pi = 2.50662827463100050242E0;
  const float y = y0 - 0.5f;
  const float y2 = y * y;
  const float x = y + y * (y2 * polevl(y2, P0) / polevl(y2, Q0));
  return x * s2pi;
}

__device__ __forceinline__ float ndtri_tail(float s) {
  const float y = fabsf(s);
  const float x = sqrtf(-2.0f * logf(y));
  const float x0 = x - (logf(x) / x);
  const float z = 1.0f / x;
  float x1;
  if (x < 8.0f) {  // y above exp(-32): every y here
    constexpr float P1[9] = {4.05544892305962419923E0,   3.15251094599893866154E1,
                             5.71628192246421288162E1,   4.40805073893200834700E1,
                             1.46849561928858024014E1,   2.18663306850790267539E0,
                             -1.40256079171354495875E-1, -3.50424626827848203418E-2,
                             -8.57456785154685413611E-4};
    constexpr float Q1[9] = {1.00000000000000000000E0,   1.57799883256466749731E1,
                             4.53907635128879210584E1,   4.13172038254672030440E1,
                             1.50425385692907503408E1,   2.50464946208309415979E0,
                             -1.42182922854787788574E-1, -3.80806407691578277194E-2,
                             -9.33259480895457427372E-4};
    x1 = z * polevl(z, P1) / polevl(z, Q1);
  } else {
    constexpr float P2[9] = {3.23774891776946035970E0,  6.91522889068984211695E0,
                             3.93881025292474443415E0,  1.33303460815807542389E0,
                             2.01485389549179081538E-1, 1.23716634817820021358E-2,
                             3.01581553508235416007E-4, 2.65806974686737550832E-6,
                             6.23974539184983293730E-9};
    constexpr float Q2[9] = {1.00000000000000000000E0,  6.02427039364742014255E0,
                             3.67983563856160859403E0,  1.37702099489081330271E0,
                             2.16236993594496635890E-1, 1.34204006088543189037E-2,
                             3.28014464682127739104E-4, 2.89247864745380683936E-6,
                             6.79019408009981274425E-9};
    x1 = z * polevl(z, P2) / polevl(z, Q2);
  }
  const float r = x0 - x1;
  return s > 0.0f ? -r : r;
}

// table: rows x 12 words.  payload: rows x n_blocks * 16 words, the diffused
// payload's bits packed in stream order (chacha.pack_bits).  u, z: rows x
// elements float32.  Grid: rows x ceil(elements / EMBED_ELEMS) blocks, the
// chunks of a row in a run.  VEC: elements % 4 == 0 (16-byte rows of u, z).
// A thread takes 4 elements at 4 g and 4 g + 1024 of the chunk.  ndtri's
// tails (about 27% of uniform p) cost some three times its centre: run in
// place they would hold every lane of a warp, so each warp first writes its
// tail elements' folded y into its slice of shared memory, packed by ballot,
// maps them 32 at a time, and takes them back.  Six blocks an SM (40
// registers): the card timed that ahead of the unbounded build's 52
// registers (four blocks) and of seven or eight (32 registers, spilling),
// u's loads and z's stores overlapping ndtri's arithmetic the more warps
// there are.
template <bool VEC>
__global__ void __launch_bounds__(EMBED_THREADS, 6)
chacha20_embed_kernel(const uint32_t* __restrict__ table, const uint32_t* __restrict__ payload,
                      const float* __restrict__ u, float* __restrict__ z, int elements, int l,
                      int chunks) {
  constexpr int PER = EMBED_ELEMS / EMBED_THREADS;  // elements a thread: 8
  __shared__ __align__(16) uint32_t cw[EMBED_ELEMS * 8 / 32 + 4];  // l <= 8, a word of pad
  __shared__ float tails[EMBED_ELEMS];  // a warp's PER * 32
  const int row = blockIdx.x / chunks, chunk = blockIdx.x - row * chunks;
  const int t = threadIdx.x, lane = t & 31;
  const int n_blocks = (int)(((long long)elements * l + 511) >> 9);
  const int b0 = chunk * 4 * l;  // the chunk's first ChaCha20 block
  const int nb = min(4 * l, n_blocks - b0);
  const int e_chunk = chunk * EMBED_ELEMS;
  const size_t base = (size_t)row * elements;

  // u first: its loads are in flight while the chunk's blocks are made
  float uv[PER];
#pragma unroll
  for (int j = 0; j < PER / 4; ++j) {
    const int e = e_chunk + 4 * (t + j * EMBED_THREADS);
    if (VEC && e + 4 <= elements) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(u + base + e));
      uv[4 * j] = v.x, uv[4 * j + 1] = v.y, uv[4 * j + 2] = v.z, uv[4 * j + 3] = v.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) uv[4 * j + i] = e + i < elements ? __ldg(u + base + e + i) : 0.0f;
    }
  }
  if (t < nb) {
    const uint32_t* p = table + (size_t)row * 12;
    const uint32_t idx = static_cast<uint32_t>(b0 + t);
    const uint32_t lo = __ldg(p + 8) + idx;
    const uint32_t hi = __ldg(p + 9) + (lo < idx ? 1u : 0u);  // carry
    uint32_t x[16] = {0x61707865u, 0x3320646Eu, 0x79622D32u, 0x6B206574u,
                      __ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3),
                      __ldg(p + 4), __ldg(p + 5), __ldg(p + 6), __ldg(p + 7),
                      lo, hi, __ldg(p + 10), __ldg(p + 11)};
    chacha20_block(x);
    const uint4* pl = reinterpret_cast<const uint4*>(
        payload + ((size_t)row * n_blocks + b0 + t) * 16);
    uint4* dst = reinterpret_cast<uint4*>(cw) + 4 * t;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 w = __ldg(pl + q);
      dst[q] = make_uint4(big_endian(x[4 * q] ^ w.x), big_endian(x[4 * q + 1] ^ w.y),
                          big_endian(x[4 * q + 2] ^ w.z), big_endian(x[4 * q + 3] ^ w.w));
    }
  }
  if (t == 0) cw[nb * 16] = 0u;  // a window's second word past the last block
  __syncthreads();

  // p = clamp((u + y) 2^-l), each step rounded as the plain version's
  // float32 tensors are; the tails packed into the warp's slice
  const float scale = __int_as_float((127 - l) << 23);  // 2^-l
  const uint32_t mask = (1u << l) - 1u;
  float* slice = tails + (t >> 5) * (32 * PER);
  float p[PER];
  int at[PER];
  int n_tail = 0;
#pragma unroll
  for (int j = 0; j < PER / 4; ++j) {
    const int o = 4 * (t + j * EMBED_THREADS) * l, k = o >> 5, sh = o & 31;
    const uint32_t w = sh ? __funnelshift_l(cw[k + 1], cw[k], sh) : cw[k];  // bits o ... o + 31
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = 4 * j + i;
      const uint32_t y = (w >> (32 - (i + 1) * l)) & mask;
      const float v = __fmul_rn(__fadd_rn(uv[q], static_cast<float>(y)), scale);
      p[q] = fminf(fmaxf(v, 1e-7f), (float)(1.0 - 1e-7));
      const bool tail = ndtri_is_tail(p[q]);
      const unsigned m = __ballot_sync(0xffffffffu, tail);
      at[q] = tail ? n_tail + __popc(m & ((1u << lane) - 1u)) : -1;
      if (tail) slice[at[q]] = p[q] > 1.0f - EXP_M2 ? -(1.0f - p[q]) : p[q];
      n_tail += __popc(m);
    }
  }
  __syncwarp();
  for (int i = lane; i < n_tail; i += 32) slice[i] = ndtri_tail(slice[i]);
  __syncwarp();
#pragma unroll
  for (int j = 0; j < PER / 4; ++j) {
    const int e = e_chunk + 4 * (t + j * EMBED_THREADS);
    float zq[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = 4 * j + i;
      zq[i] = at[q] >= 0 ? slice[at[q]] : ndtri_center(p[q]);
    }
    if (VEC && e + 4 <= elements) {
      *reinterpret_cast<float4*>(z + base + e) = make_float4(zq[0], zq[1], zq[2], zq[3]);
    } else {
      for (int i = 0; i < 4 && e + i < elements; ++i) z[base + e + i] = zq[i];
    }
  }
}

template <int GROUP, int D>
cudaError_t launch_vote(unsigned grid, size_t smem, cudaStream_t st, const uint32_t* table,
                        const uint32_t* latent, int shared_latent, const uint32_t* expected,
                        float* scores, uint8_t* voted, int rows, int n_bits, int mb) {
  auto kernel = chacha20_vote_kernel<GROUP, D>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, GROUP == 32 ? VOTE_THREADS : VOTE_ROW_THREADS, smem, st>>>(
      table, latent, shared_latent, expected, scores, voted, rows, n_bits, mb);
  return cudaGetLastError();
}

}  // namespace

// words12: host array of key[8], counter_lo, counter_hi, nonce[2].
// out: device buffer of n_blocks * 16 32-bit words, 16-byte aligned.
extern "C" int gswm_chacha20_words(const uint32_t* words12, void* out,
                                   int n_blocks, void* stream) {
  ChachaParams p;
  for (int i = 0; i < 8; ++i) p.key[i] = words12[i];
  p.counter_lo = words12[8];
  p.counter_hi = words12[9];
  p.nonce[0] = words12[10];
  p.nonce[1] = words12[11];
  const int threads = 128;
  const int grid = (n_blocks + threads - 1) / threads;
  chacha20_words_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<uint4*>(out), n_blocks);
  return static_cast<int>(cudaGetLastError());
}

// table: device array of rows * 12 32-bit words (key[8], counter_lo,
// counter_hi, nonce[2] a row).  out: device buffer of rows * n_bits bytes, 16-byte
// aligned; row r's first n_bits keystream bits, one byte each, in stream order.
extern "C" int gswm_chacha20_batch(const void* table, void* out, int rows, int n_bits,
                                   void* stream) {
  if (rows < 1 || n_bits < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int n_blocks = (n_bits + 511) / 512;
  const long long total = (long long)rows * n_blocks;
  if (total >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = (unsigned)((total + BATCH_THREADS - 1) / BATCH_THREADS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* tab = static_cast<const uint32_t*>(table);
  uint8_t* o = static_cast<uint8_t*>(out);
  // rows start on 16-byte boundaries only when n_bits is a multiple of 16
  if (n_bits % 16 == 0)
    chacha20_batch_kernel<true><<<grid, BATCH_THREADS, 0, st>>>(tab, o, rows, n_blocks, n_bits);
  else
    chacha20_batch_kernel<false><<<grid, BATCH_THREADS, 0, st>>>(tab, o, rows, n_blocks, n_bits);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
cudaError_t launch_vote_stream(int rows, int splits, int span, int fill, cudaStream_t st,
                               const uint32_t* table, const uint32_t* latent, int shared_latent,
                               const uint32_t* expected, float* scores, uint8_t* voted,
                               int n_bits, int mb) {
  constexpr size_t most = 4 * (STREAM_FILL * 16 + STREAM_THREADS * D + 2);
  auto kernel = chacha20_vote_stream_kernel<D>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(most));
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(rows * splits));
  cfg.blockDim = dim3(STREAM_THREADS);
  cfg.dynamicSmemBytes = 4 * ((size_t)fill * 16 + STREAM_THREADS * D + 2);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, table, latent, shared_latent, expected, scores, voted,
                            n_bits, mb, span, fill);
}

// table: device array of rows * 12 32-bit words.  latent: device words of the
// quantized bits packed in stream order, latent_rows (1: every row shares it;
// or rows) rows of ceil(n_bits / 512) * 16 words, zero-filled, 16-byte
// aligned.  expected (or null): rows * ceil(mb / 32) words packed the same
// way; with it, scores (float32, rows) gets matches / mb.  voted (or null):
// rows * mb bytes of 0 or 1, 16-byte aligned where mb % 32 == 0.  At least
// one output; 1 <= mb < 2^24; n_bits up to 3584 blocks (1,835,008 bits);
// longer rows: gswm_chacha20_vote_stream.
extern "C" int gswm_chacha20_vote(const void* table, const void* latent, int latent_rows,
                                  const void* expected, void* scores, void* voted, int rows,
                                  int n_bits, int mb, void* stream) {
  if (rows < 1 || n_bits < 1 || mb < 1 || mb >= (1 << 24) ||
      (latent_rows != 1 && latent_rows != rows) || (expected == nullptr) != (scores == nullptr) ||
      (scores == nullptr && voted == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_blocks = (n_bits + 511) / 512;
  if (n_blocks > VOTE_MAX_BLOCKS) return static_cast<int>(cudaErrorInvalidValue);
  const size_t slice = (size_t)n_blocks * 16;
  const int segs = n_bits / mb;  // bit planes: 8 below 256 segments, 16, or 24
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* tab = static_cast<const uint32_t*>(table);
  const uint32_t* lat = static_cast<const uint32_t*>(latent);
  const uint32_t* want = static_cast<const uint32_t*>(expected);
  float* sc = static_cast<float*>(scores);
  uint8_t* out = static_cast<uint8_t*>(voted);
  const int sh = latent_rows == 1 ? 1 : 0;
  cudaError_t e;
  if (n_blocks <= VOTE_WARP_BLOCKS) {
    const int groups = VOTE_THREADS / 32;
    const size_t smem = 4 * ((sh ? slice : 0) + 4 + groups * (slice + 4));
    const unsigned grid = (unsigned)((rows + groups - 1) / groups);
    e = segs < 256     ? launch_vote<32, 8>(grid, smem, st, tab, lat, sh, want, sc, out, rows,
                                            n_bits, mb)
        : segs < 65536 ? launch_vote<32, 16>(grid, smem, st, tab, lat, sh, want, sc, out, rows,
                                             n_bits, mb)
                       : launch_vote<32, 24>(grid, smem, st, tab, lat, sh, want, sc, out, rows,
                                             n_bits, mb);
  } else {
    const size_t smem = 4 * (4 + slice + 4);
    e = segs < 256     ? launch_vote<256, 8>(rows, smem, st, tab, lat, sh, want, sc, out, rows,
                                             n_bits, mb)
        : segs < 65536 ? launch_vote<256, 16>(rows, smem, st, tab, lat, sh, want, sc, out, rows,
                                              n_bits, mb)
                       : launch_vote<256, 24>(rows, smem, st, tab, lat, sh, want, sc, out, rows,
                                              n_bits, mb);
  }
  return static_cast<int>(e);
}

// The same arguments and outputs at any n_bits with rows * ceil(n_bits /
// 512) < 2^31: the stream mode (the C entry of rows past 3584 blocks), a
// cluster of `splits` thread blocks a row (1 to STREAM_MAX_SPLITS), each
// taking an equal share of the blocks where the row's windows start, its
// payload a chunk of at most STREAM_FILL blocks at a time.
extern "C" int gswm_chacha20_vote_stream(const void* table, const void* latent, int latent_rows,
                                         const void* expected, void* scores, void* voted,
                                         int rows, int n_bits, int mb, int splits,
                                         void* stream) {
  if (rows < 1 || n_bits < 1 || mb < 1 || mb >= (1 << 24) || splits < 1 ||
      splits > STREAM_MAX_SPLITS || (latent_rows != 1 && latent_rows != rows) ||
      (expected == nullptr) != (scores == nullptr) || (scores == nullptr && voted == nullptr) ||
      (long long)rows * ((n_bits + 511) / 512) >= (1ll << 31) ||
      (long long)rows * splits >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int segs = n_bits / mb;  // bit planes: 8 below 256 segments, 16, 24, or 32
  // the blocks where windows start, shared among the cluster; a chunk holds
  // a share (and the block past it where mb % 32 != 0) where it fits
  const int starts = (int)(((long long)segs * mb + 511) >> 9);
  const int span = std::max(1, (starts + splits - 1) / splits);
  const int fill = std::min(STREAM_FILL, span + (mb % 32 ? 1 : 0));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* tab = static_cast<const uint32_t*>(table);
  const uint32_t* lat = static_cast<const uint32_t*>(latent);
  const uint32_t* want = static_cast<const uint32_t*>(expected);
  float* sc = static_cast<float*>(scores);
  uint8_t* out = static_cast<uint8_t*>(voted);
  const int sh = latent_rows == 1 ? 1 : 0;
  cudaError_t e;
  if (segs < 256)
    e = launch_vote_stream<8>(rows, splits, span, fill, st, tab, lat, sh, want, sc, out, n_bits,
                              mb);
  else if (segs < 65536)
    e = launch_vote_stream<16>(rows, splits, span, fill, st, tab, lat, sh, want, sc, out,
                               n_bits, mb);
  else if (segs < (1 << 24))
    e = launch_vote_stream<24>(rows, splits, span, fill, st, tab, lat, sh, want, sc, out,
                               n_bits, mb);
  else
    e = launch_vote_stream<32>(rows, splits, span, fill, st, tab, lat, sh, want, sc, out,
                               n_bits, mb);
  return static_cast<int>(e);
}

// table: device array of rows * 12 32-bit words, then payload: rows *
// ceil(elements * l / 512) * 16 words, each row's diffused payload bits
// packed in stream order (chacha.pack_bits), zero-filled; u, z: rows *
// elements float32, 16-byte aligned.  z = ndtri(clamp((u + y) 2^-l, 1e-7,
// 1 - 1e-7)), y the l-bit big-endian windows of payload XOR keystream; 1 <= l
// <= 8; rows * chunks and rows * ceil(elements * l / 512) below 2^31.
extern "C" int gswm_chacha20_embed(const void* table, const void* payload, const void* u,
                                   void* z, int rows, int elements, int l, void* stream) {
  const int chunks = (elements + EMBED_ELEMS - 1) / EMBED_ELEMS;
  if (rows < 1 || elements < 1 || l < 1 || l > 8 || (long long)rows * chunks >= (1ll << 31) ||
      (long long)rows * (((long long)elements * l + 511) / 512) >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* tab = static_cast<const uint32_t*>(table);
  const uint32_t* pl = static_cast<const uint32_t*>(payload);
  const float* uu = static_cast<const float*>(u);
  float* zz = static_cast<float*>(z);
  const unsigned grid = (unsigned)(rows * chunks);
  if (elements % 4 == 0)
    chacha20_embed_kernel<true><<<grid, EMBED_THREADS, 0, st>>>(tab, pl, uu, zz, elements, l,
                                                                 chunks);
  else
    chacha20_embed_kernel<false><<<grid, EMBED_THREADS, 0, st>>>(tab, pl, uu, zz, elements, l,
                                                                  chunks);
  return static_cast<int>(cudaGetLastError());
}
