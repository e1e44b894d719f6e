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

#include <cuda_runtime.h>
#include <stdint.h>

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
