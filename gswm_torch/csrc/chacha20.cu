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

__global__ void chacha20_words_kernel(ChachaParams p, uint4* __restrict__ out,
                                      int n_blocks) {
  const int blk = blockIdx.x * blockDim.x + threadIdx.x;
  if (blk >= n_blocks) return;
  const uint32_t idx = static_cast<uint32_t>(blk);
  const uint32_t lo = p.counter_lo + idx;
  const uint32_t hi = p.counter_hi + (lo < idx ? 1u : 0u);  // carry

  uint32_t init[16] = {0x61707865u, 0x3320646Eu, 0x79622D32u, 0x6B206574u,
                       p.key[0], p.key[1], p.key[2], p.key[3],
                       p.key[4], p.key[5], p.key[6], p.key[7],
                       lo, hi, p.nonce[0], p.nonce[1]};
  uint32_t x[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] = init[i];
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
  uint4* dst = out + static_cast<size_t>(blk) * 4;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    dst[q] = make_uint4(x[4 * q] + init[4 * q], x[4 * q + 1] + init[4 * q + 1],
                        x[4 * q + 2] + init[4 * q + 2],
                        x[4 * q + 3] + init[4 * q + 3]);
  }
}

#undef GSWM_QR

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
