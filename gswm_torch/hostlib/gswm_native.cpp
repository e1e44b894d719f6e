// gswm_torch's native host library: ChaCha20 keystream + Gaussian-Shading
// decode, the port's own copy of gswm/native/gswm_native.cpp (same ABI, same
// arithmetic).
//
// Role: the multi-key traceability search (eval/trace.find_source: one
// recovered latent scored against a registry of 10,000 per-user keys) spends
// its time on per-candidate keystream + XOR + majority vote + match count;
// here that loop is C++, called through ctypes, with the latent quantized
// once.  The batched search on the card (find_source_device) is the other
// path; this one serves registries of mixed message lengths and hosts
// without a card.  The numpy functions of eval/trace.py
// (quantize_bits_host, decode_host, match_accuracy) are its plain versions.
//
// ABI (ctypes):
//   void chacha20_keystream(const uint8_t key[32], const uint8_t nonce16[16],
//                           uint8_t* out, uint64_t n_bytes);
//   void gs_quantize_bits(const float* latents, uint64_t n, int l,
//                         uint8_t* bits_out);               // n*l bits
//   void gs_decode(const uint8_t* quant_bits, uint64_t n_bits,
//                  const uint8_t key[32], const uint8_t nonce16[16],
//                  uint32_t message_bits, uint8_t* voted_out);
//   double gs_match_accuracy(const uint8_t* voted, const uint8_t* expected,
//                            uint32_t message_bits);
//
// Bit order matches the Python core: byte-stream order, MSB-first per byte.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline uint32_t rotl(uint32_t x, int n) { return (x << n) | (x >> (32 - n)); }

inline void quarter_round(uint32_t& a, uint32_t& b, uint32_t& c, uint32_t& d) {
  a += b; d ^= a; d = rotl(d, 16);
  c += d; b ^= c; b = rotl(b, 12);
  a += b; d ^= a; d = rotl(d, 8);
  c += d; b ^= c; b = rotl(b, 7);
}

inline uint32_t load_le32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}

inline void store_le32(uint8_t* p, uint32_t v) {
  p[0] = v & 0xff; p[1] = (v >> 8) & 0xff;
  p[2] = (v >> 16) & 0xff; p[3] = (v >> 24) & 0xff;
}

void chacha20_block(const uint32_t key_words[8], uint64_t counter,
                    const uint32_t nonce_words[2], uint8_t out[64]) {
  uint32_t s[16] = {
      0x61707865u, 0x3320646eu, 0x79622d32u, 0x6b206574u,
      key_words[0], key_words[1], key_words[2], key_words[3],
      key_words[4], key_words[5], key_words[6], key_words[7],
      (uint32_t)(counter & 0xffffffffu), (uint32_t)(counter >> 32),
      nonce_words[0], nonce_words[1]};
  uint32_t x[16];
  std::memcpy(x, s, sizeof(s));
  for (int i = 0; i < 10; ++i) {
    quarter_round(x[0], x[4], x[8], x[12]);
    quarter_round(x[1], x[5], x[9], x[13]);
    quarter_round(x[2], x[6], x[10], x[14]);
    quarter_round(x[3], x[7], x[11], x[15]);
    quarter_round(x[0], x[5], x[10], x[15]);
    quarter_round(x[1], x[6], x[11], x[12]);
    quarter_round(x[2], x[7], x[8], x[13]);
    quarter_round(x[3], x[4], x[9], x[14]);
  }
  for (int i = 0; i < 16; ++i) store_le32(out + 4 * i, x[i] + s[i]);
}

}  // namespace

extern "C" {

void chacha20_keystream(const uint8_t key[32], const uint8_t nonce16[16],
                        uint8_t* out, uint64_t n_bytes) {
  uint32_t kw[8];
  for (int i = 0; i < 8; ++i) kw[i] = load_le32(key + 4 * i);
  // cryptography-API layout: first 8 nonce bytes = initial counter (LE)
  uint64_t counter = 0;
  for (int i = 7; i >= 0; --i) counter = (counter << 8) | nonce16[i];
  uint32_t nw[2] = {load_le32(nonce16 + 8), load_le32(nonce16 + 12)};

  uint8_t block[64];
  uint64_t off = 0;
  while (off < n_bytes) {
    chacha20_block(kw, counter++, nw, block);
    uint64_t take = n_bytes - off < 64 ? n_bytes - off : 64;
    std::memcpy(out + off, block, take);
    off += take;
  }
}

// y = floor(Phi(z) * 2^l) clipped to 2^l - 1; emit l bits big-endian per
// element (extract.py:82-84 semantics; Phi via erfc is exact to double).
void gs_quantize_bits(const float* latents, uint64_t n, int l,
                      uint8_t* bits_out) {
  const double scale = std::ldexp(1.0, l);  // 2^l
  const int maxy = (1 << l) - 1;
  for (uint64_t i = 0; i < n; ++i) {
    double cdf = 0.5 * std::erfc(-((double)latents[i]) * M_SQRT1_2);
    int y = (int)(cdf * scale);
    if (y > maxy) y = maxy;
    if (y < 0) y = 0;
    for (int j = l - 1; j >= 0; --j)
      bits_out[i * l + (l - 1 - j)] = (uint8_t)((y >> j) & 1);
  }
}

void gs_decode(const uint8_t* quant_bits, uint64_t n_bits,
               const uint8_t key[32], const uint8_t nonce16[16],
               uint32_t message_bits, uint8_t* voted_out) {
  uint64_t n_bytes = (n_bits + 7) / 8;
  std::vector<uint8_t> ks(n_bytes);
  chacha20_keystream(key, nonce16, ks.data(), n_bytes);

  uint64_t segments = n_bits / message_bits;  // complete segments only
  std::vector<uint32_t> counts(message_bits, 0);
  for (uint64_t s = 0; s < segments; ++s) {
    for (uint32_t i = 0; i < message_bits; ++i) {
      uint64_t bit = s * message_bits + i;
      uint8_t k = (ks[bit >> 3] >> (7 - (bit & 7))) & 1;
      counts[i] += (uint32_t)(quant_bits[bit] ^ k);
    }
  }
  for (uint32_t i = 0; i < message_bits; ++i)
    voted_out[i] = (uint8_t)(2 * (uint64_t)counts[i] > segments ? 1 : 0);
}

double gs_match_accuracy(const uint8_t* voted, const uint8_t* expected,
                         uint32_t message_bits) {
  uint32_t match = 0;
  for (uint32_t i = 0; i < message_bits; ++i)
    match += (uint32_t)(voted[i] == expected[i]);
  return (double)match / (double)message_bits;
}

}  // extern "C"
