#include "sha256.hpp"

#include <cstring>

namespace chaincore {

namespace {

const uint32_t K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

inline uint32_t rotr(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }

inline uint32_t load_be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

inline void store_be32(uint8_t* p, uint32_t v) {
  p[0] = uint8_t(v >> 24);
  p[1] = uint8_t(v >> 16);
  p[2] = uint8_t(v >> 8);
  p[3] = uint8_t(v);
}

}  // namespace

const uint32_t SHA256_IV[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                               0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};

void sha256_compress(uint32_t state[8], const uint32_t win[16]) {
  uint32_t w[64];
  std::memcpy(w, win, 16 * sizeof(uint32_t));
  for (int i = 16; i < 64; ++i) {
    uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
    uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
    w[i] = w[i - 16] + s0 + w[i - 7] + s1;
  }
  uint32_t a = state[0], b = state[1], c = state[2], d = state[3];
  uint32_t e = state[4], f = state[5], g = state[6], h = state[7];
  for (int i = 0; i < 64; ++i) {
    uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    uint32_t ch = (e & f) ^ (~e & g);
    uint32_t t1 = h + S1 + ch + K[i] + w[i];
    uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    uint32_t t2 = S0 + maj;
    h = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + t2;
  }
  state[0] += a; state[1] += b; state[2] += c; state[3] += d;
  state[4] += e; state[5] += f; state[6] += g; state[7] += h;
}

void sha256(const uint8_t* data, size_t len, uint8_t out[32]) {
  uint32_t state[8];
  std::memcpy(state, SHA256_IV, sizeof(state));

  size_t off = 0;
  uint32_t w[16];
  while (len - off >= 64) {
    for (int i = 0; i < 16; ++i) w[i] = load_be32(data + off + 4 * i);
    sha256_compress(state, w);
    off += 64;
  }
  // Final padded block(s): remaining bytes + 0x80 + zeros + 64-bit BE length.
  uint8_t tail[128];
  size_t rem = len - off;
  std::memset(tail, 0, sizeof(tail));
  std::memcpy(tail, data + off, rem);
  tail[rem] = 0x80;
  size_t total = (rem + 9 <= 64) ? 64 : 128;
  uint64_t bitlen = uint64_t(len) * 8;
  for (int i = 0; i < 8; ++i)
    tail[total - 1 - i] = uint8_t(bitlen >> (8 * i));
  for (size_t blk = 0; blk < total; blk += 64) {
    for (int i = 0; i < 16; ++i) w[i] = load_be32(tail + blk + 4 * i);
    sha256_compress(state, w);
  }
  for (int i = 0; i < 8; ++i) store_be32(out + 4 * i, state[i]);
}

void sha256d(const uint8_t* data, size_t len, uint8_t out[32]) {
  uint8_t inner[32];
  sha256(data, len, inner);
  sha256(inner, 32, out);
}

void header_midstate(const uint8_t header80[80], uint32_t out_state[8],
                     uint32_t out_tail_w[16]) {
  std::memcpy(out_state, SHA256_IV, 8 * sizeof(uint32_t));
  uint32_t w[16];
  for (int i = 0; i < 16; ++i) w[i] = load_be32(header80 + 4 * i);
  sha256_compress(out_state, w);
  // Chunk 2: header bytes 64..79, 0x80 pad, zeros, 640-bit length.
  for (int i = 0; i < 4; ++i) out_tail_w[i] = load_be32(header80 + 64 + 4 * i);
  out_tail_w[4] = 0x80000000u;
  for (int i = 5; i < 15; ++i) out_tail_w[i] = 0;
  out_tail_w[15] = 80 * 8;
}

void sha256d_from_midstate(const uint32_t midstate[8],
                           const uint32_t tail_w[16], uint8_t out[32]) {
  uint32_t state[8];
  std::memcpy(state, midstate, sizeof(state));
  sha256_compress(state, tail_w);
  // Second hash: the 32-byte digest is one padded chunk. The digest bytes are
  // the big-endian encoding of `state`, so reading them back as big-endian
  // words reproduces `state` directly — no byte swaps needed.
  uint32_t w2[16];
  for (int i = 0; i < 8; ++i) w2[i] = state[i];
  w2[8] = 0x80000000u;
  for (int i = 9; i < 15; ++i) w2[i] = 0;
  w2[15] = 32 * 8;
  uint32_t st2[8];
  std::memcpy(st2, SHA256_IV, sizeof(st2));
  sha256_compress(st2, w2);
  for (int i = 0; i < 8; ++i) store_be32(out + 4 * i, st2[i]);
}

uint64_t midstate_sweep(const uint8_t header80[80], uint64_t start_nonce,
                        uint64_t count, uint32_t difficulty_bits,
                        uint64_t* hashes_tried) {
  uint32_t midstate[8], tail[16];
  header_midstate(header80, midstate, tail);
  uint64_t end = start_nonce + count;
  if (end > 0x100000000ULL) end = 0x100000000ULL;
  uint64_t tried = 0;
  for (uint64_t n = start_nonce; n < end; ++n, ++tried) {
    // The header stores the nonce little-endian; SHA words are big-endian
    // reads of the stream, so word 3 = bswap32(nonce).
    tail[3] = ((uint32_t(n) & 0xff) << 24) | ((uint32_t(n) & 0xff00) << 8) |
              ((uint32_t(n) >> 8) & 0xff00) | (uint32_t(n) >> 24);
    uint8_t digest[32];
    sha256d_from_midstate(midstate, tail, digest);
    if (leading_zero_bits(digest) >= int(difficulty_bits)) {
      if (hashes_tried) *hashes_tried = tried + 1;
      return n;
    }
  }
  if (hashes_tried) *hashes_tried = tried;
  return UINT64_MAX;
}

int leading_zero_bits(const uint8_t h[32]) {
  int bits = 0;
  for (int i = 0; i < 32; ++i) {
    if (h[i] == 0) {
      bits += 8;
      continue;
    }
    uint8_t b = h[i];
    while (!(b & 0x80)) {
      ++bits;
      b <<= 1;
    }
    return bits;
  }
  return bits;
}

}  // namespace chaincore
