// SHA-256 (FIPS 180-4) primitives for the chain core.
//
// Rebuild of the reference's hashing layer (SURVEY.md §1 layer 1; the
// reference mount was empty this round, so parity is to the BASELINE.json
// capability contract: "double-SHA256 over the block header").
//
// Exposes the raw compression function and midstate helpers so the CPU miner
// and the TPU (JAX/Pallas) backend can share the exact same two-compression
// per-nonce schedule: the 80-byte header occupies two 512-bit chunks, the
// nonce lives in the second chunk, so chunk-1 state ("midstate") is constant
// per candidate header.
#pragma once
#include <cstdint>
#include <cstddef>

namespace chaincore {

// One SHA-256 compression round over a 16-word big-endian message block.
// `state` is updated in place. `w` is the 16-word message block (already
// big-endian words, i.e. bytes loaded MSB-first).
void sha256_compress(uint32_t state[8], const uint32_t w[16]);

// Full SHA-256 of an arbitrary byte message.
void sha256(const uint8_t* data, size_t len, uint8_t out[32]);

// Double SHA-256: sha256(sha256(data)).
void sha256d(const uint8_t* data, size_t len, uint8_t out[32]);

// The SHA-256 initial hash value (H0..H7).
extern const uint32_t SHA256_IV[8];

// Midstate for an 80-byte block header:
//   out_state  = compression state after chunk 1 (header bytes 0..63)
//   out_tail_w = the 16 big-endian words of chunk 2 (header bytes 64..79,
//                then 0x80 pad, zeros, and the 640-bit length), with the
//                nonce word (index 3) taken from the header as-is.
// Per-nonce work is then: replace word 3 with bswap32(nonce), one
// compression from out_state, then one compression for the second hash.
void header_midstate(const uint8_t header80[80], uint32_t out_state[8],
                     uint32_t out_tail_w[16]);

// Finish a double-SHA256 given a midstate and chunk-2 words (word 3 = the
// byte-swapped nonce). Writes the 32-byte final digest.
void sha256d_from_midstate(const uint32_t midstate[8], const uint32_t tail_w[16],
                           uint8_t out[32]);

// Number of leading zero bits of a 32-byte digest interpreted as a 256-bit
// big-endian integer (the proof-of-work difficulty measure).
int leading_zero_bits(const uint8_t h[32]);

// Sequential lowest-nonce-first midstate sweep over [start_nonce,
// start_nonce + count), clamped to the uint32 nonce space. Returns the first
// (== lowest) nonce whose double-SHA256 header hash has >= difficulty_bits
// leading zero bits, or UINT64_MAX if none in range; *hashes_tried (if
// non-null) receives the number of hashes evaluated. This "lowest qualifying
// nonce" rule is the deterministic winner rule every backend implements, so
// CPU and TPU produce identical block hashes. Shared by both Python bindings
// (capi.cpp cc_search and pybind_module.cpp cpu_search).
uint64_t midstate_sweep(const uint8_t header80[80], uint64_t start_nonce,
                        uint64_t count, uint32_t difficulty_bits,
                        uint64_t* hashes_tried);

}  // namespace chaincore
