// Double-SHA-256 nonce sweep for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel `pallas_sweep_core_ext`
// (mpi_blockchain_tpu/ops/sha256_pallas.py). It computes the same function:
// for every nonce in [base, base + count) the double SHA-256 of the 80-byte
// block header, entered at round 4 of the first hash from the 20-word
// extended midstate (ops/sha256_sched.py), with the byte-swapped nonce at
// chunk-2 word 3; the leading-zero test for a difficulty class; and the
// result (number of qualifying nonces, lowest qualifying nonce).
//
// What bounds it: integer ALU work. A nonce costs a few thousand 32-bit
// integer operations (adds, funnel-shift rotations, 3-input logic) and no
// device-memory traffic at all: the inputs ride in the kernel's parameter
// space and the only bytes written are the 8-byte result. The design keeps
// every cycle on that work:
//   * the 20 extended-midstate words go by value in the argument struct
//     (uniform, so they sit in the constant bank, the twin of the TPU's
//     scalar prefetch), and the round constants are __constant__;
//   * both compressions are fully unrolled, so the schedule's constant words
//     (padding, lengths) fold at compile time and no state leaves registers;
//   * one template per difficulty class (0, <32, ==32, 33..63, ==64), so h1
//     is formed only when the test reads it and unused rounds' tails fold;
//   * rotations are __funnelshift_r, ch/maj are written as 3-input forms
//     that map to one LOP3 each, and the nonce byte-swap is one __byte_perm;
//   * a persistent grid (the SM count times the resident blocks per SM,
//     queried once per device) strides over the range, and the reduction
//     is one warp vote per nonce plus one atomicAdd/atomicMin per warp that
//     found something.
//
// Early exit. TPU grid steps run in ascending order, so the Pallas kernel
// skips every tile after the first hit. GPU blocks run in no order, and a
// slower warp may still hold a lower qualifying nonce. So a warp skips its
// slice only when the global minimum found so far is already below the
// slice's first nonce, which can never lose a lower winner. With early exit
// the count is only a found-flag, as in the reference. The warps of the
// grid-stride split do not advance in step, so an early-exit launch hashes
// well past the winner; the measuring build (kCountHashed) counts by how
// much.
//
// The result buffer is two uint32 words {count, min}; the caller resets it
// to {0, 0xFFFFFFFF} before each launch. 0xFFFFFFFF is a real nonce too: a
// caller tells "none" from "found 0xFFFFFFFF" by count > 0.
#include <atomic>
#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullMask = 0xFFFFFFFFu;
constexpr int kBlock = 256;
constexpr int kMaxDevices = 64;  // devices whose resident grid is cached

__constant__ uint32_t kK[64] = {
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

// The IV as scalar constants, so hash 2's first rounds fold at compile time.
constexpr uint32_t kIV0 = 0x6a09e667, kIV1 = 0xbb67ae85, kIV2 = 0x3c6ef372,
                   kIV3 = 0xa54ff53a, kIV4 = 0x510e527f, kIV5 = 0x9b05688c,
                   kIV6 = 0x1f83d9ab, kIV7 = 0x5be0cd19;

// Extended-midstate layout (ops/sha256_sched.py).
constexpr int kExtA2 = 8, kExtA1 = 9, kExtA0 = 10;
constexpr int kExtE2 = 11, kExtE1 = 12, kExtE0 = 13;
constexpr int kExtRcA = 14, kExtRcE = 15;
constexpr int kExtW16 = 16, kExtW17 = 17, kExtRc18 = 18, kExtRc19 = 19;

struct SweepArgs {
  uint32_t ext[20];
  unsigned long long base;   // first nonce
  unsigned long long count;  // nonces to sweep; base + count <= 2^32
  uint32_t h0_limit;         // class <32: qualifies when h0 < h0_limit
  uint32_t h1_limit;         // class 33..63: h0 == 0 and h1 < h1_limit
  int early_exit;
};

// Difficulty classes, as the reference's mask branches.
enum Mode { kAll = 0, kBelow32 = 1, kEq32 = 2, kBelow64 = 3, kEq64 = 4 };

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}
__device__ __forceinline__ uint32_t big_sigma0(uint32_t a) {
  return rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
}
__device__ __forceinline__ uint32_t big_sigma1(uint32_t e) {
  return rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
}
__device__ __forceinline__ uint32_t small_sigma0(uint32_t x) {
  return rotr(x, 7) ^ rotr(x, 18) ^ (x >> 3);
}
__device__ __forceinline__ uint32_t small_sigma1(uint32_t x) {
  return rotr(x, 17) ^ rotr(x, 19) ^ (x >> 10);
}
__device__ __forceinline__ uint32_t ch(uint32_t e, uint32_t f, uint32_t g) {
  return g ^ (e & (f ^ g));
}
__device__ __forceinline__ uint32_t maj(uint32_t a, uint32_t b, uint32_t c) {
  return b ^ ((a ^ b) & (b ^ c));
}

// Message schedule words w[first..63] from the words below them.
template <int kFirst>
__device__ __forceinline__ void expand(uint32_t (&w)[64]) {
#pragma unroll
  for (int r = kFirst; r < 64; ++r)
    w[r] = small_sigma1(w[r - 2]) + w[r - 7] + small_sigma0(w[r - 15]) +
           w[r - 16];
}

// Rounds [kFirst, 64) of a compression, in place on s = {a..h}.
template <int kFirst>
__device__ __forceinline__ void rounds(uint32_t (&s)[8],
                                       const uint32_t (&w)[64]) {
  uint32_t a = s[0], b = s[1], c = s[2], d = s[3];
  uint32_t e = s[4], f = s[5], g = s[6], h = s[7];
#pragma unroll
  for (int r = kFirst; r < 64; ++r) {
    const uint32_t t1 = h + big_sigma1(e) + ch(e, f, g) + kK[r] + w[r];
    const uint32_t t2 = big_sigma0(a) + maj(a, b, c);
    h = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + t2;
  }
  s[0] = a; s[1] = b; s[2] = c; s[3] = d;
  s[4] = e; s[5] = f; s[6] = g; s[7] = h;
}

// Digest words h0, h1 of sha256d(header with this nonce).
__device__ __forceinline__ void sha256d_h01(const SweepArgs& args,
                                            uint32_t nonce, uint32_t& h0,
                                            uint32_t& h1) {
  const uint32_t* ext = args.ext;
  // The header stores the nonce little-endian; SHA reads big-endian words.
  const uint32_t w3 = __byte_perm(nonce, 0, 0x0123);

  // Hash 1, chunk 2, from round 4: rounds 0..2 and round 3's constant part
  // are per-template (ext), the nonce enters through w3.
  uint32_t w[64];
  w[4] = 0x80000000u;
#pragma unroll
  for (int i = 5; i < 15; ++i) w[i] = 0;
  w[15] = 80 * 8;
  w[16] = ext[kExtW16];
  w[17] = ext[kExtW17];
  w[18] = ext[kExtRc18] + small_sigma0(w3);
  w[19] = w3 + ext[kExtRc19];
  expand<20>(w);
  uint32_t s[8] = {ext[kExtRcA] + w3, ext[kExtA2], ext[kExtA1], ext[kExtA0],
                   ext[kExtRcE] + w3, ext[kExtE2], ext[kExtE1], ext[kExtE0]};
  rounds<4>(s, w);

  // Hash 2 over the 32-byte digest: its words are the message directly.
  uint32_t w2[64];
#pragma unroll
  for (int i = 0; i < 8; ++i) w2[i] = s[i] + ext[i];
  w2[8] = 0x80000000u;
#pragma unroll
  for (int i = 9; i < 15; ++i) w2[i] = 0;
  w2[15] = 32 * 8;
  expand<16>(w2);
  uint32_t s2[8] = {kIV0, kIV1, kIV2, kIV3, kIV4, kIV5, kIV6, kIV7};
  rounds<0>(s2, w2);
  h0 = s2[0] + kIV0;
  h1 = s2[1] + kIV1;
}

template <int kMode>
__device__ __forceinline__ bool qualifies(uint32_t h0, uint32_t h1,
                                          const SweepArgs& args) {
  if (kMode == kAll) return true;
  if (kMode == kBelow32) return h0 < args.h0_limit;
  if (kMode == kEq32) return h0 == 0;
  if (kMode == kBelow64) return h0 == 0 && h1 < args.h1_limit;
  return h0 == 0 && h1 == 0;
}

// kCountHashed is a measuring build: each warp also adds the nonces it
// hashes to *hashed, which shows how far early exit overshoots the winner.
template <int kMode, bool kCountHashed>
__global__ void __launch_bounds__(kBlock)
    sha256d_sweep_kernel(const SweepArgs args, uint32_t* __restrict__ out,
                         unsigned long long* __restrict__ hashed) {
  const unsigned lane = threadIdx.x & 31u;
  const unsigned long long stride =
      static_cast<unsigned long long>(gridDim.x) * blockDim.x;
  for (unsigned long long i =
           static_cast<unsigned long long>(blockIdx.x) * blockDim.x +
           threadIdx.x;;
       i += stride) {
    // The warp's first index: uniform across the warp, so every branch
    // below is taken by all 32 lanes together.
    const unsigned long long first = i - lane;
    if (first >= args.count) break;
    if (args.early_exit) {
      uint32_t best = 0;
      if (lane == 0) best = *reinterpret_cast<volatile uint32_t*>(out + 1);
      best = __shfl_sync(kFullMask, best, 0);
      // Slices ascend along this warp's loop, so once one is above the
      // minimum every later one is too.
      if (best < args.base + first) break;
    }
    if (kCountHashed && lane == 0) {
      const unsigned long long left = args.count - first;
      atomicAdd(hashed, left < 32 ? left : 32ull);
    }
    const uint32_t nonce = static_cast<uint32_t>(args.base + i);
    uint32_t h0, h1;
    sha256d_h01(args, nonce, h0, h1);
    const bool hit = i < args.count && qualifies<kMode>(h0, h1, args);
    const unsigned hits = __ballot_sync(kFullMask, hit);
    if (hits) {
      const uint32_t lowest =
          __reduce_min_sync(kFullMask, hit ? nonce : 0xFFFFFFFFu);
      if (lane == 0) {
        atomicAdd(out, static_cast<uint32_t>(__popc(hits)));
        atomicMin(out + 1, lowest);
      }
    }
  }
}

// Blocks of one instantiation that the current device holds at once (SMs
// times resident blocks per SM). Queried once per device and kept, so a
// launch costs no attribute or occupancy query.
template <int kMode, bool kCountHashed>
cudaError_t resident_blocks(unsigned long long* blocks) {
  static std::atomic<unsigned long long> cache[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const bool cached = device < kMaxDevices;
  if (cached && (*blocks = cache[device].load(std::memory_order_relaxed)))
    return cudaSuccess;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sha256d_sweep_kernel<kMode, kCountHashed>, kBlock, 0);
  if (err != cudaSuccess) return err;
  *blocks = static_cast<unsigned long long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (cached) cache[device].store(*blocks, std::memory_order_relaxed);
  return cudaSuccess;
}

template <int kMode, bool kCountHashed>
int launch(const SweepArgs& args, uint32_t* out, unsigned long long* hashed,
           cudaStream_t stream) {
  unsigned long long resident = 0;
  const cudaError_t err = resident_blocks<kMode, kCountHashed>(&resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long needed = (args.count + kBlock - 1) / kBlock;
  const unsigned grid =
      static_cast<unsigned>(needed < resident ? needed : resident);
  sha256d_sweep_kernel<kMode, kCountHashed>
      <<<grid, kBlock, 0, stream>>>(args, out, hashed);
  return static_cast<int>(cudaGetLastError());
}

template <bool kCountHashed>
int launch_mode(int difficulty_bits, const SweepArgs& args, uint32_t* out,
                unsigned long long* hashed, cudaStream_t stream) {
  const int d = difficulty_bits;
  if (d <= 0) return launch<kAll, kCountHashed>(args, out, hashed, stream);
  if (d < 32) return launch<kBelow32, kCountHashed>(args, out, hashed, stream);
  if (d == 32) return launch<kEq32, kCountHashed>(args, out, hashed, stream);
  if (d < 64) return launch<kBelow64, kCountHashed>(args, out, hashed, stream);
  return launch<kEq64, kCountHashed>(args, out, hashed, stream);
}

}  // namespace

extern "C" {

// Enqueues one sweep of [base, base + count) on `stream`; `out` is the
// device result buffer {count, min}, reset by the caller. Returns the CUDA
// error code of the launch (0 on success). count must be >= 1 and
// base + count <= 2^32; difficulty_bits <= 64 (<= 0 qualifies every nonce).
// A non-null `hashed` (a device uint64) selects the measuring build, which
// adds the number of nonces it hashed there.
int sha256d_sweep_launch(const uint32_t* ext, unsigned long long base,
                         unsigned long long count, int difficulty_bits,
                         int early_exit, void* out, void* hashed,
                         void* stream) {
  if (count == 0 || base + count > (1ull << 32) || difficulty_bits > 64)
    return static_cast<int>(cudaErrorInvalidValue);
  SweepArgs args;
  std::memcpy(args.ext, ext, sizeof(args.ext));
  args.base = base;
  args.count = count;
  args.early_exit = early_exit;
  const int d = difficulty_bits;
  args.h0_limit = (d > 0 && d < 32) ? (1u << (32 - d)) : 0u;
  args.h1_limit = (d > 32 && d < 64) ? (1u << (64 - d)) : 0u;
  uint32_t* o = static_cast<uint32_t*>(out);
  auto* n = static_cast<unsigned long long*>(hashed);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return n ? launch_mode<true>(d, args, o, n, s)
           : launch_mode<false>(d, args, o, n, s);
}

// Blocks a production launch at `difficulty_bits` runs on the current
// device (its persistent grid), or minus the CUDA error code.
long long sha256d_sweep_resident_blocks(int difficulty_bits) {
  const int d = difficulty_bits;
  unsigned long long blocks = 0;
  const cudaError_t err =
      d <= 0    ? resident_blocks<kAll, false>(&blocks)
      : d < 32  ? resident_blocks<kBelow32, false>(&blocks)
      : d == 32 ? resident_blocks<kEq32, false>(&blocks)
      : d < 64  ? resident_blocks<kBelow64, false>(&blocks)
                : resident_blocks<kEq64, false>(&blocks);
  return err == cudaSuccess ? static_cast<long long>(blocks)
                            : -static_cast<long long>(err);
}

// The CUDA runtime's message for an error code returned above.
const char* sha256d_sweep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
