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
// What bounds it: the integer ALU pipe. A nonce costs some 3100 SASS
// instructions (funnel-shift rotations, 3-input logic, adds) and no
// device-memory traffic: the inputs ride in the kernel's parameter space
// and the only bytes written are the result words. SHF, LOP3 and PRMT run
// only on the ALU pipe (64 lanes per SM per clock); a two-input add can run
// there or, as IMAD, on the FMA pipe, as wide. So the least a nonce can take
// is its ALU-only instructions over 64 per SM-clock, or, where the adds
// outweigh them, the ALU-only instructions and the source's adds spread over
// both pipes (ops/sha256_cuda.bound_sm_clocks_per_nonce). The design keeps
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
//   * the reduction is one warp vote per nonce plus one atomicAdd/atomicMin
//     per warp that found something.
//
// Pipe balance. Every add of the rounds and the schedule is written as
// x * one + y, where `one` is 1 in the arguments, so the compiler cannot
// fold the multiply and issues it as IMAD on the FMA pipe instead of IADD3
// on the ALU pipe. The ALU pipe is then left with the work only it can do
// (SHF, LOP3, PRMT: about 1900 instructions a nonce) and the FMA pipe,
// which otherwise idles, takes the adds (about 1100). On an NVIDIA H100
// 80GB HBM3 at a 700 W power limit this made the full sweep 7% faster than
// moving only the adds off a round's critical path, and 11% faster than
// leaving the adds to the compiler, though the build needs more registers
// and holds 4 blocks per SM instead of 5 (PERF.md; these variants are
// rebuilt and timed by mpi_blockchain_tpu_torch/tools/sweep_variants.py).
//
// Work distribution and early exit. A persistent grid (the SM count times
// the resident blocks per SM, queried once per device) takes work from a
// queue: lane 0 of a warp takes the next slice index from a 64-bit atomic
// cursor and broadcasts it, a slice being 32 consecutive nonces, one per
// lane (on the H100 above, slices of 64 to 256 nonces were no faster,
// PERF.md). Slices are handed out in ascending order whatever the order in
// which warps run, so every slice below the lowest winner is handed out
// before any slice above it. With early exit a warp stops when the minimum
// found so far is below its next slice's first nonce; since later slices
// only ascend, that can never lose a lower winner, which some slower warp
// may still hold. The work past the winner is then the slices taken while
// the winner's own slice was in flight: about one slice per resident warp
// when warps progress alike. On the H100 above, warps of one block do, but
// warps of different blocks on one SM do not, so a winner in a slow warp's
// slice is reported late and some launches run several slices per warp
// past it. Blocks of 1024 threads, one per SM, remove that tail but made
// the mean launch slower (PERF.md).
// A static grid-stride split instead lets warps drift far out of step, and
// an early-exit launch then hashes several times the nonces the winner
// needs. With early exit the count is only a found-flag, as in the
// reference. The measuring build (kCountHashed) adds the nonces of each
// slice it takes to a counter, which shows the overshoot.
//
// The result buffer is four uint32 words {count, min, cursor_lo, cursor_hi},
// 8-byte aligned; the caller resets it to {0, 0xFFFFFFFF, 0, 0} before each
// launch. 0xFFFFFFFF is a real nonce too: a caller tells "none" from "found
// 0xFFFFFFFF" by count > 0.
//
// Extended midstate from device memory. The fused k-block miner builds each
// block's header on the card from the previous block's digest, so the host
// never sees the 20 ext words. An instantiation with kExtFromSymbol reads
// them from the __constant__ array kExtSymbol instead of the arguments; a
// stream-ordered device-to-device copy fills it from the step kernel's
// output before each sweep. Both are constant-bank operands, so the loop's
// registers do not change (ext loaded from global memory into registers
// would spill or cost a resident block per SM). The symbol is one per
// device: the caller lets one user at a time enqueue work that writes and
// reads it (ops/sha256_cuda.py holds a lock and chains the users' streams).
//
// The fused step kernel (block_step_kernel below) replaces the jnp header
// build and winner digest of the reference's fused miner
// (mpi_blockchain_tpu/models/fused.py:89-114). One thread per block: it
// finalizes the block just swept (its lowest winner from the result buffer,
// and that header's double hash, the next prev_hash), builds the next
// block's midstate, chunk-2 template and extended midstate, and resets the
// result buffer, cursor included. What bounds it, on an NVIDIA H100 80GB
// HBM3 at a 700.00 W power limit (PERF.md; the alternatives are rebuilt from
// text patches and timed in turns by tools/step_variants.py):
//   * its dependent chain: three compressions, each fed by the one before's
//     digest, on one thread. The body takes about 9300 SM clocks (4.7 us)
//     for its 4384 instructions. Built compact (one 16-round body in loops,
//     720 instructions) it ran 24% more clocks, as the loops and the
//     constants it no longer folds add instructions, and after a sweep the
//     unrolled code started no later than the compact one: fetching the
//     code does not cost. So one thread runs the three compressions
//     unrolled, with plain adds that fuse into three-input IADD3s, the
//     schedule in a 16-word ring of registers;
//   * its launch: back to back a step takes 6.6 us on the card, 1.9 us
//     over its body, and in the fused loop 9.8 us from the end of a sweep.
//     A step that follows a sweep is a programmatic dependent launch: it
//     may start while the sweep's grid drains, loads its template,
//     midstate and data words (nothing the sweep writes), and waits for
//     the sweep (griddepcontrol.wait) only before it reads the result
//     buffer. That saved 1.0 us a block where the sweeps are short (dbits
//     12); at dbits 24 the calls' spread hides it. Every load is issued
//     before any store, through __restrict__ pointers, so the loads cost
//     one round trip (0.5 us a block at dbits 12).
// sha256d_fused_enqueue puts a whole k-block call on a stream (step, symbol
// copy and early-exit sweep over [0, cap), k times, then a final step), so
// the host makes one call per k blocks and reads nothing back between them.
#include <atomic>
#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullMask = 0xFFFFFFFFu;
constexpr int kBlock = 256;
constexpr unsigned long long kSlice = 32;  // nonces per slice, one a lane
constexpr int kMaxDevices = 64;  // devices whose resident grid is cached
constexpr int kExtWords = 20;

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

// The extended midstate of the block the fused loop is mining (see above).
__constant__ uint32_t kExtSymbol[kExtWords];

struct SweepArgs {
  uint32_t ext[kExtWords];       // unused by the kExtFromSymbol instantiation
  unsigned long long base;   // first nonce
  unsigned long long count;  // nonces to sweep; base + count <= 2^32
  uint32_t h0_limit;         // class <32: qualifies when h0 < h0_limit
  uint32_t h1_limit;         // class 33..63: h0 == 0 and h1 < h1_limit
  uint32_t one;              // 1, opaque to the compiler (add_on_fma)
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

// x + y as x * one + y, an IMAD on the FMA pipe: `one` is 1 at run time,
// which the compiler cannot see, so it cannot turn the IMAD back into an
// add on the ALU pipe.
__device__ __forceinline__ uint32_t add_on_fma(uint32_t x, uint32_t y,
                                               uint32_t one) {
  return x * one + y;
}

// Message schedule words w[first..63] from the words below them. The newest
// word's sigma comes last, so the sum of the three older terms is ready
// early.
template <int kFirst>
__device__ __forceinline__ void expand(uint32_t (&w)[64], uint32_t one) {
#pragma unroll
  for (int r = kFirst; r < 64; ++r)
    w[r] = add_on_fma(
        small_sigma1(w[r - 2]),
        add_on_fma(add_on_fma(w[r - 16], w[r - 7], one),
                   small_sigma0(w[r - 15]), one),
        one);
}

// Rounds [kFirst, 64) of a compression, in place on s = {a..h}.
template <int kFirst>
__device__ __forceinline__ void rounds(uint32_t (&s)[8],
                                       const uint32_t (&w)[64],
                                       uint32_t one) {
  uint32_t a = s[0], b = s[1], c = s[2], d = s[3];
  uint32_t e = s[4], f = s[5], g = s[6], h = s[7];
#pragma unroll
  for (int r = kFirst; r < 64; ++r) {
    // h + K + w is known a round early: off the critical path.
    const uint32_t t1 = add_on_fma(
        add_on_fma(add_on_fma(h, kK[r] + w[r], one), big_sigma1(e), one),
        ch(e, f, g), one);
    const uint32_t t2 = add_on_fma(big_sigma0(a), maj(a, b, c), one);
    h = g; g = f; f = e; e = add_on_fma(d, t1, one);
    d = c; c = b; b = a; a = add_on_fma(t1, t2, one);
  }
  s[0] = a; s[1] = b; s[2] = c; s[3] = d;
  s[4] = e; s[5] = f; s[6] = g; s[7] = h;
}

// Digest words h0, h1 of sha256d(header with this nonce).
template <bool kExtFromSymbol>
__device__ __forceinline__ void sha256d_h01(const SweepArgs& args,
                                            uint32_t nonce, uint32_t& h0,
                                            uint32_t& h1) {
  const uint32_t* ext = kExtFromSymbol ? kExtSymbol : args.ext;
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
  expand<20>(w, args.one);
  uint32_t s[8] = {ext[kExtRcA] + w3, ext[kExtA2], ext[kExtA1], ext[kExtA0],
                   ext[kExtRcE] + w3, ext[kExtE2], ext[kExtE1], ext[kExtE0]};
  rounds<4>(s, w, args.one);

  // Hash 2 over the 32-byte digest: its words are the message directly.
  uint32_t w2[64];
#pragma unroll
  for (int i = 0; i < 8; ++i) w2[i] = s[i] + ext[i];
  w2[8] = 0x80000000u;
#pragma unroll
  for (int i = 9; i < 15; ++i) w2[i] = 0;
  w2[15] = 32 * 8;
  expand<16>(w2, args.one);
  uint32_t s2[8] = {kIV0, kIV1, kIV2, kIV3, kIV4, kIV5, kIV6, kIV7};
  rounds<0>(s2, w2, args.one);
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

// One trip of the loop takes a slice from the cursor and hashes one nonce
// per lane. kCountHashed is a measuring build: each warp also adds the
// nonces of each slice it takes to *hashed, which shows how far early exit
// overshoots the winner. kExtFromSymbol reads ext from kExtSymbol.
template <int kMode, bool kCountHashed, bool kExtFromSymbol>
__global__ void __launch_bounds__(kBlock)
    sha256d_sweep_kernel(const SweepArgs args, uint32_t* __restrict__ out,
                         unsigned long long* __restrict__ hashed) {
  const unsigned lane = threadIdx.x & 31u;
  auto* const cursor = reinterpret_cast<unsigned long long*>(out + 2);
  for (;;) {
    // Everything up to the hash is uniform across the warp, so every branch
    // is taken by all 32 lanes together.
    unsigned long long taken = 0;
    uint32_t best = 0;
    if (lane == 0) {
      taken = atomicAdd(cursor, 1ull);
      if (args.early_exit)
        best = *reinterpret_cast<volatile uint32_t*>(out + 1);
    }
    const unsigned long long first =
        __shfl_sync(kFullMask, taken, 0) * kSlice;
    if (first >= args.count) break;
    if (args.early_exit) {
      // Slices are handed out in ascending order, so once the minimum is
      // below this one it is below every slice this warp could take.
      best = __shfl_sync(kFullMask, best, 0);
      if (best < args.base + first) break;
    }
    if (kCountHashed && lane == 0) {
      const unsigned long long left = args.count - first;
      atomicAdd(hashed, left < kSlice ? left : kSlice);
    }
    const unsigned long long i = first + lane;
    const uint32_t nonce = static_cast<uint32_t>(args.base + i);
    uint32_t h0, h1;
    sha256d_h01<kExtFromSymbol>(args, nonce, h0, h1);
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
template <int kMode, bool kCountHashed, bool kExtFromSymbol>
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
        &per_sm, sha256d_sweep_kernel<kMode, kCountHashed, kExtFromSymbol>,
        kBlock, 0);
  if (err != cudaSuccess) return err;
  *blocks = static_cast<unsigned long long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (cached) cache[device].store(*blocks, std::memory_order_relaxed);
  return cudaSuccess;
}

template <int kMode, bool kCountHashed, bool kExtFromSymbol>
int launch(const SweepArgs& args, uint32_t* out, unsigned long long* hashed,
           cudaStream_t stream) {
  unsigned long long resident = 0;
  const cudaError_t err =
      resident_blocks<kMode, kCountHashed, kExtFromSymbol>(&resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  // A warp needs at least one slice; more blocks would find the queue empty.
  const unsigned long long slices = (args.count + kSlice - 1) / kSlice;
  const unsigned long long needed = (slices + kBlock / 32 - 1) / (kBlock / 32);
  const unsigned grid =
      static_cast<unsigned>(needed < resident ? needed : resident);
  sha256d_sweep_kernel<kMode, kCountHashed, kExtFromSymbol>
      <<<grid, kBlock, 0, stream>>>(args, out, hashed);
  return static_cast<int>(cudaGetLastError());
}

template <bool kCountHashed, bool kExt>
int launch_mode(int difficulty_bits, const SweepArgs& args, uint32_t* out,
                unsigned long long* hashed, cudaStream_t stream) {
  const int d = difficulty_bits;
  if (d <= 0)
    return launch<kAll, kCountHashed, kExt>(args, out, hashed, stream);
  if (d < 32)
    return launch<kBelow32, kCountHashed, kExt>(args, out, hashed, stream);
  if (d == 32)
    return launch<kEq32, kCountHashed, kExt>(args, out, hashed, stream);
  if (d < 64)
    return launch<kBelow64, kCountHashed, kExt>(args, out, hashed, stream);
  return launch<kEq64, kCountHashed, kExt>(args, out, hashed, stream);
}

// Registers a thread of an instantiation uses, and the blocks an SM holds at
// once; querying them also caches the instantiation's resident grid.
template <int kMode, bool kExt>
cudaError_t occupancy(int* registers, int* blocks_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err =
      cudaFuncGetAttributes(&attr, sha256d_sweep_kernel<kMode, false, kExt>);
  if (err != cudaSuccess) return err;
  *registers = attr.numRegs;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, sha256d_sweep_kernel<kMode, false, kExt>, kBlock, 0);
  if (err != cudaSuccess) return err;
  unsigned long long resident = 0;
  return resident_blocks<kMode, false, kExt>(&resident);
}

template <bool kExt>
cudaError_t occupancy_mode(int d, int* registers, int* blocks_per_sm) {
  return d <= 0    ? occupancy<kAll, kExt>(registers, blocks_per_sm)
         : d < 32  ? occupancy<kBelow32, kExt>(registers, blocks_per_sm)
         : d == 32 ? occupancy<kEq32, kExt>(registers, blocks_per_sm)
         : d < 64  ? occupancy<kBelow64, kExt>(registers, blocks_per_sm)
                   : occupancy<kEq64, kExt>(registers, blocks_per_sm);
}

// The sweep's arguments for [base, base + count) at a difficulty; ext may
// be null (the kExtFromSymbol instantiation reads kExtSymbol).
SweepArgs sweep_args(const uint32_t* ext, unsigned long long base,
                     unsigned long long count, int difficulty_bits,
                     int early_exit) {
  SweepArgs args;
  if (ext != nullptr)
    std::memcpy(args.ext, ext, sizeof(args.ext));
  else
    std::memset(args.ext, 0, sizeof(args.ext));
  args.base = base;
  args.count = count;
  args.one = 1;
  args.early_exit = early_exit;
  const int d = difficulty_bits;
  args.h0_limit = (d > 0 && d < 32) ? (1u << (32 - d)) : 0u;
  args.h1_limit = (d > 32 && d < 64) ? (1u << (64 - d)) : 0u;
  return args;
}

bool valid_range(unsigned long long base, unsigned long long count,
                 int difficulty_bits, const void* out) {
  return count != 0 && base + count <= (1ull << 32) && difficulty_bits <= 64 &&
         reinterpret_cast<uintptr_t>(out) % 8 == 0;
}

// ---- the fused miner's per-block step --------------------------------------

constexpr uint32_t kVersionWord = 0x01000000u;  // bswap32(version 1)
// The step's device scratch, uint32 words: the sweep's result buffer (at
// word 0, so 8-byte aligned), the block's extended midstate, its midstate
// and its chunk-2 template.
constexpr int kScratchResult = 0, kScratchExt = 4, kScratchMidstate = 24,
              kScratchTail = 32;

struct StepArgs {
  const uint32_t* prev;  // the previous digest, when no block is finalized
  const uint32_t* data;  // data-hash words of the block to build, or null
  uint32_t* scratch;     // result(4) | ext(20) | midstate(8) | tail(16)
  uint32_t* nonce_out;   // finalize: the swept block's nonce goes here
  uint32_t* tip_out;     // when no block is built: the digest goes here
  uint32_t height;       // timestamp of the block built
  uint32_t bits;         // difficulty bits of the block built
};

// The schedule's next 16 words, in place on the ring m (see compress_ring).
__device__ __forceinline__ void expand_ring(uint32_t (&m)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i)
    m[i] = small_sigma1(m[(i + 14) & 15]) +
           (m[i] + m[(i + 9) & 15] + small_sigma0(m[(i + 1) & 15]));
}

// state <- compress(state, m), the feed-forward included. m holds the 16
// message words and is the schedule's ring: trip t runs rounds 16 t ..
// 16 t + 15 on m[i] = w[16 t + i], then expands m in place into the next 16
// words, so every index is static once the trips are unrolled and the
// schedule stays in registers. The adds are plain: the compiler fuses them
// into three-input IADD3s, which keep the chain short.
__device__ __forceinline__ void compress_ring(uint32_t (&s)[8],
                                              uint32_t (&m)[16]) {
  uint32_t a = s[0], b = s[1], c = s[2], d = s[3];
  uint32_t e = s[4], f = s[5], g = s[6], h = s[7];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      // h + K + w is known a round early: off the critical path.
      const uint32_t t1 =
          h + (kK[16 * t + i] + m[i]) + big_sigma1(e) + ch(e, f, g);
      const uint32_t t2 = big_sigma0(a) + maj(a, b, c);
      h = g; g = f; f = e; e = d + t1;
      d = c; c = b; b = a; a = t1 + t2;
    }
    if (t < 3) expand_ring(m);
  }
  s[0] += a; s[1] += b; s[2] += c; s[3] += d;
  s[4] += e; s[5] += f; s[6] += g; s[7] += h;
}

template <int kN>
__device__ __forceinline__ void load_words(uint32_t (&dst)[kN],
                                           const uint32_t* __restrict__ src) {
#pragma unroll
  for (int i = 0; i < kN; ++i) dst[i] = src[i];
}

// The extended midstate of a template (ops/sha256_sched.py): rounds 0..2
// of the chunk-2 compression, round 3 folded onto the nonce word, and the
// nonce-invariant schedule prefix.
__device__ __forceinline__ void extend_midstate(const uint32_t (&ms)[8],
                                                const uint32_t (&t)[16],
                                                uint32_t (&x)[kExtWords]) {
  uint32_t a = ms[0], b = ms[1], c = ms[2], d = ms[3];
  uint32_t e = ms[4], f = ms[5], g = ms[6], h = ms[7];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const uint32_t t1 = h + big_sigma1(e) + ch(e, f, g) + kK[r] + t[r];
    const uint32_t t2 = big_sigma0(a) + maj(a, b, c);
    h = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + t2;
  }
  const uint32_t t1c = h + big_sigma1(e) + ch(e, f, g) + kK[3];
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = ms[i];
  x[kExtA2] = a; x[kExtA1] = b; x[kExtA0] = c;
  x[kExtE2] = e; x[kExtE1] = f; x[kExtE0] = g;
  x[kExtRcA] = t1c + big_sigma0(a) + maj(a, b, c);
  x[kExtRcE] = d + t1c;
  x[kExtW16] = t[0] + small_sigma0(t[1]);
  x[kExtW17] = t[1] + small_sigma0(t[2]) + small_sigma1(t[15]);
  x[kExtRc18] = t[2] + small_sigma1(x[kExtW16]);
  x[kExtRc19] = small_sigma0(t[4]) + small_sigma1(x[kExtW17]);
}

// One thread runs the step (StepArgs). Finalize when nonce_out is given:
// the swept block's lowest winner from the result buffer (0xFFFFFFFF when
// there is none, which the host's validation then rejects) and the double
// hash of its header, the next prev_hash. Build when data is given: the
// next header's midstate, chunk-2 template and extended midstate, and the
// result buffer reset, cursor included. kStamp is a measuring build: it
// writes clock64() at its first and last instruction to stamps[0] and
// stamps[1].
template <bool kStamp>
__global__ void __launch_bounds__(1)
    block_step_kernel(const uint32_t* __restrict__ prev,
                      const uint32_t* __restrict__ data,
                      uint32_t* __restrict__ scratch,
                      uint32_t* __restrict__ nonce_out,
                      uint32_t* __restrict__ tip_out, uint32_t height,
                      uint32_t bits, unsigned long long* stamps) {
  const long long start = kStamp ? clock64() : 0;
  const bool finalize = nonce_out != nullptr, build = data != nullptr;
  uint32_t* const result = scratch + kScratchResult;
  uint32_t* const midstate = scratch + kScratchMidstate;
  uint32_t* const tail = scratch + kScratchTail;
  // s and m are the state and message of the compression at hand, pw the
  // previous digest, dw the data words.
  uint32_t s[8], m[16], pw[8], dw[8];
  // The template, midstate and data words: nothing the sweep before this
  // step writes, so a programmatic dependent launch loads them before it
  // waits for the sweep.
  if (finalize) {
    load_words(m, tail);
    load_words(s, midstate);
  }
  if (build) load_words(dw, data);
  // Waits for the sweep launched before this step (a no-op in plain
  // stream order).
  asm volatile("griddepcontrol.wait;" ::: "memory");
  uint32_t nonce = 0;
  if (finalize) {
    nonce = result[1];
    m[3] = __byte_perm(nonce, 0, 0x0123);
  } else {
    load_words(pw, prev);
  }
  // Compression c = 0 hashes the swept header's chunk 2 from its midstate,
  // c = 1 that digest (the next prev_hash), c = 2 the next header's chunk 1
  // (version | prev_hash | data_hash[0:7], big-endian words).
  const int first = finalize ? 0 : 2, last = build ? 3 : 2;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    if (c < first || c >= last) continue;
    if (c == 1) {
#pragma unroll
      for (int i = 0; i < 8; ++i) m[i] = s[i];
      m[8] = 0x80000000u;
#pragma unroll
      for (int i = 9; i < 15; ++i) m[i] = 0;
      m[15] = 32 * 8;
    } else if (c == 2) {
      m[0] = kVersionWord;
#pragma unroll
      for (int i = 0; i < 8; ++i) m[1 + i] = pw[i];
#pragma unroll
      for (int i = 0; i < 7; ++i) m[9 + i] = dw[i];
    }
    if (c > 0) {
      s[0] = kIV0; s[1] = kIV1; s[2] = kIV2; s[3] = kIV3;
      s[4] = kIV4; s[5] = kIV5; s[6] = kIV6; s[7] = kIV7;
    }
    compress_ring(s, m);
    if (c == 1) {
#pragma unroll
      for (int i = 0; i < 8; ++i) pw[i] = s[i];
    }
  }
  if (finalize) *nonce_out = nonce;
  if (!build) {
    if (tip_out != nullptr) {
#pragma unroll
      for (int i = 0; i < 8; ++i) tip_out[i] = pw[i];
    }
  } else {
    // Chunk-2 template: data_hash[7] | timestamp | bits | nonce slot |
    // padding (the header stores the little-endian fields; SHA reads
    // big-endian).
    uint32_t t[16] = {dw[7], __byte_perm(height, 0, 0x0123),
                      __byte_perm(bits, 0, 0x0123), 0, 0x80000000u};
    t[15] = 80 * 8;
    uint32_t x[kExtWords];
    extend_midstate(s, t, x);
#pragma unroll
    for (int i = 0; i < kExtWords; ++i) scratch[kScratchExt + i] = x[i];
#pragma unroll
    for (int i = 0; i < 8; ++i) midstate[i] = s[i];
#pragma unroll
    for (int i = 0; i < 16; ++i) tail[i] = t[i];
    result[0] = 0;
    result[1] = 0xFFFFFFFFu;
    result[2] = 0;
    result[3] = 0;
  }
  if (kStamp) {
    stamps[0] = start;
    stamps[1] = clock64();
  }
}

// Enqueues one step on `stream`. One that follows a sweep (after_sweep) is
// a programmatic dependent launch: it may start while the sweep's grid
// drains, and waits for the sweep's results at griddepcontrol.wait. Steps
// back to back keep plain stream order: they share their scratch, which a
// step reads before it waits. A refused launch returns its error; nothing
// retries it another way.
template <bool kStamp = false>
int launch_step(const StepArgs& a, cudaStream_t stream,
                bool after_sweep = false,
                unsigned long long* stamps = nullptr) {
  cudaLaunchAttribute pdl;
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(1);
  config.blockDim = dim3(1);
  config.stream = stream;
  config.attrs = &pdl;
  config.numAttrs = after_sweep ? 1 : 0;
  const cudaError_t err =
      cudaLaunchKernelEx(&config, block_step_kernel<kStamp>, a.prev, a.data,
                         a.scratch, a.nonce_out, a.tip_out, a.height, a.bits,
                         stamps);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// Enqueues the copy of a device ext into kExtSymbol.
int copy_ext_to_symbol(const uint32_t* ext, cudaStream_t stream) {
  return static_cast<int>(
      cudaMemcpyToSymbolAsync(kExtSymbol, ext, sizeof(uint32_t) * kExtWords,
                              0, cudaMemcpyDeviceToDevice, stream));
}

}  // namespace

extern "C" {

// Enqueues one sweep of [base, base + count) on `stream`; `out` is the
// device result buffer {count, min, cursor_lo, cursor_hi}, 8-byte aligned
// and reset by the caller to {0, 0xFFFFFFFF, 0, 0}. Returns the CUDA error
// code of the launch (0 on success). count must be >= 1 and
// base + count <= 2^32; difficulty_bits <= 64 (<= 0 qualifies every
// nonce). A non-null `hashed`
// (a device uint64) selects the measuring build, which adds the number of
// nonces it hashed there.
int sha256d_sweep_launch(const uint32_t* ext, unsigned long long base,
                         unsigned long long count, int difficulty_bits,
                         int early_exit, void* out,
                         void* hashed, void* stream) {
  if (!valid_range(base, count, difficulty_bits, out))
    return static_cast<int>(cudaErrorInvalidValue);
  const int d = difficulty_bits;
  const SweepArgs args = sweep_args(ext, base, count, d, early_exit);
  uint32_t* o = static_cast<uint32_t*>(out);
  auto* n = static_cast<unsigned long long*>(hashed);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return n ? launch_mode<true, false>(d, args, o, n, s)
           : launch_mode<false, false>(d, args, o, n, s);
}

// The same sweep with the 20 ext words in device memory: enqueues their
// copy into kExtSymbol, then the kExtFromSymbol instantiation.
int sha256d_sweep_launch_ext_symbol(const uint32_t* ext_device,
                                    unsigned long long base,
                                    unsigned long long count,
                                    int difficulty_bits, int early_exit,
                                    void* out, void* stream) {
  if (!valid_range(base, count, difficulty_bits, out))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = copy_ext_to_symbol(ext_device, s);
  if (err != 0) return err;
  const SweepArgs args =
      sweep_args(nullptr, base, count, difficulty_bits, early_exit);
  return launch_mode<false, true>(difficulty_bits, args,
                                  static_cast<uint32_t*>(out), nullptr, s);
}

// Enqueues one fused step (StepArgs above; null pointers switch its parts
// off). scratch must be 8-byte aligned.
int sha256d_block_step_launch(const uint32_t* prev, const uint32_t* data,
                              void* scratch, uint32_t* nonce_out,
                              uint32_t* tip_out, unsigned int height,
                              unsigned int bits, void* stream) {
  if (reinterpret_cast<uintptr_t>(scratch) % 8 != 0 ||
      (prev == nullptr && nonce_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const StepArgs args{prev, data, static_cast<uint32_t*>(scratch),
                      nonce_out, tip_out, height, bits};
  return launch_step(args, static_cast<cudaStream_t>(stream));
}

// Enqueues n such steps back to back on `stream` in one call, so that no
// host work lies between the launches (a measuring entry). A non-null
// `stamps` (2 n device uint64) selects the measuring build: launch i writes
// clock64() at its first and last instruction to stamps[2 i], stamps[2 i + 1].
int sha256d_block_step_repeat(int n, const uint32_t* prev,
                              const uint32_t* data, void* scratch,
                              uint32_t* nonce_out, uint32_t* tip_out,
                              unsigned int height, unsigned int bits,
                              void* stamps, void* stream) {
  if (n < 1 || reinterpret_cast<uintptr_t>(scratch) % 8 != 0 ||
      (prev == nullptr && nonce_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const StepArgs args{prev, data, static_cast<uint32_t*>(scratch),
                      nonce_out, tip_out, height, bits};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* const t = static_cast<unsigned long long*>(stamps);
  for (int i = 0; i < n; ++i) {
    const int err = t ? launch_step<true>(args, s, false, t + 2 * i)
                      : launch_step(args, s);
    if (err != 0) return err;
  }
  return 0;
}

// Enqueues a whole k-block call of the fused miner on `stream`: for each
// block j, the step (finalize block j - 1, build block j at height
// start_height + j + 1 from data[8 j .. 8 j + 8)), the copy of its ext into
// kExtSymbol and an early-exit sweep of [0, cap); then a final step that
// finalizes block k - 1 into tip. nonces gets the k winners (0xFFFFFFFF where
// [0, cap) holds none). prev, data, nonces and tip are device uint32 arrays
// of 8, 8 k, k and 8 words; scratch is a device buffer of 48 words, 8-byte
// aligned. For measuring, a non-null sweep_events holds 2 k cudaEvent_t,
// recorded before and after each sweep, and a non-null step_events k + 1,
// recorded after each step, which splits the device time between two
// sweeps into the step and the symbol copy. Returns the first CUDA error
// (0 on success); nothing synchronizes.
int sha256d_fused_enqueue(const uint32_t* prev, const uint32_t* data, int k,
                          unsigned int start_height, int difficulty_bits,
                          unsigned long long cap, void* scratch,
                          uint32_t* nonces, uint32_t* tip,
                          void* const* sweep_events,
                          void* const* step_events, void* stream) {
  if (k < 1 || difficulty_bits < 0 ||
      !valid_range(0, cap, difficulty_bits, scratch))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* const sc = static_cast<uint32_t*>(scratch);
  const SweepArgs args = sweep_args(nullptr, 0, cap, difficulty_bits, 1);
  for (int j = 0; j <= k; ++j) {
    const StepArgs step{prev, j < k ? data + 8 * j : nullptr, sc,
                        j > 0 ? nonces + j - 1 : nullptr,
                        j == k ? tip : nullptr,
                        start_height + static_cast<unsigned int>(j) + 1u,
                        static_cast<uint32_t>(difficulty_bits)};
    int err = launch_step(step, s, j > 0);
    if (err == 0 && step_events != nullptr)
      err = static_cast<int>(
          cudaEventRecord(static_cast<cudaEvent_t>(step_events[j]), s));
    if (err != 0 || j == k) return err;
    err = copy_ext_to_symbol(sc + kScratchExt, s);
    if (err != 0) return err;
    if (sweep_events != nullptr) {
      err = static_cast<int>(cudaEventRecord(
          static_cast<cudaEvent_t>(sweep_events[2 * j]), s));
      if (err != 0) return err;
    }
    err = launch_mode<false, true>(difficulty_bits, args, sc + kScratchResult,
                                   nullptr, s);
    if (err != 0) return err;
    if (sweep_events != nullptr) {
      err = static_cast<int>(cudaEventRecord(
          static_cast<cudaEvent_t>(sweep_events[2 * j + 1]), s));
      if (err != 0) return err;
    }
  }
  return 0;
}

// Registers a thread and blocks per SM of the production sweep at
// difficulty_bits, by-value ext (ext_from_symbol 0) or kExtSymbol (1), on
// the current device. Returns the CUDA error code (0 on success).
int sha256d_sweep_occupancy(int difficulty_bits, int ext_from_symbol,
                            int* registers, int* blocks_per_sm) {
  return static_cast<int>(
      ext_from_symbol
          ? occupancy_mode<true>(difficulty_bits, registers, blocks_per_sm)
          : occupancy_mode<false>(difficulty_bits, registers, blocks_per_sm));
}

// Blocks a production launch at `difficulty_bits` runs on the current
// device (its persistent grid), or minus the CUDA error code.
long long sha256d_sweep_resident_blocks(int difficulty_bits) {
  const int d = difficulty_bits;
  unsigned long long blocks = 0;
  const cudaError_t err =
      d <= 0    ? resident_blocks<kAll, false, false>(&blocks)
      : d < 32  ? resident_blocks<kBelow32, false, false>(&blocks)
      : d == 32 ? resident_blocks<kEq32, false, false>(&blocks)
      : d < 64  ? resident_blocks<kBelow64, false, false>(&blocks)
                : resident_blocks<kEq64, false, false>(&blocks);
  return err == cudaSuccess ? static_cast<long long>(blocks)
                            : -static_cast<long long>(err);
}

// Threads in a block of the persistent grid.
int sha256d_sweep_block_threads() { return kBlock; }

// The CUDA runtime's message for an error code returned above.
const char* sha256d_sweep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
