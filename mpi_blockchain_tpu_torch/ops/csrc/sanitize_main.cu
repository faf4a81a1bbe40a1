// Sanitizer driver for the CUDA kernel library (sha256d_sweep.cu).
//
// The counterpart of the reference's core/src/sanity_main.cpp: a standalone
// program that runs every entry of the library's C interface against known
// answers, so that compute-sanitizer's memcheck, racecheck, synccheck and
// initcheck tools check the kernels without instrumenting Python and
// PyTorch. The known answers come from the C++ core's SHA-256
// (core/csrc/sha256.cpp) on the host: for each sweep, the count and the
// lowest qualifying nonce of its range by brute force; for each step, the
// header's midstate, chunk-2 template and extended midstate, and the
// winner's double hash; for a k-block call, the chain of k blocks mined
// one by one.
//
// It covers the sweep by value (sha256d_sweep_launch, its measuring build
// and its stamped form) and from the __constant__ ext symbol
// (sha256d_sweep_launch_ext_symbol, which copies ext into kExtSymbol) at
// difficulties 16 and 24, the step (build, finalize, back to back, and its
// measuring build), the fused k-block call (step, symbol copy and sweep, k
// times, with and without timing events), the queries and the timer's
// tick.
//
// Built by mpi_blockchain_tpu_torch/analysis/sanitizers.py into the
// package's git-ignored build/ directory (one translation unit: this file
// includes the library's source). Usage:
//   sanitize_sha256d                  every case; exit 0 iff all match
//   sanitize_sha256d --poison short   one sweep into a result buffer one
//                                     word short (memcheck must report it)
//   sanitize_sha256d --poison uninit  one sweep into a result buffer never
//                                     reset (initcheck must report it)
// Exit codes: 0 all cases match, 1 a case disagrees or a call failed,
// 2 bad usage, 3 no CUDA device.
#include "sha256d_sweep.cu"

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "../../core/csrc/sha256.hpp"

namespace host {

int failures = 0;

void expect(bool ok, const char* what) {
  std::printf("%s %s\n", ok ? "ok" : "FAIL", what);
  if (!ok) ++failures;
}

bool cuda_ok(cudaError_t err, const char* what) {
  if (err == cudaSuccess) return true;
  std::printf("FAIL %s: %s\n", what, cudaGetErrorString(err));
  ++failures;
  return false;
}

bool lib_ok(int err, const char* what) {
  return cuda_ok(static_cast<cudaError_t>(err), what);
}

uint32_t rotr(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }
uint32_t bsig0(uint32_t a) { return rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22); }
uint32_t bsig1(uint32_t e) { return rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25); }
uint32_t ssig0(uint32_t x) { return rotr(x, 7) ^ rotr(x, 18) ^ (x >> 3); }
uint32_t ssig1(uint32_t x) { return rotr(x, 17) ^ rotr(x, 19) ^ (x >> 10); }
uint32_t bswap(uint32_t x) {
  return (x >> 24) | ((x >> 8) & 0xFF00u) | ((x << 8) & 0xFF0000u) |
         (x << 24);
}

const uint32_t kRoundK[4] = {0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5};

// The 20-word extended midstate of a template (ops/sha256_sched.py), on
// the host.
void extend(const uint32_t ms[8], const uint32_t t[16], uint32_t x[20]) {
  uint32_t a = ms[0], b = ms[1], c = ms[2], d = ms[3];
  uint32_t e = ms[4], f = ms[5], g = ms[6], h = ms[7];
  for (int r = 0; r < 3; ++r) {
    const uint32_t t1 = h + bsig1(e) + (g ^ (e & (f ^ g))) + kRoundK[r] + t[r];
    const uint32_t t2 = bsig0(a) + (b ^ ((a ^ b) & (b ^ c)));
    h = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + t2;
  }
  const uint32_t t1c = h + bsig1(e) + (g ^ (e & (f ^ g))) + kRoundK[3];
  for (int i = 0; i < 8; ++i) x[i] = ms[i];
  x[8] = a; x[9] = b; x[10] = c;
  x[11] = e; x[12] = f; x[13] = g;
  x[14] = t1c + bsig0(a) + (b ^ ((a ^ b) & (b ^ c)));
  x[15] = d + t1c;
  x[16] = t[0] + ssig0(t[1]);
  x[17] = t[1] + ssig0(t[2]) + ssig1(t[15]);
  x[18] = t[2] + ssig1(x[16]);
  x[19] = ssig0(t[4]) + ssig1(x[17]);
}

// A block as the fused step builds it: version 1, the previous digest's
// words, the data words, the height as timestamp and the difficulty bits.
struct Block {
  uint32_t prev[8];
  uint32_t data[8];
  uint32_t height;
  uint32_t bits;
};

void put_be(uint8_t* p, uint32_t v) {
  p[0] = uint8_t(v >> 24); p[1] = uint8_t(v >> 16);
  p[2] = uint8_t(v >> 8); p[3] = uint8_t(v);
}
void put_le(uint8_t* p, uint32_t v) {
  p[0] = uint8_t(v); p[1] = uint8_t(v >> 8);
  p[2] = uint8_t(v >> 16); p[3] = uint8_t(v >> 24);
}

void header(const Block& b, uint32_t nonce, uint8_t out[80]) {
  put_le(out, 1);
  for (int i = 0; i < 8; ++i) put_be(out + 4 + 4 * i, b.prev[i]);
  for (int i = 0; i < 8; ++i) put_be(out + 36 + 4 * i, b.data[i]);
  put_le(out + 68, b.height);
  put_le(out + 72, b.bits);
  put_le(out + 76, nonce);
}

int lzb(const Block& b, uint32_t nonce) {
  uint8_t h[80], d[32];
  header(b, nonce, h);
  chaincore::sha256d(h, 80, d);
  return chaincore::leading_zero_bits(d);
}

void digest_words(const Block& b, uint32_t nonce, uint32_t w[8]) {
  uint8_t h[80], d[32];
  header(b, nonce, h);
  chaincore::sha256d(h, 80, d);
  for (int i = 0; i < 8; ++i)
    w[i] = (uint32_t(d[4 * i]) << 24) | (uint32_t(d[4 * i + 1]) << 16) |
           (uint32_t(d[4 * i + 2]) << 8) | uint32_t(d[4 * i + 3]);
}

void template_words(const Block& b, uint32_t ms[8], uint32_t t[16],
                    uint32_t x[20]) {
  uint8_t h[80];
  header(b, 0, h);
  chaincore::header_midstate(h, ms, t);
  extend(ms, t, x);
}

// Count and lowest qualifying nonce of [base, base + count) by brute force.
void brute(const Block& b, uint64_t base, uint64_t count, int dbits,
           uint32_t* hits, uint32_t* lowest) {
  *hits = 0;
  *lowest = 0xFFFFFFFFu;
  for (uint64_t n = base; n < base + count; ++n) {
    if (lzb(b, static_cast<uint32_t>(n)) >= dbits) {
      if (*hits == 0) *lowest = static_cast<uint32_t>(n);
      ++*hits;
    }
  }
}

// The test block: its lowest nonce with 24 leading zero bits is
// kWinner24 (found once by brute force over [0, kWinner24]; the dbits-24
// window below holds it, and the brute force of the window confirms it).
Block test_block() {
  Block b;
  for (int i = 0; i < 8; ++i) {
    b.prev[i] = 0x01020304u * static_cast<uint32_t>(i + 1);
    b.data[i] = 0x9e3779b9u * static_cast<uint32_t>(i + 1);
  }
  b.height = 7;
  b.bits = 24;
  return b;
}
constexpr uint64_t kWinner24 = 12226267;
constexpr uint64_t kWindow = 1 << 16;

// ---- device buffers -------------------------------------------------------

template <typename T>
T* device_words(const T* src, size_t n) {
  T* p = nullptr;
  if (!cuda_ok(cudaMalloc(&p, n * sizeof(T)), "cudaMalloc")) return nullptr;
  if (src != nullptr)
    cuda_ok(cudaMemcpy(p, src, n * sizeof(T), cudaMemcpyHostToDevice),
            "cudaMemcpy to the device");
  return p;
}

template <typename T>
void to_host(T* dst, const T* src, size_t n) {
  cuda_ok(cudaMemcpy(dst, src, n * sizeof(T), cudaMemcpyDeviceToHost),
          "cudaMemcpy to the host");
}

const uint32_t kFreshResult[4] = {0, 0xFFFFFFFFu, 0, 0};
// A stamped result buffer as reset: the result, start all ones, end 0.
const uint32_t kFreshStamped[8] = {0, 0xFFFFFFFFu, 0, 0,
                                   0xFFFFFFFFu, 0xFFFFFFFFu, 0, 0};

// ---- the cases ------------------------------------------------------------

enum SweepForm { kByValue, kExtSymbol, kStamped, kMeasured };

void sweep_case(SweepForm form, int dbits, uint64_t base, uint64_t count,
                int early_exit, cudaStream_t s) {
  const Block b = test_block();
  uint32_t ms[8], t[16], ext[20];
  template_words(b, ms, t, ext);
  uint32_t want_hits, want_min;
  brute(b, base, count, dbits, &want_hits, &want_min);

  const int words = form == kStamped ? 8 : 4;
  uint32_t* out =
      device_words(form == kStamped ? kFreshStamped : kFreshResult, words);
  uint32_t* ext_dev = device_words(ext, 20);
  unsigned long long* hashed = nullptr;
  int err = 0;
  if (form == kByValue) {
    err = sha256d_sweep_launch(ext, base, count, dbits, early_exit, out,
                               nullptr, s);
  } else if (form == kExtSymbol) {
    err = sha256d_sweep_launch_ext_symbol(ext_dev, base, count, dbits,
                                          early_exit, out, s);
  } else if (form == kStamped) {
    err = sha256d_sweep_launch_stamped(ext, base, count, dbits, early_exit,
                                       out, s);
  } else {
    const unsigned long long zero = 0;
    hashed = device_words(&zero, 1);
    err = sha256d_sweep_launch(ext, base, count, dbits, early_exit, out,
                               hashed, s);
  }
  char what[160];
  static const char* kForms[] = {"by value", "ext symbol", "stamped",
                                 "measuring"};
  std::snprintf(what, sizeof what,
                "sweep %s dbits %d [%llu, +%llu) early_exit %d", kForms[form],
                dbits, static_cast<unsigned long long>(base),
                static_cast<unsigned long long>(count), early_exit);
  if (lib_ok(err, what) && cuda_ok(cudaStreamSynchronize(s), what)) {
    uint32_t got[8];
    to_host(got, out, words);
    const bool min_ok = got[1] == want_min;
    const bool count_ok = early_exit ? ((got[0] > 0) == (want_hits > 0))
                                     : got[0] == want_hits;
    expect(min_ok && count_ok, what);
    if (form == kStamped) {
      unsigned long long stamp[2];
      std::memcpy(stamp, got + 4, sizeof stamp);
      expect(stamp[0] != ~0ull && stamp[1] != 0 && stamp[0] <= stamp[1],
             "the stamped sweep's start and end stamps: both written, "
             "start no later than end");
    }
    if (form == kMeasured && !early_exit) {
      unsigned long long n = 0;
      to_host(&n, hashed, 1);
      expect(n == count, "the measuring sweep hashed every nonce");
    }
  }
  cudaFree(hashed);
  cudaFree(ext_dev);
  cudaFree(out);
}

// The step: build a block into the scratch, sweep it from the ext symbol
// into the scratch's result buffer, finalize it; then the same build back
// to back (sha256d_block_step_repeat) with and without its clock stamps.
void step_case(cudaStream_t s) {
  Block b = test_block();
  b.bits = 16;
  uint32_t ms[8], t[16], ext[20];
  template_words(b, ms, t, ext);
  uint32_t* prev = device_words(b.prev, 8);
  uint32_t* data = device_words(b.data, 8);
  uint32_t* scratch = device_words<uint32_t>(nullptr, 48);
  uint32_t* nonce = device_words<uint32_t>(nullptr, 1);
  uint32_t* tip = device_words<uint32_t>(nullptr, 8);

  auto check_build = [&](const char* what) {
    uint32_t got[48];
    to_host(got, scratch, 48);
    bool ok = std::memcmp(got, kFreshResult, sizeof kFreshResult) == 0 &&
              std::memcmp(got + 4, ext, sizeof ext) == 0 &&
              std::memcmp(got + 24, ms, sizeof ms) == 0;
    for (int i = 0; i < 16; ++i) ok = ok && got[32 + i] == t[i];
    expect(ok, what);
  };

  if (lib_ok(sha256d_block_step_launch(prev, data, scratch, nullptr, nullptr,
                                       b.height, b.bits, s),
             "step build") &&
      cuda_ok(cudaStreamSynchronize(s), "step build")) {
    check_build("step build: result reset, ext, midstate, template");
  }
  const uint64_t cap = 1 << 20;
  uint8_t h0[80];
  header(b, 0, h0);
  const uint64_t want = chaincore::midstate_sweep(h0, 0, cap, b.bits, nullptr);
  if (lib_ok(sha256d_sweep_launch_ext_symbol(scratch + 4, 0, cap, b.bits, 1,
                                             scratch, s),
             "sweep of the built block") &&
      lib_ok(sha256d_block_step_launch(nullptr, nullptr, scratch, nonce, tip,
                                       0, 0, s),
             "step finalize") &&
      cuda_ok(cudaStreamSynchronize(s), "step finalize")) {
    uint32_t got_nonce = 0, got_tip[8], want_tip[8];
    to_host(&got_nonce, nonce, 1);
    to_host(got_tip, tip, 8);
    digest_words(b, static_cast<uint32_t>(want), want_tip);
    expect(want != UINT64_MAX && got_nonce == want &&
               std::memcmp(got_tip, want_tip, sizeof want_tip) == 0,
           "step finalize: the lowest winner and its double hash");
  }
  if (lib_ok(sha256d_block_step_repeat(3, prev, data, scratch, nullptr,
                                       nullptr, b.height, b.bits, nullptr, s),
             "step repeat") &&
      cuda_ok(cudaStreamSynchronize(s), "step repeat")) {
    check_build("step repeat x3: the same build");
  }
  unsigned long long* stamps = device_words<unsigned long long>(nullptr, 4);
  if (lib_ok(sha256d_block_step_repeat(2, prev, data, scratch, nullptr,
                                       nullptr, b.height, b.bits, stamps, s),
             "step repeat, measuring build") &&
      cuda_ok(cudaStreamSynchronize(s), "step repeat, measuring build")) {
    unsigned long long st[4];
    to_host(st, stamps, 4);
    check_build("step repeat x2, measuring build: the same build");
    expect(st[0] <= st[1] && st[2] <= st[3],
           "the measuring step's clock stamps ascend");
  }
  cudaFree(stamps);
  cudaFree(tip);
  cudaFree(nonce);
  cudaFree(scratch);
  cudaFree(data);
  cudaFree(prev);
}

// A k-block call of the fused miner, against the k blocks mined one by one.
void fused_case(bool with_events, cudaStream_t s) {
  constexpr int kK = 2, kDbits = 8;
  constexpr unsigned kStart = 5;
  constexpr uint64_t kCap = 1 << 16;
  const Block base = test_block();
  uint32_t want_nonces[kK], want_tip[8];
  Block b = base;
  for (int j = 0; j < kK; ++j) {
    for (int i = 0; i < 8; ++i)
      b.data[i] = base.data[i] ^ (0x5bd1e995u * static_cast<uint32_t>(j + 1));
    b.height = kStart + static_cast<unsigned>(j) + 1;
    b.bits = kDbits;
    uint32_t hits;
    brute(b, 0, kCap, kDbits, &hits, &want_nonces[j]);
    digest_words(b, want_nonces[j], want_tip);
    std::memcpy(b.prev, want_tip, sizeof want_tip);
  }
  uint32_t data_words[8 * kK];
  for (int j = 0; j < kK; ++j)
    for (int i = 0; i < 8; ++i)
      data_words[8 * j + i] =
          base.data[i] ^ (0x5bd1e995u * static_cast<uint32_t>(j + 1));

  uint32_t* prev = device_words(base.prev, 8);
  uint32_t* data = device_words(data_words, 8 * kK);
  uint32_t* scratch = device_words<uint32_t>(nullptr, 48);
  uint32_t* nonces = device_words<uint32_t>(nullptr, kK);
  uint32_t* tip = device_words<uint32_t>(nullptr, 8);
  std::vector<cudaEvent_t> sweeps(2 * kK), steps(kK + 1);
  if (with_events) {
    for (auto& e : sweeps) cuda_ok(cudaEventCreate(&e), "cudaEventCreate");
    for (auto& e : steps) cuda_ok(cudaEventCreate(&e), "cudaEventCreate");
  }
  const char* what = with_events ? "fused k=2 call with timing events"
                                 : "fused k=2 call";
  if (lib_ok(sha256d_fused_enqueue(
                 prev, data, kK, kStart, kDbits, kCap, scratch, nonces, tip,
                 with_events ? reinterpret_cast<void* const*>(sweeps.data())
                             : nullptr,
                 with_events ? reinterpret_cast<void* const*>(steps.data())
                             : nullptr,
                 s),
             what) &&
      cuda_ok(cudaStreamSynchronize(s), what)) {
    uint32_t got_nonces[kK], got_tip[8];
    to_host(got_nonces, nonces, kK);
    to_host(got_tip, tip, 8);
    expect(std::memcmp(got_nonces, want_nonces, sizeof want_nonces) == 0 &&
               std::memcmp(got_tip, want_tip, sizeof want_tip) == 0,
           what);
  }
  if (with_events) {
    for (auto& e : sweeps) cudaEventDestroy(e);
    for (auto& e : steps) cudaEventDestroy(e);
  }
  cudaFree(tip);
  cudaFree(nonces);
  cudaFree(scratch);
  cudaFree(data);
  cudaFree(prev);
}

void query_case() {
  for (int symbol = 0; symbol < 2; ++symbol) {
    int regs = 0, per_sm = 0;
    lib_ok(sha256d_sweep_occupancy(24, symbol, &regs, &per_sm),
           "sha256d_sweep_occupancy");
    expect(regs > 0 && per_sm > 0, "occupancy query");
  }
  expect(sha256d_sweep_resident_blocks(24) > 0, "resident blocks query");
  expect(sha256d_sweep_block_threads() == kBlock, "block threads query");
  expect(sha256d_sweep_error_string(0) != nullptr, "error string query");
}

// The timer's tick: the kernel sees it step, by a positive amount.
void tick_case(cudaStream_t s) {
  unsigned long long* out = device_words<unsigned long long>(nullptr, 4);
  if (lib_ok(sha256d_globaltimer_tick(out, 1 << 12, s),
             "sha256d_globaltimer_tick") &&
      cuda_ok(cudaStreamSynchronize(s), "sha256d_globaltimer_tick")) {
    unsigned long long got[4];
    to_host(got, out, 4);
    expect(got[0] > 0 && got[1] > 0 && got[2] < got[3],
           "the timer's tick: it steps while the kernel reads it");
  }
  cudaFree(out);
}

// One sweep into a deliberately broken result buffer; what it returns does
// not matter, only what the tool reports.
void poison_case(bool short_buffer, cudaStream_t s) {
  const Block b = test_block();
  uint32_t ms[8], t[16], ext[20];
  template_words(b, ms, t, ext);
  uint32_t* out = nullptr;
  if (short_buffer) {
    out = device_words(kFreshResult, 3);  // the cursor's high word is missing
  } else {
    out = device_words<uint32_t>(nullptr, 4);  // never reset
  }
  sha256d_sweep_launch(ext, 0, kWindow, 16, 1, out, nullptr, s);
  cudaStreamSynchronize(s);
  cudaFree(out);
}

}  // namespace host

int main(int argc, char** argv) {
  const char* poison = nullptr;
  if (argc == 3 && std::strcmp(argv[1], "--poison") == 0 &&
      (std::strcmp(argv[2], "short") == 0 ||
       std::strcmp(argv[2], "uninit") == 0)) {
    poison = argv[2];
  } else if (argc != 1) {
    std::fprintf(stderr, "usage: %s [--poison short|uninit]\n", argv[0]);
    return 2;
  }
  int devices = 0;
  if (cudaGetDeviceCount(&devices) != cudaSuccess || devices == 0) {
    std::fprintf(stderr, "no CUDA device\n");
    return 3;
  }
  cudaStream_t s = nullptr;
  if (!host::cuda_ok(cudaStreamCreate(&s), "cudaStreamCreate")) return 1;
  if (poison != nullptr) {
    host::poison_case(std::strcmp(poison, "short") == 0, s);
    cudaStreamDestroy(s);
    std::printf("poisoned run (%s) done\n", poison);
    return 0;
  }
  const uint64_t w24 = host::kWinner24 - 40000;
  for (int dbits : {16, 24}) {
    const uint64_t base = dbits == 24 ? w24 : 0;
    for (int ee = 0; ee < 2; ++ee) {
      host::sweep_case(host::kByValue, dbits, base, host::kWindow, ee, s);
      host::sweep_case(host::kExtSymbol, dbits, base, host::kWindow, ee, s);
    }
  }
  host::sweep_case(host::kStamped, 16, 0, host::kWindow, 1, s);
  host::sweep_case(host::kMeasured, 16, 0, host::kWindow, 0, s);
  host::step_case(s);
  host::fused_case(false, s);
  host::fused_case(true, s);
  host::query_case();
  host::tick_case(s);
  cudaStreamDestroy(s);
  std::printf("%s: %d failure(s)\n", host::failures ? "FAIL" : "ok",
              host::failures);
  return host::failures ? 1 : 0;
}
