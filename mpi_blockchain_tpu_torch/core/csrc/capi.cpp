// extern "C" boundary for ctypes — the FALLBACK Python <-> C++ binding.
//
// BASELINE.json's north-star names pybind11 for this boundary, and since
// round 2 the pybind11 extension (src/pybind_module.cpp, built against the
// headers vendored in the image's torch/tensorflow include trees) is the
// default. This CPython-agnostic C ABI stays as the fallback for
// environments with no pybind11 headers (SURVEY.md §7 hard part #7). Both
// bindings expose the identical surface: the C++ Block/Node classes remain
// the canonical chain state; Python sees only opaque Node handles, 80-byte
// serialized headers, and 32-byte digests.
#include <cstdint>
#include <cstring>
#include <vector>

#include "chain.hpp"
#include "sha256.hpp"

using namespace chaincore;

extern "C" {

// ---------- hashing primitives ----------

void cc_sha256(const uint8_t* data, uint64_t len, uint8_t out[32]) {
  sha256(data, len, out);
}

void cc_sha256d(const uint8_t* data, uint64_t len, uint8_t out[32]) {
  sha256d(data, len, out);
}

void cc_header_hash(const uint8_t header80[80], uint8_t out[32]) {
  sha256d(header80, kHeaderSize, out);
}

int cc_leading_zero_bits(const uint8_t h[32]) { return leading_zero_bits(h); }

// Midstate + chunk-2 word template for an 80-byte header (see sha256.hpp).
void cc_header_midstate(const uint8_t header80[80], uint32_t out_state[8],
                        uint32_t out_tail_w[16]) {
  header_midstate(header80, out_state, out_tail_w);
}

// ---------- CPU nonce search (the cpu miner_backend) ----------

// Sequential lowest-nonce-first sweep; the shared chaincore::midstate_sweep
// implements the deterministic "lowest qualifying nonce" winner rule
// (BASELINE.json north-star requirement) for both bindings.
uint64_t cc_search(const uint8_t header80[80], uint64_t start_nonce,
                   uint64_t count, uint32_t difficulty_bits,
                   uint64_t* hashes_tried) {
  return midstate_sweep(header80, start_nonce, count, difficulty_bits,
                        hashes_tried);
}

// ---------- Node / Chain object API ----------

void* cc_node_new(uint32_t difficulty_bits, int node_id) {
  return new Node(difficulty_bits, node_id);
}

void cc_node_free(void* node) { delete static_cast<Node*>(node); }

uint64_t cc_node_height(void* node) {
  return static_cast<Node*>(node)->height();
}

uint32_t cc_node_difficulty(void* node) {
  return static_cast<Node*>(node)->chain().difficulty_bits();
}

void cc_node_tip_hash(void* node, uint8_t out[32]) {
  std::memcpy(out, static_cast<Node*>(node)->chain().tip().hash, 32);
}

void cc_node_block_hash(void* node, uint64_t height, uint8_t out[32]) {
  const Chain& c = static_cast<Node*>(node)->chain();
  if (height > c.height()) {  // defense in depth; Python raises first
    std::memset(out, 0, 32);
    return;
  }
  std::memcpy(out, c.at(height).hash, 32);
}

void cc_node_block_header(void* node, uint64_t height, uint8_t out80[80]) {
  const Chain& c = static_cast<Node*>(node)->chain();
  if (height > c.height()) {
    std::memset(out80, 0, kHeaderSize);
    return;
  }
  c.at(height).header.serialize(out80);
}

void cc_node_make_candidate(void* node, const uint8_t* data, uint64_t len,
                            uint8_t out80[80]) {
  static_cast<Node*>(node)->make_candidate(data, len).serialize(out80);
}

// Returns 1 on success (validated + appended), 0 otherwise.
int cc_node_submit(void* node, const uint8_t header80[80]) {
  return static_cast<Node*>(node)->submit(BlockHeader::deserialize(header80))
             ? 1
             : 0;
}

// Returns the RecvResult enum value.
int cc_node_receive(void* node, const uint8_t header80[80]) {
  return int(static_cast<Node*>(node)->on_block_received(
      BlockHeader::deserialize(header80)));
}

// headers = n concatenated 80-byte headers for heights 1..n.
// Returns the RecvResult enum value (kReorged on adoption).
int cc_node_adopt_chain(void* node, const uint8_t* headers, uint64_t n) {
  std::vector<BlockHeader> hs;
  hs.reserve(n);
  for (uint64_t i = 0; i < n; ++i)
    hs.push_back(BlockHeader::deserialize(headers + i * kHeaderSize));
  return int(static_cast<Node*>(node)->adopt_chain(hs));
}

// Suffix adoption above a common ancestor at `anchor` (O(suffix) sync).
// headers = n concatenated 80-byte headers for heights anchor+1..anchor+n.
// Returns the RecvResult enum value (kReorged on adoption).
int cc_node_adopt_suffix(void* node, uint64_t anchor, const uint8_t* headers,
                         uint64_t n) {
  std::vector<BlockHeader> hs;
  hs.reserve(n);
  for (uint64_t i = 0; i < n; ++i)
    hs.push_back(BlockHeader::deserialize(headers + i * kHeaderSize));
  return int(static_cast<Node*>(node)->adopt_suffix(anchor, hs));
}

// Height of the block with this hash on the node's chain, or -1 (O(1)
// via the chain's hash index) — the sync protocol's common-ancestor probe.
int64_t cc_node_find(void* node, const uint8_t hash32[32]) {
  return static_cast<Node*>(node)->chain().find(hash32);
}

// Serves the headers ABOVE from_height (heights from_height+1..tip) as
// concatenated 80-byte headers into `out` (caller allocates
// (height - from_height)*80 bytes). Returns the number of headers written;
// 0 when from_height >= height.
uint64_t cc_node_headers_from(void* node, uint64_t from_height, uint8_t* out) {
  std::vector<uint8_t> bytes =
      static_cast<Node*>(node)->chain().headers_from(from_height);
  if (!bytes.empty()) std::memcpy(out, bytes.data(), bytes.size());
  return bytes.size() / kHeaderSize;
}

// Writes the whole chain (genesis..tip) as concatenated headers into `out`
// (caller allocates (height+1)*80 bytes). Returns the number of headers.
uint64_t cc_node_save(void* node, uint8_t* out) {
  std::vector<uint8_t> bytes = static_cast<Node*>(node)->chain().save();
  std::memcpy(out, bytes.data(), bytes.size());
  return bytes.size() / kHeaderSize;
}

// Restores chain state from concatenated headers (validates everything,
// under the node's CURRENT retarget rule). Returns 1 on success.
int cc_node_load(void* node, const uint8_t* bytes, uint64_t n_headers) {
  Node* nd = static_cast<Node*>(node);
  std::vector<uint8_t> buf(bytes, bytes + n_headers * kHeaderSize);
  Chain fresh(nd->chain().difficulty_bits());
  if (!Chain::load(buf, nd->chain().difficulty_bits(), &fresh,
                   nd->chain().retarget_interval(),
                   nd->chain().retarget_step(),
                   nd->chain().retarget_max_bits()))
    return 0;
  nd->mutable_chain() = std::move(fresh);
  return 1;
}

// Arms the height-scheduled difficulty-retarget rule (Chain::set_retarget;
// interval 0 disables). Returns 1 on success, 0 when blocks beyond genesis
// already exist (the rule is frozen once history does).
int cc_node_set_retarget(void* node, uint32_t interval, uint32_t step,
                         uint32_t max_bits) {
  return static_cast<Node*>(node)->set_retarget(interval, step, max_bits)
             ? 1
             : 0;
}

// The difficulty bits the NEXT block (height+1) must carry under the
// chain's retarget rule — the search backend's target.
uint32_t cc_node_next_bits(void* node) {
  return static_cast<Node*>(node)->next_bits();
}

void cc_node_rollback(void* node, uint64_t new_height) {
  static_cast<Node*>(node)->mutable_chain().rollback_to(new_height);
}

}  // extern "C"
