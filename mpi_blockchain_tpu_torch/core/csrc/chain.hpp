// Chain core: Block header layout, Chain container, Node state machine.
//
// Rebuild of the reference's Block/Node C++ classes (SURVEY.md §1 layers 2-4,
// 6; BASELINE.json north-star: "Block/Node C++ classes stay as the canonical
// chain state"). The reference mount was empty this round, so the design is
// built to the BASELINE.json capability contract, not traced source.
//
// FROZEN 80-byte header byte layout (both the CPU and the TPU/JAX backends
// depend on this exact serialization — see SURVEY.md §7 "hard parts" #1):
//
//   offset size field       encoding
//   0      4    version     uint32 little-endian
//   4      32   prev_hash   raw digest bytes of the previous block
//   36     32   data_hash   sha256d of the block payload
//   68     4    timestamp   uint32 little-endian (deterministic: == height)
//   72     4    bits        uint32 little-endian (difficulty, leading-0 bits)
//   76     4    nonce       uint32 little-endian
//
// The nonce sits in the second SHA-256 chunk, enabling the midstate
// optimization shared by every backend. Timestamps are deterministic (equal
// to the block height) so that a chain's block hashes are a pure function of
// (genesis, payload data, difficulty) — the executable form of the
// north-star's "identical block hashes" requirement.
#pragma once
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace chaincore {

constexpr size_t kHeaderSize = 80;
constexpr uint32_t kVersion = 1;

struct BlockHeader {
  uint32_t version = kVersion;
  uint8_t prev_hash[32] = {0};
  uint8_t data_hash[32] = {0};
  uint32_t timestamp = 0;
  uint32_t bits = 0;
  uint32_t nonce = 0;

  void serialize(uint8_t out[kHeaderSize]) const;
  static BlockHeader deserialize(const uint8_t in[kHeaderSize]);
  // sha256d of the serialized header — the block hash.
  void hash(uint8_t out[32]) const;
  // Proof-of-work check: leading_zero_bits(hash) >= bits.
  bool meets_difficulty() const;
};

struct Block {
  BlockHeader header;
  uint64_t height = 0;
  uint8_t hash[32] = {0};  // cached sha256d of the header

  static Block from_header(const BlockHeader& h, uint64_t height);
};

// Append-only chain with longest-chain reorg support.
class Chain {
 public:
  // Constructs a chain holding only the fixed genesis block. Genesis is
  // deterministic given `difficulty_bits`: version=1, prev=0^32,
  // data_hash=sha256d("genesis"), timestamp=0, bits=difficulty, nonce=0.
  // Genesis is exempt from the PoW check.
  explicit Chain(uint32_t difficulty_bits);

  uint64_t height() const { return blocks_.size() - 1; }  // genesis = height 0
  const Block& tip() const { return blocks_.back(); }
  const Block& at(uint64_t h) const { return blocks_[h]; }
  uint32_t difficulty_bits() const { return difficulty_bits_; }

  // Height-scheduled difficulty retargeting (ISSUE 6). Timestamps are
  // structural (== height), so the only retarget rule every validator can
  // agree on from header bytes alone is a pure function of height:
  //
  //   expected_bits(h) = min(difficulty_bits + step * (h / interval),
  //                          max_bits)            for h >= 1
  //   expected_bits(0) = difficulty_bits          (genesis, PoW-exempt)
  //
  // interval == 0 disables retargeting (the default; expected_bits is then
  // the constant difficulty_bits — existing chains are byte-unchanged).
  // The schedule is enforced by valid_child, i.e. on EVERY adoption path
  // (append, try_adopt, try_adopt_from), not just on locally mined blocks.
  // Returns false (rule unchanged) if blocks beyond genesis already exist:
  // changing the rule mid-chain would retroactively invalidate history.
  bool set_retarget(uint32_t interval, uint32_t step, uint32_t max_bits);
  uint32_t expected_bits(uint64_t height) const;
  uint32_t retarget_interval() const { return retarget_interval_; }
  uint32_t retarget_step() const { return retarget_step_; }
  uint32_t retarget_max_bits() const { return retarget_max_bits_; }

  // Validates `header` as the next block (linkage, deterministic timestamp,
  // bits, PoW) and appends. Returns false (chain unchanged) if invalid.
  bool append(const BlockHeader& header);

  // Validation of a header as a child of `parent` under this chain's rules.
  bool valid_child(const BlockHeader& header, const Block& parent) const;

  // Longest-chain rule: `headers` is a full replacement chain, heights
  // 1..headers.size(), child of this chain's genesis. Adopts iff it is
  // fully valid and strictly longer than the current chain. Returns true
  // on adoption. Cost is O(suffix): the longest byte-identical prefix
  // shared with the current chain was already validated when first
  // adopted, so only the divergent suffix is hashed and checked.
  bool try_adopt(const std::vector<BlockHeader>& headers);

  // Suffix form of the longest-chain rule (SURVEY.md §3.3 "request chain
  // (suffix) from r"): `headers` are heights anchor+1..anchor+n, children
  // of OUR block at `anchor` (a common ancestor the sync protocol
  // established). Adopts iff fully valid and the result is strictly
  // longer. Makes fork-heal TRANSFER O(suffix), matching the O(suffix)
  // validation try_adopt already has; try_adopt == try_adopt_from(0, ...).
  bool try_adopt_from(uint64_t anchor, const std::vector<BlockHeader>& headers);

  // Drops blocks above `new_height` (reorg rollback primitive).
  void rollback_to(uint64_t new_height);

  // Height of the block with this hash, or -1 if absent. O(1) via the
  // hash index (kills the O(chain) duplicate scan in Node receive).
  int64_t find(const uint8_t hash[32]) const;

  // Serialization: concatenated 80-byte headers (heights 0..tip).
  std::vector<uint8_t> save() const;
  // Concatenated headers for heights from_height+1..tip (the suffix-sync
  // wire format; empty when from_height >= height()). The ONE serve-side
  // implementation both bindings expose.
  std::vector<uint8_t> headers_from(uint64_t from_height) const;
  // Rebuilds a chain from saved bytes; validates everything above genesis.
  // Returns false if the bytes do not form a valid chain. The optional
  // retarget triple re-arms the schedule the saved chain was mined under
  // (0/0/0 = no retargeting), so validation judges it by its own rule.
  static bool load(const std::vector<uint8_t>& bytes, uint32_t difficulty_bits,
                   Chain* out, uint32_t retarget_interval = 0,
                   uint32_t retarget_step = 0, uint32_t retarget_max_bits = 0);

 private:
  void index_add(const Block& b);

  std::vector<Block> blocks_;
  // block hash (32 raw bytes) -> height; kept in sync by every mutation.
  std::unordered_map<std::string, uint64_t> index_;
  uint32_t difficulty_bits_;
  // Retarget schedule (0/0/0 = disabled; see set_retarget above).
  uint32_t retarget_interval_ = 0;
  uint32_t retarget_step_ = 0;
  uint32_t retarget_max_bits_ = 0;
};

// Result of handing a peer's block to a Node (SURVEY.md §3.3).
enum class RecvResult : int {
  kAppended = 0,     // extended our tip; local miner must restart on new tip
  kDuplicate = 1,    // already have it
  kStaleOrFork = 2,  // does not extend our tip: caller should fetch the
                     // sender's full chain and call Node::adopt_chain
  kInvalid = 3,      // failed PoW / bits / timestamp validation
  kReorged = 4,      // (from adopt_chain) we switched to a longer chain
  kIgnoredShorter = 5
};

// One blockchain node: owns a Chain, issues mining candidates, accepts
// winning nonces, and applies the consensus rules to peers' blocks.
// The nonce *search* itself lives behind the miner_backend plugin boundary
// (Python side; BASELINE.json north-star) — the Node never searches.
class Node {
 public:
  Node(uint32_t difficulty_bits, int node_id)
      : chain_(difficulty_bits), id_(node_id) {}

  const Chain& chain() const { return chain_; }
  int id() const { return id_; }
  uint64_t height() const { return chain_.height(); }

  // Arms the chain's height-scheduled retarget rule (see Chain::
  // set_retarget); call before any block beyond genesis exists.
  bool set_retarget(uint32_t interval, uint32_t step, uint32_t max_bits) {
    return chain_.set_retarget(interval, step, max_bits);
  }
  // The bits the NEXT block (height()+1) must carry under the rule —
  // what a search backend must target.
  uint32_t next_bits() const { return chain_.expected_bits(height() + 1); }

  // Builds the candidate header for the next block: prev = tip hash,
  // data_hash = sha256d(data), timestamp = height+1, bits = difficulty,
  // nonce = 0 (to be filled by the search backend).
  BlockHeader make_candidate(const uint8_t* data, size_t len) const;

  // Submits a mined candidate (nonce filled in). Validates and appends.
  bool submit(const BlockHeader& header);

  // Consensus entry point for a block announced by a peer.
  RecvResult on_block_received(const BlockHeader& header);

  // Longest-chain adoption of a peer's full chain (heights 1..n).
  RecvResult adopt_chain(const std::vector<BlockHeader>& headers);

  // Suffix adoption above a common ancestor at `anchor` (the O(suffix)
  // sync protocol's entry point). kReorged on adoption, kIgnoredShorter
  // when not strictly longer, kInvalid otherwise.
  RecvResult adopt_suffix(uint64_t anchor,
                          const std::vector<BlockHeader>& headers);

  Chain& mutable_chain() { return chain_; }

 private:
  Chain chain_;
  int id_;
};

}  // namespace chaincore
