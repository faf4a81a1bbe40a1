#include "chain.hpp"

#include "sha256.hpp"

namespace chaincore {

namespace {
inline void store_le32(uint8_t* p, uint32_t v) {
  p[0] = uint8_t(v);
  p[1] = uint8_t(v >> 8);
  p[2] = uint8_t(v >> 16);
  p[3] = uint8_t(v >> 24);
}
inline uint32_t load_le32(const uint8_t* p) {
  return uint32_t(p[0]) | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16) |
         (uint32_t(p[3]) << 24);
}
}  // namespace

void BlockHeader::serialize(uint8_t out[kHeaderSize]) const {
  store_le32(out, version);
  std::memcpy(out + 4, prev_hash, 32);
  std::memcpy(out + 36, data_hash, 32);
  store_le32(out + 68, timestamp);
  store_le32(out + 72, bits);
  store_le32(out + 76, nonce);
}

BlockHeader BlockHeader::deserialize(const uint8_t in[kHeaderSize]) {
  BlockHeader h;
  h.version = load_le32(in);
  std::memcpy(h.prev_hash, in + 4, 32);
  std::memcpy(h.data_hash, in + 36, 32);
  h.timestamp = load_le32(in + 68);
  h.bits = load_le32(in + 72);
  h.nonce = load_le32(in + 76);
  return h;
}

void BlockHeader::hash(uint8_t out[32]) const {
  uint8_t buf[kHeaderSize];
  serialize(buf);
  sha256d(buf, kHeaderSize, out);
}

bool BlockHeader::meets_difficulty() const {
  uint8_t h[32];
  hash(h);
  return leading_zero_bits(h) >= int(bits);
}

Block Block::from_header(const BlockHeader& h, uint64_t height) {
  Block b;
  b.header = h;
  b.height = height;
  h.hash(b.hash);
  return b;
}

namespace {
inline std::string hash_key(const uint8_t hash[32]) {
  return std::string(reinterpret_cast<const char*>(hash), 32);
}
}  // namespace

Chain::Chain(uint32_t difficulty_bits) : difficulty_bits_(difficulty_bits) {
  BlockHeader genesis;
  genesis.version = kVersion;
  // prev_hash stays all-zero.
  static const char kGenesisPayload[] = "genesis";
  sha256d(reinterpret_cast<const uint8_t*>(kGenesisPayload),
          sizeof(kGenesisPayload) - 1, genesis.data_hash);
  genesis.timestamp = 0;
  genesis.bits = difficulty_bits;
  genesis.nonce = 0;
  blocks_.push_back(Block::from_header(genesis, 0));
  index_add(blocks_.back());
}

void Chain::index_add(const Block& b) { index_[hash_key(b.hash)] = b.height; }

int64_t Chain::find(const uint8_t hash[32]) const {
  auto it = index_.find(hash_key(hash));
  return it == index_.end() ? -1 : int64_t(it->second);
}

bool Chain::set_retarget(uint32_t interval, uint32_t step,
                         uint32_t max_bits) {
  // Changing the rule once non-genesis blocks exist would retroactively
  // re-judge history under a different schedule; refuse.
  if (height() > 0) return false;
  retarget_interval_ = interval;
  retarget_step_ = step;
  retarget_max_bits_ = max_bits;
  return true;
}

uint32_t Chain::expected_bits(uint64_t height) const {
  if (retarget_interval_ == 0 || height == 0) return difficulty_bits_;
  // 64-bit accumulate: a hostile height can never overflow back under
  // the clamp.
  uint64_t bits = uint64_t(difficulty_bits_) +
                  uint64_t(retarget_step_) * (height / retarget_interval_);
  uint64_t cap = retarget_max_bits_ ? retarget_max_bits_ : 255;
  if (cap < difficulty_bits_) cap = difficulty_bits_;
  if (bits > cap) bits = cap;
  return uint32_t(bits);
}

bool Chain::valid_child(const BlockHeader& header, const Block& parent) const {
  if (header.version != kVersion) return false;
  if (std::memcmp(header.prev_hash, parent.hash, 32) != 0) return false;
  if (header.timestamp != uint32_t(parent.height + 1)) return false;
  // The retarget schedule is enforced HERE, on every adoption path —
  // append, try_adopt, and try_adopt_from all funnel through valid_child,
  // so a synced suffix is judged under the same rule as a local submit.
  if (header.bits != expected_bits(parent.height + 1)) return false;
  return header.meets_difficulty();
}

bool Chain::append(const BlockHeader& header) {
  if (!valid_child(header, tip())) return false;
  blocks_.push_back(Block::from_header(header, height() + 1));
  index_add(blocks_.back());
  return true;
}

bool Chain::try_adopt(const std::vector<BlockHeader>& headers) {
  return try_adopt_from(0, headers);
}

bool Chain::try_adopt_from(uint64_t anchor,
                           const std::vector<BlockHeader>& headers) {
  if (anchor > height()) return false;
  if (anchor + headers.size() <= height()) return false;  // not strictly longer
  // Fork point: the longest prefix of `headers` byte-identical to our own
  // blocks anchor+1..height(). Shared blocks were fully validated when
  // first adopted, so only the divergent suffix needs hashing and
  // validation — adopt cost is O(suffix), not O(height).
  uint8_t ours[kHeaderSize], theirs[kHeaderSize];
  size_t fork = 0;  // number of leading shared headers
  while (anchor + fork + 1 < blocks_.size() && fork < headers.size()) {
    blocks_[anchor + fork + 1].header.serialize(ours);
    headers[fork].serialize(theirs);
    if (std::memcmp(ours, theirs, kHeaderSize) != 0) break;
    ++fork;
  }
  const Block* parent = &blocks_[anchor + fork];
  std::vector<Block> suffix;
  suffix.reserve(headers.size() - fork);
  for (size_t i = fork; i < headers.size(); ++i) {
    if (!valid_child(headers[i], *parent)) return false;  // chain unchanged
    suffix.push_back(Block::from_header(headers[i], parent->height + 1));
    parent = &suffix.back();
  }
  rollback_to(anchor + fork);
  for (const Block& b : suffix) {
    blocks_.push_back(b);
    index_add(blocks_.back());
  }
  return true;
}

void Chain::rollback_to(uint64_t new_height) {
  while (blocks_.size() > new_height + 1) {
    index_.erase(hash_key(blocks_.back().hash));
    blocks_.pop_back();
  }
}

std::vector<uint8_t> Chain::save() const {
  std::vector<uint8_t> out(blocks_.size() * kHeaderSize);
  for (size_t i = 0; i < blocks_.size(); ++i)
    blocks_[i].header.serialize(out.data() + i * kHeaderSize);
  return out;
}

std::vector<uint8_t> Chain::headers_from(uint64_t from_height) const {
  if (from_height >= height()) return {};
  uint64_t n = height() - from_height;
  std::vector<uint8_t> out(n * kHeaderSize);
  for (uint64_t i = 0; i < n; ++i)
    blocks_[from_height + 1 + i].header.serialize(out.data() +
                                                  i * kHeaderSize);
  return out;
}

bool Chain::load(const std::vector<uint8_t>& bytes, uint32_t difficulty_bits,
                 Chain* out, uint32_t retarget_interval,
                 uint32_t retarget_step, uint32_t retarget_max_bits) {
  if (bytes.empty() || bytes.size() % kHeaderSize != 0) return false;
  Chain fresh(difficulty_bits);
  fresh.set_retarget(retarget_interval, retarget_step, retarget_max_bits);
  // Byte 0..79 must be exactly our deterministic genesis.
  uint8_t genesis_buf[kHeaderSize];
  fresh.blocks_[0].header.serialize(genesis_buf);
  if (std::memcmp(bytes.data(), genesis_buf, kHeaderSize) != 0) return false;
  size_t n = bytes.size() / kHeaderSize;
  std::vector<BlockHeader> rest;
  rest.reserve(n - 1);
  for (size_t i = 1; i < n; ++i)
    rest.push_back(BlockHeader::deserialize(bytes.data() + i * kHeaderSize));
  if (!rest.empty() && !fresh.try_adopt(rest)) return false;
  *out = std::move(fresh);
  return true;
}

BlockHeader Node::make_candidate(const uint8_t* data, size_t len) const {
  BlockHeader h;
  h.version = kVersion;
  std::memcpy(h.prev_hash, chain_.tip().hash, 32);
  sha256d(data, len, h.data_hash);
  h.timestamp = uint32_t(chain_.height() + 1);
  h.bits = chain_.expected_bits(chain_.height() + 1);
  h.nonce = 0;
  return h;
}

bool Node::submit(const BlockHeader& header) { return chain_.append(header); }

RecvResult Node::on_block_received(const BlockHeader& header) {
  uint8_t h[32];
  header.hash(h);
  // O(1) duplicate check via the chain's hash index (was an O(height)
  // scan — O(height^2) over a long simulation).
  if (chain_.find(h) >= 0) return RecvResult::kDuplicate;
  if (std::memcmp(header.prev_hash, chain_.tip().hash, 32) == 0) {
    return chain_.append(header) ? RecvResult::kAppended : RecvResult::kInvalid;
  }
  // Does not extend our tip and is not a block we have: the caller must
  // fetch the sender's chain for longest-chain resolution (SURVEY.md §3.3).
  return RecvResult::kStaleOrFork;
}

RecvResult Node::adopt_chain(const std::vector<BlockHeader>& headers) {
  if (headers.size() <= chain_.height()) return RecvResult::kIgnoredShorter;
  return chain_.try_adopt(headers) ? RecvResult::kReorged
                                   : RecvResult::kInvalid;
}

RecvResult Node::adopt_suffix(uint64_t anchor,
                              const std::vector<BlockHeader>& headers) {
  if (anchor > chain_.height()) return RecvResult::kInvalid;
  if (anchor + headers.size() <= chain_.height())
    return RecvResult::kIgnoredShorter;
  return chain_.try_adopt_from(anchor, headers) ? RecvResult::kReorged
                                                : RecvResult::kInvalid;
}

}  // namespace chaincore
