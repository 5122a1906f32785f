// Response cache: skip re-announcing tensors negotiated in earlier
// iterations.
//
// Capability parity with the reference ResponseCache + CacheCoordinator
// (response_cache.h:45-169, controller.cc:181-237 fast path): training
// iterations repeat the same tensor set, so after the first negotiation a
// worker announces a cached tensor as one *bit* in its RequestList instead
// of a full Request (name + shape + params).  The coordinator intersects
// bits across ranks; fully-hit tensors are constructed from cached
// metadata.  Determinism note (the subtle part, reference
// controller.cc:368-378): bit assignment and eviction are decided by the
// coordinator alone and mirrored by workers at response time, so the
// name→bit tables never diverge.
#pragma once

#include <cstdint>
#include <list>
#include <map>
#include <string>
#include <vector>

#include "wire.h"

namespace hvdtpu {

struct CachedTensor {
  Request meta;                       // this rank's meta (worker cache) or
                                      // first-reporter meta (coordinator)
  std::map<int32_t, Request> by_rank; // coordinator only: per-rank metas
};

class ResponseCache {
 public:
  explicit ResponseCache(size_t capacity = 1024) : capacity_(capacity) {}
  size_t capacity() const { return capacity_; }
  bool enabled() const { return capacity_ > 0; }

  // Worker: bit for (name, meta) if cached and meta matches; -1 otherwise.
  int32_t Lookup(const Request& q) const {
    auto it = name_to_bit_.find(q.name);
    if (it == name_to_bit_.end()) return -1;
    const CachedTensor& ct = entries_.at(it->second);
    const Request& m = ct.meta;
    if (m.type != q.type || m.dtype != q.dtype || m.op != q.op ||
        m.root_rank != q.root_rank || m.prescale != q.prescale ||
        m.postscale != q.postscale || m.shape != q.shape ||
        m.splits != q.splits || m.device != q.device)
      return -1;
    return static_cast<int32_t>(it->second);
  }

  bool has_bit(uint32_t bit) const { return entries_.count(bit) != 0; }

  int32_t BitForName(const std::string& name) const {
    auto it = name_to_bit_.find(name);
    return it == name_to_bit_.end() ? -1 : static_cast<int32_t>(it->second);
  }

  std::string NameForBit(uint32_t bit) const {
    auto it = bit_to_name_.find(bit);
    return it == bit_to_name_.end() ? std::string() : it->second;
  }

  const CachedTensor& Get(uint32_t bit) const { return entries_.at(bit); }
  CachedTensor& GetMutable(uint32_t bit) { return entries_[bit]; }

  // Coordinator: choose a bit for a new tensor (existing bit, recycled
  // free bit, or a fresh one).  Eviction happens in InsertAt so the
  // coordinator and every worker run the *identical* eviction sequence —
  // the determinism requirement the reference calls out
  // (controller.cc:368-378).
  uint32_t Assign(const std::string& name) {
    int32_t existing = BitForName(name);
    if (existing >= 0) return static_cast<uint32_t>(existing);
    if (!free_bits_.empty()) {
      uint32_t bit = free_bits_.back();
      free_bits_.pop_back();
      return bit;
    }
    return next_bit_++;
  }

  // Install (or replace) the entry at a coordinator-chosen bit, evicting
  // the LRU entry when at capacity.  Called in response order on every
  // rank, so all caches evolve identically.
  void InsertAt(uint32_t bit, const std::string& name, const Request& meta) {
    if (entries_.count(bit)) {
      EraseBit(bit);
    } else if (entries_.size() >= capacity_ && !lru_.empty()) {
      uint32_t victim = lru_.back();
      EraseBit(victim);
      free_bits_.push_back(victim);
    }
    // A stale entry under the same name at a different bit is superseded.
    auto old = name_to_bit_.find(name);
    if (old != name_to_bit_.end() && old->second != bit) {
      uint32_t stale = old->second;
      EraseBit(stale);
      free_bits_.push_back(stale);
    }
    PlaceBit(bit, name);
    entries_[bit].meta = meta;
  }

  // LRU touch for the bits hit this round (broadcast by the coordinator so
  // every rank applies the identical ordering update).
  void Touch(const std::vector<uint32_t>& bits) {
    for (uint32_t b : bits) {
      auto it = lru_pos_.find(b);
      if (it == lru_pos_.end()) continue;
      lru_.erase(it->second);
      lru_.push_front(b);
      lru_pos_[b] = lru_.begin();
    }
  }

  void Invalidate(const std::string& name) {
    auto it = name_to_bit_.find(name);
    if (it != name_to_bit_.end()) {
      uint32_t bit = it->second;
      EraseBit(bit);
      free_bits_.push_back(bit);
    }
  }

  size_t size() const { return entries_.size(); }

 private:
  void PlaceBit(uint32_t bit, const std::string& name) {
    entries_[bit] = CachedTensor{};
    name_to_bit_[name] = bit;
    bit_to_name_[bit] = name;
    lru_.push_front(bit);
    lru_pos_[bit] = lru_.begin();
  }

  void EraseBit(uint32_t bit) {
    auto nit = bit_to_name_.find(bit);
    if (nit != bit_to_name_.end()) {
      name_to_bit_.erase(nit->second);
      bit_to_name_.erase(nit);
    }
    entries_.erase(bit);
    auto lit = lru_pos_.find(bit);
    if (lit != lru_pos_.end()) {
      lru_.erase(lit->second);
      lru_pos_.erase(lit);
    }
  }

  size_t capacity_;
  uint32_t next_bit_ = 0;
  std::vector<uint32_t> free_bits_;
  std::map<uint32_t, CachedTensor> entries_;
  std::map<std::string, uint32_t> name_to_bit_;
  std::map<uint32_t, std::string> bit_to_name_;
  std::list<uint32_t> lru_;
  std::map<uint32_t, std::list<uint32_t>::iterator> lru_pos_;
};

// Bit-vector helpers (cache_hits is a packed u64 vector on the wire).
inline void SetBit(std::vector<uint64_t>& v, uint32_t bit) {
  size_t word = bit / 64;
  if (v.size() <= word) v.resize(word + 1, 0);
  v[word] |= (1ull << (bit % 64));
}

inline bool TestBit(const std::vector<uint64_t>& v, uint32_t bit) {
  size_t word = bit / 64;
  return word < v.size() && (v[word] & (1ull << (bit % 64)));
}

}  // namespace hvdtpu
