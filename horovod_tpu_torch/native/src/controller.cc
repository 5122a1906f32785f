#include "controller.h"

#include <cstdio>
#include <sstream>

namespace hvdtpu {

namespace {

std::string ShapeStr(const std::vector<int64_t>& s) {
  std::ostringstream os;
  os << "[";
  for (size_t i = 0; i < s.size(); ++i) os << (i ? "," : "") << s[i];
  os << "]";
  return os.str();
}

// Cross-rank consistency validation (reference controller.cc:482-706).
std::string Validate(const std::map<int32_t, Request>& by_rank) {
  const Request* first = nullptr;
  int32_t first_rank = 0;
  for (const auto& [rank, q] : by_rank) {
    if (!first) {
      first = &q;
      first_rank = rank;
      continue;
    }
    std::ostringstream err;
    if (q.type != first->type) {
      err << "mismatched collective type between rank " << first_rank
          << " and rank " << rank;
      return err.str();
    }
    if (q.dtype != first->dtype) {
      err << "mismatched dtype between rank " << first_rank << " and rank "
          << rank;
      return err.str();
    }
    if (q.op != first->op) {
      err << "mismatched reduce op between rank " << first_rank
          << " and rank " << rank;
      return err.str();
    }
    if (q.prescale != first->prescale || q.postscale != first->postscale) {
      err << "mismatched prescale/postscale factors";
      return err.str();
    }
    if (q.device != first->device) {
      // Reference validates device placement consistency the same way
      // (controller.cc:482-706): a collective must be all-HBM or all-host.
      err << "mismatched device placement: rank " << first_rank << " is "
          << (first->device ? "device" : "host") << ", rank " << rank
          << " is " << (q.device ? "device" : "host");
      return err.str();
    }
    if (q.type == RequestType::ALLREDUCE ||
        q.type == RequestType::BROADCAST) {
      if (q.shape != first->shape) {
        err << "mismatched shape: rank " << first_rank << " has "
            << ShapeStr(first->shape) << ", rank " << rank << " has "
            << ShapeStr(q.shape);
        return err.str();
      }
    }
    if (q.type == RequestType::ALLGATHER && !q.shape.empty() &&
        !first->shape.empty()) {
      // All dims but the first must match (controller.cc:576-648).
      if (std::vector<int64_t>(q.shape.begin() + 1, q.shape.end()) !=
          std::vector<int64_t>(first->shape.begin() + 1,
                               first->shape.end())) {
        err << "mismatched allgather trailing dims";
        return err.str();
      }
    }
    if (q.type == RequestType::BROADCAST && q.root_rank != first->root_rank) {
      err << "mismatched broadcast root";
      return err.str();
    }
  }
  return "";
}

int64_t NumElements(const std::vector<int64_t>& shape) {
  int64_t n = 1;
  for (auto d : shape) n *= d;
  return n;
}

}  // namespace

Status Controller::Exchange(const RequestList& mine, ResponseList* out) {
  Writer w;
  SerializeRequestList(mine, w);
  // Control-profile channel transfers: resilient to connection resets
  // (reconnect-and-resume through the persistent listeners) but with the
  // raw protocol's open-ended patience — a worker blocked in a long
  // device collective between rounds is not a network fault.
  if (net_->rank() == 0) {
    std::vector<RequestList> lists(net_->size());
    lists[0] = mine;
    for (int r = 1; r < net_->size(); ++r) {
      std::vector<uint8_t> frame;
      Status st = net_->chan(r)->RecvMsg(frame);
      if (!st.ok()) return st;
      Reader rd(frame.data(), frame.size());
      lists[r] = DeserializeRequestList(rd);
    }
    ResponseList rl = Coordinate(lists);
    Writer rw;
    SerializeResponseList(rl, rw);
    for (int r = 1; r < net_->size(); ++r) {
      Status st = net_->chan(r)->SendMsg(rw.buf);
      if (!st.ok()) return st;
    }
    *out = rl;
  } else {
    Status st = net_->coordinator_chan()->SendMsg(w.buf);
    if (!st.ok()) return st;
    std::vector<uint8_t> frame;
    st = net_->coordinator_chan()->RecvMsg(frame);
    if (!st.ok()) return st;
    Reader rd(frame.data(), frame.size());
    *out = DeserializeResponseList(rd);
  }
  return Status::OK();
}

void Controller::AbsorbCacheHits(const std::vector<RequestList>& lists,
                                 ResponseList& rl) {
  // Translate each rank's cache-hit bits into table_ entries using the
  // coordinator's cached per-rank metadata (reference fast path,
  // controller.cc:181-237).  Bits hit by *every* non-joined rank are
  // reported back as valid_cache_bits for the deterministic LRU touch.
  const int size = net_->size();
  std::map<uint32_t, int> hit_counts;
  for (int r = 0; r < size; ++r) {
    const auto& bits = lists[r].cache_hits;
    for (size_t word = 0; word < bits.size(); ++word) {
      uint64_t w = bits[word];
      while (w) {
        uint32_t bit = word * 64 + __builtin_ctzll(w);
        w &= w - 1;
        if (!cache_.has_bit(bit)) {
          rl.resend_bits.push_back(bit);  // tell the rank to renegotiate
          continue;
        }
        const CachedTensor& ct = cache_.Get(bit);
        const std::string& name = ct.meta.name;
        auto it = table_.find(name);
        if (it == table_.end()) {
          PendingTensor pt;
          pt.first = ct.meta;
          pt.first_report = std::chrono::steady_clock::now();
          table_.emplace(name, std::move(pt));
          arrival_order_.push_back(name);
          it = table_.find(name);
        }
        auto rm = ct.by_rank.find(r);
        if (!it->second.by_rank.count(r)) RecordReady(name, r);
        it->second.by_rank[r] = rm != ct.by_rank.end() ? rm->second
                                                       : ct.meta;
        hit_counts[bit]++;
      }
    }
  }
  int needed = 0;
  for (int r = 0; r < size; ++r)
    if (!joined_.count(r)) needed++;
  for (const auto& [bit, count] : hit_counts)
    if (count >= needed && needed > 0)
      rl.valid_cache_bits.push_back(bit);
  cache_.Touch(rl.valid_cache_bits);
}

ResponseList Controller::Coordinate(std::vector<RequestList>& lists) {
  // One lock for the whole round: table_/arrival_order_/joined_ mutate
  // throughout, and StalledJson() (watchdog thread) must never observe a
  // half-built round.  Rounds are short (validation + response building,
  // no network I/O happens under Coordinate), so the watchdog's read
  // waits at most one round.
  std::lock_guard<std::mutex> table_lk(table_mu_);
  const int size = net_->size();
  ResponseList rl;
  const bool cache_on = cache_on_.load();
  rl.cache_on = cache_on;
  rl.wire_compression = wire_compression_.load();

  // Absorb flags + requests.
  for (int r = 0; r < size; ++r) {
    if (lists[r].join) joined_.insert(r);
    if (lists[r].barrier) barriered_.insert(r);
    if (lists[r].shutdown) shutdown_.insert(r);
    for (auto& q : lists[r].requests) {
      auto it = table_.find(q.name);
      if (it == table_.end()) {
        PendingTensor pt;
        pt.first = q;
        pt.first_report = std::chrono::steady_clock::now();
        pt.by_rank[r] = q;
        table_.emplace(q.name, std::move(pt));
        arrival_order_.push_back(q.name);
        RecordReady(q.name, r);
      } else {
        if (!it->second.by_rank.count(r)) RecordReady(q.name, r);
        it->second.by_rank[r] = q;
      }
      // Note: a full request for a cached name does NOT invalidate the
      // coordinator entry — other ranks may still be announcing via its
      // bit this very round; the entry is refreshed when the tensor's
      // response is rebuilt below.
    }
  }
  if (cache_.enabled()) AbsorbCacheHits(lists, rl);

  // Find ready tensors (reported by every non-joined rank), preserving
  // arrival order for deterministic fusion across iterations.
  std::vector<std::string> ready;
  for (const auto& name : arrival_order_) {
    auto it = table_.find(name);
    if (it == table_.end()) continue;
    size_t needed = 0;
    for (int r = 0; r < size; ++r)
      if (!joined_.count(r)) needed++;
    size_t have = 0;
    for (const auto& [r, q] : it->second.by_rank)
      if (!joined_.count(r)) have++;
    if (have >= needed && needed > 0) ready.push_back(name);
  }

  // Build responses: validate, then fuse compatible allreduces under the
  // threshold (FuseResponses, controller.cc:777-914).
  Response* open_fusion = nullptr;
  int64_t open_bytes = 0;
  for (const auto& name : ready) {
    PendingTensor& pt = table_[name];
    std::string err = Validate(pt.by_rank);
    const Request& q = pt.first;
    // Cache slot for this tensor: reuse its bit or assign a fresh one;
    // refresh the per-rank metadata (reference ResponseCache put path).
    uint32_t cache_bit = UINT32_MAX;
    // cache_on gates NEW bit assignment only: bits already announced
    // this round were honored by AbsorbCacheHits above, so a flip never
    // strands an in-flight announcement (it drains via resend_bits).
    if (err.empty() && cache_.enabled() && cache_on) {
      int32_t b = cache_.BitForName(name);
      cache_bit = b >= 0 ? static_cast<uint32_t>(b) : cache_.Assign(name);
      cache_.InsertAt(cache_bit, name, q);
      cache_.GetMutable(cache_bit).by_rank = pt.by_rank;
    }
    if (!err.empty()) {
      Response resp;
      resp.type = q.type;
      resp.names = {name};
      resp.error = err;
      rl.responses.push_back(resp);
      cache_.Invalidate(name);
      open_fusion = nullptr;
    } else if (q.type == RequestType::ALLREDUCE) {
      int64_t bytes = NumElements(q.shape) * DataTypeSize(q.dtype);
      bool fusible =
          open_fusion != nullptr && open_fusion->dtype == q.dtype &&
          open_fusion->op == q.op && open_fusion->prescale == q.prescale &&
          open_fusion->postscale == q.postscale &&
          open_fusion->device == q.device &&
          open_bytes + bytes <= effective_fusion_threshold();
      if (fusible) {
        open_fusion->names.push_back(name);
        open_fusion->sizes.push_back(NumElements(q.shape));
        open_fusion->cache_bits.push_back(cache_bit);
        open_bytes += bytes;
      } else {
        Response resp;
        resp.type = q.type;
        resp.names = {name};
        resp.dtype = q.dtype;
        resp.op = q.op;
        resp.prescale = q.prescale;
        resp.postscale = q.postscale;
        resp.device = q.device;
        resp.sizes = {NumElements(q.shape)};
        resp.cache_bits = {cache_bit};
        rl.responses.push_back(resp);
        open_fusion = &rl.responses.back();
        open_bytes = bytes;
      }
    } else if (q.type == RequestType::ALLGATHER) {
      Response resp;
      resp.type = q.type;
      resp.names = {name};
      resp.dtype = q.dtype;
      // sizes = first dims per rank (0 for joined ranks), then row_elems
      // (product of trailing dims) as the final element so joined ranks can
      // size their ring blocks.
      for (int r = 0; r < size; ++r) {
        auto itq = pt.by_rank.find(r);
        resp.sizes.push_back(
            itq == pt.by_rank.end() || itq->second.shape.empty()
                ? 0 : itq->second.shape[0]);
      }
      int64_t row_elems = 1;
      for (size_t d = 1; d < q.shape.size(); ++d) row_elems *= q.shape[d];
      resp.sizes.push_back(row_elems);
      resp.device = q.device;
      resp.cache_bits = {cache_bit};
      rl.responses.push_back(resp);
      open_fusion = nullptr;
    } else if (q.type == RequestType::BROADCAST) {
      Response resp;
      resp.type = q.type;
      resp.names = {name};
      resp.dtype = q.dtype;
      resp.root_rank = q.root_rank;
      resp.device = q.device;
      resp.sizes = {NumElements(q.shape)};
      resp.cache_bits = {cache_bit};
      rl.responses.push_back(resp);
      open_fusion = nullptr;
    } else if (q.type == RequestType::ALLTOALL) {
      Response resp;
      resp.type = q.type;
      resp.names = {name};
      resp.dtype = q.dtype;
      // sizes = row-split matrix, row-major [src * size + dst], then
      // row_elems appended; joined ranks contribute zero rows.
      resp.sizes.assign(static_cast<size_t>(size) * size, 0);
      for (int r = 0; r < size; ++r) {
        auto itq = pt.by_rank.find(r);
        if (itq == pt.by_rank.end()) continue;
        for (int d = 0; d < size && d < (int)itq->second.splits.size(); ++d)
          resp.sizes[static_cast<size_t>(r) * size + d] =
              itq->second.splits[d];
      }
      int64_t a2a_row_elems = 1;
      for (size_t d = 1; d < q.shape.size(); ++d) a2a_row_elems *= q.shape[d];
      resp.sizes.push_back(a2a_row_elems);
      resp.device = q.device;
      resp.cache_bits = {cache_bit};
      rl.responses.push_back(resp);
      open_fusion = nullptr;
    }
    table_.erase(name);
  }
  if (!ready.empty()) {
    // Compact arrival order.
    std::vector<std::string> rest;
    for (const auto& n : arrival_order_)
      if (table_.count(n)) rest.push_back(n);
    arrival_order_ = std::move(rest);
  }

  // Join: when every rank has joined, release and report the last rank.
  if (!joined_.empty() && static_cast<int>(joined_.size()) == size) {
    rl.last_joined_rank = *joined_.rbegin();
    joined_.clear();
  }
  // Barrier: release when all ranks are waiting.
  if (static_cast<int>(barriered_.size()) == size) {
    rl.barrier_release = true;
    barriered_.clear();
  }
  // Shutdown once every rank asked for it.
  if (static_cast<int>(shutdown_.size()) == size) rl.shutdown = true;

  StampSchedules(rl);
  CheckStalls(rl);
  return rl;
}

void Controller::SetScheduleTable(int kind,
                                  std::vector<ScheduleSegment> segs) {
  if (kind < 0 || kind >= kNumScheduleKinds || segs.empty()) return;
  // Reject malformed tables (unsorted, or not covering the full payload
  // range) instead of stamping from them: a bad install must not make
  // the dispatch undefined for some payload size.
  for (size_t i = 1; i < segs.size(); ++i)
    if (segs[i].max_bytes <= segs[i - 1].max_bytes) return;
  if (segs.back().max_bytes != INT64_MAX) return;
  std::lock_guard<std::mutex> lk(sched_mu_);
  sched_[kind] = std::move(segs);
}

void Controller::StampSchedules(ResponseList& rl) {
  // Per-payload dispatch: stamp each response's schedule choice once
  // its FINAL (post-fusion) payload is known.  The stamp — not any
  // rank-local state — is what execution consults, so a mid-run table
  // swap can never split the fleet across schedules for one Response.
  std::lock_guard<std::mutex> lk(sched_mu_);
  auto choose = [this](int kind, int64_t bytes) {
    for (const auto& seg : sched_[kind])
      if (bytes <= seg.max_bytes) return seg.hierarchical;
    return false;  // unreachable: last segment is INT64_MAX
  };
  for (auto& resp : rl.responses) {
    if (!resp.error.empty()) continue;
    const int64_t elem = DataTypeSize(resp.dtype);
    if (resp.type == RequestType::ALLREDUCE) {
      int64_t elems = 0;
      for (auto n : resp.sizes) elems += n;
      resp.hierarchical = choose(kScheduleAllreduce, elems * elem);
    } else if (resp.type == RequestType::ALLGATHER) {
      // sizes = per-rank first dims + trailing row_elems: the wire
      // payload is the FULL gathered result every rank ends up holding.
      int64_t dims = 0;
      for (size_t i = 0; i + 1 < resp.sizes.size(); ++i)
        dims += resp.sizes[i];
      resp.hierarchical =
          choose(kScheduleAllgather, dims * resp.sizes.back() * elem);
    }
  }
}

void Controller::RecordReady(const std::string& name, int32_t rank) {
  // Per-rank NEGOTIATE ready instant — the reference timeline's #1
  // debugging feature: which rank is late for which tensor
  // (timeline.cc:496-541).  pid = the reporting rank, so each rank's
  // readiness renders on its own process row.
  if (timeline_ && timeline_->active())
    timeline_->Record(name, "i", "NEGOTIATE_READY",
                      "{\"rank\":" + std::to_string(rank) + "}", rank);
}

std::vector<int32_t> Controller::MissingRanks(const PendingTensor& pt) const {
  std::vector<int32_t> missing;
  for (int r = 0; r < net_->size(); ++r)
    if (!pt.by_rank.count(r) && !joined_.count(r)) missing.push_back(r);
  return missing;
}

namespace {
std::string RankListStr(const std::vector<int32_t>& ranks) {
  std::string s = "[";
  for (size_t i = 0; i < ranks.size(); ++i)
    s += (i ? "," : "") + std::to_string(ranks[i]);
  return s + "]";
}

std::string JsonEscape(const std::string& in) {
  std::string out;
  for (char c : in) {
    if (c == '"' || c == '\\') out += '\\';
    if (static_cast<unsigned char>(c) < 0x20) { out += ' '; continue; }
    out += c;
  }
  return out;
}
}  // namespace

std::string Controller::StalledJson() {
  std::lock_guard<std::mutex> lk(table_mu_);
  auto now = std::chrono::steady_clock::now();
  std::ostringstream os;
  os << "[";
  bool first = true;
  for (const auto& [name, pt] : table_) {
    double age = std::chrono::duration<double>(now - pt.first_report).count();
    if (age <= cfg_.stall_warning_s) continue;
    std::vector<int32_t> submitted;
    for (const auto& [r, q] : pt.by_rank) submitted.push_back(r);
    os << (first ? "" : ",") << "{\"name\":\"" << JsonEscape(name)
       << "\",\"type\":" << static_cast<int>(pt.first.type)
       << ",\"age_s\":" << age
       << ",\"missing\":" << RankListStr(MissingRanks(pt))
       << ",\"submitted\":" << RankListStr(submitted) << "}";
    first = false;
  }
  os << "]";
  return os.str();
}

std::string Controller::StalledJsonPlain() {  // port: stall snapshot without iostreams
  std::lock_guard<std::mutex> lk(table_mu_);  // port: stall snapshot without iostreams
  auto now = std::chrono::steady_clock::now();  // port: stall snapshot without iostreams
  std::string out = "[";  // port: stall snapshot without iostreams
  for (const auto& [name, pt] : table_) {  // port: stall snapshot without iostreams
    double age = std::chrono::duration<double>(now - pt.first_report).count();  // port: stall snapshot without iostreams
    if (age <= cfg_.stall_warning_s) continue;  // port: stall snapshot without iostreams
    std::vector<int32_t> submitted;  // port: stall snapshot without iostreams
    for (const auto& [r, q] : pt.by_rank) submitted.push_back(r);  // port: stall snapshot without iostreams
    char age_s[32];  // port: stall snapshot without iostreams
    snprintf(age_s, sizeof(age_s), "%g", age);  // port: stall snapshot without iostreams
    if (out.size() > 1) out += ",";  // port: stall snapshot without iostreams
    out += "{\"name\":\"" + JsonEscape(name) + "\",\"type\":" +  // port: stall snapshot without iostreams
           std::to_string(static_cast<int>(pt.first.type)) +  // port: stall snapshot without iostreams
           ",\"age_s\":" + age_s + ",\"missing\":" +  // port: stall snapshot without iostreams
           RankListStr(MissingRanks(pt)) + ",\"submitted\":" +  // port: stall snapshot without iostreams
           RankListStr(submitted) + "}";  // port: stall snapshot without iostreams
  }  // port: stall snapshot without iostreams
  return out + "]";  // port: stall snapshot without iostreams
}  // port: stall snapshot without iostreams
void Controller::CheckStalls(ResponseList& rl) {
  auto now = std::chrono::steady_clock::now();
  for (auto& [name, pt] : table_) {
    double age = std::chrono::duration<double>(now - pt.first_report).count();
    if (cfg_.stall_shutdown_s > 0 && age > cfg_.stall_shutdown_s) {
      Response resp;
      resp.type = pt.first.type;
      resp.names = {name};
      // The error every blocked rank sees must name the culprits, not
      // just the tensor — rank lists are the actionable half of a stall
      // post-mortem (which host to inspect / evict).
      resp.error = "stalled for " + std::to_string((int)age) +
                   "s; missing rank(s) " + RankListStr(MissingRanks(pt)) +
                   " never submitted within the shutdown window";
      rl.responses.push_back(resp);
      continue;
    }
    if (!pt.stall_warned && age > cfg_.stall_warning_s) {
      pt.stall_warned = true;
      fprintf(stderr,
              "[hvd_tpu coordinator] WARNING: tensor %s submitted by some "
              "ranks but rank(s) %s have not yet (%.0fs); possible stall\n",
              name.c_str(), RankListStr(MissingRanks(pt)).c_str(), age);
    }
  }
  // Purge entries flagged as errors by the stall shutdown above.
  for (const auto& resp : rl.responses)
    if (!resp.error.empty())
      for (const auto& n : resp.names) table_.erase(n);
}

}  // namespace hvdtpu
