// Coordinator/worker control-plane protocol.
//
// Capability parity with the reference Controller (controller.h:37-223,
// controller.cc:69-449 ComputeResponseList): workers announce ready tensors
// each cycle; rank 0 counts announcements per tensor, validates cross-rank
// consistency (dtype/shape/op/root/scale — controller.cc:482-706), fuses
// ready allreduces under the fusion threshold (FuseResponses,
// controller.cc:777-914), and broadcasts the ResponseList.  Join / barrier /
// shutdown ride the same rounds.  The transport is the synchronous
// gather+bcast of MPIController (mpi_controller.cc:108-199) over TCP.
// A StallInspector (stall_inspector.h:31-100) flags tensors reported by
// some-but-not-all ranks past a warning window.
#pragma once

#include <atomic>
#include <chrono>
#include <cstdint>
#include <map>
#include <memory>
#include <mutex>
#include <set>
#include <string>
#include <vector>

#include "cache.h"
#include "net.h"
#include "timeline.h"
#include "wire.h"

namespace hvdtpu {

struct ControllerConfig {
  int64_t fusion_threshold_bytes = 64 * 1024 * 1024;
  double stall_warning_s = 60.0;
  double stall_shutdown_s = 0.0;  // 0 = never
  size_t cache_capacity = 1024;   // response cache entries (0 = disabled)
};

// One segment of a per-payload schedule dispatch table: payloads up to
// max_bytes (inclusive) use the hierarchical schedule iff hierarchical.
// A table is a sorted (ascending max_bytes) list whose last segment has
// max_bytes == INT64_MAX, so every payload maps to exactly one choice.
struct ScheduleSegment {
  int64_t max_bytes;
  bool hierarchical;
};

// Op kinds with a flat/hierarchical schedule choice (indices into the
// coordinator's table array; broadcast/alltoall have no such choice).
enum ScheduleKind { kScheduleAllreduce = 0, kScheduleAllgather = 1 };
constexpr int kNumScheduleKinds = 2;

class Controller {
 public:
  Controller(Network* net, const ControllerConfig& cfg)
      : net_(net), cfg_(cfg), cache_(cfg.cache_capacity) {}

  // Synchronous round: every rank calls this every cycle. Returns the
  // coordinator's ResponseList.
  Status Exchange(const RequestList& mine, ResponseList* out);

  // Autotune hook (ParameterManager, reference parameter_manager.h:42-246):
  // adjust the coordinator's fusion threshold at runtime.
  void SetFusionThreshold(int64_t bytes) {
    fusion_threshold_.store(bytes);
  }

  // Per-payload schedule dispatch (topology-probed): a piecewise-
  // constant map payload bytes -> {flat, hierarchical} per op kind.
  // The coordinator consults it once each response's FINAL (fused)
  // payload is known and stamps the choice into Response::hierarchical,
  // so mid-run table swaps (probe install, tuner crossover shifts) stay
  // rank-consistent exactly like the wire_compression stamp.  An empty
  // or unsorted segment list is rejected (table unchanged).
  void SetScheduleTable(int kind, std::vector<ScheduleSegment> segs);

  // Response-cache toggle alone (the dispatch plane owns the schedule
  // choice; the cache categorical is still a plain global).
  void SetCacheOn(bool cache_on) { cache_on_.store(cache_on); }

  // Legacy global toggles (reference parameter_manager.h:91-93): now a
  // degenerate single-segment table per kind — the whole payload range
  // maps to one schedule.  Kept as the config/tuner entry point for
  // jobs without a probe-seeded table.
  void SetAlgoToggles(bool hier_allreduce, bool hier_allgather,
                      bool cache_on) {
    SetScheduleTable(kScheduleAllreduce,
                     {{INT64_MAX, hier_allreduce}});
    SetScheduleTable(kScheduleAllgather,
                     {{INT64_MAX, hier_allgather}});
    cache_on_.store(cache_on);
  }

  // Eager wire-compression choice (quantized collective engine): set by
  // rank 0's config/tuner, stamped into every round's ResponseList
  // (ResponseList::wire_compression) so the device-plane executor picks
  // the same staged wire format on every rank mid-flip.
  void SetWireCompression(int code) { wire_compression_.store(code); }

  // Coordinator-side timeline: per-rank NEGOTIATE ready instants are
  // recorded as each rank's report arrives (reference timeline.cc:496-541).
  void set_timeline(Timeline* t) { timeline_ = t; }

  // Stall-inspector snapshot for the flight-recorder escalation path
  // (debug/hang.py): JSON array of tensors past the warning window, each
  // naming the stuck collective, its age and the per-tensor missing /
  // submitted rank lists.  Coordinator-only (other ranks see "[]").
  // Thread-safe against the background loop's Coordinate().
  std::string StalledJson();
  // The same snapshot built without iostreams, which the runtime serves  // port: stall snapshot without iostreams
  // (std::ostream crashed in it on the card's machine; PERF.md).  // port: stall snapshot without iostreams
  std::string StalledJsonPlain();  // port: stall snapshot without iostreams
  int64_t effective_fusion_threshold() const {
    int64_t dyn = fusion_threshold_.load();
    return dyn > 0 ? dyn : cfg_.fusion_threshold_bytes;
  }

 private:
  ResponseList Coordinate(std::vector<RequestList>& lists);
  void AbsorbCacheHits(const std::vector<RequestList>& lists,
                       ResponseList& rl);
  void CheckStalls(ResponseList& rl);
  void StampSchedules(ResponseList& rl);

  struct PendingTensor {
    Request first;                       // first-reported metadata
    std::map<int32_t, Request> by_rank;  // all reports
    std::chrono::steady_clock::time_point first_report;
    bool stall_warned = false;
  };

  void RecordReady(const std::string& name, int32_t rank);

  Network* net_;
  ControllerConfig cfg_;
  Timeline* timeline_ = nullptr;
  std::atomic<int64_t> fusion_threshold_{0};  // 0 -> use cfg_ value
  std::atomic<bool> cache_on_{true};
  std::atomic<int> wire_compression_{0};
  // Per-kind dispatch tables (default: everything flat — the seed
  // repo's pre-probe behavior).  sched_mu_ guards installs from the
  // application/probe thread against the background loop's stamping.
  std::mutex sched_mu_;
  std::vector<ScheduleSegment> sched_[kNumScheduleKinds] = {
      {{INT64_MAX, false}}, {{INT64_MAX, false}}};
  // Missing (non-joined, not-yet-reported) ranks for one pending tensor.
  std::vector<int32_t> MissingRanks(const PendingTensor& pt) const;

  // Coordinator-only state (persists across rounds).  table_mu_ lets
  // StalledJson() — called from an application watchdog thread — read
  // table_/joined_ while the background loop's Coordinate() mutates them.
  std::mutex table_mu_;
  ResponseCache cache_;
  std::map<std::string, PendingTensor> table_;
  std::vector<std::string> arrival_order_;
  std::set<int32_t> joined_;
  std::set<int32_t> barriered_;
  std::set<int32_t> shutdown_;
  int32_t last_join_rank_ = -1;
};

}  // namespace hvdtpu
