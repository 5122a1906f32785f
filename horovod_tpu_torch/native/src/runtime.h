// The native runtime: background thread, tensor queue, fusion buffer,
// execution of negotiated collectives, async handles.
//
// Capability parity with the reference core (operations.cc:353-587
// BackgroundThreadLoop / RunLoopOnce, tensor_queue.h:28-66 TensorQueue with
// duplicate-name rejection, fusion_buffer_manager.h FusionBufferManager,
// global_state.h HorovodGlobalState): framework threads enqueue named
// tensors; the background thread announces them to the controller each
// cycle, packs ready fused sets into the fusion buffer, runs the TCP ring
// data plane, and resolves handles.
#pragma once

#include <atomic>
#include <condition_variable>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include "cache.h"
#include "collectives.h"
#include "common.h"
#include "controller.h"
#include "net.h"
#include "timeline.h"
#include "wire.h"

namespace hvdtpu {

// Device-executor callback (registered from Python via ctypes): executes one
// negotiated, possibly-fused Response whose entries are accelerator-resident
// — the TPU analog of NCCLAllreduce::Execute running on device buffers
// inside the negotiated runtime (reference nccl_operations.cc:126-184).
// Invoked on the background thread in coordinator response order (identical
// on every rank, so SPMD-dispatched device collectives line up).
//
// Two-phase protocol (the analog of the reference's async-error abort,
// nccl_operations.cc:96-109, which this plane cannot replicate because an
// XLA collective in flight cannot be aborted): PREPARE runs every check
// that can fail *before* any SPMD dispatch (executor wiring, spanning JAX
// world, dtype, staged inputs); the runtime then agrees the per-rank
// PREPARE status across all ranks over the wire, and only a unanimous OK
// proceeds to EXECUTE — so a rank that would fail can no longer strand its
// peers inside the device collective.  ABORT drops state staged by a
// PREPARE whose agreement failed.  A second agreement after EXECUTE turns
// any late failure into an ERROR on every rank.
// Returns 0 on success; nonzero with a message written into err.
enum DeviceExecPhase {
  kDevicePrepare = 0,
  kDeviceExecute = 1,
  kDeviceAbort = 2,
};
typedef int (*DeviceExecutorFn)(int phase, int request_type, int n,
                                const char** names, const int64_t* sizes,
                                int dtype, int op, int root_rank,
                                double prescale, double postscale, char* err,
                                int err_cap);

struct HandleState {
  std::atomic<bool> done{false};
  Status status;
  std::shared_ptr<TensorEntry> entry;  // keeps var_output alive
};

class Runtime {
 public:
  static Runtime& Get();

  Status Init(int rank, int size, const std::string& coord_addr,
              int64_t fusion_threshold, double cycle_time_ms,
              double stall_warning_s, double stall_shutdown_s,
              const std::string& timeline_file,
              size_t cache_capacity = 1024);
  void Shutdown();
  bool initialized() const { return initialized_; }
  int rank() const { return net_ ? net_->rank() : 0; }
  int size() const { return net_ ? net_->size() : 1; }

  // Returns handle id, or -1 with *status set (e.g. duplicate name).
  int64_t Enqueue(std::shared_ptr<TensorEntry> entry, Status* status);
  bool Poll(int64_t handle);
  Status Wait(int64_t handle);  // blocks; does NOT release
  void InterruptWaits(const std::string& reason);  // port: elastic wake-up
  std::shared_ptr<TensorEntry> GetEntry(int64_t handle);
  void Release(int64_t handle);

  int JoinBlocking();
  Status BarrierBlocking();
  // Autotune hooks: runtime-adjustable knobs + data-plane byte counters.
  void SetParams(int64_t fusion_threshold, double cycle_time_ms);
  void ReadCounters(int64_t* bytes, double* seconds);
  // Node topology for hierarchical collectives (ranks grouped into nodes
  // of local_size consecutive ranks; ICI-intra / DCN-inter analog).
  void SetTopology(int local_size, bool hierarchical_allreduce,
                   bool hierarchical_allgather);
  // Eager wire compression (quantized collective engine): forwarded to
  // the coordinator, which stamps it into every round's ResponseList;
  // WireCompression() returns the stream-adopted value — NEVER the
  // locally-set one — so a rank 0 flip cannot race peers mid-round.
  void SetWireCompression(int code);
  int WireCompression() const { return coord_wire_compression_.load(); }
  // Categorical autotune toggles (reference parameter_manager.h:91-93):
  // forwarded to the coordinator, which stamps each Response's algorithm
  // choice and distributes the cache toggle — execution consults the
  // RESPONSE, never local state, so mid-run flips stay rank-consistent.
  void SetTunedToggles(bool hierarchical_allreduce,
                       bool hierarchical_allgather, bool cache_enabled);
  // Per-payload schedule dispatch table (topology probe / tuner
  // refinement): forwarded to the coordinator, which stamps each
  // response's schedule from its FINAL fused payload size.  Coordinator-
  // only effect, like SetWireCompression.
  void SetScheduleTable(int kind, std::vector<ScheduleSegment> segs);
  void SetCacheOn(bool cache_enabled);
  void SetDeviceExecutor(DeviceExecutorFn fn) { device_executor_ = fn; }
  void StartTimeline(const std::string& filename);
  void StopTimeline();
  // Stall-inspector snapshot (controller::StalledJson); "[]" when not
  // initialized or not the coordinator.
  std::string StalledJson();
  // Test/observability hook: names in the most recent (possibly fused)
  // allreduce Response this rank executed — shows the live fusion
  // threshold's effect (autotune integration evidence).
  int64_t LastFusedNames() const { return last_fused_names_.load(); }
  int64_t CacheHits() const { return cache_hits_.load(); }  // port: response-cache hit counter

 private:
  Runtime() = default;
  void BackgroundLoop();
  void ExecuteResponse(const Response& resp);
  void ExecuteAllreduce(const Response& resp,
                        std::vector<std::shared_ptr<TensorEntry>>& entries);
  void ExecuteAllgather(const Response& resp,
                        std::shared_ptr<TensorEntry> entry);
  void ExecuteBroadcast(const Response& resp,
                        std::shared_ptr<TensorEntry> entry);
  void ExecuteAlltoall(const Response& resp,
                       std::shared_ptr<TensorEntry> entry);
  void ExecuteDeviceCollective(
      const Response& resp,
      std::vector<std::shared_ptr<TensorEntry>>& entries);
  std::shared_ptr<TensorEntry> TakeSubmitted(const std::string& name);
  void Finish(std::shared_ptr<TensorEntry>& e, const Status& s);

  std::atomic<bool> initialized_{false};
  std::atomic<bool> stop_{false};
  // Graceful teardown: Shutdown() requests, the loop announces it on the
  // wire each round, and only global consensus (responses.shutdown)
  // breaks the loop — so the coordinator keeps serving rounds until
  // every rank is ready to leave (a hard stop would sever stragglers
  // mid-negotiation).
  std::atomic<bool> shutdown_requested_{false};
  std::atomic<bool> loop_exited_{false};
  std::atomic<bool> loop_dead_{false};
  std::unique_ptr<Network> net_;
  std::unique_ptr<Controller> controller_;
  std::thread background_;
  std::atomic<double> cycle_time_ms_{1.0};

  std::mutex mu_;
  std::condition_variable enqueue_cv_;
  // Pending = enqueued, not yet announced. Submitted = announced, awaiting
  // response. Both keyed by name; duplicate names across the union rejected.
  std::map<std::string, std::shared_ptr<TensorEntry>> pending_;
  std::vector<std::string> pending_order_;
  std::map<std::string, std::shared_ptr<TensorEntry>> submitted_;

  std::mutex handle_mu_;
  std::condition_variable handle_cv_;
  std::atomic<bool> interrupted_{false};  // port: elastic wake-up
  std::string interrupt_reason_;  // port: elastic wake-up
  int64_t next_handle_ = 0;
  std::map<int64_t, std::shared_ptr<HandleState>> handles_;
  std::map<std::string, int64_t> name_to_handle_;

  // Join/barrier signaling.
  std::mutex sync_mu_;
  std::condition_variable sync_cv_;
  std::atomic<bool> join_requested_{false};
  std::atomic<bool> barrier_requested_{false};
  int last_joined_rank_ = -2;  // -2 = no join completed yet
  bool barrier_released_ = false;

  std::vector<uint8_t> fusion_buffer_;
  // Worker-side response cache mirror (bit table mirrors the coordinator's
  // assignments received in responses).
  ResponseCache worker_cache_{1024};
  int64_t fusion_threshold_ = 64 * 1024 * 1024;
  std::atomic<int64_t> bytes_processed_{0};
  int local_size_ = 1;
  // The hierarchical toggles live in the Controller (stamped onto each
  // Response); execution consults resp.hierarchical ONLY — no local
  // mirror exists to drift out of sync.
  bool tuned_cache_on_ = true;
  // Coordinator's distributed cache toggle (ResponseList::cache_on),
  // adopted each round: gates this worker's bit announcements.
  std::atomic<bool> coord_cache_on_{true};
  // Coordinator's wire-compression stamp, adopted each round before the
  // round's responses execute (ResponseList::wire_compression).
  std::atomic<int> coord_wire_compression_{0};
  std::atomic<DeviceExecutorFn> device_executor_{nullptr};
  std::atomic<int64_t> last_fused_names_{0};
  std::atomic<int64_t> cache_hits_{0};  // port: response-cache hit counter
  std::chrono::steady_clock::time_point counter_start_;
  Timeline timeline_;
  Status loop_error_;

  // Device-response stall watchdog: the negotiation-plane stall inspector
  // (controller.cc) cannot see a device Response stuck inside the
  // executor (e.g. one rank's jit blocked on a dead peer's collective),
  // because the background thread itself is the one blocked.  A separate
  // thread watches the in-flight marker and warns after stall_warning_s
  // (reference: the stall inspector watches the full op lifetime).
  void DeviceWatchdog();
  std::thread watchdog_;
  std::atomic<bool> watchdog_stop_{false};
  std::atomic<int64_t> device_exec_start_ms_{0};  // 0 = none in flight
  std::atomic<bool> device_exec_warned_{false};
  std::mutex watch_mu_;
  std::condition_variable watch_cv_;
  std::string device_exec_name_;  // guarded by watch_mu_
  double stall_warning_s_ = 60.0;
};

}  // namespace hvdtpu
