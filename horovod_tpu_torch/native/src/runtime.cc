#include "runtime.h"

#include <algorithm>
#include <chrono>
#include <cstring>

namespace hvdtpu {

Runtime& Runtime::Get() {
  static Runtime* runtime = new Runtime();
  return *runtime;
}

Status Runtime::Init(int rank, int size, const std::string& coord_addr,
                     int64_t fusion_threshold, double cycle_time_ms,
                     double stall_warning_s, double stall_shutdown_s,
                     const std::string& timeline_file,
                     size_t cache_capacity) {
  if (initialized_) return Status::OK();
  interrupted_ = false;  // port: elastic wake-up
  Status st;
  net_ = Network::Connect(rank, size, coord_addr, &st);
  if (!net_) return st;
  worker_cache_ = ResponseCache(cache_capacity);
  ControllerConfig ccfg;
  ccfg.fusion_threshold_bytes = fusion_threshold;
  ccfg.stall_warning_s = stall_warning_s;
  ccfg.stall_shutdown_s = stall_shutdown_s;
  ccfg.cache_capacity = cache_capacity;
  controller_ = std::make_unique<Controller>(net_.get(), ccfg);
  controller_->set_timeline(&timeline_);
  fusion_threshold_ = fusion_threshold;
  cycle_time_ms_ = cycle_time_ms;
  if (!timeline_file.empty() && rank == 0)
    timeline_.Start(timeline_file, rank, size);
  stop_ = false;
  shutdown_requested_ = false;
  loop_exited_ = false;
  loop_dead_ = false;
  loop_error_ = Status::OK();
  counter_start_ = std::chrono::steady_clock::now();
  bytes_processed_ = 0;
  stall_warning_s_ = stall_warning_s;
  watchdog_stop_ = false;
  device_exec_start_ms_ = 0;
  watchdog_ = std::thread([this] { DeviceWatchdog(); });
  background_ = std::thread([this] { BackgroundLoop(); });
  initialized_ = true;
  return Status::OK();
}

void Runtime::Shutdown() {
  if (!initialized_) return;
  // Phase 1: announce shutdown on the wire and wait for the global
  // consensus exit (every rank requested it) — severs no straggler.
  shutdown_requested_ = true;
  enqueue_cv_.notify_all();
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::seconds(30);
  if (interrupted_) deadline = std::chrono::steady_clock::now();  // port: elastic wake-up
  // A failed world's links are not recovered: its peer is dead or hung.  // port: failed-world reset
  if (interrupted_ && net_) net_->Close();  // port: failed-world reset
  while (!loop_exited_ &&
         std::chrono::steady_clock::now() < deadline) {
    std::this_thread::sleep_for(std::chrono::milliseconds(5));
  }
  // Phase 2 (fallback): peers that will never consent (hung or gone)
  // cannot hold this process hostage.
  stop_ = true;
  enqueue_cv_.notify_all();
  if (background_.joinable()) background_.join();
  {
    // Store + notify under the lock: an unlocked store can race the
    // watchdog's predicate evaluation and lose the wakeup (untimed idle
    // wait would then block join forever).
    std::lock_guard<std::mutex> lk(watch_mu_);
    watchdog_stop_ = true;
  }
  watch_cv_.notify_all();
  if (watchdog_.joinable()) watchdog_.join();
  timeline_.Stop();
  // Fail any remaining entries (FinalizeTensorQueue semantics,
  // tensor_queue.cc).
  std::vector<std::shared_ptr<TensorEntry>> leftovers;
  {
    std::lock_guard<std::mutex> lk(mu_);
    for (auto& [n, e] : pending_) leftovers.push_back(e);
    for (auto& [n, e] : submitted_) leftovers.push_back(e);
    pending_.clear();
    pending_order_.clear();
    submitted_.clear();
  }
  for (auto& e : leftovers)
    Finish(e, Status::Aborted("runtime shut down with pending tensors"));
  net_.reset();
  controller_.reset();
  // Reset join/barrier state so an elastic re-init starts clean.
  {
    std::lock_guard<std::mutex> lk(sync_mu_);
    last_joined_rank_ = -2;
    barrier_released_ = false;
  }
  join_requested_ = false;
  barrier_requested_ = false;
  initialized_ = false;
}

int64_t Runtime::Enqueue(std::shared_ptr<TensorEntry> entry, Status* status) {
  if (!initialized_) {
    *status = Status::PreconditionError("runtime not initialized");
    return -1;
  }
  if (loop_dead_) {
    *status = Status::Error("collective runtime failed (" +
                            loop_error_.reason +
                            "); re-initialize to continue");
    return -1;
  }
  std::shared_ptr<HandleState> hs = std::make_shared<HandleState>();
  hs->entry = entry;
  int64_t id;
  {
    std::lock_guard<std::mutex> lk(mu_);
    if (pending_.count(entry->name) || submitted_.count(entry->name)) {
      // DUPLICATE_NAME_ERROR (reference common.h:169-172).
      *status = Status::InvalidArgument(
          "a tensor named " + entry->name +
          " is already in flight; use distinct names for concurrent ops");
      return -1;
    }
    pending_[entry->name] = entry;
    pending_order_.push_back(entry->name);
  }
  {
    std::lock_guard<std::mutex> lk(handle_mu_);
    id = next_handle_++;
    handles_[id] = hs;
    name_to_handle_[entry->name] = id;
  }
  timeline_.Record(entry->name, "B", "NEGOTIATE");
  enqueue_cv_.notify_one();
  *status = Status::OK();
  return id;
}

bool Runtime::Poll(int64_t handle) {
  std::lock_guard<std::mutex> lk(handle_mu_);
  auto it = handles_.find(handle);
  return it == handles_.end() || it->second->done.load();
}

Status Runtime::Wait(int64_t handle) {
  std::unique_lock<std::mutex> lk(handle_mu_);
  auto it = handles_.find(handle);
  if (it == handles_.end()) return Status::InvalidArgument("unknown handle");
  auto hs = it->second;
  handle_cv_.wait(lk, [&] { return hs->done.load() || interrupted_; });  // port: elastic wake-up
  if (!hs->done.load()) return Status::Aborted(interrupt_reason_);  // port: elastic wake-up
  handle_cv_.wait(lk, [&] { return hs->done.load(); });
  return hs->status;
}
// Ends every Wait of this world with Aborted(reason), now and until the  // port: elastic wake-up
// next Init, and lets Shutdown skip its wait for the ranks' consensus:  // port: elastic wake-up
// the world was declared failed, and its ops are left to Shutdown.  // port: elastic wake-up
void Runtime::InterruptWaits(const std::string& reason) {  // port: elastic wake-up
  {  // port: elastic wake-up
    std::lock_guard<std::mutex> lk(handle_mu_);  // port: elastic wake-up
    interrupt_reason_ = reason;  // port: elastic wake-up
    interrupted_ = true;  // port: elastic wake-up
  }  // port: elastic wake-up
  handle_cv_.notify_all();  // port: elastic wake-up
}  // port: elastic wake-up

std::shared_ptr<TensorEntry> Runtime::GetEntry(int64_t handle) {
  std::lock_guard<std::mutex> lk(handle_mu_);
  auto it = handles_.find(handle);
  return it == handles_.end() ? nullptr : it->second->entry;
}

void Runtime::Release(int64_t handle) {
  std::lock_guard<std::mutex> lk(handle_mu_);
  auto it = handles_.find(handle);
  if (it != handles_.end()) {
    if (it->second->entry) name_to_handle_.erase(it->second->entry->name);
    handles_.erase(it);
  }
}

void Runtime::Finish(std::shared_ptr<TensorEntry>& e, const Status& s) {
  if (!e) return;
  timeline_.Record(e->name, "E", "OPERATION");
  int64_t hid = -1;
  std::shared_ptr<HandleState> hs;
  {
    std::lock_guard<std::mutex> lk(handle_mu_);
    auto it = name_to_handle_.find(e->name);
    if (it != name_to_handle_.end()) {
      hid = it->second;
      hs = handles_[hid];
    }
  }
  if (hs) {
    hs->status = s;
    hs->done = true;
    handle_cv_.notify_all();
  }
  if (e->callback) e->callback(s);
}

std::shared_ptr<TensorEntry> Runtime::TakeSubmitted(const std::string& name) {
  std::lock_guard<std::mutex> lk(mu_);
  auto it = submitted_.find(name);
  if (it == submitted_.end()) return nullptr;
  auto e = it->second;
  submitted_.erase(it);
  return e;
}

void Runtime::BackgroundLoop() {
  using clock = std::chrono::steady_clock;
  while (!stop_) {
    auto cycle_start = clock::now();
    // 1. Drain pending into a RequestList.
    RequestList rl;
    {
      std::unique_lock<std::mutex> lk(mu_);
      // Sleep to cycle time, but wake the moment work arrives: a
      // latency-sensitive sequential op should not pay the full cycle
      // (the reference sleeps unconditionally, operations.cc:592-598 —
      // here bursty enqueues still batch into one round because they
      // accumulate while the previous round executes).
      enqueue_cv_.wait_for(
          lk, std::chrono::duration<double, std::milli>(
              cycle_time_ms_.load()),
          [this] {
            return stop_.load() || !pending_order_.empty() ||
                   join_requested_.load() || barrier_requested_.load() ||
                   shutdown_requested_.load();
          });
      for (const auto& name : pending_order_) {
        auto it = pending_.find(name);
        if (it == pending_.end()) continue;
        auto& e = it->second;
        Request q;
        q.type = e->type;
        q.rank = net_->rank();
        q.name = e->name;
        q.dtype = e->dtype;
        q.shape = e->shape;
        q.op = e->op;
        q.root_rank = e->root_rank;
        q.prescale = e->prescale;
        q.postscale = e->postscale;
        q.splits = e->splits;
        q.device = e->device;
        // Response-cache fast path: announce a previously-negotiated
        // tensor as one bit instead of the full request (reference
        // controller.cc:181-237).
        int32_t bit = (worker_cache_.enabled() && coord_cache_on_.load())
                          ? worker_cache_.Lookup(q)
                          : -1;
        if (bit >= 0) {
          SetBit(rl.cache_hits, static_cast<uint32_t>(bit));
          cache_hits_++;  // port: response-cache hit counter
        } else {
          rl.requests.push_back(std::move(q));
        }
        submitted_[name] = e;
      }
      for (const auto& [name, e] : submitted_) pending_.erase(name);
      pending_order_.clear();
    }
    rl.join = join_requested_.load();
    rl.barrier = barrier_requested_.load();
    rl.shutdown = shutdown_requested_.load() || stop_.load();

    // 2. Controller round.
    ResponseList responses;
    Status st = controller_->Exchange(rl, &responses);
    if (!st.ok()) {
      loop_error_ = st;
      loop_dead_ = true;
      // Fail everything in flight — submitted AND still-pending — so no
      // caller blocks on a handle that will never resolve; new enqueues
      // fail fast until re-init (elastic reset path).
      std::vector<std::shared_ptr<TensorEntry>> all;
      {
        std::lock_guard<std::mutex> lk(mu_);
        for (auto& [n, e] : submitted_) all.push_back(e);
        for (auto& [n, e] : pending_) all.push_back(e);
        submitted_.clear();
        pending_.clear();
        pending_order_.clear();
      }
      for (auto& e : all) Finish(e, st);
      // Unblock join()/barrier() waiters too — without clobbering a
      // release that was delivered but not yet consumed.
      {
        std::lock_guard<std::mutex> lk(sync_mu_);
        if (last_joined_rank_ == -2) last_joined_rank_ = -1;
        barrier_released_ = true;
      }
      sync_cv_.notify_all();
      break;
    }
    timeline_.MarkCycle();

    // 3. Self-heal any cache divergence: renegotiate bits the
    // coordinator no longer holds.
    for (uint32_t bit : responses.resend_bits) {
      std::string name = worker_cache_.NameForBit(bit);
      if (name.empty()) continue;
      worker_cache_.Invalidate(name);
      std::lock_guard<std::mutex> lk(mu_);
      auto it = submitted_.find(name);
      if (it != submitted_.end()) {
        pending_[name] = it->second;
        pending_order_.push_back(name);
        submitted_.erase(it);
      }
    }
    // 4. Execute responses in coordinator order (identical on all ranks).
    coord_cache_on_.store(responses.cache_on);
    coord_wire_compression_.store(responses.wire_compression);
    for (const auto& resp : responses.responses) ExecuteResponse(resp);
    worker_cache_.Touch(responses.valid_cache_bits);

    // 4. Join / barrier releases.
    if (responses.last_joined_rank >= 0) {
      std::lock_guard<std::mutex> lk(sync_mu_);
      last_joined_rank_ = responses.last_joined_rank;
      join_requested_ = false;
      sync_cv_.notify_all();
    }
    if (responses.barrier_release) {
      std::lock_guard<std::mutex> lk(sync_mu_);
      barrier_released_ = true;
      barrier_requested_ = false;
      sync_cv_.notify_all();
    }
    if (responses.shutdown) break;
    (void)cycle_start;
  }
  loop_exited_ = true;
}

void Runtime::ExecuteResponse(const Response& resp) {
  if (!resp.error.empty()) {
    for (const auto& name : resp.names) {
      worker_cache_.Invalidate(name);
      auto e = TakeSubmitted(name);
      if (e) Finish(e, Status::Error(resp.error));
    }
    return;
  }
  // Mirror the coordinator's cache-slot assignments using this rank's own
  // metadata for the lookup key.
  if (worker_cache_.enabled()) {
    for (size_t i = 0; i < resp.names.size() && i < resp.cache_bits.size();
         ++i) {
      if (resp.cache_bits[i] == UINT32_MAX) continue;
      std::shared_ptr<TensorEntry> e;
      {
        std::lock_guard<std::mutex> lk(mu_);
        auto it = submitted_.find(resp.names[i]);
        if (it != submitted_.end()) e = it->second;
      }
      if (!e) continue;  // joined rank: no local meta to cache
      Request q;
      q.type = e->type;
      q.rank = net_->rank();
      q.name = e->name;
      q.dtype = e->dtype;
      q.shape = e->shape;
      q.op = e->op;
      q.root_rank = e->root_rank;
      q.prescale = e->prescale;
      q.postscale = e->postscale;
      q.splits = e->splits;
      q.device = e->device;
      worker_cache_.InsertAt(resp.cache_bits[i], resp.names[i], q);
    }
  }
  switch (resp.type) {
    case RequestType::ALLREDUCE: {
      std::vector<std::shared_ptr<TensorEntry>> entries;
      for (const auto& name : resp.names) entries.push_back(
          TakeSubmitted(name));
      ExecuteAllreduce(resp, entries);
      break;
    }
    case RequestType::ALLGATHER:
      ExecuteAllgather(resp, TakeSubmitted(resp.names[0]));
      break;
    case RequestType::BROADCAST:
      ExecuteBroadcast(resp, TakeSubmitted(resp.names[0]));
      break;
    case RequestType::ALLTOALL:
      ExecuteAlltoall(resp, TakeSubmitted(resp.names[0]));
      break;
    default:
      break;
  }
}

void Runtime::ExecuteDeviceCollective(
    const Response& resp,
    std::vector<std::shared_ptr<TensorEntry>>& entries) {
  // Negotiated device-resident execution: the fused payload never touches
  // host memory — the registered executor runs it on HBM via the jitted
  // device plane (reference: NCCLAllreduce on device fusion buffers,
  // nccl_operations.cc:126-184).  Invoked in coordinator response order,
  // identical across ranks, so the executor's SPMD collectives line up
  // even when per-rank enqueue order diverged.
  //
  // Failure protocol (reference: NCCL async-error abort,
  // nccl_operations.cc:96-109 — an XLA collective cannot be aborted, so
  // failures must be caught BEFORE the SPMD dispatch): PREPARE runs every
  // locally-detectable check; the per-rank status is agreed across all
  // ranks over the wire; only unanimous OK proceeds to EXECUTE.  A second
  // agreement after EXECUTE converts any late failure into an ERROR on
  // every rank.  Either way every rank's entries resolve and the runtime
  // stays usable (like the coordinator's validation-error path).
  DeviceExecutorFn fn = device_executor_.load();
  Status st;
  std::vector<const char*> names(resp.names.size());
  for (size_t i = 0; i < resp.names.size(); ++i)
    names[i] = resp.names[i].c_str();
  char err[512];
  err[0] = '\0';

  // Watchdog marker covers the whole prepare/agree/execute/agree span:
  // a peer stuck in any of them leaves this rank blocked here too, and
  // the negotiation-plane stall inspector cannot see it.
  {
    std::lock_guard<std::mutex> lk(watch_mu_);
    device_exec_name_ = resp.names[0];
    device_exec_warned_ = false;
    device_exec_start_ms_ =
        std::chrono::duration_cast<std::chrono::milliseconds>(
            std::chrono::steady_clock::now().time_since_epoch())
            .count();
  }
  watch_cv_.notify_all();

  int32_t ok = 1;
  if (fn == nullptr) {
    ok = 0;
    snprintf(err, sizeof(err),
             "no device executor registered on rank %d",
             net_ ? net_->rank() : -1);
  } else {
    int rc = fn(kDevicePrepare, static_cast<int>(resp.type),
                static_cast<int>(names.size()), names.data(),
                resp.sizes.data(), static_cast<int>(resp.dtype),
                static_cast<int>(resp.op), resp.root_rank, resp.prescale,
                resp.postscale, err, sizeof(err));
    ok = (rc == 0);
  }
  int32_t first_bad = -1;
  Status ag = AgreeAllRanks(*net_, &ok, &first_bad);
  if (!ag.ok()) {
    if (fn != nullptr && ok) {
      // Drop the staged plan on transport failure too (symmetry with
      // the peer-failure path below), or the staged HBM inputs stay
      // referenced until the next device PREPARE.
      char abort_err[64];
      fn(kDeviceAbort, static_cast<int>(resp.type),
         static_cast<int>(names.size()), names.data(), resp.sizes.data(),
         static_cast<int>(resp.dtype), static_cast<int>(resp.op),
         resp.root_rank, resp.prescale, resp.postscale, abort_err,
         sizeof(abort_err));
    }
    device_exec_start_ms_ = 0;
    for (auto& e : entries)
      if (e) Finish(e, ag);
    return;
  }
  if (!ok) {
    if (fn != nullptr) {
      // Drop any state PREPARE staged (a rank whose own prepare failed
      // has nothing staged; abort is idempotent).
      char abort_err[64];
      fn(kDeviceAbort, static_cast<int>(resp.type),
         static_cast<int>(names.size()), names.data(), resp.sizes.data(),
         static_cast<int>(resp.dtype), static_cast<int>(resp.op),
         resp.root_rank, resp.prescale, resp.postscale, abort_err,
         sizeof(abort_err));
    }
    // Own error text only when this rank IS the (first) failing rank —
    // appending a local message to a peer's rank id would misattribute
    // one rank's error to another.
    st = (first_bad == net_->rank() && err[0] != '\0')
             ? Status::Error(err)
             : Status::Error("device executor failed on rank " +
                             std::to_string(first_bad));
    device_exec_start_ms_ = 0;
    for (auto& e : entries)
      if (e) Finish(e, st);
    return;
  }

  {
    timeline_.Record(resp.names[0], "B", "DEVICE_COLLECTIVE");
    int rc = fn(kDeviceExecute, static_cast<int>(resp.type),
                static_cast<int>(names.size()), names.data(),
                resp.sizes.data(), static_cast<int>(resp.dtype),
                static_cast<int>(resp.op), resp.root_rank, resp.prescale,
                resp.postscale, err, sizeof(err));
    timeline_.Record(resp.names[0], "E", "DEVICE_COLLECTIVE");
    int32_t exec_ok = (rc == 0);
    int32_t exec_bad = -1;
    ag = AgreeAllRanks(*net_, &exec_ok, &exec_bad);
    if (!ag.ok()) {
      device_exec_start_ms_ = 0;
      for (auto& e : entries)
        if (e) Finish(e, ag);
      return;
    }
    if (!exec_ok) {
      st = rc != 0 ? Status::Error(err[0] ? err : "device executor failed")
                   : Status::Error("device executor failed on rank " +
                                   std::to_string(exec_bad));
    } else {
      const int P = net_->size();
      int64_t total_elems = 0;
      switch (resp.type) {
        case RequestType::ALLGATHER:
          // sizes = per-rank first dims + trailing row_elems.
          if (resp.sizes.size() == static_cast<size_t>(P) + 1) {
            int64_t rows = 0;
            for (int r = 0; r < P; ++r) rows += resp.sizes[r];
            total_elems = rows * resp.sizes[P];
          }
          break;
        case RequestType::ALLTOALL:
          // sizes = P x P split matrix + trailing row_elems.
          if (resp.sizes.size() ==
              static_cast<size_t>(P) * P + 1) {
            int64_t rows = 0;
            for (size_t i = 0; i < static_cast<size_t>(P) * P; ++i)
              rows += resp.sizes[i];
            total_elems = rows * resp.sizes[static_cast<size_t>(P) * P];
          }
          break;
        default:  // allreduce (fused) / broadcast: element counts
          for (size_t i = 0;
               i < resp.names.size() && i < resp.sizes.size(); ++i)
            total_elems += resp.sizes[i];
          break;
      }
      bytes_processed_ += total_elems * DataTypeSize(resp.dtype);
    }
  }
  device_exec_start_ms_ = 0;
  for (auto& e : entries)
    if (e) Finish(e, st);
}

void Runtime::DeviceWatchdog() {
  std::unique_lock<std::mutex> lk(watch_mu_);
  while (!watchdog_stop_) {
    if (device_exec_start_ms_.load() == 0) {
      // Idle: block until a device response starts or shutdown — zero
      // wakeups for host-plane-only workloads.
      watch_cv_.wait(lk, [this] {
        return watchdog_stop_.load() || device_exec_start_ms_.load() != 0;
      });
      continue;
    }
    watch_cv_.wait_for(lk, std::chrono::milliseconds(200),
                       [this] { return watchdog_stop_.load(); });
    int64_t start = device_exec_start_ms_.load();
    if (start == 0 || device_exec_warned_.load()) continue;
    int64_t now = std::chrono::duration_cast<std::chrono::milliseconds>(
                      std::chrono::steady_clock::now().time_since_epoch())
                      .count();
    if ((now - start) / 1000.0 > stall_warning_s_) {
      device_exec_warned_ = true;
      fprintf(stderr,
              "[hvdtpu rank %d] WARNING: device response '%s' in flight "
              "for %.0fs; a peer rank may be stuck or dead inside the "
              "device collective\n",
              net_ ? net_->rank() : -1, device_exec_name_.c_str(),
              (now - start) / 1000.0);
    }
  }
}

void Runtime::ExecuteAllreduce(
    const Response& resp,
    std::vector<std::shared_ptr<TensorEntry>>& entries) {
  last_fused_names_ = static_cast<int64_t>(resp.names.size());
  if (resp.device) {
    ExecuteDeviceCollective(resp, entries);
    return;
  }
  // resp.sizes[i] = element count of names[i] (authoritative — joined ranks
  // have no local entry and synthesize zeros).
  int64_t total_elems = 0;
  for (auto n : resp.sizes) total_elems += n;
  const size_t elem = DataTypeSize(resp.dtype);
  const size_t total_bytes = total_elems * elem;

  // Single-tensor fast path: run the ring in place on the caller's output
  // buffer — no fusion arena, at most one copy (zero when submitted
  // in-place with input == output).  Fusion only ever pays for itself
  // when it batches multiple tensors.
  uint8_t* fb;
  bool in_place = resp.names.size() == 1 && entries[0] &&
                  entries[0]->input && entries[0]->output;
  if (in_place) {
    fb = static_cast<uint8_t*>(entries[0]->output);
    if (entries[0]->output != entries[0]->input) {
      timeline_.Record(resp.names[0], "B", "MEMCPY_IN_FUSION_BUFFER");
      memcpy(fb, entries[0]->input, total_bytes);
      timeline_.Record(resp.names[0], "E", "MEMCPY_IN_FUSION_BUFFER");
    }
  } else {
    if (fusion_buffer_.size() < total_bytes)
      fusion_buffer_.resize(total_bytes);
    fb = fusion_buffer_.data();

    // Pack (MemcpyInFusionBuffer, collective_operations.cc).
    timeline_.Record(resp.names[0], "B", "MEMCPY_IN_FUSION_BUFFER");
    int64_t off = 0;
    for (size_t i = 0; i < resp.names.size(); ++i) {
      int64_t nbytes = resp.sizes[i] * elem;
      if (entries[i] && entries[i]->input) {
        memcpy(fb + off, entries[i]->input, nbytes);
      } else {
        memset(fb + off, 0, nbytes);  // joined-rank zero proxy
      }
      off += nbytes;
    }
    timeline_.Record(resp.names[0], "E", "MEMCPY_IN_FUSION_BUFFER");
  }

  if (resp.prescale != 1.0)
    ScaleBuffer(fb, total_elems, resp.dtype, resp.prescale);

  // Ring-recovery restore: a renegotiated retry re-packs the fusion
  // buffer from the entries' inputs, which the ring never touches — so
  // the resilient wrapper skips its clean-path snapshot copy.  The only
  // shape it cannot rebuild is a truly in-place submission (input ==
  // output): that one falls back to the wrapper's internal snapshot.
  std::function<void()> repack;
  if (!in_place || entries[0]->input != entries[0]->output) {
    repack = [&, fb]() {
      if (in_place) {
        memcpy(fb, entries[0]->input, total_bytes);
      } else {
        int64_t off = 0;
        for (size_t i = 0; i < resp.names.size(); ++i) {
          int64_t nbytes = resp.sizes[i] * elem;
          if (entries[i] && entries[i]->input) {
            memcpy(fb + off, entries[i]->input, nbytes);
          } else {
            memset(fb + off, 0, nbytes);
          }
          off += nbytes;
        }
      }
      if (resp.prescale != 1.0)
        ScaleBuffer(fb, total_elems, resp.dtype, resp.prescale);
    };
  }

  timeline_.Record(resp.names[0], "B", "RING_ALLREDUCE");
  Status st;
  // Algorithm choice comes from the RESPONSE (coordinator-stamped), not
  // local state: the tuner flips the toggle on rank 0 mid-run and every
  // rank must execute the same schedule for the same Response.
  if (resp.op == ReduceOp::ADASUM) {
    st = (resp.hierarchical && local_size_ > 1)
             ? HierarchicalAdasum(*net_, fb, total_elems, resp.dtype,
                                  local_size_)
             : AdasumAllreduce(*net_, fb, total_elems, resp.dtype);
  } else if (resp.hierarchical && local_size_ > 1) {
    st = HierarchicalAllreduce(*net_, fb, total_elems, resp.dtype, resp.op,
                               local_size_);
  } else {
    st = RingAllreduce(*net_, fb, total_elems, resp.dtype, resp.op,
                       repack ? &repack : nullptr);
  }
  timeline_.Record(resp.names[0], "E", "RING_ALLREDUCE");

  if (st.ok()) bytes_processed_ += total_bytes;
  if (st.ok()) {
    if (resp.op == ReduceOp::AVERAGE) {
      // Integer Average floor-divides in the integer domain (compiled-
      // path contract); float dtypes scale.
      if (!FloorAverageInt(fb, total_elems, resp.dtype, net_->size()))
        ScaleBuffer(fb, total_elems, resp.dtype, 1.0 / net_->size());
    }
    if (resp.postscale != 1.0)
      ScaleBuffer(fb, total_elems, resp.dtype, resp.postscale);
    if (!in_place) {
      // Unpack.
      int64_t off = 0;
      for (size_t i = 0; i < resp.names.size(); ++i) {
        int64_t nbytes = resp.sizes[i] * elem;
        if (entries[i] && entries[i]->output)
          memcpy(entries[i]->output, fb + off, nbytes);
        off += nbytes;
      }
    }
  }
  for (auto& e : entries)
    if (e) Finish(e, st);
}

void Runtime::ExecuteAllgather(const Response& resp,
                               std::shared_ptr<TensorEntry> entry) {
  if (resp.device) {
    std::vector<std::shared_ptr<TensorEntry>> entries{entry};
    ExecuteDeviceCollective(resp, entries);
    return;
  }
  const int size = net_->size();
  const int rank = net_->rank();
  const size_t elem = DataTypeSize(resp.dtype);
  // resp.sizes = [first_dim per rank ..., row_elems]; row_elems from the
  // coordinator so joined ranks (no local entry) can still size their ring
  // blocks and forward peers' data.
  const int64_t row_elems = resp.sizes[size];
  std::vector<int64_t> bytes(size), offsets(size);
  int64_t total = 0;
  for (int r = 0; r < size; ++r) {
    bytes[r] = resp.sizes[r] * row_elems * elem;
    offsets[r] = total;
    total += bytes[r];
  }
  auto out = std::make_shared<std::vector<uint8_t>>(
      std::max<int64_t>(total, 1));
  if (entry && entry->input)
    memcpy(out->data() + offsets[rank], entry->input, bytes[rank]);
  if (entry) timeline_.Record(entry->name, "B", "RING_ALLGATHER");
  // Always route through HierarchicalAllgatherv: it owns the schedule
  // marker and degrades to the flat ring itself when local_size == 1.
  Status st = HierarchicalAllgatherv(
      *net_, out->data(), bytes, offsets,
      (resp.hierarchical && local_size_ > 1) ? local_size_ : 1);
  if (entry) {
    timeline_.Record(entry->name, "E", "RING_ALLGATHER");
    entry->var_output = out;
    entry->out_first_dims.assign(resp.sizes.begin(),
                                 resp.sizes.begin() + size);
    Finish(entry, st);
  }
}

void Runtime::ExecuteBroadcast(const Response& resp,
                               std::shared_ptr<TensorEntry> entry) {
  if (resp.device) {
    std::vector<std::shared_ptr<TensorEntry>> entries{entry};
    ExecuteDeviceCollective(resp, entries);
    return;
  }
  const size_t elem = DataTypeSize(resp.dtype);
  const int64_t nbytes = resp.sizes[0] * elem;
  std::vector<uint8_t> scratch;
  void* buf;
  if (entry && entry->output) {
    if (net_->rank() == resp.root_rank && entry->input != entry->output)
      memcpy(entry->output, entry->input, nbytes);
    buf = entry->output;
  } else {
    scratch.resize(nbytes);
    buf = scratch.data();  // joined-rank proxy participates in the chain
  }
  Status st = ChainBroadcast(*net_, buf, nbytes, resp.root_rank);
  if (entry) Finish(entry, st);
}

void Runtime::ExecuteAlltoall(const Response& resp,
                              std::shared_ptr<TensorEntry> entry) {
  if (resp.device) {
    std::vector<std::shared_ptr<TensorEntry>> entries{entry};
    ExecuteDeviceCollective(resp, entries);
    return;
  }
  const int size = net_->size();
  const int rank = net_->rank();
  const size_t elem = DataTypeSize(resp.dtype);
  // resp.sizes = row-split matrix [src * size + dst] + trailing row_elems
  // (coordinator-supplied so joined ranks size their exchanges correctly).
  const int64_t row_elems = resp.sizes[static_cast<size_t>(size) * size];
  std::vector<int64_t> send_bytes(size), recv_bytes(size);
  int64_t total_recv = 0;
  for (int d = 0; d < size; ++d)
    send_bytes[d] =
        (entry ? resp.sizes[static_cast<size_t>(rank) * size + d] : 0) *
        row_elems * elem;
  for (int s = 0; s < size; ++s) {
    recv_bytes[s] = resp.sizes[static_cast<size_t>(s) * size + rank] *
                    row_elems * elem;
    total_recv += recv_bytes[s];
  }
  auto out = std::make_shared<std::vector<uint8_t>>(
      std::max<int64_t>(total_recv, 1));
  const uint8_t* send =
      entry ? static_cast<const uint8_t*>(entry->input) : out->data();
  Status st = PairwiseAlltoallv(*net_, send, send_bytes, out->data(),
                                recv_bytes);
  if (entry) {
    entry->var_output = out;
    entry->out_first_dims.resize(size);
    for (int s = 0; s < size; ++s)
      entry->out_first_dims[s] =
          resp.sizes[static_cast<size_t>(s) * size + rank];
    Finish(entry, st);
  }
}

int Runtime::JoinBlocking() {
  join_requested_ = true;
  enqueue_cv_.notify_one();
  std::unique_lock<std::mutex> lk(sync_mu_);
  // -2 = idle sentinel; >= 0 = released (last joined rank); -1 = the
  // background loop died (loop_dead_ unblock) — waiting for >= 0 only
  // would strand the caller forever on loop failure.
  sync_cv_.wait(lk,
                [this] { return last_joined_rank_ != -2 || stop_; });
  int r = last_joined_rank_;
  last_joined_rank_ = -2;
  return r;
}

Status Runtime::BarrierBlocking() {
  barrier_requested_ = true;
  enqueue_cv_.notify_one();
  std::unique_lock<std::mutex> lk(sync_mu_);
  sync_cv_.wait(lk, [this] { return barrier_released_ || stop_; });
  barrier_released_ = false;
  return Status::OK();
}

void Runtime::SetTopology(int local_size, bool hierarchical_allreduce,
                          bool hierarchical_allgather) {
  local_size_ = local_size;
  // Seed the coordinator's per-response stamping with the configured
  // algorithm choice (the tuner may override later via SetTunedToggles).
  if (controller_)
    controller_->SetAlgoToggles(hierarchical_allreduce,
                                hierarchical_allgather, tuned_cache_on_);
}

void Runtime::SetTunedToggles(bool hierarchical_allreduce,
                              bool hierarchical_allgather,
                              bool cache_enabled) {
  tuned_cache_on_ = cache_enabled;
  if (controller_)
    controller_->SetAlgoToggles(hierarchical_allreduce,
                                hierarchical_allgather, cache_enabled);
}

void Runtime::SetScheduleTable(int kind, std::vector<ScheduleSegment> segs) {
  // Coordinator-only effect (workers adopt the per-response stamp from
  // the response stream), mirroring SetWireCompression.
  if (controller_) controller_->SetScheduleTable(kind, std::move(segs));
}

void Runtime::SetCacheOn(bool cache_enabled) {
  tuned_cache_on_ = cache_enabled;
  if (controller_) controller_->SetCacheOn(cache_enabled);
}

void Runtime::SetWireCompression(int code) {
  // Coordinator-only effect: workers (and rank 0's own executor) adopt
  // the choice from the response stream, so setting it here on a
  // non-coordinator rank is a deliberate no-op.
  if (controller_) controller_->SetWireCompression(code);
}

void Runtime::SetParams(int64_t fusion_threshold, double cycle_time_ms) {
  if (fusion_threshold > 0 && controller_)
    controller_->SetFusionThreshold(fusion_threshold);
  if (cycle_time_ms > 0) cycle_time_ms_ = cycle_time_ms;
}

void Runtime::ReadCounters(int64_t* bytes, double* seconds) {
  auto now = std::chrono::steady_clock::now();
  *bytes = bytes_processed_.exchange(0);
  *seconds = std::chrono::duration<double>(now - counter_start_).count();
  counter_start_ = now;
}

void Runtime::StartTimeline(const std::string& filename) {
  timeline_.Start(filename, net_ ? net_->rank() : 0,
                  net_ ? net_->size() : 1);
}

std::string Runtime::StalledJson() {
  if (!initialized_ || !controller_) return "[]";
  return controller_->StalledJsonPlain();  // port: stall snapshot without iostreams
  return controller_->StalledJson();
}

void Runtime::StopTimeline() { timeline_.Stop(); }

}  // namespace hvdtpu
