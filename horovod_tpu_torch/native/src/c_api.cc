// extern "C" API consumed by the ctypes layer (native/controller.py).
//
// Capability parity with the reference's C API (operations.cc:703-915:
// horovod_init/shutdown/rank/size + EnqueueTensor* reached through the
// framework bridges) — here a single flat C surface since the only bridge
// is Python/numpy.
#include <cstring>
#include <memory>
#include <mutex>
#include <string>

#include "runtime.h"

using namespace hvdtpu;

namespace {
std::mutex g_err_mu;
std::string g_last_error;

void SetError(const std::string& msg) {
  std::lock_guard<std::mutex> lk(g_err_mu);
  g_last_error = msg;
}

std::shared_ptr<TensorEntry> MakeEntry(const char* name, RequestType type,
                                       const void* input, void* output,
                                       int ndim, const int64_t* shape,
                                       int dtype) {
  auto e = std::make_shared<TensorEntry>();
  e->name = name;
  e->type = type;
  e->dtype = static_cast<DataType>(dtype);
  e->shape.assign(shape, shape + ndim);
  e->input = input;
  e->output = output;
  return e;
}

int64_t EnqueueChecked(std::shared_ptr<TensorEntry> e) {
  Status st;
  int64_t h = Runtime::Get().Enqueue(std::move(e), &st);
  if (h < 0) SetError(st.reason);
  return h;
}
}  // namespace

extern "C" {

int hvd_native_init(int rank, int size, const char* coord_addr,
                    int64_t fusion_threshold, double cycle_time_ms,
                    double stall_warning_s, double stall_shutdown_s,
                    const char* timeline_file, int64_t cache_capacity) {
  Status st = Runtime::Get().Init(rank, size, coord_addr, fusion_threshold,
                                  cycle_time_ms, stall_warning_s,
                                  stall_shutdown_s,
                                  timeline_file ? timeline_file : "",
                                  cache_capacity < 0 ? 0 : cache_capacity);
  if (!st.ok()) {
    SetError(st.reason);
    return -1;
  }
  return 0;
}

void hvd_native_shutdown() { Runtime::Get().Shutdown(); }

int hvd_native_initialized() { return Runtime::Get().initialized() ? 1 : 0; }
int hvd_native_rank() { return Runtime::Get().rank(); }
int hvd_native_size() { return Runtime::Get().size(); }

int64_t hvd_native_allreduce(const char* name, const void* input,
                             void* output, int ndim, const int64_t* shape,
                             int dtype, int op, double prescale,
                             double postscale) {
  auto e = MakeEntry(name, RequestType::ALLREDUCE, input, output, ndim,
                     shape, dtype);
  e->op = static_cast<ReduceOp>(op);
  e->prescale = prescale;
  e->postscale = postscale;
  return EnqueueChecked(std::move(e));
}

// Device-resident enqueue: the payload stays in accelerator HBM; the
// runtime negotiates/fuses/caches as usual and hands the fused response to
// the registered device executor instead of the host rings.
int64_t hvd_native_allreduce_device(const char* name, int ndim,
                                    const int64_t* shape, int dtype, int op,
                                    double prescale, double postscale) {
  auto e = MakeEntry(name, RequestType::ALLREDUCE, nullptr, nullptr, ndim,
                     shape, dtype);
  e->op = static_cast<ReduceOp>(op);
  e->prescale = prescale;
  e->postscale = postscale;
  e->device = true;
  return EnqueueChecked(std::move(e));
}

int64_t hvd_native_broadcast_device(const char* name, int ndim,
                                    const int64_t* shape, int dtype,
                                    int root_rank) {
  auto e = MakeEntry(name, RequestType::BROADCAST, nullptr, nullptr, ndim,
                     shape, dtype);
  e->root_rank = root_rank;
  e->device = true;
  return EnqueueChecked(std::move(e));
}

int64_t hvd_native_allgather_device(const char* name, int ndim,
                                    const int64_t* shape, int dtype) {
  auto e = MakeEntry(name, RequestType::ALLGATHER, nullptr, nullptr, ndim,
                     shape, dtype);
  e->device = true;
  return EnqueueChecked(std::move(e));
}

int64_t hvd_native_alltoall_device(const char* name, int ndim,
                                   const int64_t* shape, int dtype,
                                   const int64_t* splits, int nsplits) {
  auto e = MakeEntry(name, RequestType::ALLTOALL, nullptr, nullptr, ndim,
                     shape, dtype);
  e->splits.assign(splits, splits + nsplits);
  e->device = true;
  return EnqueueChecked(std::move(e));
}

void hvd_native_set_device_executor(DeviceExecutorFn fn) {
  Runtime::Get().SetDeviceExecutor(fn);
}

int64_t hvd_native_allgather(const char* name, const void* input, int ndim,
                             const int64_t* shape, int dtype) {
  return EnqueueChecked(MakeEntry(name, RequestType::ALLGATHER, input,
                                  nullptr, ndim, shape, dtype));
}

int64_t hvd_native_broadcast(const char* name, const void* input,
                             void* output, int ndim, const int64_t* shape,
                             int dtype, int root_rank) {
  auto e = MakeEntry(name, RequestType::BROADCAST, input, output, ndim,
                     shape, dtype);
  e->root_rank = root_rank;
  return EnqueueChecked(std::move(e));
}

int64_t hvd_native_alltoall(const char* name, const void* input, int ndim,
                            const int64_t* shape, int dtype,
                            const int64_t* splits, int nsplits) {
  auto e = MakeEntry(name, RequestType::ALLTOALL, input, nullptr, ndim,
                     shape, dtype);
  e->splits.assign(splits, splits + nsplits);
  return EnqueueChecked(std::move(e));
}

int hvd_native_poll(int64_t handle) {
  return Runtime::Get().Poll(handle) ? 1 : 0;
}

// Blocks; returns 0 on success. Does not release the handle.
int hvd_native_wait(int64_t handle) {
  Status st = Runtime::Get().Wait(handle);
  if (!st.ok()) {
    SetError(st.reason);
    return -1;
  }
  return 0;
}

// Variable-size results (allgather/alltoall).
int64_t hvd_native_result_bytes(int64_t handle) {
  auto e = Runtime::Get().GetEntry(handle);
  if (!e || !e->var_output) return -1;
  return static_cast<int64_t>(e->var_output->size());
}

int hvd_native_result_dims(int64_t handle, int64_t* dims, int max_dims) {
  auto e = Runtime::Get().GetEntry(handle);
  if (!e) return -1;
  int n = static_cast<int>(e->out_first_dims.size());
  for (int i = 0; i < n && i < max_dims; ++i) dims[i] = e->out_first_dims[i];
  return n;
}

int hvd_native_result_copy(int64_t handle, void* dst, int64_t nbytes) {
  auto e = Runtime::Get().GetEntry(handle);
  if (!e || !e->var_output ||
      nbytes < static_cast<int64_t>(e->var_output->size()))
    return -1;
  memcpy(dst, e->var_output->data(), e->var_output->size());
  return 0;
}

void hvd_native_release(int64_t handle) { Runtime::Get().Release(handle); }

void hvd_native_interrupt_waits(const char* reason) {  // port: elastic wake-up
  Runtime::Get().InterruptWaits(reason ? reason : "interrupted");  // port: elastic wake-up
}  // port: elastic wake-up
int hvd_native_join() { return Runtime::Get().JoinBlocking(); }

int hvd_native_barrier() {
  Status st = Runtime::Get().BarrierBlocking();
  return st.ok() ? 0 : -1;
}

void hvd_native_set_topology(int local_size, int hierarchical_allreduce,
                             int hierarchical_allgather) {
  Runtime::Get().SetTopology(local_size, hierarchical_allreduce != 0,
                             hierarchical_allgather != 0);
}

// Test/observability hook: 0 = flat ring, 1 = hierarchical (schedule used
// by this process's most recent allgather).
int hvd_native_last_allgather_schedule() {
  return LastAllgatherSchedule();
}

// 0 = flat ring / flat VHDD, 1 = hierarchical (this process's most
// recent allreduce/Adasum) — the allreduce analog of the hook above.
int hvd_native_last_allreduce_schedule() {
  return LastAllreduceSchedule();
}

// 0 = flat/none, 1 = pipelined chain, 2 = zero-copy CMA star.
int hvd_native_last_allreduce_fanout() { return LastAllreduceFanout(); }
int hvd_native_last_bcast_schedule() { return LastBroadcastSchedule(); }

// Test/observability hooks: peak scratch bytes of the Adasum VHDD path.
int64_t hvd_native_adasum_scratch_peak() { return AdasumScratchPeak(); }
void hvd_native_adasum_scratch_reset() { ResetAdasumScratchPeak(); }

// Names in the most recent (possibly fused) allreduce Response executed
// by this rank — live evidence of the current fusion threshold.
int64_t hvd_native_last_fused_names() {
  return Runtime::Get().LastFusedNames();
}
int64_t hvd_native_cache_hits() { return Runtime::Get().CacheHits(); }  // port: response-cache hit counter

void hvd_native_set_params(int64_t fusion_threshold, double cycle_time_ms) {
  Runtime::Get().SetParams(fusion_threshold, cycle_time_ms);
}

// Categorical autotune toggles (reference parameter_manager.h:91-93):
// rank 0's tuner flips {hierarchical allreduce, hierarchical allgather,
// response cache} per sample; the coordinator distributes the choice
// through the response stream so every rank stays schedule-consistent.
void hvd_native_set_tuned_toggles(int hierarchical_allreduce,
                                  int hierarchical_allgather,
                                  int cache_enabled) {
  Runtime::Get().SetTunedToggles(hierarchical_allreduce != 0,
                                 hierarchical_allgather != 0,
                                 cache_enabled != 0);
}

// Per-payload schedule dispatch table (topology-probed): rank 0
// installs a piecewise-constant payload_bytes -> {flat(0), hier(1)}
// map per op kind (0 = allreduce, 1 = allgather); the coordinator
// stamps each response's choice from its FINAL fused payload, so
// table swaps stay rank-consistent like every other stream stamp.
// max_bytes must be ascending with the last entry == INT64_MAX;
// malformed tables are ignored.
void hvd_native_set_schedule_table(int kind, const int64_t* max_bytes,
                                   const int32_t* hierarchical, int n) {
  std::vector<ScheduleSegment> segs;
  segs.reserve(n > 0 ? n : 0);
  for (int i = 0; i < n; ++i)
    segs.push_back({max_bytes[i], hierarchical[i] != 0});
  Runtime::Get().SetScheduleTable(kind, std::move(segs));
}

// Response-cache toggle alone (the dispatch plane owns the schedule
// choice once a table is installed; flipping the cache must not
// clobber it the way set_tuned_toggles' whole-range reinstall would).
void hvd_native_set_cache_enabled(int cache_enabled) {
  Runtime::Get().SetCacheOn(cache_enabled != 0);
}

// Eager wire compression (quantized collective engine): rank 0's
// config/tuner picks the device-plane wire format; the coordinator
// stamps it per round (ResponseList::wire_compression) so every rank
// builds the same staged-buffer program mid-flip.  The getter returns
// the stream-adopted value (0 none, 1 bf16, 2 int8, 3 int4, 4 fp16).
void hvd_native_set_wire_compression(int code) {
  Runtime::Get().SetWireCompression(code);
}

int hvd_native_wire_compression() {
  return Runtime::Get().WireCompression();
}

void hvd_native_counters(int64_t* bytes, double* seconds) {
  Runtime::Get().ReadCounters(bytes, seconds);
}

// Self-healing wire fabric counters (net.cc escalation ladder), consumed
// by hvd.net / hvd.metrics and by hang reports to tell "retrying,
// deadline not yet reached" from "wedged".  Layout (n capped):
//   [0] retries          — recovery attempts, any rung
//   [1] reconnects       — connections re-established and resumed
//   [2] renegotiations   — ring re-formations around a dead link
//   [3] resets_avoided   — ops/collectives completed after >= 1 recovery
//   [4] chaos_injected   — faults the seeded chaos layer fired
//   [5] recovering_now   — channels currently mid-recovery (> 0 means a
//                          retry ladder is live right now)
//   [6] last_recovery_age_ms — ms since the last recovery activity
//                              (-1: never)
//   [7..10] dev diagnostics: wall us inside channel Send/Recv + op
//           counts (protocol-cost attribution; not exported to metrics)
int hvd_native_net_counters(int64_t* out, int n) {
  NetCountersState& c = NetCounters();
  int64_t vals[15] = {
      c.retries.load(),        c.reconnects.load(),
      c.renegotiations.load(), c.resets_avoided.load(),
      c.chaos_injected.load(), c.recovering_now.load(),
      c.last_recovery_ms.load() == 0
          ? -1
          : SteadyNowMs() - c.last_recovery_ms.load(),
      c.send_us.load(),        c.recv_us.load(),
      c.send_ops.load(),       c.recv_ops.load(),
      c.pump_wait_us.load(),   c.pump_read_us.load(),
      c.write_us.load(),       c.cvwait_us.load()};
  int m = n < 15 ? n : 15;
  for (int i = 0; i < m; ++i) out[i] = vals[i];
  return m;
}

// Stall-inspector snapshot for the Python-side hang-diagnosis watchdog:
// fills buf with a JSON array of tensors past the warning window (name,
// request type, age, missing + submitted rank lists).  Returns the number
// of bytes written (truncated to cap-1), or the full length when buf is
// NULL — call twice to size.  Coordinator-only; other ranks get "[]".
int hvd_native_stalled_json(char* buf, int cap) {
  std::string s = Runtime::Get().StalledJson();
  int n = static_cast<int>(s.size());
  if (!buf || cap <= 0) return n;
  int c = n < cap - 1 ? n : cap - 1;
  memcpy(buf, s.data(), c);
  buf[c] = '\0';
  return c;
}

void hvd_native_start_timeline(const char* filename) {
  Runtime::Get().StartTimeline(filename);
}

void hvd_native_stop_timeline() { Runtime::Get().StopTimeline(); }

const char* hvd_native_last_error() {
  std::lock_guard<std::mutex> lk(g_err_mu);
  return g_last_error.c_str();
}

}  // extern "C"
