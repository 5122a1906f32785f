// Chrome-tracing timeline writer.
//
// Capability parity with the reference Timeline (timeline.h:36-168,
// timeline.cc:443-640): per-tensor phases (NEGOTIATE → operation →
// activities) written as Chrome trace events on a dedicated writer thread,
// enabled by HOROVOD_TIMELINE / HVD_TPU_TIMELINE or started at runtime.
#pragma once

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdio>
#include <mutex>
#include <queue>
#include <string>
#include <thread>

namespace hvdtpu {

class Timeline {
 public:
  ~Timeline() { Stop(); }
  // size: communicator size — one process_name/process_sort_index
  // metadata row is emitted per rank up front, so per-rank events (pid =
  // rank) render as one labeled row per rank in chrome://tracing instead
  // of interleaving on the recorder's pid.
  void Start(const std::string& filename, int rank, int size = 1);
  void Stop();
  bool active() const { return active_; }

  // ph: "B" begin / "E" end / "i" instant. category groups rows.  args,
  // when non-empty, is a pre-rendered JSON object body (e.g. {"rank":2})
  // attached to the event — used for the per-rank NEGOTIATE ready instants
  // (reference timeline.cc:496-541).  pid < 0 means "the recording
  // rank"; events that belong to a specific rank (negotiate readiness)
  // pass that rank so the trace attributes them to the right row.
  void Record(const std::string& name, const char* ph,
              const std::string& category, const std::string& args = "",
              int pid = -1);
  void MarkCycle();

 private:
  void WriterLoop();
  struct Event {
    std::string name;
    std::string cat;
    char ph;
    int64_t ts_us;
    std::string args;
    int pid;
  };
  std::atomic<bool> active_{false};
  bool stop_requested_ = false;
  int rank_ = 0;
  FILE* file_ = nullptr;
  bool first_event_ = true;
  std::chrono::steady_clock::time_point t0_;
  std::mutex mu_;
  std::condition_variable cv_;
  std::queue<Event> queue_;
  std::thread writer_;
};

}  // namespace hvdtpu
