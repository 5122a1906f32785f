#include "timeline.h"

namespace hvdtpu {

void Timeline::Start(const std::string& filename, int rank, int size) {
  if (active_) return;
  file_ = fopen(filename.c_str(), "w");
  if (!file_) return;
  rank_ = rank;
  t0_ = std::chrono::steady_clock::now();
  fprintf(file_, "[\n");
  first_event_ = true;
  // One labeled process row per rank (pid = rank), sorted by rank: the
  // writer thread has not started yet, so writing directly is safe.
  for (int r = 0; r < size; ++r) {
    fprintf(file_,
            "%s{\"name\":\"process_name\",\"ph\":\"M\",\"pid\":%d,"
            "\"tid\":0,\"args\":{\"name\":\"rank %d\"}},\n"
            "{\"name\":\"process_sort_index\",\"ph\":\"M\",\"pid\":%d,"
            "\"tid\":0,\"args\":{\"sort_index\":%d}}",
            first_event_ ? "" : ",\n", r, r, r, r);
    first_event_ = false;
  }
  stop_requested_ = false;
  active_ = true;
  writer_ = std::thread([this] { WriterLoop(); });
}

void Timeline::Stop() {
  if (!active_) return;
  {
    std::lock_guard<std::mutex> lk(mu_);
    stop_requested_ = true;
  }
  cv_.notify_all();
  if (writer_.joinable()) writer_.join();
  fprintf(file_, "\n]\n");
  fclose(file_);
  file_ = nullptr;
  active_ = false;
}

void Timeline::Record(const std::string& name, const char* ph,
                      const std::string& category, const std::string& args,
                      int pid) {
  if (!active_) return;
  int64_t ts = std::chrono::duration_cast<std::chrono::microseconds>(
                   std::chrono::steady_clock::now() - t0_).count();
  {
    std::lock_guard<std::mutex> lk(mu_);
    queue_.push(Event{name, category, ph[0], ts, args,
                      pid < 0 ? rank_ : pid});
  }
  cv_.notify_one();
}

void Timeline::MarkCycle() { Record("CYCLE", "i", "cycle"); }

void Timeline::WriterLoop() {
  std::unique_lock<std::mutex> lk(mu_);
  while (true) {
    cv_.wait(lk, [this] { return !queue_.empty() || stop_requested_; });
    while (!queue_.empty()) {
      Event ev = queue_.front();
      queue_.pop();
      lk.unlock();
      fprintf(file_, "%s{\"name\":\"%s\",\"cat\":\"%s\",\"ph\":\"%c\","
              "\"ts\":%lld,\"pid\":%d,\"tid\":0%s",
              first_event_ ? "" : ",\n", ev.name.c_str(), ev.cat.c_str(),
              ev.ph, static_cast<long long>(ev.ts_us), ev.pid,
              ev.ph == 'i' ? ",\"s\":\"g\"" : "");
      if (!ev.args.empty()) fprintf(file_, ",\"args\":%s", ev.args.c_str());
      fprintf(file_, "}");
      first_event_ = false;
      lk.lock();
    }
    if (stop_requested_ && queue_.empty()) break;
  }
}

}  // namespace hvdtpu
