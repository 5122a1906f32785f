// TCP transport: full-mesh peer connections bootstrapped through the
// coordinator (rank 0), with a self-healing resilient channel layer.
//
// Capability parity with the reference's Gloo context creation
// (gloo/gloo_context.cc:66-160: TCP devices + rendezvous KV): rank 0 binds
// the address the launcher exported (HVD_TPU_CONTROLLER_ADDR), workers dial
// in, the address table is broadcast, then every pair connects directly.
//
// Resilience (HVD_TPU_NET_RESILIENCE, default on): every logical transfer
// between a pair of ranks is framed — a 16-byte header carrying a magic,
// the payload length and a per-direction frame sequence number — and
// acknowledged at operation granularity.  A broken connection (reset,
// dropped frame detected as a sequence gap, truncation) is re-established
// through the pair's persistent listeners and the transfer RESUMES from
// the last fully delivered frame, bounded by a per-operation deadline.
// Only when reconnection exhausts does the failure surface to the caller,
// where the ring-level recovery (collectives.cc) can re-form the ring
// around the dead link before escalating to the elastic reset.
#pragma once

#include <atomic>
#include <condition_variable>
#include <cstdio>
#include <cstdlib>
#include <deque>
#include <functional>
#include <memory>
#include <mutex>
#include <set>
#include <string>
#include <thread>
#include <utility>
#include <vector>

#include "common.h"
#include "shm.h"

namespace hvdtpu {

// ---------------------------------------------------------------------------
// Resilience configuration (parsed once from env; uniform across the fleet
// because the launcher exports the knobs to every worker).
// ---------------------------------------------------------------------------
struct NetResilienceConfig {
  bool enabled = true;         // HVD_TPU_NET_RESILIENCE
  double probe_ms = 10000.0;   // HVD_TPU_NET_PROBE_MS: no-progress window
                               // before a mid-stream reconnect attempt
  double reconnect_s = 10.0;   // HVD_TPU_NET_RECONNECT_S: budget per
                               // reconnect-and-resume attempt
  double op_deadline_s = 60.0; // HVD_TPU_NET_OP_DEADLINE_S: total budget per
                               // logical transfer including recoveries
  int max_renegotiations = 2;  // HVD_TPU_NET_MAX_RENEG: ring re-formations
                               // per collective before escalating
  bool renegotiate = true;     // HVD_TPU_NET_RENEGOTIATE
};
const NetResilienceConfig& NetResilience();

// ---------------------------------------------------------------------------
// Seeded wire chaos (HVD_TPU_CHAOS_NET_*): deterministic fault injection in
// the native socket layer so the whole escalation ladder drills in CI
// without root.  Draws are a pure function of (seed, rank, peer, per-channel
// draw index) — channel writes are serialized, so the schedule replays
// bit-for-bit from its seed.
// ---------------------------------------------------------------------------
struct NetChaosConfig {
  uint64_t seed = 0;          // HVD_TPU_CHAOS_NET_SEED
  double drop_pct = 0.0;      // HVD_TPU_CHAOS_NET_DROP_PCT: swallow a data
                              // frame (receiver sees a sequence gap)
  double reset_pct = 0.0;     // HVD_TPU_CHAOS_NET_RESET_PCT: kill the
                              // connection before a data frame
  double delay_ms = 0.0;      // HVD_TPU_CHAOS_NET_DELAY_MS: per-frame delay
  double truncate_pct = 0.0;  // HVD_TPU_CHAOS_NET_TRUNCATE: write a partial
                              // frame, then kill the connection
  // HVD_TPU_CHAOS_NET_BLACKHOLE="a-b[,c-d]": the listed rank pairs lose
  // connectivity permanently once the mesh is up (reconnects refused) —
  // the renegotiation drill.
  std::set<std::pair<int, int>> blackhole;
  bool enabled() const {
    return drop_pct > 0 || reset_pct > 0 || delay_ms > 0 ||
           truncate_pct > 0 || !blackhole.empty();
  }
  bool blackholed(int a, int b) const {
    return blackhole.count({std::min(a, b), std::max(a, b)}) != 0;
  }
};
const NetChaosConfig& NetChaos();

// Deterministic draw in [0, 1) from (seed, rank, peer, index).
double NetChaosDraw(uint64_t seed, int rank, int peer, uint64_t index);

// ---------------------------------------------------------------------------
// Observability: the ladder's counters, exported through c_api to
// hvd.metrics (hvd_net_*_total) and to hang reports ("retrying, deadline
// not yet reached" vs "wedged").
// ---------------------------------------------------------------------------
struct NetCountersState {
  std::atomic<int64_t> retries{0};          // recovery attempts, any rung
  std::atomic<int64_t> reconnects{0};       // re-established connections
  std::atomic<int64_t> renegotiations{0};   // ring re-formations
  std::atomic<int64_t> resets_avoided{0};   // ops/collectives completed
                                            // after >= 1 recovery
  std::atomic<int64_t> chaos_injected{0};   // faults the chaos layer fired
  std::atomic<int> recovering_now{0};       // channels mid-recovery
  std::atomic<int64_t> last_recovery_ms{0}; // steady-clock ms of the last
                                            // recovery activity
  // Dev/diagnosis accumulators (exported in the trailing counter slots):
  // wall microseconds inside channel Send/Recv + op counts.
  std::atomic<int64_t> send_us{0};
  std::atomic<int64_t> recv_us{0};
  std::atomic<int64_t> send_ops{0};
  std::atomic<int64_t> recv_ops{0};
  std::atomic<int64_t> pump_wait_us{0};   // PumpOne first poll (arrival)
  std::atomic<int64_t> pump_read_us{0};   // PumpOne header+payload reads
  std::atomic<int64_t> write_us{0};       // WriteBytes total
  std::atomic<int64_t> cvwait_us{0};      // Pump cv fallback waits
};
NetCountersState& NetCounters();
int64_t SteadyNowMs();

class Network;

// Persistent helper thread for full-duplex streaming: the data plane
// overlaps one send with one recv per ring round, and spawning a fresh
// std::thread per round (2(P-1) spawns per allreduce) costs more than
// the transfer at small payloads.  One lazily-started helper per
// Network; the background thread is the only submitter.
class DuplexHelper {
 public:
  ~DuplexHelper() { Stop(); }

  // Runs fn on the helper thread; pair with Wait() before touching the
  // buffers fn captures.  Single-submitter contract (the background
  // thread): overlapping Run calls would overwrite the in-flight task's
  // closure (whose by-reference captures then dangle) — abort loudly
  // instead of corrupting silently.
  void Run(std::function<void()> fn) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      if (busy_) {
        fprintf(stderr,
                "DuplexHelper: overlapping Run (single-submitter "
                "contract violated)\n");
        std::abort();
      }
      if (!started_) {
        started_ = true;
        th_ = std::thread([this] { Loop(); });
      }
      task_ = std::move(fn);
      has_task_ = true;
      done_ = false;
      busy_ = true;
    }
    cv_.notify_all();
  }

  void Wait() {
    std::unique_lock<std::mutex> lk(mu_);
    cv_.wait(lk, [this] { return done_; });
    busy_ = false;
  }

  void Stop() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      if (!started_) return;
      stop_ = true;
    }
    cv_.notify_all();
    if (th_.joinable()) th_.join();
    std::lock_guard<std::mutex> lk(mu_);
    started_ = false;
    stop_ = false;
  }

 private:
  void Loop() {
    for (;;) {
      std::function<void()> fn;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return stop_ || has_task_; });
        if (stop_) return;
        fn = std::move(task_);
        has_task_ = false;
      }
      fn();
      {
        std::lock_guard<std::mutex> lk(mu_);
        done_ = true;
      }
      cv_.notify_all();
    }
  }

  std::thread th_;
  std::mutex mu_;
  std::condition_variable cv_;
  std::function<void()> task_;
  bool started_ = false;
  bool has_task_ = false;
  bool done_ = false;
  bool busy_ = false;
  bool stop_ = false;
};

class Socket {
 public:
  explicit Socket(int fd) : fd_(fd) {}
  ~Socket();
  Socket(const Socket&) = delete;

  Status SendAll(const void* data, size_t n);
  Status RecvAll(void* data, size_t n);
  // Frame = u32 little-endian length + payload.
  Status SendFrame(const std::vector<uint8_t>& payload);
  Status RecvFrame(std::vector<uint8_t>& payload);
  int fd() const { return fd_; }
  int release() { int f = fd_; fd_ = -1; return f; }

 private:
  int fd_;
};

// One resilient bidirectional link to a peer.  In resilient mode every
// logical transfer is framed + acked and survives connection loss via
// reconnect-and-resume; in raw mode the wire bytes are identical to the
// pre-resilience protocol.  Thread contract: at most one in-flight send
// op and one in-flight recv op at a time (the collective schedules
// guarantee it); the two may run on different threads (FullDuplex).
class Channel {
 public:
  Channel(Network* net, int peer, int fd);
  ~Channel();

  // One logical transfer of exactly n bytes.  on_progress(delivered) is
  // invoked at frame granularity as the delivered prefix grows (never
  // for bytes a resume might rewrite).  `control` ops (negotiation
  // frames) never reconnect on mere inactivity — a peer legitimately
  // blocked in a long device collective is not a network fault — only
  // on hard socket errors, and wait without deadline like the raw
  // protocol did.
  Status Send(const uint8_t* buf, size_t n, bool control = false);
  // deadline_s bounds a CONTROL recv (the ring-recovery agreement is a
  // bounded rendezvous, unlike the open-ended negotiation wait); 0 keeps
  // the control default (no deadline).  Data ops always use the
  // configured op deadline.
  Status Recv(uint8_t* dst, size_t n,
              const std::function<void(size_t)>& on_progress = nullptr,
              bool control = false, double deadline_s = 0.0);
  // Length-prefixed message atop Send/Recv (controller exchange).
  Status SendMsg(const std::vector<uint8_t>& payload, bool control = true);
  Status RecvMsg(std::vector<uint8_t>& payload, bool control = true,
                 double deadline_s = 0.0);

  // Best-effort tiny frames outside the op stream.
  void SendAbort(uint64_t attempt_epoch);

  // Ring-recovery agreement frames: typed, epoch-keyed, OUTSIDE the op
  // stream — an aborted attempt's residue (partial data frames stashed
  // after the matching op died) can never be misread as an agreement
  // message.  The inbox keeps the latest payload per kind; epochs fence
  // stale attempts.
  Status SendRecoveryFrame(bool verdict, uint64_t epoch,
                           const std::vector<uint8_t>& payload,
                           double deadline_s);
  Status AwaitRecoveryFrame(bool verdict, uint64_t epoch,
                            std::vector<uint8_t>* out, double deadline_s);

  // Listener-thread hand-off: a freshly accepted reconnect (resume) or
  // reset socket for this channel.
  void AdoptResumed(int fd);
  void AdoptReset(int fd, uint64_t generation);
  // Close the current socket and rebuild the link from scratch at
  // `generation` (ring renegotiation: in-flight bytes of the aborted
  // attempt are discarded on both sides).
  Status Reset(uint64_t generation, double deadline_s);

  int peer() const { return peer_; }
  bool connected() const { return fd_.load() >= 0; }
  int fd() const { return fd_.load(); }  // raw-mode duplex poll loop only

 private:
  friend class Network;
  struct Deadline;
  Status WriteFrameVec(int fd, uint32_t magic, uint64_t seq,
                       const uint8_t* payload, size_t n);
  Status RawSend(const uint8_t* buf, size_t n, bool control);
  Status RawRecv(uint8_t* dst, size_t n,
                 const std::function<void(size_t)>& on_progress,
                 bool control);
  // Retransmit the unacked replay tail on a freshly resumed socket
  // (called by the resume completer with the new fd, pre-adoption).
  bool RetransmitReplay(int fd, uint64_t peer_recv_bytes,
                        uint64_t peer_recv_frames);
  Status WriteBytes(int fd, const uint8_t* p, size_t n);
  Status WriteDataFrame(const uint8_t* payload, size_t n, uint64_t seq);
  Status WriteControlFrame(uint32_t magic, uint64_t seq);
  // Reads + dispatches one incoming frame (data -> the registered recv
  // op or the stash; ack -> sender state; abort -> the network's abort
  // flag).  Returns IN_PROGRESS when the poll slice elapsed quietly.
  Status PumpOne(int slice_ms);
  Status Pump(Deadline& dl, bool control, uint64_t op_id, bool for_send);
  Status Recover(uint64_t failed_epoch, Deadline& dl);
  void ApplyResume(uint64_t peer_recv_bytes, uint64_t peer_recv_frames,
                   uint64_t peer_recv_ops);
  void CloseFd();
  void ReapGraveyard();
  bool Aborted() const;

  Network* net_;
  int peer_;
  bool dialer_;  // this side re-dials on reconnect (higher rank dials)
  std::atomic<int> fd_{-1};
  std::atomic<uint64_t> epoch_{0};  // bumps on every adoption
  std::atomic<uint64_t> generation_{0};

  std::mutex wmu_;  // serializes frame writes
  std::mutex rmu_;  // one frame reader at a time
  std::mutex smu_;  // guards the op/resume state below
  // Serializes recv-progress callback invocations: the registering Recv
  // thread (stash drain) and a concurrent dispatcher (the Send thread's
  // opportunistic pump on the SAME channel — 2-member rings / Adasum
  // pairs) may both deliver progress, and the ring's incremental
  // reducer is not thread-safe.  Out-of-order progress values are fine
  // (the reducer ignores non-monotone callbacks); concurrency is not.
  std::mutex cbmu_;
  std::condition_variable cv_;

  // send side.  Sends are OPTIMISTIC: an op completes once its bytes
  // are streamed AND copied into the replay buffer — the ack round-trip
  // leaves the critical path (the old op-granularity ack wait cost one
  // scheduler round-trip per ring step).  Byte-cumulative ACKs prune
  // the replay tail asynchronously; a resume retransmits from it, so
  // the caller's buffer is never needed after Send returns.
  bool send_active_ = false;
  const uint8_t* s_buf_ = nullptr;
  size_t s_total_ = 0, s_off_ = 0;
  uint64_t s_op_start_abs_ = 0;  // send_bytes_ at the active op's start
  uint64_t send_bytes_ = 0;    // cumulative payload bytes streamed
  uint64_t send_frames_ = 0;   // next data frame seq
  uint64_t acked_bytes_ = 0;   // peer-confirmed delivered bytes
  std::vector<uint8_t> replay_;  // unacked tail [replay_base_, send_bytes_)
  size_t replay_off_ = 0;        // consumed prefix of replay_
  uint64_t replay_base_ = 0;     // cumulative offset of replay_[replay_off_]

  // recv side
  bool r_active_ = false;
  uint8_t* r_dst_ = nullptr;
  size_t r_total_ = 0, r_off_ = 0;
  const std::function<void(size_t)>* r_cb_ = nullptr;
  uint64_t recv_ops_ = 0;
  uint64_t recv_bytes_ = 0;   // cumulative fully-delivered payload bytes
  uint64_t recv_frames_ = 0;  // next expected data frame seq
  uint64_t ack_sent_bytes_ = 0;  // recv_bytes_ at the last ACK we sent
  // Delivered bytes awaiting their recv op (the sender streams
  // optimistically, so ring frames routinely land before the matching
  // Recv posts).  Vector + consumed-offset, drained with memcpy — a
  // byte-deque here cost ~500us per 256 KB op.
  std::vector<uint8_t> stash_;
  size_t stash_off_ = 0;

  // Buffered reader (touched only by the rmu_ holder): one recv
  // syscall pulls many small frames (headers, ACKs, control messages) —
  // per-frame recvs tripled the syscall count of a ring step.  Cleared
  // on adoption (epoch change): resume retransmits from the peer's
  // parsed position, so unparsed leftovers are stale duplicates.
  std::vector<uint8_t> rdbuf_;
  size_t rd_off_ = 0, rd_len_ = 0;
  uint64_t rd_epoch_ = 0;

  // ring-recovery agreement inbox (guarded by smu_; latest per kind)
  uint64_t report_epoch_ = 0;
  std::vector<uint8_t> report_;
  uint64_t verdict_epoch_ = 0;
  std::vector<uint8_t> verdict_;

  // recovery
  std::mutex recover_mu_;
  int pending_fd_ = -1;        // adopted socket awaiting a Reset() consumer
  uint64_t pending_gen_ = 0;
  uint64_t chaos_draws_ = 0;   // per-channel deterministic draw index
  bool dead_ = false;          // reconnect refused (blackholed pair)
  // (fd, burial epoch) of shutdown sockets awaiting safe close.
  std::vector<std::pair<int, uint64_t>> graveyard_;
};

class Network {
 public:
  // Establish the full mesh. coord_addr: "host:port" of rank 0's listener.
  // Returns nullptr + error status on failure.
  static std::unique_ptr<Network> Connect(int rank, int size,
                                          const std::string& coord_addr,
                                          Status* status);
  ~Network();

  Channel* chan(int r) { return channels_[r].get(); }
  Channel* coordinator_chan() { return channels_[0].get(); }
  int rank() const { return rank_; }
  int size() const { return size_; }
  const std::vector<std::string>& table() const { return table_; }

  // Same-host shared-memory channels (null when the peer is remote or
  // shm setup failed — callers fall back to the TCP socket).
  ShmChannel* shm_tx(int r) { return shm_tx_[r].get(); }  // me → r
  ShmChannel* shm_rx(int r) { return shm_rx_[r].get(); }  // r → me

  DuplexHelper& duplex_helper() { return duplex_helper_; }

  // --- ring recovery state (collectives.cc) -------------------------------
  // The member order flat ring collectives run in; renegotiation swaps a
  // permutation in so a dead link is never a ring adjacency again.
  std::vector<int> ring_order() const;
  void set_ring_order(const std::vector<int>& order);
  // Collective attempt bookkeeping: every resilient flat collective bumps
  // the epoch; ABORT frames carry the sender's epoch and poison only
  // attempts at or after it (a stale abort from a finished attempt is
  // inert).
  uint64_t BeginAttempt() { return ++attempt_epoch_; }
  uint64_t attempt_epoch() const { return attempt_epoch_.load(); }
  void NoteAbort(uint64_t epoch) {
    uint64_t prev = abort_seen_.load();
    while (epoch > prev && !abort_seen_.compare_exchange_weak(prev, epoch)) {
    }
    abort_cv_notify();
  }
  bool AbortPending() const {
    return abort_seen_.load() >= attempt_epoch_.load() &&
           attempt_epoch_.load() > 0;
  }
  void BroadcastAbort();
  // Dead links this process has proven (reconnect exhausted): fed to the
  // coordinator's ring re-formation.
  void NoteBadLink(int peer);
  std::vector<int> bad_links() const;
  int TakeLastBadPeer();
  // Tear down and re-establish every TCP link at a fresh generation
  // (post-renegotiation resync: discards the aborted attempt's in-flight
  // bytes on both sides of every pair).
  Status MeshReset(double deadline_s);
  uint64_t generation() const { return generation_.load(); }

  void abort_cv_notify() {}
  // A failed world's shutdown: every recovery and wait gives up at once.  // port: failed-world reset
  void Close();  // port: failed-world reset
  bool Closing() const { return closing_.load(); }  // port: failed-world reset

 private:
  friend class Channel;
  Network(int rank, int size) : rank_(rank), size_(size) {
    peers_.resize(size);
    shm_tx_.resize(size);
    shm_rx_.resize(size);
  }
  void SetupShm(const std::vector<std::string>& table,
                const std::string& tag);
  void MakeChannels();
  void ListenerLoop();

  int rank_;
  int size_;
  std::vector<std::unique_ptr<Socket>> peers_;   // init-time only
  std::vector<std::unique_ptr<Channel>> channels_;
  std::vector<std::unique_ptr<ShmChannel>> shm_tx_;
  std::vector<std::unique_ptr<ShmChannel>> shm_rx_;
  std::vector<std::string> table_;  // advertised host:port per rank
  int listen_fd_ = -1;
  std::thread listener_;
  std::atomic<bool> listener_stop_{false};
  DuplexHelper duplex_helper_;

  mutable std::mutex ring_mu_;
  std::vector<int> ring_order_;
  std::atomic<uint64_t> attempt_epoch_{0};
  std::atomic<uint64_t> abort_seen_{0};
  std::atomic<uint64_t> generation_{0};
  std::atomic<bool> closing_{false};  // port: failed-world reset
  mutable std::mutex bad_mu_;
  std::set<int> bad_links_;
  int last_bad_peer_ = -1;
};

}  // namespace hvdtpu
