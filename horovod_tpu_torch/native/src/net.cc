#include "net.h"

#include <arpa/inet.h>
#include <fcntl.h>
#include <net/if.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <sys/ioctl.h>
#include <sys/socket.h>
#include <unistd.h>

#include <cerrno>
#include <cstdio>
#include <algorithm>
#include <chrono>
#include <cstdlib>
#include <cstring>

namespace hvdtpu {

// ---------------------------------------------------------------------------
// Resilience / chaos configuration + counters
// ---------------------------------------------------------------------------

namespace {

const char* EnvOr(const char* hvd, const char* legacy = nullptr) {
  const char* v = getenv(hvd);
  if (!v && legacy) v = getenv(legacy);
  return v;
}

double EnvDouble(const char* name, double dflt) {
  const char* v = EnvOr(name);
  return (v && *v) ? atof(v) : dflt;
}

bool EnvBool(const char* name, bool dflt) {
  const char* v = EnvOr(name);
  if (!v || !*v) return dflt;
  return !(strcmp(v, "0") == 0 || strcasecmp(v, "false") == 0 ||
           strcasecmp(v, "off") == 0 || strcasecmp(v, "no") == 0);
}

}  // namespace

const NetResilienceConfig& NetResilience() {
  static const NetResilienceConfig cfg = [] {
    NetResilienceConfig c;
    c.enabled = EnvBool("HVD_TPU_NET_RESILIENCE", true);
    c.probe_ms = EnvDouble("HVD_TPU_NET_PROBE_MS", c.probe_ms);
    c.reconnect_s = EnvDouble("HVD_TPU_NET_RECONNECT_S", c.reconnect_s);
    c.op_deadline_s =
        EnvDouble("HVD_TPU_NET_OP_DEADLINE_S", c.op_deadline_s);
    c.max_renegotiations = static_cast<int>(
        EnvDouble("HVD_TPU_NET_MAX_RENEG", c.max_renegotiations));
    c.renegotiate = EnvBool("HVD_TPU_NET_RENEGOTIATE", true);
    return c;
  }();
  return cfg;
}

const NetChaosConfig& NetChaos() {
  static const NetChaosConfig cfg = [] {
    NetChaosConfig c;
    c.seed = static_cast<uint64_t>(
        EnvDouble("HVD_TPU_CHAOS_NET_SEED", 0));
    c.drop_pct = EnvDouble("HVD_TPU_CHAOS_NET_DROP_PCT", 0);
    c.reset_pct = EnvDouble("HVD_TPU_CHAOS_NET_RESET_PCT", 0);
    c.delay_ms = EnvDouble("HVD_TPU_CHAOS_NET_DELAY_MS", 0);
    c.truncate_pct = EnvDouble("HVD_TPU_CHAOS_NET_TRUNCATE", 0);
    if (const char* bh = EnvOr("HVD_TPU_CHAOS_NET_BLACKHOLE")) {
      std::string s(bh);
      size_t pos = 0;
      while (pos < s.size()) {
        size_t end = s.find(',', pos);
        if (end == std::string::npos) end = s.size();
        std::string tok = s.substr(pos, end - pos);
        size_t dash = tok.find('-');
        if (dash != std::string::npos) {
          int a = atoi(tok.substr(0, dash).c_str());
          int b = atoi(tok.substr(dash + 1).c_str());
          c.blackhole.insert({std::min(a, b), std::max(a, b)});
        }
        pos = end + 1;
      }
    }
    return c;
  }();
  return cfg;
}

// splitmix64 over (seed, rank, peer, index): platform-independent and
// identical on every incarnation — the same determinism contract as the
// Python recovery chaos layer's sha256 draws.
double NetChaosDraw(uint64_t seed, int rank, int peer, uint64_t index) {
  uint64_t x = seed * 0x9E3779B97F4A7C15ull + 0xBF58476D1CE4E5B9ull;
  x ^= (static_cast<uint64_t>(rank) << 32) ^
       (static_cast<uint64_t>(static_cast<uint32_t>(peer)));
  x += index * 0x94D049BB133111EBull;
  x ^= x >> 30; x *= 0xBF58476D1CE4E5B9ull;
  x ^= x >> 27; x *= 0x94D049BB133111EBull;
  x ^= x >> 31;
  return static_cast<double>(x >> 11) / 9007199254740992.0;  // [0, 1)
}

NetCountersState& NetCounters() {
  static NetCountersState* s = new NetCountersState();
  return *s;
}

// HVD_TPU_NET_TRACE=1: recovery-path stderr traces (debug aid; off in
// production — the hot path never calls this when disabled).
bool NetTrace() {
  static const bool on = [] {
    const char* v = getenv("HVD_TPU_NET_TRACE");
    return v && *v && strcmp(v, "0") != 0;
  }();
  return on;
}

#define NET_TRACE(fmt, ...)                                              \
  do {                                                                   \
    if (NetTrace())                                                      \
      fprintf(stderr, "[hvdnet r%d p%d] " fmt "\n", net_->rank(), peer_, \
              ##__VA_ARGS__);                                            \
  } while (0)

int64_t SteadyNowMs() {
  return std::chrono::duration_cast<std::chrono::milliseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// ---------------------------------------------------------------------------
// Raw socket helpers
// ---------------------------------------------------------------------------

Socket::~Socket() {
  if (fd_ >= 0) ::close(fd_);
}

Status Socket::SendAll(const void* data, size_t n) {
  const uint8_t* p = static_cast<const uint8_t*>(data);
  while (n > 0) {
    ssize_t k = ::send(fd_, p, n, MSG_NOSIGNAL);
    if (k < 0) {
      if (errno == EINTR) continue;
      return Status::Error(std::string("send: ") + strerror(errno));
    }
    p += k;
    n -= k;
  }
  return Status::OK();
}

Status Socket::RecvAll(void* data, size_t n) {
  uint8_t* p = static_cast<uint8_t*>(data);
  while (n > 0) {
    ssize_t k = ::recv(fd_, p, n, 0);
    if (k < 0) {
      if (errno == EINTR) continue;
      return Status::Error(std::string("recv: ") + strerror(errno));
    }
    if (k == 0) return Status::Aborted("peer closed connection");
    p += k;
    n -= k;
  }
  return Status::OK();
}

Status Socket::SendFrame(const std::vector<uint8_t>& payload) {
  uint32_t len = static_cast<uint32_t>(payload.size());
  Status s = SendAll(&len, 4);
  if (!s.ok()) return s;
  return SendAll(payload.data(), payload.size());
}

Status Socket::RecvFrame(std::vector<uint8_t>& payload) {
  uint32_t len = 0;
  Status s = RecvAll(&len, 4);
  if (!s.ok()) return s;
  payload.resize(len);
  return RecvAll(payload.data(), len);
}

namespace {

void SetNoDelay(int fd) {
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  // Large kernel buffers keep the full-duplex ring streaming instead of
  // stalling on flow control (both directions carry MBs per step).
  // (No socket-level SO_SNDTIMEO/RCVTIMEO: control-plane waits — e.g. a
  // worker blocking on the address table while slow peers start up — are
  // legitimately longer than any collective timeout; the collective paths
  // bound their own waits with poll().)
  int bufsz = 4 << 20;
  setsockopt(fd, SOL_SOCKET, SO_SNDBUF, &bufsz, sizeof(bufsz));
  setsockopt(fd, SOL_SOCKET, SO_RCVBUF, &bufsz, sizeof(bufsz));
}

int Listen(uint16_t port, uint16_t* bound_port) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(port);
  if (::bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0 ||
      ::listen(fd, 64) < 0) {
    ::close(fd);
    return -1;
  }
  socklen_t len = sizeof(addr);
  getsockname(fd, reinterpret_cast<sockaddr*>(&addr), &len);
  *bound_port = ntohs(addr.sin_port);
  return fd;
}

// Non-blocking connect bounded by timeout_s; on success the socket is
// returned in blocking mode.  Bounding connect() itself matters: against a
// black-holed address a blocking connect sits in the kernel SYN retry for
// minutes, which would blow any caller-side deadline.
static int ConnectTimeout(const addrinfo* res, double timeout_s) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  int flags = fcntl(fd, F_GETFL, 0);
  fcntl(fd, F_SETFL, flags | O_NONBLOCK);
  int rc = ::connect(fd, res->ai_addr, res->ai_addrlen);
  if (rc != 0) {
    if (errno != EINPROGRESS) {
      ::close(fd);
      return -1;
    }
    pollfd pfd{fd, POLLOUT, 0};
    int ms = static_cast<int>(timeout_s * 1000);
    if (poll(&pfd, 1, ms > 0 ? ms : 1) != 1) {
      ::close(fd);
      return -1;
    }
    int err = 0;
    socklen_t len = sizeof(err);
    if (getsockopt(fd, SOL_SOCKET, SO_ERROR, &err, &len) != 0 || err != 0) {
      ::close(fd);
      return -1;
    }
  }
  fcntl(fd, F_SETFL, flags);  // back to blocking for the frame protocol
  return fd;
}

bool ParseAddr(const std::string& addr, std::string* host, uint16_t* port) {
  auto pos = addr.rfind(':');
  if (pos == std::string::npos) return false;
  *host = addr.substr(0, pos);
  *port = static_cast<uint16_t>(atoi(addr.c_str() + pos + 1));
  return true;
}

int DialOnce(const std::string& host, uint16_t port, double timeout_s) {
  addrinfo hints{}, *res = nullptr;
  hints.ai_family = AF_INET;
  hints.ai_socktype = SOCK_STREAM;
  char portstr[16];
  snprintf(portstr, sizeof(portstr), "%u", port);
  if (getaddrinfo(host.c_str(), portstr, &hints, &res) != 0 || !res)
    return -1;
  int fd = ConnectTimeout(res, timeout_s);
  freeaddrinfo(res);
  if (fd >= 0) SetNoDelay(fd);
  return fd;
}

int DialRetry(const std::string& host, uint16_t port, int attempts = 600) {
  // --start-timeout: bound how long workers wait for the coordinator (and
  // for peer-mesh dials during startup) — reference horovodrun
  // --start-timeout; default stays ~60 s.  Deadline-based: retries plus
  // DNS/connect time all count against the budget.
  double timeout_s = attempts * 0.1;
  const char* st = getenv("HVD_TPU_START_TIMEOUT");
  if (!st) st = getenv("HOROVOD_START_TIMEOUT");
  if (st && atof(st) > 0) timeout_s = atof(st);
  auto deadline = std::chrono::steady_clock::now() +
      std::chrono::duration<double>(timeout_s);
  while (std::chrono::steady_clock::now() < deadline) {
    double remaining = std::chrono::duration<double>(
        deadline - std::chrono::steady_clock::now()).count();
    int fd = DialOnce(host, port, std::min(remaining, 2.0));
    if (fd >= 0) return fd;
    usleep(100000);  // coordinator may not be up yet; retry until deadline
  }
  return -1;
}

std::string LocalHostname() {
  // HVD_TPU_IFACE / HOROVOD_GLOO_IFACE: advertise this interface's IPv4
  // to peers instead of the hostname (reference --network-interface /
  // HOROVOD_GLOO_IFACE semantics — on multi-NIC hosts gethostname() may
  // resolve to an address peers cannot route to).
  const char* ifn = getenv("HVD_TPU_IFACE");
  if (!ifn || !*ifn) ifn = getenv("HOROVOD_GLOO_IFACE");
  if (ifn && *ifn) {
    int fd = ::socket(AF_INET, SOCK_DGRAM, 0);
    if (fd >= 0) {
      ifreq ifr{};
      strncpy(ifr.ifr_name, ifn, IFNAMSIZ - 1);
      bool ok = ioctl(fd, SIOCGIFADDR, &ifr) == 0;
      ::close(fd);
      if (ok) {
        auto* sin = reinterpret_cast<sockaddr_in*>(&ifr.ifr_addr);
        char abuf[INET_ADDRSTRLEN];
        if (inet_ntop(AF_INET, &sin->sin_addr, abuf, sizeof(abuf))) {
          return abuf;
        }
      }
    }
  }
  char buf[256];
  if (gethostname(buf, sizeof(buf)) == 0) return buf;
  return "127.0.0.1";
}

// --- resilient frame wire format -------------------------------------------

constexpr uint32_t kMagicData = 0x48444154;   // 'HDAT'
constexpr uint32_t kMagicAck = 0x4841434Bu;   // 'HACK'
constexpr uint32_t kMagicAbort = 0x48414254;  // 'HABT'
constexpr uint32_t kMagicHello = 0x48454C4F;  // 'HELO'  (resume)
constexpr uint32_t kMagicHelloReset = 0x48525354;  // 'HRST' (fresh link)
constexpr uint32_t kMagicReport = 0x48524550;      // 'HREP' (agreement)
constexpr uint32_t kMagicVerdict = 0x48564552;     // 'HVER' (agreement)

struct FrameHdr {
  uint32_t magic;
  uint32_t len;
  uint64_t seq;
};

struct HelloWire {
  uint32_t magic;
  int32_t rank;
  uint64_t generation;
};

struct ResumeWire {
  uint64_t recv_bytes;
  uint64_t recv_frames;
  uint64_t recv_ops;
};

constexpr size_t kFrameChunk = 1 << 20;
constexpr int kPumpSliceMs = 100;
// cv fallback when another thread holds the reader lock: bounded SHORT —
// a waiter that lost the try_lock race by a hair must not sleep until
// the next dispatch happens to notify it (measured ~+100us per op).
constexpr int kPumpWaitMs = 2;
// Unacked-send replay cap: a sender may run this far ahead of the
// receiver's acks before it must block and drain them.  Covers the
// default 64 MB fusion buffer's largest ring segment with room to
// spare.
constexpr size_t kReplayCap = 64u << 20;
// Ops up to this size complete optimistically (bytes copied into the
// replay buffer; the ack round-trip leaves the critical path — it is
// what dominates small ring steps).  Larger ops stream zero-copy and
// ack-wait at the end: the RTT is amortized by the transfer itself and
// the replay memcpy would be the new per-byte tax.
constexpr size_t kOptimisticMax = 256u << 10;
// ACK cadence: small-op receivers batch their delivery acks until this
// many bytes accumulate — per-op acks doubled the syscall count of a
// ring step for no correctness gain (resume exchanges recv_bytes_
// directly; acks only prune the sender's replay tail).  Ops at or above
// kOptimisticMax always ack at completion: their sender is waiting.
constexpr uint64_t kAckEveryBytes = 1u << 20;

bool IoAllTimeout(int fd, void* buf, size_t n, int ms, bool write) {
  // I/O-first: syscalls dominate on sandboxed kernels, so attempt the
  // transfer directly and fall back to poll() only on EAGAIN.
  uint8_t* p = static_cast<uint8_t*>(buf);
  auto end = std::chrono::steady_clock::now() +
             std::chrono::milliseconds(ms);
  size_t done = 0;
  while (done < n) {
    ssize_t k = write
        ? ::send(fd, p + done, n - done, MSG_NOSIGNAL | MSG_DONTWAIT)
        : ::recv(fd, p + done, n - done, MSG_DONTWAIT);
    if (k > 0) {
      done += k;
      continue;
    }
    if (k == 0 && !write) return false;
    if (k < 0 && errno != EINTR && errno != EAGAIN &&
        errno != EWOULDBLOCK)
      return false;
    int left = static_cast<int>(
        std::chrono::duration_cast<std::chrono::milliseconds>(
            end - std::chrono::steady_clock::now())
            .count());
    if (left <= 0) return false;
    pollfd pfd{fd, static_cast<short>(write ? POLLOUT : POLLIN), 0};
    int pr = ::poll(&pfd, 1, left);
    if (pr < 0 && errno == EINTR) continue;
    if (pr <= 0) return false;
  }
  return true;
}

}  // namespace

// ---------------------------------------------------------------------------
// Channel
// ---------------------------------------------------------------------------

struct Channel::Deadline {
  std::chrono::steady_clock::time_point end;
  bool infinite = false;
  static Deadline After(double seconds) {
    Deadline d;
    if (seconds <= 0) {
      d.infinite = true;
    } else {
      d.end = std::chrono::steady_clock::now() +
              std::chrono::duration_cast<std::chrono::steady_clock::duration>(
                  std::chrono::duration<double>(seconds));
    }
    return d;
  }
  bool expired() const {
    return !infinite && std::chrono::steady_clock::now() >= end;
  }
  double remaining_s() const {
    if (infinite) return 3600.0;
    return std::chrono::duration<double>(
               end - std::chrono::steady_clock::now())
        .count();
  }
};

Channel::Channel(Network* net, int peer, int fd)
    : net_(net), peer_(peer), dialer_(net->rank() > peer), fd_(fd) {}

Channel::~Channel() {
  int fd = fd_.exchange(-1);
  if (fd >= 0) ::close(fd);
  if (pending_fd_ >= 0) ::close(pending_fd_);
  for (auto& g : graveyard_) ::close(g.first);
}

void Channel::CloseFd() {
  NET_TRACE("closefd");
  // shutdown, don't close yet: a concurrent op thread may still hold this
  // fd number in a poll set, and closing would let the kernel reuse the
  // number for the REPLACEMENT socket — the blocked thread would then
  // read the resumed stream.  shutdown() wakes every blocked syscall on
  // it immediately; the number itself is reclaimed once two adoption
  // epochs have passed (ReapGraveyard) — by then no op loop can still be
  // between capturing the fd and its next syscall on it.
  int fd = fd_.exchange(-1);
  if (fd >= 0) {
    ::shutdown(fd, SHUT_RDWR);
    std::lock_guard<std::mutex> lk(smu_);
    graveyard_.push_back({fd, epoch_.load()});
  }
}

void Channel::ReapGraveyard() {
  std::lock_guard<std::mutex> lk(smu_);
  uint64_t cur = epoch_.load();
  size_t kept = 0;
  for (auto& g : graveyard_) {
    if (g.second + 2 <= cur) {
      ::close(g.first);
    } else {
      graveyard_[kept++] = g;
    }
  }
  graveyard_.resize(kept);
}

bool Channel::Aborted() const { return net_->AbortPending(); }

Status Channel::WriteBytes(int fd, const uint8_t* p, size_t n) {
  struct WT { std::chrono::steady_clock::time_point t0;
              ~WT() { NetCounters().write_us +=
                  std::chrono::duration_cast<std::chrono::microseconds>(
                      std::chrono::steady_clock::now() - t0).count(); }
  } _wt{std::chrono::steady_clock::now()};
  size_t sent = 0;
  while (sent < n) {
    ssize_t k = ::send(fd, p + sent,
                       std::min<size_t>(n - sent, kFrameChunk),
                       MSG_NOSIGNAL | MSG_DONTWAIT);
    if (k > 0) {
      sent += k;
      continue;
    }
    if (k < 0 && errno != EINTR && errno != EAGAIN &&
        errno != EWOULDBLOCK)
      return Status::Error(std::string("net: send failed: ") +
                           strerror(errno));
    pollfd pfd{fd, POLLOUT, 0};
    int pr = ::poll(&pfd, 1, 60000);
    if (pr < 0 && errno == EINTR) continue;
    if (pr <= 0) return Status::Error("net: send poll timeout");
  }
  return Status::OK();
}

// One gathered write per frame (header + payload in a single sendmsg):
// on sandboxed kernels every syscall costs tens of microseconds, so the
// frame protocol must not double them.
Status Channel::WriteFrameVec(int fd, uint32_t magic, uint64_t seq,
                              const uint8_t* payload, size_t n) {
  FrameHdr hdr{magic, static_cast<uint32_t>(n), seq};
  struct FT { Channel* c; uint32_t m; bool ok = false;
              ~FT() { if (!ok) {
                  if (getenv("HVD_TPU_NET_TRACE"))
                    fprintf(stderr, "[hvdnet] writeframe FAILED magic=%08x\n", m);
              } } } _ft{this, magic};
  struct iovec iov[2];
  iov[0].iov_base = &hdr;
  iov[0].iov_len = sizeof(hdr);
  iov[1].iov_base = const_cast<uint8_t*>(payload);
  iov[1].iov_len = n;
  struct msghdr msg {};
  msg.msg_iov = iov;
  msg.msg_iovlen = n > 0 ? 2 : 1;
  size_t total = sizeof(hdr) + n;
  size_t sent = 0;
  while (sent < total) {
    ssize_t k = ::sendmsg(fd, &msg, MSG_NOSIGNAL | MSG_DONTWAIT);
    if (k > 0) {
      sent += k;
      if (sent >= total) break;
      // Advance the iovecs past the bytes the kernel took.
      size_t skip = static_cast<size_t>(k);
      while (skip > 0 && msg.msg_iovlen > 0) {
        if (skip >= msg.msg_iov[0].iov_len) {
          skip -= msg.msg_iov[0].iov_len;
          msg.msg_iov++;
          msg.msg_iovlen--;
        } else {
          msg.msg_iov[0].iov_base =
              static_cast<uint8_t*>(msg.msg_iov[0].iov_base) + skip;
          msg.msg_iov[0].iov_len -= skip;
          skip = 0;
        }
      }
      continue;
    }
    if (k < 0 && errno != EINTR && errno != EAGAIN &&
        errno != EWOULDBLOCK)
      return Status::Error(std::string("net: send failed: ") +
                           strerror(errno));
    pollfd pfd{fd, POLLOUT, 0};
    int pr = ::poll(&pfd, 1, 60000);
    if (pr < 0 && errno == EINTR) continue;
    if (pr <= 0) return Status::Error("net: send poll timeout");
  }
  _ft.ok = true;
  return Status::OK();
}

Status Channel::WriteDataFrame(const uint8_t* payload, size_t n,
                               uint64_t seq) {
  std::lock_guard<std::mutex> lk(wmu_);
  int fd = fd_.load();
  if (fd < 0) return Status::Error("net: connection down");
  const NetChaosConfig& chaos = NetChaos();
  if (chaos.enabled()) {
    uint64_t idx = chaos_draws_++;
    if (chaos.delay_ms > 0) usleep(static_cast<int>(chaos.delay_ms * 1000));
    if (chaos.reset_pct > 0 &&
        NetChaosDraw(chaos.seed, net_->rank(), peer_, idx * 4 + 1) * 100.0 <
            chaos.reset_pct) {
      NetCounters().chaos_injected++;
      NET_TRACE("chaos reset seq=%llu", (unsigned long long)seq);
      CloseFd();
      return Status::Error("net: chaos connection reset");
    }
    if (chaos.drop_pct > 0 && NetResilience().enabled &&
        NetChaosDraw(chaos.seed, net_->rank(), peer_, idx * 4 + 2) * 100.0 <
            chaos.drop_pct) {
      // Swallow the frame: the receiver detects the sequence gap on the
      // next frame (or a stall on the last) and forces reconnect-resume.
      NetCounters().chaos_injected++;
      NET_TRACE("chaos drop seq=%llu len=%zu", (unsigned long long)seq, n);
      return Status::OK();
    }
    if (chaos.truncate_pct > 0 && NetResilience().enabled &&
        NetChaosDraw(chaos.seed, net_->rank(), peer_, idx * 4 + 3) * 100.0 <
            chaos.truncate_pct) {
      NetCounters().chaos_injected++;
      FrameHdr hdr{kMagicData, static_cast<uint32_t>(n), seq};
      WriteBytes(fd, reinterpret_cast<const uint8_t*>(&hdr), sizeof(hdr));
      WriteBytes(fd, payload, n / 2);
      CloseFd();
      return Status::Error("net: chaos truncated frame");
    }
  }
  return WriteFrameVec(fd, kMagicData, seq, payload, n);
}

Status Channel::WriteControlFrame(uint32_t magic, uint64_t seq) {
  std::lock_guard<std::mutex> lk(wmu_);
  int fd = fd_.load();
  if (fd < 0) return Status::Error("net: connection down");
  return WriteFrameVec(fd, magic, seq, nullptr, 0);
}

void Channel::SendAbort(uint64_t attempt_epoch) {
  if (fd_.load() < 0 || dead_) return;
  WriteControlFrame(kMagicAbort, attempt_epoch);  // best-effort
}

Status Channel::SendRecoveryFrame(bool verdict, uint64_t epoch,
                                  const std::vector<uint8_t>& payload,
                                  double deadline_s) {
  Deadline dl = Deadline::After(deadline_s);
  const uint32_t magic = verdict ? kMagicVerdict : kMagicReport;
  for (;;) {
    uint64_t ep = epoch_.load();
    Status st;
    {
      std::lock_guard<std::mutex> lk(wmu_);
      int fd = fd_.load();
      if (fd < 0) {
        st = Status::Error("net: connection down");
      } else {
        st = WriteFrameVec(fd, magic, epoch, payload.data(),
                           payload.size());
      }
    }
    if (st.ok()) return st;
    if (dl.expired())
      return Status::Retry("net: recovery frame send deadline to rank " +
                           std::to_string(peer_));
    Status rs = Recover(ep, dl);
    if (!rs.ok()) return rs;
  }
}

Status Channel::AwaitRecoveryFrame(bool verdict, uint64_t epoch,
                                   std::vector<uint8_t>* out,
                                   double deadline_s) {
  Deadline dl = Deadline::After(deadline_s);
  auto last_progress = std::chrono::steady_clock::now();
  for (;;) {
    if (net_->Closing()) return Status::Error("net: the runtime is shutting down");  // port: failed-world reset
    uint64_t ep = epoch_.load();
    {
      std::lock_guard<std::mutex> lk(smu_);
      uint64_t have = verdict ? verdict_epoch_ : report_epoch_;
      if (have >= epoch) {
        *out = verdict ? verdict_ : report_;
        return Status::OK();
      }
    }
    if (dl.expired())
      return Status::Retry("net: recovery agreement deadline from rank " +
                           std::to_string(peer_));
    Status st;
    if (rmu_.try_lock()) {
      st = PumpOne(kPumpSliceMs);
      rmu_.unlock();
      if (st.type == StatusType::IN_PROGRESS) st = Status::OK();
    } else {
      std::unique_lock<std::mutex> lk(smu_);
      cv_.wait_for(lk, std::chrono::milliseconds(kPumpSliceMs));
      st = Status::OK();
    }
    bool stalled =
        dialer_ &&
        std::chrono::duration<double>(std::chrono::steady_clock::now() -
                                      last_progress)
                .count() *
                1000.0 >
            std::max(NetResilience().probe_ms, 1000.0);
    if (!st.ok() || stalled) {
      Status rs = Recover(ep, dl);
      if (!rs.ok()) return rs;
      last_progress = std::chrono::steady_clock::now();
    }
  }
}

// Reads and dispatches exactly one frame (caller holds rmu_).
constexpr size_t kRdBufCap = 64u << 10;

Status Channel::PumpOne(int slice_ms) {
  int fd = fd_.load();
  if (fd < 0) return Status::Error("net: connection down");
  auto _t0 = std::chrono::steady_clock::now();
  struct ReadT { std::chrono::steady_clock::time_point t0;
                 ~ReadT() { NetCounters().pump_read_us +=
                     std::chrono::duration_cast<std::chrono::microseconds>(
                         std::chrono::steady_clock::now() - t0).count(); }
  } _rt{_t0};
  if (rdbuf_.empty()) rdbuf_.resize(kRdBufCap);
  if (rd_epoch_ != epoch_.load()) {
    // Fresh connection: unparsed leftovers belong to the dead one and
    // the resume already retransmits from our parsed position.
    rd_off_ = rd_len_ = 0;
    rd_epoch_ = epoch_.load();
  }
  auto rd_avail = [&] { return rd_len_ - rd_off_; };
  // One batched refill: pull whatever the socket holds (many small
  // frames per syscall).  wait_ms bounds the poll when the socket is
  // dry; 0 bytes within it -> IN_PROGRESS.
  auto refill = [&](int wait_ms) -> int {
    if (rd_off_ > 0) {
      memmove(rdbuf_.data(), rdbuf_.data() + rd_off_, rd_avail());
      rd_len_ -= rd_off_;
      rd_off_ = 0;
    }
    for (;;) {
      ssize_t k = ::recv(fd, rdbuf_.data() + rd_len_,
                         rdbuf_.size() - rd_len_, MSG_DONTWAIT);
      if (k > 0) {
        rd_len_ += k;
        return 1;
      }
      if (k == 0) return -1;  // peer closed
      if (errno != EINTR && errno != EAGAIN && errno != EWOULDBLOCK)
        return -1;
      if (wait_ms <= 0) return 0;
      auto _p0 = std::chrono::steady_clock::now();
      pollfd pfd{fd, POLLIN, 0};
      int pr = ::poll(&pfd, 1, wait_ms);
      NetCounters().pump_wait_us +=
          std::chrono::duration_cast<std::chrono::microseconds>(
              std::chrono::steady_clock::now() - _p0).count();
      if (pr < 0 && errno == EINTR) return 0;
      if (pr <= 0) return 0;
      wait_ms = 0;  // readable now: one more recv, then report
    }
  };
  const int frame_ms =
      std::max(1000, static_cast<int>(NetResilience().probe_ms));
  if (rd_avail() < sizeof(FrameHdr)) {
    int rc = refill(slice_ms);
    if (rc < 0) return Status::Error("net: peer closed");
    if (rd_avail() == 0) return Status{StatusType::IN_PROGRESS, ""};
    // Partial header: the rest must land within the probe window — a
    // frame stuck half-delivered IS a faulty link.
    auto end = std::chrono::steady_clock::now() +
               std::chrono::milliseconds(frame_ms);
    while (rd_avail() < sizeof(FrameHdr)) {
      int left = static_cast<int>(
          std::chrono::duration_cast<std::chrono::milliseconds>(
              end - std::chrono::steady_clock::now()).count());
      if (left <= 0 || refill(left) < 0) {
        NET_TRACE("pump: lost mid-header avail=%zu", rd_avail());
        return Status::Error("net: connection lost mid-frame");
      }
    }
  }
  FrameHdr hdr;
  memcpy(&hdr, rdbuf_.data() + rd_off_, sizeof(hdr));
  rd_off_ += sizeof(hdr);
  // Consume `len` payload bytes into dst (buffer first, then direct
  // socket reads for the remainder — large payloads never take a
  // staging copy beyond what was already batched).
  auto consume = [&](uint8_t* dst, size_t len) -> bool {
    size_t from_buf = std::min(len, rd_avail());
    if (from_buf > 0) {
      memcpy(dst, rdbuf_.data() + rd_off_, from_buf);
      rd_off_ += from_buf;
    }
    if (len > from_buf) {
      if (!IoAllTimeout(fd, dst + from_buf, len - from_buf, frame_ms,
                        false))
        return false;
    }
    return true;
  };
  if (hdr.magic == kMagicAck) {
    // Byte-cumulative delivery ack: prune the replay tail up to it.
    // Clamp to the bytes actually held — large zero-copy ops advance
    // send/ack byte counters WITHOUT passing through the replay buffer.
    std::lock_guard<std::mutex> lk(smu_);
    if (hdr.seq > acked_bytes_) {
      acked_bytes_ = hdr.seq;
      if (acked_bytes_ > replay_base_) {
        size_t avail = replay_.size() - replay_off_;
        uint64_t want = acked_bytes_ - replay_base_;
        size_t drop = want > avail ? avail : static_cast<size_t>(want);
        replay_off_ += drop;
        replay_base_ = acked_bytes_;
        if (replay_off_ == replay_.size()) {
          replay_.clear();
          replay_off_ = 0;
        } else if (replay_off_ > (8u << 20) &&
                   replay_off_ * 2 >= replay_.size()) {
          replay_.erase(replay_.begin(),
                        replay_.begin() + replay_off_);
          replay_off_ = 0;
        }
      }
    }
    cv_.notify_all();
    return Status::OK();
  }
  if (hdr.magic == kMagicAbort) {
    net_->NoteAbort(hdr.seq);
    cv_.notify_all();
    return Status::OK();
  }
  if (hdr.magic == kMagicReport || hdr.magic == kMagicVerdict) {
    // Agreement frames live OUTSIDE the op stream (no data seq, no op
    // accounting) so an aborted attempt's residue can never displace or
    // impersonate them.  Latest payload per kind wins, fenced by epoch.
    if (hdr.len > 4096)
      return Status::Error("net: oversized recovery frame");
    std::vector<uint8_t> tmp(hdr.len);
    if (hdr.len > 0 && !consume(tmp.data(), hdr.len))
      return Status::Error("net: connection lost mid-frame");
    {
      std::lock_guard<std::mutex> lk(smu_);
      if (hdr.magic == kMagicReport) {
        if (hdr.seq >= report_epoch_) {
          report_epoch_ = hdr.seq;
          report_ = std::move(tmp);
        }
      } else if (hdr.seq >= verdict_epoch_) {
        verdict_epoch_ = hdr.seq;
        verdict_ = std::move(tmp);
      }
      cv_.notify_all();
    }
    return Status::OK();
  }
  if (hdr.magic != kMagicData || hdr.len > (64u << 20)) {
    NET_TRACE("pump: corrupt header magic=%08x len=%u seq=%llu",
              hdr.magic, hdr.len, (unsigned long long)hdr.seq);
    return Status::Error("net: corrupt frame header");
  }
  uint8_t* direct = nullptr;
  {
    std::lock_guard<std::mutex> lk(smu_);
    if (hdr.seq != recv_frames_) {
      NET_TRACE("seq gap: got=%llu want=%llu len=%u",
                (unsigned long long)hdr.seq,
                (unsigned long long)recv_frames_, hdr.len);
      return Status::Error("net: data frame sequence gap (frame dropped "
                           "or stream desynchronized)");
    }
    if (r_active_ && r_total_ - r_off_ >= hdr.len &&
        stash_.size() == stash_off_)
      direct = r_dst_ + r_off_;
  }
  if (direct != nullptr) {
    if (!consume(direct, hdr.len))
      return Status::Error("net: connection lost mid-frame");
    const std::function<void(size_t)>* cb = nullptr;
    size_t progress = 0;
    {
      std::lock_guard<std::mutex> lk(smu_);
      r_off_ += hdr.len;
      recv_bytes_ += hdr.len;
      recv_frames_++;
      if (r_cb_) { cb = r_cb_; progress = r_off_; }
      cv_.notify_all();
    }
    if (cb && *cb) {
    std::lock_guard<std::mutex> cl(cbmu_);
    (*cb)(progress);
  }
    return Status::OK();
  }
  std::vector<uint8_t> tmp(hdr.len);
  if (!consume(tmp.data(), hdr.len))
    return Status::Error("net: connection lost mid-frame");
  const std::function<void(size_t)>* cb = nullptr;
  size_t progress = 0;
  {
    std::lock_guard<std::mutex> lk(smu_);
    stash_.insert(stash_.end(), tmp.begin(), tmp.end());
    recv_bytes_ += hdr.len;
    recv_frames_++;
    // A resume retransmission coalesces several ops' bytes into one
    // frame, which the direct path above rejects (larger than the
    // active op's remainder) — feed the active op from the stash here,
    // or it would starve waiting for bytes that already arrived.
    if (r_active_ && r_off_ < r_total_) {
      size_t avail = stash_.size() - stash_off_;
      size_t take = std::min(avail, r_total_ - r_off_);
      if (take > 0) {
        memcpy(r_dst_ + r_off_, stash_.data() + stash_off_, take);
        stash_off_ += take;
        r_off_ += take;
        if (stash_off_ == stash_.size()) {
          stash_.clear();
          stash_off_ = 0;
        }
        if (r_cb_) { cb = r_cb_; progress = r_off_; }
      }
    }
    cv_.notify_all();
  }
  if (cb && *cb) {
    std::lock_guard<std::mutex> cl(cbmu_);
    (*cb)(progress);
  }
  return Status::OK();
}

// One wait-or-dispatch step for an op loop: become the frame reader if
// nobody else is, otherwise wait for their dispatch to make progress.
Status Channel::Pump(Deadline& dl, bool control, uint64_t /*op_id*/,
                     bool /*for_send*/) {
  if (net_->Closing()) return Status::Error("net: the runtime is shutting down");  // port: failed-world reset
  if (!control && Aborted())
    return Status::Retry("net: collective attempt aborted by a peer");
  if (rmu_.try_lock()) {
    Status st = PumpOne(kPumpSliceMs);
    rmu_.unlock();
    if (st.type == StatusType::IN_PROGRESS) return Status::OK();
    if (!st.ok())
      NET_TRACE("pump error: %s", st.reason.c_str());
    return st;
  }
  auto _t0 = std::chrono::steady_clock::now();
  std::unique_lock<std::mutex> lk(smu_);
  cv_.wait_for(lk, std::chrono::milliseconds(kPumpWaitMs));
  NetCounters().cvwait_us +=
      std::chrono::duration_cast<std::chrono::microseconds>(
          std::chrono::steady_clock::now() - _t0).count();
  return Status::OK();
}

void Channel::ApplyResume(uint64_t peer_recv_bytes,
                          uint64_t peer_recv_frames,
                          uint64_t peer_recv_ops) {
  (void)peer_recv_ops;
  std::lock_guard<std::mutex> lk(smu_);
  NET_TRACE("apply resume: peer rb=%llu rf=%llu (my sb=%llu sf=%llu "
            "acked=%llu)",
            (unsigned long long)peer_recv_bytes,
            (unsigned long long)peer_recv_frames,
            (unsigned long long)send_bytes_,
            (unsigned long long)send_frames_,
            (unsigned long long)acked_bytes_);
  if (peer_recv_bytes > acked_bytes_) acked_bytes_ = peer_recv_bytes;
  send_frames_ = peer_recv_frames;
  cv_.notify_all();
}

// Retransmit the unacked tail [peer_recv_bytes, send_bytes_) from the
// replay buffer onto a freshly resumed socket.  Called by the resume
// completer BEFORE the fd is adopted, so no other writer can interleave.
bool Channel::RetransmitReplay(int fd, uint64_t peer_recv_bytes,
                               uint64_t peer_recv_frames) {
  // The missing span [peer_recv_bytes, send_bytes_) is covered by two
  // sources: the replay buffer (optimistic small ops) and, beyond it,
  // the still-live caller buffer of an active zero-copy large op —
  // that part is not re-sent here; the op's streaming loop re-runs
  // from the rewound offset once the fresh socket is adopted.
  std::vector<uint8_t> tail;
  {
    std::lock_guard<std::mutex> lk(smu_);
    if (peer_recv_bytes > acked_bytes_) acked_bytes_ = peer_recv_bytes;
    // Prune everything the peer confirms delivered (clamped: large
    // zero-copy ops never passed through the replay buffer).
    if (acked_bytes_ > replay_base_) {
      size_t avail = replay_.size() - replay_off_;
      uint64_t want = acked_bytes_ - replay_base_;
      size_t drop = want > avail ? avail : static_cast<size_t>(want);
      replay_off_ += drop;
      replay_base_ = acked_bytes_;
    }
    const uint64_t replay_end = replay_base_ +
        (replay_.size() - replay_off_);
    if (replay_end > peer_recv_bytes) {
      if (peer_recv_bytes < replay_base_)
        return false;  // bytes no longer held — unrecoverable link
      size_t start = replay_off_ +
          static_cast<size_t>(peer_recv_bytes - replay_base_);
      tail.assign(replay_.begin() + start, replay_.end());
    }
    const uint64_t covered = replay_end > peer_recv_bytes
                                 ? replay_end
                                 : peer_recv_bytes;
    if (send_bytes_ > covered) {
      // Beyond the replay: must be the active zero-copy op's bytes.
      if (!send_active_ || covered < s_op_start_abs_)
        return false;  // unrecoverable (op failed/aborted mid-flight)
      s_off_ = static_cast<size_t>(covered - s_op_start_abs_);
      send_bytes_ = covered;
    }
  }
  uint64_t seq = peer_recv_frames;
  size_t off = 0;
  while (off < tail.size()) {
    size_t k = std::min(tail.size() - off, kFrameChunk);
    if (!WriteFrameVec(fd, kMagicData, seq, tail.data() + off, k).ok())
      return false;
    off += k;
    seq++;
  }
  {
    std::lock_guard<std::mutex> lk(smu_);
    send_frames_ = seq;
    cv_.notify_all();
  }
  NET_TRACE("retransmitted %zu bytes from replay", tail.size());
  return true;
}

void Channel::AdoptResumed(int fd) {
  // Listener-thread half of reconnect-and-resume (this side accepts).
  ResumeWire theirs;
  if (!IoAllTimeout(fd, &theirs, sizeof(theirs), 2000, false)) {
    ::close(fd);
    return;
  }
  ResumeWire mine;
  {
    std::lock_guard<std::mutex> lk(smu_);
    mine = {recv_bytes_, recv_frames_, recv_ops_};
  }
  if (!IoAllTimeout(fd, &mine, sizeof(mine), 2000, true)) {
    ::close(fd);
    return;
  }
  CloseFd();
  ApplyResume(theirs.recv_bytes, theirs.recv_frames, theirs.recv_ops);
  if (!RetransmitReplay(fd, theirs.recv_bytes, theirs.recv_frames)) {
    ::close(fd);
    return;  // the dialer will retry; our op loops keep recovering
  }
  fd_.store(fd);
  epoch_++;
  NetCounters().reconnects++;
  NetCounters().last_recovery_ms.store(SteadyNowMs());
  NET_TRACE("adopt resumed fd=%d epoch=%llu", fd,
            (unsigned long long)epoch_.load());
  std::lock_guard<std::mutex> lk(smu_);
  cv_.notify_all();
}

void Channel::AdoptReset(int fd, uint64_t generation) {
  std::lock_guard<std::mutex> lk(smu_);
  if (pending_fd_ >= 0) ::close(pending_fd_);
  pending_fd_ = fd;
  pending_gen_ = generation;
  cv_.notify_all();
}

Status Channel::Recover(uint64_t failed_epoch, Deadline& dl) {
  std::lock_guard<std::mutex> rec(recover_mu_);
  if (epoch_.load() > failed_epoch && fd_.load() >= 0)
    return Status::OK();  // another thread already recovered this link
  if (net_->Closing()) return Status::Error("net: the runtime is shutting down");  // port: failed-world reset
  const NetResilienceConfig& rc = NetResilience();
  if (!rc.enabled)
    return Status::Error("net: connection to rank " +
                         std::to_string(peer_) + " failed");
  if (dead_ || NetChaos().blackholed(net_->rank(), peer_)) {
    dead_ = true;
    net_->NoteBadLink(peer_);
    return Status::Retry("net: link to rank " + std::to_string(peer_) +
                         " is dead (reconnect refused)");
  }
  NetCounters().retries++;
  NetCounters().recovering_now++;
  NetCounters().last_recovery_ms.store(SteadyNowMs());
  {
    std::lock_guard<std::mutex> lk(smu_);
    NET_TRACE(
        "recover begin epoch=%llu dialer=%d sact=%d soff=%zu/%zu "
        "acked=%llu ract=%d roff=%zu/%zu stash=%zu sb=%llu rb=%llu",
        (unsigned long long)failed_epoch, dialer_ ? 1 : 0,
        send_active_ ? 1 : 0, s_off_, s_total_,
        (unsigned long long)acked_bytes_, r_active_ ? 1 : 0, r_off_,
        r_total_, stash_.size(),
        (unsigned long long)send_bytes_, (unsigned long long)recv_bytes_);
  }
  CloseFd();
  double budget = std::min(rc.reconnect_s, dl.remaining_s());
  auto end = std::chrono::steady_clock::now() +
             std::chrono::duration_cast<std::chrono::steady_clock::duration>(
                 std::chrono::duration<double>(std::max(budget, 0.2)));
  Status out = Status::Retry("net: reconnect to rank " +
                             std::to_string(peer_) + " exhausted");
  if (dialer_) {
    int attempt = 0;
    while (std::chrono::steady_clock::now() < end) {
      if (net_->Closing()) break;  // port: failed-world reset
      std::string host;
      uint16_t port = 0;
      if (!ParseAddr(net_->table()[peer_], &host, &port)) break;
      int fd = DialOnce(host, port, 2.0);
      if (fd >= 0) {
        HelloWire hello{kMagicHello, net_->rank(), generation_.load()};
        ResumeWire mine;
        {
          std::lock_guard<std::mutex> lk(smu_);
          mine = {recv_bytes_, recv_frames_, recv_ops_};
        }
        ResumeWire theirs;
        if (IoAllTimeout(fd, &hello, sizeof(hello), 2000, true) &&
            IoAllTimeout(fd, &mine, sizeof(mine), 2000, true) &&
            IoAllTimeout(fd, &theirs, sizeof(theirs), 2000, false)) {
          ApplyResume(theirs.recv_bytes, theirs.recv_frames,
                      theirs.recv_ops);
          if (RetransmitReplay(fd, theirs.recv_bytes,
                               theirs.recv_frames)) {
            fd_.store(fd);
            epoch_++;
            NetCounters().reconnects++;
            out = Status::OK();
            break;
          }
        }
        ::close(fd);
      }
      // Bounded jittered backoff (deterministic: the chaos draw keyed by
      // the attempt index doubles as the jitter source).
      double jitter =
          NetChaosDraw(NetChaos().seed + 1, net_->rank(), peer_,
                       0xB0F0 + attempt);
      int backoff_ms = static_cast<int>(
          std::min(50.0 * (1 << std::min(attempt, 4)), 800.0) *
          (0.5 + 0.5 * jitter));
      usleep(backoff_ms * 1000);
      attempt++;
    }
  } else {
    // The lower rank waits for the dialer to come back through the
    // persistent listener (AdoptResumed swaps the socket in).
    std::unique_lock<std::mutex> lk(smu_);
    bool ok = cv_.wait_until(lk, end, [&] {
      if (net_->Closing()) return true;  // port: failed-world reset
      return epoch_.load() > failed_epoch && fd_.load() >= 0;
    });
    if (ok) out = Status::OK();
  }
  if (net_->Closing()) out = Status::Error("net: the runtime is shutting down");  // port: failed-world reset
  NetCounters().recovering_now--;
  NetCounters().last_recovery_ms.store(SteadyNowMs());
  NET_TRACE("recover end ok=%d epoch=%llu", out.ok() ? 1 : 0,
            (unsigned long long)epoch_.load());
  if (out.ok()) ReapGraveyard();
  if (!out.ok()) net_->NoteBadLink(peer_);
  return out;
}

namespace {
struct OpTimer {
  std::chrono::steady_clock::time_point t0;
  std::atomic<int64_t>* us;
  std::atomic<int64_t>* ops;
  OpTimer(std::atomic<int64_t>* us_, std::atomic<int64_t>* ops_)
      : t0(std::chrono::steady_clock::now()), us(us_), ops(ops_) {}
  ~OpTimer() {
    *us += std::chrono::duration_cast<std::chrono::microseconds>(
               std::chrono::steady_clock::now() - t0)
               .count();
    (*ops)++;
  }
};
}  // namespace

Status Channel::Send(const uint8_t* buf, size_t n, bool control) {
  OpTimer _t(&NetCounters().send_us, &NetCounters().send_ops);
  if (!NetResilience().enabled) return RawSend(buf, n, control);
  if (n == 0) return Status::OK();
  if (!control && Aborted())
    return Status::Retry("net: collective attempt aborted");
  if (NetChaos().blackholed(net_->rank(), peer_)) {
    Deadline dl = Deadline::After(0.2);
    uint64_t ep = epoch_.load();
    CloseFd();
    return Recover(ep, dl);  // refuses immediately: dead link
  }
  // Small ops complete OPTIMISTICALLY: their bytes are copied into the
  // replay buffer as they stream, so the ack round-trip (which
  // dominates small ring steps) leaves the critical path and a resume
  // retransmits from the replay tail.  Large ops stream zero-copy and
  // ack-wait at the end — the RTT is amortized by the transfer itself,
  // and the replay memcpy would be a per-byte tax; their resume rewinds
  // s_off_ into the still-live caller buffer instead.
  const bool optimistic = n <= kOptimisticMax;
  {
    std::lock_guard<std::mutex> lk(smu_);
    send_active_ = true;
    s_buf_ = buf;
    s_total_ = n;
    s_off_ = 0;
    s_op_start_abs_ = send_bytes_;
  }
  Deadline dl =
      Deadline::After(control ? 0.0 : NetResilience().op_deadline_s);
  bool recovered = false;
  auto fail = [&](Status st) {
    std::lock_guard<std::mutex> lk(smu_);
    send_active_ = false;
    s_buf_ = nullptr;
    return st;
  };
  const uint64_t op_start = [&] {
    std::lock_guard<std::mutex> lk(smu_);
    return s_op_start_abs_;
  }();
  const uint64_t op_end = op_start + n;
  bool done = false;
  while (!done) {
    // Phase 1: stream frames from the current (possibly rewound) offset.
    for (;;) {
      size_t off;
      uint64_t ep = epoch_.load();
      size_t unacked;
      {
        std::lock_guard<std::mutex> lk(smu_);
        off = s_off_;
        unacked = static_cast<size_t>(send_bytes_ - acked_bytes_);
      }
      if (off >= n) break;
      if (!control && Aborted())
        return fail(Status::Retry("net: collective attempt aborted"));
      if (dl.expired())
        return fail(Status::Retry("net: send deadline exceeded to rank " +
                                  std::to_string(peer_)));
      if (optimistic && unacked >= kReplayCap) {
        // Backpressure: drain acks before streaming further.
        Status st = Pump(dl, control, 0, true);
        if (st.retryable()) return fail(st);
        if (!st.ok()) {
          Status rs = Recover(ep, dl);
          if (!rs.ok()) return fail(rs);
          recovered = true;
        }
        continue;
      }
      // Opportunistically drain pending ACKs (zero-timeout pump): the
      // replay tail must shrink in steady state, not at the cap.
      if (rmu_.try_lock()) {
        for (int i = 0; i < 8; ++i) {
          Status ps = PumpOne(0);
          if (ps.type == StatusType::IN_PROGRESS || !ps.ok()) break;
        }
        rmu_.unlock();
        // A reader that lost the rmu_ race to this drain may be asleep
        // on the cv with nothing left to notify it — wake it to retry.
        std::lock_guard<std::mutex> lk(smu_);
        cv_.notify_all();
      }
      size_t k = std::min(n - off, kFrameChunk);
      uint64_t seq;
      {
        std::lock_guard<std::mutex> lk(smu_);
        seq = send_frames_;
      }
      Status st = WriteDataFrame(buf + off, k, seq);
      if (st.ok()) {
        std::lock_guard<std::mutex> lk(smu_);
        if (epoch_.load() == ep) {
          if (optimistic) {
            if (replay_off_ == replay_.size()) {
              // Re-anchor an empty buffer: a preceding zero-copy large
              // op advanced the byte counters past replay_base_.
              replay_.clear();
              replay_off_ = 0;
              replay_base_ = send_bytes_;
            }
            replay_.insert(replay_.end(), buf + off, buf + off + k);
          }
          s_off_ = off + k;
          send_bytes_ += k;
          send_frames_++;
          continue;
        }
        // An adoption raced the write: the frame landed on a dead
        // socket with a stale seq — the resume already handled the
        // unacked span, so just retry this chunk on the fresh link.
        continue;
      }
      Status rs = Recover(ep, dl);
      if (!rs.ok()) return fail(rs);
      recovered = true;
    }
    if (optimistic) {
      done = true;
      break;
    }
    // Phase 2 (large ops): wait until the receiver confirms every byte —
    // only then may the caller reuse the buffer.  A resume rewinds
    // s_off_ into it and phase 1 re-runs.
    auto last_progress = std::chrono::steady_clock::now();
    uint64_t last_acked = 0;
    for (;;) {
      uint64_t ep = epoch_.load();
      bool rewound = false;
      {
        std::lock_guard<std::mutex> lk(smu_);
        if (acked_bytes_ >= op_end) {
          done = true;
          break;
        }
        if (s_off_ < s_total_) rewound = true;
        if (acked_bytes_ != last_acked) {
          last_acked = acked_bytes_;
          last_progress = std::chrono::steady_clock::now();
        }
      }
      if (rewound) break;  // back to phase 1
      if (!control && Aborted())
        return fail(Status::Retry("net: collective attempt aborted"));
      if (dl.expired())
        return fail(Status::Retry("net: ack deadline exceeded from rank " +
                                  std::to_string(peer_)));
      Status st = Pump(dl, control, 0, true);
      if (st.retryable()) return fail(st);
      double probe = NetResilience().probe_ms;
      if (control) probe = std::max(probe * 10.0, 2000.0);
      bool stalled =
          dialer_ &&
          std::chrono::duration<double>(
              std::chrono::steady_clock::now() - last_progress)
                  .count() *
                  1000.0 >
              probe;
      if (!st.ok() || stalled) {
        Status rs = Recover(ep, dl);
        if (!rs.ok()) return fail(rs);
        recovered = true;
        last_progress = std::chrono::steady_clock::now();
      }
    }
  }
  {
    std::lock_guard<std::mutex> lk(smu_);
    send_active_ = false;
    s_buf_ = nullptr;
  }
  if (recovered) NetCounters().resets_avoided++;
  return Status::OK();
}

Status Channel::Recv(uint8_t* dst, size_t n,
                     const std::function<void(size_t)>& on_progress,
                     bool control, double deadline_s) {
  OpTimer _t(&NetCounters().recv_us, &NetCounters().recv_ops);
  if (!NetResilience().enabled) return RawRecv(dst, n, on_progress, control);
  if (n == 0) return Status::OK();
  if (!control && Aborted())
    return Status::Retry("net: collective attempt aborted");
  if (NetChaos().blackholed(net_->rank(), peer_)) {
    Deadline dl = Deadline::After(0.2);
    uint64_t ep = epoch_.load();
    CloseFd();
    return Recover(ep, dl);
  }
  NET_TRACE("recv post n=%zu ctl=%d rops=%llu", n, control ? 1 : 0,
            (unsigned long long)recv_ops_);
  size_t drained = 0;
  {
    std::lock_guard<std::mutex> lk(smu_);
    size_t avail = stash_.size() - stash_off_;
    if (avail > 0) {
      drained = std::min(avail, n);
      memcpy(dst, stash_.data() + stash_off_, drained);
      stash_off_ += drained;
      if (stash_off_ == stash_.size()) {
        stash_.clear();
        stash_off_ = 0;
      } else if (stash_off_ > (1u << 20) &&
                 stash_off_ * 2 >= stash_.size()) {
        stash_.erase(stash_.begin(), stash_.begin() + stash_off_);
        stash_off_ = 0;
      }
    }
    if (drained < n) {
      r_active_ = true;
      r_dst_ = dst;
      r_total_ = n;
      r_off_ = drained;
      r_cb_ = on_progress ? &on_progress : nullptr;
    } else {
      recv_ops_++;
    }
  }
  if (drained >= n) {
    if (on_progress) {
      std::lock_guard<std::mutex> cl(cbmu_);
      on_progress(n);
    }
    uint64_t rb = 0;
    {
      std::lock_guard<std::mutex> lk(smu_);
      if (n >= kOptimisticMax ||
          recv_bytes_ - ack_sent_bytes_ >= kAckEveryBytes) {
        rb = recv_bytes_;
        ack_sent_bytes_ = rb;
      }
    }
    if (rb != 0 && !WriteControlFrame(kMagicAck, rb).ok()) CloseFd();
    return Status::OK();
  }
  if (drained > 0 && on_progress) {
    std::lock_guard<std::mutex> cl(cbmu_);
    on_progress(drained);
  }
  Deadline dl = Deadline::After(control ? deadline_s
                                        : NetResilience().op_deadline_s);
  bool recovered = false;
  auto fail = [&](Status st) {
    std::lock_guard<std::mutex> lk(smu_);
    r_active_ = false;
    r_cb_ = nullptr;
    return st;
  };
  auto last_progress = std::chrono::steady_clock::now();
  size_t last_off = drained;
  for (;;) {
    uint64_t ep = epoch_.load();
    {
      std::lock_guard<std::mutex> lk(smu_);
      if (r_off_ >= r_total_) break;
      if (r_off_ != last_off) {
        last_off = r_off_;
        last_progress = std::chrono::steady_clock::now();
      }
    }
    if (!control && Aborted())
      return fail(Status::Retry("net: collective attempt aborted"));
    if (dl.expired())
      return fail(Status::Retry("net: recv deadline exceeded from rank " +
                                std::to_string(peer_)));
    Status st = Pump(dl, control, 0, false);
    if (st.retryable()) return fail(st);
    // Same dialer-only probe rule as the ack wait (see Send).
    double probe = NetResilience().probe_ms;
    if (control) probe = std::max(probe * 10.0, 2000.0);
    bool stalled =
        dialer_ &&
        std::chrono::duration<double>(std::chrono::steady_clock::now() -
                                      last_progress)
                .count() *
                1000.0 >
            probe;
    if (!st.ok() || stalled) {
      Status rs = Recover(ep, dl);
      if (!rs.ok()) return fail(rs);
      recovered = true;
      last_progress = std::chrono::steady_clock::now();
    }
  }
  uint64_t rb = 0;
  {
    std::lock_guard<std::mutex> lk(smu_);
    r_active_ = false;
    r_cb_ = nullptr;
    recv_ops_++;
    if (n >= kOptimisticMax ||
        recv_bytes_ - ack_sent_bytes_ >= kAckEveryBytes) {
      rb = recv_bytes_;
      ack_sent_bytes_ = rb;
    }
    NET_TRACE("recv done rb=%llu n=%zu",
              (unsigned long long)recv_bytes_, n);
  }
  // A lost ACK is recovered by the resume handshake (the peer learns
  // recv_bytes_ from it), so a failed write only needs to break the
  // link loudly, not fail this completed op.
  if (rb != 0 && !WriteControlFrame(kMagicAck, rb).ok()) CloseFd();
  if (recovered) NetCounters().resets_avoided++;
  return Status::OK();
}

Status Channel::SendMsg(const std::vector<uint8_t>& payload,
                        bool control) {
  // One op (and one gathered frame) for len+payload: control messages
  // are small and flow every negotiation cycle — two ops apiece doubled
  // the control plane's syscall count.  The receiver still posts two
  // recvs, but both parse out of the batched read buffer.
  std::vector<uint8_t> wire(4 + payload.size());
  uint32_t len = static_cast<uint32_t>(payload.size());
  memcpy(wire.data(), &len, 4);
  if (!payload.empty())
    memcpy(wire.data() + 4, payload.data(), payload.size());
  return Send(wire.data(), wire.size(), control);
}

Status Channel::RecvMsg(std::vector<uint8_t>& payload, bool control,
                        double deadline_s) {
  // deadline_s > 0 bounds a control recv (the ring-recovery agreement is
  // a bounded rendezvous, unlike the open-ended negotiation wait).
  auto start = std::chrono::steady_clock::now();
  uint32_t len = 0;
  Status st =
      Recv(reinterpret_cast<uint8_t*>(&len), 4, nullptr, control,
           deadline_s);
  if (!st.ok()) return st;
  if (len > (256u << 20))
    return Status::Error("net: oversized control message");
  payload.resize(len);
  if (len == 0) return Status::OK();
  double remaining = 0.0;
  if (deadline_s > 0) {
    remaining = deadline_s -
                std::chrono::duration<double>(
                    std::chrono::steady_clock::now() - start)
                    .count();
    if (remaining <= 0.05) remaining = 0.05;
  }
  return Recv(payload.data(), len, nullptr, control, remaining);
}

Status Channel::Reset(uint64_t generation, double deadline_s) {
  std::lock_guard<std::mutex> rec(recover_mu_);
  CloseFd();
  {
    std::lock_guard<std::mutex> lk(smu_);
    send_active_ = false;
    s_buf_ = nullptr;
    s_total_ = s_off_ = 0;
    send_bytes_ = send_frames_ = acked_bytes_ = 0;
    replay_.clear();
    replay_off_ = 0;
    replay_base_ = 0;
    r_active_ = false;
    r_dst_ = nullptr;
    r_cb_ = nullptr;
    r_total_ = r_off_ = 0;
    recv_ops_ = recv_bytes_ = recv_frames_ = 0;
    ack_sent_bytes_ = 0;
    stash_.clear();
    stash_off_ = 0;
  }
  generation_.store(generation);
  auto end = std::chrono::steady_clock::now() +
             std::chrono::duration_cast<std::chrono::steady_clock::duration>(
                 std::chrono::duration<double>(deadline_s));
  if (dialer_) {
    while (std::chrono::steady_clock::now() < end) {
      if (net_->Closing()) break;  // port: failed-world reset
      std::string host;
      uint16_t port = 0;
      if (!ParseAddr(net_->table()[peer_], &host, &port)) break;
      int fd = DialOnce(host, port, 2.0);
      if (fd >= 0) {
        HelloWire hello{kMagicHelloReset, net_->rank(), generation};
        if (IoAllTimeout(fd, &hello, sizeof(hello), 2000, true)) {
          fd_.store(fd);
          epoch_++;
          std::lock_guard<std::mutex> lk(smu_);
          cv_.notify_all();
          return Status::OK();
        }
        ::close(fd);
      }
      usleep(50000);
    }
  } else {
    std::unique_lock<std::mutex> lk(smu_);
    bool ok = cv_.wait_until(lk, end, [&] {
      return pending_fd_ >= 0 && pending_gen_ >= generation;
    });
    if (ok) {
      int fd = pending_fd_;
      pending_fd_ = -1;
      fd_.store(fd);
      epoch_++;
      cv_.notify_all();
      return Status::OK();
    }
  }
  return Status::Error("net: mesh reset could not re-link rank " +
                       std::to_string(peer_));
}

// --- raw (pre-resilience) wire protocol ------------------------------------

Status Channel::RawSend(const uint8_t* buf, size_t n, bool control) {
  int fd = fd_.load();
  if (fd < 0) return Status::Error("net: connection down");
  const NetChaosConfig& chaos = NetChaos();
  size_t sent = 0;
  while (sent < n) {
    if (chaos.enabled()) {
      uint64_t idx;
      {
        std::lock_guard<std::mutex> lk(wmu_);
        idx = chaos_draws_++;
      }
      if (chaos.delay_ms > 0)
        usleep(static_cast<int>(chaos.delay_ms * 1000));
      if (chaos.reset_pct > 0 &&
          NetChaosDraw(chaos.seed, net_->rank(), peer_, idx * 4 + 1) *
                  100.0 <
              chaos.reset_pct) {
        NetCounters().chaos_injected++;
        CloseFd();
        return Status::Error("net: chaos connection reset");
      }
    }
    pollfd pfd{fd, POLLOUT, 0};
    int pr = ::poll(&pfd, 1, control ? -1 : 60000);
    if (pr < 0 && errno == EINTR) continue;
    if (pr <= 0) return Status::Error("collective send timeout");
    ssize_t k = ::send(fd, buf + sent,
                       std::min<size_t>(n - sent, kFrameChunk),
                       MSG_NOSIGNAL | MSG_DONTWAIT);
    if (k < 0) {
      if (errno == EINTR || errno == EAGAIN || errno == EWOULDBLOCK)
        continue;
      return Status::Error("send failed in collective");
    }
    sent += k;
  }
  return Status::OK();
}

Status Channel::RawRecv(uint8_t* dst, size_t n,
                        const std::function<void(size_t)>& on_progress,
                        bool control) {
  int fd = fd_.load();
  if (fd < 0) return Status::Error("net: connection down");
  size_t received = 0;
  while (received < n) {
    pollfd pfd{fd, POLLIN, 0};
    int pr = ::poll(&pfd, 1, control ? -1 : 60000);
    if (pr < 0 && errno == EINTR) continue;
    if (pr <= 0) return Status::Error("collective recv timeout");
    ssize_t k = ::recv(fd, dst + received,
                       std::min<size_t>(n - received, kFrameChunk),
                       MSG_DONTWAIT);
    if (k == 0) return Status::Aborted("peer closed during collective");
    if (k < 0) {
      if (errno == EINTR || errno == EAGAIN || errno == EWOULDBLOCK)
        continue;
      return Status::Error("recv failed in collective");
    }
    received += k;
    if (on_progress) on_progress(received);
  }
  return Status::OK();
}

// ---------------------------------------------------------------------------
// Network
// ---------------------------------------------------------------------------

std::unique_ptr<Network> Network::Connect(int rank, int size,
                                          const std::string& coord_addr,
                                          Status* status) {
  std::string coord_host;
  uint16_t coord_port = 0;
  if (!ParseAddr(coord_addr, &coord_host, &coord_port)) {
    *status = Status::InvalidArgument("bad coordinator address " + coord_addr);
    return nullptr;
  }
  std::unique_ptr<Network> net(new Network(rank, size));

  // Every rank listens; rank 0 on the well-known port.  The listener
  // outlives the handshake: reconnect-and-resume re-enters through it.
  uint16_t my_port = 0;
  int listen_fd = Listen(rank == 0 ? coord_port : 0, &my_port);
  if (listen_fd < 0) {
    *status = Status::Error("cannot bind listener");
    return nullptr;
  }
  net->listen_fd_ = listen_fd;

  if (rank == 0) {
    // Accept size-1 workers; each announces {rank, host, port}.
    std::vector<std::string> table(size);
    table[0] = LocalHostname() + ":" + std::to_string(my_port);
    for (int i = 1; i < size; ++i) {
      int fd = ::accept(listen_fd, nullptr, nullptr);
      if (fd < 0) {
        *status = Status::Error("accept failed");
        return nullptr;
      }
      SetNoDelay(fd);
      auto sock = std::make_unique<Socket>(fd);
      int32_t peer_rank;
      if (!sock->RecvAll(&peer_rank, 4).ok()) {
        *status = Status::Error("handshake recv failed");
        return nullptr;
      }
      std::vector<uint8_t> addr_buf;
      sock->RecvFrame(addr_buf);
      table[peer_rank].assign(addr_buf.begin(), addr_buf.end());
      net->peers_[peer_rank] = std::move(sock);
    }
    // Broadcast the address table.
    std::vector<uint8_t> blob;
    for (int i = 0; i < size; ++i) {
      uint32_t n = table[i].size();
      const uint8_t* np = reinterpret_cast<const uint8_t*>(&n);
      blob.insert(blob.end(), np, np + 4);
      blob.insert(blob.end(), table[i].begin(), table[i].end());
    }
    for (int i = 1; i < size; ++i) net->peers_[i]->SendFrame(blob);
    net->table_ = table;
    net->SetupShm(table, coord_addr);
  } else {
    int fd = DialRetry(coord_host, coord_port);
    if (fd < 0) {
      *status = Status::Error("cannot reach coordinator at " + coord_addr);
      return nullptr;
    }
    auto sock = std::make_unique<Socket>(fd);
    int32_t r32 = rank;
    sock->SendAll(&r32, 4);
    std::string my_addr = LocalHostname() + ":" + std::to_string(my_port);
    sock->SendFrame(std::vector<uint8_t>(my_addr.begin(), my_addr.end()));
    std::vector<uint8_t> blob;
    if (!sock->RecvFrame(blob).ok()) {
      *status = Status::Error("address table recv failed");
      return nullptr;
    }
    net->peers_[0] = std::move(sock);
    // Parse table.
    std::vector<std::string> table(size);
    size_t off = 0;
    for (int i = 0; i < size; ++i) {
      uint32_t n;
      memcpy(&n, blob.data() + off, 4);
      off += 4;
      table[i].assign(reinterpret_cast<const char*>(blob.data() + off), n);
      off += n;
    }
    // Full mesh: connect to all lower ranks (>0), accept from higher ranks.
    for (int peer = 1; peer < rank; ++peer) {
      std::string host;
      uint16_t port;
      ParseAddr(table[peer], &host, &port);
      int pfd = DialRetry(host, port);
      if (pfd < 0) {
        *status = Status::Error("cannot reach peer " + table[peer]);
        return nullptr;
      }
      auto psock = std::make_unique<Socket>(pfd);
      int32_t me = rank;
      psock->SendAll(&me, 4);
      net->peers_[peer] = std::move(psock);
    }
    for (int peer = rank + 1; peer < size; ++peer) {
      int pfd = ::accept(listen_fd, nullptr, nullptr);
      if (pfd < 0) {
        *status = Status::Error("peer accept failed");
        return nullptr;
      }
      SetNoDelay(pfd);
      auto psock = std::make_unique<Socket>(pfd);
      int32_t peer_rank;
      psock->RecvAll(&peer_rank, 4);
      net->peers_[peer_rank] = std::move(psock);
    }
    net->table_ = table;
    net->SetupShm(table, coord_addr);
  }
  net->MakeChannels();
  if (NetResilience().enabled) {
    net->listener_ = std::thread([n = net.get()] { n->ListenerLoop(); });
  }
  *status = Status::OK();
  return net;
}

void Network::MakeChannels() {
  channels_.resize(size_);
  for (int r = 0; r < size_; ++r) {
    int fd = peers_[r] ? peers_[r]->release() : -1;
    channels_[r] = std::make_unique<Channel>(this, r, fd);
  }
  peers_.clear();
  ring_order_.resize(size_);
  for (int i = 0; i < size_; ++i) ring_order_[i] = i;
}

Network::~Network() {
  listener_stop_ = true;
  if (listener_.joinable()) listener_.join();
  if (listen_fd_ >= 0) ::close(listen_fd_);
}

void Network::ListenerLoop() {
  // Reconnect router: a dialer coming back (same generation → resume the
  // in-flight transfers) or the fleet re-forming the mesh after a ring
  // renegotiation (higher generation → fresh link, zeroed state).
  while (!listener_stop_.load()) {
    pollfd pfd{listen_fd_, POLLIN, 0};
    int pr = ::poll(&pfd, 1, 200);
    if (pr <= 0) continue;
    int fd = ::accept(listen_fd_, nullptr, nullptr);
    if (fd < 0) continue;
    SetNoDelay(fd);
    HelloWire hello{};
    if (!IoAllTimeout(fd, &hello, sizeof(hello), 2000, false) ||
        (hello.magic != kMagicHello && hello.magic != kMagicHelloReset) ||
        hello.rank < 0 || hello.rank >= size_ ||
        channels_.size() != static_cast<size_t>(size_)) {
      ::close(fd);
      continue;
    }
    Channel* ch = channels_[hello.rank].get();
    if (NetChaos().blackholed(rank_, hello.rank)) {
      ::close(fd);  // the drill: this pair stays unreachable
      continue;
    }
    if (hello.magic == kMagicHelloReset) {
      ch->AdoptReset(fd, hello.generation);
    } else {
      ch->AdoptResumed(fd);
    }
  }
}

std::vector<int> Network::ring_order() const {
  std::lock_guard<std::mutex> lk(ring_mu_);
  return ring_order_;
}

void Network::set_ring_order(const std::vector<int>& order) {
  std::lock_guard<std::mutex> lk(ring_mu_);
  ring_order_ = order;
}

void Network::BroadcastAbort() {
  uint64_t epoch = attempt_epoch_.load();
  NoteAbort(epoch);  // unblock our own op threads too
  for (int r = 0; r < size_; ++r) {
    if (r == rank_) continue;
    if (channels_[r]) channels_[r]->SendAbort(epoch);
  }
}

// Ends every recovery and wait of this world's links (Runtime::Shutdown).  // port: failed-world reset
void Network::Close() {  // port: failed-world reset
  closing_ = true;  // port: failed-world reset
  for (auto& c : channels_) {  // port: failed-world reset
    if (!c) continue;  // port: failed-world reset
    std::lock_guard<std::mutex> lk(c->smu_);  // port: failed-world reset
    c->cv_.notify_all();  // port: failed-world reset
  }  // port: failed-world reset
}  // port: failed-world reset
void Network::NoteBadLink(int peer) {
  std::lock_guard<std::mutex> lk(bad_mu_);
  bad_links_.insert(peer);
  last_bad_peer_ = peer;
}

std::vector<int> Network::bad_links() const {
  std::lock_guard<std::mutex> lk(bad_mu_);
  return std::vector<int>(bad_links_.begin(), bad_links_.end());
}

int Network::TakeLastBadPeer() {
  std::lock_guard<std::mutex> lk(bad_mu_);
  int p = last_bad_peer_;
  last_bad_peer_ = -1;
  return p;
}

Status Network::MeshReset(double deadline_s) {
  uint64_t gen = ++generation_;
  Status out = Status::OK();
  std::set<int> bad;
  {
    std::lock_guard<std::mutex> lk(bad_mu_);
    bad = bad_links_;
  }
  for (int r = 0; r < size_; ++r) {
    if (r == rank_ || !channels_[r]) continue;
    if (bad.count(r)) continue;  // a proven-dead link stays down; the
                                 // renegotiated ring routes around it
    Status st = channels_[r]->Reset(gen, deadline_s);
    if (!st.ok()) out = st;
  }
  return out;
}

void Network::SetupShm(const std::vector<std::string>& table,
                       const std::string& tag) {
  // A rank with HVD_TPU_DISABLE_SHM still runs the handshake bytes (as
  // "not participating") — a unilateral early-return would desynchronize
  // the shared data sockets for peers that do participate.
  const bool disabled = getenv("HVD_TPU_DISABLE_SHM") != nullptr;
  std::string my_host, host;
  uint16_t port;
  if (!ParseAddr(table[rank_], &my_host, &port)) return;
  std::vector<int> local;
  for (int r = 0; r < size_; ++r) {
    if (r != rank_ && ParseAddr(table[r], &host, &port) &&
        host == my_host) {
      local.push_back(r);
    }
  }
  if (local.empty()) return;

  // Segment names are scoped to this job by the coordinator address
  // (unique per launch/elastic round).
  std::string base = "/hvt_";
  for (char c : tag)
    base += (isalnum(static_cast<unsigned char>(c)) ? c : '_');

  // Phase 1: create all outgoing segments, then confirm creation with
  // each peer BEFORE anyone opens — opening only after the peer's create
  // is confirmed means a stale segment from a crashed job (which Create
  // unlinks and replaces) can never be the object the consumer maps.
  std::vector<std::unique_ptr<ShmChannel>> tx(size_);
  if (!disabled) {
    for (int r : local) {
      tx[r] = ShmChannel::Create(base + "_" + std::to_string(rank_) +
                                 "_" + std::to_string(r));
    }
  }
  for (int r : local) {
    uint8_t my_created = tx[r] != nullptr ? 1 : 0;
    uint8_t peer_created = 0;
    if (!peers_[r]->SendAll(&my_created, 1).ok() ||
        !peers_[r]->RecvAll(&peer_created, 1).ok()) {
      if (tx[r]) tx[r]->Unlink();
      tx[r].reset();
      continue;
    }
    // Phase 2: open the peer's (fresh) segment, report back.
    std::unique_ptr<ShmChannel> rx;
    if (!disabled && peer_created) {
      rx = ShmChannel::Open(base + "_" + std::to_string(r) + "_" +
                            std::to_string(rank_));
    }
    uint8_t my_rx_ok = rx != nullptr ? 1 : 0;
    uint8_t peer_rx_ok = 0;
    bool hs_ok = peers_[r]->SendAll(&my_rx_ok, 1).ok() &&
                 peers_[r]->RecvAll(&peer_rx_ok, 1).ok();
    // Phase 3: cross-memory-attach capability — my consumer end probes a
    // direct read of the producer's memory; the producer publishes
    // descriptors (zero staging copies) only if my probe succeeded.
    uint8_t my_cma = (hs_ok && rx != nullptr && rx->ProbeCma()) ? 1 : 0;
    uint8_t peer_cma = 0;
    if (hs_ok) {
      hs_ok = peers_[r]->SendAll(&my_cma, 1).ok() &&
              peers_[r]->RecvAll(&peer_cma, 1).ok();
    }
    if (tx[r]) {
      tx[r]->Unlink();  // both ends mapped (or unused): never leak
      if (hs_ok && peer_rx_ok) {
        if (peer_cma) tx[r]->EnableRefs();
        shm_tx_[r] = std::move(tx[r]);
      } else {
        tx[r].reset();
      }
    }
    if (hs_ok && my_rx_ok) shm_rx_[r] = std::move(rx);
  }
}

}  // namespace hvdtpu
