#include "collectives.h"

#include <poll.h>
#include <sys/socket.h>

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <cmath>
#include <functional>
#include <thread>
#include <cstring>

namespace hvdtpu {

namespace {

// --- fp16 / bf16 <-> fp32 (reference half.cc capability, portable) --------

inline float HalfToFloat(uint16_t h) {
  uint32_t sign = (h & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1f;
  uint32_t mant = h & 0x3ffu;
  uint32_t f;
  if (exp == 0) {
    if (mant == 0) {
      f = sign;
    } else {  // subnormal
      exp = 127 - 15 + 1;
      while ((mant & 0x400u) == 0) { mant <<= 1; exp--; }
      mant &= 0x3ffu;
      f = sign | (exp << 23) | (mant << 13);
    }
  } else if (exp == 0x1f) {
    f = sign | 0x7f800000u | (mant << 13);
  } else {
    f = sign | ((exp + 127 - 15) << 23) | (mant << 13);
  }
  float out;
  memcpy(&out, &f, 4);
  return out;
}

inline uint16_t FloatToHalf(float v) {
  uint32_t f;
  memcpy(&f, &v, 4);
  uint32_t sign = (f >> 16) & 0x8000u;
  int32_t exp = static_cast<int32_t>((f >> 23) & 0xff) - 127 + 15;
  uint32_t mant = f & 0x7fffffu;
  if (exp <= 0) {
    if (exp < -10) return static_cast<uint16_t>(sign);
    mant |= 0x800000u;
    uint32_t shift = 14 - exp;
    return static_cast<uint16_t>(sign | (mant >> shift));
  }
  if (exp >= 0x1f) return static_cast<uint16_t>(sign | 0x7c00u);
  return static_cast<uint16_t>(sign | (exp << 10) | (mant >> 13));
}

inline float Bf16ToFloat(uint16_t b) {
  uint32_t f = static_cast<uint32_t>(b) << 16;
  float out;
  memcpy(&out, &f, 4);
  return out;
}

inline uint16_t FloatToBf16(float v) {
  uint32_t f;
  memcpy(&f, &v, 4);
  // round-to-nearest-even
  uint32_t rounding = ((f >> 16) & 1u) + 0x7fffu;
  return static_cast<uint16_t>((f + rounding) >> 16);
}

// --- reduction kernels -----------------------------------------------------

template <typename T>
void ReduceT(T* dst, const T* src, int64_t n, ReduceOp op) {
  switch (op) {
    case ReduceOp::SUM:
    case ReduceOp::AVERAGE:  // divide happens at unpack
    case ReduceOp::ADASUM:   // handled elsewhere; fallthrough sum for safety
      for (int64_t i = 0; i < n; ++i) dst[i] += src[i];
      break;
    case ReduceOp::MIN:
      for (int64_t i = 0; i < n; ++i) dst[i] = std::min(dst[i], src[i]);
      break;
    case ReduceOp::MAX:
      for (int64_t i = 0; i < n; ++i) dst[i] = std::max(dst[i], src[i]);
      break;
    case ReduceOp::PRODUCT:
      for (int64_t i = 0; i < n; ++i) dst[i] *= src[i];
      break;
  }
}

template <typename U, float (*ToF)(U), U (*FromF)(float)>
void Reduce16(U* dst, const U* src, int64_t n, ReduceOp op) {
  for (int64_t i = 0; i < n; ++i) {
    float a = ToF(dst[i]);
    float b = ToF(src[i]);
    float r;
    switch (op) {
      case ReduceOp::MIN: r = std::min(a, b); break;
      case ReduceOp::MAX: r = std::max(a, b); break;
      case ReduceOp::PRODUCT: r = a * b; break;
      default: r = a + b; break;
    }
    dst[i] = FromF(r);
  }
}

void ReduceBuf(void* dst, const void* src, int64_t count, DataType dtype,
               ReduceOp op) {
  switch (dtype) {
    case DataType::FLOAT32:
      ReduceT(static_cast<float*>(dst), static_cast<const float*>(src),
              count, op);
      break;
    case DataType::FLOAT64:
      ReduceT(static_cast<double*>(dst), static_cast<const double*>(src),
              count, op);
      break;
    case DataType::INT32:
      ReduceT(static_cast<int32_t*>(dst), static_cast<const int32_t*>(src),
              count, op);
      break;
    case DataType::INT64:
      ReduceT(static_cast<int64_t*>(dst), static_cast<const int64_t*>(src),
              count, op);
      break;
    case DataType::UINT8:
    case DataType::BOOL:
      ReduceT(static_cast<uint8_t*>(dst), static_cast<const uint8_t*>(src),
              count, op);
      break;
    case DataType::INT8:
      ReduceT(static_cast<int8_t*>(dst), static_cast<const int8_t*>(src),
              count, op);
      break;
    case DataType::FLOAT16:
      Reduce16<uint16_t, HalfToFloat, FloatToHalf>(
          static_cast<uint16_t*>(dst), static_cast<const uint16_t*>(src),
          count, op);
      break;
    case DataType::BFLOAT16:
      Reduce16<uint16_t, Bf16ToFloat, FloatToBf16>(
          static_cast<uint16_t*>(dst), static_cast<const uint16_t*>(src),
          count, op);
      break;
  }
}

// One-directional streams: shared memory when the peer is on this host
// (Network::shm_tx/shm_rx — two memcpys, no syscalls on the bulk path),
// TCP otherwise.  Used standalone for chains/broadcasts and paired by
// FullDuplex for ring steps.

Status SendStream(Network& net, int peer, const uint8_t* buf, size_t n) {
  if (n == 0) return Status::OK();
  if (ShmChannel* ch = net.shm_tx(peer)) {
    if (ch->refs_enabled() && n >= (1u << 20)) {
      // Cross-memory attach: publish slot-sized descriptors into this
      // process's memory; the consumer pulls each directly (zero staging
      // copies) while later chunks are being published — keeping the
      // receiver's incremental reduction pipelined.  Must drain before
      // returning: the ring reuses the region in later steps.
      size_t off = 0;
      while (off < n) {
        size_t k = std::min(n - off, ShmChannel::kSlotBytes);
        Status st = ch->PushRef(buf + off, k);
        if (!st.ok()) return st;
        off += k;
      }
      return ch->WaitDrained();
    }
    size_t off = 0;
    while (off < n) {
      size_t k = std::min(n - off, ShmChannel::kSlotBytes);
      Status st = ch->Push(buf + off, k);
      if (!st.ok()) return st;
      off += k;
    }
    return Status::OK();
  }
  // TCP: the resilient channel (framing + acks + reconnect-and-resume
  // when HVD_TPU_NET_RESILIENCE is on; raw 4 MB chunks otherwise).
  return net.chan(peer)->Send(buf, n);
}

Status RecvStream(Network& net, int peer, uint8_t* dst, size_t n,
                  const std::function<void(size_t)>& on_recv = nullptr) {
  if (n == 0) return Status::OK();
  if (ShmChannel* ch = net.shm_rx(peer)) {
    size_t off = 0;
    while (off < n) {
      size_t got = 0;
      Status st = ch->PopInto(dst + off, n - off, &got);
      if (!st.ok()) return st;
      off += got;
      if (on_recv) on_recv(off);
    }
    return Status::OK();
  }
  return net.chan(peer)->Recv(dst, n, on_recv);
}

// Full-duplex transfer: simultaneously stream nsend bytes toward
// send_peer and nrecv bytes from recv_peer.  ``on_recv(total)``, when
// set, is invoked as the received prefix grows so the caller can overlap
// per-chunk work (reduction) with the remaining transfer.
// Threaded variant for large or shm transfers: the send stream runs on
// its own thread so both directions (and the on_recv reduction) proceed
// in parallel — a single-threaded poll loop serializes the kernel copies
// of the two directions onto one core and halves duplex throughput.
Status FullDuplexThreaded(Network& net, int send_peer,
                          const uint8_t* send_buf, size_t nsend,
                          int recv_peer, uint8_t* recv_buf, size_t nrecv,
                          const std::function<void(size_t)>& on_recv) {
  // Persistent helper thread instead of a per-call std::thread: the ring
  // calls this 2(P-1) times per allreduce, and the spawn+join cost
  // rivals the transfer itself at small payloads.
  Status send_st = Status::OK();
  net.duplex_helper().Run(
      [&] { send_st = SendStream(net, send_peer, send_buf, nsend); });
  Status st = RecvStream(net, recv_peer, recv_buf, nrecv, on_recv);
  net.duplex_helper().Wait();
  return st.ok() ? send_st : st;
}

// Zero-copy CMA star delivery of [buf, buf+total) from `root` to every
// other member (the reference's shared-memory window for fan-outs,
// MEMCPY_IN_SHARED_BUFFER in mpi_operations.cc): the root publishes
// cross-memory descriptors per member and all members pull directly
// from the root's memory CONCURRENTLY — one copy per member, none for
// the root, no per-hop forwarding.  The root picks and announces the
// mode in-band (one flag byte per member) so capability asymmetries can
// never desynchronize the framing.  When *used_star comes back false
// the caller runs its chain fallback.
//
// `star_min`: payloads below it skip the star AND the mode-byte
// exchange entirely — `total` is coordinator-provided and identical on
// every member, so the short-circuit is symmetric (SendStream's CMA
// path has the same >=1MB cutoff: descriptor+syscall overhead beats a
// shm-slot memcpy only on large payloads).
//
// `skip_off`/`skip_len` (indexed BY RANK, both or neither): each
// member's own block is excluded from its spans — the allgather case,
// where a member already holds its contribution; at most two
// descriptors per member around the hole.
Status StarFanout(Network& net, uint8_t* buf, int64_t total, int root,
                  const std::vector<int>& members, bool force_chain,
                  int64_t star_min, bool* used_star,
                  const std::vector<int64_t>* skip_off = nullptr,
                  const std::vector<int64_t>* skip_len = nullptr) {
  const int rank = net.rank();
  *used_star = false;
  if (total < star_min) return Status::OK();
  uint8_t star = 0;
  if (rank == root) {
    star = force_chain ? 0 : 1;
    for (int peer : members) {
      if (peer == root) continue;
      ShmChannel* ch = net.shm_tx(peer);
      if (ch == nullptr || !ch->refs_enabled()) star = 0;
    }
    for (int peer : members) {
      if (peer == root) continue;
      Status st = SendStream(net, peer, &star, 1);
      if (!st.ok()) return st;
    }
  } else {
    Status st = RecvStream(net, root, &star, 1);
    if (!st.ok()) return st;
  }
  *used_star = star != 0;
  if (!star || total == 0) return Status::OK();
  // Spans for rank r: [0, total) minus r's own block (when skipping).
  auto spans_for = [&](int r, std::pair<int64_t, int64_t> out[2]) {
    int64_t s0 = skip_off ? (*skip_off)[r] : 0;
    int64_t s1 = s0 + (skip_len ? (*skip_len)[r] : 0);
    int n = 0;
    if (s1 <= 0 || s0 >= total) {
      out[n++] = {0, total};
    } else {
      if (s0 > 0) out[n++] = {0, s0};
      if (s1 < total) out[n++] = {s1, total};
    }
    return n;
  };
  if (rank == root) {
    // On ANY failure mid-star, poison EVERY member channel before
    // returning: live descriptors into a buffer the failed op will free
    // must not let a slow member complete a "successful" pull from
    // reused memory (only the failing channel self-poisons).
    auto poison_all = [&] {
      for (int peer : members)
        if (peer != root)
          if (ShmChannel* ch = net.shm_tx(peer)) ch->Poison();
    };
    std::pair<int64_t, int64_t> spans[2];
    for (int peer : members) {
      if (peer == root) continue;
      int n = spans_for(peer, spans);
      for (int s = 0; s < n; ++s) {
        if (spans[s].second == spans[s].first) continue;
        Status st = net.shm_tx(peer)->PushRef(
            buf + spans[s].first, spans[s].second - spans[s].first);
        if (!st.ok()) {
          poison_all();
          return st;
        }
      }
    }
    // Drain AFTER publishing to every member: the pulls overlap.
    for (int peer : members) {
      if (peer == root) continue;
      Status st = net.shm_tx(peer)->WaitDrained();
      if (!st.ok()) {
        poison_all();
        return st;
      }
    }
    return Status::OK();
  }
  std::pair<int64_t, int64_t> spans[2];
  int n = spans_for(rank, spans);
  for (int s = 0; s < n; ++s) {
    const int64_t want = spans[s].second - spans[s].first;
    if (want == 0) continue;
    size_t got = 0;
    Status st = net.shm_rx(root)->PopInto(
        buf + spans[s].first, static_cast<size_t>(want), &got);
    if (!st.ok()) return st;
    if (static_cast<int64_t>(got) != want)
      return Status::Error("star fanout: descriptor length mismatch");
  }
  return Status::OK();
}

// Chunk-pipelined intra-node chain: the leader streams the payload down
// leader -> leader+1 -> ... -> leader+L-1; downstream ranks start
// forwarding while upstream bytes are still in flight.  Shared by the
// hierarchical allreduce/allgather/Adasum fan-out phases (the
// StarFanout fallback when a channel lacks cross-memory attach).
Status ChainFanout(Network& net, uint8_t* buf, int64_t nbytes, int rank,
                   int leader, int local_size) {
  const int pos = rank - leader;
  const int64_t kChunk = 4 << 20;
  for (int64_t off = 0; off < nbytes; off += kChunk) {
    int64_t k = std::min(kChunk, nbytes - off);
    if (pos > 0) {
      Status st = RecvStream(net, rank - 1, buf + off, k);
      if (!st.ok()) return st;
    }
    if (pos < local_size - 1) {
      Status st = SendStream(net, rank + 1, buf + off, k);
      if (!st.ok()) return st;
    }
  }
  return Status::OK();
}

Status FullDuplex(Network& net, int send_peer, const uint8_t* send_buf,
                  size_t nsend, int recv_peer, uint8_t* recv_buf,
                  size_t nrecv,
                  const std::function<void(size_t)>& on_recv = nullptr) {
  if (NetResilience().enabled || net.shm_tx(send_peer) != nullptr ||
      net.shm_rx(recv_peer) != nullptr || nsend + nrecv >= (4u << 20)) {
    // Resilient mode always takes the threaded variant: the interleaved
    // single-thread poll loop below speaks the raw byte protocol and
    // cannot parse frames.
    return FullDuplexThreaded(net, send_peer, send_buf, nsend, recv_peer,
                              recv_buf, nrecv, on_recv);
  }
  const int send_fd = net.chan(send_peer)->fd();
  const int recv_fd = net.chan(recv_peer)->fd();
  size_t sent = 0, received = 0;
  while (sent < nsend || received < nrecv) {
    struct pollfd fds[2];
    int nf = 0;
    int send_i = -1, recv_i = -1;
    if (sent < nsend) {
      fds[nf] = {send_fd, POLLOUT, 0};
      send_i = nf++;
    }
    if (received < nrecv) {
      fds[nf] = {recv_fd, POLLIN, 0};
      recv_i = nf++;
    }
    int pr = ::poll(fds, nf, 60000);
    if (pr < 0 && errno == EINTR) continue;
    if (pr <= 0)
      return Status::Error("collective transfer timeout/poll error");
    if (send_i >= 0 && (fds[send_i].revents & (POLLOUT | POLLERR))) {
      ssize_t k = ::send(send_fd, send_buf + sent,
                         std::min<size_t>(nsend - sent, 4 << 20),
                         MSG_NOSIGNAL | MSG_DONTWAIT);
      if (k < 0 && errno != EAGAIN && errno != EWOULDBLOCK && errno != EINTR)
        return Status::Error("send failed in collective");
      if (k > 0) sent += k;
    }
    if (recv_i >= 0 && (fds[recv_i].revents & (POLLIN | POLLERR | POLLHUP))) {
      ssize_t k = ::recv(recv_fd, recv_buf + received,
                         std::min<size_t>(nrecv - received, 4 << 20),
                         MSG_DONTWAIT);
      if (k == 0) return Status::Aborted("peer closed during collective");
      if (k < 0 && errno != EAGAIN && errno != EWOULDBLOCK && errno != EINTR)
        return Status::Error("recv failed in collective");
      if (k > 0) {
        received += k;
        if (on_recv) on_recv(received);
      }
    }
  }
  return Status::OK();
}

}  // namespace

namespace {
template <typename T>
void FloorDivT(T* p, int64_t count, int64_t d) {
  for (int64_t i = 0; i < count; ++i) {
    int64_t v = static_cast<int64_t>(p[i]);
    int64_t q = v / d;
    if (v % d != 0 && v < 0) q -= 1;  // d (world size) is positive
    p[i] = static_cast<T>(q);
  }
}
}  // namespace

bool FloorAverageInt(void* buf, int64_t count, DataType dtype,
                     int64_t divisor) {
  switch (dtype) {
    case DataType::UINT8:
      FloorDivT(static_cast<uint8_t*>(buf), count, divisor);
      return true;
    case DataType::INT8:
      FloorDivT(static_cast<int8_t*>(buf), count, divisor);
      return true;
    case DataType::INT32:
      FloorDivT(static_cast<int32_t*>(buf), count, divisor);
      return true;
    case DataType::INT64:
      FloorDivT(static_cast<int64_t*>(buf), count, divisor);
      return true;
    default:
      return false;
  }
}

void ScaleBuffer(void* buf, int64_t count, DataType dtype, double factor) {
  if (factor == 1.0) return;
  switch (dtype) {
    case DataType::FLOAT32: {
      float* p = static_cast<float*>(buf);
      for (int64_t i = 0; i < count; ++i) p[i] *= factor;
      break;
    }
    case DataType::FLOAT64: {
      double* p = static_cast<double*>(buf);
      for (int64_t i = 0; i < count; ++i) p[i] *= factor;
      break;
    }
    case DataType::FLOAT16: {
      uint16_t* p = static_cast<uint16_t*>(buf);
      for (int64_t i = 0; i < count; ++i)
        p[i] = FloatToHalf(HalfToFloat(p[i]) * factor);
      break;
    }
    case DataType::BFLOAT16: {
      uint16_t* p = static_cast<uint16_t*>(buf);
      for (int64_t i = 0; i < count; ++i)
        p[i] = FloatToBf16(Bf16ToFloat(p[i]) * factor);
      break;
    }
    case DataType::INT32: {
      int32_t* p = static_cast<int32_t*>(buf);
      for (int64_t i = 0; i < count; ++i)
        p[i] = static_cast<int32_t>(p[i] * factor);
      break;
    }
    case DataType::INT64: {
      int64_t* p = static_cast<int64_t*>(buf);
      for (int64_t i = 0; i < count; ++i)
        p[i] = static_cast<int64_t>(p[i] * factor);
      break;
    }
    default:
      break;
  }
}

Status RingAllreduceGroup(Network& net, void* vbuf, int64_t count,
                          DataType dtype, ReduceOp op,
                          const std::vector<int>& members) {
  const int m = static_cast<int>(members.size());
  if (m <= 1 || count == 0) return Status::OK();
  int idx = -1;
  for (int i = 0; i < m; ++i)
    if (members[i] == net.rank()) idx = i;
  if (idx < 0)
    return Status::InvalidArgument("rank not in allreduce group");
  uint8_t* buf = static_cast<uint8_t*>(vbuf);
  const size_t elem = DataTypeSize(dtype);

  // Segment boundaries (last segment may be short).
  const int64_t seg = (count + m - 1) / m;
  auto seg_start = [&](int s) { return std::min<int64_t>(seg * s, count); };
  auto seg_count = [&](int s) {
    return std::min<int64_t>(seg, count - seg_start(s));
  };

  const int right = members[(idx + 1) % m];
  const int left = members[(idx - 1 + m) % m];
  // Reused across calls: a fresh segment-sized allocation per op would
  // pay tens of ms of page faults on large tensors.
  static thread_local std::vector<uint8_t> scratch;
  if (scratch.size() < static_cast<size_t>(seg * elem))
    scratch.resize(seg * elem);

  // Reduce-scatter then allgather (bandwidth-optimal ring).  The
  // reduction of each received chunk runs incrementally inside the
  // transfer (on_recv), overlapping compute with the remaining wire time
  // instead of serializing a full-segment reduce after each step.
  for (int t = 0; t < m - 1; ++t) {
    int send_s = ((idx - t) % m + m) % m;
    int recv_s = ((idx - t - 1) % m + m) % m;
    uint8_t* recv_dst = buf + seg_start(recv_s) * elem;
    size_t reduced = 0;  // elements of this segment already reduced
    auto reduce_prefix = [&](size_t received_bytes) {
      size_t avail = received_bytes / elem;
      if (avail > reduced) {
        ReduceBuf(recv_dst + reduced * elem,
                  scratch.data() + reduced * elem,
                  static_cast<int64_t>(avail - reduced), dtype, op);
        reduced = avail;
      }
    };
    Status st = FullDuplex(net, right, buf + seg_start(send_s) * elem,
                           seg_count(send_s) * elem, left, scratch.data(),
                           seg_count(recv_s) * elem, reduce_prefix);
    if (!st.ok()) return st;
  }
  for (int t = 0; t < m - 1; ++t) {
    int send_s = ((idx + 1 - t) % m + m) % m;
    int recv_s = ((idx - t) % m + m) % m;
    Status st = FullDuplex(net, right, buf + seg_start(send_s) * elem,
                           seg_count(send_s) * elem, left,
                           buf + seg_start(recv_s) * elem,
                           seg_count(recv_s) * elem);
    if (!st.ok()) return st;
  }
  return Status::OK();
}

// ---------------------------------------------------------------------------
// Graded ring recovery (rungs 3-4 of the escalation ladder).  Rungs 1-2 —
// per-frame deadlines/acks and reconnect-and-resume — live inside the
// Channel layer (net.cc) and are transparent here.  When a reconnect
// exhausts, the flat ring collectives below agree the failure across the
// fleet through the coordinator star, re-form the ring with the dead link
// never an adjacency, reset the mesh at a fresh generation, and retry the
// attempt from a pre-collective snapshot.  Only when renegotiation
// exhausts (or the coordinator link itself is dead) does the error
// propagate into HorovodInternalError → elastic reset.
// ---------------------------------------------------------------------------

namespace {

// A cyclic order of 0..P-1 in which no pair in `bad` is adjacent.
// Deterministic DFS (identical on every rank, though only rank 0 runs
// it); returns false when no such cycle exists (e.g. a rank with P-1
// dead links).
bool RingOrderDfs(int P, const std::set<std::pair<int, int>>& bad,
                  std::vector<int>& order, std::vector<bool>& used,
                  int64_t* budget) {
  auto is_bad = [&](int a, int b) {
    return bad.count({std::min(a, b), std::max(a, b)}) != 0;
  };
  if (static_cast<int>(order.size()) == P)
    return !is_bad(order.back(), order.front());
  if ((*budget)-- <= 0) return false;
  for (int cand = 0; cand < P; ++cand) {
    if (used[cand] || is_bad(order.back(), cand)) continue;
    used[cand] = true;
    order.push_back(cand);
    if (RingOrderDfs(P, bad, order, used, budget)) return true;
    order.pop_back();
    used[cand] = false;
  }
  return false;
}

bool ComputeRingOrder(int P, const std::set<std::pair<int, int>>& bad,
                      std::vector<int>* out) {
  std::vector<int> order{0};
  std::vector<bool> used(P, false);
  used[0] = true;
  int64_t budget = 1 << 20;
  if (!RingOrderDfs(P, bad, order, used, &budget)) return false;
  *out = order;
  return true;
}

// Post-attempt rendezvous at the coordinator: every rank reports
// {ok, bad_peer}; rank 0 replies {action} and, on RETRY, the permuted
// ring order plus the merged bad-link pair list.  Runs after EVERY
// resilient flat collective — a link can die so late that some ranks
// complete the attempt while others abort, and those ranks must retry
// too or the fleet deadlocks half-retried.
constexpr int32_t kRingProceed = 0;
constexpr int32_t kRingRetry = 1;
constexpr int32_t kRingFail = 2;

void PutI32(std::vector<uint8_t>& b, int32_t v) {
  const uint8_t* p = reinterpret_cast<const uint8_t*>(&v);
  b.insert(b.end(), p, p + 4);
}

int32_t GetI32(const std::vector<uint8_t>& b, size_t i) {
  int32_t v;
  memcpy(&v, b.data() + i * 4, 4);
  return v;
}

Status AgreeRingRecovery(Network& net, bool my_ok, int my_bad_peer,
                         int32_t* action, std::vector<int>* order) {
  const int size = net.size();
  const double deadline = NetResilience().op_deadline_s;
  const uint64_t epoch = net.attempt_epoch();
  order->clear();
  if (net.rank() == 0) {
    bool all_ok = my_ok;
    bool coord_fail = false;  // a rank beyond even coordinator reach
    std::set<std::pair<int, int>> bad;
    auto note = [&](int a, int b) {
      if (a >= 0 && b >= 0 && a != b)
        bad.insert({std::min(a, b), std::max(a, b)});
    };
    note(0, my_bad_peer);
    for (int b : net.bad_links()) note(0, b);
    for (int r = 1; r < size; ++r) {
      std::vector<uint8_t> msg;
      Status st = net.chan(r)->AwaitRecoveryFrame(false, epoch, &msg,
                                                  deadline);
      if (!st.ok() || msg.size() < 8) {
        all_ok = false;
        coord_fail = true;
        continue;
      }
      if (GetI32(msg, 0) == 0) all_ok = false;
      note(r, GetI32(msg, 1));
    }
    std::vector<uint8_t> resp;
    if (all_ok) {
      PutI32(resp, kRingProceed);
      *action = kRingProceed;
    } else {
      std::vector<int> new_order;
      bool can = !coord_fail && NetResilience().renegotiate &&
                 !bad.empty() && ComputeRingOrder(size, bad, &new_order);
      if (can) {
        PutI32(resp, kRingRetry);
        PutI32(resp, size);
        for (int v : new_order) PutI32(resp, v);
        PutI32(resp, static_cast<int32_t>(bad.size()));
        for (auto& pr : bad) {
          PutI32(resp, pr.first);
          PutI32(resp, pr.second);
        }
        *action = kRingRetry;
        *order = new_order;
      } else {
        PutI32(resp, kRingFail);
        *action = kRingFail;
      }
    }
    for (int r = 1; r < size; ++r) {
      Status st = net.chan(r)->SendRecoveryFrame(true, epoch, resp,
                                                 deadline);
      (void)st;  // a lost verdict surfaces as that rank's own failure
    }
    return Status::OK();
  }
  std::vector<uint8_t> report;
  PutI32(report, my_ok ? 1 : 0);
  PutI32(report, my_bad_peer);
  // Re-send the report each await slice: agreement frames live outside
  // the op stream and the replay buffer, so one lost to a reset between
  // write and delivery would otherwise never be retransmitted (the
  // frames are epoch-fenced and latest-wins — re-sending is free).
  std::vector<uint8_t> resp;
  Status st;
  auto agree_end = std::chrono::steady_clock::now() +
                   std::chrono::duration_cast<
                       std::chrono::steady_clock::duration>(
                       std::chrono::duration<double>(deadline));
  for (;;) {
    double remaining = std::chrono::duration<double>(
                           agree_end - std::chrono::steady_clock::now())
                           .count();
    if (remaining <= 0)
      return Status::Retry("ring recovery: agreement deadline");
    st = net.chan(0)->SendRecoveryFrame(false, epoch, report, remaining);
    if (!st.ok()) return st;
    st = net.chan(0)->AwaitRecoveryFrame(true, epoch, &resp,
                                         std::min(remaining, 2.0));
    if (st.ok()) break;
    if (!st.retryable()) return st;
  }
  if (resp.size() < 4)
    return Status::Error("ring recovery: short response");
  *action = GetI32(resp, 0);
  if (getenv("HVD_TPU_NET_TRACE"))
    fprintf(stderr, "[hvdagree r%d] worker got action=%d resp=%zu\n",
            net.rank(), *action, resp.size());
  if (*action == kRingRetry) {
    int n = GetI32(resp, 1);
    for (int i = 0; i < n; ++i) order->push_back(GetI32(resp, 2 + i));
    int nbad = GetI32(resp, 2 + n);
    // Record every bad pair touching this rank so MeshReset skips them
    // symmetrically on BOTH endpoints.
    for (int i = 0; i < nbad; ++i) {
      int a = GetI32(resp, 3 + n + 2 * i);
      int b = GetI32(resp, 3 + n + 2 * i + 1);
      if (a == net.rank()) net.NoteBadLink(b);
      if (b == net.rank()) net.NoteBadLink(a);
    }
  }
  return Status::OK();
}

// Run a flat ring collective under the full escalation ladder.
// `snapshot`/`restore` bracket the in-place mutation so a renegotiated
// retry reruns from the original input.
Status RunResilientRing(
    Network& net, const std::function<void()>& snapshot,
    const std::function<void()>& restore,
    const std::function<Status(const std::vector<int>&)>& fn) {
  if (!NetResilience().enabled || net.size() <= 1)
    return fn(net.ring_order());
  if (!NetResilience().renegotiate) {
    // Rung 3 off: reconnect-and-resume (inside the channels) still
    // heals transient faults transparently, but there is no
    // renegotiation and therefore no per-collective agreement or
    // snapshot to pay for — exhausted reconnects escalate directly.
    net.BeginAttempt();
    return fn(net.ring_order());
  }
  if (snapshot) snapshot();
  int renegs = 0;
  bool recovered_any = false;
  for (;;) {
    net.BeginAttempt();
    Status st = fn(net.ring_order());
    if (getenv("HVD_TPU_NET_TRACE"))
      fprintf(stderr, "[hvdring r%d] fn st=%d %s\n", net.rank(),
              (int)st.type, st.reason.c_str());
    // EVERY failure joins the agreement — including non-retryable ones
    // (e.g. a same-host neighbor's shm op timing out because the abort
    // broadcast cannot unblock shared memory): skipping it would leave
    // the fleet's agreement one report short and convert a repairable
    // link death into a blanket kRingFail.  Genuinely symmetric
    // validation errors carry no bad link, so the coordinator answers
    // kRingFail and the error still surfaces unchanged.
    int bad_peer = net.TakeLastBadPeer();
    if (!st.ok()) net.BroadcastAbort();
    int32_t action = kRingProceed;
    std::vector<int> order;
    Status ag = AgreeRingRecovery(net, st.ok(), st.ok() ? -1 : bad_peer,
                                  &action, &order);
    if (!ag.ok()) return st.ok() ? ag : st;
    if (action == kRingProceed) {
      if (recovered_any && st.ok()) NetCounters().resets_avoided++;
      return st;
    }
    if (action == kRingFail)
      return st.ok() ? Status::Error(
                           "ring recovery: fleet agreed the collective "
                           "cannot be repaired")
                     : st;
    if (++renegs > NetResilience().max_renegotiations)
      return Status::Error("ring recovery: renegotiation limit reached");
    net.set_ring_order(order);
    Status mr = net.MeshReset(NetResilience().reconnect_s * 2 + 5.0);
    if (!mr.ok()) return mr;
    NetCounters().renegotiations++;
    NetCounters().last_recovery_ms.store(SteadyNowMs());
    recovered_any = true;
    if (restore) restore();
  }
}

}  // namespace

namespace {
// Schedule marker for tests/observability (0 = flat ring / flat VHDD,
// 1 = hierarchical) — the allreduce analog of g_allgather_schedule;
// stored only by COMPLETED top-level entry points (RingAllreduceGroup
// runs inside hierarchical phases and must not clobber it).
std::atomic<int> g_allreduce_schedule{0};
}  // namespace

int LastAllreduceSchedule() { return g_allreduce_schedule.load(); }

Status RingAllreduce(Network& net, void* vbuf, int64_t count, DataType dtype,
                     ReduceOp op, const std::function<void()>* restore) {
  const size_t nbytes = count * DataTypeSize(dtype);
  uint8_t* buf = static_cast<uint8_t*>(vbuf);
  Status st;
  if (restore != nullptr && *restore) {
    // The caller can rebuild buf from still-intact inputs: no
    // pre-collective snapshot copy on the clean path at all.
    st = RunResilientRing(
        net, nullptr, *restore, [&](const std::vector<int>& members) {
          return RingAllreduceGroup(net, vbuf, count, dtype, op, members);
        });
  } else {
    // Fallback (true in-place aliasing, hierarchical degenerate paths):
    // the ring mutates buf, so a renegotiated retry needs the original
    // addends back — one memcpy per collective when resilience is on.
    thread_local std::vector<uint8_t> snap;
    st = RunResilientRing(
        net,
        [&] {
          if (snap.size() < nbytes) snap.resize(nbytes);
          memcpy(snap.data(), buf, nbytes);
        },
        [&] { memcpy(buf, snap.data(), nbytes); },
        [&](const std::vector<int>& members) {
          return RingAllreduceGroup(net, vbuf, count, dtype, op, members);
        });
  }
  if (st.ok()) g_allreduce_schedule.store(0);
  return st;
}

namespace {
// Schedule markers for tests/observability: most recent hierarchical
// allreduce/Adasum fan-out and most recent broadcast on this process
// (0 = flat/none, 1 = pipelined chain, 2 = zero-copy CMA star).
std::atomic<int> g_allreduce_fanout{0};
std::atomic<int> g_bcast_schedule{0};

bool ForceChainEnv(const char* name) {
  const char* v = getenv(name);
  return v && std::string(v) == "chain";
}

// Star cutoff for full-payload fan-outs (allreduce/Adasum/broadcast):
// below this the chain's shm-slot memcpys beat CMA descriptor+syscall
// overhead (same rationale as SendStream's CMA threshold).
constexpr int64_t kStarMinBytes = 1 << 20;

// Shared phase-3 delivery for the hierarchical allreduce family
// (allreduce + Adasum): star-or-chain under HVD_TPU_AR_FANOUT, with
// the completed schedule recorded in g_allreduce_fanout.
Status StarOrChainArFanout(Network& net, void* vbuf, int64_t nbytes,
                           int rank, int leader,
                           const std::vector<int>& local_members,
                           int local_size) {
  static const bool force_chain = ForceChainEnv("HVD_TPU_AR_FANOUT");
  bool used_star = false;
  Status st = StarFanout(net, static_cast<uint8_t*>(vbuf), nbytes, leader,
                         local_members, force_chain, kStarMinBytes,
                         &used_star);
  if (!st.ok()) return st;
  if (used_star) {
    g_allreduce_fanout.store(2);
    return st;
  }
  st = ChainFanout(net, static_cast<uint8_t*>(vbuf), nbytes, rank, leader,
                   local_size);
  if (st.ok()) g_allreduce_fanout.store(1);
  return st;
}
}  // namespace

int LastAllreduceFanout() { return g_allreduce_fanout.load(); }
int LastBroadcastSchedule() { return g_bcast_schedule.load(); }

Status HierarchicalAllreduce(Network& net, void* vbuf, int64_t count,
                             DataType dtype, ReduceOp op, int local_size) {
  const int size = net.size();
  const int rank = net.rank();
  if (local_size <= 1 || size % local_size != 0 || size == local_size) {
    g_allreduce_fanout.store(0);
    return RingAllreduce(net, vbuf, count, dtype, op);
  }
  const int node = rank / local_size;
  const int leader = node * local_size;

  // Phase 1: intra-node allreduce (short hops — ICI analog).
  std::vector<int> local_members(local_size);
  for (int i = 0; i < local_size; ++i) local_members[i] = leader + i;
  Status st = RingAllreduceGroup(net, vbuf, count, dtype, op,
                                 local_members);
  if (!st.ok()) return st;

  // Phase 2: node leaders reduce across nodes (long hops — DCN analog).
  // Phase-1 result is the node total for SUM/MIN/MAX/PRODUCT, so the
  // leader ring produces the global reduction directly.
  const int n_nodes = size / local_size;
  if (rank == leader) {
    std::vector<int> leaders(n_nodes);
    for (int i = 0; i < n_nodes; ++i) leaders[i] = i * local_size;
    st = RingAllreduceGroup(net, vbuf, count, dtype, op, leaders);
    if (!st.ok()) return st;
  }

  // Phase 3: leaders deliver the global result within their node —
  // zero-copy CMA star when the payload is large and every
  // leader->member channel supports cross-memory attach, pipelined
  // chain otherwise (HVD_TPU_AR_FANOUT=chain forces the chain for
  // benchmarking).  Markers record only schedules that COMPLETED — a
  // failed fan-out must not read as the schedule that never ran.
  st = StarOrChainArFanout(net, vbuf, count * DataTypeSize(dtype),
                           rank, leader, local_members, local_size);
  if (st.ok()) g_allreduce_schedule.store(1);
  return st;
}

namespace {
// Schedule marker for tests/observability (0 flat ring, 1 hierarchical).
std::atomic<int> g_allgather_schedule{0};

// Ring allgatherv restricted to `members`; bytes/offsets are indexed by
// member *position* (block i belongs to members[i]).
Status RingAllgathervGroup(Network& net, uint8_t* buf,
                           const std::vector<int64_t>& bytes,
                           const std::vector<int64_t>& offsets,
                           const std::vector<int>& members) {
  const int m = static_cast<int>(members.size());
  if (m <= 1) return Status::OK();
  int idx = -1;
  for (int i = 0; i < m; ++i)
    if (members[i] == net.rank()) idx = i;
  if (idx < 0)
    return Status::InvalidArgument("rank not in allgather group");
  const int right = members[(idx + 1) % m];
  const int left = members[(idx - 1 + m) % m];
  for (int t = 0; t < m - 1; ++t) {
    int send_b = ((idx - t) % m + m) % m;
    int recv_b = ((idx - t - 1) % m + m) % m;
    Status st = FullDuplex(net, right, buf + offsets[send_b],
                           bytes[send_b], left, buf + offsets[recv_b],
                           bytes[recv_b]);
    if (!st.ok()) return st;
  }
  return Status::OK();
}
}  // namespace

int LastAllgatherSchedule() { return g_allgather_schedule.load(); }

Status RingAllgatherv(Network& net, uint8_t* buf,
                      const std::vector<int64_t>& bytes,
                      const std::vector<int64_t>& offsets) {
  // No schedule-marker store here: internal users (Adasum gather+tree,
  // VHDD reassembly) must not clobber the user-level allgather hook —
  // HierarchicalAllgatherv is the marker-setting entry point.
  //
  // No retry snapshot needed: the ring never rewrites a rank's own
  // block, and every other block is pure output.
  return RunResilientRing(
      net, nullptr, nullptr, [&](const std::vector<int>& members) {
        // bytes/offsets are indexed BY RANK; the group ring indexes by
        // member POSITION — remap for permuted (renegotiated) orders.
        std::vector<int64_t> pb(members.size()), po(members.size());
        for (size_t i = 0; i < members.size(); ++i) {
          pb[i] = bytes[members[i]];
          po[i] = offsets[members[i]];
        }
        return RingAllgathervGroup(net, buf, pb, po, members);
      });
}

Status HierarchicalAllgatherv(Network& net, uint8_t* buf,
                              const std::vector<int64_t>& bytes,
                              const std::vector<int64_t>& offsets,
                              int local_size) {
  const int size = net.size();
  const int rank = net.rank();
  if (local_size <= 1 || size % local_size != 0 || size == local_size) {
    g_allgather_schedule.store(0);
    return RingAllgatherv(net, buf, bytes, offsets);
  }
  g_allgather_schedule.store(1);
  const int node = rank / local_size;
  const int leader = node * local_size;
  const int n_nodes = size / local_size;

  // Phase 1: node members stage their block on the leader (intra-node
  // hops — shm/CMA when available; the reference's shared-memory window,
  // MEMCPY_IN_SHARED_BUFFER).  SendStream/RecvStream chunk internally.
  if (rank == leader) {
    for (int i = 1; i < local_size; ++i) {
      int peer = leader + i;
      Status st = RecvStream(net, peer, buf + offsets[peer], bytes[peer]);
      if (!st.ok()) return st;
    }
  } else {
    Status st = SendStream(net, leader, buf + offsets[rank], bytes[rank]);
    if (!st.ok()) return st;
  }

  // Phase 2: leaders ring-allgatherv node-level blocks (rank order makes
  // each node's member regions contiguous).
  if (rank == leader) {
    std::vector<int64_t> node_bytes(n_nodes), node_offs(n_nodes);
    std::vector<int> leaders(n_nodes);
    for (int b = 0; b < n_nodes; ++b) {
      leaders[b] = b * local_size;
      node_offs[b] = offsets[static_cast<size_t>(b) * local_size];
      int64_t tot = 0;
      for (int i = 0; i < local_size; ++i)
        tot += bytes[static_cast<size_t>(b) * local_size + i];
      node_bytes[b] = tot;
    }
    Status st = RingAllgathervGroup(net, buf, node_bytes, node_offs,
                                    leaders);
    if (!st.ok()) return st;
  }

  // Phase 3: deliver the assembled result to the node's members.
  //
  // Fast path — zero-copy STAR (the reference's shared-memory-window
  // analog, MEMCPY_IN_SHARED_BUFFER): when every leader->member channel
  // supports cross-memory attach, the leader publishes at most two CMA
  // descriptors per member (the buffer minus that member's own block)
  // and all members pull directly from the leader's memory
  // CONCURRENTLY — one copy per member, none for the leader, no
  // per-hop forwarding.  Fallback — pipelined chain, skipping each
  // receiver's own block.  The leader picks and announces the mode
  // in-band (one flag byte per member) so capability asymmetries can
  // never desynchronize the framing.
  const int pos = rank - leader;
  int64_t total = 0;
  for (auto b : bytes) total += b;
  auto minus = [](int64_t s, int64_t e, int64_t bs, int64_t be,
                  std::pair<int64_t, int64_t> out[2]) {
    int n = 0;
    if (be <= s || bs >= e) {
      out[n++] = {s, e};
    } else {
      if (bs > s) out[n++] = {s, bs};
      if (be < e) out[n++] = {be, e};
    }
    return n;
  };

  // Star via the shared StarFanout (skip spans exclude each member's
  // own block — it already holds its contribution).  star_min = 0: the
  // leader staging already dominates small allgathers, and the
  // schedule-marker tests pin tiny payloads to the star path.
  // HVD_TPU_AG_FANOUT=chain forces the chain (benchmark head-to-head
  // comparison knob, like HVD_TPU_ADASUM_ALGO).
  {
    static const bool force_chain = ForceChainEnv("HVD_TPU_AG_FANOUT");
    std::vector<int> members(local_size);
    for (int i = 0; i < local_size; ++i) members[i] = leader + i;
    bool used_star = false;
    Status st = StarFanout(net, buf, total, leader, members, force_chain,
                           0, &used_star, &offsets, &bytes);
    if (!st.ok()) return st;
    // Observability: 1 = hierarchical chain fan-out, 2 = hierarchical
    // CMA star (this rank's node; tests assert the intended path
    // actually ran).  Stored only for schedules that COMPLETED.
    if (used_star) {
      g_allgather_schedule.store(2);
      return st;
    }
  }
  const int64_t kChunk = 4 << 20;
  for (int64_t off = 0; off < total; off += kChunk) {
    const int64_t end = std::min(off + kChunk, total);
    std::pair<int64_t, int64_t> spans[2];
    if (pos > 0) {
      int n = minus(off, end, offsets[rank], offsets[rank] + bytes[rank],
                    spans);
      for (int i = 0; i < n; ++i) {
        Status st = RecvStream(net, rank - 1, buf + spans[i].first,
                               spans[i].second - spans[i].first);
        if (!st.ok()) return st;
      }
    }
    if (pos < local_size - 1) {
      const int nxt = rank + 1;
      int n = minus(off, end, offsets[nxt], offsets[nxt] + bytes[nxt],
                    spans);
      for (int i = 0; i < n; ++i) {
        Status st = SendStream(net, nxt, buf + spans[i].first,
                               spans[i].second - spans[i].first);
        if (!st.ok()) return st;
      }
    }
  }
  g_allgather_schedule.store(1);
  return Status::OK();
}

Status ChainBroadcast(Network& net, void* vbuf, int64_t nbytes, int root) {
  const int size = net.size();
  const int rank = net.rank();
  if (size == 1 || nbytes == 0) return Status::OK();
  uint8_t* buf = static_cast<uint8_t*>(vbuf);
  // Zero-copy CMA star when the payload is large and every root->rank
  // channel supports cross-memory attach (single-host broadcast: one
  // concurrent pull per rank instead of size-1 chained
  // store-and-forward hops); pipelined chain otherwise
  // (HVD_TPU_BCAST_FANOUT=chain forces it).  Small broadcasts skip the
  // star and its O(size) mode-byte exchange entirely — nbytes is known
  // identically on every rank, so the short-circuit is symmetric.
  {
    static const bool force_chain = ForceChainEnv("HVD_TPU_BCAST_FANOUT");
    std::vector<int> all(size);
    for (int i = 0; i < size; ++i) all[i] = i;
    bool used_star = false;
    Status st = StarFanout(net, buf, nbytes, root, all, force_chain,
                           kStarMinBytes, &used_star);
    if (!st.ok()) return st;
    if (used_star) {
      g_bcast_schedule.store(2);
      return st;
    }
  }
  // Rotate so root is position 0 in the chain; forward chunk-by-chunk so
  // the chain pipelines (downstream ranks start receiving while upstream
  // bytes are still in flight) instead of store-and-forwarding the whole
  // payload at each hop.
  int pos = ((rank - root) % size + size) % size;
  int prev = (rank - 1 + size) % size;
  int next = (rank + 1) % size;
  const int64_t kChunk = 4 << 20;
  for (int64_t off = 0; off < nbytes; off += kChunk) {
    int64_t k = std::min(kChunk, nbytes - off);
    if (pos > 0) {
      Status st = RecvStream(net, prev, buf + off, k);
      if (!st.ok()) return st;
    }
    if (pos < size - 1) {
      Status st = SendStream(net, next, buf + off, k);
      if (!st.ok()) return st;
    }
  }
  g_bcast_schedule.store(1);
  return Status::OK();
}

Status AgreeAllRanks(Network& net, int32_t* ok, int32_t* first_bad_rank) {
  *first_bad_rank = (*ok != 0) ? -1 : net.rank();
  if (net.size() == 1) return Status::OK();
  // Star over the mesh sockets (raw 8-byte exchange, no framing): rank 0
  // gathers [ok, rank], ANDs, broadcasts [all_ok, first_bad].  Safe on
  // the shared sockets because every rank reaches this call at the same
  // point of the identical coordinator response schedule.
  int32_t msg[2] = {*ok, *first_bad_rank};
  if (net.rank() == 0) {
    for (int r = 1; r < net.size(); ++r) {
      int32_t peer[2];
      Status st = net.chan(r)->Recv(reinterpret_cast<uint8_t*>(peer),
                                    sizeof(peer), nullptr, true);
      if (!st.ok()) return st;
      if (peer[0] == 0 && (msg[1] < 0 || peer[1] < msg[1])) msg[1] = peer[1];
      msg[0] &= peer[0];
    }
    for (int r = 1; r < net.size(); ++r) {
      Status st = net.chan(r)->Send(reinterpret_cast<const uint8_t*>(msg),
                                    sizeof(msg), true);
      if (!st.ok()) return st;
    }
  } else {
    Status st = net.coordinator_chan()->Send(
        reinterpret_cast<const uint8_t*>(msg), sizeof(msg), true);
    if (!st.ok()) return st;
    st = net.coordinator_chan()->Recv(reinterpret_cast<uint8_t*>(msg),
                                      sizeof(msg), nullptr, true);
    if (!st.ok()) return st;
  }
  *ok = msg[0];
  *first_bad_rank = msg[1];
  return Status::OK();
}

Status PairwiseAlltoallv(Network& net, const uint8_t* send,
                         const std::vector<int64_t>& send_bytes,
                         uint8_t* recv,
                         const std::vector<int64_t>& recv_bytes) {
  const int size = net.size();
  const int rank = net.rank();
  std::vector<int64_t> soff(size + 1, 0), roff(size + 1, 0);
  for (int i = 0; i < size; ++i) {
    soff[i + 1] = soff[i] + send_bytes[i];
    roff[i + 1] = roff[i] + recv_bytes[i];
  }
  // Self copy.
  memcpy(recv + roff[rank], send + soff[rank], send_bytes[rank]);
  for (int d = 1; d < size; ++d) {
    int to = (rank + d) % size;
    int from = (rank - d + size) % size;
    Status st = FullDuplex(net, to, send + soff[to], send_bytes[to],
                           from, recv + roff[from], recv_bytes[from]);
    if (!st.ok()) return st;
  }
  return Status::OK();
}

namespace {

template <typename T>
void AdasumPair(T* a, const T* b, int64_t n) {
  double dot = 0, na = 0, nb = 0;
  for (int64_t i = 0; i < n; ++i) {
    double x = static_cast<double>(a[i]);
    double y = static_cast<double>(b[i]);
    dot += x * y;
    na += x * x;
    nb += y * y;
  }
  double ac = na > 0 ? 1.0 - dot / (2.0 * na) : 1.0;
  double bc = nb > 0 ? 1.0 - dot / (2.0 * nb) : 1.0;
  for (int64_t i = 0; i < n; ++i)
    a[i] = static_cast<T>(ac * static_cast<double>(a[i]) +
                          bc * static_cast<double>(b[i]));
}

template <typename T>
void AdasumTree(std::vector<std::vector<uint8_t>>& bufs, int64_t n) {
  // Pair (0,1),(2,3)... then pairs-of-pairs — same tree as ops/adasum.py.
  size_t m = bufs.size();
  std::vector<int> live(m);
  for (size_t i = 0; i < m; ++i) live[i] = static_cast<int>(i);
  while (live.size() > 1) {
    std::vector<int> nxt;
    for (size_t i = 0; i + 1 < live.size(); i += 2) {
      AdasumPair(reinterpret_cast<T*>(bufs[live[i]].data()),
                 reinterpret_cast<const T*>(bufs[live[i + 1]].data()), n);
      nxt.push_back(live[i]);
    }
    if (live.size() % 2 == 1) nxt.push_back(live.back());
    live = nxt;
  }
  if (live[0] != 0) bufs[0] = bufs[live[0]];
}

// Scratch-memory instrumentation for the VHDD path (tested: the schedule
// must stay O(|t|), unlike the old gather+tree's O(P*|t|)).
std::atomic<int64_t> g_adasum_scratch_peak{0};

int BitRev(int i, int bits) {
  int r = 0;
  for (int b = 0; b < bits; ++b) r = (r << 1) | ((i >> b) & 1);
  return r;
}

// Vector-halving distance-doubling Adasum on a typed working buffer
// (reference chunked pairwise VHDD, adasum.h:168-395 / adasum_mpi.cc:
// 107-110; same schedule as the compiled ladder in ops/adasum.py).
// O(|t|) scratch; members.size() must be a power of two.  Chunked wire
// transfers are inherited from SendStream/RecvStream/FullDuplex (4 MB
// chunks / shm slots).  `members` lets hierarchical schedules run the
// ladder over node leaders only (reference adasum_gpu_operations.cc).
template <typename T>
Status AdasumVHDDImpl(Network& net, T* data, int64_t count,
                      const std::vector<int>& members) {
  const int P = static_cast<int>(members.size());
  int rank = -1;  // index within the group
  for (int i = 0; i < P; ++i)
    if (members[i] == net.rank()) rank = i;
  if (rank < 0)
    return Status::InvalidArgument("rank not in adasum group");
  const int levels = __builtin_ctz(P);
  const int64_t L = ((count + P - 1) / P) * P;
  int64_t scratch = 0;
  auto track = [&](int64_t bytes) {
    scratch += bytes;
    int64_t prev = g_adasum_scratch_peak.load();
    while (scratch > prev &&
           !g_adasum_scratch_peak.compare_exchange_weak(prev, scratch)) {
    }
  };

  std::vector<T> x(L, T(0));
  track(L * sizeof(T));
  memcpy(x.data(), data, count * sizeof(T));
  std::vector<T> recv(L / 2);
  track((L / 2) * sizeof(T));

  int64_t cur = L;
  for (int level = 0; level < levels; ++level) {
    const int d = 1 << level;
    const int partner = members[rank ^ d];
    const int64_t half = cur / 2;
    const int bit = (rank >> level) & 1;
    T* lower = x.data();
    T* upper = x.data() + half;
    T* keep = bit == 0 ? lower : upper;
    T* send = bit == 0 ? upper : lower;
    Status st = FullDuplex(
        net, partner, reinterpret_cast<const uint8_t*>(send),
        half * sizeof(T), partner, reinterpret_cast<uint8_t*>(recv.data()),
        half * sizeof(T));
    if (!st.ok()) return st;
    // Role assignment matches ops/adasum.py: "a" is the lower (bit==0)
    // block's logical vector, "b" the upper's, so the group-summed
    // partials are the true full-vector dot and norms.
    const T* a = bit == 0 ? keep : recv.data();
    const T* b = bit == 0 ? recv.data() : keep;
    double partials[3] = {0.0, 0.0, 0.0};  // dot, ||a||^2, ||b||^2
    for (int64_t i = 0; i < half; ++i) {
      const double av = static_cast<double>(a[i]);
      const double bv = static_cast<double>(b[i]);
      partials[0] += av * bv;
      partials[1] += av * av;
      partials[2] += bv * bv;
    }
    // Sum the 24-byte partials over the 2d-member group by recursive
    // doubling: log2(2d) pairwise exchanges instead of a 2*(2d-1)-step
    // ring — the scalar reduction is latency-bound, especially on the
    // cross-node (DCN-analog) levels.  Commutative fp addition makes the
    // per-rank results bitwise identical.
    const int group = 2 * d;
    const int base = (rank / group) * group;
    for (int h = 1; h < group; h <<= 1) {
      const int peer = members[base + ((rank - base) ^ h)];
      double incoming[3];
      Status gst = FullDuplex(
          net, peer, reinterpret_cast<const uint8_t*>(partials),
          sizeof(partials), peer, reinterpret_cast<uint8_t*>(incoming),
          sizeof(incoming));
      if (!gst.ok()) return gst;
      partials[0] += incoming[0];
      partials[1] += incoming[1];
      partials[2] += incoming[2];
    }
    const double dot = partials[0], na = partials[1], nb = partials[2];
    const double ac = na > 0 ? 1.0 - dot / (2.0 * na) : 1.0;
    const double bc = nb > 0 ? 1.0 - dot / (2.0 * nb) : 1.0;
    T* dst = x.data();
    for (int64_t i = 0; i < half; ++i)
      dst[i] = static_cast<T>(ac * static_cast<double>(a[i]) +
                              bc * static_cast<double>(b[i]));
    cur = half;
  }

  // Each rank holds fragment bit_reverse(rank); the reordering happens in
  // the allgather's offset table (no post-pass).
  const int64_t frag = L / P;
  std::vector<T> mine(x.begin(), x.begin() + frag);
  track(frag * sizeof(T));
  x.clear();
  x.shrink_to_fit();
  track(-L * static_cast<int64_t>(sizeof(T)));
  recv.clear();
  recv.shrink_to_fit();
  track(-(L / 2) * static_cast<int64_t>(sizeof(T)));

  std::vector<T> full(L);
  track(L * sizeof(T));
  std::vector<int64_t> bytes(P, frag * sizeof(T)), offs(P);
  for (int r = 0; r < P; ++r)
    offs[r] = static_cast<int64_t>(BitRev(r, levels)) * frag * sizeof(T);
  memcpy(reinterpret_cast<uint8_t*>(full.data()) + offs[rank], mine.data(),
         frag * sizeof(T));
  Status st = RingAllgathervGroup(
      net, reinterpret_cast<uint8_t*>(full.data()), bytes, offs, members);
  if (!st.ok()) return st;
  memcpy(data, full.data(), count * sizeof(T));
  return Status::OK();
}

// Non-power-of-two fallback: gather + coefficient tree (exact, O(P*|t|)
// scratch — the reference restricts Adasum to power-of-two worlds,
// tensorflow/__init__.py:146-147).
template <typename T>
Status AdasumGatherTree(Network& net, T* data, int64_t count) {
  const int size = net.size();
  const size_t nbytes = count * sizeof(T);
  std::vector<std::vector<uint8_t>> bufs(size);
  std::vector<int64_t> bytes(size, nbytes), offsets(size);
  std::vector<uint8_t> gathered(nbytes * size);
  for (int i = 0; i < size; ++i) offsets[i] = i * nbytes;
  memcpy(gathered.data() + net.rank() * nbytes, data, nbytes);
  Status st = RingAllgatherv(net, gathered.data(), bytes, offsets);
  if (!st.ok()) return st;
  for (int i = 0; i < size; ++i)
    bufs[i].assign(gathered.begin() + i * nbytes,
                   gathered.begin() + (i + 1) * nbytes);
  AdasumTree<T>(bufs, count);
  memcpy(data, bufs[0].data(), nbytes);
  return Status::OK();
}

// HVD_TPU_ADASUM_ALGO=tree forces the gather+tree fallback at any world
// size so the two algorithms can be benchmarked head-to-head at the same
// np (the reference exposes no such knob; pow2 worlds always take VHDD).
inline bool ForceAdasumTree() {
  static const bool force = [] {
    const char* v = getenv("HVD_TPU_ADASUM_ALGO");
    return v && std::string(v) == "tree";
  }();
  return force;
}

template <typename T>
Status AdasumTyped(Network& net, T* data, int64_t count) {
  const int P = net.size();
  if (ForceAdasumTree() || (P & (P - 1)))
    return AdasumGatherTree<T>(net, data, count);
  std::vector<int> all(P);
  for (int i = 0; i < P; ++i) all[i] = i;
  return AdasumVHDDImpl<T>(net, data, count, all);
}

// Run `fn(float* work)` on an fp32 copy of a 16-bit buffer, writing the
// result back in the wire dtype (fp32 accumulation for fp16/bf16 — the
// reference's fp16 Adasum kernel policy).
template <typename Fn>
Status With16BitAsFloat(void* vbuf, int64_t count, DataType dtype, Fn fn) {
  std::vector<float> work(count);
  uint16_t* raw = static_cast<uint16_t*>(vbuf);
  if (dtype == DataType::FLOAT16) {
    for (int64_t i = 0; i < count; ++i) work[i] = HalfToFloat(raw[i]);
  } else {
    for (int64_t i = 0; i < count; ++i) work[i] = Bf16ToFloat(raw[i]);
  }
  Status st = fn(work.data());
  if (!st.ok()) return st;
  if (dtype == DataType::FLOAT16) {
    for (int64_t i = 0; i < count; ++i) raw[i] = FloatToHalf(work[i]);
  } else {
    for (int64_t i = 0; i < count; ++i) raw[i] = FloatToBf16(work[i]);
  }
  return Status::OK();
}

// Typed Adasum over a rank subgroup (node leaders) with the same 16-bit
// conversion policy as the public entry point.
Status AdasumGroup(Network& net, void* vbuf, int64_t count, DataType dtype,
                   const std::vector<int>& members) {
  switch (dtype) {
    case DataType::FLOAT64:
      return AdasumVHDDImpl<double>(net, static_cast<double*>(vbuf), count,
                                    members);
    case DataType::FLOAT32:
      return AdasumVHDDImpl<float>(net, static_cast<float*>(vbuf), count,
                                   members);
    case DataType::FLOAT16:
    case DataType::BFLOAT16:
      return With16BitAsFloat(vbuf, count, dtype, [&](float* w) {
        return AdasumVHDDImpl<float>(net, w, count, members);
      });
    default:
      return Status::InvalidArgument(
          "eager Adasum supports float16/bfloat16/float32/float64");
  }
}

}  // namespace

int64_t AdasumScratchPeak() { return g_adasum_scratch_peak.load(); }
void ResetAdasumScratchPeak() { g_adasum_scratch_peak.store(0); }

Status AdasumAllreduce(Network& net, void* vbuf, int64_t count,
                       DataType dtype) {
  const int size = net.size();
  if (size == 1 || count == 0) return Status::OK();
  Status st;
  switch (dtype) {
    case DataType::FLOAT64:
      st = AdasumTyped<double>(net, static_cast<double*>(vbuf), count);
      break;
    case DataType::FLOAT32:
      st = AdasumTyped<float>(net, static_cast<float*>(vbuf), count);
      break;
    case DataType::FLOAT16:
    case DataType::BFLOAT16:
      // fp32 accumulation for 16-bit wires (reference fp16 Adasum kernels,
      // adasum.h AVX/F16C specializations — portable here).
      st = With16BitAsFloat(vbuf, count, dtype, [&](float* w) {
        return AdasumTyped<float>(net, w, count);
      });
      break;
    default:
      return Status::InvalidArgument(
          "eager Adasum supports float16/bfloat16/float32/float64");
  }
  if (st.ok()) g_allreduce_schedule.store(0);
  return st;
}

namespace {

Status HierarchicalAdasumImpl(Network& net, void* vbuf, int64_t count,
                              DataType dtype, int local_size);

}  // namespace

Status HierarchicalAdasum(Network& net, void* vbuf, int64_t count,
                          DataType dtype, int local_size) {
  // Reference AdasumGpuAllreduceOp (adasum_gpu_operations.cc:38-…):
  // intra-node reduction, cross-node VHDD between node leaders, intra-node
  // fan-out, with local averaging folded in (operations.cc:968-975; the
  // Adasum coefficients are scale-invariant, so Adasum(node sums)/L ==
  // Adasum(node means)).
  // Validate dtype BEFORE phase 1: the intra-node sum would succeed on
  // every rank while phase-2 AdasumGroup failed on leaders only, leaving
  // non-leaders stalled in the fan-out — all ranks must fail
  // symmetrically, like the flat path does.
  if (dtype != DataType::FLOAT16 && dtype != DataType::BFLOAT16 &&
      dtype != DataType::FLOAT32 && dtype != DataType::FLOAT64)
    return Status::InvalidArgument(
        "eager Adasum supports float16/bfloat16/float32/float64");
  if (dtype == DataType::FLOAT16 || dtype == DataType::BFLOAT16) {
    // fp32 accumulation for 16-bit wires across ALL phases, matching the
    // flat path (which converts the whole buffer before any reduction):
    // fp16 intra-node partial sums would overflow at moderate local_size
    // and the hierarchical result would diverge from the flat one.
    return With16BitAsFloat(vbuf, count, dtype, [&](float* w) {
      return HierarchicalAdasumImpl(net, w, count, DataType::FLOAT32,
                                    local_size);
    });
  }
  return HierarchicalAdasumImpl(net, vbuf, count, dtype, local_size);
}

namespace {

Status HierarchicalAdasumImpl(Network& net, void* vbuf, int64_t count,
                              DataType dtype, int local_size) {
  const int size = net.size();
  const int rank = net.rank();
  const int n_nodes = local_size > 0 ? size / local_size : 0;
  if (local_size <= 1 || size % local_size != 0 || size == local_size ||
      (n_nodes & (n_nodes - 1)) != 0) {
    g_allreduce_fanout.store(0);
    return AdasumAllreduce(net, vbuf, count, dtype);
  }
  if (count == 0) return Status::OK();
  const int node = rank / local_size;
  const int leader = node * local_size;

  // Phase 1: intra-node sum (short hops — ICI analog).
  std::vector<int> local_members(local_size);
  for (int i = 0; i < local_size; ++i) local_members[i] = leader + i;
  Status st = RingAllreduceGroup(net, vbuf, count, dtype, ReduceOp::SUM,
                                 local_members);
  if (!st.ok()) return st;

  // Phase 2: node leaders combine node sums with the VHDD ladder
  // (long hops — DCN analog), then fold in the local average.
  if (rank == leader) {
    std::vector<int> leaders(n_nodes);
    for (int i = 0; i < n_nodes; ++i) leaders[i] = i * local_size;
    st = AdasumGroup(net, vbuf, count, dtype, leaders);
    if (!st.ok()) return st;
    ScaleBuffer(vbuf, count, dtype, 1.0 / local_size);
  }

  // Phase 3: leaders deliver the result within their node (same star-
  // or-chain schedule as HierarchicalAllreduce phase 3; markers record
  // only completed schedules).
  st = StarOrChainArFanout(net, vbuf, count * DataTypeSize(dtype),
                           rank, leader, local_members, local_size);
  if (st.ok()) g_allreduce_schedule.store(1);
  return st;
}

}  // namespace

}  // namespace hvdtpu
