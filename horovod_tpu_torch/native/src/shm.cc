#include "shm.h"

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <sched.h>
#include <sys/uio.h>
#include <unistd.h>

#include <cerrno>
#include <chrono>
#include <cstring>

namespace hvdtpu {

namespace {

constexpr size_t kMapBytes =
    sizeof(ShmChannel::Hdr) + ShmChannel::kSlots * ShmChannel::kSlotBytes;
constexpr uint64_t kProbeMagic = 0x48764474707531ULL;

// Bounded wait on a shm condition: brief spin for the multi-core
// streaming case, then sched_yield — on an oversubscribed or single-CPU
// host a pure spin PREVENTS the peer from running until the spinner's
// timeslice ends, and a usleep(50) pays ~wakeup-latency per ring-slot
// handoff (measured: shm lost to TCP at 1MB payloads on a 1-core box
// because blocking socket reads hand the CPU to the producer
// immediately).  yield gives the same immediate handoff; micro-sleeps
// only as the deep fallback.  60 s deadline like the socket paths.
template <typename Cond>
Status WaitFor(Cond cond, const char* what) {
  for (int i = 0; i < 64; ++i) {
    if (cond()) return Status::OK();
  }
  for (int i = 0; i < 4096; ++i) {
    if (cond()) return Status::OK();
    ::sched_yield();
  }
  auto deadline =
      std::chrono::steady_clock::now() + std::chrono::seconds(60);
  while (!cond()) {
    if (std::chrono::steady_clock::now() > deadline)
      return Status::Error(std::string("shm channel timeout: ") + what);
    ::usleep(50);
  }
  return Status::OK();
}

}  // namespace

std::unique_ptr<ShmChannel> ShmChannel::Create(const std::string& name) {
  int fd = ::shm_open(name.c_str(), O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0 && errno == EEXIST) {
    // Stale segment from a crashed prior job: replace it.
    ::shm_unlink(name.c_str());
    fd = ::shm_open(name.c_str(), O_CREAT | O_EXCL | O_RDWR, 0600);
  }
  if (fd < 0) return nullptr;
  if (::ftruncate(fd, kMapBytes) != 0) {
    ::close(fd);
    ::shm_unlink(name.c_str());
    return nullptr;
  }
  void* map = ::mmap(nullptr, kMapBytes, PROT_READ | PROT_WRITE,
                     MAP_SHARED, fd, 0);
  ::close(fd);
  if (map == MAP_FAILED) {
    ::shm_unlink(name.c_str());
    return nullptr;
  }
  auto ch = std::unique_ptr<ShmChannel>(new ShmChannel());
  ch->map_ = map;
  ch->map_bytes_ = kMapBytes;
  ch->name_ = name;
  ch->hdr_ = new (map) Hdr();
  ch->hdr_->head.store(0, std::memory_order_relaxed);
  ch->hdr_->tail.store(0, std::memory_order_relaxed);
  memset(ch->hdr_->addrs, 0, sizeof(ch->hdr_->addrs));
  ch->hdr_->producer_pid = ::getpid();
  ch->hdr_->probe_magic = kProbeMagic;
  ch->hdr_->poisoned.store(0, std::memory_order_relaxed);
  ch->hdr_->producer_probe_addr =
      reinterpret_cast<uint64_t>(&ch->hdr_->probe_magic);
  ch->slots_ = static_cast<uint8_t*>(map) + sizeof(Hdr);
  return ch;
}

std::unique_ptr<ShmChannel> ShmChannel::Open(const std::string& name) {
  int fd = -1;
  // The creator may not have finished Create yet: retry briefly.
  for (int i = 0; i < 200 && fd < 0; ++i) {
    fd = ::shm_open(name.c_str(), O_RDWR, 0600);
    if (fd < 0) ::usleep(10000);
  }
  if (fd < 0) return nullptr;
  struct stat st{};
  if (::fstat(fd, &st) != 0 ||
      static_cast<size_t>(st.st_size) < kMapBytes) {
    // Racing the creator's ftruncate: wait for the full size.
    for (int i = 0; i < 200; ++i) {
      ::usleep(10000);
      if (::fstat(fd, &st) == 0 &&
          static_cast<size_t>(st.st_size) >= kMapBytes) {
        break;
      }
    }
    if (static_cast<size_t>(st.st_size) < kMapBytes) {
      ::close(fd);
      return nullptr;
    }
  }
  void* map = ::mmap(nullptr, kMapBytes, PROT_READ | PROT_WRITE,
                     MAP_SHARED, fd, 0);
  ::close(fd);
  if (map == MAP_FAILED) return nullptr;
  auto ch = std::unique_ptr<ShmChannel>(new ShmChannel());
  ch->map_ = map;
  ch->map_bytes_ = kMapBytes;
  ch->name_ = name;
  ch->hdr_ = static_cast<Hdr*>(map);
  ch->slots_ = static_cast<uint8_t*>(map) + sizeof(Hdr);
  return ch;
}

ShmChannel::~ShmChannel() {
  if (map_ != nullptr) ::munmap(map_, map_bytes_);
}

void ShmChannel::Unlink() {
  if (!name_.empty()) {
    ::shm_unlink(name_.c_str());
    name_.clear();
  }
}

Status ShmChannel::Push(const uint8_t* data, size_t n) {
  if (n > kSlotBytes)
    return Status::Error("shm Push: chunk of " + std::to_string(n) +
                         " bytes exceeds slot size " +
                         std::to_string(kSlotBytes));
  uint64_t head = hdr_->head.load(std::memory_order_relaxed);
  Status st = WaitFor(
      [&] {
        return head - hdr_->tail.load(std::memory_order_acquire) < kSlots;
      },
      "producer waiting for a free slot");
  if (!st.ok()) return st;
  size_t slot = head % kSlots;
  memcpy(slots_ + slot * kSlotBytes, data, n);
  hdr_->lens[slot] = n;
  hdr_->addrs[slot] = 0;
  hdr_->head.store(head + 1, std::memory_order_release);
  return Status::OK();
}

Status ShmChannel::PushRef(const uint8_t* data, size_t n) {
  // No size guard here: a descriptor publishes (addr, n) without copying
  // into the slot, and the consumer chunk-reads arbitrarily large regions.
  uint64_t head = hdr_->head.load(std::memory_order_relaxed);
  Status st = WaitFor(
      [&] {
        return head - hdr_->tail.load(std::memory_order_acquire) < kSlots;
      },
      "producer waiting for a free ref slot");
  if (!st.ok()) {
    // Aborting with descriptors possibly still published: the region may
    // be reused by the caller — the consumer must not trust later reads.
    hdr_->poisoned.store(1, std::memory_order_release);
    return st;
  }
  size_t slot = head % kSlots;
  hdr_->lens[slot] = n;
  hdr_->addrs[slot] = reinterpret_cast<uint64_t>(data);
  hdr_->head.store(head + 1, std::memory_order_release);
  return Status::OK();
}

Status ShmChannel::WaitDrained() {
  uint64_t head = hdr_->head.load(std::memory_order_relaxed);
  Status st = WaitFor(
      [&] {
        return hdr_->tail.load(std::memory_order_acquire) >= head;
      },
      "producer waiting for the consumer to finish reading");
  if (!st.ok()) hdr_->poisoned.store(1, std::memory_order_release);
  return st;
}

Status ShmChannel::PopInto(uint8_t* dst, size_t max_n, size_t* got) {
  uint64_t tail = hdr_->tail.load(std::memory_order_relaxed);
  Status st = WaitFor(
      [&] {
        return hdr_->head.load(std::memory_order_acquire) > tail;
      },
      "consumer waiting for a chunk");
  if (!st.ok()) return st;
  size_t slot = tail % kSlots;
  size_t n = hdr_->lens[slot];
  if (n > max_n)
    return Status::Error("shm chunk larger than receive window");
  if (hdr_->addrs[slot] != 0) {
    // Descriptor: pull straight from the producer's memory.
    size_t off = 0;
    while (off < n) {
      iovec liov{dst + off, std::min<size_t>(n - off, 8 << 20)};
      iovec riov{reinterpret_cast<void*>(hdr_->addrs[slot] + off),
                 liov.iov_len};
      ssize_t k = ::process_vm_readv(hdr_->producer_pid, &liov, 1,
                                     &riov, 1, 0);
      if (k <= 0)
        return Status::Error("process_vm_readv failed mid-transfer");
      off += static_cast<size_t>(k);
    }
  } else {
    memcpy(dst, slots_ + slot * kSlotBytes, n);
  }
  if (hdr_->poisoned.load(std::memory_order_acquire))
    return Status::Error("shm channel poisoned by an aborted producer");
  *got = n;
  hdr_->tail.store(tail + 1, std::memory_order_release);
  return Status::OK();
}

bool ShmChannel::ProbeCma() {
  // The probe target address is the PRODUCER's VA of probe_magic —
  // published by the producer itself (this process maps the segment at a
  // different address).
  uint64_t magic = 0;
  iovec liov{&magic, sizeof(magic)};
  iovec riov{reinterpret_cast<void*>(hdr_->producer_probe_addr),
             sizeof(magic)};
  ssize_t k = ::process_vm_readv(hdr_->producer_pid, &liov, 1, &riov, 1,
                                 0);
  return k == sizeof(magic) && magic == kProbeMagic;
}

}  // namespace hvdtpu
