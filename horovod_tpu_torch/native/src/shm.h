// Same-host bulk transport: one-directional POSIX-shm channels.
//
// TPU-native equivalent of the reference's shared-memory staging for
// same-node ranks (MPIHierarchicalAllgather's POSIX shm window,
// mpi_operations.cc MEMCPY_IN_SHARED_BUFFER): local peers move collective
// payloads through a double-buffered shared segment (two memcpys, no
// kernel socket copies, no syscalls on the bulk path) while remote peers
// stay on TCP.  Synchronization is head/tail atomics in the segment —
// no tokens on the sockets, so the control plane is untouched.
#pragma once

#include <atomic>
#include <cstdint>
#include <memory>
#include <string>

#include "common.h"

namespace hvdtpu {

class ShmChannel {
 public:
  static constexpr size_t kSlots = 2;
  static constexpr size_t kSlotBytes = 4 << 20;

  struct Hdr {
    std::atomic<uint64_t> head;  // chunks published by the producer
    char pad0[64 - sizeof(std::atomic<uint64_t>)];
    std::atomic<uint64_t> tail;  // chunks consumed by the consumer
    char pad1[64 - sizeof(std::atomic<uint64_t>)];
    uint64_t lens[kSlots];
    // Cross-memory-attach descriptors: addrs[slot] != 0 marks the chunk
    // as a reference into the producer's address space (the consumer
    // pulls it with process_vm_readv — zero staging copies) instead of
    // data in the slot.
    uint64_t addrs[kSlots];
    int32_t producer_pid;
    uint64_t probe_magic;          // consumer CMA capability probe value
    uint64_t producer_probe_addr;  // producer's own VA of probe_magic
    // Set by a producer that aborted a transfer without draining: any
    // still-published descriptor may point at reused memory, so the
    // consumer must treat reads after this as failed, never as data.
    std::atomic<uint32_t> poisoned;
  };

  // Producer side (the sending rank) creates; consumer opens.  Both
  // return nullptr on failure (no /dev/shm, permission, size) — callers
  // fall back to TCP.
  static std::unique_ptr<ShmChannel> Create(const std::string& name);
  static std::unique_ptr<ShmChannel> Open(const std::string& name);
  ~ShmChannel();

  // Remove the name (mapping stays valid); call once both ends mapped so
  // a crash cannot leak the segment.
  void Unlink();

  // Producer: wait (bounded) for a free slot, copy n <= kSlotBytes in,
  // publish.
  Status Push(const uint8_t* data, size_t n);

  // Producer, CMA mode: publish a descriptor for an arbitrarily large
  // region of this process's memory; the consumer pulls it directly.
  // The caller MUST call WaitDrained() before reusing/modifying the
  // region (the consumer reads it asynchronously).
  Status PushRef(const uint8_t* data, size_t n);
  Status WaitDrained();

  // Consumer: wait (bounded) for a published chunk and land up to
  // max_n bytes at dst (slot memcpy or direct process_vm_readv for
  // descriptors); *got reports the chunk size.
  Status PopInto(uint8_t* dst, size_t max_n, size_t* got);

  // Consumer-side CMA capability: can this process read the producer's
  // memory? (probed once against probe_magic).
  bool ProbeCma();
  // Producer side: enable descriptor publishing (set after the peer
  // reported a successful probe).
  void EnableRefs() { use_refs_ = true; }
  bool refs_enabled() const { return use_refs_; }
  // Mark the channel unusable: consumers' in-flight/later reads fail
  // instead of trusting descriptors into memory the producer may have
  // freed (producer-side error teardown).
  void Poison() { hdr_->poisoned.store(1, std::memory_order_release); }

 private:
  ShmChannel() = default;
  Hdr* hdr_ = nullptr;
  uint8_t* slots_ = nullptr;
  void* map_ = nullptr;
  size_t map_bytes_ = 0;
  std::string name_;
  bool use_refs_ = false;
};

}  // namespace hvdtpu
