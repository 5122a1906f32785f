// Wire messages + serialization for the controller protocol.
//
// Capability parity with the reference's Request/Response message layer
// (message.h:50-251, wire/message.fbs) — rebuilt with a hand-rolled
// length-prefixed binary format instead of FlatBuffers (no third-party
// dependency; messages are small and on the control plane only).
#pragma once

#include <cstdint>
#include <string>
#include <vector>

#include "common.h"

namespace hvdtpu {

// One tensor announcement from a rank (reference Request, message.h:56-139).
struct Request {
  RequestType type = RequestType::ALLREDUCE;
  int32_t rank = 0;
  std::string name;
  DataType dtype = DataType::FLOAT32;
  std::vector<int64_t> shape;
  ReduceOp op = ReduceOp::SUM;
  int32_t root_rank = 0;
  double prescale = 1.0;
  double postscale = 1.0;
  std::vector<int64_t> splits;  // alltoall: rows destined per rank
  bool device = false;          // payload is accelerator-resident (HBM)
};

// What every worker sends each cycle.
struct RequestList {
  std::vector<Request> requests;
  std::vector<uint64_t> cache_hits;  // cache-bit vector (response cache)
  bool join = false;                 // this rank called join()
  bool barrier = false;              // this rank waits at a barrier
  bool shutdown = false;             // this rank is shutting down
};

// Coordinator's answer for one (possibly fused) collective
// (reference Response, message.h:159-210).
struct Response {
  RequestType type = RequestType::ALLREDUCE;
  std::vector<std::string> names;        // fused tensor names, in order
  std::string error;                     // non-empty → deliver error
  DataType dtype = DataType::FLOAT32;
  ReduceOp op = ReduceOp::SUM;
  int32_t root_rank = 0;
  double prescale = 1.0;
  double postscale = 1.0;
  // allgather: first dims per rank, flattened [name0_rank0.. name0_rankN,
  // name1_rank0 ...]; alltoall: recv splits matrix row-major [src][dst].
  std::vector<int64_t> sizes;
  // Cache slot per name (aligned with ``names``; UINT32_MAX = uncached).
  std::vector<uint32_t> cache_bits;
  // Execute through the registered device executor on HBM buffers instead
  // of the host TCP data plane (all fused entries are device-resident).
  bool device = false;
  // Algorithm choice stamped by the COORDINATOR (allreduce: hierarchical
  // vs flat ring; allgather: hierarchical vs flat allgatherv): the tuner
  // flips these per sample on rank 0 (reference's categorical autotune
  // parameters, parameter_manager.h:91-93), and per-response stamping is
  // what keeps every rank executing the same schedule mid-flip.
  bool hierarchical = false;
};

struct ResponseList {
  std::vector<Response> responses;
  std::vector<uint32_t> valid_cache_bits;  // intersection across ranks
  // Bits a rank announced that the coordinator no longer holds: the rank
  // must invalidate its entry and resend a full request (self-healing on
  // any cache divergence).
  std::vector<uint32_t> resend_bits;
  bool shutdown = false;                   // all ranks done → stop loop
  bool barrier_release = false;
  int32_t last_joined_rank = -1;           // all ranks joined → returned
  // Coordinator's current response-cache toggle (autotuned categorical,
  // reference parameter_manager.h:93): workers stop announcing bits when
  // the coordinator turned caching off; outstanding bits from the
  // transition window still resolve (or self-heal via resend_bits).
  bool cache_on = true;
  // Coordinator's current eager wire-compression choice (quantized
  // collective engine; 0 none, 1 bf16, 2 int8, 3 int4, 4 fp16).  Stamped per
  // round like cache_on: workers adopt it BEFORE executing the round's
  // responses, so the device-plane executor on every rank builds the
  // same staged-buffer program even when the tuner flips mid-run.
  int32_t wire_compression = 0;
};

// --- serialization ---------------------------------------------------------

class Writer {
 public:
  std::vector<uint8_t> buf;
  void u8(uint8_t v) { buf.push_back(v); }
  void u32(uint32_t v) { append(&v, 4); }
  void i32(int32_t v) { append(&v, 4); }
  void i64(int64_t v) { append(&v, 8); }
  void u64(uint64_t v) { append(&v, 8); }
  void f64(double v) { append(&v, 8); }
  void str(const std::string& s) {
    u32(static_cast<uint32_t>(s.size()));
    append(s.data(), s.size());
  }
  void vec_i64(const std::vector<int64_t>& v) {
    u32(static_cast<uint32_t>(v.size()));
    append(v.data(), v.size() * 8);
  }
  void vec_u64(const std::vector<uint64_t>& v) {
    u32(static_cast<uint32_t>(v.size()));
    append(v.data(), v.size() * 8);
  }
  void vec_u32(const std::vector<uint32_t>& v) {
    u32(static_cast<uint32_t>(v.size()));
    append(v.data(), v.size() * 4);
  }
 private:
  void append(const void* p, size_t n) {
    const uint8_t* b = static_cast<const uint8_t*>(p);
    buf.insert(buf.end(), b, b + n);
  }
};

class Reader {
 public:
  Reader(const uint8_t* p, size_t n) : p_(p), end_(p + n) {}
  uint8_t u8() { return *take(1); }
  uint32_t u32() { uint32_t v; memcpy(&v, take(4), 4); return v; }
  int32_t i32() { int32_t v; memcpy(&v, take(4), 4); return v; }
  int64_t i64() { int64_t v; memcpy(&v, take(8), 8); return v; }
  uint64_t u64() { uint64_t v; memcpy(&v, take(8), 8); return v; }
  double f64() { double v; memcpy(&v, take(8), 8); return v; }
  std::string str() {
    uint32_t n = u32();
    const uint8_t* p = take(n);
    return std::string(reinterpret_cast<const char*>(p), n);
  }
  std::vector<int64_t> vec_i64() {
    uint32_t n = u32();
    std::vector<int64_t> v(n);
    memcpy(v.data(), take(n * 8), n * 8);
    return v;
  }
  std::vector<uint64_t> vec_u64() {
    uint32_t n = u32();
    std::vector<uint64_t> v(n);
    memcpy(v.data(), take(n * 8), n * 8);
    return v;
  }
  std::vector<uint32_t> vec_u32() {
    uint32_t n = u32();
    std::vector<uint32_t> v(n);
    memcpy(v.data(), take(n * 4), n * 4);
    return v;
  }
  bool overflowed() const { return overflow_; }
 private:
  const uint8_t* take(size_t n) {
    if (p_ + n > end_) { overflow_ = true; static uint8_t z[8] = {0}; return z; }
    const uint8_t* r = p_;
    p_ += n;
    return r;
  }
  const uint8_t* p_;
  const uint8_t* end_;
  bool overflow_ = false;
};

void SerializeRequestList(const RequestList& rl, Writer& w);
RequestList DeserializeRequestList(Reader& r);
void SerializeResponseList(const ResponseList& rl, Writer& w);
ResponseList DeserializeResponseList(Reader& r);

}  // namespace hvdtpu
