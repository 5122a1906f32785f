#include "wire.h"

namespace hvdtpu {

static void SerializeRequest(const Request& q, Writer& w) {
  w.u8(static_cast<uint8_t>(q.type));
  w.i32(q.rank);
  w.str(q.name);
  w.u8(static_cast<uint8_t>(q.dtype));
  w.vec_i64(q.shape);
  w.u8(static_cast<uint8_t>(q.op));
  w.i32(q.root_rank);
  w.f64(q.prescale);
  w.f64(q.postscale);
  w.vec_i64(q.splits);
  w.u8(q.device ? 1 : 0);
}

static Request DeserializeRequest(Reader& r) {
  Request q;
  q.type = static_cast<RequestType>(r.u8());
  q.rank = r.i32();
  q.name = r.str();
  q.dtype = static_cast<DataType>(r.u8());
  q.shape = r.vec_i64();
  q.op = static_cast<ReduceOp>(r.u8());
  q.root_rank = r.i32();
  q.prescale = r.f64();
  q.postscale = r.f64();
  q.splits = r.vec_i64();
  q.device = r.u8() != 0;
  return q;
}

void SerializeRequestList(const RequestList& rl, Writer& w) {
  w.u32(static_cast<uint32_t>(rl.requests.size()));
  for (const auto& q : rl.requests) SerializeRequest(q, w);
  w.vec_u64(rl.cache_hits);
  w.u8(rl.join ? 1 : 0);
  w.u8(rl.barrier ? 1 : 0);
  w.u8(rl.shutdown ? 1 : 0);
}

RequestList DeserializeRequestList(Reader& r) {
  RequestList rl;
  uint32_t n = r.u32();
  rl.requests.reserve(n);
  for (uint32_t i = 0; i < n; ++i) rl.requests.push_back(DeserializeRequest(r));
  rl.cache_hits = r.vec_u64();
  rl.join = r.u8() != 0;
  rl.barrier = r.u8() != 0;
  rl.shutdown = r.u8() != 0;
  return rl;
}

static void SerializeResponse(const Response& s, Writer& w) {
  w.u8(static_cast<uint8_t>(s.type));
  w.u32(static_cast<uint32_t>(s.names.size()));
  for (const auto& n : s.names) w.str(n);
  w.str(s.error);
  w.u8(static_cast<uint8_t>(s.dtype));
  w.u8(static_cast<uint8_t>(s.op));
  w.i32(s.root_rank);
  w.f64(s.prescale);
  w.f64(s.postscale);
  w.vec_i64(s.sizes);
  w.vec_u32(s.cache_bits);
  w.u8(s.device ? 1 : 0);
  w.u8(s.hierarchical ? 1 : 0);
}

static Response DeserializeResponse(Reader& r) {
  Response s;
  s.type = static_cast<RequestType>(r.u8());
  uint32_t n = r.u32();
  s.names.reserve(n);
  for (uint32_t i = 0; i < n; ++i) s.names.push_back(r.str());
  s.error = r.str();
  s.dtype = static_cast<DataType>(r.u8());
  s.op = static_cast<ReduceOp>(r.u8());
  s.root_rank = r.i32();
  s.prescale = r.f64();
  s.postscale = r.f64();
  s.sizes = r.vec_i64();
  s.cache_bits = r.vec_u32();
  s.device = r.u8() != 0;
  s.hierarchical = r.u8() != 0;
  return s;
}

void SerializeResponseList(const ResponseList& rl, Writer& w) {
  w.u32(static_cast<uint32_t>(rl.responses.size()));
  for (const auto& s : rl.responses) SerializeResponse(s, w);
  w.vec_u32(rl.valid_cache_bits);
  w.vec_u32(rl.resend_bits);
  w.u8(rl.shutdown ? 1 : 0);
  w.u8(rl.barrier_release ? 1 : 0);
  w.i32(rl.last_joined_rank);
  w.u8(rl.cache_on ? 1 : 0);
  w.i32(rl.wire_compression);
}

ResponseList DeserializeResponseList(Reader& r) {
  ResponseList rl;
  uint32_t n = r.u32();
  rl.responses.reserve(n);
  for (uint32_t i = 0; i < n; ++i)
    rl.responses.push_back(DeserializeResponse(r));
  rl.valid_cache_bits = r.vec_u32();
  rl.resend_bits = r.vec_u32();
  rl.shutdown = r.u8() != 0;
  rl.barrier_release = r.u8() != 0;
  rl.last_joined_rank = r.i32();
  rl.cache_on = r.u8() != 0;
  rl.wire_compression = r.i32();
  return rl;
}

}  // namespace hvdtpu
