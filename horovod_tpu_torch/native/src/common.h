// Core types for the native eager-path runtime.
//
// TPU-native equivalent of the reference's horovod/common/common.h:113-281
// (Status, DataType, TensorTableEntry) — rebuilt, not ported: no framework
// Tensor/OpContext abstraction is needed because the eager path always
// operates on host buffers handed over from Python (numpy / dlpack), and
// device-resident collectives go through the compiled XLA path instead.
#pragma once

#include <atomic>
#include <cstdint>
#include <cstring>
#include <functional>
#include <memory>
#include <string>
#include <vector>

namespace hvdtpu {

enum class StatusType : uint8_t { OK = 0, UNKNOWN_ERROR, PRECONDITION_ERROR,
                                 ABORTED, INVALID_ARGUMENT, IN_PROGRESS,
                                 RETRYABLE };

struct Status {
  StatusType type = StatusType::OK;
  std::string reason;
  static Status OK() { return Status(); }
  static Status Error(const std::string& msg) {
    return Status{StatusType::UNKNOWN_ERROR, msg};
  }
  static Status PreconditionError(const std::string& msg) {
    return Status{StatusType::PRECONDITION_ERROR, msg};
  }
  static Status InvalidArgument(const std::string& msg) {
    return Status{StatusType::INVALID_ARGUMENT, msg};
  }
  static Status Aborted(const std::string& msg) {
    return Status{StatusType::ABORTED, msg};
  }
  // A transport failure the ring-level recovery may retry (reconnect
  // exhausted on one link, or a peer's abort of the attempt): never
  // returned to callers — collectives.cc either renegotiates the ring
  // or converts it to a terminal error.
  static Status Retry(const std::string& msg) {
    return Status{StatusType::RETRYABLE, msg};
  }
  bool ok() const { return type == StatusType::OK; }
  bool retryable() const { return type == StatusType::RETRYABLE; }
};

// Matches the Python/dtype codes in native/controller.py. Subset of the
// reference's 10-dtype enum (message.h:30-41) + bfloat16 (TPU-native).
enum class DataType : uint8_t {
  UINT8 = 0, INT8 = 1, INT32 = 2, INT64 = 3,
  FLOAT16 = 4, FLOAT32 = 5, FLOAT64 = 6, BOOL = 7, BFLOAT16 = 8,
};

inline size_t DataTypeSize(DataType t) {
  switch (t) {
    case DataType::UINT8: case DataType::INT8: case DataType::BOOL: return 1;
    case DataType::FLOAT16: case DataType::BFLOAT16: return 2;
    case DataType::INT32: case DataType::FLOAT32: return 4;
    case DataType::INT64: case DataType::FLOAT64: return 8;
  }
  return 1;
}

enum class ReduceOp : uint8_t { AVERAGE = 0, SUM = 1, ADASUM = 2, MIN = 3,
                                MAX = 4, PRODUCT = 5 };

enum class RequestType : uint8_t { ALLREDUCE = 0, ALLGATHER = 1,
                                   BROADCAST = 2, ALLTOALL = 3, JOIN = 4,
                                   BARRIER = 5 };

// A pending collective owned by this rank (reference TensorTableEntry,
// common.h:223-281). Input/output are host buffers kept alive by Python
// until the callback fires.
struct TensorEntry {
  std::string name;
  RequestType type = RequestType::ALLREDUCE;
  DataType dtype = DataType::FLOAT32;
  std::vector<int64_t> shape;
  ReduceOp op = ReduceOp::SUM;
  int32_t root_rank = 0;
  double prescale = 1.0;
  double postscale = 1.0;
  const void* input = nullptr;
  void* output = nullptr;          // for allreduce/broadcast: same size as in
  // Device-resident entry: payload lives in accelerator HBM and is executed
  // by the registered device executor (the TPU analog of the reference's
  // device-buffer fusion inside the negotiated runtime,
  // nccl_operations.cc:126-184); input/output stay null.
  bool device = false;
  std::vector<int64_t> splits;     // alltoall send splits (first-dim rows)
  // Variable-size outputs (allgather/alltoall): runtime allocates and Python
  // copies out; holds the buffer until handle collected.
  std::shared_ptr<std::vector<uint8_t>> var_output;
  std::vector<int64_t> out_first_dims;  // per-rank first dims (allgather) or
                                        // received splits (alltoall)
  std::function<void(const Status&)> callback;
  int64_t num_elements() const {
    int64_t n = 1;
    for (auto d : shape) n *= d;
    return n;
  }
  size_t byte_size() const { return num_elements() * DataTypeSize(dtype); }
};

}  // namespace hvdtpu
