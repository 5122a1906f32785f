// TensorFlow custom ops bridging TF graphs to the native runtime.
//
// The reference reaches its runtime from TF graphs through registered
// AsyncOpKernels (tensorflow/mpi_ops.cc:383-962).  This is the TPU-native
// equivalent: real graph ops (GIL-free, SavedModel-serializable, usable
// under tf.function(input_signature=...)) that call the same
// hvd_native_* C API the ctypes layer uses.  The native library is
// dlopened from HVD_TPU_NATIVE_LIB (set by the Python loader) so this .so
// carries no link-time coupling; in-process it resolves to the same
// runtime singleton the Python controller initialized.

#include <dlfcn.h>

#include <cstdint>
#include <mutex>
#include <string>

#include "tensorflow/core/framework/common_shape_fns.h"
#include "tensorflow/core/framework/op.h"
#include "tensorflow/core/framework/op_kernel.h"
#include "tensorflow/core/framework/shape_inference.h"

namespace {

using tensorflow::AsyncOpKernel;
using tensorflow::OpKernel;
using tensorflow::OpKernelConstruction;
using tensorflow::OpKernelContext;
using tensorflow::Tensor;
using tensorflow::errors::Internal;

// hvd_native_* entry points resolved at first use.
struct NativeApi {
  int64_t (*allreduce)(const char*, const void*, void*, int,
                       const int64_t*, int, int, double, double) = nullptr;
  int64_t (*broadcast)(const char*, const void*, void*, int,
                       const int64_t*, int, int) = nullptr;
  int64_t (*allgather)(const char*, const void*, int, const int64_t*,
                       int) = nullptr;
  int64_t (*alltoall)(const char*, const void*, int, const int64_t*, int,
                      const int64_t*, int) = nullptr;
  int64_t (*result_bytes)(int64_t) = nullptr;
  int (*result_dims)(int64_t, int64_t*, int) = nullptr;
  int (*result_copy)(int64_t, void*, int64_t) = nullptr;
  int (*wait)(int64_t) = nullptr;
  void (*release)(int64_t) = nullptr;
  const char* (*last_error)() = nullptr;
  int (*initialized)() = nullptr;
  int (*rank)() = nullptr;
  int (*size)() = nullptr;
  bool ok = false;
  std::string error;
};

const NativeApi& Api() {
  static NativeApi api = [] {
    NativeApi a;
    const char* path = getenv("HVD_TPU_NATIVE_LIB");
    if (!path) {
      a.error = "HVD_TPU_NATIVE_LIB not set";
      return a;
    }
    void* h = dlopen(path, RTLD_NOW | RTLD_GLOBAL);
    if (!h) {
      a.error = std::string("dlopen failed: ") + dlerror();
      return a;
    }
    auto resolve = [&](const char* name) -> void* {
      void* sym = dlsym(h, name);
      if (!sym) a.error = std::string("missing symbol ") + name;
      return sym;
    };
    a.allreduce = reinterpret_cast<decltype(a.allreduce)>(
        resolve("hvd_native_allreduce"));
    a.broadcast = reinterpret_cast<decltype(a.broadcast)>(
        resolve("hvd_native_broadcast"));
    a.allgather = reinterpret_cast<decltype(a.allgather)>(
        resolve("hvd_native_allgather"));
    a.alltoall = reinterpret_cast<decltype(a.alltoall)>(
        resolve("hvd_native_alltoall"));
    a.result_bytes = reinterpret_cast<decltype(a.result_bytes)>(
        resolve("hvd_native_result_bytes"));
    a.result_dims = reinterpret_cast<decltype(a.result_dims)>(
        resolve("hvd_native_result_dims"));
    a.result_copy = reinterpret_cast<decltype(a.result_copy)>(
        resolve("hvd_native_result_copy"));
    a.wait = reinterpret_cast<decltype(a.wait)>(resolve("hvd_native_wait"));
    a.release = reinterpret_cast<decltype(a.release)>(
        resolve("hvd_native_release"));
    a.last_error = reinterpret_cast<decltype(a.last_error)>(
        resolve("hvd_native_last_error"));
    a.initialized = reinterpret_cast<decltype(a.initialized)>(
        resolve("hvd_native_initialized"));
    a.rank = reinterpret_cast<decltype(a.rank)>(
        resolve("hvd_native_rank"));
    a.size = reinterpret_cast<decltype(a.size)>(
        resolve("hvd_native_size"));
    a.ok = a.error.empty();
    return a;
  }();
  return api;
}

int DtypeCode(tensorflow::DataType dt) {
  switch (dt) {
    case tensorflow::DT_UINT8: return 0;
    case tensorflow::DT_INT8: return 1;
    case tensorflow::DT_INT32: return 2;
    case tensorflow::DT_INT64: return 3;
    case tensorflow::DT_HALF: return 4;
    case tensorflow::DT_FLOAT: return 5;
    case tensorflow::DT_DOUBLE: return 6;
    case tensorflow::DT_BOOL: return 7;
    case tensorflow::DT_BFLOAT16: return 8;
    default: return -1;
  }
}

std::string LastError() {
  const NativeApi& api = Api();
  if (!api.ok) return api.error;
  const char* e = api.last_error();
  return e ? e : "unknown native error";
}

// Both kernels are AsyncOpKernels: the enqueue happens on the executor
// thread but the wait-for-completion runs on a scheduled closure.  A
// blocking Compute() would pin executor threads on collectives whose
// completion needs OTHER collectives to be enqueued by those same threads
// — the distributed-deadlock hazard the reference's async design exists
// to prevent (tensorflow/mpi_ops.cc:383-431).
class HvdTpuAllreduceOp : public AsyncOpKernel {
 public:
  explicit HvdTpuAllreduceOp(OpKernelConstruction* ctx)
      : AsyncOpKernel(ctx) {
    OP_REQUIRES_OK(ctx, ctx->GetAttr("op_code", &op_code_));
    OP_REQUIRES_OK(ctx, ctx->GetAttr("prescale", &prescale_));
    OP_REQUIRES_OK(ctx, ctx->GetAttr("postscale", &postscale_));
    OP_REQUIRES_OK(ctx, ctx->GetAttr("tensor_name", &tensor_name_));
    if (tensor_name_.empty()) tensor_name_ = name();
  }

  void ComputeAsync(OpKernelContext* ctx, DoneCallback done) override {
    const NativeApi& api = Api();
    OP_REQUIRES_ASYNC(ctx, api.ok,
                      Internal("hvd native runtime: ", LastError()), done);
    OP_REQUIRES_ASYNC(ctx, api.initialized(),
                      Internal("hvd native runtime not initialized; call "
                               "hvd.init() under the launcher first"),
                      done);
    const Tensor& input = ctx->input(0);
    Tensor* output = nullptr;
    OP_REQUIRES_OK_ASYNC(
        ctx, ctx->allocate_output(0, input.shape(), &output), done);
    int code = DtypeCode(input.dtype());
    OP_REQUIRES_ASYNC(ctx, code >= 0,
                      Internal("unsupported dtype for hvd allreduce"),
                      done);
    int ndim = input.dims();
    std::vector<int64_t> dims(std::max(ndim, 1), 1);
    for (int i = 0; i < ndim; ++i) dims[i] = input.dim_size(i);
    int64_t h = api.allreduce(
        tensor_name_.c_str(), input.tensor_data().data(),
        const_cast<char*>(output->tensor_data().data()), ndim, dims.data(),
        code, op_code_, prescale_, postscale_);
    OP_REQUIRES_ASYNC(ctx, h >= 0,
                      Internal("allreduce enqueue: ", LastError()), done);
    tensorflow::Env::Default()->SchedClosure(
        [ctx, done = std::move(done), h, &api]() {
          int rc = api.wait(h);
          api.release(h);
          if (rc != 0) {
            ctx->SetStatus(Internal("allreduce: ", LastError()));
          }
          done();
        });
  }

 private:
  int op_code_;
  float prescale_;
  float postscale_;
  std::string tensor_name_;
};

class HvdTpuBroadcastOp : public AsyncOpKernel {
 public:
  explicit HvdTpuBroadcastOp(OpKernelConstruction* ctx)
      : AsyncOpKernel(ctx) {
    OP_REQUIRES_OK(ctx, ctx->GetAttr("root_rank", &root_rank_));
    OP_REQUIRES_OK(ctx, ctx->GetAttr("tensor_name", &tensor_name_));
    if (tensor_name_.empty()) tensor_name_ = name();
  }

  void ComputeAsync(OpKernelContext* ctx, DoneCallback done) override {
    const NativeApi& api = Api();
    OP_REQUIRES_ASYNC(ctx, api.ok,
                      Internal("hvd native runtime: ", LastError()), done);
    OP_REQUIRES_ASYNC(ctx, api.initialized(),
                      Internal("hvd native runtime not initialized"), done);
    const Tensor& input = ctx->input(0);
    Tensor* output = nullptr;
    OP_REQUIRES_OK_ASYNC(
        ctx, ctx->allocate_output(0, input.shape(), &output), done);
    int code = DtypeCode(input.dtype());
    OP_REQUIRES_ASYNC(ctx, code >= 0,
                      Internal("unsupported dtype for hvd broadcast"),
                      done);
    int ndim = input.dims();
    std::vector<int64_t> dims(std::max(ndim, 1), 1);
    for (int i = 0; i < ndim; ++i) dims[i] = input.dim_size(i);
    int64_t h = api.broadcast(
        tensor_name_.c_str(), input.tensor_data().data(),
        const_cast<char*>(output->tensor_data().data()), ndim, dims.data(),
        code, root_rank_);
    OP_REQUIRES_ASYNC(ctx, h >= 0,
                      Internal("broadcast enqueue: ", LastError()), done);
    tensorflow::Env::Default()->SchedClosure(
        [ctx, done = std::move(done), h, &api]() {
          int rc = api.wait(h);
          api.release(h);
          if (rc != 0) {
            ctx->SetStatus(Internal("broadcast: ", LastError()));
          }
          done();
        });
  }

 private:
  int root_rank_;
  std::string tensor_name_;
};

class HvdTpuAllgatherOp : public AsyncOpKernel {
 public:
  explicit HvdTpuAllgatherOp(OpKernelConstruction* ctx)
      : AsyncOpKernel(ctx) {
    OP_REQUIRES_OK(ctx, ctx->GetAttr("tensor_name", &tensor_name_));
    if (tensor_name_.empty()) tensor_name_ = name();
  }

  void ComputeAsync(OpKernelContext* ctx, DoneCallback done) override {
    const NativeApi& api = Api();
    OP_REQUIRES_ASYNC(ctx, api.ok,
                      Internal("hvd native runtime: ", LastError()), done);
    OP_REQUIRES_ASYNC(ctx, api.initialized(),
                      Internal("hvd native runtime not initialized"), done);
    const Tensor& input = ctx->input(0);
    int code = DtypeCode(input.dtype());
    OP_REQUIRES_ASYNC(ctx, code >= 0,
                      Internal("unsupported dtype for hvd allgather"),
                      done);
    int ndim = input.dims();
    std::vector<int64_t> dims(std::max(ndim, 1), 1);
    for (int i = 0; i < ndim; ++i) dims[i] = input.dim_size(i);
    int64_t h = api.allgather(tensor_name_.c_str(),
                              input.tensor_data().data(), ndim, dims.data(),
                              code);
    OP_REQUIRES_ASYNC(ctx, h >= 0,
                      Internal("allgather enqueue: ", LastError()), done);
    // The variable-size output is allocated after completion, from the
    // negotiated per-rank first dims.
    tensorflow::TensorShape trailing = input.shape();
    if (trailing.dims() > 0) trailing.RemoveDim(0);
    tensorflow::Env::Default()->SchedClosure(
        [ctx, done = std::move(done), h, &api, trailing]() {
          if (api.wait(h) != 0) {
            api.release(h);
            ctx->SetStatus(Internal("allgather: ", LastError()));
            done();
            return;
          }
          std::vector<int64_t> first(api.size(), 0);
          api.result_dims(h, first.data(), api.size());
          int64_t rows = 0;
          for (int64_t f : first) rows += f;
          tensorflow::TensorShape out_shape;
          out_shape.AddDim(rows);
          out_shape.AppendShape(trailing);
          Tensor* output = nullptr;
          auto st = ctx->allocate_output(0, out_shape, &output);
          if (!st.ok()) {
            api.release(h);
            ctx->SetStatus(st);
            done();
            return;
          }
          int rc = api.result_copy(
              h, const_cast<char*>(output->tensor_data().data()),
              static_cast<int64_t>(output->tensor_data().size()));
          api.release(h);
          if (rc != 0) ctx->SetStatus(Internal("allgather result copy"));
          done();
        });
  }

 private:
  std::string tensor_name_;
};

class HvdTpuAlltoallOp : public AsyncOpKernel {
 public:
  explicit HvdTpuAlltoallOp(OpKernelConstruction* ctx)
      : AsyncOpKernel(ctx) {
    OP_REQUIRES_OK(ctx, ctx->GetAttr("tensor_name", &tensor_name_));
    if (tensor_name_.empty()) tensor_name_ = name();
  }

  void ComputeAsync(OpKernelContext* ctx, DoneCallback done) override {
    const NativeApi& api = Api();
    OP_REQUIRES_ASYNC(ctx, api.ok,
                      Internal("hvd native runtime: ", LastError()), done);
    OP_REQUIRES_ASYNC(ctx, api.initialized(),
                      Internal("hvd native runtime not initialized"), done);
    const Tensor& input = ctx->input(0);
    const Tensor& splits_in = ctx->input(1);
    int code = DtypeCode(input.dtype());
    OP_REQUIRES_ASYNC(ctx, code >= 0,
                      Internal("unsupported dtype for hvd alltoall"), done);
    int world = api.size();
    std::vector<int64_t> splits;
    if (splits_in.NumElements() == 0) {
      OP_REQUIRES_ASYNC(
          ctx, input.dim_size(0) % world == 0,
          Internal("alltoall dim0 not divisible by world size"), done);
      splits.assign(world, input.dim_size(0) / world);
    } else {
      auto flat = splits_in.flat<int64_t>();
      for (int i = 0; i < flat.size(); ++i) splits.push_back(flat(i));
    }
    int ndim = input.dims();
    std::vector<int64_t> dims(std::max(ndim, 1), 1);
    for (int i = 0; i < ndim; ++i) dims[i] = input.dim_size(i);
    int64_t h = api.alltoall(tensor_name_.c_str(),
                             input.tensor_data().data(), ndim, dims.data(),
                             code, splits.data(),
                             static_cast<int>(splits.size()));
    OP_REQUIRES_ASYNC(ctx, h >= 0,
                      Internal("alltoall enqueue: ", LastError()), done);
    tensorflow::TensorShape trailing = input.shape();
    if (trailing.dims() > 0) trailing.RemoveDim(0);
    tensorflow::Env::Default()->SchedClosure(
        [ctx, done = std::move(done), h, &api, trailing, world]() {
          if (api.wait(h) != 0) {
            api.release(h);
            ctx->SetStatus(Internal("alltoall: ", LastError()));
            done();
            return;
          }
          std::vector<int64_t> recv(world, 0);
          api.result_dims(h, recv.data(), world);
          int64_t rows = 0;
          for (int64_t r : recv) rows += r;
          tensorflow::TensorShape out_shape;
          out_shape.AddDim(rows);
          out_shape.AppendShape(trailing);
          Tensor* output = nullptr;
          Tensor* recv_splits = nullptr;
          auto st = ctx->allocate_output(0, out_shape, &output);
          if (st.ok())
            st = ctx->allocate_output(
                1, tensorflow::TensorShape({world}), &recv_splits);
          if (!st.ok()) {
            api.release(h);
            ctx->SetStatus(st);
            done();
            return;
          }
          int rc = api.result_copy(
              h, const_cast<char*>(output->tensor_data().data()),
              static_cast<int64_t>(output->tensor_data().size()));
          api.release(h);
          for (int i = 0; i < world; ++i)
            recv_splits->flat<int64_t>()(i) = recv[i];
          if (rc != 0) ctx->SetStatus(Internal("alltoall result copy"));
          done();
        });
  }

 private:
  std::string tensor_name_;
};

// Scalar topology query ops (reference HorovodSize/Rank/LocalRank/
// LocalSize, tensorflow/mpi_ops.cc:787-867): graph-time constants would
// bake a world size into elastic graphs; these read the live runtime
// (local topology from the launcher env contract).
class HvdTpuQueryOp : public OpKernel {
 public:
  enum class Kind { kRank, kSize, kLocalRank, kLocalSize };

  HvdTpuQueryOp(OpKernelConstruction* ctx, Kind kind)
      : OpKernel(ctx), kind_(kind) {}

  void Compute(OpKernelContext* ctx) override {
    Tensor* output = nullptr;
    OP_REQUIRES_OK(ctx, ctx->allocate_output(
                            0, tensorflow::TensorShape({}), &output));
    int value = -1;
    const NativeApi& api = Api();
    switch (kind_) {
      case Kind::kRank:
        value = (api.ok && api.initialized()) ? api.rank()
                                              : EnvInt("RANK", 0);
        break;
      case Kind::kSize:
        value = (api.ok && api.initialized()) ? api.size()
                                              : EnvInt("SIZE", 1);
        break;
      case Kind::kLocalRank:
        value = EnvInt("LOCAL_RANK", 0);
        break;
      case Kind::kLocalSize:
        value = EnvInt("LOCAL_SIZE", 1);
        break;
    }
    output->scalar<int32_t>()() = value;
  }

 private:
  static int EnvInt(const char* suffix, int fallback) {
    for (const char* prefix : {"HVD_TPU_", "HOROVOD_"}) {
      std::string name = std::string(prefix) + suffix;
      const char* v = getenv(name.c_str());
      if (v) return atoi(v);
    }
    return fallback;
  }

  Kind kind_;
};

#define HVD_QUERY_KERNEL(OPNAME, KIND)                                   \
  class OPNAME##Kernel : public HvdTpuQueryOp {                          \
   public:                                                               \
    explicit OPNAME##Kernel(OpKernelConstruction* ctx)                   \
        : HvdTpuQueryOp(ctx, HvdTpuQueryOp::Kind::KIND) {}               \
  };

HVD_QUERY_KERNEL(HvdTpuRank, kRank)
HVD_QUERY_KERNEL(HvdTpuSize, kSize)
HVD_QUERY_KERNEL(HvdTpuLocalRank, kLocalRank)
HVD_QUERY_KERNEL(HvdTpuLocalSize, kLocalSize)

#undef HVD_QUERY_KERNEL

}  // namespace

REGISTER_OP("HvdTpuTorchRank").Output("rank: int32")  // port: op names of its own
    .SetShapeFn(tensorflow::shape_inference::ScalarShape)
    .SetIsStateful();
REGISTER_OP("HvdTpuTorchSize").Output("size: int32")  // port: op names of its own
    .SetShapeFn(tensorflow::shape_inference::ScalarShape)
    .SetIsStateful();
REGISTER_OP("HvdTpuTorchLocalRank").Output("local_rank: int32")  // port: op names of its own
    .SetShapeFn(tensorflow::shape_inference::ScalarShape)
    .SetIsStateful();
REGISTER_OP("HvdTpuTorchLocalSize").Output("local_size: int32")  // port: op names of its own
    .SetShapeFn(tensorflow::shape_inference::ScalarShape)
    .SetIsStateful();

REGISTER_KERNEL_BUILDER(Name("HvdTpuTorchRank").Device(tensorflow::DEVICE_CPU),  // port: op names of its own
                        HvdTpuRankKernel);
REGISTER_KERNEL_BUILDER(Name("HvdTpuTorchSize").Device(tensorflow::DEVICE_CPU),  // port: op names of its own
                        HvdTpuSizeKernel);
REGISTER_KERNEL_BUILDER(
    Name("HvdTpuTorchLocalRank").Device(tensorflow::DEVICE_CPU),  // port: op names of its own
    HvdTpuLocalRankKernel);
REGISTER_KERNEL_BUILDER(
    Name("HvdTpuTorchLocalSize").Device(tensorflow::DEVICE_CPU),  // port: op names of its own
    HvdTpuLocalSizeKernel);

REGISTER_OP("HvdTpuTorchAllreduce")  // port: op names of its own
    .Input("tensor: T")
    .Output("output: T")
    .Attr("T: {uint8, int8, int32, int64, half, float, double, bfloat16}")
    .Attr("op_code: int = 1")
    .Attr("prescale: float = 1.0")
    .Attr("postscale: float = 1.0")
    .Attr("tensor_name: string = ''")
    .SetShapeFn(tensorflow::shape_inference::UnchangedShape);

REGISTER_OP("HvdTpuTorchBroadcast")  // port: op names of its own
    .Input("tensor: T")
    .Output("output: T")
    .Attr("T: {uint8, int8, int32, int64, half, float, double, bfloat16}")
    .Attr("root_rank: int = 0")
    .Attr("tensor_name: string = ''")
    .SetShapeFn(tensorflow::shape_inference::UnchangedShape);

REGISTER_OP("HvdTpuTorchAllgather")  // port: op names of its own
    .Input("tensor: T")
    .Output("output: T")
    .Attr("T: {uint8, int8, int32, int64, half, float, double, bfloat16}")
    .Attr("tensor_name: string = ''")
    .SetShapeFn([](tensorflow::shape_inference::InferenceContext* c) {
      tensorflow::shape_inference::ShapeHandle trailing;
      TF_RETURN_IF_ERROR(c->Subshape(c->input(0), 1, &trailing));
      tensorflow::shape_inference::ShapeHandle first =
          c->Vector(tensorflow::shape_inference::InferenceContext::
                        kUnknownDim);
      tensorflow::shape_inference::ShapeHandle out;
      TF_RETURN_IF_ERROR(c->Concatenate(first, trailing, &out));
      c->set_output(0, out);
      return absl::OkStatus();
    });

REGISTER_OP("HvdTpuTorchAlltoall")  // port: op names of its own
    .Input("tensor: T")
    .Input("splits: int64")
    .Output("output: T")
    .Output("received_splits: int64")
    .Attr("T: {uint8, int8, int32, int64, half, float, double, bfloat16}")
    .Attr("tensor_name: string = ''")
    .SetShapeFn([](tensorflow::shape_inference::InferenceContext* c) {
      tensorflow::shape_inference::ShapeHandle trailing;
      TF_RETURN_IF_ERROR(c->Subshape(c->input(0), 1, &trailing));
      tensorflow::shape_inference::ShapeHandle first =
          c->Vector(tensorflow::shape_inference::InferenceContext::
                        kUnknownDim);
      tensorflow::shape_inference::ShapeHandle out;
      TF_RETURN_IF_ERROR(c->Concatenate(first, trailing, &out));
      c->set_output(0, out);
      c->set_output(1, c->Vector(
          tensorflow::shape_inference::InferenceContext::kUnknownDim));
      return absl::OkStatus();
    });

REGISTER_KERNEL_BUILDER(Name("HvdTpuTorchAllreduce")  // port: op names of its own
                            .Device(tensorflow::DEVICE_CPU),
                        HvdTpuAllreduceOp);
REGISTER_KERNEL_BUILDER(Name("HvdTpuTorchBroadcast")  // port: op names of its own
                            .Device(tensorflow::DEVICE_CPU),
                        HvdTpuBroadcastOp);
REGISTER_KERNEL_BUILDER(Name("HvdTpuTorchAllgather")  // port: op names of its own
                            .Device(tensorflow::DEVICE_CPU),
                        HvdTpuAllgatherOp);
REGISTER_KERNEL_BUILDER(Name("HvdTpuTorchAlltoall")  // port: op names of its own
                            .Device(tensorflow::DEVICE_CPU),
                        HvdTpuAlltoallOp);
