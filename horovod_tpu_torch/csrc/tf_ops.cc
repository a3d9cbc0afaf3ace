// TensorFlow custom ops backed by the native engine: the port's copy of
// the JAX package's csrc/tf_ops.cc, kernel for kernel.
//
// Role parity: horovod/tensorflow/mpi_ops.cc — REGISTER_OP kernels whose
// bodies hand tensors to the shared coordinator.  The TF front-end
// (horovod_tpu_torch/tensorflow, loaded by its _native_ops.py) loads
// this library when TF + a toolchain are present and routes allreduce /
// broadcast / allgather through real graph ops (visible in GraphDefs,
// no py_function trampoline); the py_function path remains the fallback
// (custom ops sit outside jit_compile clusters).
//
// The kernels are synchronous CPU kernels: enqueue into the engine, wait,
// surface errors through ctx->SetStatus.  (The reference's AsyncOpKernel
// exists to overlap GPU streams; the CPU data plane here completes on the
// background thread either way.)

#include <cstring>
#include <string>
#include <vector>

#include "tensorflow/core/framework/op.h"
#include "tensorflow/core/framework/op_kernel.h"
#include "tensorflow/core/framework/shape_inference.h"

#include "engine.h"

extern "C" void* hvd_engine_handle();

namespace {

using tensorflow::DEVICE_CPU;
using tensorflow::OpKernel;
using tensorflow::OpKernelConstruction;
using tensorflow::OpKernelContext;
using tensorflow::Tensor;

bool MapDtype(tensorflow::DataType dt, hvd::DataType* out) {
  switch (dt) {
    case tensorflow::DT_FLOAT:
      *out = hvd::DataType::FLOAT32;
      return true;
    case tensorflow::DT_DOUBLE:
      *out = hvd::DataType::FLOAT64;
      return true;
    case tensorflow::DT_HALF:
      *out = hvd::DataType::FLOAT16;
      return true;
    case tensorflow::DT_BFLOAT16:
      *out = hvd::DataType::BFLOAT16;
      return true;
    case tensorflow::DT_INT32:
      *out = hvd::DataType::INT32;
      return true;
    case tensorflow::DT_INT64:
      *out = hvd::DataType::INT64;
      return true;
    case tensorflow::DT_UINT8:
      *out = hvd::DataType::UINT8;
      return true;
    case tensorflow::DT_INT8:
      *out = hvd::DataType::INT8;
      return true;
    case tensorflow::DT_BOOL:
      *out = hvd::DataType::BOOL;
      return true;
    default:
      return false;
  }
}

hvd::Engine* EngineOrError(OpKernelContext* ctx) {
  auto* eng = static_cast<hvd::Engine*>(hvd_engine_handle());
  if (eng == nullptr) {
    ctx->SetStatus(tensorflow::errors::FailedPrecondition(
        "horovod_tpu_torch native engine is not initialized (hvd.init() "
        "first; the py engine serves only the py_function path)"));
  }
  return eng;
}

hvd::TensorShape ShapeOf(const Tensor& t) {
  hvd::TensorShape s;
  for (int i = 0; i < t.dims(); ++i) s.dims.push_back(t.dim_size(i));
  // 0-d scalars ride the wire as shape (1,), matching the ctypes
  // binding's lift so mixed call sites negotiate identical shapes.
  if (s.dims.empty()) s.dims.push_back(1);
  return s;
}

bool WaitHandle(OpKernelContext* ctx, hvd::Engine* eng, int64_t h) {
  hvd::StatusType st = eng->handles().Wait(h);
  std::string reason;
  if (st != hvd::StatusType::OK) {
    auto* state = eng->handles().Get(h);
    reason = state != nullptr && !state->status.reason.empty()
                 ? state->status.reason
                 : "collective failed";
  }
  eng->handles().Release(h);
  if (!reason.empty()) {
    ctx->SetStatus(tensorflow::errors::Internal(reason));
    return false;
  }
  return true;
}

class HvdAllreduceOp : public OpKernel {
 public:
  explicit HvdAllreduceOp(OpKernelConstruction* c) : OpKernel(c) {
    OP_REQUIRES_OK(c, c->GetAttr("tensor_name", &name_));
    OP_REQUIRES_OK(c, c->GetAttr("reduce_op", &op_));
    OP_REQUIRES_OK(c, c->GetAttr("prescale_factor", &prescale_));
    OP_REQUIRES_OK(c, c->GetAttr("postscale_factor", &postscale_));
    OP_REQUIRES_OK(c, c->GetAttr("process_set_id", &ps_id_));
    OP_REQUIRES_OK(c, c->GetAttr("process_set_size", &ps_size_));
  }

  void Compute(OpKernelContext* ctx) override {
    auto* eng = EngineOrError(ctx);
    if (eng == nullptr) return;
    const Tensor& in = ctx->input(0);
    Tensor* out = nullptr;
    OP_REQUIRES_OK(ctx, ctx->allocate_output(0, in.shape(), &out));
    hvd::DataType dt;
    OP_REQUIRES(ctx, MapDtype(in.dtype(), &dt),
                tensorflow::errors::InvalidArgument(
                    "unsupported dtype for engine allreduce"));
    // The ring reduces in place: stage input into the output buffer.
    std::memcpy(const_cast<char*>(out->tensor_data().data()),
                in.tensor_data().data(), in.tensor_data().size());
    std::string err;
    int64_t h = eng->EnqueueAllreduce(
        name_, const_cast<char*>(out->tensor_data().data()), ShapeOf(in),
        dt, static_cast<hvd::ReduceOp>(op_), prescale_, postscale_, &err,
        ps_id_, ps_size_);
    if (h < 0) {
      ctx->SetStatus(tensorflow::errors::Internal(err));
      return;
    }
    WaitHandle(ctx, eng, h);
  }

 private:
  std::string name_;
  int op_ = 1;
  float prescale_ = 1.0f, postscale_ = 1.0f;
  int ps_id_ = 0, ps_size_ = 0;
};

class HvdBroadcastOp : public OpKernel {
 public:
  explicit HvdBroadcastOp(OpKernelConstruction* c) : OpKernel(c) {
    OP_REQUIRES_OK(c, c->GetAttr("tensor_name", &name_));
    OP_REQUIRES_OK(c, c->GetAttr("root_rank", &root_));
    OP_REQUIRES_OK(c, c->GetAttr("process_set_id", &ps_id_));
    OP_REQUIRES_OK(c, c->GetAttr("process_set_size", &ps_size_));
  }

  void Compute(OpKernelContext* ctx) override {
    auto* eng = EngineOrError(ctx);
    if (eng == nullptr) return;
    const Tensor& in = ctx->input(0);
    Tensor* out = nullptr;
    OP_REQUIRES_OK(ctx, ctx->allocate_output(0, in.shape(), &out));
    hvd::DataType dt;
    OP_REQUIRES(ctx, MapDtype(in.dtype(), &dt),
                tensorflow::errors::InvalidArgument(
                    "unsupported dtype for engine broadcast"));
    std::memcpy(const_cast<char*>(out->tensor_data().data()),
                in.tensor_data().data(), in.tensor_data().size());
    std::string err;
    int64_t h = eng->EnqueueBroadcast(
        name_, const_cast<char*>(out->tensor_data().data()), ShapeOf(in),
        dt, root_, &err, ps_id_, ps_size_);
    if (h < 0) {
      ctx->SetStatus(tensorflow::errors::Internal(err));
      return;
    }
    WaitHandle(ctx, eng, h);
  }

 private:
  std::string name_;
  int root_ = 0, ps_id_ = 0, ps_size_ = 0;
};

class HvdAllgatherOp : public OpKernel {
 public:
  explicit HvdAllgatherOp(OpKernelConstruction* c) : OpKernel(c) {
    OP_REQUIRES_OK(c, c->GetAttr("tensor_name", &name_));
    OP_REQUIRES_OK(c, c->GetAttr("process_set_id", &ps_id_));
    OP_REQUIRES_OK(c, c->GetAttr("process_set_size", &ps_size_));
  }

  void Compute(OpKernelContext* ctx) override {
    auto* eng = EngineOrError(ctx);
    if (eng == nullptr) return;
    const Tensor& in = ctx->input(0);
    hvd::DataType dt;
    OP_REQUIRES(ctx, MapDtype(in.dtype(), &dt),
                tensorflow::errors::InvalidArgument(
                    "unsupported dtype for engine allgather"));
    std::string err;
    int64_t h = eng->EnqueueAllgather(name_, in.tensor_data().data(),
                                      ShapeOf(in), dt, &err, ps_id_,
                                      ps_size_);
    if (h < 0) {
      ctx->SetStatus(tensorflow::errors::Internal(err));
      return;
    }
    hvd::StatusType st = eng->handles().Wait(h);
    auto* state = eng->handles().Get(h);
    if (st != hvd::StatusType::OK || state == nullptr) {
      std::string reason =
          state != nullptr && !state->status.reason.empty()
              ? state->status.reason
              : "allgather failed";
      eng->handles().Release(h);
      ctx->SetStatus(tensorflow::errors::Internal(reason));
      return;
    }
    // First-dim-concat result with a negotiated size.  Row element
    // count comes from dims[1:], NOT NumElements()/dim0 — a rank
    // contributing zero rows must still shape the gathered result
    // correctly (same formula as the ctypes binding's
    // `reshape((-1,) + shape[1:])`).
    tensorflow::TensorShape out_shape = in.shape();
    tensorflow::int64 row = 1;
    for (int i = 1; i < in.dims(); ++i) row *= in.dim_size(i);
    tensorflow::int64 elem_size =
        tensorflow::DataTypeSize(in.dtype());
    tensorflow::int64 total_rows =
        elem_size > 0 && row > 0
            ? static_cast<tensorflow::int64>(state->result.size()) /
                  (elem_size * row)
            : 0;
    out_shape.set_dim(0, total_rows);
    Tensor* out = nullptr;
    if (!ctx->allocate_output(0, out_shape, &out).ok()) {
      eng->handles().Release(h);
      ctx->SetStatus(
          tensorflow::errors::Internal("allgather output allocation"));
      return;
    }
    std::memcpy(const_cast<char*>(out->tensor_data().data()),
                state->result.data(), state->result.size());
    eng->handles().Release(h);
  }

 private:
  std::string name_;
  int ps_id_ = 0, ps_size_ = 0;
};

class HvdGroupedAllreduceOp : public OpKernel {
 public:
  explicit HvdGroupedAllreduceOp(OpKernelConstruction* c) : OpKernel(c) {
    OP_REQUIRES_OK(c, c->GetAttr("tensor_name", &name_));
    OP_REQUIRES_OK(c, c->GetAttr("reduce_op", &op_));
    OP_REQUIRES_OK(c, c->GetAttr("prescale_factor", &prescale_));
    OP_REQUIRES_OK(c, c->GetAttr("postscale_factor", &postscale_));
    OP_REQUIRES_OK(c, c->GetAttr("process_set_id", &ps_id_));
    OP_REQUIRES_OK(c, c->GetAttr("process_set_size", &ps_size_));
  }

  void Compute(OpKernelContext* ctx) override {
    // One node submits EVERY tensor before waiting on any: a rank's
    // submission set is atomic, so executor scheduling order cannot
    // block two ranks inside different tensors' collectives (the
    // deadlock the per-tensor synchronous kernels admit under small
    // thread pools), and the engine sees all entries pending at once —
    // full coordinator fusion, like the hook-driven torch path.
    auto* eng = EngineOrError(ctx);
    if (eng == nullptr) return;
    const int n = ctx->num_inputs();
    std::vector<int64_t> handles;
    handles.reserve(n);
    for (int i = 0; i < n; ++i) {
      const Tensor& in = ctx->input(i);
      Tensor* out = nullptr;
      OP_REQUIRES_OK(ctx, ctx->allocate_output(i, in.shape(), &out));
      hvd::DataType dt;
      OP_REQUIRES(ctx, MapDtype(in.dtype(), &dt),
                  tensorflow::errors::InvalidArgument(
                      "unsupported dtype for engine grouped allreduce"));
      std::memcpy(const_cast<char*>(out->tensor_data().data()),
                  in.tensor_data().data(), in.tensor_data().size());
      std::string err;
      // Same wire naming as the eager/bridge grouped surface
      // ("{base}.{i}") so mixed gangs align.
      int64_t h = eng->EnqueueAllreduce(
          name_ + "." + std::to_string(i),
          const_cast<char*>(out->tensor_data().data()), ShapeOf(in), dt,
          static_cast<hvd::ReduceOp>(op_), prescale_, postscale_, &err,
          ps_id_, ps_size_);
      if (h < 0) {
        for (int64_t prior : handles) {
          eng->handles().Wait(prior);
          eng->handles().Release(prior);
        }
        ctx->SetStatus(tensorflow::errors::Internal(err));
        return;
      }
      handles.push_back(h);
    }
    bool ok = true;
    for (int64_t h : handles) ok = WaitHandle(ctx, eng, h) && ok;
  }

 private:
  std::string name_;
  int op_ = 1;
  float prescale_ = 1.0f, postscale_ = 1.0f;
  int ps_id_ = 0, ps_size_ = 0;
};

}  // namespace

REGISTER_OP("HvdAllreduce")
    .Input("tensor: T")
    .Output("sum: T")
    .Attr("T: {float32, float64, half, bfloat16, int32, int64, uint8, "
          "int8, bool}")
    .Attr("tensor_name: string")
    .Attr("reduce_op: int = 1")
    .Attr("prescale_factor: float = 1.0")
    .Attr("postscale_factor: float = 1.0")
    .Attr("process_set_id: int = 0")
    .Attr("process_set_size: int = 0")
    .SetShapeFn([](tensorflow::shape_inference::InferenceContext* c) {
      c->set_output(0, c->input(0));
      return tensorflow::OkStatus();
    });

REGISTER_OP("HvdBroadcast")
    .Input("tensor: T")
    .Output("output: T")
    .Attr("T: {float32, float64, half, bfloat16, int32, int64, uint8, "
          "int8, bool}")
    .Attr("tensor_name: string")
    .Attr("root_rank: int = 0")
    .Attr("process_set_id: int = 0")
    .Attr("process_set_size: int = 0")
    .SetShapeFn([](tensorflow::shape_inference::InferenceContext* c) {
      c->set_output(0, c->input(0));
      return tensorflow::OkStatus();
    });

REGISTER_OP("HvdAllgather")
    .Input("tensor: T")
    .Output("gathered: T")
    .Attr("T: {float32, float64, half, bfloat16, int32, int64, uint8, "
          "int8, bool}")
    .Attr("tensor_name: string")
    .Attr("process_set_id: int = 0")
    .Attr("process_set_size: int = 0")
    .SetShapeFn([](tensorflow::shape_inference::InferenceContext* c) {
      tensorflow::shape_inference::ShapeHandle rest;
      TF_RETURN_IF_ERROR(c->Subshape(c->input(0), 1, &rest));
      tensorflow::shape_inference::ShapeHandle first =
          c->Vector(c->UnknownDim());
      tensorflow::shape_inference::ShapeHandle out;
      TF_RETURN_IF_ERROR(c->Concatenate(first, rest, &out));
      c->set_output(0, out);
      return tensorflow::OkStatus();
    });

REGISTER_OP("HvdGroupedAllreduce")
    .Input("tensors: T")
    .Output("sums: T")
    .Attr("T: list({float32, float64, half, bfloat16, int32, int64, "
          "uint8, int8, bool})")
    .Attr("tensor_name: string")
    .Attr("reduce_op: int = 1")
    .Attr("prescale_factor: float = 1.0")
    .Attr("postscale_factor: float = 1.0")
    .Attr("process_set_id: int = 0")
    .Attr("process_set_size: int = 0")
    .SetShapeFn([](tensorflow::shape_inference::InferenceContext* c) {
      for (int i = 0; i < c->num_inputs(); ++i)
        c->set_output(i, c->input(i));
      return tensorflow::OkStatus();
    });

REGISTER_KERNEL_BUILDER(Name("HvdAllreduce").Device(DEVICE_CPU),
                        HvdAllreduceOp);
REGISTER_KERNEL_BUILDER(Name("HvdGroupedAllreduce").Device(DEVICE_CPU),
                        HvdGroupedAllreduceOp);
REGISTER_KERNEL_BUILDER(Name("HvdBroadcast").Device(DEVICE_CPU),
                        HvdBroadcastOp);
REGISTER_KERNEL_BUILDER(Name("HvdAllgather").Device(DEVICE_CPU),
                        HvdAllgatherOp);
