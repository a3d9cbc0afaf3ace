// PyTorch dispatcher ops backed by the native engine.
//
// Role parity: horovod/torch/mpi_ops_v2.cc -- ops registered with the
// dispatcher whose kernels enqueue into the shared coordinator.  Loaded
// with torch.ops.load_library (horovod_tpu_torch/torch/_native_ops.py);
// horovod_tpu_torch.torch routes CPU tensors through torch.ops.hvd.* when
// the native engine runs, and horovod_tpu_torch.ops.bridge its grouped
// allreduce through hvd::grouped_allreduce (the JAX package's XLA FFI
// handler, csrc/ffi_bridge.cc, as a dispatcher op).  The eager engine's
// numpy path stays the fallback.  Being dispatcher ops, they appear in
// torch.compile graphs as calls, not graph breaks.

#include <cstring>
#include <string>
#include <vector>

#include <torch/library.h>
#include <ATen/ATen.h>

#include "engine.h"

extern "C" void* hvd_engine_handle();

namespace {

bool MapDtype(at::ScalarType t, hvd::DataType* out) {
  switch (t) {
    case at::kFloat:
      *out = hvd::DataType::FLOAT32;
      return true;
    case at::kDouble:
      *out = hvd::DataType::FLOAT64;
      return true;
    case at::kHalf:
      *out = hvd::DataType::FLOAT16;
      return true;
    case at::kBFloat16:
      *out = hvd::DataType::BFLOAT16;
      return true;
    case at::kInt:
      *out = hvd::DataType::INT32;
      return true;
    case at::kLong:
      *out = hvd::DataType::INT64;
      return true;
    case at::kByte:
      *out = hvd::DataType::UINT8;
      return true;
    case at::kChar:
      *out = hvd::DataType::INT8;
      return true;
    case at::kShort:
      *out = hvd::DataType::INT16;
      return true;
    case at::kFloat8_e4m3fn:
      *out = hvd::DataType::FLOAT8_E4M3;
      return true;
    case at::kFloat8_e5m2:
      *out = hvd::DataType::FLOAT8_E5M2;
      return true;
    case at::kBool:
      *out = hvd::DataType::BOOL;
      return true;
    default:
      return false;
  }
}

hvd::Engine* EngineOrThrow() {
  auto* eng = static_cast<hvd::Engine*>(hvd_engine_handle());
  TORCH_CHECK(eng != nullptr,
              "horovod_tpu_torch native engine is not initialized");
  return eng;
}

hvd::TensorShape ShapeOf(const at::Tensor& t) {
  hvd::TensorShape s;
  for (auto d : t.sizes()) s.dims.push_back(d);
  if (s.dims.empty()) s.dims.push_back(1);  // 0-d lift, ctypes parity
  return s;
}

void WaitOrThrow(hvd::Engine* eng, int64_t h) {
  hvd::StatusType st = eng->handles().Wait(h);
  std::string reason;
  if (st != hvd::StatusType::OK) {
    auto* state = eng->handles().Get(h);
    reason = state != nullptr && !state->status.reason.empty()
                 ? state->status.reason
                 : "collective failed";
  }
  eng->handles().Release(h);
  TORCH_CHECK(reason.empty(), reason);
}

at::Tensor Allreduce(const at::Tensor& input, std::string tensor_name,
                     int64_t reduce_op, double prescale, double postscale,
                     int64_t ps_id, int64_t ps_size) {
  auto* eng = EngineOrThrow();
  at::Tensor out = input.is_contiguous() ? input.clone()
                                         : input.contiguous();
  hvd::DataType dt;
  TORCH_CHECK(MapDtype(out.scalar_type(), &dt),
              "unsupported dtype for engine allreduce");
  std::string err;
  int64_t h = eng->EnqueueAllreduce(
      tensor_name, out.data_ptr(), ShapeOf(out), dt,
      static_cast<hvd::ReduceOp>(reduce_op), prescale, postscale, &err,
      static_cast<int32_t>(ps_id), static_cast<int32_t>(ps_size));
  TORCH_CHECK(h >= 0, err);
  WaitOrThrow(eng, h);
  return out;
}

// In-place variant: reduces directly into the caller's tensor (parity:
// hvd.allreduce_ — mpi_ops_v2.cc's DoAllreduce writes the output in
// place).
at::Tensor& AllreduceInplace(at::Tensor& input, std::string tensor_name,
                             int64_t reduce_op, double prescale,
                             double postscale, int64_t ps_id,
                             int64_t ps_size) {
  auto* eng = EngineOrThrow();
  TORCH_CHECK(input.is_contiguous(),
              "in-place allreduce needs a contiguous tensor");
  hvd::DataType dt;
  TORCH_CHECK(MapDtype(input.scalar_type(), &dt),
              "unsupported dtype for engine allreduce");
  std::string err;
  int64_t h = eng->EnqueueAllreduce(
      tensor_name, input.data_ptr(), ShapeOf(input), dt,
      static_cast<hvd::ReduceOp>(reduce_op), prescale, postscale, &err,
      static_cast<int32_t>(ps_id), static_cast<int32_t>(ps_size));
  TORCH_CHECK(h >= 0, err);
  WaitOrThrow(eng, h);
  return input;
}

at::Tensor Broadcast(const at::Tensor& input, std::string tensor_name,
                     int64_t root_rank, int64_t ps_id, int64_t ps_size) {
  auto* eng = EngineOrThrow();
  at::Tensor out = input.is_contiguous() ? input.clone()
                                         : input.contiguous();
  hvd::DataType dt;
  TORCH_CHECK(MapDtype(out.scalar_type(), &dt),
              "unsupported dtype for engine broadcast");
  std::string err;
  int64_t h = eng->EnqueueBroadcast(
      tensor_name, out.data_ptr(), ShapeOf(out), dt,
      static_cast<int32_t>(root_rank), &err, static_cast<int32_t>(ps_id),
      static_cast<int32_t>(ps_size));
  TORCH_CHECK(h >= 0, err);
  WaitOrThrow(eng, h);
  return out;
}

at::Tensor Allgather(const at::Tensor& input, std::string tensor_name,
                     int64_t ps_id, int64_t ps_size) {
  auto* eng = EngineOrThrow();
  at::Tensor in = input.contiguous();
  hvd::DataType dt;
  TORCH_CHECK(MapDtype(in.scalar_type(), &dt),
              "unsupported dtype for engine allgather");
  std::string err;
  int64_t h = eng->EnqueueAllgather(
      tensor_name, in.data_ptr(), ShapeOf(in), dt, &err,
      static_cast<int32_t>(ps_id), static_cast<int32_t>(ps_size));
  TORCH_CHECK(h >= 0, err);
  hvd::StatusType st = eng->handles().Wait(h);
  auto* state = eng->handles().Get(h);
  if (st != hvd::StatusType::OK || state == nullptr) {
    std::string reason = state != nullptr && !state->status.reason.empty()
                             ? state->status.reason
                             : "allgather failed";
    eng->handles().Release(h);
    TORCH_CHECK(false, reason);
  }
  // Negotiated first-dim size: rows derive from dims[1:] (zero-row
  // contributions included).
  int64_t row = 1;
  for (size_t i = 1; i < in.sizes().size(); ++i) row *= in.size(i);
  int64_t elem = in.element_size();
  int64_t total_rows =
      elem > 0 && row > 0
          ? static_cast<int64_t>(state->result.size()) / (elem * row)
          : 0;
  std::vector<int64_t> shape(in.sizes().begin(), in.sizes().end());
  if (shape.empty()) shape.push_back(1);
  shape[0] = total_rows;
  at::Tensor out = at::empty(shape, in.options());
  std::memcpy(out.data_ptr(), state->result.data(), state->result.size());
  eng->handles().Release(h);
  return out;
}

// The grouped allreduce of the compiled path (the body of the JAX
// package's XLA FFI handler, csrc/ffi_bridge.cc): every operand is copied
// to its output, all are enqueued under `{name}.{i}` and then all are
// awaited, so that the controller sees the whole group outstanding and
// fuses it.  `single`: a group of one keeps the unsuffixed name, so that
// its wire name matches a lone eager allreduce's in a mixed gang.
std::vector<at::Tensor> GroupedAllreduce(at::TensorList inputs,
                                         std::string name,
                                         int64_t reduce_op, double prescale,
                                         double postscale, int64_t ps_id,
                                         int64_t ps_size, int64_t single) {
  auto* eng = EngineOrThrow();
  const size_t n = inputs.size();
  std::vector<at::Tensor> outs;
  outs.reserve(n);
  std::vector<int64_t> handles;
  handles.reserve(n);
  // Await anything already enqueued before failing: the engine owns
  // those buffers until they complete, and peers may be negotiating.
  auto drain = [&]() {
    for (int64_t h : handles) {
      eng->handles().Wait(h);
      eng->handles().Release(h);
    }
  };
  for (size_t i = 0; i < n; ++i) {
    hvd::DataType dt;
    if (!MapDtype(inputs[i].scalar_type(), &dt)) {
      drain();
      TORCH_CHECK(false, "unsupported dtype for engine allreduce");
    }
    // The engine reduces in place: stage the operand into the output.
    at::Tensor out = inputs[i].clone(at::MemoryFormat::Contiguous);
    std::string tensor_name = (single != 0 && n == 1)
                                  ? name
                                  : name + "." + std::to_string(i);
    // The dims as they are (a 0-d operand has none), as the FFI handler
    // and the eager path send them.
    hvd::TensorShape shape;
    for (auto d : out.sizes()) shape.dims.push_back(d);
    std::string err;
    int64_t h = eng->EnqueueAllreduce(
        tensor_name, out.data_ptr(), shape, dt,
        static_cast<hvd::ReduceOp>(reduce_op), prescale, postscale, &err,
        static_cast<int32_t>(ps_id), static_cast<int32_t>(ps_size));
    if (h < 0) {
      drain();
      TORCH_CHECK(false, "enqueue failed: " + err);
    }
    handles.push_back(h);
    outs.push_back(out);
  }
  std::string first_error;
  for (int64_t h : handles) {
    hvd::StatusType st = eng->handles().Wait(h);
    if (st != hvd::StatusType::OK && first_error.empty()) {
      auto* state = eng->handles().Get(h);
      first_error = state != nullptr && !state->status.reason.empty()
                        ? state->status.reason
                        : "collective failed";
    }
    eng->handles().Release(h);
  }
  TORCH_CHECK(first_error.empty(), first_error);
  return outs;
}

}  // namespace

TORCH_LIBRARY(hvd, m) {
  m.def(
      "allreduce(Tensor input, str tensor_name, int reduce_op, "
      "float prescale, float postscale, int ps_id, int ps_size) "
      "-> Tensor");
  m.def(
      "allreduce_(Tensor(a!) input, str tensor_name, int reduce_op, "
      "float prescale, float postscale, int ps_id, int ps_size) "
      "-> Tensor(a!)");
  m.def(
      "broadcast(Tensor input, str tensor_name, int root_rank, "
      "int ps_id, int ps_size) -> Tensor");
  m.def(
      "allgather(Tensor input, str tensor_name, int ps_id, "
      "int ps_size) -> Tensor");
  m.def(
      "grouped_allreduce(Tensor[] inputs, str name, int reduce_op, "
      "float prescale, float postscale, int ps_id, int ps_size, "
      "int single) -> Tensor[]");
}

TORCH_LIBRARY_IMPL(hvd, CPU, m) {
  m.impl("allreduce", Allreduce);
  m.impl("allreduce_", AllreduceInplace);
  m.impl("broadcast", Broadcast);
  m.impl("allgather", Allgather);
  m.impl("grouped_allreduce", GroupedAllreduce);
}
