// Core enums / status / shape types for the native coordination core.
//
// Behavior parity (not a translation): horovod/common/common.h:90-200 and
// horovod/common/message.h:27-38 in the reference tree.  The numeric values
// MUST match horovod_tpu_torch/common/types.py — the Python and native engines
// are wire-compatible and can coexist in one job.
#pragma once

#include <cstdint>
#include <string>
#include <vector>

namespace hvd {

enum class DataType : uint8_t {
  UINT8 = 0,
  INT8 = 1,
  UINT16 = 2,
  INT16 = 3,
  INT32 = 4,
  INT64 = 5,
  FLOAT16 = 6,
  FLOAT32 = 7,
  FLOAT64 = 8,
  BOOL = 9,
  BFLOAT16 = 10,
  // OCP FP8 wire formats (TPU-native extension; ring hops accumulate
  // via fp32 like half.cc — see kernels.cc Fp8* conversions).
  FLOAT8_E4M3 = 11,
  FLOAT8_E5M2 = 12,
};

inline size_t ItemSize(DataType dt) {
  switch (dt) {
    case DataType::UINT8:
    case DataType::INT8:
    case DataType::BOOL:
    case DataType::FLOAT8_E4M3:
    case DataType::FLOAT8_E5M2:
      return 1;
    case DataType::UINT16:
    case DataType::INT16:
    case DataType::FLOAT16:
    case DataType::BFLOAT16:
      return 2;
    case DataType::INT32:
    case DataType::FLOAT32:
      return 4;
    case DataType::INT64:
    case DataType::FLOAT64:
      return 8;
  }
  return 0;
}

enum class ReduceOp : uint8_t {
  AVERAGE = 0,
  SUM = 1,
  ADASUM = 2,
  MIN = 3,
  MAX = 4,
  PRODUCT = 5,
};

enum class RequestType : uint8_t {
  ALLREDUCE = 0,
  ALLGATHER = 1,
  BROADCAST = 2,
  JOIN = 3,
  ALLTOALL = 4,
  BARRIER = 5,
  REDUCESCATTER = 6,
};

enum class ResponseType : uint8_t {
  ALLREDUCE = 0,
  ALLGATHER = 1,
  BROADCAST = 2,
  JOIN = 3,
  ALLTOALL = 4,
  BARRIER = 5,
  REDUCESCATTER = 6,
  ERROR = 7,
};

// Matches StatusType in types.py; surfaced through the C API.
enum class StatusType : int {
  OK = 0,
  UNKNOWN_ERROR = 1,
  PRECONDITION_ERROR = 2,
  ABORTED = 3,
  INVALID_ARGUMENT = 4,
  IN_PROGRESS = 5,
};

struct Status {
  StatusType type = StatusType::OK;
  std::string reason;

  static Status OK() { return {StatusType::OK, ""}; }
  static Status Aborted(std::string r) {
    return {StatusType::ABORTED, std::move(r)};
  }
  static Status PreconditionError(std::string r) {
    return {StatusType::PRECONDITION_ERROR, std::move(r)};
  }
  static Status InvalidArgument(std::string r) {
    return {StatusType::INVALID_ARGUMENT, std::move(r)};
  }
  static Status UnknownError(std::string r) {
    return {StatusType::UNKNOWN_ERROR, std::move(r)};
  }
  bool ok() const { return type == StatusType::OK; }
};

struct TensorShape {
  std::vector<int64_t> dims;

  int64_t num_elements() const {
    int64_t n = 1;
    for (auto d : dims) n *= d;
    return n;
  }
  bool operator==(const TensorShape& o) const { return dims == o.dims; }
  bool operator!=(const TensorShape& o) const { return dims != o.dims; }
  std::string ToString() const {
    std::string s = "[";
    for (size_t i = 0; i < dims.size(); ++i) {
      if (i) s += ", ";
      s += std::to_string(dims[i]);
    }
    return s + "]";
  }
};

}  // namespace hvd
