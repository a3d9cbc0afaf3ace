// extern "C" surface of the native engine, consumed by
// horovod_tpu_torch/native.py over ctypes.
//
// Role parity: the ctypes-visible C API in horovod/common/operations.cc:650-788
// (horovod_init/rank/size/...) plus the enqueue/handle surface of the torch
// v2 binding (horovod/torch/mpi_ops_v2.cc:53-299) — collapsed into one API
// since every framework front-end here goes through numpy buffers.
//
// Convention: enqueue functions return a handle >= 0 or -1 with the message
// available via hvd_last_error() (thread-local).  hvd_wait() returns the
// StatusType; result buffers for size-negotiated ops (allgather/alltoall)
// are owned by the engine until hvd_release().

#include <cstring>
#include <chrono>
#include <memory>
#include <string>
#include <vector>

#include "engine.h"
#include "kernels.h"

namespace {

std::unique_ptr<hvd::Engine> g_engine;
thread_local std::string g_last_error;

hvd::TensorShape MakeShape(int ndim, const int64_t* dims) {
  hvd::TensorShape s;
  s.dims.assign(dims, dims + ndim);
  return s;
}

}  // namespace

extern "C" {

int hvd_create(int rank, int size, int local_rank, int local_size,
               int cross_rank, int cross_size, const int32_t* data_fds,
               const int32_t* ctrl_fds, double cycle_time_s,
               int64_t fusion_threshold, double stall_warn_s,
               double stall_shutdown_s, int stall_check_disable,
               int64_t cache_capacity, int hierarchical_allreduce,
               int hierarchical_allgather, int autotune, int tune_fusion,
               int tune_cycle, int tune_cache, int tune_hier_allreduce,
               int tune_hier_allgather, int autotune_warmup,
               int autotune_max_samples, double autotune_sample_duration_s,
               const char* autotune_log, const char* timeline_path,
               int timeline_mark_cycles) {
  if (g_engine) {
    g_last_error = "engine already initialized";
    return -1;
  }
  hvd::EngineConfig cfg;
  cfg.rank = rank;
  cfg.size = size;
  cfg.local_rank = local_rank;
  cfg.local_size = local_size;
  cfg.cross_rank = cross_rank;
  cfg.cross_size = cross_size;
  cfg.cycle_time_s = cycle_time_s;
  cfg.fusion_threshold = fusion_threshold;
  cfg.stall_warn_s = stall_warn_s;
  cfg.stall_shutdown_s = stall_shutdown_s;
  cfg.stall_check_disable = stall_check_disable != 0;
  cfg.cache_capacity = cache_capacity;
  cfg.hierarchical_allreduce = hierarchical_allreduce != 0;
  cfg.hierarchical_allgather = hierarchical_allgather != 0;
  // Autotune knobs arrive pre-parsed from Python (env_util), same path
  // as every other knob, so both engines read env identically.
  cfg.autotune = autotune != 0 &&
                 (tune_fusion != 0 || tune_cycle != 0 || tune_cache != 0 ||
                  tune_hier_allreduce != 0 || tune_hier_allgather != 0);
  if (cfg.autotune) {
    auto& o = cfg.autotune_opts;
    o.tune_fusion = tune_fusion != 0;
    o.tune_cycle = tune_cycle != 0;
    o.tune_cache = tune_cache != 0;
    o.tune_hier_allreduce = tune_hier_allreduce != 0;
    o.tune_hier_allgather = tune_hier_allgather != 0;
    o.warmup_samples = autotune_warmup;
    o.max_samples = autotune_max_samples;
    o.sample_duration_s = autotune_sample_duration_s;
    if (autotune_log) o.log_path = autotune_log;
  }
  if (timeline_path) cfg.timeline_path = timeline_path;
  cfg.timeline_mark_cycles = timeline_mark_cycles != 0;
  std::vector<int> data(data_fds, data_fds + size);
  std::vector<int> ctrl(ctrl_fds, ctrl_fds + size);
  try {
    g_engine = std::make_unique<hvd::Engine>(cfg, std::move(data),
                                             std::move(ctrl));
  } catch (const std::exception& e) {
    g_last_error = e.what();
    return -1;
  }
  return 0;
}

void hvd_shutdown() {
  if (g_engine) {
    g_engine->Shutdown();
    g_engine.reset();
  }
}

int hvd_is_aborted() { return g_engine && g_engine->aborted() ? 1 : 0; }

// Raw engine pointer for in-process native consumers (the XLA FFI
// handlers in ffi_bridge.cc); NULL before init / after shutdown.
void* hvd_engine_handle() { return g_engine.get(); }

const char* hvd_last_error() { return g_last_error.c_str(); }

int64_t hvd_register_process_set(int id, const int32_t* ranks, int n) {
  if (!g_engine) {
    g_last_error = "engine not initialized";
    return -1;
  }
  g_engine->RegisterProcessSet(id, std::vector<int>(ranks, ranks + n));
  return 0;
}

int64_t hvd_allreduce_async(const char* name, void* buf, int ndim,
                            const int64_t* dims, int dtype, int op,
                            double prescale, double postscale, int ps_id,
                            int ps_size) {
  if (!g_engine) {
    g_last_error = "engine not initialized";
    return -1;
  }
  std::string err;
  int64_t h = g_engine->EnqueueAllreduce(
      name, buf, MakeShape(ndim, dims), static_cast<hvd::DataType>(dtype),
      static_cast<hvd::ReduceOp>(op), prescale, postscale, &err, ps_id,
      ps_size);
  if (h < 0) g_last_error = err;
  return h;
}

int64_t hvd_allgather_async(const char* name, const void* buf, int ndim,
                            const int64_t* dims, int dtype, int ps_id,
                            int ps_size) {
  if (!g_engine) {
    g_last_error = "engine not initialized";
    return -1;
  }
  std::string err;
  int64_t h = g_engine->EnqueueAllgather(name, buf, MakeShape(ndim, dims),
                                         static_cast<hvd::DataType>(dtype),
                                         &err, ps_id, ps_size);
  if (h < 0) g_last_error = err;
  return h;
}

// Test-only conversion surface: lets the Python tests pin the fp8
// codecs bit-for-bit against ml_dtypes (mixed native/py jobs rely on
// the two sides converting identically).  kind: 0 = e4m3fn, 1 = e5m2.
void hvd_fp8_to_f32(int kind, const uint8_t* in, float* out, int n) {
  for (int i = 0; i < n; ++i)
    out[i] = kind == 0 ? hvd::Fp8E4m3ToFloat(in[i])
                       : hvd::Fp8E5m2ToFloat(in[i]);
}

void hvd_f32_to_fp8(int kind, const float* in, uint8_t* out, int n) {
  for (int i = 0; i < n; ++i)
    out[i] = kind == 0 ? hvd::FloatToFp8E4m3(in[i])
                       : hvd::FloatToFp8E5m2(in[i]);
}

int64_t hvd_reducescatter_async(const char* name, const void* buf, int ndim,
                                const int64_t* dims, int dtype, int op,
                                int ps_id, int ps_size) {
  if (!g_engine) {
    g_last_error = "engine not initialized";
    return -1;
  }
  std::string err;
  int64_t h = g_engine->EnqueueReduceScatter(
      name, buf, MakeShape(ndim, dims), static_cast<hvd::DataType>(dtype),
      static_cast<hvd::ReduceOp>(op), &err, ps_id, ps_size);
  if (h < 0) g_last_error = err;
  return h;
}

int64_t hvd_broadcast_async(const char* name, void* buf, int ndim,
                            const int64_t* dims, int dtype, int root_rank,
                            int ps_id, int ps_size) {
  if (!g_engine) {
    g_last_error = "engine not initialized";
    return -1;
  }
  std::string err;
  int64_t h = g_engine->EnqueueBroadcast(name, buf, MakeShape(ndim, dims),
                                         static_cast<hvd::DataType>(dtype),
                                         root_rank, &err, ps_id, ps_size);
  if (h < 0) g_last_error = err;
  return h;
}

int64_t hvd_alltoall_async(const char* name, const void* buf, int ndim,
                           const int64_t* dims, int dtype,
                           const int64_t* splits, int nsplits, int ps_id,
                           int ps_size) {
  if (!g_engine) {
    g_last_error = "engine not initialized";
    return -1;
  }
  std::vector<int64_t> sp;
  if (splits && nsplits > 0) sp.assign(splits, splits + nsplits);
  std::string err;
  int64_t h = g_engine->EnqueueAlltoall(name, buf, MakeShape(ndim, dims),
                                        static_cast<hvd::DataType>(dtype),
                                        sp, &err, ps_id, ps_size);
  if (h < 0) g_last_error = err;
  return h;
}

// 1 = done, 0 = pending, -1 = unknown handle.
int hvd_poll(int64_t handle) {
  if (!g_engine) return -1;
  return g_engine->handles().Poll(handle);
}

// Blocks; returns the StatusType value.
int hvd_wait(int64_t handle) {
  if (!g_engine) return static_cast<int>(hvd::StatusType::ABORTED);
  return static_cast<int>(g_engine->handles().Wait(handle));
}

// Error message of a completed handle (empty string if none).
const char* hvd_handle_error(int64_t handle) {
  if (!g_engine) return "engine not initialized";
  auto* st = g_engine->handles().Get(handle);
  if (!st) return "unknown handle";
  g_last_error = st->status.reason;
  return g_last_error.c_str();
}

int64_t hvd_result_nbytes(int64_t handle) {
  if (!g_engine) return -1;
  auto* st = g_engine->handles().Get(handle);
  return st ? static_cast<int64_t>(st->result.size()) : -1;
}

const void* hvd_result_data(int64_t handle) {
  if (!g_engine) return nullptr;
  auto* st = g_engine->handles().Get(handle);
  return st && !st->result.empty() ? st->result.data() : nullptr;
}

// Copies up to cap recv splits into out; returns the count.
int hvd_result_splits(int64_t handle, int64_t* out, int cap) {
  if (!g_engine) return -1;
  auto* st = g_engine->handles().Get(handle);
  if (!st) return -1;
  int n = static_cast<int>(st->recv_splits.size());
  for (int i = 0; i < n && i < cap; ++i) out[i] = st->recv_splits[i];
  return n;
}

void hvd_release(int64_t handle) {
  if (g_engine) g_engine->handles().Release(handle);
}

int hvd_barrier(int ps_id, int ps_size) {
  if (!g_engine) {
    g_last_error = "engine not initialized";
    return -1;
  }
  std::string err;
  int rc = g_engine->Barrier(&err, ps_id, ps_size);
  if (rc != 0) g_last_error = err;
  return rc;
}

int hvd_join() {
  if (!g_engine) {
    g_last_error = "engine not initialized";
    return -1;
  }
  return g_engine->Join();
}

// out: hits, misses, evictions, size, capacity.
void hvd_cache_stats(int64_t* out) {
  if (!g_engine) {
    for (int i = 0; i < 5; ++i) out[i] = 0;
    return;
  }
  g_engine->CacheStats(out);
}

// CPU capability probe for diagnostics (hvdrun --check-build).
int hvd_simd_available() {
  return hvd::SimdRuntimeAvailable() ? 1 : 0;
}

// Microbenchmark hook for the wire-codec combine loops (the per-hop hot
// path of compressed ring traffic; parity target: half.cc:43-77's
// vectorized fp16 sum).  Runs `iters` combines of an n-element buffer
// of dtype `dt` and returns elements/second.  The SIMD/scalar split is
// selected by the HVD_NO_SIMD env read at first use, so callers bench
// each side in a fresh process.  Needs no engine.
// Test-only: raw per-hop combine on caller buffers (dst <- combine(in,
// dst)).  Lets the suite pin SIMD and scalar paths bit-for-bit against
// each other across processes (HVD_NO_SIMD toggles at load time).
void hvd_combine_into(void* dst, const void* in, uint64_t n, int dt,
                      int op) {
  hvd::CombineInto(dst, in, n, static_cast<hvd::DataType>(dt),
                   static_cast<hvd::ReduceOp>(op));
}

double hvd_bench_combine(int dt, uint64_t n, int iters) {
  std::vector<uint8_t> a(n * 8, 0), b(n * 8, 0);
  auto t = static_cast<hvd::DataType>(dt);
  // deterministic non-trivial bit patterns valid for every dtype
  for (size_t i = 0; i < a.size(); ++i) {
    a[i] = static_cast<uint8_t>((i * 37u + 11u) & 0x3fu);
    b[i] = static_cast<uint8_t>((i * 53u + 7u) & 0x3fu);
  }
  auto t0 = std::chrono::steady_clock::now();
  for (int it = 0; it < iters; ++it)
    hvd::CombineInto(a.data(), b.data(), n, t, hvd::ReduceOp::SUM);
  auto dt_s = std::chrono::duration<double>(
                  std::chrono::steady_clock::now() - t0)
                  .count();
  return dt_s > 0 ? static_cast<double>(n) * iters / dt_s : 0.0;
}

}  // extern "C"
