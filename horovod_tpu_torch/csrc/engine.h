// The native coordination engine: background thread + star controller +
// ring data plane over a TCP full mesh.
//
// Behavioral parity map (reference → here), mirroring the Python engine in
// horovod_tpu_torch/runtime_py.py which is the executable spec:
//   horovod/common/operations.cc:333-589 BackgroundThreadLoop/RunLoopOnce
//       → Engine::BackgroundLoop / RunLoopOnce
//   horovod/common/controller.cc:62-354 ComputeResponseList
//       → Engine::CoordinatorCycle (rank-0 message table)
//   horovod/common/controller.cc:376-609 ConstructResponse
//       → Engine::ConstructResponse
//   horovod/common/controller.cc:638-759 FuseResponses
//       → Engine::FuseResponses
//   horovod/common/tensor_queue.cc → request_queue_/table_/name guard
//   horovod/common/stall_inspector.cc → Engine::CheckStalls
//   horovod/torch/handle_manager.h → HandleManager
//   horovod/common/ops/gloo_operations.cc (CPU ring data plane)
//       → Engine::RingAllreduce / RingAllgather / ... below
//
// Process bootstrap (rendezvous, socket dialing) stays in Python — it is
// cold-path host traffic; the connected fds are handed to this engine which
// owns them from then on.  Everything after init runs without the GIL.
#pragma once

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <list>
#include <map>
#include <memory>
#include <mutex>
#include <set>
#include <string>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#include "autotune.h"
#include "timeline.h"
#include "types.h"
#include "wire.h"

namespace hvd {

struct HandleState {
  bool done = false;
  Status status;
  // Result storage for ops whose output size is negotiated (allgather,
  // alltoall).  Allreduce/broadcast write in place into the caller buffer.
  std::vector<uint8_t> result;
  std::vector<int64_t> recv_splits;
};

class HandleManager {
 public:
  int64_t Allocate();
  void MarkDone(int64_t h, Status status, std::vector<uint8_t> result = {},
                std::vector<int64_t> splits = {});
  int Poll(int64_t h);  // 1 done, 0 pending, -1 unknown
  // Blocks until done; returns the status type.
  StatusType Wait(int64_t h);
  HandleState* Get(int64_t h);  // valid until Release
  void Release(int64_t h);

 private:
  std::mutex mu_;
  std::condition_variable cv_;
  int64_t next_ = 0;
  std::unordered_map<int64_t, HandleState> states_;
};

struct TensorTableEntry {
  std::string name;
  uint8_t* data = nullptr;       // caller buffer (in/out), or stand-in
  std::vector<uint8_t> standin;  // owned zero buffer for joined ranks
  int64_t nelems = 0;
  int64_t handle = -1;  // -1 => join stand-in, no completion
  Request request;
  std::vector<int64_t> splits;  // alltoall only
  double enqueue_s = 0;
};

struct EngineConfig {
  int rank = 0;
  int size = 1;
  int local_rank = 0;
  int local_size = 1;
  int cross_rank = 0;
  int cross_size = 1;
  double cycle_time_s = 0.001;
  int64_t fusion_threshold = 64 << 20;
  double stall_warn_s = 60.0;
  double stall_shutdown_s = 0.0;
  bool stall_check_disable = false;
  int64_t cache_capacity = 1024;  // 0 disables the response cache
  // Two-level data plane: local ring reduce-scatter → cross ring
  // allreduce → local ring allgather (the NCCLHierarchicalAllreduce
  // shape, nccl_operations.cc:163-363).  Effective only when the
  // topology is actually hierarchical (local_size>1 && cross_size>1).
  bool hierarchical_allreduce = false;
  bool hierarchical_allgather = false;
  // Ring-hop receive segmentation (PyEngine data plane; carried here so
  // the knob round-trips the params broadcast unchanged in mixed jobs).
  int64_t ring_segment_bytes = 0;
  // Autotuner (coordinator only; parity: parameter_manager.cc).
  bool autotune = false;
  ParameterManager::Options autotune_opts;
  // Timeline (rank 0 only; parity: timeline.cc, HOROVOD_TIMELINE).
  std::string timeline_path;
  bool timeline_mark_cycles = false;
};

// LRU cache of previously negotiated single-tensor ALLREDUCE responses,
// position-addressed and kept coherent across ranks by mutating it only at
// response-execution time.  Parity: horovod/common/response_cache.cc/.h,
// protocol adapted to the star controller (see
// horovod_tpu_torch/common/response_cache.py — the Python twin is the spec).
class ResponseCache {
 public:
  enum State { MISS = 0, HIT = 1, INVALID = 2 };

  explicit ResponseCache(int64_t capacity) : capacity_(capacity) {}
  // Only valid before first use (the engine ctor, pre-background-thread).
  void SetCapacity(int64_t c) { capacity_ = c; }
  bool enabled() const { return capacity_ > 0; }

  State Classify(const Request& req, uint32_t* position);
  // nullptr when the position is vacant.
  const Response* GetByPosition(uint32_t pos) const;
  const std::string* NameAt(uint32_t pos) const;
  // Rebuilds the full Request a hit event stands for; false if vacant.
  bool SynthesizeRequest(uint32_t pos, int rank, Request* out) const;
  void Touch(uint32_t pos);
  // Caches each tensor of an executed ALLREDUCE response as its own
  // single-tensor response.  Exact dims come from the negotiated
  // resp.tensor_shapes — response-carried, hence identical on every
  // rank regardless of local request state (joined ranks included).
  void Put(const Response& resp);
  // Position of `name`, or -1.
  int64_t PositionOf(const std::string& name) const;

  int64_t hits = 0, misses = 0, evictions = 0;
  int64_t size() const { return static_cast<int64_t>(by_name_.size()); }
  int64_t capacity() const { return capacity_; }

 private:
  struct Entry {
    std::string name;
    uint32_t position = 0;
    Response response;  // single-tensor
    Request params;     // canonical request (rank field unused)
    std::list<std::string>::iterator lru_it;
  };
  void PutOne(const std::string& name, Response resp, Request params);
  static bool SameParams(const Request& a, const Request& b);

  int64_t capacity_;
  std::unordered_map<std::string, Entry> by_name_;
  std::unordered_map<uint32_t, Entry*> by_pos_;
  std::list<std::string> lru_;  // front = least recently used; O(1) via
                                // the iterators stored in each Entry
  std::vector<uint32_t> free_positions_;
  uint32_t next_position_ = 0;
};

class Engine {
 public:
  // data_fds: one per rank (self = -1), full mesh.
  // ctrl_fds: coordinator: fd per worker rank (index 0 unused = -1);
  //           workers: index 0 = fd to the coordinator.
  Engine(const EngineConfig& cfg, std::vector<int> data_fds,
         std::vector<int> ctrl_fds);
  ~Engine();

  // Enqueue APIs; return handle or -1 with *err filled.
  int64_t EnqueueAllreduce(const std::string& name, void* buf,
                           const TensorShape& shape, DataType dt, ReduceOp op,
                           double prescale, double postscale,
                           std::string* err, int32_t ps_id = 0,
                           int32_t ps_size = 0);
  int64_t EnqueueAllgather(const std::string& name, const void* buf,
                           const TensorShape& shape, DataType dt,
                           std::string* err, int32_t ps_id = 0,
                           int32_t ps_size = 0);
  int64_t EnqueueBroadcast(const std::string& name, void* buf,
                           const TensorShape& shape, DataType dt,
                           int root_rank, std::string* err,
                           int32_t ps_id = 0, int32_t ps_size = 0);
  int64_t EnqueueAlltoall(const std::string& name, const void* buf,
                          const TensorShape& shape, DataType dt,
                          const std::vector<int64_t>& splits,
                          std::string* err, int32_t ps_id = 0,
                          int32_t ps_size = 0);
  int64_t EnqueueReduceScatter(const std::string& name, const void* buf,
                               const TensorShape& shape, DataType dt,
                               ReduceOp op, std::string* err,
                               int32_t ps_id = 0, int32_t ps_size = 0);

  int Barrier(std::string* err, int32_t ps_id = 0,
              int32_t ps_size = 0);  // blocking; 0 ok
  int Join();                     // blocking; returns last joined rank

  // Process sets: register member ranks for a set id (idempotent; the
  // id is the Python-side hash of the sorted members).  Enqueue fns
  // take (ps_id, ps_size); 0/0 = the global set.
  void RegisterProcessSet(int32_t id, std::vector<int> ranks);
  std::vector<int> ProcessSetRanks(int32_t id);
  // (member global ranks, my index) for a response — the full world for
  // the global set (mirrors cpu_backend.resp_group).
  std::pair<std::vector<int>, int> ResponseGroup(const Response& resp);

  // hits/misses/evictions/size/capacity, for introspection + tests.
  void CacheStats(int64_t out[5]);

  HandleManager& handles() { return handles_; }
  const EngineConfig& config() const { return cfg_; }
  void Shutdown();
  bool aborted() const { return aborted_.load(); }

 private:
  int64_t Enqueue(TensorTableEntry entry, std::string* err);
  bool ClaimName(const std::string& name, std::string* err);
  void ReleaseName(const std::string& name);

  void BackgroundLoop();
  bool RunLoopOnce();
  bool WorkerCycle(std::vector<Request> msgs);
  bool CoordinatorCycle(std::vector<Request> msgs);
  void AbsorbRequest(const Request& req, std::vector<std::string>* ready);
  // Splits popped requests into uncached requests + cache-hit events.
  void ClassifyRequests(std::vector<Request> msgs,
                        std::vector<Request>* requests,
                        std::vector<CacheHit>* hit_events);
  void ExecuteCachedHits(const std::vector<uint32_t>& hit_positions);
  void ProcessResends(const std::vector<std::string>& resend_names);
  Response ConstructResponse(const std::string& name,
                             const std::vector<Request>& reqs);
  std::vector<Response> FuseResponses(std::vector<Response> responses);
  bool CheckStalls();
  void DrainOnShutdown();
  void Abort(const std::string& reason);

  // Execution.
  std::vector<TensorTableEntry> GetEntries(const Response& resp);
  void PerformResponse(const Response& resp, bool from_cache = false);
  void DoAllreduce(std::vector<TensorTableEntry>& entries,
                   const Response& resp);
  void DoAllgather(std::vector<TensorTableEntry>& entries,
                   const Response& resp);
  void DoAllgatherHierarchical(std::vector<TensorTableEntry>& entries,
                               const Response& resp);
  void DoBroadcast(std::vector<TensorTableEntry>& entries,
                   const Response& resp);
  void DoAlltoall(std::vector<TensorTableEntry>& entries,
                  const Response& resp);
  void DoReduceScatter(std::vector<TensorTableEntry>& entries,
                       const Response& resp);
  void DoBarrier(const Response& resp);

  // Data plane.
  void RingAllreduceFlat(uint8_t* buf, int64_t nelems, DataType dt,
                         ReduceOp op);
  // Ring allreduce restricted to `group` (global ranks, any order);
  // `me` is this rank's index within it.
  void RingAllreduceGroup(uint8_t* buf, int64_t nelems, DataType dt,
                          ReduceOp op, const std::vector<int>& group,
                          int me);
  void HierarchicalAllreduceFlat(uint8_t* buf, int64_t nelems, DataType dt,
                                 ReduceOp op);
  // True when hierarchical mode can actually run on this topology.
  bool HierarchicalTopologyOk() const;
  std::vector<int> LocalGroup() const;
  std::vector<int> CrossGroup() const;
  void AdasumFlat(uint8_t* buf, int64_t nelems, DataType dt);

  EngineConfig cfg_;
  std::vector<int> data_fds_;
  std::vector<int> ctrl_fds_;
  HandleManager handles_;

  std::mutex queue_mu_;
  std::vector<Request> request_queue_;
  std::unordered_map<std::string, TensorTableEntry> table_;
  std::unordered_set<std::string> pending_names_;
  bool joined_ = false;
  int64_t join_handle_ = -1;
  std::atomic<int> last_joined_rank_{-1};

  // Coordinator state (rank 0 only).
  struct MessageTableEntry {
    std::vector<Request> requests;
    double first_seen_s = 0;
  };
  std::map<std::string, MessageTableEntry> msg_table_;
  std::set<int> joined_ranks_;
  double last_stall_check_s_ = 0;

  // Response cache (both roles). All access is on the background thread,
  // except CacheStats which takes cache_mu_.
  std::mutex cache_mu_;
  ResponseCache cache_{1024};
  bool cache_classify_enabled_ = true;
  std::unordered_set<std::string> resend_uncached_;
  // Coordinator only: ranks whose contribution for a name arrived as a
  // hit event (→ response can be broadcast as a bare position).
  std::unordered_map<std::string, std::set<int>> hit_ranks_;

  // Autotuner (coordinator only; background thread).
  std::unique_ptr<ParameterManager> pm_;
  bool have_pending_params_ = false;
  TunedParams pending_params_;
  void ApplyParams(const WireParams& p);

  // Timeline (rank 0 only; events emitted from the background thread).
  Timeline timeline_;

  // Fusion scratch (parity: fusion_buffer_manager.cc — one lazily grown
  // persistent buffer reused across fused launches).
  std::vector<uint8_t> fusion_buffer_;

  std::atomic<bool> shutdown_{false};
  // Set by Shutdown(): the loop negotiates the stop through the
  // controller (RequestList/ResponseList shutdown bits) so every rank
  // exits in the same cycle instead of closing sockets under a peer.
  std::atomic<bool> shutdown_requested_{false};
  std::atomic<bool> loop_exited_{false};
  std::atomic<bool> aborted_{false};
  std::atomic<int64_t> barrier_counter_{0};
  std::mutex process_sets_mu_;
  std::map<int32_t, std::vector<int>> process_sets_;
  std::map<int32_t, int64_t> ps_barrier_counters_;
  std::thread bg_;
};

}  // namespace hvd
