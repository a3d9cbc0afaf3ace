#include "engine.h"

#include <unistd.h>

#include <algorithm>
#include <chrono>
#include <cstdio>
#include <cstring>

#include "kernels.h"
#include "sockets.h"

namespace hvd {
namespace {

double NowS() {
  return std::chrono::duration<double>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

int64_t Mod(int64_t a, int64_t m) { return ((a % m) + m) % m; }

// NCCL-style near-equal chunking (parity: cpu_backend._chunk_bounds).
std::vector<int64_t> ChunkBounds(int64_t n, int parts) {
  int64_t base = n / parts, rem = n % parts;
  std::vector<int64_t> bounds{0};
  for (int i = 0; i < parts; ++i)
    bounds.push_back(bounds.back() + base + (i < rem ? 1 : 0));
  return bounds;
}

const char* OpName(RequestType t) {
  switch (t) {
    case RequestType::ALLREDUCE: return "ALLREDUCE";
    case RequestType::ALLGATHER: return "ALLGATHER";
    case RequestType::BROADCAST: return "BROADCAST";
    case RequestType::JOIN: return "JOIN";
    case RequestType::ALLTOALL: return "ALLTOALL";
    case RequestType::BARRIER: return "BARRIER";
    case RequestType::REDUCESCATTER: return "REDUCESCATTER";
  }
  return "?";
}

const char* DtypeName(DataType t) {
  switch (t) {
    case DataType::UINT8: return "UINT8";
    case DataType::INT8: return "INT8";
    case DataType::UINT16: return "UINT16";
    case DataType::INT16: return "INT16";
    case DataType::INT32: return "INT32";
    case DataType::INT64: return "INT64";
    case DataType::FLOAT16: return "FLOAT16";
    case DataType::FLOAT32: return "FLOAT32";
    case DataType::FLOAT64: return "FLOAT64";
    case DataType::BOOL: return "BOOL";
    case DataType::BFLOAT16: return "BFLOAT16";
    case DataType::FLOAT8_E4M3: return "FLOAT8_E4M3";
    case DataType::FLOAT8_E5M2: return "FLOAT8_E5M2";
  }
  return "?";
}

}  // namespace

// ---------------------------------------------------------------------------
// HandleManager
// ---------------------------------------------------------------------------

int64_t HandleManager::Allocate() {
  std::lock_guard<std::mutex> lk(mu_);
  int64_t h = next_++;
  states_[h];  // default-construct pending state
  return h;
}

void HandleManager::MarkDone(int64_t h, Status status,
                             std::vector<uint8_t> result,
                             std::vector<int64_t> splits) {
  {
    std::lock_guard<std::mutex> lk(mu_);
    auto it = states_.find(h);
    if (it == states_.end()) return;
    it->second.done = true;
    it->second.status = std::move(status);
    it->second.result = std::move(result);
    it->second.recv_splits = std::move(splits);
  }
  cv_.notify_all();
}

int HandleManager::Poll(int64_t h) {
  std::lock_guard<std::mutex> lk(mu_);
  auto it = states_.find(h);
  if (it == states_.end()) return -1;
  return it->second.done ? 1 : 0;
}

StatusType HandleManager::Wait(int64_t h) {
  std::unique_lock<std::mutex> lk(mu_);
  auto it = states_.find(h);
  if (it == states_.end()) return StatusType::INVALID_ARGUMENT;
  cv_.wait(lk, [&] { return states_[h].done; });
  return states_[h].status.type;
}

HandleState* HandleManager::Get(int64_t h) {
  std::lock_guard<std::mutex> lk(mu_);
  auto it = states_.find(h);
  return it == states_.end() ? nullptr : &it->second;
}

void HandleManager::Release(int64_t h) {
  std::lock_guard<std::mutex> lk(mu_);
  states_.erase(h);
}

// ---------------------------------------------------------------------------
// ResponseCache
// ---------------------------------------------------------------------------

bool ResponseCache::SameParams(const Request& a, const Request& b) {
  return a.tensor_type == b.tensor_type &&
         a.tensor_shape.dims == b.tensor_shape.dims &&
         a.reduce_op == b.reduce_op &&
         a.prescale_factor == b.prescale_factor &&
         a.postscale_factor == b.postscale_factor && a.device == b.device;
}

ResponseCache::State ResponseCache::Classify(const Request& req,
                                             uint32_t* position) {
  *position = 0;
  // Process-set ops bypass the cache (positions must stay coherent on
  // EVERY rank; non-members never see the set's traffic).
  if (!enabled() || req.request_type != RequestType::ALLREDUCE ||
      req.process_set_id)
    return MISS;
  auto it = by_name_.find(req.tensor_name);
  if (it == by_name_.end()) {
    ++misses;
    return MISS;
  }
  if (!SameParams(it->second.params, req)) {
    *position = it->second.position;
    return INVALID;
  }
  ++hits;
  *position = it->second.position;
  return HIT;
}

const Response* ResponseCache::GetByPosition(uint32_t pos) const {
  auto it = by_pos_.find(pos);
  return it == by_pos_.end() ? nullptr : &it->second->response;
}

const std::string* ResponseCache::NameAt(uint32_t pos) const {
  auto it = by_pos_.find(pos);
  return it == by_pos_.end() ? nullptr : &it->second->name;
}

bool ResponseCache::SynthesizeRequest(uint32_t pos, int rank,
                                      Request* out) const {
  auto it = by_pos_.find(pos);
  if (it == by_pos_.end()) return false;
  *out = it->second->params;
  out->request_rank = rank;
  return true;
}

void ResponseCache::Touch(uint32_t pos) {
  auto it = by_pos_.find(pos);
  if (it == by_pos_.end()) return;
  lru_.splice(lru_.end(), lru_, it->second->lru_it);
}

int64_t ResponseCache::PositionOf(const std::string& name) const {
  auto it = by_name_.find(name);
  return it == by_name_.end() ? -1 : static_cast<int64_t>(it->second.position);
}

void ResponseCache::Put(const Response& resp) {
  if (!enabled() || resp.response_type != ResponseType::ALLREDUCE ||
      !resp.error_message.empty() || resp.process_set_id)
    return;
  bool have_shapes = resp.tensor_shapes.size() == resp.tensor_names.size();
  for (size_t i = 0; i < resp.tensor_names.size(); ++i) {
    const auto& name = resp.tensor_names[i];
    TensorShape shape;
    if (have_shapes)
      shape = resp.tensor_shapes[i];
    else
      shape.dims = {resp.tensor_sizes[i]};

    Response single;
    single.response_type = ResponseType::ALLREDUCE;
    single.tensor_type = resp.tensor_type;
    single.tensor_names = {name};
    single.devices = resp.devices;
    single.tensor_sizes = {resp.tensor_sizes[i]};
    single.reduce_op = resp.reduce_op;
    single.prescale_factor = resp.prescale_factor;
    single.postscale_factor = resp.postscale_factor;
    single.tensor_shapes = {shape};

    Request params;
    params.request_type = RequestType::ALLREDUCE;
    params.tensor_type = resp.tensor_type;
    params.tensor_name = name;
    params.device = resp.devices.empty() ? "cpu" : resp.devices[0];
    params.reduce_op = resp.reduce_op;
    params.prescale_factor = resp.prescale_factor;
    params.postscale_factor = resp.postscale_factor;
    params.tensor_shape = std::move(shape);
    PutOne(name, std::move(single), std::move(params));
  }
}

void ResponseCache::PutOne(const std::string& name, Response resp,
                           Request params) {
  auto it = by_name_.find(name);
  if (it != by_name_.end()) {
    // In-place update keeps the position stable (shape changes re-cache
    // under the same position).
    it->second.response = std::move(resp);
    it->second.params = std::move(params);
    lru_.splice(lru_.end(), lru_, it->second.lru_it);
    return;
  }
  if (static_cast<int64_t>(by_name_.size()) >= capacity_) {
    const std::string victim = lru_.front();
    lru_.pop_front();
    auto vit = by_name_.find(victim);
    if (vit != by_name_.end()) {
      free_positions_.push_back(vit->second.position);
      by_pos_.erase(vit->second.position);
      by_name_.erase(vit);
    }
    ++evictions;
  }
  uint32_t pos;
  if (!free_positions_.empty()) {
    pos = free_positions_.front();
    free_positions_.erase(free_positions_.begin());
  } else {
    pos = next_position_++;
  }
  Entry e;
  e.name = name;
  e.position = pos;
  e.response = std::move(resp);
  e.params = std::move(params);
  e.lru_it = lru_.insert(lru_.end(), name);
  auto [nit, _] = by_name_.emplace(name, std::move(e));
  by_pos_[pos] = &nit->second;
}

// ---------------------------------------------------------------------------
// Engine lifecycle
// ---------------------------------------------------------------------------

Engine::Engine(const EngineConfig& cfg, std::vector<int> data_fds,
               std::vector<int> ctrl_fds)
    : cfg_(cfg), data_fds_(std::move(data_fds)), ctrl_fds_(std::move(ctrl_fds)) {
  for (int fd : data_fds_)
    if (fd >= 0) SetNoDelay(fd);
  for (int fd : ctrl_fds_)
    if (fd >= 0) SetNoDelay(fd);
  last_stall_check_s_ = NowS();
  cache_.SetCapacity(cfg.cache_capacity);
  if (cfg.rank == 0 && !cfg.timeline_path.empty())
    timeline_.Initialize(cfg.timeline_path, cfg.timeline_mark_cycles);
  if (cfg.autotune && cfg.rank == 0) {
    auto opts = cfg.autotune_opts;
    if (!HierarchicalTopologyOk()) {
      // A hierarchy knob is meaningless on a flat topology — tuning it
      // would waste GP samples on a no-op dimension.
      opts.tune_hier_allreduce = false;
      opts.tune_hier_allgather = false;
    }
    pm_ = std::make_unique<ParameterManager>(
        TunedParams{cfg.fusion_threshold, cfg.cycle_time_s,
                    cfg.cache_capacity > 0, cfg.hierarchical_allreduce,
                    cfg.hierarchical_allgather, cfg.ring_segment_bytes},
        opts);
  }
  bg_ = std::thread([this] { BackgroundLoop(); });
}

Engine::~Engine() { Shutdown(); }

void Engine::Shutdown() {
  bool expected = false;
  if (!shutdown_requested_.compare_exchange_strong(expected, true)) {
    if (bg_.joinable()) bg_.join();
    return;
  }
  // Negotiated shutdown (parity: controller.cc:116-130 — the shutdown
  // flag rides RequestList/ResponseList): the loop tells the
  // coordinator, whose next ResponseList stops every rank in the same
  // cycle, so no rank reads a socket its peer already closed.  Bounded:
  // if negotiation can't complete (peer already gone), force the local
  // loop down after the deadline.
  double deadline = NowS() + 10.0;
  while (!loop_exited_.load() && NowS() < deadline)
    std::this_thread::sleep_for(std::chrono::milliseconds(2));
  shutdown_.store(true);
  if (bg_.joinable()) bg_.join();
  timeline_.Shutdown();
  for (int fd : data_fds_)
    if (fd >= 0) ::close(fd);
  for (int fd : ctrl_fds_)
    if (fd >= 0) ::close(fd);
}

// ---------------------------------------------------------------------------
// Enqueue side (caller threads)
// ---------------------------------------------------------------------------

bool Engine::ClaimName(const std::string& name, std::string* err) {
  if (pending_names_.count(name)) {
    *err = "Requested a collective on a tensor with the same name as "
           "another tensor that is currently being processed: " +
           name;
    return false;
  }
  pending_names_.insert(name);
  return true;
}

void Engine::ReleaseName(const std::string& name) {
  std::lock_guard<std::mutex> lk(queue_mu_);
  pending_names_.erase(name);
}

int64_t Engine::Enqueue(TensorTableEntry entry, std::string* err) {
  std::lock_guard<std::mutex> lk(queue_mu_);
  if (aborted_.load() || shutdown_.load() || shutdown_requested_.load()) {
    *err = "horovod_tpu_torch runtime has been shut down";
    return -1;
  }
  if (!ClaimName(entry.name, err)) return -1;
  entry.enqueue_s = NowS();
  int64_t h = entry.handle;
  request_queue_.push_back(entry.request);
  table_.emplace(entry.name, std::move(entry));
  return h;
}

int64_t Engine::EnqueueAllreduce(const std::string& name, void* buf,
                                 const TensorShape& shape, DataType dt,
                                 ReduceOp op, double prescale,
                                 double postscale, std::string* err,
                                 int32_t ps_id, int32_t ps_size) {
  TensorTableEntry e;
  e.name = name;
  e.data = static_cast<uint8_t*>(buf);
  e.nelems = shape.num_elements();
  e.handle = handles_.Allocate();
  e.request.request_rank = cfg_.rank;
  e.request.request_type = RequestType::ALLREDUCE;
  e.request.tensor_type = dt;
  e.request.tensor_name = name;
  e.request.tensor_shape = shape;
  e.request.reduce_op = op;
  e.request.prescale_factor = prescale;
  e.request.postscale_factor = postscale;
  e.request.process_set_id = ps_id;
  e.request.process_set_size = ps_size;
  return Enqueue(std::move(e), err);
}

int64_t Engine::EnqueueAllgather(const std::string& name, const void* buf,
                                 const TensorShape& shape, DataType dt,
                                 std::string* err, int32_t ps_id,
                                 int32_t ps_size) {
  TensorTableEntry e;
  e.name = name;
  e.data = static_cast<uint8_t*>(const_cast<void*>(buf));
  e.nelems = shape.num_elements();
  e.handle = handles_.Allocate();
  e.request.request_rank = cfg_.rank;
  e.request.request_type = RequestType::ALLGATHER;
  e.request.tensor_type = dt;
  e.request.tensor_name = name;
  e.request.tensor_shape = shape;
  e.request.process_set_id = ps_id;
  e.request.process_set_size = ps_size;
  return Enqueue(std::move(e), err);
}

int64_t Engine::EnqueueBroadcast(const std::string& name, void* buf,
                                 const TensorShape& shape, DataType dt,
                                 int root_rank, std::string* err,
                                 int32_t ps_id, int32_t ps_size) {
  if (root_rank < 0 || root_rank >= cfg_.size) {
    *err = "broadcast root rank " + std::to_string(root_rank) +
           " out of range [0, " + std::to_string(cfg_.size) + ")";
    return -1;
  }
  TensorTableEntry e;
  e.name = name;
  e.data = static_cast<uint8_t*>(buf);
  e.nelems = shape.num_elements();
  e.handle = handles_.Allocate();
  e.request.request_rank = cfg_.rank;
  e.request.request_type = RequestType::BROADCAST;
  e.request.tensor_type = dt;
  e.request.tensor_name = name;
  e.request.tensor_shape = shape;
  e.request.root_rank = root_rank;
  e.request.process_set_id = ps_id;
  e.request.process_set_size = ps_size;
  return Enqueue(std::move(e), err);
}

int64_t Engine::EnqueueAlltoall(const std::string& name, const void* buf,
                                const TensorShape& shape, DataType dt,
                                const std::vector<int64_t>& splits,
                                std::string* err, int32_t ps_id,
                                int32_t ps_size) {
  int n = ps_id ? ps_size : cfg_.size;
  if (n <= 0) {
    *err = "alltoall: invalid process_set_size " + std::to_string(ps_size);
    return -1;
  }
  if (!splits.empty()) {
    if (static_cast<int>(splits.size()) != n) {
      *err = "alltoall needs one split per participant (" +
             std::to_string(n) + ")";
      return -1;
    }
    int64_t total = 0;
    for (auto s : splits) total += s;
    if (shape.dims.empty() || total != shape.dims[0]) {
      *err = "splits must sum to dim 0";
      return -1;
    }
  } else if (!shape.dims.empty() && shape.dims[0] % n != 0) {
    *err = "alltoall without splits requires dim 0 divisible by the "
           "participant count";
    return -1;
  }
  TensorTableEntry e;
  e.name = name;
  e.data = static_cast<uint8_t*>(const_cast<void*>(buf));
  e.nelems = shape.num_elements();
  e.handle = handles_.Allocate();
  e.splits = splits;
  e.request.request_rank = cfg_.rank;
  e.request.request_type = RequestType::ALLTOALL;
  e.request.tensor_type = dt;
  e.request.tensor_name = name;
  e.request.tensor_shape = shape;
  e.request.process_set_id = ps_id;
  e.request.process_set_size = ps_size;
  return Enqueue(std::move(e), err);
}

void Engine::RegisterProcessSet(int32_t id, std::vector<int> ranks) {
  std::lock_guard<std::mutex> lk(process_sets_mu_);
  process_sets_[id] = std::move(ranks);
}

std::vector<int> Engine::ProcessSetRanks(int32_t id) {
  std::lock_guard<std::mutex> lk(process_sets_mu_);
  auto it = process_sets_.find(id);
  return it != process_sets_.end() ? it->second : std::vector<int>{};
}

std::pair<std::vector<int>, int> Engine::ResponseGroup(
    const Response& resp) {
  std::vector<int> group;
  int me = cfg_.rank;
  if (resp.process_set_id) {
    group = ProcessSetRanks(resp.process_set_id);
    me = static_cast<int>(
        std::find(group.begin(), group.end(), cfg_.rank) - group.begin());
  } else {
    for (int r = 0; r < cfg_.size; ++r) group.push_back(r);
  }
  return {std::move(group), me};
}

int64_t Engine::EnqueueReduceScatter(const std::string& name,
                                     const void* buf,
                                     const TensorShape& shape, DataType dt,
                                     ReduceOp op, std::string* err,
                                     int32_t ps_id, int32_t ps_size) {
  if (shape.dims.empty()) {
    *err = "reducescatter needs at least one dimension to scatter over "
           "(got a scalar)";
    return -1;
  }
  TensorTableEntry e;
  e.name = name;
  e.data = static_cast<uint8_t*>(const_cast<void*>(buf));
  e.nelems = shape.num_elements();
  e.handle = handles_.Allocate();
  e.request.request_rank = cfg_.rank;
  e.request.request_type = RequestType::REDUCESCATTER;
  e.request.tensor_type = dt;
  e.request.tensor_name = name;
  e.request.tensor_shape = shape;
  e.request.reduce_op = op;
  e.request.process_set_id = ps_id;
  e.request.process_set_size = ps_size;
  return Enqueue(std::move(e), err);
}

int Engine::Barrier(std::string* err, int32_t ps_id, int32_t ps_size) {
  TensorTableEntry e;
  int64_t c;
  if (ps_id == 0) {
    c = barrier_counter_.fetch_add(1);
    e.name = "__barrier." + std::to_string(c);
  } else {
    // Per-set counters; distinct name families keep a concurrent
    // global barrier from colliding in the duplicate-name guard.
    std::lock_guard<std::mutex> lk(process_sets_mu_);
    c = ps_barrier_counters_[ps_id]++;
    e.name = "__barrier.ps" + std::to_string(ps_id) + "." +
             std::to_string(c);
  }
  static int32_t zero = 0;
  e.data = reinterpret_cast<uint8_t*>(&zero);
  e.nelems = 1;
  e.handle = handles_.Allocate();
  e.request.request_rank = cfg_.rank;
  e.request.request_type = RequestType::BARRIER;
  e.request.tensor_name = e.name;
  e.request.tensor_type = DataType::INT32;
  e.request.process_set_id = ps_id;
  e.request.process_set_size = ps_size;
  int64_t h = Enqueue(std::move(e), err);
  if (h < 0) return -1;
  StatusType st = handles_.Wait(h);
  if (st != StatusType::OK && err) {
    HandleState* hs = handles_.Get(h);
    *err = (hs && !hs->status.reason.empty())
               ? hs->status.reason
               : "barrier failed (status " +
                     std::to_string(static_cast<int>(st)) + ")";
  }
  handles_.Release(h);
  return st == StatusType::OK ? 0 : -1;
}

void Engine::CacheStats(int64_t out[5]) {
  std::lock_guard<std::mutex> lk(cache_mu_);
  out[0] = cache_.hits;
  out[1] = cache_.misses;
  out[2] = cache_.evictions;
  out[3] = cache_.size();
  out[4] = cache_.capacity();
}

int Engine::Join() {
  int64_t h = handles_.Allocate();
  {
    std::lock_guard<std::mutex> lk(queue_mu_);
    joined_ = true;
    join_handle_ = h;
    Request req;
    req.request_rank = cfg_.rank;
    req.request_type = RequestType::JOIN;
    req.tensor_name = "__join__";
    request_queue_.push_back(req);
  }
  handles_.Wait(h);
  handles_.Release(h);
  return last_joined_rank_.load();
}

// ---------------------------------------------------------------------------
// Background loop
// ---------------------------------------------------------------------------

void Engine::BackgroundLoop() {
  try {
    while (!shutdown_.load()) {
      double t0 = NowS();
      timeline_.MarkCycleStart();
      if (!RunLoopOnce()) break;
      double dt = NowS() - t0;
      if (dt < cfg_.cycle_time_s) {
        auto us = static_cast<int64_t>((cfg_.cycle_time_s - dt) * 1e6);
        std::this_thread::sleep_for(std::chrono::microseconds(us));
      }
    }
  } catch (const std::exception& e) {
    // A peer closing its socket during an agreed teardown is part of
    // shutting down, not a failure worth alarming about.
    if (!shutdown_requested_.load() && !shutdown_.load())
      std::fprintf(stderr, "[hvd-core %d] background loop failed: %s\n",
                   cfg_.rank, e.what());
    Abort(e.what());
  }
  DrainOnShutdown();
  loop_exited_.store(true);
}

void Engine::DrainOnShutdown() {
  std::vector<TensorTableEntry> entries;
  int64_t jh;
  {
    std::lock_guard<std::mutex> lk(queue_mu_);
    for (auto& kv : table_) entries.push_back(std::move(kv.second));
    table_.clear();
    request_queue_.clear();
    jh = join_handle_;
    join_handle_ = -1;
  }
  for (auto& e : entries) {
    ReleaseName(e.name);
    if (e.handle >= 0)
      handles_.MarkDone(e.handle,
                        Status::Aborted("Horovod has been shut down."));
  }
  if (jh >= 0) handles_.MarkDone(jh, Status::OK());
}

bool Engine::RunLoopOnce() {
  std::vector<Request> msgs;
  {
    std::lock_guard<std::mutex> lk(queue_mu_);
    msgs.swap(request_queue_);
  }
  if (cfg_.rank == 0) return CoordinatorCycle(std::move(msgs));
  return WorkerCycle(std::move(msgs));
}

void Engine::ClassifyRequests(std::vector<Request> msgs,
                              std::vector<Request>* requests,
                              std::vector<CacheHit>* hit_events) {
  // Parity: the cache check at the top of ComputeResponseList
  // (controller.cc:171-200), adapted to explicit hit events.
  std::lock_guard<std::mutex> lk(cache_mu_);
  for (auto& req : msgs) {
    auto rit = resend_uncached_.find(req.tensor_name);
    if (rit != resend_uncached_.end()) {
      resend_uncached_.erase(rit);
      requests->push_back(std::move(req));
      continue;
    }
    uint32_t pos = 0;
    if (cache_classify_enabled_ &&
        cache_.Classify(req, &pos) == ResponseCache::HIT)
      hit_events->push_back({req.tensor_name, pos});
    else
      requests->push_back(std::move(req));
  }
}

void Engine::ApplyParams(const WireParams& p) {
  cfg_.fusion_threshold = p.fusion_threshold;
  cfg_.cycle_time_s = p.cycle_time_s;
  cfg_.hierarchical_allreduce = p.hierarchical_allreduce;
  cfg_.hierarchical_allgather = p.hierarchical_allgather;
  cfg_.ring_segment_bytes = p.ring_segment_bytes;
  std::lock_guard<std::mutex> lk(cache_mu_);
  cache_classify_enabled_ = p.cache_enabled;
}

void Engine::ExecuteCachedHits(const std::vector<uint32_t>& hit_positions) {
  if (hit_positions.empty()) return;
  std::vector<Response> cached;
  {
    std::lock_guard<std::mutex> lk(cache_mu_);
    for (auto p : hit_positions) {
      const Response* resp = cache_.GetByPosition(p);
      if (resp == nullptr) {
        // A missing position means this rank's cache diverged from the
        // coordinator's.  Executing the remaining hits would launch a
        // different collective sequence than the other ranks and hang
        // the whole job — fail fast instead.
        std::fprintf(stderr,
                     "[hvd-core %d] cache coherence violation: position %u "
                     "missing locally, aborting\n",
                     cfg_.rank, p);
        Abort("response cache coherence violation");
        return;
      }
      cache_.Touch(p);
      cached.push_back(*resp);  // copy: FuseResponses mutates its inputs
    }
  }
  for (auto& resp : FuseResponses(std::move(cached)))
    PerformResponse(resp, /*from_cache=*/true);
}

void Engine::ProcessResends(const std::vector<std::string>& resend_names) {
  std::lock_guard<std::mutex> lk(queue_mu_);
  std::lock_guard<std::mutex> clk(cache_mu_);
  for (auto& nm : resend_names) {
    auto it = table_.find(nm);
    if (it != table_.end()) {
      resend_uncached_.insert(nm);
      request_queue_.push_back(it->second.request);
    }
  }
}

bool Engine::WorkerCycle(std::vector<Request> msgs) {
  int ctrl = ctrl_fds_[0];
  std::vector<Request> requests;
  std::vector<CacheHit> hit_events;
  ClassifyRequests(std::move(msgs), &requests, &hit_events);
  bool want_shutdown = shutdown_requested_.load();
  bool send_failed = false;
  if (!requests.empty() || !hit_events.empty() || want_shutdown) {
    auto payload = EncodeRequestList(requests, want_shutdown, hit_events);
    try {
      SendFrame(ctrl, kTagRequestList, payload.data(), payload.size());
    } catch (const SocketError&) {
      // The coordinator may have closed right after broadcasting a
      // shutdown ResponseList; that frame can still be buffered on our
      // side — fall through to the drain, which exits gracefully on
      // it.  Only if no shutdown was in flight is this a real failure.
      send_failed = true;
    }
  }
  while (Readable(ctrl, 0)) {
    std::vector<uint8_t> payload;
    uint8_t tag = RecvFrame(ctrl, &payload);
    if (tag != kTagResponseList)
      throw SocketError("worker expected response list, got tag " +
                        std::to_string(tag));
    std::vector<Response> responses;
    std::vector<uint32_t> hit_positions;
    std::vector<std::string> resend;
    WireParams params;
    bool shutdown = false;
    if (!DecodeResponseList(payload.data(), payload.size(), &responses,
                            &shutdown, &hit_positions, &resend, &params))
      throw SocketError("malformed response list");
    // Apply BEFORE executing this frame's hits: the fusion threshold
    // shapes the fused launches, which must match on every rank.
    if (params.present) ApplyParams(params);
    ProcessResends(resend);
    ExecuteCachedHits(hit_positions);
    for (auto& resp : responses) PerformResponse(resp);
    if (shutdown) {
      shutdown_.store(true);
      return false;
    }
  }
  if (send_failed)  // no shutdown was in flight: genuine lost peer
    throw SocketError("lost connection to coordinator");
  return true;
}

void Engine::AbsorbRequest(const Request& req,
                           std::vector<std::string>* ready) {
  if (req.request_type == RequestType::JOIN) {
    joined_ranks_.insert(req.request_rank);
    last_joined_rank_.store(req.request_rank);
    // Tensors waiting only on joined ranks become ready (global-set
    // entries only; join never applies to process-set traffic).
    for (auto& kv : msg_table_) {
      if (!kv.second.requests.empty() &&
          kv.second.requests[0].process_set_id == 0 &&
          static_cast<int>(kv.second.requests.size()) ==
              cfg_.size - static_cast<int>(joined_ranks_.size())) {
        if (std::find(ready->begin(), ready->end(), kv.first) == ready->end())
          ready->push_back(kv.first);
      }
    }
    return;
  }
  // Table key: process-set requests are scoped by set id, so the same
  // tensor name may be in flight in two different sets at once.
  std::string key =
      req.process_set_id
          ? req.tensor_name + "@ps" + std::to_string(req.process_set_id)
          : req.tensor_name;
  auto& ent = msg_table_[key];
  if (timeline_.enabled()) {
    // Start on the FIRST request for this key — a process set may not
    // contain rank 0, and an End without a Start corrupts the trace.
    if (ent.requests.empty())
      timeline_.NegotiateStart(req.tensor_name, OpName(req.request_type));
    timeline_.NegotiateRankReady(req.tensor_name, req.request_rank);
  }
  if (ent.requests.empty()) ent.first_seen_s = NowS();
  ent.requests.push_back(req);
  // Process-set request: ready when every member is in (join is
  // global-set-only); global: all non-joined ranks.
  int full_at = req.process_set_id
                    ? req.process_set_size
                    : cfg_.size - static_cast<int>(joined_ranks_.size());
  if (static_cast<int>(ent.requests.size()) == full_at)
    ready->push_back(key);
}

bool Engine::CoordinatorCycle(std::vector<Request> msgs) {
  std::vector<std::string> ready;
  bool shutdown = shutdown_requested_.load();
  std::map<int, std::vector<std::string>> resend_by_rank;

  auto absorb_hit = [&](const std::string& name, uint32_t pos, int rank) {
    // A hit event stands for the full Request; rebuild it from our own
    // (coherent) cache and let it ride the ordinary message table.  If
    // our entry was evicted in flight, ask the sender to resend.
    std::lock_guard<std::mutex> lk(cache_mu_);
    const std::string* ent_name = cache_.NameAt(pos);
    Request req;
    if (ent_name == nullptr || *ent_name != name ||
        !cache_.SynthesizeRequest(pos, rank, &req)) {
      resend_by_rank[rank].push_back(name);
      return;
    }
    hit_ranks_[name].insert(rank);
    AbsorbRequest(req, &ready);
  };

  std::vector<Request> requests;
  std::vector<CacheHit> own_hits;
  ClassifyRequests(std::move(msgs), &requests, &own_hits);
  for (auto& req : requests) AbsorbRequest(req, &ready);
  for (auto& h : own_hits) absorb_hit(h.name, h.position, 0);
  for (int r = 1; r < cfg_.size; ++r) {
    int fd = ctrl_fds_[r];
    while (Readable(fd, 0)) {
      std::vector<uint8_t> payload;
      uint8_t tag = RecvFrame(fd, &payload);
      if (tag != kTagRequestList)
        throw SocketError("coordinator expected request list, got tag " +
                          std::to_string(tag));
      std::vector<Request> reqs;
      std::vector<CacheHit> peer_hits;
      bool peer_shutdown = false;
      if (!DecodeRequestList(payload.data(), payload.size(), &reqs,
                             &peer_shutdown, &peer_hits))
        throw SocketError("malformed request list");
      shutdown = shutdown || peer_shutdown;
      for (auto& req : reqs) AbsorbRequest(req, &ready);
      for (auto& h : peer_hits) absorb_hit(h.name, h.position, r);
    }
  }

  std::vector<Response> responses;
  std::vector<uint32_t> hit_positions;
  for (auto& key : ready) {
    auto it = msg_table_.find(key);
    if (it == msg_table_.end()) continue;
    auto reqs = std::move(it->second.requests);
    msg_table_.erase(it);
    const std::string& name = reqs[0].tensor_name;  // key may be scoped
    timeline_.NegotiateEnd(name);
    // Hits are global-set-only (key == name there); looking up by key
    // keeps a set-scoped completion from stealing a same-named global
    // tensor's hit record.
    std::set<int> hit_ranks;
    auto hit = hit_ranks_.find(key);
    if (hit != hit_ranks_.end()) {
      hit_ranks = std::move(hit->second);
      hit_ranks_.erase(hit);
    }
    bool all_hit = true;
    for (auto& r : reqs)
      if (!hit_ranks.count(r.request_rank)) {
        all_hit = false;
        break;
      }
    int64_t pos = -1;
    if (all_hit) {
      std::lock_guard<std::mutex> lk(cache_mu_);
      pos = cache_.PositionOf(name);
    }
    if (pos >= 0) {
      // Every contributor hit → all requests were synthesized from the
      // same cache entry → the negotiated response IS the cached one;
      // broadcast just the position.
      hit_positions.push_back(static_cast<uint32_t>(pos));
    } else {
      responses.push_back(ConstructResponse(name, reqs));
    }
  }

  if (static_cast<int>(joined_ranks_.size()) == cfg_.size) {
    Response join_resp;
    join_resp.response_type = ResponseType::JOIN;
    join_resp.tensor_sizes = {last_joined_rank_.load()};
    responses.push_back(join_resp);
    joined_ranks_.clear();
  }

  if (!cfg_.stall_check_disable) shutdown = CheckStalls() || shutdown;

  if (!responses.empty() || !hit_positions.empty() || !resend_by_rank.empty() ||
      have_pending_params_ || shutdown) {
    auto fused = FuseResponses(std::move(responses));
    WireParams wp;
    if (have_pending_params_) {
      wp.present = true;
      wp.fusion_threshold = pending_params_.fusion_threshold;
      wp.cycle_time_s = pending_params_.cycle_time_s;
      wp.cache_enabled = pending_params_.cache_enabled;
      wp.hierarchical_allreduce = pending_params_.hierarchical_allreduce;
      wp.hierarchical_allgather = pending_params_.hierarchical_allgather;
      wp.ring_segment_bytes = pending_params_.ring_segment_bytes;
      have_pending_params_ = false;
    }
    std::vector<uint8_t> shared;
    for (int r = 1; r < cfg_.size; ++r) {
      auto rit = resend_by_rank.find(r);
      if (rit != resend_by_rank.end()) {
        auto payload = EncodeResponseList(fused, shutdown, hit_positions,
                                          rit->second, wp);
        SendFrame(ctrl_fds_[r], kTagResponseList, payload.data(),
                  payload.size());
      } else {
        if (shared.empty())
          shared = EncodeResponseList(fused, shutdown, hit_positions, {}, wp);
        SendFrame(ctrl_fds_[r], kTagResponseList, shared.data(),
                  shared.size());
      }
    }
    // Same ordering contract as the workers: apply before fusing or
    // executing this frame's cached hits.
    if (wp.present) ApplyParams(wp);
    ExecuteCachedHits(hit_positions);
    for (auto& resp : fused) PerformResponse(resp);
    if (pm_ && !pm_->done()) {
      int64_t nbytes = 0;
      for (auto& r : fused)
        if (r.response_type == ResponseType::ALLREDUCE)
          for (auto s : r.tensor_sizes)
            nbytes += s * static_cast<int64_t>(ItemSize(r.tensor_type));
      {
        std::lock_guard<std::mutex> lk(cache_mu_);
        for (auto p : hit_positions) {
          const Response* c = cache_.GetByPosition(p);
          if (c)
            nbytes += c->tensor_sizes[0] *
                      static_cast<int64_t>(ItemSize(c->tensor_type));
        }
      }
      TunedParams next;
      if (pm_->RecordBytes(nbytes, NowS(), &next)) {
        pending_params_ = next;
        have_pending_params_ = true;
      }
    }
    if (shutdown) {
      shutdown_.store(true);
      return false;
    }
  }
  return true;
}

bool Engine::CheckStalls() {
  double now = NowS();
  if (now - last_stall_check_s_ < cfg_.stall_warn_s / 4) return false;
  last_stall_check_s_ = now;
  bool shutdown = false;
  for (auto& kv : msg_table_) {
    double waited = now - kv.second.first_seen_s;
    if (waited > cfg_.stall_warn_s) {
      std::string have;
      for (auto& r : kv.second.requests)
        have += std::to_string(r.request_rank) + " ";
      std::fprintf(stderr,
                   "[hvd-core 0] Stalled tensor %s: ready on ranks [ %s] "
                   "for %.0fs\n",
                   kv.first.c_str(), have.c_str(), waited);
      if (cfg_.stall_shutdown_s > 0 && waited > cfg_.stall_shutdown_s) {
        std::fprintf(stderr,
                     "[hvd-core 0] Stalled tensor %s exceeded shutdown "
                     "threshold; shutting down\n",
                     kv.first.c_str());
        shutdown = true;
      }
    }
  }
  return shutdown;
}

// ---------------------------------------------------------------------------
// Response construction + fusion (coordinator)
// ---------------------------------------------------------------------------

Response Engine::ConstructResponse(const std::string& name,
                                   const std::vector<Request>& reqs) {
  const Request& first = reqs[0];
  std::string err;
  auto mismatch = [&](auto pred) {
    for (auto& r : reqs)
      if (pred(r)) return true;
    return false;
  };

  if (mismatch([&](const Request& r) {
        return r.request_type != first.request_type;
      })) {
    err = "Mismatched collective operations for tensor " + name;
  } else if (mismatch([&](const Request& r) {
               return r.process_set_id != first.process_set_id ||
                      r.process_set_size != first.process_set_size;
             })) {
    err = "Mismatched process sets for tensor " + name;
  } else if (first.process_set_id &&
             first.request_type == RequestType::JOIN) {
    err = std::string(OpName(first.request_type)) +
          " does not support process sets (tensor " + name + ")";
  } else if (first.process_set_id &&
             first.request_type == RequestType::ALLREDUCE &&
             first.reduce_op == ReduceOp::ADASUM) {
    err = "Adasum is not supported with process sets (tensor " + name + ")";
  } else if (mismatch([&](const Request& r) {
               return r.tensor_type != first.tensor_type;
             })) {
    err = "Mismatched data types for tensor " + name + ": ";
    std::set<std::string> types;
    for (auto& r : reqs) types.insert(DtypeName(r.tensor_type));
    bool firstt = true;
    for (auto& t : types) {
      if (!firstt) err += ", ";
      err += t;
      firstt = false;
    }
  } else if (first.request_type == RequestType::ALLREDUCE) {
    if (mismatch([&](const Request& r) {
          return r.tensor_shape != first.tensor_shape;
        })) {
      err = "Mismatched allreduce tensor shapes for " + name;
    } else if (mismatch([&](const Request& r) {
                 return r.reduce_op != first.reduce_op;
               })) {
      err = "Mismatched reduce ops for tensor " + name;
    }
  } else if (first.request_type == RequestType::BROADCAST) {
    if (mismatch([&](const Request& r) {
          return r.root_rank != first.root_rank;
        })) {
      err = "Mismatched broadcast root ranks for " + name;
    } else if (mismatch([&](const Request& r) {
                 return r.tensor_shape != first.tensor_shape;
               })) {
      err = "Mismatched broadcast tensor shapes for " + name;
    } else if (first.process_set_id) {
      auto members = ProcessSetRanks(first.process_set_id);
      if (!members.empty() &&
          std::find(members.begin(), members.end(), first.root_rank) ==
              members.end()) {
        // Authoritative check (wrappers pre-check too): a non-member
        // root would skip while members block in RecvFrame.
        err = "broadcast root rank " + std::to_string(first.root_rank) +
              " is not a member of process set " +
              std::to_string(first.process_set_id) + " (tensor " + name +
              ")";
      }
    }
  } else if (first.request_type == RequestType::ALLGATHER) {
    for (auto& r : reqs) {
      if (r.tensor_shape.dims.size() != first.tensor_shape.dims.size() ||
          !std::equal(r.tensor_shape.dims.begin() + 1,
                      r.tensor_shape.dims.end(),
                      first.tensor_shape.dims.begin() + 1)) {
        err = "Mismatched allgather tensor shapes for " + name +
              ": all dimensions except the first must match";
        break;
      }
    }
  } else if (first.request_type == RequestType::REDUCESCATTER) {
    if (mismatch([&](const Request& r) {
          return r.tensor_shape != first.tensor_shape;
        })) {
      err = "Mismatched reducescatter tensor shapes for " + name;
    } else if (mismatch([&](const Request& r) {
                 return r.reduce_op != first.reduce_op;
               })) {
      err = "Mismatched reduce ops for tensor " + name;
    } else if (first.reduce_op == ReduceOp::ADASUM) {
      err = "Adasum is not defined for reducescatter (tensor " + name + ")";
    }
  }

  if (!err.empty()) {
    Response r;
    r.response_type = ResponseType::ERROR;
    r.tensor_names = {name};
    r.error_message = err;
    return r;
  }

  Response resp;
  resp.response_type = static_cast<ResponseType>(first.request_type);
  resp.tensor_names = {name};
  resp.tensor_type = first.tensor_type;
  resp.devices = {first.device};
  resp.process_set_id = first.process_set_id;
  if (first.request_type == RequestType::ALLREDUCE) {
    resp.tensor_sizes = {first.tensor_shape.num_elements()};
    resp.reduce_op = first.reduce_op;
    resp.prescale_factor = first.prescale_factor;
    resp.postscale_factor = first.postscale_factor;
    // Negotiated dims ride the response so cache parameters stay
    // coherent on every rank (incl. joined ranks' stand-ins).
    resp.tensor_shapes = {first.tensor_shape};
  } else if (first.request_type == RequestType::ALLGATHER) {
    // First-dim size per rank, rank order (0 for joined ranks); for a
    // process set, per member in member order.
    std::map<int, const Request*> by_rank;
    for (auto& r : reqs) by_rank[r.request_rank] = &r;
    std::vector<int> order;
    if (first.process_set_id) {
      auto members = ProcessSetRanks(first.process_set_id);
      if (members.empty()) {
        Response er;
        er.response_type = ResponseType::ERROR;
        er.tensor_names = {name};
        er.error_message =
            "process set " + std::to_string(first.process_set_id) +
            " is not registered on the coordinator (construct the "
            "ProcessSet on every rank)";
        return er;
      }
      order = members;
    } else {
      for (int r = 0; r < cfg_.size; ++r) order.push_back(r);
    }
    for (int r : order) {
      auto it = by_rank.find(r);
      resp.tensor_sizes.push_back(
          it != by_rank.end() ? it->second->tensor_shape.dims[0] : 0);
    }
  } else if (first.request_type == RequestType::BROADCAST) {
    resp.tensor_sizes = {first.root_rank};
  } else if (first.request_type == RequestType::REDUCESCATTER) {
    resp.tensor_sizes = {first.tensor_shape.num_elements()};
    resp.reduce_op = first.reduce_op;
    resp.tensor_shapes = {first.tensor_shape};
  }
  return resp;
}

std::vector<Response> Engine::FuseResponses(std::vector<Response> responses) {
  std::vector<Response> out;
  Response pending;
  bool have_pending = false;
  int64_t pending_bytes = 0;
  for (auto& r : responses) {
    bool fusable = r.response_type == ResponseType::ALLREDUCE &&
                   r.error_message.empty();
    if (!fusable) {
      if (have_pending) {
        out.push_back(std::move(pending));
        have_pending = false;
      }
      out.push_back(std::move(r));
      continue;
    }
    int64_t nbytes = 0;
    for (auto s : r.tensor_sizes) nbytes += s;
    nbytes *= static_cast<int64_t>(ItemSize(r.tensor_type));
    if (have_pending && pending.tensor_type == r.tensor_type &&
        pending.devices == r.devices && pending.reduce_op == r.reduce_op &&
        pending.prescale_factor == r.prescale_factor &&
        pending.postscale_factor == r.postscale_factor &&
        pending.process_set_id == r.process_set_id &&
        pending_bytes + nbytes <= cfg_.fusion_threshold) {
      pending.tensor_names.insert(pending.tensor_names.end(),
                                  r.tensor_names.begin(),
                                  r.tensor_names.end());
      pending.tensor_sizes.insert(pending.tensor_sizes.end(),
                                  r.tensor_sizes.begin(),
                                  r.tensor_sizes.end());
      pending.tensor_shapes.insert(pending.tensor_shapes.end(),
                                   r.tensor_shapes.begin(),
                                   r.tensor_shapes.end());
      pending_bytes += nbytes;
    } else {
      if (have_pending) out.push_back(std::move(pending));
      pending = std::move(r);
      have_pending = true;
      pending_bytes = nbytes;
    }
  }
  if (have_pending) out.push_back(std::move(pending));
  return out;
}

// ---------------------------------------------------------------------------
// Execution
// ---------------------------------------------------------------------------

std::vector<TensorTableEntry> Engine::GetEntries(const Response& resp) {
  // Parity: GetTensorEntriesFromResponse (tensor_queue.cc:72-117) — a
  // joined rank gets zero stand-ins.
  std::vector<TensorTableEntry> entries;
  std::lock_guard<std::mutex> lk(queue_mu_);
  for (size_t i = 0; i < resp.tensor_names.size(); ++i) {
    const auto& nm = resp.tensor_names[i];
    auto it = table_.find(nm);
    if (it != table_.end()) {
      entries.push_back(std::move(it->second));
      table_.erase(it);
    } else {
      TensorTableEntry e;
      e.name = nm;
      e.handle = -1;
      e.request.request_rank = cfg_.rank;
      e.request.tensor_type = resp.tensor_type;
      if (resp.response_type == ResponseType::ALLREDUCE) {
        int64_t n = resp.tensor_sizes[i];
        e.standin.assign(n * ItemSize(resp.tensor_type), 0);
        e.data = e.standin.data();
        e.nelems = n;
        e.request.tensor_shape.dims = {n};
      } else if (resp.response_type == ResponseType::REDUCESCATTER) {
        // Needs the negotiated shape — the scatter splits over dim 0,
        // so a flat stand-in would desync the ring chunk boundaries.
        const TensorShape& s = resp.tensor_shapes[i];
        int64_t n = s.num_elements();
        e.standin.assign(n * ItemSize(resp.tensor_type), 0);
        e.data = e.standin.data();
        e.nelems = n;
        e.request.tensor_shape = s;
      } else {
        e.nelems = 0;
        e.request.tensor_shape.dims = {0};
      }
      entries.push_back(std::move(e));
    }
  }
  return entries;
}

void Engine::PerformResponse(const Response& resp, bool from_cache) {
  if (resp.response_type == ResponseType::JOIN) {
    if (!resp.tensor_sizes.empty())
      last_joined_rank_.store(static_cast<int>(resp.tensor_sizes[0]));
    int64_t jh;
    {
      std::lock_guard<std::mutex> lk(queue_mu_);
      jh = join_handle_;
      join_handle_ = -1;
      joined_ = false;
    }
    if (jh >= 0) handles_.MarkDone(jh, Status::OK());
    return;
  }

  if (resp.response_type == ResponseType::ERROR) {
    for (const auto& nm : resp.tensor_names) {
      TensorTableEntry e;
      bool found = false;
      {
        std::lock_guard<std::mutex> lk(queue_mu_);
        auto it = table_.find(nm);
        if (it != table_.end()) {
          e = std::move(it->second);
          table_.erase(it);
          found = true;
        }
      }
      if (found) {
        ReleaseName(e.name);
        if (e.handle >= 0)
          handles_.MarkDone(e.handle,
                            Status::PreconditionError(resp.error_message));
      }
    }
    return;
  }

  if (resp.process_set_id && resp.response_type != ResponseType::ERROR) {
    // Process-set responses reach every rank in the response stream;
    // non-members simply skip (members always have the entries — join
    // is global-set-only, so no stand-ins here).
    auto members = ProcessSetRanks(resp.process_set_id);
    if (std::find(members.begin(), members.end(), cfg_.rank) ==
        members.end())
      return;
  }

  if (!from_cache && resp.response_type == ResponseType::ALLREDUCE) {
    // Populate the response cache BEFORE execution and regardless of
    // execution outcome: the put stores metadata only, and doing it
    // unconditionally in response-stream order is what keeps every
    // rank's cache (positions, LRU, evictions) coherent.
    std::lock_guard<std::mutex> lk(cache_mu_);
    cache_.Put(resp);
  }

  auto entries = GetEntries(resp);
  if (timeline_.enabled() && !resp.tensor_names.empty())
    timeline_.Start(resp.tensor_names[0],
                    OpName(static_cast<RequestType>(resp.response_type)));
  Status status = Status::OK();
  try {
    switch (resp.response_type) {
      case ResponseType::ALLREDUCE:
        DoAllreduce(entries, resp);
        break;
      case ResponseType::ALLGATHER:
        DoAllgather(entries, resp);
        break;
      case ResponseType::BROADCAST:
        DoBroadcast(entries, resp);
        break;
      case ResponseType::ALLTOALL:
        DoAlltoall(entries, resp);
        break;
      case ResponseType::REDUCESCATTER:
        DoReduceScatter(entries, resp);
        break;
      case ResponseType::BARRIER:
        DoBarrier(resp);
        for (auto& e : entries) {
          ReleaseName(e.name);
          if (e.handle >= 0) handles_.MarkDone(e.handle, Status::OK());
        }
        if (timeline_.enabled() && !resp.tensor_names.empty())
          timeline_.End(resp.tensor_names[0]);
        return;
      default:
        throw std::runtime_error("bad response type");
    }
  } catch (const std::exception& ex) {
    std::fprintf(stderr, "[hvd-core %d] collective %s failed: %s\n",
                 cfg_.rank, OpName(static_cast<RequestType>(resp.response_type)),
                 ex.what());
    status = Status::UnknownError(ex.what());
    for (auto& e : entries) {
      ReleaseName(e.name);
      if (e.handle >= 0) handles_.MarkDone(e.handle, status);
    }
    // Data-plane failure leaves sockets in an undefined protocol state.
    Abort(ex.what());
  }
  if (timeline_.enabled() && !resp.tensor_names.empty())
    timeline_.End(resp.tensor_names[0]);
}

void Engine::DoAllreduce(std::vector<TensorTableEntry>& entries,
                         const Response& resp) {
  DataType dt = resp.tensor_type;
  size_t isz = ItemSize(dt);
  // Op and scales come from the negotiated response — identical on every
  // rank, including joined ranks whose entries are zero stand-ins.
  ReduceOp op = resp.reduce_op;
  double prescale = resp.prescale_factor;
  double postscale = resp.postscale_factor;

  int64_t total = 0;
  for (auto& e : entries) total += e.nelems;

  uint8_t* flat;
  bool fused = entries.size() > 1;
  if (fused) {
    // Parity: MemcpyInFusionBuffer — one lazily grown persistent buffer.
    if (fusion_buffer_.size() < static_cast<size_t>(total) * isz)
      fusion_buffer_.resize(total * isz);
    flat = fusion_buffer_.data();
    int64_t off = 0;
    for (auto& e : entries) {
      std::memcpy(flat + off * isz, e.data, e.nelems * isz);
      off += e.nelems;
    }
  } else {
    flat = entries[0].data;  // in-place, zero copy
  }

  if (prescale != 1.0) ScaleInPlace(flat, total, dt, prescale);

  // Group = the full world, or the process set's members (subgroup
  // rings reuse the full mesh sockets; Adasum/hierarchical are
  // rejected for sets at negotiation).
  auto [group, me] = ResponseGroup(resp);

  if (op == ReduceOp::ADASUM) {
    AdasumFlat(flat, total, dt);
  } else if (!resp.process_set_id && cfg_.hierarchical_allreduce &&
             HierarchicalTopologyOk()) {
    HierarchicalAllreduceFlat(flat, total, dt, op);
  } else {
    RingAllreduceGroup(flat, total, dt, op, group, me);
  }

  if (op == ReduceOp::AVERAGE)
    AverageInPlace(flat, total, dt,
                   static_cast<int64_t>(group.size()));
  if (postscale != 1.0) ScaleInPlace(flat, total, dt, postscale);

  if (fused) {
    int64_t off = 0;
    for (auto& e : entries) {
      std::memcpy(e.data, flat + off * isz, e.nelems * isz);
      off += e.nelems;
    }
  }
  for (auto& e : entries) {
    ReleaseName(e.name);
    if (e.handle >= 0) handles_.MarkDone(e.handle, Status::OK());
  }
}

void Engine::RingAllreduceFlat(uint8_t* buf, int64_t nelems, DataType dt,
                               ReduceOp op) {
  // Parity: cpu_backend.ring_allreduce_flat — ring reduce-scatter +
  // ring allgather, chunk boundaries and combine order identical so the
  // two engines are bit-identical (they can share one job).
  std::vector<int> group(cfg_.size);
  for (int i = 0; i < cfg_.size; ++i) group[i] = i;
  RingAllreduceGroup(buf, nelems, dt, op, group, cfg_.rank);
}

void Engine::RingAllreduceGroup(uint8_t* buf, int64_t nelems, DataType dt,
                                ReduceOp op, const std::vector<int>& group,
                                int me) {
  int size = static_cast<int>(group.size());
  if (size == 1) return;
  size_t isz = ItemSize(dt);
  int right = data_fds_[group[Mod(me + 1, size)]];
  int left = data_fds_[group[Mod(me - 1, size)]];
  auto bounds = ChunkBounds(nelems, size);
  std::vector<uint8_t> tmp;

  // Phase 1: ring reduce-scatter.
  for (int step = 0; step < size - 1; ++step) {
    int64_t send_idx = Mod(me - step, size);
    int64_t recv_idx = Mod(me - step - 1, size);
    int64_t send_n = bounds[send_idx + 1] - bounds[send_idx];
    int64_t recv_n = bounds[recv_idx + 1] - bounds[recv_idx];
    tmp.resize(recv_n * isz);
    ExchangeInto(right, buf + bounds[send_idx] * isz, send_n * isz, left,
                 tmp.data(), recv_n * isz);
    CombineInto(buf + bounds[recv_idx] * isz, tmp.data(), recv_n, dt, op);
  }

  // Phase 2: ring allgather of the reduced chunks.
  for (int step = 0; step < size - 1; ++step) {
    int64_t send_idx = Mod(me + 1 - step, size);
    int64_t recv_idx = Mod(me - step, size);
    int64_t send_n = bounds[send_idx + 1] - bounds[send_idx];
    int64_t recv_n = bounds[recv_idx + 1] - bounds[recv_idx];
    ExchangeInto(right, buf + bounds[send_idx] * isz, send_n * isz, left,
                 buf + bounds[recv_idx] * isz, recv_n * isz);
  }
}

bool Engine::HierarchicalTopologyOk() const {
  // Requires the launcher's homogeneous block rank layout
  // (rank = cross_rank*local_size + local_rank) and a true two-level
  // shape.
  return cfg_.local_size > 1 && cfg_.cross_size > 1 &&
         cfg_.local_size * cfg_.cross_size == cfg_.size &&
         cfg_.rank == cfg_.cross_rank * cfg_.local_size + cfg_.local_rank;
}

std::vector<int> Engine::LocalGroup() const {
  std::vector<int> g(cfg_.local_size);
  for (int i = 0; i < cfg_.local_size; ++i)
    g[i] = cfg_.cross_rank * cfg_.local_size + i;
  return g;
}

std::vector<int> Engine::CrossGroup() const {
  std::vector<int> g(cfg_.cross_size);
  for (int k = 0; k < cfg_.cross_size; ++k)
    g[k] = k * cfg_.local_size + cfg_.local_rank;
  return g;
}

void Engine::HierarchicalAllreduceFlat(uint8_t* buf, int64_t nelems,
                                       DataType dt, ReduceOp op) {
  // Two-level TPU mapping of NCCLHierarchicalAllreduce
  // (nccl_operations.cc:163-363): reduce-scatter on the node-local ring,
  // allreduce the owned 1/local_size slice on the cross-node ring, then
  // allgather on the local ring — only 1/local_size of the bytes crosses
  // the slow fabric.  Chunk walk identical to cpu_backend so the two
  // engines stay bit-compatible in a mixed job.
  int L = cfg_.local_size;
  int li = cfg_.local_rank;
  size_t isz = ItemSize(dt);
  auto local = LocalGroup();
  int right = data_fds_[local[Mod(li + 1, L)]];
  int left = data_fds_[local[Mod(li - 1, L)]];
  auto bounds = ChunkBounds(nelems, L);
  std::vector<uint8_t> tmp;

  // Phase 1: local ring reduce-scatter.
  for (int step = 0; step < L - 1; ++step) {
    int64_t send_idx = Mod(li - step, L);
    int64_t recv_idx = Mod(li - step - 1, L);
    int64_t send_n = bounds[send_idx + 1] - bounds[send_idx];
    int64_t recv_n = bounds[recv_idx + 1] - bounds[recv_idx];
    tmp.resize(recv_n * isz);
    ExchangeInto(right, buf + bounds[send_idx] * isz, send_n * isz, left,
                 tmp.data(), recv_n * isz);
    CombineInto(buf + bounds[recv_idx] * isz, tmp.data(), recv_n, dt, op);
  }

  // Phase 2: cross-node ring allreduce of the fully-reduced owned chunk.
  int64_t own = Mod(li + 1, L);
  int64_t own_n = bounds[own + 1] - bounds[own];
  if (own_n > 0)
    RingAllreduceGroup(buf + bounds[own] * isz, own_n, dt, op, CrossGroup(),
                       cfg_.cross_rank);

  // Phase 3: local ring allgather.
  for (int step = 0; step < L - 1; ++step) {
    int64_t send_idx = Mod(li + 1 - step, L);
    int64_t recv_idx = Mod(li - step, L);
    int64_t send_n = bounds[send_idx + 1] - bounds[send_idx];
    int64_t recv_n = bounds[recv_idx + 1] - bounds[recv_idx];
    ExchangeInto(right, buf + bounds[send_idx] * isz, send_n * isz, left,
                 buf + bounds[recv_idx] * isz, recv_n * isz);
  }
}

void Engine::AdasumFlat(uint8_t* buf, int64_t nelems, DataType dt) {
  // Parity: cpu_backend._adasum_flat — recursive distance-doubling partner
  // exchange, fp64 accumulation, power-of-two world sizes.
  int size = cfg_.size, rank = cfg_.rank;
  if (size == 1) return;
  if (size & (size - 1))
    throw std::runtime_error("Adasum requires a power-of-two world size");
  std::vector<double> acc(nelems), other(nelems);
  ToF64(buf, acc.data(), nelems, dt);
  for (int k = 1; k < size; k *= 2) {
    int partner = rank ^ k;
    int fd = data_fds_[partner];
    ExchangeInto(fd, acc.data(), nelems * 8, fd, other.data(), nelems * 8);
    if (rank < partner) {
      AdasumPairF64(acc.data(), other.data(), acc.data(), nelems);
    } else {
      AdasumPairF64(other.data(), acc.data(), acc.data(), nelems);
    }
  }
  FromF64(acc.data(), buf, nelems, dt);
}

void Engine::DoAllgather(std::vector<TensorTableEntry>& entries,
                         const Response& resp) {
  if (!resp.process_set_id && cfg_.hierarchical_allgather &&
      HierarchicalTopologyOk()) {
    DoAllgatherHierarchical(entries, resp);
    return;
  }
  // Ragged ring allgatherv (parity: cpu_backend.allgather; displacement
  // logic parity: MPIAllgather, mpi_operations.cc:83-166).  For a
  // process set the ring walks the member list.
  auto [group, me] = ResponseGroup(resp);
  int size = static_cast<int>(group.size()), rank = me;
  for (auto& e : entries) {
    size_t isz = ItemSize(resp.tensor_type);
    struct Block {
      const uint8_t* ptr = nullptr;
      size_t len = 0;
      std::vector<uint8_t> own;
    };
    std::vector<Block> blocks(size);
    blocks[rank].ptr = e.data;
    blocks[rank].len = e.nelems * isz;
    if (size > 1) {
      int right = data_fds_[group[Mod(rank + 1, size)]];
      int left = data_fds_[group[Mod(rank - 1, size)]];
      for (int step = 0; step < size - 1; ++step) {
        int64_t send_idx = Mod(rank - step, size);
        int64_t recv_idx = Mod(rank - step - 1, size);
        std::vector<uint8_t> incoming;
        Exchange(right, blocks[send_idx].ptr, blocks[send_idx].len, left,
                 &incoming);
        blocks[recv_idx].own = std::move(incoming);
        blocks[recv_idx].ptr = blocks[recv_idx].own.data();
        blocks[recv_idx].len = blocks[recv_idx].own.size();
      }
    }
    size_t total = 0;
    for (auto& b : blocks) total += b.len;
    std::vector<uint8_t> result(total);
    size_t off = 0;
    for (auto& b : blocks) {
      if (b.len) std::memcpy(result.data() + off, b.ptr, b.len);
      off += b.len;
    }
    ReleaseName(e.name);
    if (e.handle >= 0)
      handles_.MarkDone(e.handle, Status::OK(), std::move(result));
  }
}

void Engine::DoAllgatherHierarchical(std::vector<TensorTableEntry>& entries,
                                     const Response& resp) {
  // Two-level allgatherv (role parity: MPIHierarchicalAllgather,
  // mpi_operations.cc:168-309 — there via a node-shared MPI window;
  // here via the node-local ring + a leaders-only cross ring):
  //   1. ragged ring allgatherv within the node → node block,
  //   2. local leaders exchange node blocks on the cross ring,
  //   3. leaders fan the full buffer out to their node (MultiSend).
  // Output ordering matches the flat path because the launcher's block
  // rank layout makes node blocks contiguous in global rank order.
  int L = cfg_.local_size, li = cfg_.local_rank, C = cfg_.cross_size;
  auto local = LocalGroup();
  for (auto& e : entries) {
    // Phase 1: node-local ragged ring allgatherv.
    struct Block {
      const uint8_t* ptr = nullptr;
      size_t len = 0;
      std::vector<uint8_t> own;
    };
    std::vector<Block> blocks(L);
    blocks[li].ptr = e.data;
    blocks[li].len = e.nelems * ItemSize(resp.tensor_type);
    int right = data_fds_[local[Mod(li + 1, L)]];
    int left = data_fds_[local[Mod(li - 1, L)]];
    for (int step = 0; step < L - 1; ++step) {
      int64_t send_idx = Mod(li - step, L);
      int64_t recv_idx = Mod(li - step - 1, L);
      std::vector<uint8_t> incoming;
      Exchange(right, blocks[send_idx].ptr, blocks[send_idx].len, left,
               &incoming);
      blocks[recv_idx].own = std::move(incoming);
      blocks[recv_idx].ptr = blocks[recv_idx].own.data();
      blocks[recv_idx].len = blocks[recv_idx].own.size();
    }
    size_t node_bytes = 0;
    for (auto& b : blocks) node_bytes += b.len;
    std::vector<uint8_t> node_block(node_bytes);
    size_t off = 0;
    for (auto& b : blocks) {
      if (b.len) std::memcpy(node_block.data() + off, b.ptr, b.len);
      off += b.len;
    }

    std::vector<uint8_t> result;
    if (li == 0) {
      // Phase 2: leaders' ragged ring allgatherv of node blocks.
      std::vector<Block> nblocks(C);
      int me = cfg_.cross_rank;
      nblocks[me].ptr = node_block.data();
      nblocks[me].len = node_block.size();
      if (C > 1) {
        int nright = data_fds_[Mod(me + 1, C) * L];
        int nleft = data_fds_[Mod(me - 1, C) * L];
        for (int step = 0; step < C - 1; ++step) {
          int64_t send_idx = Mod(me - step, C);
          int64_t recv_idx = Mod(me - step - 1, C);
          std::vector<uint8_t> incoming;
          Exchange(nright, nblocks[send_idx].ptr, nblocks[send_idx].len,
                   nleft, &incoming);
          nblocks[recv_idx].own = std::move(incoming);
          nblocks[recv_idx].ptr = nblocks[recv_idx].own.data();
          nblocks[recv_idx].len = nblocks[recv_idx].own.size();
        }
      }
      size_t total = 0;
      for (auto& b : nblocks) total += b.len;
      result.resize(total);
      off = 0;
      for (auto& b : nblocks) {
        if (b.len) std::memcpy(result.data() + off, b.ptr, b.len);
        off += b.len;
      }
      // Phase 3: fan out to the rest of the node.
      std::vector<int> others;
      for (int i = 1; i < L; ++i) others.push_back(data_fds_[local[i]]);
      MultiSend(others, result.data(), result.size());
    } else {
      uint8_t tag = RecvFrame(data_fds_[local[0]], &result);
      if (tag != kTagData)
        throw std::runtime_error("hierarchical allgather: bad frame tag");
    }
    ReleaseName(e.name);
    if (e.handle >= 0)
      handles_.MarkDone(e.handle, Status::OK(), std::move(result));
  }
}

void Engine::DoBroadcast(std::vector<TensorTableEntry>& entries,
                         const Response& resp) {
  int rank = cfg_.rank;
  // root is a GLOBAL rank; for a process set the fan-out covers the
  // member list only.
  auto [group, me_unused] = ResponseGroup(resp);
  (void)me_unused;
  int size = static_cast<int>(group.size());
  for (auto& e : entries) {
    int root = resp.tensor_sizes.empty()
                   ? e.request.root_rank
                   : static_cast<int>(resp.tensor_sizes[0]);
    size_t nbytes = e.nelems * ItemSize(resp.tensor_type);
    if (size > 1) {
      if (rank == root) {
        std::vector<int> others;
        for (int r : group)
          if (r != root) others.push_back(data_fds_[r]);
        MultiSend(others, e.data, nbytes);
      } else {
        std::vector<uint8_t> payload;
        uint8_t tag = RecvFrame(data_fds_[root], &payload);
        if (tag != kTagData)
          throw SocketError("broadcast expected data frame");
        // A joined stand-in has no caller buffer; the payload is dropped.
        if (e.data && e.nelems)
          std::memcpy(e.data, payload.data(),
                      std::min(payload.size(), nbytes));
      }
    }
    ReleaseName(e.name);
    if (e.handle >= 0) handles_.MarkDone(e.handle, Status::OK());
  }
}

void Engine::DoAlltoall(std::vector<TensorTableEntry>& entries,
                        const Response& resp) {
  // Pairwise exchange rounds (parity: cpu_backend.alltoall); for a
  // process set, partners walk the member list.
  auto [group, me] = ResponseGroup(resp);
  int size = static_cast<int>(group.size()), rank = me;
  for (auto& e : entries) {
    size_t isz = ItemSize(resp.tensor_type);
    int64_t dim0 = e.request.tensor_shape.dims.empty()
                       ? 0
                       : e.request.tensor_shape.dims[0];
    int64_t row_elems = dim0 > 0 ? e.nelems / dim0 : 0;
    size_t row_bytes = row_elems * isz;
    std::vector<int64_t> splits = e.splits;
    if (splits.empty()) {
      int64_t per = size > 0 ? dim0 / size : 0;
      splits.assign(size, per);
    }
    std::vector<int64_t> offs{0};
    for (auto s : splits) offs.push_back(offs.back() + s);

    std::vector<std::vector<uint8_t>> recv_blocks(size);
    std::vector<int64_t> recv_rows(size, 0);
    recv_blocks[rank].assign(
        e.data + offs[rank] * row_bytes,
        e.data + offs[rank + 1] * row_bytes);
    recv_rows[rank] = splits[rank];
    for (int step = 1; step < size; ++step) {
      int dst = Mod(rank + step, size);
      int src = Mod(rank - step, size);
      std::vector<uint8_t> incoming;
      Exchange(data_fds_[group[dst]], e.data + offs[dst] * row_bytes,
               splits[dst] * row_bytes, data_fds_[group[src]], &incoming);
      recv_rows[src] =
          row_bytes ? static_cast<int64_t>(incoming.size() / row_bytes) : 0;
      recv_blocks[src] = std::move(incoming);
    }
    size_t total = 0;
    for (auto& b : recv_blocks) total += b.size();
    std::vector<uint8_t> result(total);
    size_t off = 0;
    for (auto& b : recv_blocks) {
      if (!b.empty()) std::memcpy(result.data() + off, b.data(), b.size());
      off += b.size();
    }
    ReleaseName(e.name);
    if (e.handle >= 0)
      handles_.MarkDone(e.handle, Status::OK(), std::move(result),
                        std::move(recv_rows));
  }
}

void Engine::DoReduceScatter(std::vector<TensorTableEntry>& entries,
                             const Response& resp) {
  // Ring reduce-scatter over dim-0 row chunks (parity:
  // cpu_backend.reducescatter — identical walk, so mixed native/py jobs
  // stay bit-compatible).  The standard walk leaves rank r owning chunk
  // (r+1)%size; shifting the start by one virtual rank leaves it owning
  // chunk r, which is the API contract.
  auto [group, me] = ResponseGroup(resp);
  int size = static_cast<int>(group.size()), rank = me;
  DataType dt = resp.tensor_type;
  size_t isz = ItemSize(dt);
  ReduceOp op = resp.reduce_op;
  for (auto& e : entries) {
    const TensorShape& shape = e.request.tensor_shape;
    int64_t d0 = shape.dims[0];
    int64_t row_elems = d0 > 0 ? e.nelems / d0 : 0;
    auto row_bounds = ChunkBounds(d0, size);
    if (size == 1) {
      std::vector<uint8_t> result(e.data, e.data + e.nelems * isz);
      ReleaseName(e.name);
      if (e.handle >= 0)
        handles_.MarkDone(e.handle, Status::OK(), std::move(result));
      continue;
    }
    // Working copies of each row chunk (the caller's input buffer is
    // not mutated; the owned chunk becomes the handle result).
    std::vector<std::vector<uint8_t>> chunks(size);
    for (int i = 0; i < size; ++i) {
      int64_t lo = row_bounds[i] * row_elems;
      int64_t hi = row_bounds[i + 1] * row_elems;
      chunks[i].assign(e.data + lo * isz, e.data + hi * isz);
    }
    int right = data_fds_[group[Mod(rank + 1, size)]];
    int left = data_fds_[group[Mod(rank - 1, size)]];
    std::vector<uint8_t> tmp;
    for (int step = 0; step < size - 1; ++step) {
      int64_t send_idx = Mod(rank - 1 - step, size);
      int64_t recv_idx = Mod(rank - 2 - step, size);
      tmp.resize(chunks[recv_idx].size());
      ExchangeInto(right, chunks[send_idx].data(), chunks[send_idx].size(),
                   left, tmp.data(), tmp.size());
      CombineInto(chunks[recv_idx].data(), tmp.data(),
                  static_cast<int64_t>(chunks[recv_idx].size() / isz), dt,
                  op);
    }
    std::vector<uint8_t> result = std::move(chunks[rank]);
    if (op == ReduceOp::AVERAGE)
      AverageInPlace(result.data(),
                     static_cast<int64_t>(result.size() / isz), dt,
                     static_cast<int64_t>(size));
    ReleaseName(e.name);
    if (e.handle >= 0)
      handles_.MarkDone(e.handle, Status::OK(), std::move(result));
  }
}

void Engine::DoBarrier(const Response& resp) {
  int32_t zero = 0;
  auto [group, me] = ResponseGroup(resp);
  RingAllreduceGroup(reinterpret_cast<uint8_t*>(&zero), 1,
                     DataType::INT32, ReduceOp::SUM, group, me);
}

void Engine::Abort(const std::string& reason) {
  (void)reason;
  aborted_.store(true);
  shutdown_.store(true);
}

}  // namespace hvd
