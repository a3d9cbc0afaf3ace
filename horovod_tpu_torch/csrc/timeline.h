// Chrome-tracing timeline profiler for the native engine.
//
// Role parity: horovod/common/timeline.cc/.h — rank 0 writes a
// chrome://tracing JSON stream of per-tensor phases: NEGOTIATE_<OP>
// (with per-rank ready ticks), the top-level op, and CYCLE_START marks.
// The reference drains a boost lock-free SPSC queue on a writer thread;
// event rates here are controller-cycle rates (kHz at most), so a
// mutex+condvar deque on a writer thread gives the same non-blocking
// hot path.  File format matches horovod_tpu_torch/utils/timeline.py, the
// Python twin.
#pragma once

#include <chrono>
#include <condition_variable>
#include <cstdio>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>

namespace hvd {

class Timeline {
 public:
  ~Timeline();

  void Initialize(const std::string& path, bool mark_cycles);
  bool enabled() const { return enabled_; }

  void NegotiateStart(const std::string& tensor, const char* op_name);
  void NegotiateRankReady(const std::string& tensor, int rank);
  void NegotiateEnd(const std::string& tensor);
  void Start(const std::string& tensor, const char* op_name);
  void End(const std::string& tensor);
  void MarkCycleStart();
  void Shutdown();

 private:
  void Emit(char ph, const std::string& name, const std::string& tensor);
  int Tid(const std::string& tensor, std::string* meta = nullptr);
  void WriterLoop();

  bool enabled_ = false;
  bool mark_cycles_ = false;
  FILE* f_ = nullptr;
  std::chrono::steady_clock::time_point start_;
  std::unordered_map<std::string, int> tensor_tids_;

  std::mutex mu_;
  std::condition_variable cv_;
  std::deque<std::string> queue_;
  bool stop_ = false;
  std::thread writer_;
};

}  // namespace hvd
