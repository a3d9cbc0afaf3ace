#include "timeline.h"

#include <algorithm>
#include <cinttypes>

namespace hvd {

Timeline::~Timeline() { Shutdown(); }

void Timeline::Initialize(const std::string& path, bool mark_cycles) {
  if (enabled_ || path.empty()) return;
  f_ = std::fopen(path.c_str(), "w");
  if (!f_) return;
  std::fprintf(f_, "[\n");
  start_ = std::chrono::steady_clock::now();
  mark_cycles_ = mark_cycles;
  enabled_ = true;
  writer_ = std::thread([this] { WriterLoop(); });
}

void Timeline::Shutdown() {
  if (!enabled_) return;
  {
    std::lock_guard<std::mutex> lk(mu_);
    stop_ = true;
  }
  cv_.notify_all();
  if (writer_.joinable()) writer_.join();
  std::fclose(f_);
  f_ = nullptr;
  enabled_ = false;
}

// Tensor names are user-controlled (arbitrary Python strings); anything
// interpolated into the trace must be escaped or the JSON breaks.
static std::string JsonEscape(const std::string& s) {
  std::string out;
  out.reserve(s.size() + 8);
  for (char c : s) {
    switch (c) {
      case '"': out += "\\\""; break;
      case '\\': out += "\\\\"; break;
      case '\n': out += "\\n"; break;
      case '\r': out += "\\r"; break;
      case '\t': out += "\\t"; break;
      default:
        if (static_cast<unsigned char>(c) < 0x20) {
          char u[8];
          std::snprintf(u, sizeof(u), "\\u%04x", c);
          out += u;
        } else {
          out += c;
        }
    }
  }
  return out;
}

int Timeline::Tid(const std::string& tensor, std::string* meta) {
  if (tensor.empty()) return 0;
  auto it = tensor_tids_.find(tensor);
  if (it != tensor_tids_.end()) return it->second;
  int tid = static_cast<int>(tensor_tids_.size()) + 1;
  tensor_tids_[tensor] = tid;
  // First sighting: name the lane after the tensor (chrome-tracing
  // thread_name metadata), like the reference's per-tensor timeline rows.
  if (meta != nullptr) {
    char buf[512];
    int n = std::snprintf(buf, sizeof(buf),
                          "{\"ph\": \"M\", \"pid\": 0, \"tid\": %d, "
                          "\"name\": \"thread_name\", \"args\": "
                          "{\"name\": \"%s\"}},\n",
                          tid, JsonEscape(tensor).c_str());
    if (n > 0 && static_cast<size_t>(n) < sizeof(buf))
      meta->assign(buf, static_cast<size_t>(n));
  }
  return tid;
}

void Timeline::Emit(char ph, const std::string& name,
                    const std::string& tensor) {
  if (!enabled_) return;
  auto us = std::chrono::duration_cast<std::chrono::nanoseconds>(
                std::chrono::steady_clock::now() - start_)
                .count() /
            1e3;
  std::string meta;
  int tid = Tid(tensor, &meta);
  char buf[512];
  int n;
  if (name.empty()) {
    n = std::snprintf(buf, sizeof(buf),
                      "{\"ph\": \"%c\", \"ts\": %.3f, \"pid\": 0, "
                      "\"tid\": %d},\n",
                      ph, us, tid);
  } else {
    n = std::snprintf(buf, sizeof(buf),
                      "{\"ph\": \"%c\", \"ts\": %.3f, \"pid\": 0, "
                      "\"tid\": %d, \"name\": \"%s\"},\n",
                      ph, us, tid, JsonEscape(name).c_str());
  }
  // snprintf returns the would-have-been length on truncation; a
  // truncated record would be malformed JSON, so drop it instead.
  if (n <= 0 || static_cast<size_t>(n) >= sizeof(buf)) return;
  {
    std::lock_guard<std::mutex> lk(mu_);
    if (!meta.empty()) queue_.emplace_back(std::move(meta));
    queue_.emplace_back(buf, static_cast<size_t>(n));
  }
  cv_.notify_one();
}

void Timeline::NegotiateStart(const std::string& tensor,
                              const char* op_name) {
  Emit('B', std::string("NEGOTIATE_") + op_name, tensor);
}

void Timeline::NegotiateRankReady(const std::string& tensor, int rank) {
  Emit('i', "RANK_" + std::to_string(rank) + "_READY", tensor);
}

void Timeline::NegotiateEnd(const std::string& tensor) {
  Emit('E', "", tensor);
}

void Timeline::Start(const std::string& tensor, const char* op_name) {
  Emit('B', op_name, tensor);
}

void Timeline::End(const std::string& tensor) { Emit('E', "", tensor); }

void Timeline::MarkCycleStart() {
  if (mark_cycles_) Emit('i', "CYCLE_START", "");
}

void Timeline::WriterLoop() {
  std::unique_lock<std::mutex> lk(mu_);
  for (;;) {
    cv_.wait(lk, [this] { return stop_ || !queue_.empty(); });
    while (!queue_.empty()) {
      std::string ev = std::move(queue_.front());
      queue_.pop_front();
      lk.unlock();
      std::fwrite(ev.data(), 1, ev.size(), f_);
      std::fflush(f_);
      lk.lock();
    }
    if (stop_) return;
  }
}

}  // namespace hvd
