// Framed TCP helpers for the controller and CPU data plane.
//
// Frame = u8 tag, u32 LE length, payload — the format defined in
// horovod_tpu_torch/utils/socketutil.py.  The data plane needs full-duplex
// exchange (ring steps send and receive simultaneously); Exchange() runs a
// poll() loop over the two directions so large messages cannot deadlock on
// kernel socket buffers (the Python engine uses a sender thread for the
// same reason, cpu_backend.py:41-46).
#pragma once

#include <cstddef>
#include <cstdint>
#include <stdexcept>
#include <string>
#include <vector>

namespace hvd {

constexpr uint8_t kTagRequestList = 1;
constexpr uint8_t kTagResponseList = 2;
constexpr uint8_t kTagData = 3;
// Tags 4-9 are reserved by the Python engine's control-plane
// extensions (KV tunneling, heartbeats, and the collective-abort
// agreement: abort-report / probe / probe-ack / abort-verdict — see
// horovod_tpu_torch/utils/socketutil.py and common/wire.py).  The native
// engine never sends or expects them; do not reuse the numbers.

struct SocketError : std::runtime_error {
  explicit SocketError(const std::string& what) : std::runtime_error(what) {}
};

// Blocking send of one frame (loops over partial writes / EINTR).
void SendFrame(int fd, uint8_t tag, const void* payload, size_t len);

// Blocking receive of one full frame; returns tag, fills payload.
uint8_t RecvFrame(int fd, std::vector<uint8_t>* payload);

// True if a full read() on fd would not block right now (data available).
bool Readable(int fd, int timeout_ms);

// Full-duplex: send one kTagData frame to send_fd while receiving one
// kTagData frame from recv_fd.  Either fd may be -1 to skip a direction;
// both may be the same fd (pairwise partner exchange).
void Exchange(int send_fd, const void* sbuf, size_t slen, int recv_fd,
              std::vector<uint8_t>* rbuf);

// Like Exchange, but receives directly into a caller buffer of exactly
// rlen bytes; throws if the incoming frame length differs.
void ExchangeInto(int send_fd, const void* sbuf, size_t slen, int recv_fd,
                  void* rbuf, size_t rlen);

// Concurrent send of the same kTagData frame to many peers (broadcast
// root).  Poll-driven round-robin, so no per-peer thread is needed.
void MultiSend(const std::vector<int>& fds, const void* buf, size_t len);

void SetNoDelay(int fd);

}  // namespace hvd
