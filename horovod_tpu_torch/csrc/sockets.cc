#include "sockets.h"

#include <errno.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <string.h>
#include <unistd.h>

#include <cstring>

namespace hvd {
namespace {

constexpr size_t kHeaderLen = 5;  // u8 tag + u32 LE length

void PackHeader(uint8_t* hdr, uint8_t tag, size_t len) {
  if (len > 0xffffffffull)
    throw SocketError(
        "frame payload exceeds the 4 GiB wire limit (" +
        std::to_string(len) +
        " bytes); split the tensor or raise the chunking granularity");
  hdr[0] = tag;
  auto n = static_cast<uint32_t>(len);
  for (int i = 0; i < 4; ++i) hdr[1 + i] = (n >> (8 * i)) & 0xff;
}

void UnpackHeader(const uint8_t* hdr, uint8_t* tag, uint32_t* len) {
  *tag = hdr[0];
  uint32_t n = 0;
  for (int i = 0; i < 4; ++i) n |= uint32_t(hdr[1 + i]) << (8 * i);
  *len = n;
}

[[noreturn]] void ThrowErrno(const char* what) {
  throw SocketError(std::string(what) + ": " + strerror(errno));
}

int GetFlags(int fd) {
  int f = fcntl(fd, F_GETFL, 0);
  if (f < 0) ThrowErrno("fcntl(F_GETFL)");
  return f;
}

class NonBlockGuard {
 public:
  explicit NonBlockGuard(int fd) : fd_(fd), flags_(GetFlags(fd)) {
    if (!(flags_ & O_NONBLOCK)) fcntl(fd_, F_SETFL, flags_ | O_NONBLOCK);
  }
  ~NonBlockGuard() {
    if (!(flags_ & O_NONBLOCK)) fcntl(fd_, F_SETFL, flags_);
  }

 private:
  int fd_;
  int flags_;
};

// One in-flight framed send: header then payload, resumable.
struct SendState {
  uint8_t hdr[kHeaderLen];
  const uint8_t* payload = nullptr;
  size_t payload_len = 0;
  size_t off = 0;  // over hdr+payload

  bool done() const { return off >= kHeaderLen + payload_len; }

  // Returns false on EAGAIN (caller polls), throws on hard error.
  bool Pump(int fd) {
    while (!done()) {
      const uint8_t* src;
      size_t avail;
      if (off < kHeaderLen) {
        src = hdr + off;
        avail = kHeaderLen - off;
      } else {
        src = payload + (off - kHeaderLen);
        avail = payload_len - (off - kHeaderLen);
      }
      ssize_t n = ::send(fd, src, avail, MSG_NOSIGNAL);
      if (n > 0) {
        off += static_cast<size_t>(n);
        continue;
      }
      if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) return false;
      if (n < 0 && errno == EINTR) continue;
      ThrowErrno("send");
    }
    return true;
  }
};

// One in-flight framed receive: header then payload, resumable.
struct RecvState {
  uint8_t hdr[kHeaderLen];
  size_t hdr_off = 0;
  std::vector<uint8_t>* out = nullptr;  // exactly one of out / raw is set
  uint8_t* raw = nullptr;
  size_t raw_cap = 0;
  size_t payload_len = 0;
  size_t payload_off = 0;
  bool have_len = false;
  uint8_t tag = 0;

  bool done() const { return have_len && payload_off >= payload_len; }

  bool Pump(int fd) {
    while (!done()) {
      if (!have_len) {
        ssize_t n = ::recv(fd, hdr + hdr_off, kHeaderLen - hdr_off, 0);
        if (n == 0) throw SocketError("peer closed connection");
        if (n < 0) {
          if (errno == EAGAIN || errno == EWOULDBLOCK) return false;
          if (errno == EINTR) continue;
          ThrowErrno("recv");
        }
        hdr_off += static_cast<size_t>(n);
        if (hdr_off == kHeaderLen) {
          uint32_t len;
          UnpackHeader(hdr, &tag, &len);
          if (tag != kTagData)
            throw SocketError("expected data frame, got tag " +
                              std::to_string(tag));
          payload_len = len;
          have_len = true;
          if (out) {
            out->resize(payload_len);
          } else if (payload_len != raw_cap) {
            throw SocketError("frame length " + std::to_string(payload_len) +
                              " != expected " + std::to_string(raw_cap));
          }
        }
        continue;
      }
      uint8_t* dst = (out ? out->data() : raw) + payload_off;
      ssize_t n = ::recv(fd, dst, payload_len - payload_off, 0);
      if (n == 0) throw SocketError("peer closed connection");
      if (n < 0) {
        if (errno == EAGAIN || errno == EWOULDBLOCK) return false;
        if (errno == EINTR) continue;
        ThrowErrno("recv");
      }
      payload_off += static_cast<size_t>(n);
    }
    return true;
  }
};

void RunExchange(int send_fd, SendState* snd, int recv_fd, RecvState* rcv) {
  bool sending = send_fd >= 0;
  bool receiving = recv_fd >= 0;
  while ((sending && !snd->done()) || (receiving && !rcv->done())) {
    struct pollfd pfds[2];
    int n = 0;
    int send_slot = -1, recv_slot = -1;
    if (sending && !snd->done()) {
      if (receiving && !rcv->done() && recv_fd == send_fd) {
        pfds[n] = {send_fd, POLLOUT | POLLIN, 0};
        send_slot = recv_slot = n++;
      } else {
        pfds[n] = {send_fd, POLLOUT, 0};
        send_slot = n++;
      }
    }
    if (recv_slot < 0 && receiving && !rcv->done()) {
      pfds[n] = {recv_fd, POLLIN, 0};
      recv_slot = n++;
    }
    int rc = ::poll(pfds, n, 60000);
    if (rc < 0) {
      if (errno == EINTR) continue;
      ThrowErrno("poll");
    }
    if (rc == 0) throw SocketError("data-plane exchange timed out (60s)");
    for (int i = 0; i < n; ++i) {
      if (pfds[i].revents & (POLLERR | POLLHUP | POLLNVAL)) {
        // Let the read/write surface the precise error.
      }
    }
    if (send_slot >= 0 &&
        (pfds[send_slot].revents & (POLLOUT | POLLERR | POLLHUP)))
      snd->Pump(send_fd);
    if (recv_slot >= 0 &&
        (pfds[recv_slot].revents & (POLLIN | POLLERR | POLLHUP)))
      rcv->Pump(recv_fd);
  }
}

}  // namespace

void SetNoDelay(int fd) {
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
}

void SendFrame(int fd, uint8_t tag, const void* payload, size_t len) {
  uint8_t hdr[kHeaderLen];
  PackHeader(hdr, tag, len);
  const uint8_t* bufs[2] = {hdr, static_cast<const uint8_t*>(payload)};
  size_t lens[2] = {kHeaderLen, len};
  for (int part = 0; part < 2; ++part) {
    size_t off = 0;
    while (off < lens[part]) {
      ssize_t n = ::send(fd, bufs[part] + off, lens[part] - off, MSG_NOSIGNAL);
      if (n < 0) {
        if (errno == EINTR) continue;
        if (errno == EAGAIN || errno == EWOULDBLOCK) {
          struct pollfd p = {fd, POLLOUT, 0};
          ::poll(&p, 1, 60000);
          continue;
        }
        ThrowErrno("send");
      }
      off += static_cast<size_t>(n);
    }
  }
}

uint8_t RecvFrame(int fd, std::vector<uint8_t>* payload) {
  uint8_t hdr[kHeaderLen];
  size_t off = 0;
  auto read_exact = [&](uint8_t* dst, size_t want) {
    size_t got = 0;
    while (got < want) {
      ssize_t n = ::recv(fd, dst + got, want - got, 0);
      if (n == 0) throw SocketError("peer closed connection");
      if (n < 0) {
        if (errno == EINTR) continue;
        if (errno == EAGAIN || errno == EWOULDBLOCK) {
          struct pollfd p = {fd, POLLIN, 0};
          ::poll(&p, 1, 60000);
          continue;
        }
        ThrowErrno("recv");
      }
      got += static_cast<size_t>(n);
    }
  };
  (void)off;
  read_exact(hdr, kHeaderLen);
  uint8_t tag;
  uint32_t len;
  UnpackHeader(hdr, &tag, &len);
  payload->resize(len);
  if (len) read_exact(payload->data(), len);
  return tag;
}

bool Readable(int fd, int timeout_ms) {
  struct pollfd p = {fd, POLLIN, 0};
  int rc = ::poll(&p, 1, timeout_ms);
  return rc > 0 && (p.revents & (POLLIN | POLLHUP));
}

void Exchange(int send_fd, const void* sbuf, size_t slen, int recv_fd,
              std::vector<uint8_t>* rbuf) {
  SendState snd;
  RecvState rcv;
  PackHeader(snd.hdr, kTagData, slen);
  snd.payload = static_cast<const uint8_t*>(sbuf);
  snd.payload_len = slen;
  rcv.out = rbuf;
  NonBlockGuard g1(send_fd >= 0 ? send_fd : recv_fd);
  if (recv_fd >= 0 && recv_fd != send_fd) {
    NonBlockGuard g2(recv_fd);
    RunExchange(send_fd, &snd, recv_fd, &rcv);
  } else {
    RunExchange(send_fd, &snd, recv_fd, &rcv);
  }
}

void ExchangeInto(int send_fd, const void* sbuf, size_t slen, int recv_fd,
                  void* rbuf, size_t rlen) {
  SendState snd;
  RecvState rcv;
  PackHeader(snd.hdr, kTagData, slen);
  snd.payload = static_cast<const uint8_t*>(sbuf);
  snd.payload_len = slen;
  rcv.raw = static_cast<uint8_t*>(rbuf);
  rcv.raw_cap = rlen;
  NonBlockGuard g1(send_fd >= 0 ? send_fd : recv_fd);
  if (recv_fd >= 0 && recv_fd != send_fd) {
    NonBlockGuard g2(recv_fd);
    RunExchange(send_fd, &snd, recv_fd, &rcv);
  } else {
    RunExchange(send_fd, &snd, recv_fd, &rcv);
  }
}

void MultiSend(const std::vector<int>& fds, const void* buf, size_t len) {
  if (fds.empty()) return;
  std::vector<SendState> states(fds.size());
  std::vector<NonBlockGuard*> guards;
  guards.reserve(fds.size());
  for (size_t i = 0; i < fds.size(); ++i) {
    PackHeader(states[i].hdr, kTagData, len);
    states[i].payload = static_cast<const uint8_t*>(buf);
    states[i].payload_len = len;
    guards.push_back(new NonBlockGuard(fds[i]));
  }
  try {
    for (;;) {
      std::vector<struct pollfd> pfds;
      std::vector<size_t> idx;
      for (size_t i = 0; i < fds.size(); ++i) {
        if (!states[i].done()) {
          pfds.push_back({fds[i], POLLOUT, 0});
          idx.push_back(i);
        }
      }
      if (pfds.empty()) break;
      int rc = ::poll(pfds.data(), pfds.size(), 60000);
      if (rc < 0) {
        if (errno == EINTR) continue;
        ThrowErrno("poll");
      }
      if (rc == 0) throw SocketError("broadcast send timed out (60s)");
      for (size_t k = 0; k < pfds.size(); ++k) {
        if (pfds[k].revents & (POLLOUT | POLLERR | POLLHUP))
          states[idx[k]].Pump(fds[idx[k]]);
      }
    }
  } catch (...) {
    for (auto* g : guards) delete g;
    throw;
  }
  for (auto* g : guards) delete g;
}

}  // namespace hvd
