// Binary wire codec for controller messages.
//
// Role parity: horovod/common/wire/message.fbs + message.cc (the reference
// uses FlatBuffers).  The layout here is the hand-rolled little-endian
// encoding specified in horovod_tpu_torch/common/wire.py — THE TWO MUST MATCH;
// both engines speak this format on the same sockets.
//
// The Python engine additionally defines collective-abort agreement
// payloads (AbortReport / ProbeAck / AbortVerdict, wire.py) carried on
// reserved control tags 6-9 (sockets.h), and the serving admission
// broadcast (ServeDelta, wire.py) on reserved tag 10.  They have no C++
// mirror: the native engine ignores HVD_COLLECTIVE_TIMEOUT and never
// hosts horovod_tpu_torch.serving — both only take effect on PyEngine gangs
// (runtime_py.py).
#pragma once

#include <cstdint>
#include <string>
#include <vector>

#include "types.h"

namespace hvd {

// What one rank wants to do with one named tensor.
// Parity: message.h:47-100 + prescale/postscale from the torch v2 path.
struct Request {
  int32_t request_rank = 0;
  RequestType request_type = RequestType::ALLREDUCE;
  DataType tensor_type = DataType::FLOAT32;
  std::string tensor_name;
  int32_t root_rank = -1;
  std::string device = "cpu";
  TensorShape tensor_shape;
  ReduceOp reduce_op = ReduceOp::SUM;
  double prescale_factor = 1.0;
  double postscale_factor = 1.0;
  // Process-set scoping (0 = the global set); set_size lets the
  // coordinator wait for exactly the members.
  int32_t process_set_id = 0;
  int32_t process_set_size = 0;
};

// What every rank must now execute, in identical order.
// Parity: message.h:132-192.
struct Response {
  ResponseType response_type = ResponseType::ERROR;
  std::vector<std::string> tensor_names;
  std::string error_message;
  std::vector<std::string> devices;
  DataType tensor_type = DataType::FLOAT32;
  std::vector<int64_t> tensor_sizes;
  // Allreduce execution parameters negotiated from the requests; fusion
  // only merges responses where these match.
  ReduceOp reduce_op = ReduceOp::SUM;
  double prescale_factor = 1.0;
  double postscale_factor = 1.0;
  // For allreduce: the exact negotiated dims of each fused tensor, one
  // per tensor_names entry — authoritative on every rank, which keeps
  // response-cache parameters coherent (see engine.h ResponseCache).
  std::vector<TensorShape> tensor_shapes;
  // Process-set scoping: non-members skip the response entirely.
  int32_t process_set_id = 0;
};

// A response-cache hit event: this rank is ready to re-run the cached
// response for `name` at cache position `position` (see
// horovod_tpu_torch/common/response_cache.py for the protocol).
struct CacheHit {
  std::string name;
  uint32_t position = 0;
};

// List frames end with an optional u32 `epoch` trailer — the elastic
// membership epoch (horovod_tpu_torch/elastic; 0 when absent).  The native
// engine only ever runs at epoch 0 (elastic requires the Python engine;
// Engine raises before construction otherwise) but both codecs carry
// the trailer so the layout spec in horovod_tpu_torch/common/wire.py and this
// header stay in lockstep.
std::vector<uint8_t> EncodeRequestList(const std::vector<Request>& reqs,
                                       bool shutdown,
                                       const std::vector<CacheHit>& hits = {},
                                       uint32_t epoch = 0);
// Returns false on malformed input.  `epoch` (optional out) receives
// the trailer, 0 when the frame predates it.
bool DecodeRequestList(const uint8_t* data, size_t len,
                       std::vector<Request>* out, bool* shutdown,
                       std::vector<CacheHit>* hits,
                       uint32_t* epoch = nullptr);

// Autotuner knob broadcast riding the response stream (parity: rank-0
// Params bcast, parameter_manager.cc via controller.cc:33-47).
struct WireParams {
  bool present = false;
  int64_t fusion_threshold = 0;
  double cycle_time_s = 0;
  bool cache_enabled = true;
  bool hierarchical_allreduce = false;
  bool hierarchical_allgather = false;
  int64_t ring_segment_bytes = 0;
};

std::vector<uint8_t> EncodeResponseList(
    const std::vector<Response>& resps, bool shutdown,
    const std::vector<uint32_t>& hit_positions = {},
    const std::vector<std::string>& resend_names = {},
    const WireParams& params = {}, uint32_t epoch = 0);
bool DecodeResponseList(const uint8_t* data, size_t len,
                        std::vector<Response>* out, bool* shutdown,
                        std::vector<uint32_t>* hit_positions,
                        std::vector<std::string>* resend_names,
                        WireParams* params, uint32_t* epoch = nullptr);

// -- recovery-ladder framing (HVD_WIRE_CRC=1; wire.py mirror) ----------
//
// Control tags 11-13 are reserved by the Python engine's data-plane
// recovery ladder (utils/ladder.py): kTagNack = 11 (u32 expected_seq),
// kTagResume = 12 and kTagFailover = 13 (i32 rank, u32 expected_seq,
// u32 epoch).  On a CRC-armed link every kTagData frame additionally
// ends with an 8-byte trailer INSIDE the frame payload:
//
//   DataTrailer := u32 seq, u32 crc
//   crc = CRC-32 (reflected polynomial 0xEDB88320, the zlib/IEEE one)
//         over the payload bytes, then over the 4 LE seq bytes.
//
// The native engine does not implement the ladder yet; it MUST NOT join
// a gang running HVD_WIRE_CRC=1 (the knob is rejected at Engine
// construction, like HVD_COLLECTIVE_TIMEOUT is ignored).  WireCrc32 is
// provided so the future native path validates identically to
// wire.py's data_crc().
constexpr uint8_t kTagNack = 11;
constexpr uint8_t kTagResume = 12;
constexpr uint8_t kTagFailover = 13;
constexpr size_t kDataTrailerBytes = 8;

// Control tags 14-15 are reserved by the Python engine's gang-wide
// tracing clock sync (HVD_TRACE=1; telemetry/trace.py):
// kTagClockPing = 14 (i64 t0_ns, u32 epoch), kTagClockPong = 15
// (i64 t0_ns, i64 t_coord_ns, u32 epoch).  Like the abort tags, these
// frames never reach a native engine — a traced gang must be
// all-Python (docs/timeline.md "Gang-wide tracing").
constexpr uint8_t kTagClockPing = 14;
constexpr uint8_t kTagClockPong = 15;

// Control tags 16-17 are reserved by the Python engine's always-on
// flight recorder (telemetry/blackbox.py): kTagBlackbox = 16 (u32
// epoch; coordinator asks a live worker for its ring) and
// kTagBlackboxDump = 17 (i32 rank, u32 epoch, u32 len, len bytes of
// UTF-8 JSON — the same document blackbox_rank<r>.json would hold).
// Like the abort tags these frames never reach a native engine; the
// coordinator simply gets no dump from one.
constexpr uint8_t kTagBlackbox = 16;
constexpr uint8_t kTagBlackboxDump = 17;

// Control tags 18-21 are reserved by the Python engine's hierarchical
// control tree and epoch fencing (runtime_py.py; docs/fault_tolerance.md
// "Hierarchical control plane, fencing, and quorum"):
// kTagTreeUp = 18 (u32 epoch, u32 n, { i32 rank, u8 tag, u32 len,
// bytes }[n] — a per-host sub-coordinator's aggregate of its children's
// control frames), kTagTreeDown = 19 (i32 target_rank, u8 tag, u32 len,
// bytes — a root frame routed through the sub-coordinator; -1 fans out
// to every child), kTagReparent = 20 (i32 rank, i32 old_parent,
// u32 epoch — an orphaned child adopting itself back to the root), and
// kTagFence = 21 (u32 stale_epoch, u32 current_epoch — typed rejection
// of a stale-epoch sender).  A native engine never joins a tree: a
// multi-host Python gang only builds one among Python ranks, so like
// the abort tags these frames never reach this decoder.
constexpr uint8_t kTagTreeUp = 18;
constexpr uint8_t kTagTreeDown = 19;
constexpr uint8_t kTagReparent = 20;
constexpr uint8_t kTagFence = 21;

// CRC-32 (zlib polynomial), seed 0 — matches Python's zlib.crc32.
uint32_t WireCrc32(const uint8_t* data, size_t len, uint32_t crc = 0);

// crc-over-payload-then-seq, exactly wire.py data_crc().
uint32_t DataCrc(const uint8_t* payload, size_t len, uint32_t seq);

}  // namespace hvd
