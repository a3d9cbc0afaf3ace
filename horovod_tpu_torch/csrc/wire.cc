#include "wire.h"

#include <cstring>

namespace hvd {
namespace {

// Little-endian primitive writers.  x86/ARM targets are all LE; we still
// write bytewise so the codec is endian-agnostic.
void PutU8(std::vector<uint8_t>& b, uint8_t v) { b.push_back(v); }

void PutU32(std::vector<uint8_t>& b, uint32_t v) {
  for (int i = 0; i < 4; ++i) b.push_back((v >> (8 * i)) & 0xff);
}

void PutI32(std::vector<uint8_t>& b, int32_t v) {
  PutU32(b, static_cast<uint32_t>(v));
}

void PutI64(std::vector<uint8_t>& b, int64_t v) {
  auto u = static_cast<uint64_t>(v);
  for (int i = 0; i < 8; ++i) b.push_back((u >> (8 * i)) & 0xff);
}

void PutF64(std::vector<uint8_t>& b, double v) {
  uint64_t u;
  std::memcpy(&u, &v, 8);
  for (int i = 0; i < 8; ++i) b.push_back((u >> (8 * i)) & 0xff);
}

void PutStr(std::vector<uint8_t>& b, const std::string& s) {
  PutU32(b, static_cast<uint32_t>(s.size()));
  b.insert(b.end(), s.begin(), s.end());
}

struct Reader {
  const uint8_t* data;
  size_t len;
  size_t off = 0;
  bool fail = false;

  bool Need(size_t n) {
    if (off + n > len) {
      fail = true;
      return false;
    }
    return true;
  }
  uint8_t U8() {
    if (!Need(1)) return 0;
    return data[off++];
  }
  uint32_t U32() {
    if (!Need(4)) return 0;
    uint32_t v = 0;
    for (int i = 0; i < 4; ++i) v |= uint32_t(data[off + i]) << (8 * i);
    off += 4;
    return v;
  }
  int32_t I32() { return static_cast<int32_t>(U32()); }
  int64_t I64() {
    if (!Need(8)) return 0;
    uint64_t v = 0;
    for (int i = 0; i < 8; ++i) v |= uint64_t(data[off + i]) << (8 * i);
    off += 8;
    return static_cast<int64_t>(v);
  }
  double F64() {
    uint64_t u = static_cast<uint64_t>(I64());
    double v;
    std::memcpy(&v, &u, 8);
    return v;
  }
  std::string Str() {
    uint32_t n = U32();
    if (!Need(n)) return "";
    std::string s(reinterpret_cast<const char*>(data + off), n);
    off += n;
    return s;
  }
};

void EncodeRequest(const Request& r, std::vector<uint8_t>& b) {
  PutU8(b, static_cast<uint8_t>(r.request_type));
  PutI32(b, r.request_rank);
  PutU8(b, static_cast<uint8_t>(r.tensor_type));
  PutStr(b, r.tensor_name);
  PutI32(b, r.root_rank);
  PutStr(b, r.device);
  PutU8(b, static_cast<uint8_t>(r.reduce_op));
  PutF64(b, r.prescale_factor);
  PutF64(b, r.postscale_factor);
  PutU8(b, static_cast<uint8_t>(r.tensor_shape.dims.size()));
  for (auto d : r.tensor_shape.dims) PutI64(b, d);
  PutI32(b, r.process_set_id);
  PutI32(b, r.process_set_size);
}

Request DecodeRequest(Reader& rd) {
  Request r;
  r.request_type = static_cast<RequestType>(rd.U8());
  r.request_rank = rd.I32();
  r.tensor_type = static_cast<DataType>(rd.U8());
  r.tensor_name = rd.Str();
  r.root_rank = rd.I32();
  r.device = rd.Str();
  r.reduce_op = static_cast<ReduceOp>(rd.U8());
  r.prescale_factor = rd.F64();
  r.postscale_factor = rd.F64();
  uint8_t ndim = rd.U8();
  for (uint8_t i = 0; i < ndim; ++i) r.tensor_shape.dims.push_back(rd.I64());
  r.process_set_id = rd.I32();
  r.process_set_size = rd.I32();
  return r;
}

void EncodeResponse(const Response& r, std::vector<uint8_t>& b) {
  PutU8(b, static_cast<uint8_t>(r.response_type));
  PutU8(b, static_cast<uint8_t>(r.tensor_type));
  PutU32(b, static_cast<uint32_t>(r.tensor_names.size()));
  for (auto& nm : r.tensor_names) PutStr(b, nm);
  PutStr(b, r.error_message);
  PutU32(b, static_cast<uint32_t>(r.devices.size()));
  for (auto& d : r.devices) PutStr(b, d);
  PutU32(b, static_cast<uint32_t>(r.tensor_sizes.size()));
  for (auto s : r.tensor_sizes) PutI64(b, s);
  PutU8(b, static_cast<uint8_t>(r.reduce_op));
  PutF64(b, r.prescale_factor);
  PutF64(b, r.postscale_factor);
  PutU32(b, static_cast<uint32_t>(r.tensor_shapes.size()));
  for (auto& s : r.tensor_shapes) {
    PutU8(b, static_cast<uint8_t>(s.dims.size()));
    for (auto d : s.dims) PutI64(b, d);
  }
  PutI32(b, r.process_set_id);
}

Response DecodeResponse(Reader& rd) {
  Response r;
  r.response_type = static_cast<ResponseType>(rd.U8());
  r.tensor_type = static_cast<DataType>(rd.U8());
  uint32_t n_names = rd.U32();
  for (uint32_t i = 0; i < n_names && !rd.fail; ++i)
    r.tensor_names.push_back(rd.Str());
  r.error_message = rd.Str();
  uint32_t n_dev = rd.U32();
  for (uint32_t i = 0; i < n_dev && !rd.fail; ++i)
    r.devices.push_back(rd.Str());
  uint32_t n_sizes = rd.U32();
  for (uint32_t i = 0; i < n_sizes && !rd.fail; ++i)
    r.tensor_sizes.push_back(rd.I64());
  r.reduce_op = static_cast<ReduceOp>(rd.U8());
  r.prescale_factor = rd.F64();
  r.postscale_factor = rd.F64();
  uint32_t n_shapes = rd.U32();
  for (uint32_t i = 0; i < n_shapes && !rd.fail; ++i) {
    TensorShape s;
    uint8_t ndim = rd.U8();
    for (uint8_t j = 0; j < ndim; ++j) s.dims.push_back(rd.I64());
    r.tensor_shapes.push_back(std::move(s));
  }
  r.process_set_id = rd.I32();
  return r;
}

}  // namespace

std::vector<uint8_t> EncodeRequestList(const std::vector<Request>& reqs,
                                       bool shutdown,
                                       const std::vector<CacheHit>& hits,
                                       uint32_t epoch) {
  std::vector<uint8_t> b;
  PutU8(b, shutdown ? 1 : 0);
  PutU32(b, static_cast<uint32_t>(reqs.size()));
  for (auto& r : reqs) EncodeRequest(r, b);
  PutU32(b, static_cast<uint32_t>(hits.size()));
  for (auto& h : hits) {
    PutStr(b, h.name);
    PutU32(b, h.position);
  }
  PutU32(b, epoch);
  return b;
}

bool DecodeRequestList(const uint8_t* data, size_t len,
                       std::vector<Request>* out, bool* shutdown,
                       std::vector<CacheHit>* hits, uint32_t* epoch) {
  Reader rd{data, len};
  *shutdown = rd.U8() != 0;
  uint32_t n = rd.U32();
  for (uint32_t i = 0; i < n && !rd.fail; ++i)
    out->push_back(DecodeRequest(rd));
  uint32_t n_hits = rd.U32();
  for (uint32_t i = 0; i < n_hits && !rd.fail; ++i) {
    CacheHit h;
    h.name = rd.Str();
    h.position = rd.U32();
    hits->push_back(std::move(h));
  }
  // Optional epoch trailer (0 on frames that predate it).
  uint32_t e = (!rd.fail && rd.off + 4 <= rd.len) ? rd.U32() : 0;
  if (epoch) *epoch = e;
  return !rd.fail;
}

std::vector<uint8_t> EncodeResponseList(
    const std::vector<Response>& resps, bool shutdown,
    const std::vector<uint32_t>& hit_positions,
    const std::vector<std::string>& resend_names, const WireParams& params,
    uint32_t epoch) {
  std::vector<uint8_t> b;
  PutU8(b, shutdown ? 1 : 0);
  PutU32(b, static_cast<uint32_t>(resps.size()));
  for (auto& r : resps) EncodeResponse(r, b);
  PutU32(b, static_cast<uint32_t>(hit_positions.size()));
  for (auto p : hit_positions) PutU32(b, p);
  PutU32(b, static_cast<uint32_t>(resend_names.size()));
  for (auto& nm : resend_names) PutStr(b, nm);
  PutU8(b, params.present ? 1 : 0);
  if (params.present) {
    PutI64(b, params.fusion_threshold);
    PutF64(b, params.cycle_time_s);
    PutU8(b, params.cache_enabled ? 1 : 0);
    PutU8(b, params.hierarchical_allreduce ? 1 : 0);
    PutU8(b, params.hierarchical_allgather ? 1 : 0);
    PutI64(b, params.ring_segment_bytes);
  }
  PutU32(b, epoch);
  return b;
}

bool DecodeResponseList(const uint8_t* data, size_t len,
                        std::vector<Response>* out, bool* shutdown,
                        std::vector<uint32_t>* hit_positions,
                        std::vector<std::string>* resend_names,
                        WireParams* params, uint32_t* epoch) {
  Reader rd{data, len};
  *shutdown = rd.U8() != 0;
  uint32_t n = rd.U32();
  for (uint32_t i = 0; i < n && !rd.fail; ++i)
    out->push_back(DecodeResponse(rd));
  uint32_t n_hits = rd.U32();
  for (uint32_t i = 0; i < n_hits && !rd.fail; ++i)
    hit_positions->push_back(rd.U32());
  uint32_t n_resend = rd.U32();
  for (uint32_t i = 0; i < n_resend && !rd.fail; ++i)
    resend_names->push_back(rd.Str());
  params->present = rd.U8() != 0;
  if (params->present) {
    params->fusion_threshold = rd.I64();
    params->cycle_time_s = rd.F64();
    params->cache_enabled = rd.U8() != 0;
    params->hierarchical_allreduce = rd.U8() != 0;
    params->hierarchical_allgather = rd.U8() != 0;
    params->ring_segment_bytes = rd.I64();
  }
  // Optional epoch trailer (0 on frames that predate it).
  uint32_t e = (!rd.fail && rd.off + 4 <= rd.len) ? rd.U32() : 0;
  if (epoch) *epoch = e;
  return !rd.fail;
}

// -- recovery-ladder framing (HVD_WIRE_CRC=1; see wire.h) --------------

namespace {

// Table-driven CRC-32, reflected polynomial 0xEDB88320 (the zlib/IEEE
// CRC) — must produce exactly Python's zlib.crc32 for the same bytes.
const uint32_t* Crc32Table() {
  static uint32_t table[256];
  static bool init = false;
  if (!init) {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k)
        c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : (c >> 1);
      table[i] = c;
    }
    init = true;
  }
  return table;
}

}  // namespace

uint32_t WireCrc32(const uint8_t* data, size_t len, uint32_t crc) {
  const uint32_t* table = Crc32Table();
  crc = ~crc;
  for (size_t i = 0; i < len; ++i)
    crc = table[(crc ^ data[i]) & 0xff] ^ (crc >> 8);
  return ~crc;
}

uint32_t DataCrc(const uint8_t* payload, size_t len, uint32_t seq) {
  uint32_t crc = WireCrc32(payload, len, 0);
  uint8_t s[4] = {static_cast<uint8_t>(seq & 0xff),
                  static_cast<uint8_t>((seq >> 8) & 0xff),
                  static_cast<uint8_t>((seq >> 16) & 0xff),
                  static_cast<uint8_t>((seq >> 24) & 0xff)};
  return WireCrc32(s, 4, crc);
}

}  // namespace hvd
