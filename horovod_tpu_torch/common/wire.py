"""Binary codec for the eager engine's control messages: the port of
``horovod_tpu/common/wire.py``.

The frames are byte for byte the JAX package's, so that a port rank and a
JAX ``PyEngine`` rank negotiate in one gang.  Layout (little-endian):

  varstr   := u32 len, bytes
  Request  := u8 request_type, i32 request_rank, u8 tensor_type,
              varstr tensor_name, i32 root_rank, varstr device,
              u8 reduce_op, f64 prescale, f64 postscale,
              u8 ndim, i64 dims[ndim],
              i32 process_set_id, i32 process_set_size
  CacheHit := varstr name, u32 position
  RequestList  := u8 shutdown, u32 n, Request[n],
                  u32 n_hits, CacheHit[n_hits],
                  [ u32 epoch ]                   # optional trailer
  Response := u8 response_type, u8 tensor_type, u32 n_names,
              varstr[n_names], varstr error_message,
              u32 n_devices, varstr[n_devices],
              u32 n_sizes, i64 sizes[n_sizes],
              u8 reduce_op, f64 prescale, f64 postscale,
              u32 n_shapes, { u8 ndim, i64 dims[ndim] }[n_shapes],
              i32 process_set_id
  ResponseList := u8 shutdown, u32 n, Response[n],
                  u32 n_hit_positions, u32 pos[n_hit_positions],
                  u32 n_resend, varstr resend_names[n_resend],
                  u8 has_params,
                  [ i64 fusion_threshold, f64 cycle_time_s,
                    u8 cache_enabled, u8 hierarchical_allreduce,
                    u8 hierarchical_allgather,
                    i64 ring_segment_bytes ],  # iff has_params
                  [ u32 epoch ]                   # optional trailer

The epoch trailer is the sender's membership epoch; a frame without it
decodes as epoch 0.  ``has_params`` carries the autotuner's knob broadcast,
which a worker applies before the same frame's cached hits.

The recovery ladder's framing (``utils/ladder.py``) is here too: the
8-byte CRC trailer of a data frame (``u32 seq, u32 crc32``, the CRC over
the payload then the packed seq), the NACK (``u32 expected seq``) and the
RESUME/FAILOVER payload (``i32 rank, u32 expected seq, u32 epoch``), and
:class:`WireCorruptionError`.

The abort agreement's payloads (``TAG_ABORT_REPORT``, ``TAG_PROBE_ACK``,
``TAG_ABORT_VERDICT``) and the control tree's (``TAG_TREE_UP``,
``TAG_TREE_DOWN``, ``TAG_REPARENT``)::

  AbortReport  := varstr tensor_name, i32 suspect_rank, u32 epoch
  ProbeAck     := u8 busy, f64 busy_seconds, u32 epoch
  AbortVerdict := varstr tensor_name, u32 n, i32 ranks[n], u32 epoch
  TreeUp   := u32 epoch, u32 n, { i32 rank, u8 tag, u32 len, bytes }[n]
  TreeDown := i32 target_rank (-1 = every child), u8 tag, u32 len, bytes
  Reparent := i32 rank, i32 old_parent, u32 epoch

The trace's clock sync (``TAG_CLOCK_PING``/``TAG_CLOCK_PONG``) and the
flight recorder's pull (``TAG_BLACKBOX``/``TAG_BLACKBOX_DUMP``)::

  ClockPing     := i64 t0_ns, u32 epoch
  ClockPong     := i64 t0_ns, i64 t_coord_ns, u32 epoch
  BlackboxReq   := u32 epoch
  BlackboxDump  := i32 rank, u32 epoch, u32 len, bytes (UTF-8 JSON)

The epoch fence (``TAG_FENCE``, the coordinator's answer to a request
frame from another membership epoch)::

  Fence         := u32 stale_epoch, u32 current_epoch

The serving loop's batch delta (``TAG_SERVE``, rank 0 to every rank, one
frame per decode step)::

  ServeDelta := u64 seq, u8 stop, u32 n,
                { u32 slot, u32 max_new, varstr request_id,
                  u32 plen, u32 prompt[plen] }[n],
                u32 epoch, [ varstr leader_addr ]  # optional trailer

Retirements are not carried: greedy decode is deterministic, so every rank
retires the same slot at the same token on its own.
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Optional, Tuple

from horovod_tpu_torch.common.types import (
    DataType,
    ReduceOp,
    Request,
    RequestType,
    Response,
    ResponseType,
    TensorShape,
)


def _pack_str(buf: bytearray, s: str) -> None:
    b = s.encode("utf-8")
    buf += struct.pack("<I", len(b))
    buf += b


def _unpack_str(data: bytes, off: int) -> Tuple[str, int]:
    (n,) = struct.unpack_from("<I", data, off)
    off += 4
    return data[off:off + n].decode("utf-8"), off + n


def _pack_dims(buf: bytearray, dims) -> None:
    buf += struct.pack("<B", len(dims))
    buf += struct.pack(f"<{len(dims)}q", *dims)


def _unpack_dims(data: bytes, off: int) -> Tuple[List[int], int]:
    (ndim,) = struct.unpack_from("<B", data, off)
    off += 1
    dims = list(struct.unpack_from(f"<{ndim}q", data, off))
    return dims, off + 8 * ndim


def encode_request(req: Request, buf: bytearray) -> None:
    buf += struct.pack("<BiB", int(req.request_type), req.request_rank,
                       int(req.tensor_type))
    _pack_str(buf, req.tensor_name)
    buf += struct.pack("<i", req.root_rank)
    _pack_str(buf, req.device)
    buf += struct.pack("<Bdd", int(req.reduce_op), req.prescale_factor,
                       req.postscale_factor)
    _pack_dims(buf, req.tensor_shape.dims)
    buf += struct.pack("<ii", req.process_set_id, req.process_set_size)


def decode_request(data: bytes, off: int) -> Tuple[Request, int]:
    rtype, rrank, ttype = struct.unpack_from("<BiB", data, off)
    off += struct.calcsize("<BiB")
    name, off = _unpack_str(data, off)
    (root,) = struct.unpack_from("<i", data, off)
    off += 4
    device, off = _unpack_str(data, off)
    rop, pre, post = struct.unpack_from("<Bdd", data, off)
    off += struct.calcsize("<Bdd")
    dims, off = _unpack_dims(data, off)
    ps_id, ps_size = struct.unpack_from("<ii", data, off)
    off += 8
    return Request(
        request_rank=rrank,
        request_type=RequestType(rtype),
        tensor_type=DataType(ttype),
        tensor_name=name,
        root_rank=root,
        device=device,
        tensor_shape=TensorShape(dims),
        reduce_op=ReduceOp(rop),
        prescale_factor=pre,
        postscale_factor=post,
        process_set_id=ps_id,
        process_set_size=ps_size,
    ), off


def encode_request_list(reqs: List[Request], shutdown: bool = False,
                        cache_hits: List[Tuple[str, int]] = (),
                        epoch: int = 0) -> bytes:
    buf = bytearray()
    buf += struct.pack("<BI", 1 if shutdown else 0, len(reqs))
    for r in reqs:
        encode_request(r, buf)
    buf += struct.pack("<I", len(cache_hits))
    for name, pos in cache_hits:
        _pack_str(buf, name)
        buf += struct.pack("<I", pos)
    buf += struct.pack("<I", epoch)
    return bytes(buf)


def decode_request_list(
        data: bytes) -> Tuple[List[Request], bool, List[Tuple[str, int]],
                              int]:
    shutdown, n = struct.unpack_from("<BI", data, 0)
    off = struct.calcsize("<BI")
    out = []
    for _ in range(n):
        r, off = decode_request(data, off)
        out.append(r)
    (n_hits,) = struct.unpack_from("<I", data, off)
    off += 4
    hits = []
    for _ in range(n_hits):
        name, off = _unpack_str(data, off)
        (pos,) = struct.unpack_from("<I", data, off)
        off += 4
        hits.append((name, pos))
    epoch = 0
    if off + 4 <= len(data):  # a frame without the trailer stops here
        (epoch,) = struct.unpack_from("<I", data, off)
    return out, bool(shutdown), hits, epoch


def encode_response(resp: Response, buf: bytearray) -> None:
    buf += struct.pack("<BBI", int(resp.response_type),
                       int(resp.tensor_type), len(resp.tensor_names))
    for nm in resp.tensor_names:
        _pack_str(buf, nm)
    _pack_str(buf, resp.error_message)
    buf += struct.pack("<I", len(resp.devices))
    for d in resp.devices:
        _pack_str(buf, d)
    buf += struct.pack("<I", len(resp.tensor_sizes))
    buf += struct.pack(f"<{len(resp.tensor_sizes)}q", *resp.tensor_sizes)
    buf += struct.pack("<Bdd", int(resp.reduce_op), resp.prescale_factor,
                       resp.postscale_factor)
    buf += struct.pack("<I", len(resp.tensor_shapes))
    for shape in resp.tensor_shapes:
        _pack_dims(buf, shape.dims)
    buf += struct.pack("<i", resp.process_set_id)


def decode_response(data: bytes, off: int) -> Tuple[Response, int]:
    rtype, ttype, n_names = struct.unpack_from("<BBI", data, off)
    off += struct.calcsize("<BBI")
    names = []
    for _ in range(n_names):
        nm, off = _unpack_str(data, off)
        names.append(nm)
    err, off = _unpack_str(data, off)
    (n_dev,) = struct.unpack_from("<I", data, off)
    off += 4
    devices = []
    for _ in range(n_dev):
        d, off = _unpack_str(data, off)
        devices.append(d)
    (n_sizes,) = struct.unpack_from("<I", data, off)
    off += 4
    sizes = list(struct.unpack_from(f"<{n_sizes}q", data, off))
    off += 8 * n_sizes
    rop, pre, post = struct.unpack_from("<Bdd", data, off)
    off += struct.calcsize("<Bdd")
    (n_shapes,) = struct.unpack_from("<I", data, off)
    off += 4
    shapes = []
    for _ in range(n_shapes):
        dims, off = _unpack_dims(data, off)
        shapes.append(TensorShape(dims))
    (ps_id,) = struct.unpack_from("<i", data, off)
    off += 4
    return Response(
        response_type=ResponseType(rtype),
        tensor_type=DataType(ttype),
        tensor_names=names,
        error_message=err,
        devices=devices,
        tensor_sizes=sizes,
        reduce_op=ReduceOp(rop),
        prescale_factor=pre,
        postscale_factor=post,
        tensor_shapes=shapes,
        process_set_id=ps_id,
    ), off


def encode_response_list(resps: List[Response], shutdown: bool = False,
                         hit_positions: List[int] = (),
                         resend_names: List[str] = (),
                         params: Optional[Tuple[int, float, bool,
                                                bool, bool, int]] = None,
                         epoch: int = 0) -> bytes:
    """``params``: (fusion_threshold, cycle_time_s, cache_enabled,
    hierarchical_allreduce, hierarchical_allgather, ring_segment_bytes),
    or None.  A 5-tuple encodes its segment as 0."""
    buf = bytearray()
    buf += struct.pack("<BI", 1 if shutdown else 0, len(resps))
    for r in resps:
        encode_response(r, buf)
    buf += struct.pack("<I", len(hit_positions))
    buf += struct.pack(f"<{len(hit_positions)}I", *hit_positions)
    buf += struct.pack("<I", len(resend_names))
    for nm in resend_names:
        _pack_str(buf, nm)
    if params is None:
        buf += struct.pack("<B", 0)
    else:
        fusion, cycle_s, cache_on, hier_ar, hier_ag = params[:5]
        segment = params[5] if len(params) > 5 else 0
        buf += struct.pack("<BqdBBBq", 1, fusion, cycle_s,
                           1 if cache_on else 0, 1 if hier_ar else 0,
                           1 if hier_ag else 0, segment)
    buf += struct.pack("<I", epoch)
    return bytes(buf)


def decode_response_list(data: bytes) -> Tuple[
        List[Response], bool, List[int], List[str],
        Optional[Tuple[int, float, bool, bool, bool, int]], int]:
    shutdown, n = struct.unpack_from("<BI", data, 0)
    off = struct.calcsize("<BI")
    out = []
    for _ in range(n):
        r, off = decode_response(data, off)
        out.append(r)
    (n_hits,) = struct.unpack_from("<I", data, off)
    off += 4
    hits = list(struct.unpack_from(f"<{n_hits}I", data, off))
    off += 4 * n_hits
    (n_resend,) = struct.unpack_from("<I", data, off)
    off += 4
    resend = []
    for _ in range(n_resend):
        nm, off = _unpack_str(data, off)
        resend.append(nm)
    (has_params,) = struct.unpack_from("<B", data, off)
    off += 1
    params = None
    if has_params:
        fusion, cycle_s, cache_on, hier_ar, hier_ag, segment = \
            struct.unpack_from("<qdBBBq", data, off)
        off += struct.calcsize("<qdBBBq")
        params = (fusion, cycle_s, bool(cache_on), bool(hier_ar),
                  bool(hier_ag), segment)
    epoch = 0
    if off + 4 <= len(data):  # a frame without the trailer stops here
        (epoch,) = struct.unpack_from("<I", data, off)
    return out, bool(shutdown), hits, resend, params, epoch


# -- the recovery ladder's framing --------------------------------------

_TRAILER = struct.Struct("<II")
TRAILER_BYTES = _TRAILER.size


class WireCorruptionError(ConnectionError):
    """A data frame failed CRC validation, or the ladder exhausted its
    retransmit, reconnect or failover budget healing a link.  Carries the
    peer rank and the hop phase, as ``ops.cpu_backend.HopTimeout`` does,
    and the ``cause`` (corrupt, reset or failover)."""

    def __init__(self, peer: int, cause: str):
        super().__init__(
            f"data-plane link to rank {peer} is corrupt past the "
            f"recovery ladder ({cause})")
        self.peer = int(peer)
        self.phase = "recv"
        self.cause = cause


def data_crc(payload, seq: int) -> int:
    """CRC-32 (zlib's polynomial) over the payload bytes then the packed
    seq: covering the seq binds the checksum to the frame's place in the
    stream, so that a stale replayed frame never validates."""
    crc = zlib.crc32(payload)
    return zlib.crc32(struct.pack("<I", seq & 0xFFFFFFFF), crc)


def pack_trailer(payload, seq: int) -> bytes:
    return _TRAILER.pack(seq & 0xFFFFFFFF, data_crc(payload, seq))


def split_trailer(frame: memoryview) -> Tuple[memoryview, int, int]:
    """``(payload view, seq, crc)`` of a trailered data frame; the caller
    checks ``crc == data_crc(payload, seq)``."""
    if len(frame) < TRAILER_BYTES:
        raise ValueError("data frame shorter than its CRC trailer")
    body = frame[:-TRAILER_BYTES]
    seq, crc = _TRAILER.unpack(frame[-TRAILER_BYTES:])
    return body, seq, crc


def encode_nack(expected_seq: int) -> bytes:
    return struct.pack("<I", expected_seq & 0xFFFFFFFF)


def decode_nack(data: bytes) -> int:
    return struct.unpack_from("<I", data, 0)[0]


def encode_resume(rank: int, expected_seq: int, epoch: int = 0) -> bytes:
    """RESUME (after a reconnect) and FAILOVER (shm to TCP) payload: who
    speaks, the next data seq they expect, and their membership epoch."""
    return struct.pack("<iII", rank, expected_seq & 0xFFFFFFFF, epoch)


def decode_resume(data: bytes) -> Tuple[int, int, int]:
    return struct.unpack_from("<iII", data, 0)


# -- the collective-abort agreement -------------------------------------


def encode_abort_report(tensor_name: str, suspect_rank: int,
                        epoch: int = 0) -> bytes:
    """Worker -> coordinator: a hop of ``tensor_name``'s collective blew
    its deadline, blocked on ``suspect_rank`` (-1 = unknown)."""
    buf = bytearray()
    _pack_str(buf, tensor_name)
    buf += struct.pack("<iI", suspect_rank, epoch)
    return bytes(buf)


def decode_abort_report(data: bytes) -> Tuple[str, int, int]:
    name, off = _unpack_str(data, 0)
    suspect, epoch = struct.unpack_from("<iI", data, off)
    return name, suspect, epoch


def encode_probe_ack(busy: bool, busy_seconds: float,
                     epoch: int = 0) -> bytes:
    """Worker -> coordinator: whether a collective is running on this rank
    now (``busy``), and for how long."""
    return struct.pack("<BdI", 1 if busy else 0, busy_seconds, epoch)


def decode_probe_ack(data: bytes) -> Tuple[bool, float, int]:
    busy, busy_seconds, epoch = struct.unpack_from("<BdI", data, 0)
    return bool(busy), busy_seconds, epoch


def encode_abort_verdict(tensor_name: str, ranks,
                         epoch: int = 0) -> bytes:
    """Coordinator -> workers: the ranks the gang agreed are wedged in the
    collective of ``tensor_name`` (sorted)."""
    buf = bytearray()
    _pack_str(buf, tensor_name)
    ranks = sorted(int(r) for r in ranks)
    buf += struct.pack("<I", len(ranks))
    for r in ranks:
        buf += struct.pack("<i", r)
    buf += struct.pack("<I", epoch)
    return bytes(buf)


def decode_abort_verdict(data: bytes) -> Tuple[str, List[int], int]:
    name, off = _unpack_str(data, 0)
    (n,) = struct.unpack_from("<I", data, off)
    off += 4
    ranks = list(struct.unpack_from(f"<{n}i", data, off))
    (epoch,) = struct.unpack_from("<I", data, off + 4 * n)
    return name, ranks, epoch


# -- the control tree -----------------------------------------------------


def encode_tree_up(entries, epoch: int = 0) -> bytes:
    """Sub-coordinator -> root: its children's frames and its own,
    ``entries`` = [(rank, tag, payload)], each dispatched at the root as
    if it had come on that rank's own control socket."""
    buf = bytearray(struct.pack("<II", epoch, len(entries)))
    for rank, tag, payload in entries:
        buf += struct.pack("<iBI", rank, tag, len(payload))
        buf += payload
    return bytes(buf)


def decode_tree_up(data: bytes):
    """Returns ``(entries, epoch)``, entries = [(rank, tag, payload)]."""
    epoch, n = struct.unpack_from("<II", data, 0)
    off = 8
    entries = []
    for _ in range(n):
        rank, tag, plen = struct.unpack_from("<iBI", data, off)
        off += 9
        entries.append((rank, tag, bytes(data[off:off + plen])))
        off += plen
    return entries, epoch


def encode_tree_down(target_rank: int, tag: int, payload: bytes) -> bytes:
    """Root -> sub-coordinator: forward ``(tag, payload)`` to
    ``target_rank`` (-1 = every child)."""
    return struct.pack("<iBI", target_rank, tag, len(payload)) + payload


def decode_tree_down(data: bytes):
    """Returns ``(target_rank, tag, payload)``."""
    target, tag, plen = struct.unpack_from("<iBI", data, 0)
    return target, tag, bytes(data[9:9 + plen])


def encode_reparent(rank: int, old_parent: int, epoch: int = 0) -> bytes:
    """Orphaned child -> root: sub-coordinator ``old_parent`` died; take
    this rank's control frames directly from now on."""
    return struct.pack("<iiI", rank, old_parent, epoch)


def decode_reparent(data: bytes):
    """Returns ``(rank, old_parent, epoch)``."""
    return struct.unpack_from("<iiI", data, 0)


# -- the trace's clock sync ----------------------------------------------


def encode_clock_ping(t0_ns: int, epoch: int = 0) -> bytes:
    """Worker -> coordinator: this rank's monotonic clock, now."""
    return struct.pack("<qI", t0_ns, epoch)


def decode_clock_ping(data: bytes) -> Tuple[int, int]:
    t0_ns, epoch = struct.unpack_from("<qI", data, 0)
    return t0_ns, epoch


def encode_clock_pong(t0_ns: int, t_coord_ns: int,
                      epoch: int = 0) -> bytes:
    """Coordinator -> worker: the ping's t0 echoed, and the coordinator's
    monotonic clock when it answered."""
    return struct.pack("<qqI", t0_ns, t_coord_ns, epoch)


def decode_clock_pong(data: bytes) -> Tuple[int, int, int]:
    t0_ns, t_coord_ns, epoch = struct.unpack_from("<qqI", data, 0)
    return t0_ns, t_coord_ns, epoch


# -- the flight recorder's pull ------------------------------------------


def encode_blackbox_request(epoch: int = 0) -> bytes:
    """Coordinator -> worker (TAG_BLACKBOX): send me your recorder's ring,
    after an abort verdict."""
    return struct.pack("<I", epoch)


def decode_blackbox_request(data: bytes) -> int:
    (epoch,) = struct.unpack_from("<I", data, 0)
    return epoch


def encode_blackbox_dump(rank: int, epoch: int, blob: bytes) -> bytes:
    """Worker -> coordinator (TAG_BLACKBOX_DUMP): the dump document, the
    bytes ``blackbox_rank<r>.json`` would hold."""
    return struct.pack("<iII", rank, epoch, len(blob)) + blob


def decode_blackbox_dump(data: bytes) -> Tuple[int, int, bytes]:
    rank, epoch, n = struct.unpack_from("<iII", data, 0)
    return rank, epoch, bytes(data[12:12 + n])


# -- the epoch fence -----------------------------------------------------


def encode_fence(stale_epoch: int, current_epoch: int) -> bytes:
    """Coordinator -> a sender whose control frame carried another
    membership epoch: the gang re-formed without it; it must exit."""
    return struct.pack("<II", stale_epoch, current_epoch)


def decode_fence(data: bytes) -> Tuple[int, int]:
    """Returns ``(stale_epoch, current_epoch)``."""
    return struct.unpack_from("<II", data, 0)


# -- the serving loop's batch delta (TAG_SERVE) ----------------------------


def encode_serve_delta(seq: int, stop: bool, admissions,
                       epoch: int = 0, leader_addr: str = "") -> bytes:
    """Rank 0 -> every rank: step ``seq``'s batch delta.  ``admissions``
    holds ``(slot, request_id, max_new_tokens, prompt_tokens)``;
    ``leader_addr`` (the leader's front door, ``host:port``, "" unknown)
    rides after the epoch, where a decoder that stops at the epoch never
    reads it."""
    buf = bytearray()
    buf += struct.pack("<QBI", seq, 1 if stop else 0, len(admissions))
    for slot, req_id, max_new, prompt in admissions:
        buf += struct.pack("<II", slot, max_new)
        _pack_str(buf, req_id)
        prompt = [int(t) for t in prompt]
        buf += struct.pack(f"<I{len(prompt)}I", len(prompt), *prompt)
    buf += struct.pack("<I", epoch)
    _pack_str(buf, leader_addr)
    return bytes(buf)


def decode_serve_delta(data: bytes):
    """Returns ``(seq, stop, admissions, epoch)``, each admission as
    ``(slot, request_id, max_new_tokens, prompt list)``."""
    return decode_serve_delta_ex(data)[:4]


def decode_serve_delta_ex(data: bytes):
    """Returns ``(seq, stop, admissions, epoch, leader_addr)``; a frame
    without the trailer gives ``""``."""
    seq, stop, n = struct.unpack_from("<QBI", data, 0)
    off = struct.calcsize("<QBI")
    admissions = []
    for _ in range(n):
        slot, max_new = struct.unpack_from("<II", data, off)
        off += 8
        req_id, off = _unpack_str(data, off)
        (plen,) = struct.unpack_from("<I", data, off)
        off += 4
        prompt = list(struct.unpack_from(f"<{plen}I", data, off))
        off += 4 * plen
        admissions.append((slot, req_id, max_new, prompt))
    (epoch,) = struct.unpack_from("<I", data, off)
    off += 4
    leader_addr = ""
    if off < len(data):
        leader_addr, off = _unpack_str(data, off)
    return seq, bool(stop), admissions, epoch, leader_addr
