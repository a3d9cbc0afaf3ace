"""The eager engine's data plane: collectives over the TCP mesh, on the
host.  The port of ``horovod_tpu/ops/cpu_backend.py``, with its
algorithms, chunk walks and operand order, so that a port rank and a JAX
rank in one gang compute the same bits:

* allreduce: ring reduce-scatter then ring allgather, over the engine's
  persistent fusion buffer in place; 16- and 8-bit floats reduce in fp32
  and round back at every hop (``common/floats.py`` gives the rounding of
  ``ml_dtypes``, which the port does not use);
* hierarchical allreduce (``HVD_HIERARCHICAL_ALLREDUCE``, at a block
  topology): a node-local ring reduce-scatter, a cross-node ring allreduce
  of the owned slice, a node-local ring allgather (Horovod's
  ``NCCLHierarchicalAllreduce``: only 1/local_size of the bytes crosses
  nodes);
* Adasum: recursive distance-doubling partner exchange in float64
  (``ops/adasum.py``), at power-of-two world sizes;
* allgather: ragged ring allgatherv over the negotiated first dims; with
  ``HVD_HIERARCHICAL_ALLGATHER`` at a block topology, a node-local ring,
  a ring of the nodes' leaders, and each leader's fan-out to its node;
* reducescatter: the ring's reduce-scatter walk shifted by one rank, on
  dim-0 row chunks;
* broadcast: a star from the root; alltoall: size-1 rounds of pairwise
  exchange; barrier: a one-element ring allreduce.

Each ring hop's receive can be segmented at ``HVD_RING_SEGMENT_BYTES``, so
that reducing one segment overlaps receiving the next; segmentation is
receiver-local and the wire carries one frame per hop either way.

Arrays are numpy in their storage type (``uint16`` for bfloat16, ``uint8``
for fp8; ``common/floats.py``); the response's ``tensor_type`` says what
they hold.

The links are the engine's transports (``utils/transport.py``: TCP or a
same-host shm ring; ``utils/ladder.py`` under ``HVD_WIRE_CRC``, whose
exhausted link raises ``WireCorruptionError`` out of a hop).

Left out until their features are ported (ROADMAP Queue 1, item 5):
collective deadlines (5.3, ``HVD_COLLECTIVE_TIMEOUT``: every receive here
blocks; only the always-on send-wait cap raises :class:`HopTimeout`),
eviction's shrunken groups (5.3), and the trace spans and telemetry of the
hops (5.5).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from horovod_tpu_torch.common import floats
from horovod_tpu_torch.common.types import DataType, ReduceOp, Response
from horovod_tpu_torch.ops.fusion_buffer import FusionBuffer
from horovod_tpu_torch.utils import env as env_util
from horovod_tpu_torch.utils import socketutil as su
from horovod_tpu_torch.utils import transport as tpt


class HopTimeout(TimeoutError):
    """A ring hop blocked past its limit; ``peer`` is the global rank this
    rank was blocked on (-1 when unknown)."""

    def __init__(self, peer: int, phase: str):
        super().__init__(
            f"ring hop ({phase}) blocked past the collective deadline "
            f"waiting on rank {peer}")
        self.peer = int(peer)
        self.phase = phase


def _wait_send(sender, ticket: int, peer: int) -> None:
    """``wait(ticket)`` with the always-on ``HVD_SEND_WAIT_CAP_S`` cap, so
    that a dead sender thread never hangs a hop silently."""
    try:
        sender.wait(ticket, max(0.001, env_util.send_wait_cap_s()))
    except HopTimeout:
        raise
    except TimeoutError:
        raise HopTimeout(peer, "send") from None


def _transport(engine, rank: int) -> tpt.Transport:
    """The link to peer ``rank``, built at engine bootstrap."""
    return engine._transports[rank]


def _segment_elems(engine, itemsize: int) -> int:
    """Ring-hop receive segment in elements (0 = unsegmented)."""
    seg = engine.ring_segment_bytes
    if seg <= 0:
        return 0
    return max(1, seg // itemsize)


def _recv(tr: tpt.Transport) -> bytes:
    tag, payload = tr.recv_frame()
    if tag != su.TAG_DATA:
        raise ConnectionError(f"expected data frame, got tag {tag}")
    return payload


def _recv_data_header(tr: tpt.Transport) -> int:
    tag, nbytes = tr.recv_frame_header()
    if tag != su.TAG_DATA:
        raise ConnectionError(f"expected data frame, got tag {tag}")
    return nbytes


def _recv_into(tr: tpt.Transport, dst: np.ndarray) -> None:
    """Receive one data frame straight into ``dst`` (contiguous view)."""
    nbytes = _recv_data_header(tr)
    if nbytes != dst.nbytes:
        raise ConnectionError(
            f"ring hop size mismatch: got {nbytes} bytes, expected "
            f"{dst.nbytes}")
    if nbytes:
        tr.recv_exact_into(memoryview(dst.view(np.uint8)))


def _combine_out(a: np.ndarray, b: np.ndarray, out: np.ndarray,
                 op: ReduceOp) -> None:
    """``out[...] = combine(a, b)`` without allocating, ``a`` first (the
    operand order decides which NaN propagates)."""
    if op in (ReduceOp.SUM, ReduceOp.AVERAGE, ReduceOp.ADASUM):
        np.add(a, b, out=out)
    elif op == ReduceOp.MIN:
        np.minimum(a, b, out=out)
    elif op == ReduceOp.MAX:
        np.maximum(a, b, out=out)
    elif op == ReduceOp.PRODUCT:
        np.multiply(a, b, out=out)
    else:
        raise ValueError(f"unsupported reduce op {op}")


def _combine(a: np.ndarray, b: np.ndarray, op: ReduceOp,
             dt: DataType) -> np.ndarray:
    """One hop's reduction into a new array; sub-32-bit floats through
    fp32."""
    if floats.needs_f32_math(dt):
        a32, b32 = floats.to_f32(a, dt), floats.to_f32(b, dt)
        _combine_out(a32, b32, a32, op)
        return floats.from_f32(a32, dt)
    out = np.empty_like(a)
    _combine_out(a, b, out, op)
    return out


def _combine_into(incoming: np.ndarray, mine: np.ndarray, op: ReduceOp,
                  dt: DataType, fb: FusionBuffer) -> None:
    """In-place hop reduction: ``mine[...] = combine(incoming, mine)``;
    sub-32-bit floats through the persistent fp32 scratch."""
    if floats.needs_f32_math(dt):
        a32, b32 = fb.f32_views(mine.size)
        floats.to_f32(incoming, dt, out=a32)
        floats.to_f32(mine, dt, out=b32)
        _combine_out(a32, b32, b32, op)
        floats.from_f32(b32, dt, out=mine)
        return
    _combine_out(incoming, mine, mine, op)


def _recv_combine(tr: tpt.Transport, mine: np.ndarray, hop: np.ndarray,
                  hop_mv: memoryview, op: ReduceOp, dt: DataType, seg: int,
                  fb: FusionBuffer) -> None:
    """Receive one hop's chunk and reduce it into ``mine`` in place, in
    ``seg``-element slices when ``seg`` > 0."""
    nbytes = _recv_data_header(tr)
    n = mine.size
    isz = mine.itemsize
    if nbytes != n * isz:
        raise ConnectionError(
            f"ring hop size mismatch: got {nbytes} bytes, expected "
            f"{n * isz}")
    if n == 0:
        return
    if seg <= 0 or seg >= n:
        tr.recv_exact_into(hop_mv[:nbytes])
        _combine_into(hop[:n], mine, op, dt, fb)
        return
    done = 0
    while done < n:
        k = min(seg, n - done)
        tr.recv_exact_into(hop_mv[done * isz:(done + k) * isz])
        _combine_into(hop[done:done + k], mine[done:done + k], op, dt, fb)
        done += k


def _chunk_bounds(n: int, parts: int) -> List[int]:
    """NCCL-style near-equal split: bounds[i]..bounds[i+1] is chunk i."""
    base, rem = divmod(n, parts)
    bounds = [0]
    for i in range(parts):
        bounds.append(bounds[-1] + base + (1 if i < rem else 0))
    return bounds


def _ring_allreduce_group(engine, flat: np.ndarray, op: ReduceOp,
                          dt: DataType, group, me: int) -> np.ndarray:
    """Ring allreduce over ``group`` (global ranks); ``me`` is this rank's
    index in it.  In place on ``flat`` (scratch), which it returns.  Each
    step's send chunk and receive chunk are disjoint, so the sender thread
    reads stable memory while this thread reduces."""
    size = len(group)
    if size == 1:
        return flat
    right_rank = group[(me + 1) % size]
    left_rank = group[(me - 1) % size]
    right = _transport(engine, right_rank)
    left = _transport(engine, left_rank)
    bounds = _chunk_bounds(flat.size, size)
    max_chunk = max(bounds[i + 1] - bounds[i] for i in range(size))
    fb = engine._fusion_buf
    hop = fb.hop_view(max_chunk, flat.dtype)
    hop_mv = memoryview(hop.view(np.uint8))
    seg = _segment_elems(engine, flat.dtype.itemsize)

    # Phase 1: ring reduce-scatter.
    for step in range(size - 1):
        send_idx = (me - step) % size
        recv_idx = (me - step - 1) % size
        ticket = right.send(flat[bounds[send_idx]:bounds[send_idx + 1]])
        _recv_combine(left, flat[bounds[recv_idx]:bounds[recv_idx + 1]],
                      hop, hop_mv, op, dt, seg, fb)
        _wait_send(right, ticket, right_rank)

    # Phase 2: ring allgather of the reduced chunks, straight into place.
    for step in range(size - 1):
        send_idx = (me + 1 - step) % size
        recv_idx = (me - step) % size
        ticket = right.send(flat[bounds[send_idx]:bounds[send_idx + 1]])
        _recv_into(left, flat[bounds[recv_idx]:bounds[recv_idx + 1]])
        _wait_send(right, ticket, right_rank)
    return flat


def _local_group(engine):
    L = engine.local_size
    return [engine.cross_rank * L + i for i in range(L)]


def _cross_group(engine):
    L = engine.local_size
    return [k * L + engine.local_rank for k in range(engine.cross_size)]


def hierarchical_allreduce_flat(engine, flat: np.ndarray, op: ReduceOp,
                                dt: DataType) -> np.ndarray:
    """Two-level allreduce: node-local ring reduce-scatter, cross-node ring
    allreduce of the owned 1/local_size slice, node-local ring allgather.
    Needs the launcher's block rank layout, which
    ``engine.hierarchical_topology_ok()`` checks before dispatching here.
    In place on ``flat``, as :func:`_ring_allreduce_group` is."""
    L = engine.local_size
    li = engine.local_rank
    local = _local_group(engine)
    right_rank = local[(li + 1) % L]
    left_rank = local[(li - 1) % L]
    right = _transport(engine, right_rank)
    left = _transport(engine, left_rank)
    bounds = _chunk_bounds(flat.size, L)
    max_chunk = max(bounds[i + 1] - bounds[i] for i in range(L))
    fb = engine._fusion_buf
    hop = fb.hop_view(max_chunk, flat.dtype)
    hop_mv = memoryview(hop.view(np.uint8))
    seg = _segment_elems(engine, flat.dtype.itemsize)

    # Phase 1: node-local ring reduce-scatter.
    for step in range(L - 1):
        send_idx = (li - step) % L
        recv_idx = (li - step - 1) % L
        ticket = right.send(flat[bounds[send_idx]:bounds[send_idx + 1]])
        _recv_combine(left, flat[bounds[recv_idx]:bounds[recv_idx + 1]],
                      hop, hop_mv, op, dt, seg, fb)
        _wait_send(right, ticket, right_rank)

    # Phase 2: cross-node ring allreduce of the owned, fully node-reduced
    # chunk, in place on its slice of the fusion buffer.
    own = (li + 1) % L
    own_slice = flat[bounds[own]:bounds[own + 1]]
    if own_slice.size:
        _ring_allreduce_group(engine, own_slice, op, dt,
                              _cross_group(engine), engine.cross_rank)

    # Phase 3: node-local ring allgather.
    for step in range(L - 1):
        send_idx = (li + 1 - step) % L
        recv_idx = (li - step) % L
        ticket = right.send(flat[bounds[send_idx]:bounds[send_idx + 1]])
        _recv_into(left, flat[bounds[recv_idx]:bounds[recv_idx + 1]])
        _wait_send(right, ticket, right_rank)
    return flat


def _adasum_flat(engine, flat: np.ndarray, dt: DataType) -> np.ndarray:
    """Adasum by recursive distance-doubling partner exchange in float64;
    power-of-two world sizes only."""
    size, rank = engine.size, engine.rank
    if size == 1:
        return flat
    if size & (size - 1):
        raise ValueError("Adasum requires a power-of-two world size")
    from horovod_tpu_torch.ops.adasum import adasum_pair_numpy

    acc = floats.cast(flat, dt, DataType.FLOAT64)
    k = 1
    while k < size:
        partner = rank ^ k
        tr = _transport(engine, partner)
        ticket = tr.send(acc)
        other = np.frombuffer(_recv(tr), dtype=np.float64).copy()
        _wait_send(tr, ticket, partner)
        if rank < partner:
            acc = adasum_pair_numpy(acc, other)
        else:
            acc = adasum_pair_numpy(other, acc)
        k *= 2
    return floats.cast(acc, DataType.FLOAT64, dt)


def resp_group(engine, resp: Response):
    """(member global ranks, my index) for a response: the world for the
    global set, the registered members for a process set."""
    if resp.process_set_id:
        from horovod_tpu_torch import process_sets

        members = process_sets.ranks_of(resp.process_set_id)
        return members, members.index(engine.rank)
    return list(range(engine.size)), engine.rank


def allreduce(engine, entries, resp: Response):
    """Fused allreduce of every entry of the response, with the op and
    scale factors the response negotiated (the same on every rank, a
    joined rank's zero stand-ins included).  Entries are packed once into
    the persistent fusion buffer and the ring works on it in place;
    results are carved from a per-collective copy."""
    op = resp.reduce_op
    dt = resp.tensor_type
    dtype = floats.storage_dtype(dt)
    narrow = floats.needs_f32_math(dt)
    fb = engine._fusion_buf
    flat = fb.pack(entries, dtype)
    fused = True
    if resp.prescale_factor != 1.0:
        if narrow:
            flat = floats.from_f32(floats.to_f32(flat, dt)
                                   * resp.prescale_factor, dt)
        else:
            flat = flat * dtype.type(resp.prescale_factor)
        fused = False

    group, me = resp_group(engine, resp)
    # The JAX package's dispatch chain: Adasum, then the hierarchical
    # allreduce, then the flat ring.
    if op == ReduceOp.ADASUM and not resp.process_set_id:
        reduced = _adasum_flat(engine, flat, dt)
    elif (not resp.process_set_id and engine.hierarchical_allreduce
          and engine.hierarchical_topology_ok()):
        reduced = hierarchical_allreduce_flat(engine, flat, op, dt)
    else:
        reduced = _ring_allreduce_group(engine, flat, op, dt, group, me)
    fused = fused and reduced is flat

    if op == ReduceOp.AVERAGE:
        n = len(group)
        if narrow:
            reduced = floats.from_f32(floats.to_f32(reduced, dt) / n, dt)
        else:
            reduced = reduced / dtype.type(n)
        fused = False
    if resp.postscale_factor != 1.0:
        # Back to the tensor's type after numpy's promotion (an int
        # average is float64).
        scaled = floats.times(reduced, dt, resp.postscale_factor)
        if narrow and dt != DataType.FLOAT16:
            reduced = floats.from_f32(scaled, dt)
        else:
            reduced = scaled.astype(dtype, copy=False)
        fused = False
    if fused:
        reduced = reduced.copy()
    return fb.unpack(reduced, entries)


def _allgather_hierarchical(engine, entries, resp: Response):
    """Two-level allgatherv (Horovod's ``MPIHierarchicalAllgather`` role):
    a node-local ragged ring, a ring of the nodes' leaders (local rank 0)
    over the node blocks, and each leader's fan-out of the full buffer to
    its node.  The block rank layout makes node blocks contiguous in rank
    order, so the output is the flat ring's."""
    L, li = engine.local_size, engine.local_rank
    C = engine.cross_size
    local = _local_group(engine)
    dtype = floats.storage_dtype(resp.tensor_type)
    results = []
    for e in entries:
        rest_shape = e.array.shape[1:] if e.array.ndim > 0 else ()
        first_dims = resp.tensor_sizes

        # Phase 1: node-local ragged ring allgatherv (raw bytes).
        blocks: List[Optional[bytes]] = [None] * L
        blocks[li] = np.ascontiguousarray(e.array).tobytes()
        right_rank = local[(li + 1) % L]
        left_rank = local[(li - 1) % L]
        right = _transport(engine, right_rank)
        left = _transport(engine, left_rank)
        for step in range(L - 1):
            send_idx = (li - step) % L
            recv_idx = (li - step - 1) % L
            ticket = right.send(blocks[send_idx])
            blocks[recv_idx] = _recv(left)
            _wait_send(right, ticket, right_rank)
        node_block = b"".join(blocks)

        if li == 0:
            # Phase 2: the leaders' ragged ring allgatherv of node blocks.
            me = engine.cross_rank
            nblocks: List[Optional[bytes]] = [None] * C
            nblocks[me] = node_block
            if C > 1:
                nright_rank = ((me + 1) % C) * L
                nleft_rank = ((me - 1) % C) * L
                nright = _transport(engine, nright_rank)
                nleft = _transport(engine, nleft_rank)
                for step in range(C - 1):
                    send_idx = (me - step) % C
                    recv_idx = (me - step - 1) % C
                    ticket = nright.send(nblocks[send_idx])
                    nblocks[recv_idx] = _recv(nleft)
                    _wait_send(nright, ticket, nright_rank)
            full = b"".join(nblocks)
            # Phase 3: fan the full buffer out to the rest of the node.
            tickets = [(r, _transport(engine, r),
                        _transport(engine, r).send(full))
                       for r in local[1:]]
            for r, s, ticket in tickets:
                _wait_send(s, ticket, r)
        else:
            full = _recv(_transport(engine, local[0]))

        arr = np.frombuffer(full, dtype=dtype).copy()
        results.append(arr.reshape((sum(first_dims),) + rest_shape))
    return results


def allgather(engine, entries, resp: Response):
    """Ragged allgatherv, one entry per response: the hierarchical path
    under the JAX package's conditions, else the flat ring."""
    if (not resp.process_set_id and engine.hierarchical_allgather
            and engine.hierarchical_topology_ok()):
        return _allgather_hierarchical(engine, entries, resp)
    return _allgather_flat(engine, entries, resp)


def _allgather_flat(engine, entries, resp: Response):
    """Ragged ring allgatherv, one entry per response.  For a process set
    the ring walks the member list (``resp.tensor_sizes`` is in member
    order)."""
    group, me = resp_group(engine, resp)
    size = len(group)
    dtype = floats.storage_dtype(resp.tensor_type)
    results = []
    for e in entries:
        first_dims = resp.tensor_sizes
        rest_shape = e.array.shape[1:] if e.array.ndim > 0 else ()
        blocks: List[Optional[np.ndarray]] = [None] * size
        blocks[me] = np.ascontiguousarray(e.array)
        if size > 1:
            right_rank = group[(me + 1) % size]
            left_rank = group[(me - 1) % size]
            right = _transport(engine, right_rank)
            left = _transport(engine, left_rank)
            for step in range(size - 1):
                send_idx = (me - step) % size
                recv_idx = (me - step - 1) % size
                ticket = right.send(blocks[send_idx])
                payload = _recv(left)
                _wait_send(right, ticket, right_rank)
                blk = np.frombuffer(payload, dtype=dtype)
                blocks[recv_idx] = blk.reshape(
                    (first_dims[recv_idx],) + rest_shape)
        results.append(np.concatenate(blocks, axis=0)
                       if size > 1 else blocks[me].copy())
    return results


def reducescatter(engine, entries, resp: Response):
    """Ring reduce-scatter: reduce across ranks, scatter over dim 0.

    Rank ``r`` receives the reduced rows ``bounds[r]:bounds[r+1]`` of a
    near-equal row split (larger chunks on lower ranks).  The walk is the
    allreduce's reduce-scatter shifted by one virtual rank, so that each
    rank ends owning its own chunk."""
    group, me = resp_group(engine, resp)
    size = len(group)
    op = resp.reduce_op
    dt = resp.tensor_type
    dtype = floats.storage_dtype(dt)
    results = []
    for e in entries:
        arr = np.ascontiguousarray(e.array).astype(dtype, copy=False)
        d0 = arr.shape[0]
        rest = arr.shape[1:]
        bounds = _chunk_bounds(d0, size)
        if size == 1:
            results.append(arr.copy())
            continue
        chunks = [arr[bounds[i]:bounds[i + 1]].copy()
                  for i in range(size)]
        right_rank = group[(me + 1) % size]
        left_rank = group[(me - 1) % size]
        right = _transport(engine, right_rank)
        left = _transport(engine, left_rank)
        for step in range(size - 1):
            send_idx = (me - 1 - step) % size
            recv_idx = (me - 2 - step) % size
            ticket = right.send(chunks[send_idx])
            incoming = np.frombuffer(_recv(left), dtype=dtype).reshape(
                (bounds[recv_idx + 1] - bounds[recv_idx],) + rest).copy()
            _wait_send(right, ticket, right_rank)
            chunks[recv_idx] = _combine(incoming, chunks[recv_idx], op, dt)
        out = chunks[me]
        if op == ReduceOp.AVERAGE:
            if floats.needs_f32_math(dt):
                out = floats.from_f32(floats.to_f32(out, dt) / size, dt)
            else:
                out = out / dtype.type(size)
        results.append(out)
    return results


def broadcast(engine, entries, resp: Response):
    group, _me = resp_group(engine, resp)
    rank = engine.rank
    dtype = floats.storage_dtype(resp.tensor_type)
    results = []
    for e in entries:
        root = int(resp.tensor_sizes[0]) if resp.tensor_sizes \
            else e.root_rank  # a global rank (a set member)
        if len(group) == 1:
            results.append(e.array.copy())
            continue
        if rank == root:
            payload = np.ascontiguousarray(e.array)
            tickets = [(r, _transport(engine, r),
                        _transport(engine, r).send(payload))
                       for r in group if r != root]
            for r, s, ticket in tickets:
                _wait_send(s, ticket, r)
            results.append(e.array.copy())
        else:
            payload = _recv(_transport(engine, root))
            arr = np.frombuffer(payload, dtype=dtype).copy()
            results.append(arr.reshape(e.array.shape))
    return results


def alltoall(engine, entries, resp: Response):
    """Pairwise exchange rounds; for a process set, partners walk the
    member list."""
    group, rank = resp_group(engine, resp)
    size = len(group)
    dtype = floats.storage_dtype(resp.tensor_type)
    results = []
    for e in entries:
        splits = e.splits
        if splits is None:
            if e.array.shape[0] % size:
                raise ValueError(
                    "alltoall without splits requires dim 0 divisible by "
                    "the participant count")
            per = e.array.shape[0] // size
            splits = [per] * size
        offs = np.concatenate([[0], np.cumsum(splits)])
        my_blocks = [np.ascontiguousarray(
            e.array[offs[r]:offs[r + 1]]) for r in range(size)]
        recv_blocks: List[Optional[np.ndarray]] = [None] * size
        recv_blocks[rank] = my_blocks[rank].copy()
        rest_shape = e.array.shape[1:]
        for step in range(1, size):
            dst = (rank + step) % size
            src = (rank - step) % size
            sender = _transport(engine, group[dst])
            ticket = sender.send(my_blocks[dst])
            payload = _recv(_transport(engine, group[src]))
            _wait_send(sender, ticket, group[dst])
            blk = np.frombuffer(payload, dtype=dtype)
            if rest_shape:
                blk = blk.reshape((-1,) + rest_shape)
            recv_blocks[src] = blk.copy()
        recv_splits = [b.shape[0] for b in recv_blocks]
        results.append((np.concatenate(recv_blocks, axis=0)
                        if recv_blocks else e.array.copy(),
                        recv_splits))
    return results


def barrier(engine, resp: Response) -> None:
    group, me = resp_group(engine, resp)
    _ring_allreduce_group(engine, np.zeros(1, np.int32), ReduceOp.SUM,
                          DataType.INT32, group, me)
