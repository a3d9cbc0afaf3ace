"""In-process control-plane scale simulation: star vs. hierarchical tree.
The port of ``horovod_tpu/ctrl_sim.py``, on the port's own wire codec,
frame helpers and telemetry registry: the frames it builds are byte for
byte the JAX module's for the same rank and cycle.  It runs on the host
and touches no device.

The hierarchical control plane claims the two-level tree cuts the
coordinator's per-cycle work from O(ranks) frame receives to O(hosts):
per-host sub-coordinators fold their children's negotiation frames into
one ``TAG_TREE_UP`` aggregate.  This module *measures* that claim without
hardware: it spins up N in-process "ranks" connected by socketpairs,
runs real wire-codec negotiation cycles through both topologies, and
reports the p50 coordination-cycle latency per gang size.

One simulated cycle is the coordinator half of ``_coordinator_cycle``
(``runtime_py.py``):

* **star**  — root receives one ``TAG_REQUEST_LIST`` frame from every
  other rank, decodes each, folds the requests, encodes one shared
  ``TAG_RESPONSE_LIST`` and sends it to every rank.
* **tree**  — ranks on the root's host still send direct; every other
  host's children send to their sub-coordinator thread, which folds the
  raw frames into a single ``TAG_TREE_UP`` (no decode at the subcoord —
  exactly what ``runtime_py`` does); root receives one aggregate per
  host, decodes the entries, and answers every rank on its direct
  socket (responses never route through the tree, by design).

The root is modeled the way ``runtime_py`` actually runs it: one recv
thread per direct connection (``_ctrl_recv_loop``) decoding frames and
folding them into a shared table, with the coordinator cycle blocking
until every rank's request list has landed.  That is where the star
hurts at scale — 255 recv-thread wakeups, GIL handoffs, and lock
acquisitions per cycle against the tree's 31 — and it is exactly the
cost the sub-coordinator fold removes.

The per-cycle latency is measured at the root — start of the wait for
the cycle's uplink frames to the last response byte handed to the
kernel — and each tree sample is observed into
``hvd_ctrl_cycle_seconds{ranks}`` so the metric the real coordinator
emits gets scale coverage too.

Runnable standalone::

    python -m horovod_tpu_torch.ctrl_sim      # 8/64/256-rank curve
"""

from __future__ import annotations

import socket
import statistics
import threading
import time
from typing import Dict, List, Tuple

from horovod_tpu_torch.common import wire
from horovod_tpu_torch.common.types import Request, Response, ResponseType
from horovod_tpu_torch.telemetry import registry as _tmx
from horovod_tpu_torch.utils import socketutil as su

# Gang sizes for the latency-vs-ranks curve.  256 is the proof point:
# far past any gang the multiprocess tests can spawn, and big enough
# that O(ranks) vs O(hosts) separates clearly.
CURVE_SIZES = (8, 64, 256)
DEFAULT_LOCAL_SIZE = 8


def _plan_hosts(size: int, local_size: int) -> List[List[int]]:
    """Ranks grouped by host, mirroring ``runtime_py._plan_tree``'s
    contiguous-block layout: host h owns [h*ls, min((h+1)*ls, size))."""
    return [list(range(lo, min(lo + local_size, size)))
            for lo in range(0, size, local_size)]


def _request_payload(rank: int, cycle: int) -> bytes:
    """One realistic negotiation frame: a couple of gradient allreduce
    announcements, exactly what a worker posts per training step."""
    reqs = [Request(request_rank=rank, tensor_name=f"grad_{cycle % 4}_{i}")
            for i in range(2)]
    return wire.encode_request_list(reqs, epoch=0)


def _response_payload(cycle: int) -> bytes:
    resp = Response(response_type=ResponseType.ALLREDUCE)
    resp.add_tensor_name(f"grad_{cycle % 4}_0")
    resp.add_tensor_name(f"grad_{cycle % 4}_1")
    return wire.encode_response_list([resp], epoch=0)


def _pair() -> Tuple[socket.socket, socket.socket]:
    return socket.socketpair()


def _worker(uplink: socket.socket, downlink: socket.socket,
            rank: int, cycles: int) -> None:
    """A simulated non-root rank: post the step's request list on the
    uplink (direct-to-root in star mode, to the sub-coordinator in tree
    mode), then block on the root's response before the next step."""
    try:
        for c in range(cycles):
            su.send_frame(uplink, su.TAG_REQUEST_LIST,
                          _request_payload(rank, c))
            tag, _ = su.recv_frame(downlink)
            if tag != su.TAG_RESPONSE_LIST:
                return
    except (ConnectionError, OSError):
        pass


def _subcoord(children: List[Tuple[int, socket.socket]],
              root_uplink: socket.socket, downlink: socket.socket,
              rank: int, cycles: int) -> None:
    """A simulated sub-coordinator: fold this host's raw frames (its own
    request plus one frame per child) into a single TAG_TREE_UP — no
    per-child decode, same as ``runtime_py._worker_cycle`` — then wait
    for the root's direct response like any other rank."""
    try:
        for c in range(cycles):
            entries = [(rank, su.TAG_REQUEST_LIST,
                        _request_payload(rank, c))]
            for child_rank, csock in children:
                tag, payload = su.recv_frame(csock)
                entries.append((child_rank, tag, payload))
            su.send_frame(root_uplink, su.TAG_TREE_UP,
                          wire.encode_tree_up(entries, epoch=0))
            tag, _ = su.recv_frame(downlink)
            if tag != su.TAG_RESPONSE_LIST:
                return
    except (ConnectionError, OSError):
        pass


def _decode_uplink(tag: int, payload: bytes) -> Tuple[int, List[str]]:
    """Root-side decode of one uplink frame: ``(n_request_lists,
    tensor_names)``.  A TREE_UP aggregate yields its host's whole
    member count from a single frame on a single connection."""
    names: List[str] = []
    if tag == su.TAG_TREE_UP:
        entries, _epoch = wire.decode_tree_up(payload)
        n = 0
        for _rank, etag, epayload in entries:
            if etag == su.TAG_REQUEST_LIST:
                reqs, _s, _h, _e = wire.decode_request_list(epayload)
                names.extend(r.tensor_name for r in reqs)
                n += 1
        return n, names
    if tag == su.TAG_REQUEST_LIST:
        reqs, _s, _h, _e = wire.decode_request_list(payload)
        return 1, [r.tensor_name for r in reqs]
    return 0, names


def simulate(size: int, mode: str = "star", cycles: int = 40,
             warmup: int = 5,
             local_size: int = DEFAULT_LOCAL_SIZE) -> List[float]:
    """Run ``cycles`` coordination cycles over a ``size``-rank fake mesh
    and return the per-cycle root latencies in seconds (warmup cycles
    are run but not reported).

    ``mode`` is ``"star"`` (every rank direct to root) or ``"tree"``
    (per-host sub-coordinators, fanout = host size).  With one host the
    tree degenerates to the star, matching ``_plan_tree``'s gate.
    """
    if mode not in ("star", "tree"):
        raise ValueError(f"unknown ctrl_sim mode {mode!r}")
    if size < 2:
        raise ValueError("simulate needs size >= 2")
    total = cycles + warmup
    hosts = _plan_hosts(size, local_size)

    # Direct root<->rank links exist in both modes: responses always
    # travel root->rank directly (the tree is uplink-only).
    root_side: Dict[int, socket.socket] = {}
    rank_side: Dict[int, socket.socket] = {}
    for r in range(1, size):
        a, b = _pair()
        root_side[r], rank_side[r] = a, b

    threads: List[threading.Thread] = []
    uplinks: List[socket.socket] = []  # what the root drains each cycle
    extra_socks: List[socket.socket] = []

    if mode == "star" or len(hosts) == 1:
        for r in range(1, size):
            uplinks.append(root_side[r])
            threads.append(threading.Thread(
                target=_worker,
                args=(rank_side[r], rank_side[r], r, total),
                name=f"sim-worker-{r}", daemon=True))
    else:
        # Root's own host stays direct.
        for r in hosts[0]:
            if r == 0:
                continue
            uplinks.append(root_side[r])
            threads.append(threading.Thread(
                target=_worker,
                args=(rank_side[r], rank_side[r], r, total),
                name=f"sim-worker-{r}", daemon=True))
        for host in hosts[1:]:
            sub = host[0]
            children: List[Tuple[int, socket.socket]] = []
            for child in host[1:]:
                ca, cb = _pair()
                extra_socks.extend((ca, cb))
                children.append((child, ca))
                threads.append(threading.Thread(
                    target=_worker,
                    args=(cb, rank_side[child], child, total),
                    name=f"sim-worker-{child}", daemon=True))
            uplinks.append(root_side[sub])
            threads.append(threading.Thread(
                target=_subcoord,
                args=(children, rank_side[sub], rank_side[sub], sub, total),
                name=f"sim-subcoord-{sub}", daemon=True))

    # The root mirrors runtime_py: one recv thread per direct
    # connection decoding + folding into a shared table under a lock;
    # the coordinator cycle blocks until every rank has reported.
    cv = threading.Condition()
    pending = {"count": 0}
    folded: Dict[str, int] = {}

    def _root_recv(sock: socket.socket) -> None:
        try:
            while True:
                tag, payload = su.recv_frame(sock)
                n, names = _decode_uplink(tag, payload)
                with cv:
                    for name in names:
                        folded[name] = folded.get(name, 0) + 1
                    pending["count"] += n
                    if pending["count"] >= size - 1:
                        cv.notify()
        except (ConnectionError, OSError, ValueError):
            pass

    for sock in uplinks:
        threads.append(threading.Thread(
            target=_root_recv, args=(sock,),
            name="sim-root-recv", daemon=True))

    for t in threads:
        t.start()

    latencies: List[float] = []
    try:
        for c in range(total):
            t0 = time.perf_counter()
            with cv:
                while pending["count"] < size - 1:
                    if not cv.wait(timeout=30.0):
                        raise RuntimeError(
                            f"cycle {c}: stalled at "
                            f"{pending['count']}/{size - 1} request "
                            f"lists")
                pending["count"] -= size - 1
                folded.clear()
            resp = _response_payload(c)
            for r in range(1, size):
                su.send_frame(root_side[r], su.TAG_RESPONSE_LIST, resp)
            t1 = time.perf_counter()
            if c >= warmup:
                latencies.append(t1 - t0)
    finally:
        for s in list(root_side.values()) + list(rank_side.values()) \
                + extra_socks:
            try:
                s.close()
            except OSError:
                pass
        for t in threads:
            t.join(timeout=10.0)
    return latencies


def run_curve(sizes: Tuple[int, ...] = CURVE_SIZES, cycles: int = 40,
              local_size: int = DEFAULT_LOCAL_SIZE,
              repeats: int = 3) -> Dict[str, float]:
    """The latency-vs-ranks curve for both topologies.

    Returns a flat dict of microsecond p50s keyed
    ``ctrl_cycle_{mode}_p50_us_{size}``, plus the headline
    ``coordination_cycle_p50_us`` — the hierarchical p50 at the largest
    size (the 256-rank proof point ``bench.py`` regresses on).  Tree
    samples are observed into ``hvd_ctrl_cycle_seconds{ranks}``.

    The two modes are measured in ``repeats`` interleaved passes and
    the p50 is taken over the pooled samples: on a loaded shared host a
    noise burst then lands on both topologies instead of poisoning
    whichever mode it happened to overlap.
    """
    out: Dict[str, float] = {}
    for size in sizes:
        samples: Dict[str, List[float]] = {"star": [], "tree": []}
        for _ in range(max(1, repeats)):
            for sim_mode in ("star", "tree"):
                samples[sim_mode].extend(
                    simulate(size, mode=sim_mode, cycles=cycles,
                             local_size=local_size))
        for sim_mode, lat in samples.items():
            out[f"ctrl_cycle_{sim_mode}_p50_us_{size}"] = round(
                statistics.median(lat) * 1e6, 2)
        for sample in samples["tree"]:
            _tmx.observe("hvd_ctrl_cycle_seconds", sample,
                         labels=(str(size),))
    largest = max(sizes)
    out["coordination_cycle_p50_us"] = out[
        f"ctrl_cycle_tree_p50_us_{largest}"]
    return out


def main() -> None:
    import json

    print(json.dumps(run_curve()))


if __name__ == "__main__":
    main()
