"""The port's collective deadlines and gang-wide abort against the JAX
package's (``tests/test_timeouts.py`` is the JAX side's own).

* The deadline receive (expired, in time, partial then silent, a peer
  closed mid-header), ``PeerSender.wait`` on a stuck ticket, ``_wait_send``
  to ``HopTimeout`` (with the deadline and with the always-on cap),
  ``connect_retry`` near its deadline, ``_deadline``.
* The knob-off pins: no ``settimeout`` and no clock read on the receive
  paths (socket and shm), nothing allocated, and an in-process gang of two
  whose control frames are only request and response lists, the JAX
  codecs' bytes, with the same threads whether liveness and deadlines
  are on or off.
* ``CollectiveTimeoutError`` and the typed status against JAX's; the abort
  codecs byte for byte both ways; the knobs' defaults against JAX's.
* Gangs of three (``tests/torch_port_chaos_worker.py stall_steps``), with
  ``HVD_COLLECTIVE_TIMEOUT=3``, rank 2 stalled at step 1: a port gang on
  TCP (``sock.stall``) and one on shm (``shm.stall``), a mixed gang with
  a JAX coordinator and a port victim, and one with a port coordinator
  and a JAX victim.  Both survivors raise
  ``CollectiveTimeoutError([2])`` within twice the timeout of the step's
  submission, with the same tensor, rank 0's timeline holds
  ``COLLECTIVE_ABORT``, the retained batch is each survivor's own inputs
  bit for bit, and no shm segment outlives the gang.  With
  ``HVD_WIRE_CRC=1`` and ``HVD_HOP_RETRIES=0`` a rank that corrupts every
  TCP frame it sends is the one the abort names.

The timeout is 3 s (the JAX test's is 2) and the probe window 0.75 s,
for margin under the suite's parallel load.
"""

import glob
import json
import re
import socket
import threading
import time

import numpy as np
import pytest

from horovod_tpu_torch.common import wire
from horovod_tpu_torch.common.types import (CollectiveTimeoutError,
                                            RanksFailedError, ReduceOp,
                                            Status)
from horovod_tpu_torch.ops import cpu_backend
from horovod_tpu_torch.utils import env as env_util
from horovod_tpu_torch.utils import socketutil as su
from horovod_tpu_torch.utils import transport as tpt
from test_torch_liveness import _finish, _start, _steps

TIMEOUT_S = 3.0
PROBE_S = 0.75
GANG_TIMEOUT = 150.0


# ---------------------------------------------------------------------------
# the typed error and its status
# ---------------------------------------------------------------------------


def test_collective_timeout_error_matches_jax():
    from horovod_tpu.common.types import CollectiveTimeoutError as JaxCTE

    e = CollectiveTimeoutError([2, 0], "allreduce.grad", 3.0)
    j = JaxCTE([2, 0], "allreduce.grad", 3.0)
    assert isinstance(e, RanksFailedError)
    assert e.ranks == j.ranks == [0, 2]
    assert e.tensor_name == j.tensor_name == "allreduce.grad"
    assert e.timeout_s == j.timeout_s == 3.0
    assert str(e) == str(j)
    assert str(CollectiveTimeoutError([1])) == str(JaxCTE([1]))


def test_handle_manager_raises_typed_status_exc():
    from horovod_tpu_torch.runtime_py import HandleManager

    hm = HandleManager()
    h = hm.allocate()
    err = CollectiveTimeoutError([1], "t", 1.0)
    st = Status.aborted(str(err))
    st.exc = err
    hm.mark_done(h, st)
    with pytest.raises(CollectiveTimeoutError) as ei:
        hm.wait(h)
    assert ei.value is err
    h2 = hm.allocate()
    hm.mark_done(h2, Status.aborted("plain failure"))
    with pytest.raises(RuntimeError, match="plain failure"):
        hm.wait(h2)


# ---------------------------------------------------------------------------
# the deadline receive
# ---------------------------------------------------------------------------


def test_recv_exact_deadline_expires():
    a, b = socket.socketpair()
    try:
        t0 = time.monotonic()
        with pytest.raises(TimeoutError, match="deadline"):
            su.recv_exact(a, 4, deadline=time.monotonic() + 0.15)
        assert 0.1 <= time.monotonic() - t0 < 2.0
        assert a.gettimeout() is None  # blocking again for the teardown
    finally:
        a.close()
        b.close()


def test_recv_exact_deadline_data_in_time():
    a, b = socket.socketpair()
    try:
        b.sendall(b"abcd")
        assert su.recv_exact(a, 4,
                             deadline=time.monotonic() + 5.0) == b"abcd"
        assert a.gettimeout() is None
    finally:
        a.close()
        b.close()


def test_recv_exact_partial_then_stall_times_out():
    a, b = socket.socketpair()
    try:
        b.sendall(b"ab")
        with pytest.raises(TimeoutError, match="deadline"):
            su.recv_exact(a, 4, deadline=time.monotonic() + 0.15)
    finally:
        a.close()
        b.close()


def test_recv_frame_header_peer_closed_mid_header():
    a, b = socket.socketpair()
    try:
        b.sendall(su.HEADER.pack(su.TAG_DATA, 12)[:3])
        b.close()
        with pytest.raises(ConnectionError, match="peer closed"):
            su.recv_frame_header(a)
    finally:
        a.close()


def test_shm_receive_deadline_is_the_socket_paths():
    """A silent shm peer: the reader raises the socket path's
    ``TimeoutError``, which the hop maps to ``HopTimeout``."""
    a, b = tpt.make_transport_pair()
    try:
        with pytest.raises(TimeoutError, match="receive deadline exceeded"):
            a.recv_frame_header(time.monotonic() + 0.1)
        with pytest.raises(cpu_backend.HopTimeout) as ei:
            cpu_backend._recv(a, time.monotonic() + 0.1, peer=1)
        assert ei.value.peer == 1 and ei.value.phase == "recv"
    finally:
        a.close(timeout=1.0)
        b.close(timeout=1.0)


# ---------------------------------------------------------------------------
# knob-off pins
# ---------------------------------------------------------------------------


class _SpySock:
    def __init__(self, sock):
        self._sock = sock
        self.settimeout_calls = []

    def recv_into(self, *a, **kw):
        return self._sock.recv_into(*a, **kw)

    def settimeout(self, t):
        self.settimeout_calls.append(t)
        self._sock.settimeout(t)


def test_recv_knob_off_path_never_touches_socket_timeout():
    a, b = socket.socketpair()
    try:
        b.sendall(b"abcdefgh")
        spy = _SpySock(a)
        assert su.recv_exact(spy, 8) == b"abcdefgh"
        assert spy.settimeout_calls == []
        b.sendall(b"abcdefgh")
        assert su.recv_exact(spy, 8,
                             deadline=time.monotonic() + 5.0) == b"abcdefgh"
        assert spy.settimeout_calls and spy.settimeout_calls[-1] is None
    finally:
        a.close()
        b.close()


class _NoClock:
    """A ``time`` module whose clock fails the test when read."""

    sleep = staticmethod(time.sleep)

    @staticmethod
    def monotonic():
        raise AssertionError("a receive path read the clock")


def test_recv_paths_read_no_clock_with_the_knob_off(monkeypatch):
    a, b = socket.socketpair()
    sa, sb = tpt.make_transport_pair()
    try:
        monkeypatch.setattr(su, "time", _NoClock)
        monkeypatch.setattr(tpt, "time", _NoClock)
        monkeypatch.setattr(cpu_backend, "time", _NoClock)
        assert cpu_backend._deadline(
            type("E", (), {"collective_timeout": 0.0})()) is None
        b.sendall(su.HEADER.pack(su.TAG_DATA, 4) + b"wxyz")
        tcp = tpt.TcpTransport(a, peer=1)
        assert cpu_backend._recv(tcp, None, 1) == b"wxyz"
        tcp.sender.close(timeout=1.0)
        monkeypatch.undo()
        t = sb.send(np.arange(4, dtype=np.float32))
        sb.wait(t, 5.0)
        monkeypatch.setattr(tpt, "time", _NoClock)
        monkeypatch.setattr(cpu_backend, "time", _NoClock)
        out = np.zeros(4, np.float32)
        cpu_backend._recv_into(sa, out, None, 1)
        assert out.tolist() == [0.0, 1.0, 2.0, 3.0]
    finally:
        monkeypatch.undo()
        a.close()
        b.close()
        sa.close(timeout=1.0)
        sb.close(timeout=1.0)


def test_recv_into_knob_off_allocates_nothing():
    import gc
    import tracemalloc

    a, b = socket.socketpair()
    try:
        payload = b"x" * 64
        view = memoryview(bytearray(64))
        b.sendall(payload)
        su.recv_exact_into(a, view)
        gc.collect()
        tracemalloc.start()
        before = tracemalloc.get_traced_memory()[0]
        for _ in range(100):
            b.sendall(payload)
            su.recv_exact_into(a, view)
        after = tracemalloc.get_traced_memory()[0]
        tracemalloc.stop()
        assert after - before < 512, (before, after)
    finally:
        a.close()
        b.close()


def _gang_of_two(monkeypatch, env):
    """Two ``PyEngine`` ranks in this process (one host), with ``env``;
    returns (engines, the threads they started, the control frames sent:
    (tag, payload))."""
    from horovod_tpu_torch import runtime_py
    from horovod_tpu_torch.runner.http_server import RendezvousServer

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    frames = []
    real_send = su.send_frame

    def spy(sock, tag, payload):
        frames.append((tag, bytes(payload)))
        return real_send(sock, tag, payload)

    monkeypatch.setattr(su, "send_frame", spy)
    server = RendezvousServer("127.0.0.1")
    port = server.start()
    before = set(threading.enumerate())
    engines = {}

    def start(r):
        engines[r] = runtime_py.PyEngine(r, 2, r, 2, 0, 1, "127.0.0.1",
                                         port)

    ts = [threading.Thread(target=start, args=(r,)) for r in (0, 1)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    server.stop()
    started = [t for t in set(threading.enumerate()) - before
               if t not in ts]
    return engines, started, frames


def _drive(engines):
    x = np.arange(6, dtype=np.float32)
    for i in range(3):
        hs = {r: e.allreduce_async(f"pin.{i}", x, op=ReduceOp.SUM)
              for r, e in engines.items()}
        for r, e in engines.items():
            np.testing.assert_array_equal(e.synchronize(hs[r]), 2 * x)


def _stop(engines):
    ts = [threading.Thread(target=e.shutdown) for e in engines.values()]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)


@pytest.mark.timeout(120)
def test_knobs_off_frames_and_threads_pin(monkeypatch):
    """Knobs off: the control frames are request and response lists, each
    the bytes the JAX codecs give for its decoding; knobs on (liveness and
    deadlines): not one thread more."""
    from horovod_tpu.common import wire as jwire

    for k in ("HVD_HEARTBEAT_TIMEOUT", "HOROVOD_HEARTBEAT_TIMEOUT",
              "HVD_COLLECTIVE_TIMEOUT", "HVD_CTRL_TREE", "HVD_TIMELINE",
              "HVD_WIRE_CRC", "HOROVOD_FAULT_PLAN"):
        monkeypatch.delenv(k, raising=False)
    engines, threads_off, frames = _gang_of_two(monkeypatch, {})
    try:
        _drive(engines)
        assert all(e._tree_parent is None and not e._tree_children
                   for e in engines.values())
    finally:
        _stop(engines)
    assert {t for t, _ in frames} == {su.TAG_REQUEST_LIST,
                                      su.TAG_RESPONSE_LIST}, frames
    for tag, payload in frames:
        if tag == su.TAG_REQUEST_LIST:
            reqs, shutdown, hits, epoch = jwire.decode_request_list(payload)
            again = jwire.encode_request_list(reqs, shutdown=shutdown,
                                              cache_hits=hits, epoch=epoch)
        else:
            resps, shutdown, pos, resend, params, epoch = \
                jwire.decode_response_list(payload)
            again = jwire.encode_response_list(
                resps, shutdown=shutdown, hit_positions=pos,
                resend_names=resend, params=params, epoch=epoch)
        assert again == payload
    monkeypatch.undo()
    engines, threads_on, _ = _gang_of_two(monkeypatch, {
        "HVD_HEARTBEAT_TIMEOUT": "2.0", "HVD_COLLECTIVE_TIMEOUT": "5"})
    try:
        _drive(engines)
    finally:
        _stop(engines)
    assert sorted(t.name.split("-")[0] for t in threads_on) == \
        sorted(t.name.split("-")[0] for t in threads_off)
    assert len(threads_on) == len(threads_off)


# ---------------------------------------------------------------------------
# send waits, dials, helpers
# ---------------------------------------------------------------------------


def test_peersender_wait_times_out_on_stuck_ticket():
    a, b = socket.socketpair()
    ps = su.PeerSender(a, name="hvd-send-test")
    try:
        t0 = time.monotonic()
        with pytest.raises(TimeoutError,
                           match="send did not complete in time"):
            ps.wait(1, timeout=0.15)
        assert time.monotonic() - t0 < 2.0
    finally:
        ps.close(timeout=2.0)
        a.close()
        b.close()


def test_wait_send_wraps_timeout_as_hop_timeout():
    a, b = socket.socketpair()
    ps = su.PeerSender(a, name="hvd-send-test")
    try:
        ps.send(b"\x00" * (64 << 20))
        with pytest.raises(cpu_backend.HopTimeout) as ei:
            cpu_backend._wait_send(ps, 1, time.monotonic() + 0.2, peer=3)
        assert ei.value.peer == 3 and ei.value.phase == "send"
    finally:
        a.close()
        b.close()
        ps.close(timeout=5.0)


def test_wait_send_knob_off_uses_the_cap(monkeypatch):
    monkeypatch.setenv(env_util.SEND_WAIT_CAP_S, "0.15")
    a, b = socket.socketpair()
    ps = su.PeerSender(a, name="hvd-send-test")
    try:
        ps.send(b"\x00" * (64 << 20))
        t0 = time.monotonic()
        with pytest.raises(cpu_backend.HopTimeout):
            cpu_backend._wait_send(ps, 1, None, peer=1)
        assert time.monotonic() - t0 < 2.0
    finally:
        a.close()
        b.close()
        ps.close(timeout=5.0)


def test_connect_retry_never_passes_nonpositive_timeout(monkeypatch):
    seen = []

    def fake_create_connection(addr, timeout=None):
        seen.append(timeout)
        raise ConnectionRefusedError("nope")

    monkeypatch.setattr(su.socket, "create_connection",
                        fake_create_connection)
    with pytest.raises(ConnectionError, match="cannot connect"):
        su.connect_retry("127.0.0.1", 1, timeout=0.3, interval=0.01)
    assert seen and all(t is not None and 0 < t <= 5.0 for t in seen), seen


def test_deadline_helper_and_hop_timeout():
    assert cpu_backend._deadline(object()) is None

    class Eng:
        collective_timeout = 0.0

    assert cpu_backend._deadline(Eng()) is None
    Eng.collective_timeout = 1.5
    d = cpu_backend._deadline(Eng())
    assert 1.0 < d - time.monotonic() <= 1.6
    e = cpu_backend.HopTimeout(2, "recv")
    assert isinstance(e, TimeoutError) and e.peer == 2 and "rank 2" in str(e)


# ---------------------------------------------------------------------------
# codecs and knobs against the JAX package
# ---------------------------------------------------------------------------


def test_abort_codecs_byte_equal_to_jax_both_ways():
    from horovod_tpu.common import wire as jwire

    for args in (("allreduce.grad", 2, 7), ("x", -1, 0), ("ünï", 5, 1)):
        blob = wire.encode_abort_report(*args)
        assert blob == jwire.encode_abort_report(*args)
        assert jwire.decode_abort_report(blob) == args
        assert wire.decode_abort_report(blob) == args
    for args in ((True, 3.25, 1), (False, 0.0, 0)):
        blob = wire.encode_probe_ack(*args)
        assert blob == jwire.encode_probe_ack(*args)
        assert wire.decode_probe_ack(blob) == jwire.decode_probe_ack(blob) \
            == args
    for args, want in ((("t", [3, 1], 2), ("t", [1, 3], 2)),
                       (("t", [], 0), ("t", [], 0))):
        blob = wire.encode_abort_verdict(*args)
        assert blob == jwire.encode_abort_verdict(*args)
        assert wire.decode_abort_verdict(blob) == want
        assert jwire.decode_abort_verdict(blob) == want


@pytest.mark.parametrize("env", [
    {},
    {"HVD_HEARTBEAT_TIMEOUT": "2.0"},
    {"HOROVOD_HEARTBEAT_TIMEOUT": "8"},
    {"HVD_HEARTBEAT_TIMEOUT": "0.1", "HOROVOD_HEARTBEAT_TIMEOUT": "9"},
    {"HVD_HEARTBEAT_TIMEOUT": "2", "HVD_HEARTBEAT_INTERVAL": "0.3"},
    {"HVD_COLLECTIVE_TIMEOUT": "2.5"},
    {"HVD_COLLECTIVE_TIMEOUT": "-3"},
    {"HVD_COLLECTIVE_TIMEOUT": "10", "HVD_COLLECTIVE_PROBE_TIMEOUT": "2"},
    {"HVD_CTRL_TREE": "0", "HVD_CTRL_FANOUT": "2"},
    {"HVD_CTRL_TREE": "yes", "HVD_CTRL_FANOUT": "-1"},
])
def test_knob_defaults_match_jax(monkeypatch, env):
    """Each knob the way the JAX engine reads it
    (``horovod_tpu/runtime_py.py``'s ``PyEngine.__init__`` and
    ``horovod_tpu/utils/env.py``)."""
    from horovod_tpu.utils import env as jenv

    for k in ("HVD_HEARTBEAT_TIMEOUT", "HOROVOD_HEARTBEAT_TIMEOUT",
              "HVD_HEARTBEAT_INTERVAL", "HVD_COLLECTIVE_TIMEOUT",
              "HVD_COLLECTIVE_PROBE_TIMEOUT", "HVD_CTRL_TREE",
              "HVD_CTRL_FANOUT"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    hb = jenv.get_float(jenv.HEARTBEAT_TIMEOUT,
                        jenv.get_float("HOROVOD_HEARTBEAT_TIMEOUT", 0.0))
    ct = jenv.collective_timeout_s()
    want = (hb, jenv.get_float(jenv.HEARTBEAT_INTERVAL, max(0.05, hb / 4)),
            ct, jenv.get_float(jenv.COLLECTIVE_PROBE_TIMEOUT,
                               max(0.5, ct / 2)),
            jenv.ctrl_tree_on(), jenv.ctrl_fanout())
    hb_p = env_util.heartbeat_timeout_s()
    ct_p = env_util.collective_timeout_s()
    got = (hb_p, env_util.heartbeat_interval_s(hb_p), ct_p,
           env_util.collective_probe_timeout_s(ct_p),
           env_util.ctrl_tree_on(), env_util.ctrl_fanout())
    assert got == want


# ---------------------------------------------------------------------------
# gangs of three: a stalled rank, a corrupting rank
# ---------------------------------------------------------------------------

STALL_ENV = {"HVD_COLLECTIVE_TIMEOUT": str(TIMEOUT_S),
             "HVD_COLLECTIVE_PROBE_TIMEOUT": str(PROBE_S)}
# name: (packages by rank, the stall site, the gang's extra variables)
STALL_GANGS = {
    "tcp": (["port"] * 3, "sock.stall", {"HVD_SHM_DISABLE": "1"}),
    "shm": (["port"] * 3, "shm.stall", {}),
    "mixed_jax_coord": (["jax", "port", "port"], "shm.stall", {}),
    "mixed_port_coord": (["port", "jax", "jax"], "sock.stall",
                         {"HVD_SHM_DISABLE": "1"}),
}
CRC_VICTIM = 1


def _stall_env(rank, site, tl):
    env = {"TIMEOUT_SITE": site}
    if rank == 2:
        env["TIMEOUT_VICTIM"] = "1"
    if rank == 0:
        env["HVD_TIMELINE"] = tl
    return env


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    root = tmp_path_factory.mktemp("timeout_gangs")
    out = {}
    crc_env = dict(STALL_ENV, HVD_SHM_DISABLE="1", HVD_WIRE_CRC="1",
                   HVD_HOP_RETRIES="0")
    crc_rank_env = {
        0: {"HVD_TIMELINE": str(root / "crc" / "timeline.json")},
        CRC_VICTIM: {"TIMEOUT_VICTIM": "1", "TIMEOUT_FAULT": "corrupt",
                     # The corruptor never reports a timeout of its own:
                     # the verdict rests on the corruption's report.
                     "HVD_COLLECTIVE_TIMEOUT": "30",
                     "HVD_RECONNECT_TIMEOUT_S": "2"}}
    waves = ({"tcp": None, "shm": None, "crc": None},
             {"mixed_jax_coord": None, "mixed_port_coord": None})
    deadline = time.monotonic() + GANG_TIMEOUT
    for wave in waves:
        started = {}
        for name in wave:
            cwd = str(root / name)
            if name == "crc":
                started[name] = _start(["port"] * 3, "stall_steps", cwd,
                                       base_env=crc_env,
                                       rank_env=crc_rank_env)
                continue
            pkgs, site, extra = STALL_GANGS[name]
            tl = str(root / name / "timeline.json")
            started[name] = _start(
                pkgs, "stall_steps", cwd, base_env=dict(STALL_ENV, **extra),
                rank_env={r: _stall_env(r, site, tl) for r in range(3)})
        for name, gang in started.items():
            victim = CRC_VICTIM if name == "crc" else 2
            runs = _finish(gang, deadline, stalled=(victim,))
            with open(root / name / "timeline.json") as fh:
                timeline = fh.read()
            out[name] = (runs, timeline, [p.pid for p in gang[1]])
    return out


def _cte(out):
    m = re.search(r"CTE ranks=(\[[^\]]*\]) tensor=(\S+) dt=([\d.]+)", out)
    return (json.loads(m.group(1)), m.group(2), float(m.group(3))) \
        if m else None


@pytest.mark.timeout(300)
@pytest.mark.parametrize("name", list(STALL_GANGS))
def test_stalled_rank_one_agreed_abort(gangs, name):
    """Both survivors raise CollectiveTimeoutError([2]) for the same
    tensor within twice the timeout, after a full-gang step 0; the victim
    was still wedged when killed; the retained batch is each survivor's
    step-1 inputs; rank 0's timeline holds COLLECTIVE_ABORT."""
    runs, timeline, _ = gangs[name]
    v_code, v_out = runs[2]
    assert "(running when killed: True)" in v_out, v_out
    assert _cte(v_out) is None and dict(_steps(v_out)) == {0: 30.0}, v_out
    ctes = []
    for rank in (0, 1):
        code, out = runs[rank]
        assert code == 0, (name, rank, out)
        cte = _cte(out)
        assert cte is not None, (name, rank, out)
        ranks, tensor, dt = cte
        assert ranks == [2], (name, rank, cte)
        assert dt < 2.0 * TIMEOUT_S, (name, rank, cte)
        assert dict(_steps(out)) == {0: 30.0}, (name, rank, out)
        m = re.search(r"RETAINED (\d+) (\S+)", out)
        assert m and int(m.group(1)) >= 1 and m.group(2) == "True", out
        ctes.append(tensor)
    assert ctes[0] == ctes[1] and ctes[0].endswith(".s1"), ctes
    assert "COLLECTIVE_ABORT" in timeline, timeline[-2000:]


@pytest.mark.timeout(300)
def test_mixed_gangs_markers_equal_across_packages(gangs):
    """In each mixed gang the port survivor and the JAX survivor print the
    same markers: the JAX package's, in the same scenario."""
    for name in ("mixed_jax_coord", "mixed_port_coord"):
        runs = gangs[name][0]
        a, b = (_cte(runs[r][1]) for r in (0, 1))
        assert a and b and a[:2] == b[:2], (name, a, b)
        assert _steps(runs[0][1]) == _steps(runs[1][1])


@pytest.mark.timeout(300)
def test_corrupting_link_abort_names_the_corruptor(gangs):
    """Rank 1 corrupts every TCP data frame from step 1 on; with no
    retransmit budget its neighbour's link gives up at once, and the
    agreement names rank 1 alone."""
    runs, timeline, _ = gangs["crc"]
    for rank in (0, 2):
        code, out = runs[rank]
        assert code == 0, (rank, out)
        cte = _cte(out)
        assert cte is not None and cte[0] == [CRC_VICTIM], (rank, out)
        assert dict(_steps(out)) == {0: 30.0}, (rank, out)
    assert _cte(runs[CRC_VICTIM][1]) is None
    assert "COLLECTIVE_ABORT" in timeline


@pytest.mark.timeout(300)
def test_no_shm_segment_outlives_a_gang(gangs):
    for name, (runs, _, pids) in gangs.items():
        for pid in pids:
            assert not glob.glob(f"/dev/shm/hvd-shm-{pid}-*"), name
        for code, out in runs:
            assert "leaked shared_memory" not in out, (name, out)
