"""The collective watch (``horovod_tpu_torch/parallel/group_watch.py``) on
the CPU, with no CUDA: stand-in handles whose ``query()`` the test sets.

* A handle still pending at the deadline fires ``on_expired`` once, with
  its group's ranks, and the watch takes no handle after it.
* Handles that complete never fire, and leave the queue (a reusable one
  for reuse).
* ``stop()`` ends the thread and drops the handles and the callback; a
  watch that fired releases no handle on its own thread.
* Through ``hvd.init``: an elastic rank of an NCCL group (modelled by a
  one-rank gloo group that ``init_process_group`` forms for ``nccl``)
  arms one watch an incarnation; ``hvd.shutdown()`` and a re-form stop
  and clear it, and leave nothing that holds the handles.
* Once the watch fired, the groups are aborted naming its group, and the
  next collective and the serving engine's check after its host copy
  raise ``GroupAbortedError`` carrying that group's ranks.
"""

import gc
import threading
import time
import weakref

import pytest
import torch
import torch.distributed as dist

import horovod_tpu_torch as hvd
from horovod_tpu_torch import basics
from horovod_tpu_torch.models import transformer as tfm
from horovod_tpu_torch.ops import collective as C
from horovod_tpu_torch.parallel import group_watch as gw
from horovod_tpu_torch.parallel.mesh import GroupAbortedError, make_mesh
from horovod_tpu_torch.serving import DecodeEngine

DEADLINE = 0.3


class Handle:
    """A collective's stand-in: pending until ``done`` is set."""

    def __init__(self, done=False):
        self.done = done
        self.queries = 0

    def query(self):
        self.queries += 1
        return self.done


def _recorder():
    calls = []
    fired = threading.Event()

    def on_expired(ranks, age_s):
        calls.append((ranks, age_s, threading.current_thread().name))
        fired.set()

    return calls, fired, on_expired


def test_pending_handle_fires_once_with_its_ranks():
    calls, fired, on_expired = _recorder()
    w = gw.GroupWatch(DEADLINE, on_expired)
    try:
        done = Handle(done=True)
        stuck = Handle()
        t0 = time.monotonic()
        w.add(done, (0, 1, 2, 3))
        w.add(stuck, (0, 1))
        w.add(Handle(), (2, 3))  # behind the stuck one: never reached
        assert fired.wait(5.0)
        waited = time.monotonic() - t0
        assert DEADLINE <= waited < DEADLINE + 1.0
        time.sleep(3 * DEADLINE)  # and no second firing
        assert [(r, n) for r, _, n in calls] == [((0, 1), "hvd-group-watch")]
        assert calls[0][1] >= DEADLINE
        assert w.fired == (0, 1) and w.fired_age_s == calls[0][1]
        # The thread ended; it released nothing (stop() does).
        assert not w._thread.is_alive() and w.pending() == 2
        w.add(Handle(), (0, 1))  # after the firing: not watched
        assert w.pending() == 2
    finally:
        w.stop()
    assert w.pending() == 0


def test_completed_handles_never_fire():
    calls, _fired, on_expired = _recorder()
    w = gw.GroupWatch(DEADLINE, on_expired)
    try:
        handles = [Handle() for _ in range(20)]
        for h in handles:
            w.add(h, (0, 1))
        time.sleep(DEADLINE / 3)
        for h in handles:
            h.done = True  # each completes well before the deadline
        deadline = time.monotonic() + 5.0
        while w.pending() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert w.pending() == 0
        time.sleep(2 * DEADLINE)
        assert calls == [] and w.fired is None and w._thread.is_alive()
        assert all(h.queries >= 1 for h in handles)
    finally:
        w.stop()
    assert not w._thread.is_alive()


def test_stop_ends_the_thread_and_drops_every_reference():
    calls, _fired, on_expired = _recorder()
    w = gw.GroupWatch(DEADLINE, on_expired)
    h = Handle()
    ref = weakref.ref(h)
    w.add(h, (0, 1))
    thread = w._thread
    assert thread.is_alive()
    w.stop()
    assert not thread.is_alive() and w.pending() == 0
    assert w._on_expired is None
    del h
    gc.collect()
    assert ref() is None
    time.sleep(2 * DEADLINE)
    assert calls == []
    w.add(Handle(), (0, 1))  # a stopped watch takes nothing
    assert w.pending() == 0 and w._thread is thread


class Tracked(Handle):
    """A handle that notes which thread released it."""

    released = []

    def __del__(self):
        Tracked.released.append(threading.current_thread().name)


def test_fired_watch_releases_no_handle_on_its_own_thread():
    """At the deadline the watch's thread releases no handle (a CUDA
    event's release can wait behind the host copy that the stalled
    collective holds): the abort's stop hands them on, and the next
    disarm on another thread releases them."""
    Tracked.released = []

    def on_expired(ranks, age_s):
        gw.disarm()  # what the abort does, on the watch's thread

    w = gw.arm(DEADLINE, on_expired, torch.device("cpu"))
    for done in (True, False, False):
        w.add(Tracked(done=done), (0, 1), reusable=True)
    deadline = time.monotonic() + 5.0
    while w._thread.is_alive() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert w.fired == (0, 1) and gw.current() is None
    gc.collect()
    assert Tracked.released == []
    assert len(gw._retired) == 3
    gw.disarm()  # this thread's
    gc.collect()
    assert Tracked.released == ["MainThread"] * 3 and gw._retired == []


def test_completed_handles_are_reused():
    w = gw.GroupWatch(DEADLINE, lambda ranks, age: None)
    try:
        a, b = Handle(done=True), Handle()
        w.add(a, (0, 1), reusable=True)
        w.add(b, (0, 1))  # not reusable: dropped once complete
        b.done = True
        deadline = time.monotonic() + 5.0
        while w.pending() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert w.reuse() is a and w.reuse() is None
    finally:
        w.stop()


def test_poll_interval_and_deadline():
    assert gw.poll_interval_s(20.0) == 0.1
    assert gw.poll_interval_s(1.0) == 0.02
    assert gw.poll_interval_s(0.01) == 0.005
    with pytest.raises(ValueError, match="deadline"):
        gw.GroupWatch(0.0, lambda ranks, age: None)


@pytest.fixture
def nccl_rank(monkeypatch):
    """``hvd.init`` as an elastic rank of a one-rank NCCL group, which a
    stand-in ``init_process_group`` forms over gloo (``_world.backend``
    stays ``nccl``), under a collective deadline of DEADLINE."""
    real_init = dist.init_process_group

    def init_process_group(backend, *a, **k):
        return real_init("gloo" if backend == "nccl" else backend, *a, **k)

    monkeypatch.setattr(dist, "init_process_group", init_process_group)
    monkeypatch.setenv("HVD_ELASTIC_EPOCH", "0")
    monkeypatch.setenv("HVD_COLLECTIVE_TIMEOUT", str(DEADLINE))
    for var in ("HVD_RANK", "HVD_SIZE", "HVD_RENDEZVOUS_ADDR", "RANK",
                "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert not basics.is_initialized()

    def init():
        hvd.init(device="cpu", backend="nccl")
        assert basics._world.backend == "nccl"

    yield init
    hvd.shutdown()
    assert gw.current() is None


def test_init_arms_one_watch_and_shutdown_or_reform_clears_it(nccl_rank):
    nccl_rank()
    first = gw.current()
    assert first is not None and first.deadline_s == DEADLINE
    h = Handle(done=True)
    gw.current().add(h, (0,))
    ref = weakref.ref(h)
    thread = first._thread
    assert thread.is_alive()
    gw.record((0,))  # no card: nothing recorded
    assert first.pending() <= 1
    hvd.shutdown()  # the re-form's teardown
    assert gw.current() is None and not thread.is_alive()
    assert first.pending() == 0 and first._on_expired is None
    del h
    gc.collect()
    assert ref() is None
    nccl_rank()  # the next incarnation: a watch of its own
    second = gw.current()
    assert second is not None and second is not first
    assert second.fired is None and second.pending() == 0


def test_no_watch_without_nccl_or_deadline(monkeypatch):
    monkeypatch.setenv("HVD_ELASTIC_EPOCH", "0")
    monkeypatch.setenv("HVD_COLLECTIVE_TIMEOUT", str(DEADLINE))
    for var in ("HVD_RANK", "HVD_SIZE", "HVD_RENDEZVOUS_ADDR"):
        monkeypatch.delenv(var, raising=False)
    hvd.init(device="cpu")  # gloo: its collectives fail at the timeout
    try:
        assert gw.current() is None
    finally:
        hvd.shutdown()


def test_fired_watch_aborts_and_collectives_raise_its_ranks(nccl_rank):
    nccl_rank()
    cfg = tfm.TransformerConfig(vocab_size=32, d_model=16, n_layers=1,
                                n_heads=2, d_ff=32, max_seq_len=16,
                                compute_dtype=torch.float32, remat=False)
    torch.manual_seed(0)
    mesh = make_mesh({"tp": 1})
    engine = DecodeEngine(tfm.Transformer(cfg), cfg, max_batch=2,
                          cache_len=16, mesh=mesh, device="cpu")
    engine.prefill(0, [3, 4, 5])
    engine.step()  # a healthy step: no abort
    x = C.allreduce(torch.ones(4), op=hvd.Sum)
    assert torch.equal(x, torch.ones(4))
    # A collective of the group [0, 1] (a stand-in: this gang has one
    # rank) never completes.
    gw.current().add(Handle(), (0, 1))
    deadline = time.monotonic() + 5.0
    while (basics.group_aborted() is None or gw.current() is not None) \
            and time.monotonic() < deadline:
        time.sleep(0.01)
    reason = basics.group_aborted()
    assert reason is not None and "[0, 1]" in reason and \
        "collective deadline" in reason
    assert basics.group_aborted_ranks() == (0, 1)
    assert gw.current() is None  # the abort stopped the watch
    with pytest.raises(GroupAbortedError) as e:
        C.allreduce(torch.ones(4), op=hvd.Sum)
    assert e.value.group_ranks == (0, 1)
    # The serving engine's check after its host copy.
    with pytest.raises(GroupAbortedError) as e:
        engine._host(torch.zeros(2))
    assert e.value.group_ranks == (0, 1)
    with pytest.raises(GroupAbortedError) as e:
        engine.step()
    assert e.value.group_ranks == (0, 1)
    # The abort runs once: a second call is a no-op.
    assert basics.abort_process_groups("again", ranks=(0,)) is False
    assert basics.group_aborted_ranks() == (0, 1)
