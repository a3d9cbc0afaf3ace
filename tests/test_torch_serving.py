"""The port's serving path (``horovod_tpu_torch/serving``) on the CPU.

* ``Scheduler``: the JAX package's cases (``tests/test_serving.py``):
  shapes refused, shedding at the queue's bound, FIFO packing and refill,
  the staleness ages, TTFT and the token tail, replay order, ``fail_all``,
  and the leader's ``adopt_shadow``; ``stats()`` has the JAX package's keys
  with telemetry off.
* ``FrontDoor``: ``/health``, ``/stats``, 404, typed shedding (400, 503,
  504, 500), the completion payload, and a follower forwarding to its
  leader (and answering 503 without one).
* ``DecodeEngine``: continuous batching (two slots, staggered lengths, so
  requests join mid-flight) gives every request the tokens of
  ``generate`` on it alone, bit for bit, and the JAX package's
  ``generate``'s.
* One process serving through ``FrontDoor`` + ``Scheduler`` +
  ``DecodeEngine`` with concurrent clients and :func:`_drive` (the twin of
  ``chip_smoke.py``'s ``_serve_drive``: the order of the JAX package's
  serving loop), against the same oracle: the analog of
  ``test_single_process_selftest_matches_generate``.
* ``DecodeEngine`` over ``{"tp": 2}`` in a two-process gloo gang: each rank
  holds half the heads of the cache; every step's logits (fp32, 1e-5 of
  the largest), tokens and cache shards against the JAX package's
  one-device ``prefill_request`` and ``decode_step``.

The model is fp32 (vocab 128, d_model 64, 2 layers, 4 heads, d_ff 128) with
the JAX init's matrices times 5, so that greedy tokens change from step to
step; weights cross over through ``models/convert.py``.
"""

import functools
import json
import threading
import time

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models import transformer as tfm
from horovod_tpu_torch.parallel.mesh import make_mesh
from horovod_tpu_torch.serving import (DecodeEngine, FrontDoor, QueueFull,
                                       Scheduler)

from test_torch_train_tp import join_gang, start_gang

MODEL = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, d_ff=128)
SCALE = 5.0
CACHE_LEN = 64
TP_TOL = 1e-5


# ---------------------------------------------------------------------------
# the model and the oracles
# ---------------------------------------------------------------------------


def _port_cfg():
    return tfm.TransformerConfig(max_seq_len=CACHE_LEN, remat=False,
                                 compute_dtype=torch.float32, **MODEL)


@functools.lru_cache(maxsize=None)
def _params():
    import jax
    import jax.numpy as jnp

    from horovod_tpu.models import transformer as jtfm

    cfg = jtfm.TransformerConfig(max_seq_len=CACHE_LEN, remat=False,
                                 compute_dtype=jnp.float32, **MODEL)
    params = jax.tree.map(np.asarray, jtfm.init(jax.random.PRNGKey(0), cfg))
    return jax.tree.map(lambda a: a * SCALE if a.ndim >= 2 else a, params)


def _model():
    model = tfm.Transformer(_port_cfg())
    model.load_state_dict(convert.params_from_jax(_params()))
    return model


def _jax_tokens(prompt, max_new):
    """The JAX package's ``generate`` on one request at the serving cache
    length."""
    import jax
    import jax.numpy as jnp

    from horovod_tpu.models import transformer as jtfm

    cfg = jtfm.TransformerConfig(max_seq_len=CACHE_LEN, remat=False,
                                 compute_dtype=jnp.float32, **MODEL)
    out = jtfm.generate(jax.tree.map(jnp.asarray, _params()),
                        jnp.asarray([prompt], jnp.int32), cfg,
                        max_new_tokens=max_new, cache_len=CACHE_LEN)
    return [int(t) for t in np.asarray(out)[0, len(prompt):]]


def _requests(n):
    """Distinct prompts and lengths, so that retirements stagger and
    admissions join mid-flight."""
    return [([3 + i, 14, 15, 9 * i % 128], 6 + 2 * (i % 3))
            for i in range(n)]


def _drive(scheduler, engine, stop):
    """One rank's serving loop (``chip_smoke.py``'s ``_serve_drive``, the
    order of the JAX package's ``serving/loop.py``): at each token boundary
    the admissions, a prefill of each (its first token emitted), one
    ``step()`` while a slot is live, its token for every live slot, and a
    slot retired when its request has its tokens.  Runs until ``stop`` is
    set and no work is left."""
    live = {}

    def emit(slot, token):
        scheduler.on_token(slot, token)
        live[slot] -= 1
        if live[slot] <= 0:
            engine.clear(slot)
            del live[slot]
            scheduler.complete(slot)

    while not (stop.is_set() and not scheduler.has_work()):
        admissions = scheduler.take_admissions()
        if not admissions and not live:
            time.sleep(0.001)
            continue
        for slot, req in admissions:
            live[slot] = req.max_new
            emit(slot, engine.prefill(slot, req.prompt))
        if live:
            toks = engine.step()
            for slot in sorted(live):
                emit(slot, int(toks[slot]))


# ---------------------------------------------------------------------------
# scheduler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prompt,max_new,match", [
    ([], 4, "non-empty"), ([1], 0, "max_new_tokens"),
    ([1, 2, 3], 14, "cache length"),
], ids=["empty", "max-new", "cache-len"])
def test_scheduler_refuses_unservable_shapes(prompt, max_new, match):
    s = Scheduler(max_batch=2, max_queue=4, cache_len=16)
    with pytest.raises(ValueError, match=match):
        s.submit(prompt, max_new)


def test_scheduler_sheds_at_queue_bound():
    s = Scheduler(max_batch=1, max_queue=2, cache_len=16)
    s.submit([1], 2)
    s.submit([2], 2)
    with pytest.raises(QueueFull):
        s.submit([3], 2)


def test_scheduler_fifo_packing_and_refill():
    s = Scheduler(max_batch=2, max_queue=8, cache_len=32)
    r1, r2, r3 = (s.submit([i], 4) for i in (1, 2, 3))
    assert [(slot, r.id) for slot, r in s.take_admissions()] == \
        [(0, r1.id), (1, r2.id)]
    assert r1.attempts == 1 and r3.attempts == 0
    assert s.take_admissions() == []  # batch full, r3 waits
    st = s.stats()
    assert {k: st[k] for k in ("queued", "active", "slots", "completed")} \
        == {"queued": 1, "active": 2, "slots": 2, "completed": 0}
    assert st["last_step_age_s"] == 0.0 and st["oldest_queued_age_s"] < 5.0
    s.on_token(0, 5)
    s.complete(0)
    assert r1.done.is_set() and r1.tokens == [5]
    assert [(slot, r.id) for slot, r in s.take_admissions()] == \
        [(0, r3.id)]
    assert s.stats()["completed"] == 1


def test_scheduler_stats_keys_are_the_jax_packages():
    from horovod_tpu.serving.scheduler import Scheduler as JaxScheduler

    a = Scheduler(max_batch=2, max_queue=4, cache_len=16)
    b = JaxScheduler(max_batch=2, max_queue=4, cache_len=16)
    for s in (a, b):
        s.submit([1], 2)
        s.take_admissions()
        s.submit([2], 2)
    sa, sb = a.stats(), b.stats()
    assert sorted(sa) == sorted(k for k in sb if not k.endswith("_ms"))
    assert {k: sa[k] for k in ("queued", "active", "slots", "completed")} \
        == {k: sb[k] for k in ("queued", "active", "slots", "completed")}


def test_scheduler_staleness_ages():
    s = Scheduler(max_batch=1, max_queue=4, cache_len=16)
    st = s.stats()
    assert st["last_step_age_s"] == 0.0 and st["oldest_queued_age_s"] == 0.0
    s.note_step(time.monotonic() - 5.0)
    assert 4.5 < s.stats()["last_step_age_s"] < 60.0
    r = s.submit([1], 2)
    r.t_submit = time.monotonic() - 2.0
    assert 1.5 < s.stats()["oldest_queued_age_s"] < 60.0


def test_scheduler_ttft_and_token_tail():
    s = Scheduler(max_batch=1, max_queue=2, cache_len=16)
    r = s.submit([1, 2], 3)
    s.take_admissions()
    assert r.t_first_token is None
    s.on_token(0, 7)
    assert r.t_first_token is not None
    s.on_token(0, 8)
    assert r.tokens == [7, 8]


def test_scheduler_requeue_inflight_replays_in_order():
    s = Scheduler(max_batch=2, max_queue=8, cache_len=32)
    r1, r2, r3 = (s.submit([i], 8) for i in (1, 2, 3))
    s.take_admissions()
    s.on_token(0, 9)
    s.on_token(1, 9)
    assert s.requeue_inflight() == 2
    assert r1.tokens == [] and r2.tokens == []
    assert [r.id for _, r in s.take_admissions()] == [r1.id, r2.id]
    assert r1.attempts == 2 and r3.attempts == 0
    assert s.requeue_inflight() == 2
    assert [r.id for _, r in s.take_admissions()] == [r1.id, r2.id]
    assert s.has_work()


def test_scheduler_fail_all_wakes_everyone():
    s = Scheduler(max_batch=1, max_queue=4, cache_len=16)
    active = s.submit([1], 4)
    s.take_admissions()
    queued = s.submit([2], 4)
    s.fail_all("gang gone")
    for r in (active, queued):
        assert r.done.is_set() and r.error == "gang gone"
    assert not s.has_work()


def test_scheduler_adopt_shadow_and_idempotent_ids():
    s = Scheduler(max_batch=2, max_queue=8, cache_len=32)
    known = s.submit([1], 4, req_id="a")
    assert s.submit([1], 4, req_id="a") is known  # re-POST joins
    n = s.adopt_shadow([(1, {"id": "c", "prompt": [3], "max_new": 2}),
                        (0, {"id": "b", "prompt": [2], "max_new": 5}),
                        (2, {"id": "a", "prompt": [1], "max_new": 4})])
    assert n == 2
    adm = s.take_admissions()
    assert [r.id for _, r in adm] == ["a", "b"]
    assert [r.attempts for _, r in adm] == [1, 2]  # the replay is attempt 2


@pytest.mark.parametrize("env,want", [
    ({}, (0, 8, 64)),
    ({"HVD_SERVE_PORT": "8100", "HVD_SERVE_MAX_BATCH": "3",
      "HVD_SERVE_MAX_QUEUE": "32"}, (8100, 3, 32)),
    ({"HVD_SERVE_PORT": "-1", "HVD_SERVE_MAX_BATCH": "0",
      "HVD_SERVE_MAX_QUEUE": "-5"}, (0, 1, 1)),
], ids=["defaults", "set", "floors"])
def test_serve_env_accessors_are_the_jax_packages(monkeypatch, env, want):
    from horovod_tpu.utils import env as jenv

    from horovod_tpu_torch.utils import env as penv

    for var in (penv.SERVE_PORT, penv.SERVE_MAX_BATCH, penv.SERVE_MAX_QUEUE):
        monkeypatch.delenv(var, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for m in (penv, jenv):
        assert (m.serve_port(), m.serve_max_batch(),
                m.serve_max_queue()) == want


# ---------------------------------------------------------------------------
# front door
# ---------------------------------------------------------------------------


def _http(port, method, path, body=None, timeout=10.0):
    import http.client

    c = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        c.request(method, path,
                  json.dumps(body) if body is not None else None)
        r = c.getresponse()
        return r.status, r.read()
    finally:
        c.close()


@pytest.fixture
def door():
    doors = []

    def make(scheduler, **kw):
        d = FrontDoor(scheduler, host="127.0.0.1", port=0,
                      **{"timeout_s": 5.0, **kw})
        d.start()
        doors.append(d)
        return d

    yield make
    for d in doors:
        d.stop()


@pytest.mark.timeout(60)
def test_front_door_health_stats_and_shed(door):
    s = Scheduler(max_batch=2, max_queue=1, cache_len=16)
    port = door(s).port
    assert _http(port, "GET", "/health") == (200, b"ok")
    code, body = _http(port, "GET", "/stats")
    assert code == 200 and json.loads(body)["slots"] == 2
    assert json.loads(body)["role"] == "leader"
    assert _http(port, "GET", "/nope")[0] == 404
    assert _http(port, "POST", "/nope", {})[0] == 404
    for bad in ({"nope": 1}, {"prompt": [], "max_new_tokens": 4},
                {"prompt": [1], "id": ""}, {"prompt": ["x"]}):
        assert _http(port, "POST", "/generate", bad)[0] == 400, bad
    # A full admission queue sheds with 503: the first request parks.
    t = threading.Thread(target=_http, args=(
        port, "POST", "/generate", {"prompt": [1], "max_new_tokens": 2}),
        daemon=True)
    t.start()
    deadline = time.monotonic() + 5.0
    while s.stats()["queued"] < 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    code, body = _http(port, "POST", "/generate",
                       {"prompt": [2], "max_new_tokens": 2})
    assert code == 503, body
    s.fail_all("test over")
    t.join(timeout=10)
    assert not t.is_alive()


@pytest.mark.timeout(60)
@pytest.mark.parametrize("outcome,code", [("timeout", 504),
                                          ("fail", 500)])
def test_front_door_answers_a_lost_request(door, outcome, code):
    s = Scheduler(max_batch=1, max_queue=4, cache_len=16)
    port = door(s, timeout_s=0.5 if outcome == "timeout" else 10.0).port
    if outcome == "fail":
        threading.Timer(0.3, s.fail_all, ("engine gone",)).start()
    status, body = _http(port, "POST", "/generate",
                         {"prompt": [1], "max_new_tokens": 2, "id": "q"})
    assert status == code
    assert json.loads(body)["id"] == "q"


def _complete_next(s, tokens):
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        for slot, _ in s.take_admissions():
            for tok in tokens:
                s.on_token(slot, tok)
            s.complete(slot)
            return
        time.sleep(0.01)


@pytest.mark.timeout(60)
def test_front_door_completion_payload(door):
    s = Scheduler(max_batch=1, max_queue=4, cache_len=16)
    port = door(s, timeout_s=10.0).port
    threading.Thread(target=_complete_next, args=(s, (4, 5, 6)),
                     daemon=True).start()
    code, body = _http(port, "POST", "/generate",
                       {"prompt": [1, 2], "max_new_tokens": 3})
    assert code == 200
    out = json.loads(body)
    assert out["tokens"] == [4, 5, 6] and out["attempts"] == 1
    assert out["ttft_ms"] is not None and out["latency_ms"] >= 0


@pytest.mark.timeout(60)
def test_follower_forwards_to_the_leader(door):
    s = Scheduler(max_batch=1, max_queue=4, cache_len=16)
    leader = door(s, timeout_s=10.0)
    addr = f"127.0.0.1:{leader.port}"
    follower = door(None, leader_addr_fn=lambda refresh=False: addr)
    code, body = _http(follower.port, "GET", "/stats")
    assert json.loads(body) == {"role": "follower", "leader": addr}
    threading.Thread(target=_complete_next, args=(s, (7, 8)),
                     daemon=True).start()
    code, body = _http(follower.port, "POST", "/generate",
                       {"prompt": [1], "max_new_tokens": 2})
    assert code == 200 and json.loads(body)["tokens"] == [7, 8]
    # The leader's verdict is relayed.
    assert _http(follower.port, "POST", "/generate", {"prompt": []})[0] \
        == 400
    # No leader known: the retryable 503.
    orphan = door(None)
    code, body = _http(orphan.port, "POST", "/generate", {"prompt": [1]})
    assert code == 503 and b"leader unreachable" in body


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def oracle():
    """Each request's tokens from the JAX package's ``generate`` alone."""
    return {tuple(p): _jax_tokens(p, m) for p, m in _requests(6)}


def test_engine_continuous_batching_equals_generate(oracle):
    model = _model()
    engine = DecodeEngine(model, _port_cfg(), max_batch=2,
                          cache_len=CACHE_LEN, device="cpu")
    assert engine.ks.shape == (2, 2, CACHE_LEN, 4, 16)
    s = Scheduler(max_batch=2, max_queue=8, cache_len=CACHE_LEN)
    reqs = [s.submit(p, m) for p, m in _requests(6)]
    stop = threading.Event()
    stop.set()  # drain what is queued, then return
    _drive(s, engine, stop)
    for r in reqs:
        alone = tfm.generate(model, [r.prompt], max_new_tokens=r.max_new,
                             cache_len=CACHE_LEN, device="cpu")
        assert r.tokens == alone[0, len(r.prompt):].tolist(), r.id
        assert r.tokens == oracle[tuple(r.prompt)], r.id
    assert len({t for r in reqs for t in r.tokens}) > 10  # tokens vary


def test_engine_slot_independence_and_clamp():
    engine = DecodeEngine(_model(), _port_cfg(), max_batch=3,
                          cache_len=CACHE_LEN, device="cpu")

    def decode(neighbours):
        for slot in range(3):
            engine.clear(slot)
        toks = [engine.prefill(0, [5, 6, 7])]
        for slot, p in enumerate(neighbours, start=1):
            engine.prefill(slot, p)
        logits = []
        for _ in range(6):
            toks.append(int(engine.step()[0]))
            logits.append(engine.logits[0].clone())
        return toks, logits

    a, la = decode([])
    b, lb = decode([[1] * 20, [9, 8]])
    assert a == b and all(torch.equal(x, y) for x, y in zip(la, lb))
    with torch.inference_mode():  # the engine's vectors are inference
        engine.pos[:] = CACHE_LEN - 1  # idle slots parked at the end
    engine.step()
    assert engine.pos.tolist() == [CACHE_LEN - 1] * 3


def test_engine_refuses_moe():
    cfg = tfm.TransformerConfig(vocab_size=16, d_model=16, n_layers=1,
                                n_heads=2, d_ff=16, n_experts=2)
    with pytest.raises(NotImplementedError, match="dense-FFN"):
        DecodeEngine(tfm.init(0, cfg, device="cpu"), cfg, max_batch=2,
                     device="cpu")


@pytest.mark.timeout(120)
def test_one_process_serves_the_oracles_tokens(oracle, door):
    """FrontDoor + Scheduler + DecodeEngine in this process, concurrent
    clients, and the loop twin in its own thread."""
    engine = DecodeEngine(_model(), _port_cfg(), max_batch=2,
                          cache_len=CACHE_LEN, device="cpu")
    s = Scheduler(max_batch=2, max_queue=16, cache_len=CACHE_LEN)
    port = door(s, timeout_s=60.0).port
    stop = threading.Event()
    stepper = threading.Thread(target=_drive, args=(s, engine, stop))
    stepper.start()
    reqs = _requests(6)
    results = [None] * len(reqs)

    def client(i, prompt, max_new):
        results[i] = _http(port, "POST", "/generate",
                           {"prompt": prompt, "max_new_tokens": max_new},
                           timeout=60.0)

    clients = [threading.Thread(target=client, args=(i, p, m))
               for i, (p, m) in enumerate(reqs)]
    for c in clients:
        c.start()
    for c in clients:
        c.join(timeout=60)
    stop.set()
    stepper.join(timeout=30)
    assert not stepper.is_alive()
    for (p, m), (code, body) in zip(reqs, results):
        assert code == 200, body
        assert json.loads(body)["tokens"] == oracle[tuple(p)]
    assert s.stats()["completed"] == len(reqs)


# ---------------------------------------------------------------------------
# the engine over tp, in a gloo gang
# ---------------------------------------------------------------------------


TP_PROMPTS = ([3, 14, 15], [9, 2, 6, 5, 35, 8, 97], [1] * 12)
TP_STEPS = 5


def _tp_worker(rank, size, store, params_path, out_dir):
    torch.set_num_threads(1)
    hvd.init(rank=rank, size=size, device="cpu",
             init_method=f"file://{store}")
    try:
        d = np.load(params_path)
        tree = {"embed": d["embed"], "ln_f": d["ln_f"],
                "layers": {k[7:]: v for k, v in d.items()
                           if k.startswith("layers.")}}
        mesh = make_mesh({"tp": size})
        cfg = _port_cfg()
        model = tfm.Transformer(cfg, mesh)
        model.load_state_dict(convert.params_from_jax(tree, mesh=mesh))
        engine = DecodeEngine(model, cfg, max_batch=len(TP_PROMPTS),
                              cache_len=CACHE_LEN, mesh=mesh, device="cpu")
        first = [engine.prefill(i, p) for i, p in enumerate(TP_PROMPTS)]
        toks, logits = [], []
        for _ in range(TP_STEPS):
            toks.append(engine.step())
            logits.append(engine.logits.numpy())
        np.savez(f"{out_dir}/rank{rank}.npz", first=np.array(first),
                 toks=np.stack(toks), logits=np.stack(logits),
                 ks=engine.ks.numpy(), vs=engine.vs.numpy(),
                 tp_index=mesh.coords["tp"])
    finally:
        hvd.shutdown()


@pytest.fixture(scope="module")
def tp_gang(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve_tp_gang")
    p = _params()
    np.savez(d / "params.npz", embed=p["embed"], ln_f=p["ln_f"],
             **{f"layers.{k}": v for k, v in p["layers"].items()})
    ctx = start_gang(_tp_worker, 2, (2, str(d / "store"),
                                     str(d / "params.npz"), str(d)))
    join_gang(ctx, timeout=120.0)
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(2)]


@pytest.mark.timeout(180)
def test_engine_over_tp_matches_jax_decode_step(tp_gang):
    import jax
    import jax.numpy as jnp

    from horovod_tpu.models import transformer as jtfm

    cfg = jtfm.TransformerConfig(max_seq_len=CACHE_LEN, remat=False,
                                 compute_dtype=jnp.float32, **MODEL)
    jp = jax.tree.map(jnp.asarray, _params())
    ks, vs, first = [], [], []
    for p in TP_PROMPTS:
        lg, k, v = jtfm.prefill_request(jp, jnp.asarray(p, jnp.int32), cfg,
                                        CACHE_LEN)
        ks.append(k)
        vs.append(v)
        first.append(int(jnp.argmax(lg)))
    ks, vs = jnp.concatenate(ks, 1), jnp.concatenate(vs, 1)
    tok = jnp.asarray(first, jnp.int32)
    pos = jnp.asarray([len(p) for p in TP_PROMPTS], jnp.int32)
    step = jax.jit(functools.partial(jtfm.decode_step, cfg=cfg))
    want_toks, want_logits = [], []
    for _ in range(TP_STEPS):
        lg, ks, vs = step(jp, tok, pos, ks, vs)
        tok = jnp.argmax(lg, -1).astype(jnp.int32)
        pos = pos + 1
        want_toks.append(np.asarray(tok))
        want_logits.append(np.asarray(lg))
    want_logits = np.stack(want_logits)
    heads = MODEL["n_heads"] // 2
    for out in tp_gang:
        assert out["first"].tolist() == first
        assert out["toks"].tolist() == np.stack(want_toks).tolist()
        gap = np.abs(out["logits"] - want_logits).max() / \
            np.abs(want_logits).max()
        assert gap <= TP_TOL, gap
        i = int(out["tp_index"])
        for got, want in ((out["ks"], ks), (out["vs"], vs)):
            assert got.shape[3] == heads
            want = np.asarray(want)[:, :, :, i * heads:(i + 1) * heads]
            assert np.abs(got - want).max() <= TP_TOL * np.abs(want).max()
