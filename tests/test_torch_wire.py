"""The port's control-message codec and response cache against the JAX
package's.

* The same random ``Request`` and ``Response`` lists (every request and
  response type, every dtype and op, process sets, cache hits, resends,
  the autotuner's knob broadcast, the shutdown bit and the epoch trailer),
  built from a seed in both packages, encode to identical bytes, and each
  package decodes the other's frames to the same messages.
* The response cache gives the same positions, evictions, hits and
  ``stats()`` under the same sequence of puts, classifications and
  touches.
* The process-set ids (a hash of the member ranks) are the JAX package's.
"""

import numpy as np
import pytest

from horovod_tpu.common import response_cache as jrc
from horovod_tpu.common import types as jt
from horovod_tpu.common import wire as jw
from horovod_tpu import process_sets as jps

from horovod_tpu_torch.common import response_cache as prc
from horovod_tpu_torch.common import types as pt
from horovod_tpu_torch.common import wire as pw
from horovod_tpu_torch import process_sets as pps

NAMES = ["grad.w", "grad.b", "layers.0.wq", "emb", "x", "ünï/cødé", ""]


def _shape(rng):
    return [int(d) for d in rng.integers(0, 9, rng.integers(0, 4))]


def _request(types, rng):
    return types.Request(
        request_rank=int(rng.integers(0, 64)),
        request_type=types.RequestType(int(rng.integers(0, 7))),
        tensor_type=types.DataType(int(rng.integers(0, 13))),
        tensor_name=str(rng.choice(NAMES)) + str(rng.integers(0, 5)),
        root_rank=int(rng.integers(-1, 8)),
        device=str(rng.choice(["cpu", "cuda:0"])),
        tensor_shape=types.TensorShape(_shape(rng)),
        reduce_op=types.ReduceOp(int(rng.integers(0, 6))),
        prescale_factor=float(rng.choice([1.0, 0.5, 1 / 3, 2.0])),
        postscale_factor=float(rng.choice([1.0, 0.125, 3.7])),
        process_set_id=int(rng.choice([0, 1, 2147483647])),
        process_set_size=int(rng.integers(0, 5)))


def _response(types, rng):
    n = int(rng.integers(0, 4))
    return types.Response(
        response_type=types.ResponseType(int(rng.integers(0, 9))),
        tensor_names=[str(rng.choice(NAMES)) for _ in range(n)],
        error_message=str(rng.choice(["", "Mismatched data types"])),
        devices=[str(rng.choice(["cpu", "cuda:1"]))
                 for _ in range(int(rng.integers(0, 3)))],
        tensor_type=types.DataType(int(rng.integers(0, 13))),
        tensor_sizes=[int(x) for x in rng.integers(-2, 1 << 40,
                                                   rng.integers(0, 5))],
        reduce_op=types.ReduceOp(int(rng.integers(0, 6))),
        prescale_factor=float(rng.choice([1.0, 0.25])),
        postscale_factor=float(rng.choice([1.0, 1e-3])),
        tensor_shapes=[types.TensorShape(_shape(rng)) for _ in range(n)],
        process_set_id=int(rng.choice([0, 7])))


def _request_frame(types, wire, seed):
    rng = np.random.default_rng(seed)
    reqs = [_request(types, rng) for _ in range(int(rng.integers(0, 6)))]
    hits = [(str(rng.choice(NAMES)), int(rng.integers(0, 1 << 20)))
            for _ in range(int(rng.integers(0, 4)))]
    return wire.encode_request_list(
        reqs, shutdown=bool(rng.integers(0, 2)), cache_hits=hits,
        epoch=int(rng.choice([0, 1, 4294967295])))


def _response_frame(types, wire, seed):
    rng = np.random.default_rng(seed)
    resps = [_response(types, rng) for _ in range(int(rng.integers(0, 5)))]
    params = None
    if rng.integers(0, 2):
        params = (int(rng.integers(0, 1 << 30)), float(rng.random()),
                  bool(rng.integers(0, 2)), bool(rng.integers(0, 2)),
                  bool(rng.integers(0, 2)), int(rng.integers(0, 1 << 20)))
    return wire.encode_response_list(
        resps, shutdown=bool(rng.integers(0, 2)),
        hit_positions=[int(x) for x in rng.integers(0, 1 << 20,
                                                    rng.integers(0, 5))],
        resend_names=[str(rng.choice(NAMES))
                      for _ in range(int(rng.integers(0, 3)))],
        params=params, epoch=int(rng.choice([0, 3])))


def _plain(x):
    """A decoded message tree with enums as ints, comparable across the
    packages."""
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if hasattr(x, "__dataclass_fields__"):
        return {k: _plain(getattr(x, k)) for k in x.__dataclass_fields__}
    if isinstance(x, int) and not isinstance(x, bool):
        return int(x)
    return x


@pytest.mark.parametrize("seed", range(40))
def test_request_lists_are_byte_identical(seed):
    port = _request_frame(pt, pw, seed)
    jax = _request_frame(jt, jw, seed)
    assert port == jax
    assert _plain(pw.decode_request_list(jax)) == \
        _plain(jw.decode_request_list(port))


@pytest.mark.parametrize("seed", range(40))
def test_response_lists_are_byte_identical(seed):
    port = _response_frame(pt, pw, seed)
    jax = _response_frame(jt, jw, seed)
    assert port == jax
    assert _plain(pw.decode_response_list(jax)) == \
        _plain(jw.decode_response_list(port))


def test_frames_without_the_epoch_trailer_decode_as_epoch_zero():
    frame = jw.encode_request_list([], epoch=0)[:-4]
    assert pw.decode_request_list(frame)[3] == 0
    frame = jw.encode_response_list([], params=(1, 0.5, True, False,
                                                False), epoch=0)[:-4]
    assert pw.decode_response_list(frame)[4] == (1, 0.5, True, False,
                                                 False, 0)


def _cache_run(types, rc, seed, capacity):
    """Drive a cache through a seeded sequence of puts (single and fused
    allreduces, other response types, errors, process sets), classifies
    and touches; returns everything it answered."""
    rng = np.random.default_rng(seed)
    cache = rc.ResponseCache(capacity)
    log = []
    names = [f"t{i}" for i in range(12)]
    for _ in range(300):
        what = int(rng.integers(0, 4))
        k = int(rng.integers(1, 4))
        picked = [str(n) for n in rng.choice(names, k, replace=False)]
        dims = [[int(rng.integers(1, 3)), 4] for _ in picked]
        dtype = types.DataType(int(rng.choice([6, 7, 10])))
        op = types.ReduceOp(int(rng.choice([0, 1])))
        if what == 0:
            cache.put(types.Response(
                response_type=types.ResponseType(int(rng.choice(
                    [0, 0, 0, 1, 2]))),
                tensor_names=picked, tensor_type=dtype, devices=["cpu"],
                tensor_sizes=[d[0] * d[1] for d in dims], reduce_op=op,
                tensor_shapes=[types.TensorShape(d) for d in dims],
                process_set_id=int(rng.choice([0, 0, 0, 5])),
                error_message=str(rng.choice(["", "", "", "err"]))))
        elif what in (1, 2):
            req = types.Request(
                request_type=types.RequestType(int(rng.choice([0, 0, 1]))),
                tensor_type=dtype, tensor_name=picked[0], device="cpu",
                tensor_shape=types.TensorShape(dims[0]), reduce_op=op,
                process_set_id=int(rng.choice([0, 0, 0, 5])))
            state, pos = cache.classify(req)
            log.append(("classify", state, pos))
            if pos >= 0:
                log.append(("name_at", cache.name_at(pos)))
                syn = cache.synthesize_request(pos, 3)
                log.append(("synth", _plain(syn)))
                got = cache.get_by_position(pos)
                log.append(("get", _plain(got)))
        else:
            pos = int(rng.integers(0, capacity + 2))
            cache.touch(pos)
            log.append(("position_of", cache.position_of(picked[0])))
        log.append(("stats", cache.stats(), len(cache)))
    return log


@pytest.mark.parametrize("capacity", [0, 3, 8, 1024])
def test_response_cache_positions_evictions_and_stats(capacity):
    port = _cache_run(pt, prc, 11, capacity)
    jax = _cache_run(jt, jrc, 11, capacity)
    assert port == jax
    if capacity == 3:
        assert port[-1][1]["evictions"] > 0


def test_process_set_ids_are_the_jax_packages():
    for ranks in ([0, 2], [1], [0, 1, 2, 3], [5, 3, 9], list(range(64))):
        p = pps.ProcessSet(ranks)
        j = jps.ProcessSet(ranks)
        assert p.process_set_id == j.process_set_id
        assert pps.ranks_of(p.process_set_id) == sorted(set(ranks))
