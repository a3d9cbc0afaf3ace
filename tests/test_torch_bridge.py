"""Engine collectives as custom ops under ``torch.compile``
(``horovod_tpu_torch/ops/bridge.py``), in gangs of two
(``tests/torch_port_frontend_worker.py``; ``backend="aot_eager"``, which
needs no C++ compiler).

* A port gang: every op compiled with ``fullgraph=True`` (no graph break
  counted) gives the same bits as the eager front-end's op of the same
  name; grouped allreduce of five tensors (an int32 one among them);
  reducescatter's row chunks at uneven row counts; the gradients of
  allreduce, grouped allreduce, allgather and broadcast follow the JAX
  bridge's ``custom_vjp`` rules, compiled and eager alike;
  ``torch.library.opcheck`` passes for each op on the live gang; a call
  under ``torch.func.vmap`` raises a named ``TypeError``.
* A mixed gang: a JAX rank calls ``horovod_tpu.ops.bridge`` under ``jit``
  and a port rank the port's ops under ``torch.compile``, with the same
  names, negotiated together: both ranks get the same bits, the average
  of their inputs.

Every gang pins ``HVD_SHM_DISABLE=1`` and sets ``HVD_BLACKBOX_DIR``.
"""

import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from test_torch_frontend import ran, run_gangs, value  # noqa: E402
from torch_port_frontend_worker import tensor  # noqa: E402

GANGS = {"port2": (["port", "port"], ["bridge"]),
         "mixed2": (["jax", "port"], ["bridge_mixed"])}
OPS = ("allreduce", "grouped_allreduce", "allgather", "broadcast",
       "reducescatter", "alltoall", "barrier")


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    return run_gangs(tmp_path_factory.mktemp("bridge_gangs"), GANGS, 180.0)


def _res(gangs, rank):
    ran(gangs["port2"], "bridge")
    return gangs["port2"][1][rank]["bridge"]


@pytest.mark.timeout(300)
@pytest.mark.parametrize("rank", [0, 1])
def test_compiled_ops_are_the_eager_ops_bits(gangs, rank):
    res = _res(gangs, rank)
    for i in range(5):
        assert res[f"grouped.compiled.{i}"] == res[f"grouped.eager.{i}"]
        assert res[f"grouped.bridge_eager.{i}"] == res[f"grouped.eager.{i}"]
    for k in ("allreduce", "allgather", "broadcast", "alltoall"):
        assert res[f"{k}.compiled"] == res[f"{k}.eager"], k
    assert value(gangs["port2"], rank, "bridge",
                 "graph_breaks").item() == 0
    # Ranks agree where the op says they must.
    other = _res(gangs, 1 - rank)
    for k in ("allreduce.compiled", "allgather.compiled",
              "broadcast.compiled", "grouped.compiled.0"):
        assert res[k] == other[k], k


@pytest.mark.timeout(300)
@pytest.mark.parametrize("rows", [7, 8, 1])
def test_reducescatter_rows_at_uneven_counts(gangs, rows):
    want_rows = [(rows - r + 1) // 2 for r in range(2)]
    full = sum(tensor(("brs", r, rows), (rows, 3)).numpy().astype(np.float64)
               for r in range(2))
    start = 0
    for rank in range(2):
        res = _res(gangs, rank)
        got = value(gangs["port2"], rank, "bridge",
                    f"reducescatter.compiled.{rows}")
        assert got.shape == (want_rows[rank], 3)
        assert res[f"reducescatter.compiled.{rows}"] == \
            res[f"reducescatter.eager.{rows}"]
        np.testing.assert_allclose(got, full[start:start + got.shape[0]],
                                   rtol=1e-6, atol=1e-6)
        start += got.shape[0]


@pytest.mark.timeout(300)
@pytest.mark.parametrize("rank", [0, 1])
def test_gradients_follow_the_bridge_rules(gangs, rank):
    """loss = <allreduce_avg(t), w> + 0.5 |allgather(2t)|^2
    + <broadcast_0(t), w> + <grouped_sum(t), w> + sum(grouped_sum(t*t)).
    Each term's gradient by the JAX bridge's rules:
    allreduce: Average of w; allgather: 2 * my rows of the Sum of the
    gathered 2t; broadcast: the Sum of w on the root, zero elsewhere;
    grouped: the Sum of w, and 2t times the Sum of ones."""
    res = _res(gangs, rank)
    assert res["grad.compiled"] == res["grad.bridge_eager"]
    t = [tensor(("bt", r), (6, 4)).numpy().astype(np.float64)
         for r in range(2)]
    w = [tensor(("bw", r), (6, 4)).numpy().astype(np.float64)
         for r in range(2)]
    w_sum = w[0] + w[1]
    want = w_sum / 2
    want = want + 2 * (2 * 2 * t[rank])  # d/dt of 0.5|g|^2 summed, my rows
    if rank == 0:
        want = want + w_sum
    want = want + w_sum + 2 * t[rank] * 2
    got = value(gangs["port2"], rank, "bridge", "grad.compiled")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("op", OPS)
def test_opcheck_passes_on_the_gang(gangs, op):
    for rank in range(2):
        _res(gangs, rank)
        assert value(gangs["port2"], rank, "bridge",
                     f"opcheck.{op}").item(), (rank, op)


@pytest.mark.timeout(300)
def test_vmap_raises_a_named_error(gangs):
    for rank in range(2):
        _res(gangs, rank)
        assert value(gangs["port2"], rank, "bridge", "vmap_refused").item()


@pytest.mark.timeout(300)
def test_mixed_gang_jit_and_compile_negotiate_together(gangs):
    gang = gangs["mixed2"]
    ran(gang, "bridge_mixed")
    a, b = (gang[1][r]["bridge_mixed"] for r in range(2))
    assert sorted(a) == sorted(b)
    for key in a:
        assert a[key] == b[key], key
    shapes = [(4, 3), (7,), (2, 2, 2)]
    for i, s in enumerate(shapes):
        want = sum(tensor(("bm", r, i), s).numpy().astype(np.float64)
                   for r in range(2)) / 2
        np.testing.assert_allclose(value(gang, 1, "bridge_mixed",
                                         f"grouped.{i}"), want, rtol=1e-6)
    np.testing.assert_allclose(
        value(gang, 1, "bridge_mixed", "allreduce"),
        sum(tensor(("bm", r, 0), (4, 3)).numpy().astype(np.float64)
            for r in range(2)) / 2, rtol=1e-6)
