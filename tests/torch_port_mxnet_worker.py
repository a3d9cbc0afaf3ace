"""Gang worker for the MXNet front-ends of both packages
(``tests/test_torch_mxnet.py``), under a stand-in ``mxnet`` module.

    python tests/torch_port_mxnet_worker.py <port|jax> <out_dir>

``mxnet`` is not installed (and cannot be), so the worker puts a module of
that name in ``sys.modules`` before it imports the binding:
``tests/test_mxnet_binding.py``'s NDArray and optimizer stand-ins, a
``gluon.Trainer`` base class that keeps its parameters and ``_scale``, and
``gluon.parameter.DeferredInitializationError``.  ``port`` binds
``horovod_tpu_torch.mxnet`` (``hvd.init(device="cpu", backend="none")``),
``jax`` ``horovod_tpu.mxnet`` (``hvd.init()``).  On inputs made from a
seed it runs ``DistributedOptimizer`` (``update`` and
``update_multi_precision``, single and list indices),
``DistributedTrainer._allreduce_grads``, ``broadcast_parameters`` (a dict
and a deferred gluon parameter) and the op surface (allreduce, allgather
at ragged rows, broadcast, reducescatter), records every result in
``<out_dir>/rank<r>.pkl`` and prints ``MXNET_OK``.
"""

import os
import pickle
import sys
import types

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

from test_mxnet_binding import _FakeND, _FakeOptimizer  # noqa: E402


class _ListOptimizer(_FakeOptimizer):
    """The stand-in optimizer, taking a list of indices as mxnet's
    aggregated updates do."""

    def update_multi_precision(self, index, weight, grad, state):
        if not isinstance(index, (list, tuple)):
            return super().update_multi_precision(index, weight, grad,
                                                  state)
        for i, w, g in zip(index, weight, grad):
            super().update_multi_precision(i, w, g, state)


class _DeferredInit(Exception):
    pass


class _Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore=None):
        self._params = list(params)
        self._optimizer = optimizer
        self._scale = 1.0


class _Param:
    def __init__(self, grads, grad_req="write"):
        self._grads = grads
        self.grad_req = grad_req

    def list_grad(self):
        return self._grads


class _DeferredParam:
    """A gluon parameter whose shape is known only after a forward."""

    def __init__(self, value):
        self._value = value
        self._nd = None

    def data(self):
        if self._nd is None:
            raise _DeferredInit()
        return self._nd

    def _init_impl(self, *args, **kwargs):
        self._nd = _FakeND(self._value)


def _install_mxnet():
    mx = types.ModuleType("mxnet")
    mx.gluon = types.SimpleNamespace(
        Trainer=_Trainer,
        parameter=types.SimpleNamespace(
            DeferredInitializationError=_DeferredInit))
    sys.modules["mxnet"] = mx


def _rec(out, key, x):
    a = np.asarray(x.asnumpy() if hasattr(x, "asnumpy") else x)
    out[key] = (str(a.dtype), a.shape, a.tobytes())


def main():
    pkg, out_dir = sys.argv[1], sys.argv[2]
    _install_mxnet()
    if pkg == "jax":
        import horovod_tpu as base
        import horovod_tpu.mxnet as hvd

        base.init()
    else:
        import horovod_tpu_torch as base
        import horovod_tpu_torch.mxnet as hvd

        base.init(device="cpu", backend="none")
    assert hvd._HAVE_MXNET
    rank, size = hvd.rank(), hvd.size()
    rs = np.random.RandomState(50 + rank)
    out = {}
    try:
        opt = hvd.DistributedOptimizer(_ListOptimizer(lr=0.5))
        assert opt.rescale_grad == 1.0 / size, opt.rescale_grad
        w = _FakeND(np.arange(4.0))
        opt.update(0, w, _FakeND(rs.randn(4)), None)
        _rec(out, "opt.update", w)
        ws = [_FakeND(np.ones(3)), _FakeND(np.zeros(2))]
        gs = [_FakeND(rs.randn(3)), _FakeND(rs.randn(2))]
        opt.update_multi_precision([1, 2], ws, gs, None)
        for i, x in enumerate(ws):
            _rec(out, f"opt.ump.{i}", x)
        trainer = hvd.DistributedTrainer(
            {"b": _Param([_FakeND(rs.randn(2))]),
             "a": _Param([_FakeND(rs.randn(3))]),
             "frozen": _Param([_FakeND(rs.randn(2))], grad_req="null")},
            "sgd")
        assert trainer._scale == 1.0 / size
        trainer._allreduce_grads()
        for i, p in enumerate(trainer._params):
            _rec(out, f"trainer.{i}", p.list_grad()[0])
        params = {"w": _FakeND(rs.randn(2, 2)), "b": _FakeND(rs.randn(3))}
        late = _DeferredParam(rs.randn(2))
        params["late"] = late
        hvd.broadcast_parameters(params, root_rank=size - 1)
        late._init_impl()
        for k in ("w", "b"):
            _rec(out, f"bp.{k}", params[k])
        _rec(out, "bp.late", late.data())
        x = _FakeND(rs.randn(5))
        _rec(out, "ar.avg", hvd.allreduce(x, average=True, name="mx.ar"))
        _rec(out, "ar.sum", hvd.allreduce(x, average=False,
                                          name="mx.ar.sum"))
        _rec(out, "ag", hvd.allgather(_FakeND(rs.randn(rank + 1, 2)),
                                      name="mx.ag"))
        _rec(out, "bc", hvd.broadcast(x, root_rank=0, name="mx.bc"))
        _rec(out, "rs", hvd.reducescatter(_FakeND(rs.randn(2 * size, 2)),
                                          name="mx.rs", op=None))
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        print("MXNET_OK", flush=True)
    finally:
        base.shutdown()


if __name__ == "__main__":
    main()
