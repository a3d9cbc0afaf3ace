"""MXNet front-end: ``import horovod_tpu_torch.mxnet as hvd``.  The port of
``horovod_tpu/mxnet/__init__.py``.

Role parity: ``horovod/mxnet/__init__.py`` — ``DistributedOptimizer``
(gradient allreduce with rescale_grad /= size), gluon
``DistributedTrainer``, and ``broadcast_parameters``, over the port's
eager engine (``horovod_tpu_torch/ops/eager.py``).  MXNet reached
end-of-life upstream and is often not installed: then the module
degrades to a clear ImportError at use time while keeping the surface
importable for introspection.  ``init`` is
``horovod_tpu_torch.basics.init`` (``device="cpu"`` where there is no
card).  Nothing is left out.
"""

from __future__ import annotations

from horovod_tpu_torch.basics import (  # noqa: F401
    cross_rank,
    cross_size,
    init,
    is_initialized,
    local_rank,
    local_size,
    rank,
    shutdown,
    size,
)

try:
    import mxnet  # noqa: F401

    _HAVE_MXNET = True
except ImportError:
    _HAVE_MXNET = False


def _require_mxnet(what: str):
    if not _HAVE_MXNET:
        raise ImportError(
            f"horovod_tpu_torch.mxnet.{what} requires the `mxnet` package, "
            "which is not installed in this environment. The eager "
            "collective engine itself is framework-agnostic — see "
            "horovod_tpu_torch.torch or horovod_tpu_torch.tensorflow "
            "for supported front-ends.")


def _from_nd(tensor):
    """NDArray → numpy; anything else passes through untouched."""
    if _HAVE_MXNET and hasattr(tensor, "asnumpy"):
        return tensor.asnumpy()
    return tensor


def _to_nd(out, like):
    """Return ``out`` in the caller's type (NDArray in, NDArray out)."""
    if _HAVE_MXNET and hasattr(like, "asnumpy"):
        import mxnet as mx

        nd = getattr(mx, "nd", None)
        if nd is not None and hasattr(nd, "array"):
            return nd.array(out, dtype=out.dtype)
    return out


def allreduce(tensor, average=None, name=None, op=None):
    """Parity: mxnet/mpi_ops.py ``allreduce`` — accepts an NDArray (or
    anything the eager engine takes: numpy, scalars) and returns the
    combined tensor in the caller's type."""
    from horovod_tpu_torch.ops import eager

    return _to_nd(eager.allreduce(_from_nd(tensor), average=average,
                                  name=name, op=op), tensor)


def allgather(tensor, name=None):
    """Parity: mxnet/mpi_ops.py ``allgather`` (ragged first dims)."""
    from horovod_tpu_torch.ops import eager

    return _to_nd(eager.allgather(_from_nd(tensor), name=name), tensor)


def broadcast(tensor, root_rank=0, name=None):
    """Parity: mxnet/mpi_ops.py ``broadcast``."""
    from horovod_tpu_torch.ops import eager

    return _to_nd(eager.broadcast(_from_nd(tensor), root_rank=root_rank,
                                  name=name), tensor)


def reducescatter(tensor, average=None, name=None, op=None):
    """Reduce across ranks, scatter over dim 0 (the reference project
    added ``hvd.reducescatter`` right after the v0.19 line)."""
    from horovod_tpu_torch.ops import eager

    return _to_nd(eager.reducescatter(_from_nd(tensor), average=average,
                                      name=name, op=op), tensor)


def DistributedOptimizer(optimizer, op=None):
    """Parity: mxnet/__init__.py:40-69 — wraps an mxnet optimizer,
    allreducing gradients with rescale_grad divided by world size."""
    _require_mxnet("DistributedOptimizer")
    from horovod_tpu_torch.ops import eager
    import numpy as np

    class _DistributedOptimizer(optimizer.__class__):
        def __init__(self, inner):
            self.__dict__.update(inner.__dict__)
            self.rescale_grad = getattr(inner, "rescale_grad", 1.0) / size()

        def _do_allreduce(self, index, grad):
            if size() == 1:
                return
            if isinstance(index, (tuple, list)):
                for i in range(len(index)):
                    out = eager.allreduce(grad[i].asnumpy(),
                                          name=f"mx.grad.{index[i]}",
                                          average=False)
                    grad[i][:] = out
            else:
                out = eager.allreduce(grad.asnumpy(),
                                      name=f"mx.grad.{index}",
                                      average=False)
                grad[:] = out

        def update(self, index, weight, grad, state):
            self._do_allreduce(index, grad)
            super().update(index, weight, grad, state)

        def update_multi_precision(self, index, weight, grad, state):
            self._do_allreduce(index, grad)
            super().update_multi_precision(index, weight, grad, state)

    return _DistributedOptimizer(optimizer)


def DistributedTrainer(params, optimizer, optimizer_params=None):
    """Parity: mxnet/__init__.py:87-108 gluon Trainer wrapper."""
    _require_mxnet("DistributedTrainer")
    import mxnet as mx
    from horovod_tpu_torch.ops import eager

    class _DistributedTrainer(mx.gluon.Trainer):
        def __init__(self):
            param_list = params
            if isinstance(param_list, dict):
                param_list = [param_list[k] for k in sorted(param_list)]
            super().__init__(param_list, optimizer,
                             optimizer_params, kvstore=None)
            self._scale /= size()

        def _allreduce_grads(self):
            for i, param in enumerate(self._params):
                if param.grad_req != "null":
                    for g in param.list_grad():
                        out = eager.allreduce(g.asnumpy(),
                                              name=f"mx.tr.{i}",
                                              average=False)
                        g[:] = out

    return _DistributedTrainer()


def broadcast_parameters(params, root_rank=0):
    """Parity: mxnet/__init__.py broadcast_parameters — works on gluon
    ParameterDict or a plain dict of NDArrays."""
    _require_mxnet("broadcast_parameters")
    from horovod_tpu_torch.ops import eager

    if hasattr(params, "items"):
        items = sorted(params.items())
    else:
        raise ValueError("invalid params of type: %s" % type(params))
    import mxnet as mx

    deferred = getattr(
        getattr(getattr(mx, "gluon", None), "parameter", None),
        "DeferredInitializationError", None) or ()
    for name, p in items:
        try:
            nd = p.data()
        except AttributeError:
            nd = p
        except deferred:
            # Shape-deferred gluon parameter (no forward pass yet):
            # wrap its init so the value is broadcast right after it
            # materializes, keeping ranks in sync without forcing an
            # early forward (same contract as the reference's
            # post-initialization broadcast injection).
            import types as _types

            orig_init = p._init_impl

            def _bcast_after_init(self, *a, _orig=orig_init, _name=name,
                                  **kw):
                _orig(*a, **kw)
                nd2 = self.data()
                out2 = eager.broadcast(
                    nd2.asnumpy(), root_rank=root_rank,
                    name=f"mx.bp.late.{_name}")
                nd2[:] = out2

            p._init_impl = _types.MethodType(_bcast_after_init, p)
            continue
        out = eager.broadcast(nd.asnumpy(), root_rank=root_rank,
                              name=f"mx.bp.{name}")
        nd[:] = out
