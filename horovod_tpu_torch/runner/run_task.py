"""The worker of the launcher's function mode: the port of
``horovod_tpu/runner/run_task.py``.

``python -m horovod_tpu_torch.runner.run_task`` fetches the cloudpickled
``(fn, args, kwargs, device)`` that :func:`horovod_tpu_torch.runner.run.run`
put in the rendezvous KV store, initializes the runtime on ``device`` (the
card when None) with the eager engine and no process group, runs the
function, and posts ``(ok, result or traceback)`` back under
``runfunc/result/<rank>``.

``cloudpickle`` is imported here, when the function mode runs, and never
when the launcher's modules are imported: a machine without it launches
command-mode jobs all the same.
"""

from __future__ import annotations

import os
import sys
import traceback


def import_cloudpickle():
    """``cloudpickle``, or an ``ImportError`` that names it and the mode
    that needs it."""
    try:
        import cloudpickle
    except ImportError as e:
        raise ImportError(
            "the launcher's function mode (horovod_tpu_torch.runner.run."
            "run) needs the 'cloudpickle' package, which is not "
            "installed; launch a command instead (python -m "
            "horovod_tpu_torch.runner.run -np N -- python script.py)") from e
    return cloudpickle


def main() -> int:
    cloudpickle = import_cloudpickle()

    from horovod_tpu_torch.runner import secret as secret_mod
    from horovod_tpu_torch.runner.http_client import KVClient

    addr = os.environ["HVD_RENDEZVOUS_ADDR"]
    port = int(os.environ["HVD_RENDEZVOUS_PORT"])
    rank = int(os.environ.get("HVD_RANK", "0"))
    kv = KVClient(addr, port, secret=os.environ.get(secret_mod.ENV_VAR))
    blob = kv.get_bytes("runfunc/fn")
    if blob is None:
        print("run_task: no function in the KV store", file=sys.stderr)
        return 1
    fn, args, kwargs, device = cloudpickle.loads(blob)

    import horovod_tpu_torch as hvd

    try:
        hvd.init(device=device, backend="none")
        result = fn(*args, **kwargs)
        payload = cloudpickle.dumps((True, result))
        ret = 0
    except Exception:
        payload = cloudpickle.dumps((False, traceback.format_exc()))
        ret = 1
    finally:
        hvd.shutdown()
    kv.put(f"runfunc/result/{rank}", payload)
    return ret


if __name__ == "__main__":
    sys.exit(main())
