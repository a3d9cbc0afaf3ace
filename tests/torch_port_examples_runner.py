"""One rank of a launched gang that runs several scripts of
``examples/torch_port/`` one after another, for
``tests/test_torch_examples.py`` and ``tests/test_torch_examples_tf.py``:

    python tests/torch_port_examples_runner.py '<json [[script, [args]], ...]>'

Each script runs as ``__main__`` in this process (torch, TensorFlow and
the port are imported once for all of them), under a rendezvous scope of
its own (``HVD_RDV_SCOPE``), since each initializes and shuts down the
runtime.  Before each it prints ``=== <script>``, after it ``=== exit
<code>``; the first script that fails ends the rank with its code.
With ``EXAMPLES_KERAS_SEED`` set, Keras's, TensorFlow's, NumPy's and
Python's random numbers are seeded with it before each script (a script
given by an absolute path, such as one of the JAX package's examples,
runs as it is).
"""

import json
import os
import runpy
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples", "torch_port")


def main() -> int:
    sys.path.insert(0, REPO)
    from horovod_tpu_torch.parallel import multihost

    seed = os.environ.get("EXAMPLES_KERAS_SEED")
    base = os.environ.get("HVD_RDV_SCOPE", "")
    for i, (script, args) in enumerate(json.loads(sys.argv[1])):
        os.environ["HVD_RDV_SCOPE"] = f"{base}.ex{i}" if base else f"ex{i}"
        multihost.reset()
        if seed is not None:
            import keras

            keras.utils.set_random_seed(int(seed))
        print(f"=== {script}", flush=True)
        path = os.path.join(EXAMPLES, script)
        sys.argv = [path] + list(args)
        try:
            runpy.run_path(path, run_name="__main__")
            code = 0
        except SystemExit as e:
            code = e.code if isinstance(e.code, int) else (
                0 if e.code is None else 1)
            if not isinstance(e.code, (int, type(None))):
                print(e.code, flush=True)
        print(f"=== exit {code}", flush=True)
        if code:
            return code
    return 0


if __name__ == "__main__":
    sys.exit(main())
