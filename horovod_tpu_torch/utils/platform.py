"""Device guards: the torch counterparts of ``horovod_tpu/utils/platform.py``.

* :func:`force_cpu_platform` hides the CUDA devices from this process
  before torch initializes CUDA (``CUDA_VISIBLE_DEVICES`` is read then,
  once), so that a tool or a test that must run on the CPU cannot touch a
  card.
* :func:`default_backend_alive` probes, in a subprocess with bounded
  retry and backoff, whether CUDA initializes, so that a wedged CUDA
  stack is detected without wedging the caller.

Nothing on the main path calls either one to carry on without the card:
the entry points raise :class:`~horovod_tpu_torch.common.types.
NoCudaDeviceError` instead.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from typing import List, Tuple


def force_cpu_platform() -> None:
    """Hide every CUDA device from this process.  Raises if torch has
    already initialized CUDA, when hiding them would no longer work."""
    import torch

    if torch.cuda.is_initialized():
        raise RuntimeError(
            "force_cpu_platform() must run before torch initializes CUDA")
    os.environ["CUDA_VISIBLE_DEVICES"] = ""


def default_backend_alive(timeout: float = 60.0, attempts: int = 2,
                          backoff_s: float = 3.0
                          ) -> Tuple[bool, List[str]]:
    """Probe (in a subprocess, with retry and backoff) whether
    ``torch.cuda.init()`` succeeds.  Returns ``(alive, errors)``."""
    errors: List[str] = []
    for i in range(attempts):
        try:
            proc = subprocess.run(
                [sys.executable, "-c", "import torch; torch.cuda.init()"],
                timeout=timeout, capture_output=True, text=True)
            if proc.returncode == 0:
                return True, errors
            errors.append(f"rc={proc.returncode}: {proc.stderr[-200:]}")
        except subprocess.TimeoutExpired:
            errors.append(f"timeout after {timeout}s")
        if i + 1 < attempts:
            time.sleep(backoff_s * (i + 1))
    return False, errors
