"""Environment knobs: the port's copy of what it reads of
``horovod_tpu/utils/env.py`` (the same variable names)."""

from __future__ import annotations

import os

# The non-finite gradient guard (integrity/nonfinite.py).
NONFINITE_POLICY = "HVD_NONFINITE_POLICY"
NONFINITE_LIMIT = "HVD_NONFINITE_LIMIT"
# Verified checkpoints (utils/checkpoint.py): how many to keep, and the
# elastic membership epoch written into each manifest.
CKPT_KEEP = "HVD_CKPT_KEEP"
ELASTIC_EPOCH = "HVD_ELASTIC_EPOCH"


def get_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else default


def get_str(name: str, default: str = "") -> str:
    return os.environ.get(name, default)
