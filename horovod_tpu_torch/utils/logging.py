"""Leveled, rank-prefixed logging: the port of
``horovod_tpu/utils/logging.py``.

``HVD_LOG_LEVEL`` is one of trace, debug, info, warning (the default),
error and fatal; ``HVD_LOG_HIDE_TIME=1`` drops the timestamp.  Both are
read once, when a logger is first asked for.  The loggers are
``horovod_tpu_torch.log`` and ``horovod_tpu_torch.log[<rank>]``, each with
its own stderr handler and not propagating: names of their own, so that
the package's other loggers (``horovod_tpu_torch``,
``horovod_tpu_torch.elastic``, ...) still reach the root's handlers.
"""

from __future__ import annotations

import logging
import os
import sys

_LEVELS = {
    "trace": 5,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "fatal": logging.CRITICAL,
}

logging.addLevelName(5, "TRACE")


def get_logger(rank: int = -1) -> logging.Logger:
    name = "horovod_tpu_torch.log" if rank < 0 else \
        f"horovod_tpu_torch.log[{rank}]"
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        hide_time = os.environ.get("HVD_LOG_HIDE_TIME", "0") in ("1", "true")
        fmt = "[%(name)s %(levelname)s] %(message)s" if hide_time else \
            "%(asctime)s [%(name)s %(levelname)s] %(message)s"
        handler.setFormatter(logging.Formatter(fmt))
        logger.addHandler(handler)
        level = os.environ.get("HVD_LOG_LEVEL", "warning").lower()
        logger.setLevel(_LEVELS.get(level, logging.WARNING))
        logger.propagate = False
    return logger
