"""Retry with exponential backoff + deterministic jitter: the port's copy
of ``horovod_tpu/common/retry.py`` (stdlib only).

The control plane's cold paths (rendezvous KV requests, mesh connect)
face transient failure as a matter of course at fleet scale — a KV server
that is still binding, a peer that has not called listen yet, a dropped
SYN.  Single-try semantics turn each of those into a job failure; this
module gives them the standard remedy: capped exponential backoff with
jitter so a gang of workers retrying in lockstep does not thundering-herd
the endpoint they are waiting on.

Jitter is drawn from a ``random.Random`` seeded per call (default: from
the attempt site), keeping chaos tests deterministic.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional, TypeVar

T = TypeVar("T")


def backoff_delays(attempts: int, base_delay: float, max_delay: float,
                   jitter: float, seed: int = 0):
    """The delay sequence ``retry_call`` sleeps between attempts:
    ``min(max_delay, base * 2**i) * (1 + U(0, jitter))``, deterministic
    under ``seed``."""
    rng = random.Random(seed)
    out = []
    for i in range(max(0, attempts - 1)):
        d = min(max_delay, base_delay * (2.0 ** i))
        out.append(d * (1.0 + rng.random() * jitter))
    return out


def retry_call(
    fn: Callable[[], T],
    *,
    attempts: int = 4,
    base_delay: float = 0.05,
    max_delay: float = 2.0,
    jitter: float = 0.5,
    is_retryable: Callable[[BaseException], bool] = lambda e: True,
    deadline: Optional[float] = None,
    seed: int = 0,
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
) -> T:
    """Call ``fn`` up to ``attempts`` times with exponential backoff.

    ``is_retryable`` filters which exceptions are worth another attempt;
    anything else propagates immediately.  ``deadline`` (monotonic
    timestamp) caps total time regardless of attempts left.  The final
    failure re-raises the last exception.
    """
    delays = backoff_delays(attempts, base_delay, max_delay, jitter, seed)
    last: Optional[BaseException] = None
    for i in range(attempts):
        try:
            return fn()
        except BaseException as e:  # noqa: B036 — filtered below
            if not is_retryable(e):
                raise
            last = e
            if i >= attempts - 1:
                break
            if deadline is not None and time.monotonic() >= deadline:
                break
            if on_retry is not None:
                on_retry(i + 1, e)
            d = delays[i]
            if deadline is not None:
                d = min(d, max(0.0, deadline - time.monotonic()))
            time.sleep(d)
    assert last is not None
    raise last
