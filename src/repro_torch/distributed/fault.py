"""Fault tolerance: retry of transient failures (the reference's
``repro.distributed.fault.retry``)."""
from __future__ import annotations

import time


def retry(fn, attempts: int = 3, backoff: float = 1.0,
          exceptions=(IOError, OSError), on_retry=None):
    """Call ``fn()``, retrying ``exceptions`` with exponential backoff.

    Covers the serving layer's batch execution (``repro_torch.serving.
    Server``).  ``on_retry(attempt, exc)`` fires before each backoff
    sleep -- the hook the server counts retries with; the final attempt's
    exception propagates unchanged.
    """
    for i in range(attempts):
        try:
            return fn()
        except exceptions as e:
            if i == attempts - 1:
                raise
            if on_retry is not None:
                on_retry(i + 1, e)
            time.sleep(backoff * (2 ** i))
