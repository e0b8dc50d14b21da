"""Fault tolerance (the reference's ``repro.distributed.fault``):
preemption-safe checkpointing, straggler watermarking, step timing and
retry of transient failures.

* **Preemption** (SIGTERM from the scheduler): a flag is set; the training
  loop checkpoints at the next step boundary and exits 0 so the scheduler
  restarts it, and ``--resume auto`` picks up the latest step.
* **Hard failure**: the checkpoint cadence bounds the lost work; the
  deterministic data pipeline replays exactly the remaining batches.
* **Stragglers**: step wall times are watermarked against a running
  median and the offenders logged with their step index.
"""
from __future__ import annotations

import signal
import time


class PreemptionGuard:
    def __init__(self):
        self.requested = False
        self._installed = False

    def install(self):
        if self._installed:
            return self
        self._prev = signal.signal(signal.SIGTERM, self._handler)
        self._installed = True
        return self

    def _handler(self, signum, frame):
        self.requested = True

    def should_checkpoint(self) -> bool:
        return self.requested


class StragglerWatermark:
    """EMA-median step-time monitor; flags steps > factor × median."""

    def __init__(self, factor: float = 2.0, warmup: int = 5):
        self.factor = factor
        self.warmup = warmup
        self.median = None
        self.count = 0
        self.flagged: list[tuple[int, float]] = []

    def observe(self, step: int, seconds: float) -> bool:
        self.count += 1
        if self.median is None:
            self.median = seconds
        is_straggler = (self.count > self.warmup
                        and seconds > self.factor * self.median)
        # robust-ish streaming median: bounded multiplicative update
        self.median += 0.1 * self.median * (
            1.0 if seconds > self.median else -1.0)
        if is_straggler:
            self.flagged.append((step, seconds))
        return is_straggler


class StepTimer:
    """Host wall clock around a block (``.seconds`` after it).  Work
    queued on a card is timed only if the block waits for it: the train
    CLI synchronises inside the block."""

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.t0


def retry(fn, attempts: int = 3, backoff: float = 1.0,
          exceptions=(IOError, OSError), on_retry=None):
    """Call ``fn()``, retrying ``exceptions`` with exponential backoff.

    Covers checkpoint saves (the train CLI) and the serving layer's batch
    execution (``repro_torch.serving.Server``).  ``on_retry(attempt,
    exc)`` fires before each backoff sleep -- the hook the server counts
    retries with; the final attempt's exception propagates unchanged.
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
