"""Timing of a callable on the device its tensors live on — the
autotuner's measurement primitive.

Warm up, then report the median of ``repeat`` samples in microseconds
(the unit of the reference's ``repro.tune.timing``).  Median, not mean, so
a stray pause cannot flip a merge/row-split verdict recorded into the
TuneDB.

* On a CUDA device ``inner`` back-to-back calls are captured once into a
  CUDA graph (after a warm eager call on a side stream), and each sample
  is the time between two CUDA events recorded around one replay,
  divided by ``inner``: device time.  Timed as eager calls instead, a
  call whose kernels take less than its host dispatch (tens of µs of
  Python and launches a call) measures the host, and on small matrices
  the host's gaps, not the kernels, would decide the verdict
  (``chip_smoke.py`` prints both timings on the ``paper`` suite).  ``fn``
  must be capturable: no host synchronisation, launches on the current
  stream.
* On the CPU each sample is ``time.perf_counter`` around one call.

The result is a :class:`TimingResult` — a ``float`` subclass whose value
*is* the median — that keeps the per-repeat samples and exposes
``p50``/``p95``/``min``/``max``/``mean``/``std``/``cv``.
"""
from __future__ import annotations

import time

import numpy as np
import torch


class TimingResult(float):
    """Median µs as a float, with the raw per-repeat samples attached."""

    __slots__ = ("samples",)

    def __new__(cls, samples):
        xs = [float(s) for s in samples]
        self = super().__new__(cls, float(np.median(xs)) if xs
                               else float("nan"))
        self.samples = tuple(xs)
        return self

    @property
    def median(self) -> float:
        return float(self)

    @property
    def p50(self) -> float:
        return float(np.percentile(self.samples, 50))

    @property
    def p95(self) -> float:
        return float(np.percentile(self.samples, 95))

    @property
    def min(self) -> float:
        return float(np.min(self.samples))

    @property
    def max(self) -> float:
        return float(np.max(self.samples))

    @property
    def mean(self) -> float:
        return float(np.mean(self.samples))

    @property
    def std(self) -> float:
        return float(np.std(self.samples))

    @property
    def cv(self) -> float:
        """Coefficient of variation (std/mean) — the noise band."""
        m = self.mean
        return self.std / m if m > 0 else float("nan")

    def __repr__(self) -> str:
        return (f"TimingResult({float(self):.1f}us, n={len(self.samples)}, "
                f"cv={self.cv:.3f})")


INNER = 10    # calls a graph replays per sample on a CUDA device


def _device_of(args) -> torch.device:
    for x in args:
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cpu")


def timeit(fn, *args, warmup: int = 2, repeat: int = 5,
           inner: int = INNER) -> TimingResult:
    """Median µs of ``fn(*args)`` on the device of its first tensor
    argument (a TimingResult): on a CUDA device ``warmup`` replays, then
    ``repeat`` timed replays of a graph of ``inner`` calls; on the CPU
    ``warmup`` calls, then ``repeat`` timed calls."""
    dev = _device_of(args)
    if dev.type == "cuda":
        with torch.cuda.device(dev), torch.inference_mode():
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                fn(*args)
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for _ in range(inner):
                    fn(*args)
            for _ in range(warmup):
                graph.replay()
            ts = []
            for _ in range(repeat):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                graph.replay()
                end.record()
                end.synchronize()
                ts.append(start.elapsed_time(end) * 1e3 / inner)
        return TimingResult(ts)
    for _ in range(warmup):
        fn(*args)
    ts = []
    for _ in range(repeat):
        t0 = time.perf_counter()
        fn(*args)
        ts.append((time.perf_counter() - t0) * 1e6)
    return TimingResult(ts)
