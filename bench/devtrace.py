"""One ``torch.profiler`` capture, reduced to intervals.

The capture records the card's operations alone (kernels, copies, fills):
no host operations and no program spans, so that tracing perturbs the
traced window as little as it can.  One marker put on the card at a known
host time (:meth:`Capture.mark`) puts the host's clock on the capture's,
so the window and the client's own host spans, timed apart by
``time.perf_counter``, can be laid over the card's operations.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

# The marker: ``torch.cuda._sleep``'s kernel on the card, a host range on
# the CPU (where the capture holds no device operations).
MARK_KERNEL = "spin_kernel"
MARK_RANGE = "bench.mark"
MARK_CYCLES = 1000
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


def _kind(ev) -> str:
    kind = getattr(ev, "activity_type", None)
    if kind is not None:
        return str(kind())
    if ev.device_type() == torch.autograd.DeviceType.CUDA:
        return "kernel"
    return "user_annotation" if ev.is_user_annotation() else "cpu_op"


class Capture:
    """A running capture.  :meth:`mark` once, with the card idle, before
    the window; once the capture has stopped, ``device`` holds its device
    operations ``(name, t0, t1)`` (ns on its clock) and :meth:`ns` maps a
    ``time.perf_counter`` reading onto that clock."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.t_mark: float | None = None
        self.offset_ns = 0
        self.device: list = []
        self.stop_s = 0.0

    def mark(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()
            self.t_mark = time.perf_counter()
            torch.cuda._sleep(MARK_CYCLES)
            torch.cuda.synchronize()
        else:
            self.t_mark = time.perf_counter()
            with torch.profiler.record_function(MARK_RANGE):
                pass

    def read(self, prof) -> None:
        marks = []
        for ev in prof.profiler.kineto_results.events():
            kind = _kind(ev)
            t0 = ev.start_ns()
            t1 = t0 + ev.duration_ns()
            name = ev.name()
            if kind in DEVICE_KINDS:
                if MARK_KERNEL in name:
                    marks.append(t0)
                else:
                    self.device.append((name, t0, t1))
            elif kind == "user_annotation" and name == MARK_RANGE:
                marks.append(t0)
        if len(marks) != 1 or self.t_mark is None:
            raise RuntimeError(f"the capture holds {len(marks)} markers, "
                               f"not 1")
        self.offset_ns = marks[0] - int(self.t_mark * 1e9)

    def ns(self, t: float) -> int:
        return int(t * 1e9) + self.offset_ns

    def trace(self, t_open: float, t_end: float,
              spans=()) -> DeviceTrace:
        """The capture over the window ``[t_open, t_end]`` (host seconds),
        with host spans ``(name, t0, t1)`` in host seconds to name gaps."""
        host = [(name, self.ns(a), self.ns(b)) for name, a, b in spans]
        return DeviceTrace(self.device, host, (self.ns(t_open),
                                               self.ns(t_end)))


class DeviceTrace:
    """Device intervals and host ranges (ns on the profiler's clock)."""

    def __init__(self, device: list, host: list, window: tuple):
        self.device = sorted(device, key=lambda e: e[1])   # (name, t0, t1)
        self.host = host                                  # (name, t0, t1)
        self.window = window

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def _clipped(self):
        w0, w1 = self.window
        for name, t0, t1 in self.device:
            a, b = max(t0, w0), min(t1, w1)
            if b > a:
                yield name, a, b

    def busy_intervals(self) -> list:
        """The union of the device's operations inside the window."""
        out = []
        for _, a, b in self._clipped():
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def top_ops(self, n: int = 10) -> list:
        """The device operations that took most time in the window, summed
        by name: ``[name, seconds]``."""
        total = defaultdict(int)
        for name, a, b in self._clipped():
            total[name] += b - a
        top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name, t / 1e9] for name, t in top]

    def idle_gaps(self, n: int = 10) -> list:
        """The longest gaps in the window with no device operation, each
        named by the host range that overlaps it most: ``[label,
        seconds]``."""
        w0, w1 = self.window
        gaps, t = [], w0
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if w1 > t:
            gaps.append((t, w1))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
        return [[self._label(a, b), (b - a) / 1e9] for a, b in gaps]

    def _label(self, a: int, b: int) -> str:
        best, cover = "no host range", 0
        for name, t0, t1 in self.host:
            c = min(b, t1) - max(a, t0)
            if c > cover:
                best, cover = name, c
        return best

    def kernels(self, needle: str) -> list:
        """Every device operation whose name holds ``needle``, in start
        order over the whole capture: ``(name, t0, t1)``."""
        return [e for e in self.device if needle in e[0]]


@contextlib.contextmanager
def capture(cuda: bool):
    """Profile the card's operations (on the CPU, the host's ranges, which
    hold none of the card's); yields a :class:`Capture`, read once the
    block has ended, with ``stop_s`` the seconds the profiler took to
    stop."""
    act = (torch.profiler.ProfilerActivity.CUDA if cuda
           else torch.profiler.ProfilerActivity.CPU)
    holder = Capture(cuda)
    prof = torch.profiler.profile(activities=[act])
    prof.start()
    try:
        yield holder
    finally:
        t0 = time.perf_counter()
        prof.stop()
        holder.stop_s = time.perf_counter() - t0
    holder.read(prof)
