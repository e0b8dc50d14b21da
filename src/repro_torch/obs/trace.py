"""Structured tracing: scoped spans + instant events in a ring buffer (a
copy of the reference's ``repro.obs.trace``).

Zero-cost when disabled: every instrumentation site guards on the
module-level ``_enabled`` flag (one attribute read), so the engine's warm
execute path pays nothing while observability is off: no clock read, no
profiler range, no counter.  When enabled (``REPRO_TRACE=1`` in the
environment, the same variable the reference reads, :func:`enable`, or the
:func:`tracing` context manager), spans land in a bounded ring buffer as
Chrome trace-event records -- exportable with :meth:`Tracer.export` and
viewable in Perfetto / ``chrome://tracing``.

Spans double as ``torch.profiler.record_function`` ranges (the counterpart
of the reference's ``jax.profiler.TraceAnnotation``), so host-side engine
phases -- plan resolution, plan builds, kernel dispatch -- line up against
the card's kernels inside a ``torch.profiler`` capture.  A range is
entered only while tracing is on and a capture is running
(:func:`profiling`): outside a capture nothing records it, and entering
one costs a dispatcher call on each side.

The emitting sites (``core/config.py``, ``engine/cache.py``,
``core/spmm.py``, ``serving/server.py``, ``models/model.py``, the
launchers) use these categories:

* ``plan``     -- ``PlanPolicy.resolve`` (which ladder rung fired),
  ``plan.build``,
* ``cache``    -- plan-cache hit / miss / eviction,
* ``dispatch`` -- kernel dispatch (method, impl, dtypes, epilogue),
* ``serve`` / ``train`` -- launcher and server request/step scopes,
* ``model``    -- each block's mixer (``attention``, ``ssd_mixer``,
  ``rglru_mixer``).

What a ``dispatch`` event counts: one per ``execute_plan`` call that Python
runs.  An eager forward emits one per SpMM (48 a pruned Llama-3.2-1B
forward: 16 layers x 3 FFN matrices).  A CUDA-graph replay
(``engine.programs.GraphProgram``) launches the captured kernels without
passing through ``execute_plan``, so online serving shows ``dispatch``
events only from its warmup calls and captures, never from replays -- as
the reference's jitted forward shows them only while it traces.

One clock: every ``ts`` is ``time.perf_counter_ns() / 1e3``, in µs -- the
host's monotonic clock that ``time.perf_counter()`` reads, so a site may
stamp a span from two ``perf_counter()`` readings it already took
(:func:`complete`).  The export records it as ``otherData.clock =
"perf_counter_us"``; a marker put on the card at a known
``perf_counter()`` reading inside a ``torch.profiler`` capture lays the
exported spans over the capture's device operations.

Event args are Python values taken from plan metadata and shapes, never
read from a device tensor: a read would synchronise, and inside a CUDA
graph capture it would break the capture.  The ring and every counter
take concurrent appends (the server's batcher thread emits spans; ``tid``
is ``threading.get_ident()``).
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

import torch

DEFAULT_CAPACITY = 65536
# What every event's ``ts`` reads (see the module docstring).
CLOCK = "perf_counter_us"

# Fast-path flag: instrumentation sites read this attribute directly.
_enabled: bool = False
_tracer: Tracer | None = None
_lock = threading.Lock()


def _now_us() -> float:
    return time.perf_counter_ns() / 1e3


def profiling() -> bool:
    """Whether a ``torch.profiler`` capture is running: the process-wide
    flag the profiler sets on start and clears on stop (one attribute
    read), which PyTorch keeps for such fast checks."""
    return torch.autograd.profiler._is_profiler_enabled


class Tracer:
    """Bounded ring buffer of Chrome trace events (thread-safe appends).

    Events are dicts in the Chrome trace-event format: complete spans
    (``ph="X"`` with ``ts``/``dur`` in µs) and instant events
    (``ph="i"``).  The ring (``capacity`` events) keeps a long traced
    serving session bounded: old events fall off the front and are counted
    in ``dropped``.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = capacity
        self._events: deque = deque(maxlen=capacity)
        self._elock = threading.Lock()
        self._pid = os.getpid()
        self.dropped = 0

    def record(self, ev: dict) -> None:
        with self._elock:
            if len(self._events) == self.capacity:
                self.dropped += 1
            self._events.append(ev)

    def add_complete(self, name: str, cat: str, ts_us: float, dur_us: float,
                     args: dict) -> None:
        self.record({"name": name, "cat": cat or "default", "ph": "X",
                     "ts": ts_us, "dur": dur_us, "pid": self._pid,
                     "tid": threading.get_ident(), "args": args})

    def add_instant(self, name: str, cat: str, args: dict) -> None:
        self.record({"name": name, "cat": cat or "default", "ph": "i",
                     "ts": _now_us(), "pid": self._pid,
                     "tid": threading.get_ident(), "s": "t", "args": args})

    def events(self, *, cat: str | None = None,
               name: str | None = None) -> list:
        """Snapshot of the ring, optionally filtered by category/name."""
        with self._elock:
            evs = list(self._events)
        if cat is not None:
            evs = [e for e in evs if e.get("cat") == cat]
        if name is not None:
            evs = [e for e in evs if e.get("name") == name]
        return evs

    def clear(self) -> None:
        with self._elock:
            self._events.clear()
            self.dropped = 0

    def __len__(self) -> int:
        with self._elock:
            return len(self._events)

    def chrome_trace(self) -> dict:
        """The ring as a Chrome trace-event JSON object."""
        return {"traceEvents": self.events(), "displayTimeUnit": "ms",
                "otherData": {"producer": "repro_torch.obs",
                              "clock": CLOCK,
                              "dropped_events": self.dropped}}

    def export(self, path: str) -> str:
        """Write the Chrome trace JSON to ``path`` (returns the path)."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path


# ------------------------------------------------------------ span scopes ---


class _Span:
    """A live span: records a complete ("X") event on exit.

    ``set(**kw)`` adds args after entry (e.g. a count known only
    mid-body).  Inside a ``torch.profiler`` capture it also enters a
    ``record_function`` range of its name, so the span shows up there.
    """

    __slots__ = ("name", "cat", "args", "_t0", "_range")

    def __init__(self, name: str, cat: str, args: dict):
        self.name = name
        self.cat = cat
        self.args = args
        self._t0 = 0.0
        self._range = None

    def set(self, **kw) -> None:
        self.args.update(kw)

    def __enter__(self) -> _Span:
        if profiling():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self._t0 = _now_us()
        return self

    def __exit__(self, *exc) -> None:
        t1 = _now_us()
        if self._range is not None:
            self._range.__exit__(*exc)
        tr = _tracer
        if tr is not None:
            tr.add_complete(self.name, self.cat, self._t0, t1 - self._t0,
                            self.args)


class _NullSpan:
    """Disabled-path span: a shared, do-nothing context manager."""

    __slots__ = ()

    def set(self, **kw) -> None:
        pass

    def __enter__(self) -> _NullSpan:
        return self

    def __exit__(self, *exc) -> None:
        pass


_NULL_SPAN = _NullSpan()


def span(name: str, cat: str = "", **args):
    """A scoped span -- ``with obs.span("plan.build", cat="plan", ...):``.

    Returns a shared null context when tracing is disabled (no event, no
    timestamps, no profiler range)."""
    if not _enabled:
        return _NULL_SPAN
    return _Span(name, cat, args)


def complete(name: str, cat: str, t0: float, t1: float, **args) -> None:
    """A span from ``t0`` to ``t1``, two ``time.perf_counter()`` readings
    the site already took (a stretch that is no scope, such as a wait that
    ends when a request arrives).  No profiler range; a no-op when tracing
    is disabled."""
    if not _enabled:
        return
    tr = _tracer
    if tr is not None:
        tr.add_complete(name, cat, t0 * 1e6, (t1 - t0) * 1e6, args)


def event(name: str, cat: str = "", **args) -> None:
    """An instant event (no duration). No-op when tracing is disabled."""
    if not _enabled:
        return
    tr = _tracer
    if tr is not None:
        tr.add_instant(name, cat, args)


# ------------------------------------------------------------- lifecycle ---


def is_enabled() -> bool:
    return _enabled


def get_tracer() -> Tracer | None:
    """The active Tracer, or None when tracing was never enabled."""
    return _tracer


def enable(capacity: int = DEFAULT_CAPACITY) -> Tracer:
    """Turn tracing on (idempotent); returns the active Tracer."""
    global _enabled, _tracer
    with _lock:
        if _tracer is None:
            _tracer = Tracer(capacity)
        _enabled = True
        return _tracer


def disable() -> None:
    """Turn tracing off. The tracer (and its events) stay readable."""
    global _enabled
    with _lock:
        _enabled = False


class _Tracing:
    """``with obs.tracing() as tracer:`` -- scoped enable/restore."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._prev: tuple | None = None

    def __enter__(self) -> Tracer:
        global _enabled, _tracer
        with _lock:
            self._prev = (_enabled, _tracer)
            _tracer = Tracer(self.capacity)
            _enabled = True
            return _tracer

    def __exit__(self, *exc) -> None:
        global _enabled, _tracer
        with _lock:
            _enabled, _tracer = self._prev


def tracing(capacity: int = DEFAULT_CAPACITY) -> _Tracing:
    """Context manager: enable tracing with a fresh Tracer, restore the
    previous state (including a previously active tracer) on exit."""
    return _Tracing(capacity)


# REPRO_TRACE=1 (any non-empty value except "0") enables tracing at import
# -- the launcher-facing switch, shared with the reference package.
if os.environ.get("REPRO_TRACE", "") not in ("", "0"):
    enable()
