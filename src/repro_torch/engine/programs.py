"""Bucket-keyed program cache -- the serving twin of PlanCache.

The plan cache amortises *pattern*-derived work (chunk layout, kernel
choice); online serving adds a second static axis, the request shape.  A
:class:`ProgramCache` pins each key -- for the serving layer a ``(batch,
length)`` shape bucket -- to one program, with hit/miss/eviction counters
on the global metrics registry (``program_cache_events_total{cache,
event}`` / ``program_cache_size{cache}``), so a serving loop can assert
"zero recompiles after warmup" against a counter, not a hope.

The cache is agnostic of what it holds: ``get(key, build)`` runs
``build()`` on a miss outside the lock (a capture is long; concurrent
misses on *different* keys must not serialise) and double-checks the entry
before inserting, so two threads racing one key build at most one
redundant program and share one stored program.

What a bucket holds (:func:`bucket_program`) is chosen by the device of
the state it serves, and nothing falls back:

* on a CUDA state, a :class:`GraphProgram` -- the forward captured once
  as a CUDA graph over a static token buffer, replayed per call (PyTorch's
  counterpart of the reference's AOT-compiled program: one host launch
  for the whole forward).  A capture that fails raises; there is no eager
  retry;
* on a CUDA state whose forward runs a collective -- a sharded plan that
  takes the SPMD path, one shard a rank (``ShardedMeta.spmd_mesh()``) --
  an :class:`EagerProgram` with one warm call at build.  Gloo stages a
  collective on CUDA tensors through the host, which no capture can hold;
  under NCCL, a card a rank, a capture could, but that is not built;
* on a CPU state, an :class:`EagerProgram` -- the forward called eagerly
  under ``torch.inference_mode()``.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import OrderedDict
from collections.abc import Callable, Hashable

import torch

from repro_torch.obs import registry as _metrics

DEFAULT_MAXSIZE = 64

_prog_events = _metrics.counter(
    "program_cache_events_total",
    "ProgramCache events by cache instance", labels=("cache", "event"))
_prog_size = _metrics.gauge(
    "program_cache_size", "live entries per ProgramCache",
    labels=("cache",))

_prog_ids = itertools.count()


@dataclasses.dataclass
class ProgramStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    size: int = 0


class ProgramCache:
    """Thread-safe LRU of programs keyed on static shape keys."""

    def __init__(self, maxsize: int = DEFAULT_MAXSIZE,
                 name: str | None = None):
        self.maxsize = maxsize
        self.name = name if name is not None else \
            f"programs{next(_prog_ids)}"
        self._c_hit = _prog_events.labels(cache=self.name, event="hit")
        self._c_miss = _prog_events.labels(cache=self.name, event="miss")
        self._c_evict = _prog_events.labels(cache=self.name,
                                            event="eviction")
        self._g_size = _prog_size.labels(cache=self.name)
        self._entries: OrderedDict[Hashable, object] = OrderedDict()
        self._lock = threading.Lock()

    def get(self, key: Hashable, build: Callable[[], object]):
        """The program for ``key``; a miss runs ``build()`` (outside the
        lock) and caches its result."""
        with self._lock:
            prog = self._entries.get(key)
            if prog is not None:
                self._entries.move_to_end(key)
                self._c_hit.inc()
                return prog
        prog = build()
        with self._lock:
            raced = self._entries.get(key)
            if raced is not None:
                # Another thread built the same key first -- count our
                # build as the miss it was, serve the stored program.
                self._entries.move_to_end(key)
                self._c_miss.inc()
                return raced
            self._c_miss.inc()
            self._entries[key] = prog
            while len(self._entries) > self.maxsize:
                self._entries.popitem(last=False)
                self._c_evict.inc()
            self._g_size.set(len(self._entries))
        return prog

    def keys(self) -> list:
        with self._lock:
            return list(self._entries)

    def stats(self) -> ProgramStats:
        return ProgramStats(
            hits=self._c_hit.value, misses=self._c_miss.value,
            evictions=self._c_evict.value, size=int(self._g_size.value))

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            for c in (self._c_hit, self._c_miss, self._c_evict,
                      self._g_size):
                c.reset()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


# ------------------------------------------------------ bucket programs ---


def state_device(state) -> torch.device:
    """The device of the first tensor in a tree of dicts, lists, tuples and
    dataclasses (a parameter tree, ``SparseLinear`` layers)."""
    stack = [state]
    while stack:
        x = stack.pop(0)
        if isinstance(x, torch.Tensor):
            return x.device
        if isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            stack.extend(getattr(x, f.name) for f in dataclasses.fields(x))
    raise ValueError("the serving state holds no tensor to take a device "
                     "from")


class EagerProgram:
    """A bucket's program called eagerly: ``forward(state, tokens)`` under
    ``torch.inference_mode()``; each call returns a fresh output.

    ``warm=(batch, length)`` makes one synchronised call at build on a
    zero token matrix of that shape: a card's first-call cost moved into
    warmup."""

    def __init__(self, forward: Callable, state,
                 warm: tuple[int, int] | None = None):
        self.forward, self.state = forward, state
        if warm is not None:
            device = state_device(state)
            self(torch.zeros(warm, dtype=torch.int64, device=device))
            if device.type == "cuda":
                torch.cuda.synchronize(device)

    def __call__(self, tokens: torch.Tensor):
        with torch.inference_mode():
            return self.forward(self.state, tokens)


class GraphProgram:
    """A bucket's program on a CUDA state: ``forward(state, tokens)`` at one
    ``(batch, length)`` captured as a CUDA graph.

    Built in two steps on the state's device: one warm eager call on a side
    stream (it loads the kernel library and fills the caching allocator and
    cuBLAS's workspace, so nothing is set up for the first time inside the
    capture), then ``torch.cuda.graph`` capture over a static int64 token
    buffer, into the graph's own memory pool (``torch.cuda.graph``'s
    default; a server replays its buckets in any order, so no two graphs
    share a pool).  ``capture_s`` is the host time of both steps.

    A call copies ``tokens`` into the static buffer, replays the graph on
    the current stream and returns the graph's static output, which the
    next replay overwrites: the caller copies out what it keeps before it
    replays this program again, on the same stream.  The graph holds the
    addresses of ``state``'s tensors, which it keeps alive.  ``replays``
    counts the calls: a replay launches the captured kernels without
    passing through their wrappers, so their launch counters do not see
    it.
    """

    def __init__(self, forward: Callable, state, batch: int, length: int,
                 device: torch.device):
        t0 = time.perf_counter()
        self.state = state
        with torch.cuda.device(device):
            self.tokens = torch.zeros((batch, length), dtype=torch.int64,
                                      device=device)
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side), torch.inference_mode():
                forward(state, self.tokens)
            torch.cuda.current_stream(device).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.inference_mode(), torch.cuda.graph(self.graph):
                self.out = forward(state, self.tokens)
            torch.cuda.synchronize(device)
        self.capture_s = time.perf_counter() - t0
        self.replays = 0

    def __call__(self, tokens: torch.Tensor) -> torch.Tensor:
        self.tokens.copy_(tokens)
        self.graph.replay()
        self.replays += 1
        return self.out


def runs_collectives(state) -> bool:
    """Whether a forward over ``state`` runs a collective: some plan in
    the tree (a ``SparseLinear``'s) is sharded and takes the SPMD path,
    its ``meta.spmd_mesh()`` set."""
    stack = [state]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            continue
        spmd = getattr(x, "spmd_mesh", None)
        if callable(spmd):
            if spmd() is not None:
                return True
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            stack.extend(getattr(x, f.name) for f in dataclasses.fields(x))
    return False


def bucket_program(forward: Callable, state, batch: int, length: int):
    """The program of one ``(batch, length)`` bucket, by the state's
    device and plans: an :class:`EagerProgram` where the forward runs a
    collective (:func:`runs_collectives`; on a CUDA state with its warm
    call), else a :class:`GraphProgram` on a CUDA state and an
    :class:`EagerProgram` on a CPU one."""
    device = state_device(state)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"bucket programs run on cuda or cpu, not "
                         f"{device}")
    if runs_collectives(state):
        return EagerProgram(forward, state, warm=(
            (batch, length) if device.type == "cuda" else None))
    if device.type == "cuda":
        return GraphProgram(forward, state, batch, length, device)
    return EagerProgram(forward, state)
