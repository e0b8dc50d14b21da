"""Continuous-batching server over pre-built shape-bucket programs.

The paper's principle -- split the *total work*, not the rows, into equal
pieces so no execution unit idles -- lifted to the request level: an open
stream of ragged requests feeds a bounded queue, a batcher thread drains
it continuously, and every drained group is packed into the smallest
``(batch, length)`` bucket of a ladder (:mod:`repro_torch.serving.
buckets`).  Every bucket's program and every SpMM plan are built at
startup (``warmup``: ``ensure_spmm_plans``, then one program a bucket
through :class:`repro_torch.engine.ProgramCache` -- a CUDA graph on the
card), so the steady state replans nothing and captures nothing, both
asserted against counters.

Admission control keeps the system stable under overload: the queue is
bounded (``submit`` sheds at once when it is full), each request may carry
a deadline (shed at dequeue when already expired: serving a dead request
would only delay live ones), and transient execution failures retry with
exponential backoff through ``repro_torch.distributed.fault.retry``.

Counters on the global registry: ``serve_requests_total{outcome=ok|shed|
error}``, ``serve_request_latency_us{phase=queue_wait|batch_wait|total}``
a request, ``serve_batch_occupancy`` (true requests / bucket batch),
``serve_retries_total``, and two that are always on, for a bucket call:

* ``serve_batcher_us{phase}`` -- the batcher thread's phase clock.  Every
  stretch of its wall time from start to end lands in exactly one phase:
  ``idle`` (blocked on an empty queue; observed once when a window's
  first request arrives, and once when the batcher ends), ``window``
  (from that first dequeue until the window closes or the largest batch
  fills), then once a bucket call ``assemble`` (the first call of a
  window also holds the window's deadline check and ``pack``), ``launch``
  (the program call and the copy-out slices enqueued), ``sync`` (blocked
  until the stream drains) and ``resolve`` (stamping and resolving the
  futures, their done-callbacks included, which run on this thread).
  The batcher synchronises its stream after every call, so outside
  ``launch`` and ``sync`` the server's stream is empty: ``window``,
  ``assemble`` and ``resolve`` are the card's idle time while the server
  held requests, ``idle`` while it held none.
* ``serve_call_device_us{batch,length}`` -- one a served call: on a card
  the time between two CUDA events on the batcher's stream, one before
  the program's token copy and one after the rows are copied out; on the
  CPU the host time from launch to sync.

A request's ``batch_wait`` runs from its dequeue to the start of its
call's ``assemble`` (the window and every earlier bucket of its window),
so ``queue_wait + batch_wait`` + its call's ``assemble``, ``launch`` and
``sync`` is its ``total``.

While tracing is on (``repro_torch.obs``): the ``serve.warmup``,
``serve.idle``, ``serve.window``, ``serve.batch`` (assemble),
``serve.execute`` (launch and sync) and ``serve.resolve`` spans and the
``serve.enqueue``, ``serve.retry`` and ``serve.shed`` events.  Each
request gets a server-wide ``rid`` at submit (``RequestFuture.rid``),
carried by its enqueue and shed events; each window a ``window`` id and
each bucket call a ``call`` id, on its spans, with the call's ``rids``
and, on ``serve.execute``, its ``device_us``.

Threads and streams: once :meth:`Server.start` has run, only the batcher
thread runs programs.  A CUDA graph's output is static -- the next replay
of the bucket overwrites it -- so the batcher copies each request's rows
out, on its own current stream, before it replays again, and resolves the
futures after synchronising that stream.

Lockstep over a mesh (``lockstep=`` a :class:`Lockstep`): where the
forward runs a collective -- sharded plans on the SPMD path, each rank
running its shard and the ranks all-reducing C inside the forward -- every
rank must run every bucket program in the same order on the same tokens.
Rank 0 leads: it alone takes requests, sheds (queue full, deadline),
batches, and slices rows into futures, as above.  Every program it builds
or calls goes through one choke point that first broadcasts a message of
what to build or run; the other ranks follow (:meth:`Server.warmup`, then
:meth:`Server.follow`): they build the same programs, run them on the
broadcast tokens and drop the outputs.  One thread sends at a time:
warmup and probes before :meth:`Server.start`, the batcher while it runs
(a heartbeat on every idle poll, so a follower's wait is bounded by the
group's timeout only while the leader is gone), and :meth:`Server.stop`
after joining it.  Limits of the port: retries are off (one attempt: a
retry on one rank would desynchronise the ranks), and an execution error
fails, on the leader, that batch's futures, the rest of its batch window
unrun and every queued request, and makes :meth:`Server.stop` raise
without releasing the followers -- every rank's run then ends non-zero,
through the launcher's teardown or the group's timeout
(``launch.mesh.TIMEOUT_S``), never by serving on.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import queue as _queue
import threading
import time
from collections.abc import Callable
from concurrent.futures import Future

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed import fault
from repro_torch.engine.programs import (ProgramCache, bucket_program,
                                         state_device)
from repro_torch.obs import registry as _metrics
from repro_torch.obs import trace as _trace
from repro_torch.runtime.steps import ensure_spmm_plans

from .buckets import BucketLadder, pack

_requests_total = _metrics.counter(
    "serve_requests_total", "served requests by outcome",
    labels=("outcome",))
_latency = _metrics.histogram(
    "serve_request_latency_us", "per-request serving latency by phase",
    labels=("phase",))
_batch_occupancy = _metrics.histogram(
    "serve_batch_occupancy",
    "true requests / bucket batch per executed batch")
_retries_total = _metrics.counter(
    "serve_retries_total", "transient execution failures retried")
_batcher_us = _metrics.histogram(
    "serve_batcher_us", "the batcher thread's wall time by phase",
    labels=("phase",))
_call_device_us = _metrics.histogram(
    "serve_call_device_us", "device time of each served bucket call",
    labels=("batch", "length"))

_server_ids = itertools.count()


class RequestShed(RuntimeError):
    """Request dropped by admission control (queue full or deadline)."""


class ServerClosed(RuntimeError):
    """submit() after stop()."""


class RequestFuture(Future):
    """The future of one request, stamped by the server before it resolves:
    ``done_s`` is the ``time.perf_counter()`` at which its result or error
    was set; once executed, ``bucket`` is the ``(batch, length)`` bucket
    that served it, ``row`` its row there and ``packed`` the bucket's int64
    token matrix (host copy), so a client can replay the exact call.
    ``rid`` is the request's server-wide id, stamped at submit."""

    rid: int | None = None
    done_s: float | None = None
    bucket: tuple[int, int] | None = None
    row: int | None = None
    packed: np.ndarray | None = None


@dataclasses.dataclass
class _Pending:
    tokens: np.ndarray
    length: int
    deadline: float | None          # absolute perf_counter time
    future: RequestFuture
    t_submit: float
    t_dequeue: float = 0.0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


class _PhaseClock:
    """The batcher's phase clock: each :meth:`lap` observes the time since
    the previous one under a phase of ``serve_batcher_us``, so the phases
    tile the batcher's wall time; ``t`` is where the current phase began
    (a ``time.perf_counter()`` reading)."""

    __slots__ = ("t",)

    def __init__(self):
        self.t = time.perf_counter()

    def lap(self, phase: str, t: float | None = None) -> float:
        """End the current phase at ``t`` (default now) as ``phase``;
        returns where it began."""
        t0, self.t = self.t, time.perf_counter() if t is None else t
        _batcher_us.labels(phase=phase).observe((self.t - t0) * 1e6)
        return t0


class Lockstep:
    """The control channel of a server that runs on every rank of a mesh
    (see the module docstring): rank 0 of ``group`` leads, the others
    follow.

    A message is one int64 CPU tensor of a fixed size, broadcast from the
    leader over ``group`` -- a gloo group of its own
    (``launch.mesh.control_group``; an NCCL group takes no CPU tensor):
    ``[op, batch, length, tokens...]``, the ``(batch, length)`` token
    matrix row-major in the first of the ladder's ``max_batch * max_len``
    slots.  A message that fails raises."""

    BUILD, RUN, WARM, IDLE, STOP = "build", "run", "warm", "idle", "stop"
    _OPS = (BUILD, RUN, WARM, IDLE, STOP)

    def __init__(self, group, ladder: BucketLadder):
        self.group = group
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        self._src = dist.get_global_rank(group, 0)
        self._size = 3 + ladder.max_batch * ladder.max_len

    @property
    def leads(self) -> bool:
        return self.rank == 0

    def send(self, op: str, batch: int = 0, length: int = 0,
             tokens: torch.Tensor | None = None) -> None:
        """The leader's message (``tokens``: a ``(batch, length)`` CPU
        tensor for :attr:`RUN`)."""
        msg = torch.zeros(self._size, dtype=torch.int64)
        msg[0], msg[1], msg[2] = self._OPS.index(op), batch, length
        if tokens is not None:
            msg[3:3 + batch * length] = tokens.reshape(-1)
        dist.broadcast(msg, src=self._src, group=self.group)

    def recv(self) -> tuple[str, int, int, torch.Tensor]:
        """A follower's next message: op, batch, length and the token
        matrix."""
        msg = torch.empty(self._size, dtype=torch.int64)
        dist.broadcast(msg, src=self._src, group=self.group)
        op, batch, length = self._OPS[int(msg[0])], int(msg[1]), int(msg[2])
        return op, batch, length, msg[3:3 + batch * length].reshape(
            batch, length)


class Server:
    """Async request queue + continuous batcher over bucket programs.

    ``forward(state, tokens)`` is the request scorer: ``tokens`` is a
    ``(batch, length)`` int64 tensor on the state's device, right-padded
    with ``pad_id``; the output is a tensor whose leading axes are
    ``(batch, length, ...)``, and each row must depend only on its own
    tokens (true for causal models and for row-independent SpMM scoring).
    ``state`` is the parameter tree; its device picks the programs (CUDA
    graphs on a card, eager calls on the CPU or where the forward runs a
    collective).  ``warmup`` re-attaches the
    engine-cached SpMM plans to every sparse leaf before it builds the
    programs, so plans are built once, outside every program.
    ``lockstep`` runs the server on every rank of a mesh (see the module
    docstring): on rank 0 as below, on the others :meth:`warmup`, then
    :meth:`follow`.  ``forwards`` counts the program calls that returned
    on this rank -- probes and batches, on a follower the leader's RUN
    messages; not the warm calls at build -- and ``ran`` keeps the
    ``(batch, length)`` buckets of the last ``RAN_KEPT`` of them, in order.

    ``submit`` is thread-safe and does not block: it returns a
    :class:`RequestFuture` (a ``concurrent.futures.Future``) that resolves
    to the request's output rows (trimmed to its length), on the state's
    device, or raises :class:`RequestShed` or the execution error.
    """

    RAN_KEPT = 4096

    def __init__(self, forward: Callable, state, ladder: BucketLadder, *,
                 queue_depth: int = 256, batch_window_s: float = 0.002,
                 default_deadline_s: float | None = None,
                 retry_attempts: int = 3, retry_backoff_s: float = 0.05,
                 transient: tuple = (OSError,), pad_id: int = 0,
                 trim: bool = True, poll_s: float = 0.05,
                 name: str | None = None, lockstep: Lockstep | None = None):
        self.ladder = ladder
        self.state = state
        self.device = state_device(state)
        self.queue_depth = queue_depth
        self.batch_window_s = batch_window_s
        self.default_deadline_s = default_deadline_s
        self.retry_attempts = retry_attempts
        self.retry_backoff_s = retry_backoff_s
        self.transient = transient
        self.pad_id = pad_id
        self.trim = trim
        self.name = name if name is not None else \
            f"server{next(_server_ids)}"
        self.programs = ProgramCache(name=f"{self.name}.programs")
        self._forward = forward
        self._q: _queue.Queue = _queue.Queue(maxsize=queue_depth)
        self._poll_s = poll_s
        self._stop = threading.Event()
        self._closed = False
        self._thread: threading.Thread | None = None
        self._warm_misses: int | None = None
        self.forwards = 0
        self.ran: collections.deque = collections.deque(maxlen=self.RAN_KEPT)
        self.lockstep = lockstep
        self._failure: BaseException | None = None
        self._released = False
        self._rids = itertools.count()
        self._windows = itertools.count()
        self._calls = itertools.count()
        # One pair of timing events on a card, reused by every served call
        # (the batcher synchronises each call before the next); CUDA makes
        # an event at its first record.
        self._events = (
            (torch.cuda.Event(enable_timing=True),
             torch.cuda.Event(enable_timing=True))
            if self.device.type == "cuda" else None)
        if lockstep is not None:
            self.retry_attempts = 1
            if len(ladder.shapes()) > self.programs.maxsize:
                # An evicted bucket rebuilt on one rank alone would run its
                # warm call's collectives unpaired.
                raise ValueError(
                    f"a lockstep server keeps every bucket: the ladder's "
                    f"{len(ladder.shapes())} shapes exceed the program "
                    f"cache's {self.programs.maxsize}")

    def _leader(self, what: str) -> None:
        if self.lockstep is not None and not self.lockstep.leads:
            raise RuntimeError(
                f"server {self.name}: {what} on rank "
                f"{self.lockstep.rank}, which follows rank 0 (call "
                "warmup() and follow())")

    # ------------------------------------------------------------ warmup ---

    def program(self, batch: int, length: int):
        """The program of the ``(batch, length)`` bucket, built on a miss.
        Call it with a token tensor of that shape; before :meth:`start`
        only (afterwards the batcher thread alone runs programs).  A
        lockstep leader's build first tells the followers to build it."""
        def build():
            if self.lockstep is not None and self.lockstep.leads:
                self.lockstep.send(Lockstep.BUILD, batch, length)
            return bucket_program(self._forward, self.state, batch, length)

        return self.programs.get((batch, length), build)

    def warmup(self) -> "Server":
        """Build every SpMM plan and every bucket's program.

        Idempotent; records the post-warmup miss count so
        :meth:`recompiles` can assert the steady state built nothing.  A
        lockstep follower builds what the leader's warmup builds, in its
        order, until the leader's warmup ends.
        """
        shapes = self.ladder.shapes()
        with _trace.span("serve.warmup", cat="serve", buckets=len(shapes)):
            self.state = ensure_spmm_plans(self.state)
            if self.lockstep is not None and not self.lockstep.leads:
                self._follow(until=Lockstep.WARM)
                return self
            for b, s in shapes:
                self.program(b, s)
        self._warm_misses = self.programs.stats().misses
        if self.lockstep is not None:
            self.lockstep.send(Lockstep.WARM)
        return self

    def recompiles(self) -> int:
        """Program-cache misses since :meth:`warmup` (0 = the bucket
        ladder covered every served shape)."""
        warm = self._warm_misses if self._warm_misses is not None else 0
        return self.programs.stats().misses - warm

    def probe(self, batch: int, length: int) -> float:
        """One warm call at a bucket shape, synchronised; returns host
        seconds (rate calibration for load generators).  Before
        :meth:`start` only."""
        self._leader("probe")
        prog = self.program(batch, length)
        tok = torch.full((batch, length), self.pad_id, dtype=torch.int64,
                         device=self.device)
        t0 = time.perf_counter()
        self._call_program(prog, tok)
        _sync(self.device)
        return time.perf_counter() - t0

    # ------------------------------------------------------- client side ---

    def submit(self, tokens, *, deadline_s: float | None = None) -> RequestFuture:
        """Enqueue one request (a 1-D integer token array, or a CPU tensor)
        for batching.

        Sheds at once (the future raises :class:`RequestShed`) when the
        queue is at depth; ``deadline_s`` (default: the server's
        ``default_deadline_s``) sheds at dequeue when already expired.
        """
        self._leader("submit")
        if self._closed:
            raise ServerClosed(f"server {self.name} is stopped")
        tokens = np.asarray(tokens)
        if tokens.ndim != 1:
            raise ValueError(
                f"submit takes one request -- a 1-D token array -- got "
                f"shape {tokens.shape}")
        if not np.issubdtype(tokens.dtype, np.integer):
            raise ValueError(f"token ids must be integers, got "
                             f"{tokens.dtype}")
        length = int(tokens.shape[0])
        self.ladder.length_bucket(length)       # admission: length cap
        now = time.perf_counter()
        limit = deadline_s if deadline_s is not None \
            else self.default_deadline_s
        p = _Pending(tokens=tokens.astype(np.int64), length=length,
                     deadline=None if limit is None else now + limit,
                     future=RequestFuture(), t_submit=now)
        p.future.rid = next(self._rids)
        try:
            self._q.put_nowait(p)
        except _queue.Full:
            self._shed(p, f"queue full (depth {self.queue_depth})")
            return p.future
        if _trace._enabled:
            _trace.event("serve.enqueue", cat="serve", rid=p.future.rid,
                         length=length, depth=self._q.qsize())
        return p.future

    # ---------------------------------------------------------- batcher ---

    def start(self) -> "Server":
        """Warm up (if not yet) and launch the batcher thread."""
        self._leader("start")
        if self._thread is not None:
            raise RuntimeError(f"server {self.name} already started")
        if self._warm_misses is None:
            self.warmup()
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name=f"{self.name}.batcher", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float | None = None) -> None:
        """Stop accepting requests, drain the queue, join the batcher;
        raises ``TimeoutError`` if it has not ended within ``timeout``
        seconds.  A lockstep leader then releases the followers; after an
        execution error it raises instead (see the module docstring)."""
        self._closed = True
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise TimeoutError(f"server {self.name}: the batcher did "
                                   f"not end within {timeout} s")
            self._thread = None
        if self.lockstep is None or not self.lockstep.leads:
            return
        if self._failure is not None:
            self._fail_queued(self._failure)
            raise RuntimeError(
                f"server {self.name}: a bucket failed under lockstep; the "
                "followers are not released") from self._failure
        if not self._released:
            self.lockstep.send(Lockstep.STOP)
            self._released = True

    def follow(self) -> "Server":
        """A lockstep follower's serving loop: build and run what the
        leader's messages say, in their order, until its :meth:`stop`."""
        if self.lockstep is None or self.lockstep.leads:
            raise RuntimeError(f"server {self.name}: follow() is for the "
                               "ranks that follow a lockstep leader")
        if self._warm_misses is None and not self._released:
            self.warmup()
        if not self._released:
            self._follow(until=Lockstep.STOP)
        return self

    def _follow(self, until: str) -> None:
        ls = self.lockstep
        while True:
            op, batch, length, tokens = ls.recv()
            if op == Lockstep.BUILD:
                self.program(batch, length)
            elif op == Lockstep.RUN:
                self._ran(self.program(batch, length),
                          tokens.to(self.device))
                _sync(self.device)
            elif op == Lockstep.WARM:
                self._warm_misses = self.programs.stats().misses
            elif op == Lockstep.STOP:
                self._released = True
                return
            if op == until:
                return

    def _fail_queued(self, exc: BaseException) -> None:
        while True:
            try:
                self._fail([self._q.get_nowait()], exc)
            except _queue.Empty:
                return

    @staticmethod
    def _fail(ps: list[_Pending], exc: BaseException) -> None:
        t_fail = time.perf_counter()
        for p in ps:
            _requests_total.labels(outcome="error").inc()
            p.future.done_s = t_fail
            p.future.set_exception(exc)

    def _loop(self) -> None:
        with (torch.cuda.device(self.device) if self.device.type == "cuda"
              else contextlib.nullcontext()):
            self._batches()

    def _batches(self) -> None:
        clock = _PhaseClock()
        while True:
            try:
                first = self._q.get(timeout=self._poll_s)
            except _queue.Empty:
                if self._stop.is_set():
                    clock.lap("idle")
                    return
                if self.lockstep is not None:
                    self.lockstep.send(Lockstep.IDLE)
                continue
            first.t_dequeue = time.perf_counter()
            t_idle = clock.lap("idle", first.t_dequeue)
            window = next(self._windows)
            batch = [first]
            # Continuous assembly: after the first request, keep draining
            # until the window closes or the largest batch bucket fills --
            # the window trades a bounded latency add for occupancy under
            # bursty arrivals.
            t_close = first.t_dequeue + self.batch_window_s
            while len(batch) < self.ladder.max_batch:
                left = t_close - time.perf_counter()
                try:
                    p = (self._q.get_nowait() if left <= 0
                         else self._q.get(timeout=left))
                except _queue.Empty:
                    break
                p.t_dequeue = time.perf_counter()
                batch.append(p)
            t_window = clock.lap("window")
            if _trace._enabled:
                _trace.complete("serve.idle", "serve", t_idle, t_window,
                                window=window, n=len(batch))
                _trace.complete("serve.window", "serve", t_window, clock.t,
                                window=window, n=len(batch))
            self._serve_batch(batch, clock, window)
            if self._failure is not None:
                self._closed = True
                self._fail_queued(self._failure)
                clock.lap("idle")
                return

    def _serve_batch(self, batch: list[_Pending], clock: _PhaseClock,
                     window: int) -> None:
        now = time.perf_counter()
        live: list[_Pending] = []
        for p in batch:
            if p.deadline is not None and now > p.deadline:
                self._shed(p, "deadline expired before execution")
            else:
                live.append(p)
        for pb in pack([p.length for p in live], self.ladder):
            ps = [live[i] for i in pb.indices]
            if self._failure is not None:
                # A bucket of this window failed under lockstep: the
                # followers may still wait in its collectives, so the rest
                # of the window fails unrun.
                self._fail(ps, self._failure)
            else:
                self._execute(pb.batch, pb.length, ps, clock, window)

    def _execute(self, bb: int, lb: int, ps: list[_Pending],
                 clock: _PhaseClock, window: int) -> None:
        # The call's assemble began where the clock's last phase ended: at
        # the window's close for a window's first call, else at the end of
        # the previous call's resolve.
        t_asm0 = clock.t
        call = next(self._calls)
        ids = ({"call": call, "window": window,
                "rids": [p.future.rid for p in ps]}
               if _trace._enabled else {})
        phase = "assemble"
        try:
            with _trace.span("serve.batch", cat="serve", batch=bb,
                             length=lb, fill=len(ps), **ids):
                mat = np.full((bb, lb), self.pad_id, np.int64)
                for i, p in enumerate(ps):
                    mat[i, :p.length] = p.tokens
                    p.future.bucket, p.future.row = (bb, lb), i
                    p.future.packed = mat
                tok = torch.from_numpy(mat).to(self.device)
                program = self.program(bb, lb)
            _batch_occupancy.observe(len(ps) / bb)
            clock.lap("assemble")
            t_exec0, phase = clock.t, "launch"
            with _trace.span("serve.execute", cat="serve", batch=bb,
                             length=lb, **ids) as sp:
                rows, t_launched = fault.retry(
                    lambda: self._run(program, tok, ps),
                    attempts=self.retry_attempts,
                    backoff=self.retry_backoff_s,
                    exceptions=self.transient, on_retry=self._on_retry)
                t_done = time.perf_counter()
                if self._events is not None:
                    device_us = self._events[0].elapsed_time(
                        self._events[1]) * 1e3
                else:
                    device_us = (t_done - t_exec0) * 1e6
                sp.set(device_us=device_us)
        except Exception as e:
            # Futures must never hang: the whole bucket batch fails
            # together once retries are exhausted.
            clock.lap(phase)
            self._fail(ps, e)
            clock.lap("resolve")
            if self.lockstep is not None:
                self._failure = e
            return
        clock.lap("launch", t_launched)
        clock.lap("sync", t_done)
        _call_device_us.labels(batch=bb, length=lb).observe(device_us)
        with _trace.span("serve.resolve", cat="serve", call=call):
            for p, row in zip(ps, rows):
                _latency.labels(phase="queue_wait").observe(
                    (p.t_dequeue - p.t_submit) * 1e6)
                _latency.labels(phase="batch_wait").observe(
                    (t_asm0 - p.t_dequeue) * 1e6)
                _latency.labels(phase="total").observe(
                    (t_done - p.t_submit) * 1e6)
                _requests_total.labels(outcome="ok").inc()
                p.future.done_s = t_done
                p.future.set_result(row)
        clock.lap("resolve")

    def _run(self, program, tok: torch.Tensor,
             ps: list[_Pending]) -> tuple[list, float]:
        """One program call and the requests' rows copied out of its output
        (before the bucket's next replay overwrites it), synchronised; on
        a card between the server's two timing events.  Returns the rows
        and the ``perf_counter()`` reading at which the host had enqueued
        them, before it waited for the stream."""
        ev = self._events
        if ev is not None:
            ev[0].record()
        out = self._call_program(program, tok)
        rows = [self._slice(out, i, p.length) for i, p in enumerate(ps)]
        if ev is not None:
            ev[1].record()
        t_launched = time.perf_counter()
        _sync(self.device)
        return rows, t_launched

    def _call_program(self, program, tokens: torch.Tensor):
        """One program call: the choke point of every call, where a
        lockstep leader first sends the followers the bucket and its
        tokens (override point for fault injection in tests)."""
        if self.lockstep is not None:
            self.lockstep.send(Lockstep.RUN, *tokens.shape, tokens.cpu())
        return self._ran(program, tokens)

    def _ran(self, program, tokens: torch.Tensor):
        out = program(tokens)
        self.forwards += 1
        self.ran.append(tuple(tokens.shape))
        return out

    def _slice(self, out: torch.Tensor, i: int, length: int):
        x = out[i]
        if self.trim and x.dim() >= 1:
            x = x[:length]
        return x.clone()

    def _on_retry(self, attempt: int, exc: Exception) -> None:
        _retries_total.inc()
        if _trace._enabled:
            _trace.event("serve.retry", cat="serve", attempt=attempt,
                         error=type(exc).__name__)

    def _shed(self, p: _Pending, why: str) -> None:
        _requests_total.labels(outcome="shed").inc()
        if _trace._enabled:
            _trace.event("serve.shed", cat="serve", rid=p.future.rid,
                         length=p.length, why=why)
        p.future.done_s = time.perf_counter()
        p.future.set_exception(RequestShed(why))
