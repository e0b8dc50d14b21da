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
error}``, ``serve_request_latency_us{phase=queue_wait|assemble|execute|
total}``, ``serve_batch_occupancy`` (true requests / bucket batch) and
``serve_retries_total``.  While tracing is on (``repro_torch.obs``): the
``serve.warmup``, ``serve.batch`` and ``serve.execute`` spans and the
``serve.enqueue``, ``serve.retry`` and ``serve.shed`` events, as the
reference's server emits them.

Threads and streams: once :meth:`Server.start` has run, only the batcher
thread runs programs.  A CUDA graph's output is static -- the next replay
of the bucket overwrites it -- so the batcher copies each request's rows
out, on its own current stream, before it replays again, and resolves the
futures after synchronising that stream.
"""
from __future__ import annotations

import dataclasses
import itertools
import queue as _queue
import threading
import time
from collections.abc import Callable
from concurrent.futures import Future

import numpy as np
import torch

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
    token matrix (host copy), so a client can replay the exact call."""

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


class Server:
    """Async request queue + continuous batcher over bucket programs.

    ``forward(state, tokens)`` is the request scorer: ``tokens`` is a
    ``(batch, length)`` int64 tensor on the state's device, right-padded
    with ``pad_id``; the output is a tensor whose leading axes are
    ``(batch, length, ...)``, and each row must depend only on its own
    tokens (true for causal models and for row-independent SpMM scoring).
    ``state`` is the parameter tree; its device picks the programs (CUDA
    graphs on a card, eager calls on the CPU).  ``warmup`` re-attaches the
    engine-cached SpMM plans to every sparse leaf before it builds the
    programs, so plans are built once, outside every program.

    ``submit`` is thread-safe and does not block: it returns a
    :class:`RequestFuture` (a ``concurrent.futures.Future``) that resolves
    to the request's output rows (trimmed to its length), on the state's
    device, or raises :class:`RequestShed` or the execution error.
    """

    def __init__(self, forward: Callable, state, ladder: BucketLadder, *,
                 queue_depth: int = 256, batch_window_s: float = 0.002,
                 default_deadline_s: float | None = None,
                 retry_attempts: int = 3, retry_backoff_s: float = 0.05,
                 transient: tuple = (OSError,), pad_id: int = 0,
                 trim: bool = True, poll_s: float = 0.05,
                 name: str | None = None):
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

    # ------------------------------------------------------------ warmup ---

    def program(self, batch: int, length: int):
        """The program of the ``(batch, length)`` bucket, built on a miss.
        Call it with a token tensor of that shape; before :meth:`start`
        only (afterwards the batcher thread alone runs programs)."""
        return self.programs.get(
            (batch, length),
            lambda: bucket_program(self._forward, self.state, batch,
                                   length))

    def warmup(self) -> "Server":
        """Build every SpMM plan and every bucket's program.

        Idempotent; records the post-warmup miss count so
        :meth:`recompiles` can assert the steady state built nothing.
        """
        shapes = self.ladder.shapes()
        with _trace.span("serve.warmup", cat="serve", buckets=len(shapes)):
            self.state = ensure_spmm_plans(self.state)
            for b, s in shapes:
                self.program(b, s)
        self._warm_misses = self.programs.stats().misses
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
        try:
            self._q.put_nowait(p)
        except _queue.Full:
            self._shed(p, f"queue full (depth {self.queue_depth})")
            return p.future
        if _trace._enabled:
            _trace.event("serve.enqueue", cat="serve", length=length,
                         depth=self._q.qsize())
        return p.future

    # ---------------------------------------------------------- batcher ---

    def start(self) -> "Server":
        """Warm up (if not yet) and launch the batcher thread."""
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
        seconds."""
        self._closed = True
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise TimeoutError(f"server {self.name}: the batcher did "
                                   f"not end within {timeout} s")
            self._thread = None

    def _loop(self) -> None:
        while True:
            try:
                first = self._q.get(timeout=self._poll_s)
            except _queue.Empty:
                if self._stop.is_set():
                    return
                continue
            first.t_dequeue = time.perf_counter()
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
            self._serve_batch(batch)

    def _serve_batch(self, batch: list[_Pending]) -> None:
        now = time.perf_counter()
        live: list[_Pending] = []
        for p in batch:
            if p.deadline is not None and now > p.deadline:
                self._shed(p, "deadline expired before execution")
            else:
                live.append(p)
        for pb in pack([p.length for p in live], self.ladder):
            self._execute(pb.batch, pb.length,
                          [live[i] for i in pb.indices])

    def _execute(self, bb: int, lb: int, ps: list[_Pending]) -> None:
        t_asm0 = time.perf_counter()
        try:
            with _trace.span("serve.batch", cat="serve", batch=bb,
                             length=lb, fill=len(ps)):
                mat = np.full((bb, lb), self.pad_id, np.int64)
                for i, p in enumerate(ps):
                    mat[i, :p.length] = p.tokens
                    p.future.bucket, p.future.row = (bb, lb), i
                    p.future.packed = mat
                tok = torch.from_numpy(mat).to(self.device)
                program = self.program(bb, lb)
            _batch_occupancy.observe(len(ps) / bb)
            t_exec0 = time.perf_counter()
            with _trace.span("serve.execute", cat="serve", batch=bb,
                             length=lb):
                rows = fault.retry(lambda: self._run(program, tok, ps),
                                   attempts=self.retry_attempts,
                                   backoff=self.retry_backoff_s,
                                   exceptions=self.transient,
                                   on_retry=self._on_retry)
        except Exception as e:
            # Futures must never hang: the whole bucket batch fails
            # together once retries are exhausted.
            t_fail = time.perf_counter()
            for p in ps:
                _requests_total.labels(outcome="error").inc()
                p.future.done_s = t_fail
                p.future.set_exception(e)
            return
        t_done = time.perf_counter()
        for p, row in zip(ps, rows):
            _latency.labels(phase="queue_wait").observe(
                (p.t_dequeue - p.t_submit) * 1e6)
            _latency.labels(phase="assemble").observe(
                (t_exec0 - t_asm0) * 1e6)
            _latency.labels(phase="execute").observe(
                (t_done - t_exec0) * 1e6)
            _latency.labels(phase="total").observe(
                (t_done - p.t_submit) * 1e6)
            _requests_total.labels(outcome="ok").inc()
            p.future.done_s = t_done
            p.future.set_result(row)

    def _run(self, program, tok: torch.Tensor, ps: list[_Pending]) -> list:
        """One program call and the requests' rows copied out of its output
        (before the bucket's next replay overwrites it), synchronised."""
        out = self._call_program(program, tok)
        rows = [self._slice(out, i, p.length) for i, p in enumerate(ps)]
        _sync(self.device)
        return rows

    def _call_program(self, program, tokens: torch.Tensor):
        """One program call (override point for fault injection in
        tests)."""
        return program(tokens)

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
            _trace.event("serve.shed", cat="serve", length=p.length,
                         why=why)
        p.future.done_s = time.perf_counter()
        p.future.set_exception(RequestShed(why))
