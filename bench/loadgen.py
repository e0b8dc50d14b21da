"""Seeded traffic and the windowed client: the benchmark's load generator.

Started from the port's ``serving/loadgen.py`` (open-loop Poisson
arrivals, seeded, token ids from numpy) and frozen here, with what a
measurement needs:

* a window of fixed length instead of a fixed count;
* an open loop (independent users on a Poisson schedule that does not wait
  for completions) or a closed loop (clients that each send their next
  request when the previous one returns);
* every request timed from when it was due, so a stall delays the
  requests queued behind it; one that fails, is shed or never returns
  counts as slower than every served one;
* the same work for every seed: an open loop's window holds the
  exponential's quantiles as its Poisson gaps and the length
  distribution's quantiles as its lengths, each set in one order drawn
  once for the traffic (Poisson arrivals given their count and the spread
  of their gaps, bursts and lulls kept), which every seed replays from a
  start of its own, wrapping round; a closed loop's lengths are the
  distribution's quantiles in blocks of ``stratify`` requests, each block
  in an order the seed shuffles.

The client runs on one thread; the server stamps each future when it
resolves it, and a callback on the server's thread records the outcome.
"""
from __future__ import annotations

import dataclasses
import math
import queue
import statistics
import threading
import time

import numpy as np

_STREAM_ORDER, _STREAM_TOKENS = 1, 2
# The one draw of an open loop's order, which every seed replays.
_TAPE_SEED = 0


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % (1 << 63), *stream])


def length_quantiles(spec: dict, n: int) -> list[int]:
    """``n`` prompt lengths at the quantiles ``(i + 0.5) / n`` of the
    traffic's length distribution: ``lognormal`` (``median``, ``sigma``)
    or ``uniform``, clipped to ``[min, max]`` and rounded."""
    lo, hi = int(spec["min"]), int(spec["max"])
    out = []
    for i in range(n):
        q = (i + 0.5) / n
        if spec["dist"] == "lognormal":
            z = statistics.NormalDist().inv_cdf(q)
            x = spec["median"] * math.exp(spec["sigma"] * z)
        elif spec["dist"] == "uniform":
            x = lo + q * (hi - lo + 1) - 0.5
        else:
            raise ValueError(f"unknown length distribution {spec['dist']!r}")
        out.append(min(hi, max(lo, int(round(x)))))
    return out


def request_tokens(seed: int, index: int, length: int,
                   vocab: int) -> np.ndarray:
    """Token ids of request ``index``: a function of the seed and index."""
    return _rng(seed, _STREAM_TOKENS, index).integers(
        0, vocab, size=(length,), dtype=np.int64)


@dataclasses.dataclass
class Request:
    """One request of a tape: ``due`` is its offset (s) from the window's
    open in an open loop; a closed loop's requests are due when sent."""

    index: int
    length: int
    due: float = 0.0


def open_tape(traffic: dict, seconds: float, seed: int) -> list[Request]:
    """The open loop's requests over a window: ``n = round(rate *
    seconds)`` arrivals whose gaps are the exponential's ``n`` quantiles at
    the rate and whose lengths are the length distribution's ``n``
    quantiles, each set in one order drawn once over the whole window (by
    ``_TAPE_SEED``, not the seed); the seed picks where in that cycle the
    window starts.  The arrivals are scaled to fall inside the window.
    Every seed offers the same gaps, lengths and bursts, in the same cycle;
    the queue a seed meets differs only in where the cycle opens."""
    rate = float(traffic["rate_rps"])
    n = max(1, int(round(rate * seconds)))
    rng = _rng(_TAPE_SEED, _STREAM_ORDER)
    gaps = np.array([-math.log(1.0 - (i + 0.5) / n) / rate
                     for i in range(n)])[rng.permutation(n)]
    lengths = np.array(length_quantiles(traffic["lengths"], n))[
        rng.permutation(n)]
    start = int(_rng(seed, _STREAM_ORDER).integers(n))
    gaps, lengths = np.roll(gaps, -start), np.roll(lengths, -start)
    at = np.cumsum(gaps)
    at *= (seconds - 0.5 / rate) / at[-1]
    return [Request(i, int(lengths[i]), float(at[i])) for i in range(n)]


class ClosedTape:
    """The closed loop's requests, made on demand: request ``i`` lies in
    block ``i // stratify`` of ``stratify`` requests, whose lengths are the
    distribution's ``stratify`` quantiles in an order the seed shuffles."""

    def __init__(self, traffic: dict, seed: int):
        self.block = block = int(traffic["stratify"])
        self.seed = seed
        self._q = np.array(length_quantiles(traffic["lengths"], block))
        self._blocks: dict[int, np.ndarray] = {}

    def __getitem__(self, i: int) -> Request:
        b = i // self.block
        order = self._blocks.get(b)
        if order is None:
            order = self._q[_rng(self.seed, _STREAM_ORDER, b).permutation(
                self.block)]
            self._blocks[b] = order
        return Request(i, int(order[i % self.block]))


@dataclasses.dataclass
class Outcome:
    """What became of one request (perf_counter seconds throughout).
    ``batch`` is the token matrix of the bucket call that served it, the
    one object every request of that call shares."""

    index: int
    length: int
    due: float
    sent: float = 0.0
    done: float | None = None
    ok: bool = False
    error: str | None = None
    bucket: tuple | None = None
    batch: object = None
    output: object = None


class Client:
    """Sends a tape to a started server over one window and records every
    outcome.  ``keep`` names the requests whose outputs are kept for the
    correctness check; every other output is dropped when it arrives."""

    def __init__(self, server, *, vocab: int, seed: int,
                 keep: frozenset = frozenset(), spans: bool = False):
        self.server = server
        self.vocab = vocab
        self.seed = seed
        self.keep = keep
        self.outcomes: list[Outcome] = []
        # (name, t0, t1) of the client's own host spans, when asked for:
        # bench.submit, bench.sleep (no request due yet), bench.wait (every
        # client waiting for an answer).
        self.spans: list | None = [] if spans else None
        self._done = queue.SimpleQueue()
        self._cv = threading.Condition()
        self._resolved = 0
        self.t_open = self.t_close = 0.0
        self.late_s = 0.0

    def _submit(self, req: Request, due: float) -> Outcome:
        tokens = request_tokens(self.seed, req.index, req.length, self.vocab)
        rec = Outcome(req.index, req.length, due)
        self.outcomes.append(rec)
        rec.sent = time.perf_counter()
        self.late_s = max(self.late_s, rec.sent - due)
        fut = self.server.submit(tokens)
        self._span("bench.submit", rec.sent)
        fut.add_done_callback(lambda f, rec=rec: self._resolve(f, rec))
        return rec

    def _span(self, name: str, t0: float) -> None:
        if self.spans is not None:
            self.spans.append((name, t0, time.perf_counter()))

    def _sleep_until(self, t: float) -> None:
        t0 = time.perf_counter()
        if t > t0:
            time.sleep(t - t0)
            self._span("bench.sleep", t0)

    def _resolve(self, fut, rec: Outcome) -> None:
        rec.done = getattr(fut, "done_s", None) or time.perf_counter()
        exc = fut.exception()
        if exc is not None:
            rec.error = type(exc).__name__
        else:
            rec.ok = True
            rec.bucket = getattr(fut, "bucket", None)
            rec.batch = getattr(fut, "packed", None)
            if rec.index in self.keep:
                rec.output = fut.result()
        with self._cv:
            self._resolved += 1
            self._cv.notify_all()
        self._done.put(rec)

    def run_open(self, tape: list[Request], seconds: float) -> None:
        """Send each request at its due time; return when the window
        closes."""
        self.t_open = time.perf_counter()
        self.t_close = self.t_open + seconds
        for req in tape:
            due = self.t_open + req.due
            self._sleep_until(due)
            self._submit(req, due)
        self._sleep_until(self.t_close)

    def run_closed(self, tape: ClosedTape, clients: int,
                   seconds: float) -> None:
        """``clients`` clients, each sending its next request as soon as
        its last one resolves, until the window closes."""
        self.t_open = time.perf_counter()
        self.t_close = self.t_open + seconds
        nxt = 0
        for _ in range(clients):
            self._submit(tape[nxt], time.perf_counter())
            nxt += 1
        while True:
            t0 = time.perf_counter()
            left = self.t_close - t0
            if left <= 0:
                return
            try:
                self._done.get(timeout=left)
            except queue.Empty:
                return
            finally:
                self._span("bench.wait", t0)
            if time.perf_counter() < self.t_close:
                self._submit(tape[nxt], time.perf_counter())
                nxt += 1

    def drain(self, limit_s: float) -> bool:
        """Wait, at most ``limit_s`` past the window's close, for every
        request sent to resolve; True when all did."""
        end = self.t_close + limit_s
        with self._cv:
            while self._resolved < len(self.outcomes):
                left = end - time.perf_counter()
                if left <= 0:
                    return False
                self._cv.wait(left)
        return True


def completed_in_window(outcomes, t_open: float, t_close: float) -> list:
    return [o for o in outcomes
            if o.ok and o.done is not None and t_open <= o.done <= t_close]


def closed_window_end(outcomes, t_close: float) -> float:
    """Where a closed loop's window ends: at the first result at or after
    its close (every request of that bucket call shares the stamp), so the
    window holds whole calls and a rate over it moves by less than one."""
    after = [o.done for o in outcomes
             if o.ok and o.done is not None and o.done >= t_close]
    return min(after, default=t_close)


def latency_quantile(outcomes, q: float, t_end: float) -> float:
    """The ``q`` quantile (nearest rank) of latency from due time to
    result over every outcome, in seconds; one that failed or never
    resolved ranks above every served one.  Where the rank falls on those,
    the value is the longest wait among them as of ``t_end``, a lower
    bound."""
    if not outcomes:
        raise ValueError("no requests to take a quantile of")
    served = sorted(o.done - o.due for o in outcomes if o.ok)
    rank = max(1, math.ceil(q * len(outcomes)))
    if rank <= len(served):
        return served[rank - 1]
    missed = [(o.done if o.done is not None else t_end) - o.due
              for o in outcomes if not o.ok]
    return max(missed + served[-1:])
