"""Synthetic Poisson load for the online serving path and its tests.

Open-loop arrivals: inter-arrival gaps are exponential at the offered
rate and do **not** wait for completions, so under overload the queue
grows and admission control (not the generator) decides who gets served
— the regime where continuous batching earns its throughput.  The
schedule is fully determined by its seed (``random.Random``, no global
RNG), and the token ids by theirs (numpy), both as in the reference's
``repro.serving.loadgen``: one seed gives both packages the same arrival
tape and the same requests.
"""
from __future__ import annotations

import dataclasses
import random
import time
from collections.abc import Sequence

import numpy as np

from .server import RequestFuture, RequestShed, Server


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One scheduled request: arrival offset (s) and prompt length."""

    at_s: float
    length: int


def poisson_schedule(n: int, rate_rps: float,
                     lengths: tuple[int, int],
                     seed: int = 0) -> list[Arrival]:
    """``n`` arrivals at ``rate_rps`` with lengths uniform in
    ``lengths`` (inclusive), deterministic under ``seed``."""
    if n <= 0:
        raise ValueError(f"need a positive request count, got {n}")
    if rate_rps <= 0:
        raise ValueError(f"need a positive rate, got {rate_rps}")
    lo, hi = lengths
    rng = random.Random(seed)
    t = 0.0
    out: list[Arrival] = []
    for _ in range(n):
        t += rng.expovariate(rate_rps)
        out.append(Arrival(at_s=t, length=rng.randint(lo, hi)))
    return out


def make_tokens(length: int, vocab: int, seed: int) -> np.ndarray:
    """Deterministic token ids for one request."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, size=(length,), dtype=np.int32)


@dataclasses.dataclass
class LoadReport:
    """Outcome of one load run; latencies cover ok requests only.
    ``served`` holds ``(tokens, future)`` of every ok request, in submit
    order, when the run was asked to keep them (else it is empty)."""

    n: int
    ok: int
    shed: int
    error: int
    wall_s: float
    throughput_rps: float
    p50_us: float
    p99_us: float
    served: list = dataclasses.field(default_factory=list)


def run_load(server: Server, schedule: Sequence[Arrival], *,
             vocab: int, deadline_s: float | None = None,
             seed: int = 0, timeout_s: float | None = None,
             keep: bool = False) -> LoadReport:
    """Replay ``schedule`` against a started server; block until every
    future resolves and aggregate outcomes + client-side latency (submit
    to the server's ``done_s`` stamp).  A future not resolved
    ``timeout_s`` seconds after the last submit counts as an error.
    ``keep`` keeps each served request's tokens and future (its output,
    bucket, row and packed tokens) in ``LoadReport.served``."""
    t0 = time.perf_counter()
    futures: list[tuple[np.ndarray, float, RequestFuture]] = []
    for i, a in enumerate(schedule):
        delay = (t0 + a.at_s) - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        tokens = make_tokens(a.length, vocab, seed=seed * 100003 + i)
        t_sub = time.perf_counter()
        futures.append((tokens, t_sub,
                        server.submit(tokens, deadline_s=deadline_s)))
    ok = shed = error = 0
    lat_us: list[float] = []
    served = []
    t_end = None if timeout_s is None else time.perf_counter() + timeout_s
    for tokens, t_sub, fut in futures:
        try:
            fut.result(None if t_end is None
                       else max(0.0, t_end - time.perf_counter()))
        except RequestShed:
            shed += 1
            continue
        except Exception:
            error += 1
            continue
        ok += 1
        lat_us.append((fut.done_s - t_sub) * 1e6)
        if keep:
            served.append((tokens, fut))
    wall = time.perf_counter() - t0
    lat = np.asarray(lat_us) if lat_us else np.asarray([0.0])
    return LoadReport(
        n=len(schedule), ok=ok, shed=shed, error=error, wall_s=wall,
        throughput_rps=ok / wall if wall > 0 else 0.0,
        p50_us=float(np.percentile(lat, 50)),
        p99_us=float(np.percentile(lat, 99)), served=served)
