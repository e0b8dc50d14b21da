"""The load generator: seeded tapes with the same work for every seed,
latency from the due time through a scripted stall, misses for failed and
unanswered requests, and a closed loop that keeps its clients busy."""
import collections
import queue
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest

import loadgen

ONLINE = {"rate_rps": 40.0,
          "lengths": {"dist": "lognormal", "median": 64, "sigma": 0.8,
                      "min": 16, "max": 256}}
BACKLOG = {"stratify": 64,
           "lengths": {"dist": "uniform", "min": 192, "max": 256}}
BIG_SEEDS = (0, 2 ** 31 + 5, 2 ** 40 + 3)


def test_uniform_quantiles_cover_each_length_once():
    assert loadgen.length_quantiles(BACKLOG["lengths"], 65) == \
        list(range(192, 257))


def test_lognormal_quantiles():
    xs = loadgen.length_quantiles(ONLINE["lengths"], 1001)
    assert xs == sorted(xs) and min(xs) >= 16 and max(xs) == 256
    assert xs[500] == 64


@pytest.mark.parametrize("seed", BIG_SEEDS)
def test_open_tape_same_work_every_seed(seed):
    a = loadgen.open_tape(ONLINE, 10.0, seed)
    b = loadgen.open_tape(ONLINE, 10.0, seed + 1)
    assert len(a) == len(b) == 400
    assert sorted(r.length for r in a) == sorted(r.length for r in b)
    gaps = lambda t: sorted(np.round(np.diff([0] + [r.due for r in t]), 9))
    assert gaps(a) == pytest.approx(gaps(b))
    assert [r.length for r in a] != [r.length for r in b]
    assert all(0 < r.due < 10.0 for r in a)
    assert [r.due for r in a] == sorted(r.due for r in a)
    assert [(r.length, r.due) for r in a] == \
        [(r.length, r.due) for r in loadgen.open_tape(ONLINE, 10.0, seed)]


@pytest.mark.parametrize("seed", BIG_SEEDS)
def test_open_tape_is_one_cycle_opened_where_the_seed_says(seed):
    """Every seed replays one order of gaps and lengths, a rotation of it:
    the same bursts, the window opening at another point of the cycle."""
    gl = lambda t: list(zip(
        np.round(np.diff([0] + [r.due for r in t]) * 1e6).astype(int),
        [r.length for r in t]))
    a = gl(loadgen.open_tape(ONLINE, 10.0, seed))
    b = gl(loadgen.open_tape(ONLINE, 10.0, seed + 7))
    assert a != b
    assert any(b == (a + a)[k:k + len(a)] for k in range(1, len(a)))


def test_open_tape_arrivals_are_as_bursty_as_poisson():
    """Counts in one-second bins spread as a Poisson process's do (their
    variance near their mean), not smoothed block by block."""
    ratios = []
    for seed in BIG_SEEDS:
        tape = loadgen.open_tape(ONLINE, 100.0, seed)
        per_s = np.bincount([int(r.due) for r in tape], minlength=100)
        ratios.append(per_s.var() / per_s.mean())
    assert 0.6 < float(np.mean(ratios)) < 1.5, ratios


@pytest.mark.parametrize("seed", BIG_SEEDS)
def test_closed_tape_blocks_hold_the_same_lengths(seed):
    tape = loadgen.ClosedTape(BACKLOG, seed)
    want = sorted(loadgen.length_quantiles(BACKLOG["lengths"], 64))
    for b in range(3):
        assert sorted(tape[i].length for i in range(64 * b, 64 * b + 64)) \
            == want
    other = loadgen.ClosedTape(BACKLOG, seed + 1)
    assert [tape[i].length for i in range(64)] != \
        [other[i].length for i in range(64)]


def test_request_tokens_depend_on_seed_and_index():
    a = loadgen.request_tokens(2 ** 40, 3, 17, 1000)
    assert a.shape == (17,) and a.dtype == np.int64
    assert (a == loadgen.request_tokens(2 ** 40, 3, 17, 1000)).all()
    assert not (a == loadgen.request_tokens(2 ** 40, 4, 17, 1000)).all()
    assert 0 <= a.min() and a.max() < 1000


class FakeServer:
    """Serves one request at a time after ``service_s``; ``stall`` maps a
    request's arrival number to an extra pause before it; ``fail`` and
    ``drop`` name arrivals that fail or are never answered."""

    def __init__(self, service_s=0.002, stall=None, fail=(), drop=()):
        self.service_s = service_s
        self.stall = stall or {}
        self.fail, self.drop = set(fail), set(drop)
        self.q = queue.SimpleQueue()
        self.n = 0
        self.outstanding = 0
        self.max_outstanding = 0
        self.lock = threading.Lock()
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    def submit(self, tokens):
        fut = Future()
        with self.lock:
            k = self.n
            self.n += 1
            self.outstanding += 1
            self.max_outstanding = max(self.max_outstanding,
                                       self.outstanding)
        self.q.put((k, tokens, fut))
        return fut

    def _loop(self):
        while True:
            k, tokens, fut = self.q.get()
            if k is None:
                return
            time.sleep(self.service_s + self.stall.get(k, 0.0))
            if k in self.drop:
                continue
            with self.lock:
                self.outstanding -= 1
            fut.done_s = time.perf_counter()
            fut.bucket, fut.packed = (1, len(tokens)), object()
            if k in self.fail:
                fut.set_exception(RuntimeError("boom"))
            else:
                fut.set_result(np.asarray(tokens) * 2)

    def close(self):
        self.q.put((None, None, None))
        self.thread.join(5)


def test_stall_counts_from_the_due_time():
    tape = [loadgen.Request(i, 8, 0.01 * i) for i in range(40)]
    srv = FakeServer(stall={10: 0.25})
    try:
        cl = loadgen.Client(srv, vocab=100, seed=1, keep=frozenset({3}))
        cl.run_open(tape, 0.5)
        assert cl.drain(5.0)
    finally:
        srv.close()
    lat = {o.index: o.done - o.due for o in cl.outcomes}
    # requests due during the stall wait for it, from when they were due
    assert lat[11] > 0.2 and lat[12] > 0.19
    assert lat[5] < 0.05
    assert cl.outcomes[3].output is not None
    assert all(o.output is None for o in cl.outcomes if o.index != 3)
    p95 = loadgen.latency_quantile(cl.outcomes, 0.95, time.perf_counter())
    assert p95 > 0.1


def test_failed_and_unanswered_rank_above_every_served():
    tape = [loadgen.Request(i, 8, 0.002 * i) for i in range(20)]
    srv = FakeServer(fail={0, 1}, drop={2})
    try:
        cl = loadgen.Client(srv, vocab=100, seed=1)
        cl.run_open(tape, 0.1)
        assert not cl.drain(0.3)
    finally:
        srv.close()
    bad = [o for o in cl.outcomes if not o.ok]
    assert sorted(o.index for o in bad) == [0, 1, 2]
    assert {o.error for o in bad} == {"RuntimeError", None}
    served = max(o.done - o.due for o in cl.outcomes if o.ok)
    t_end = time.perf_counter()
    # 3 of 20 missed: the 90th percentile (rank 18) is a miss
    assert loadgen.latency_quantile(cl.outcomes, 0.90, t_end) >= served
    assert loadgen.latency_quantile(cl.outcomes, 0.85, t_end) == \
        pytest.approx(served)


def test_closed_loop_keeps_each_client_busy():
    srv = FakeServer(service_s=0.003)
    try:
        cl = loadgen.Client(srv, vocab=100, seed=2)
        cl.run_closed(loadgen.ClosedTape(BACKLOG, 2), 4, 0.4)
        assert cl.drain(5.0)
    finally:
        srv.close()
    assert srv.max_outstanding == 4
    assert len(cl.outcomes) > 40
    assert [o.index for o in cl.outcomes] == list(range(len(cl.outcomes)))
    done = loadgen.completed_in_window(cl.outcomes, cl.t_open, cl.t_close)
    assert len(cl.outcomes) - 4 <= len(done) <= len(cl.outcomes)
    counts = collections.Counter(o.length for o in cl.outcomes[:64])
    assert set(counts) <= set(range(192, 257))


def test_closed_window_ends_at_the_first_result_after_its_close():
    outs = [loadgen.Outcome(i, 8, 0.0, done=d, ok=ok) for i, (d, ok) in
            enumerate([(0.5, True), (1.0, True), (1.2, False),
                       (1.3, True), (1.3, True), (1.6, True), (None, False)])]
    assert loadgen.closed_window_end(outs, 1.1) == 1.3
    assert loadgen.closed_window_end(outs, 1.0) == 1.0
    assert loadgen.closed_window_end(outs, 2.0) == 2.0
    done = loadgen.completed_in_window(outs, 0.0, 1.3)
    assert [o.index for o in done] == [0, 1, 3, 4]
