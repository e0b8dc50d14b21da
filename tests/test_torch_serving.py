"""Online serving in the port: bucket packer, continuous batcher, admission
control, program cache, microbatching and the Poisson load generator --
the twin of tests/test_serving.py, on the CPU, where each bucket's program
is the eager forward (``engine.programs.EagerProgram``; the CUDA graphs
are in tests/test_torch_programs.py and chip_smoke.py's online phase).

Beside the twins: the ladder, ``pack``, ``poisson_schedule`` and
``make_tokens`` equal the reference's, and the port's server on the smoke
Llama pruned forward agrees with the reference's ``make_pruned_forward``
at the same bucket (f32, 1e-4, as tests/test_torch_serve.py).

Bit-identity on the CPU: a served row equals the eager forward of the
same packed token matrix bit for bit.  Against a solo forward at batch
bucket 1 it holds to f32's 2e-5 only: the SpMM's plain version sums in an
order that follows the number of B's columns (batch x length), and here
the gap is last-bit (7.5e-9 on this file's scorer).

Every future, join and wait has a timeout: nothing here can hang.
"""
import collections
import sys
import threading
import time
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.core import PlanPolicy as JPlanPolicy  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.serving import BucketLadder as JBucketLadder  # noqa: E402
from repro.serving import loadgen as jloadgen  # noqa: E402
from repro.serving import pack as jpack  # noqa: E402
from repro_torch import convert, obs  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import ExecutionConfig  # noqa: E402
from repro_torch.engine import ProgramCache  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import sparse as S  # noqa: E402
from repro_torch.runtime import steps as R  # noqa: E402
from repro_torch.serving import (BucketLadder, Lockstep,  # noqa: E402
                                 RequestShed, Server, ServerClosed, loadgen,
                                 pack)

EC = ExecutionConfig
T = 120                          # seconds: every future, join and wait


# ------------------------------------------------- microbatched ragged ---


def _counted(calls):
    def fn(x):
        calls.append(tuple(x.shape))
        return {"out": x * 2.0, "sum": x.sum(dim=1)}

    return fn


def test_microbatched_ragged_tail():
    """5 rows / microbatch 2: the tail of 1 pads to 2, outputs trim to 5."""
    calls = []
    run = R.microbatched(_counted(calls), 2)
    x = torch.arange(10.0).reshape(5, 2)
    out = run(x)
    assert torch.equal(out["out"], x * 2.0)
    assert torch.equal(out["sum"], x.sum(dim=1))
    assert set(calls) == {(2, 2)}, "padding must not add a second shape"


def test_microbatched_total_smaller_than_microbatch():
    calls = []
    run = R.microbatched(_counted(calls), 4)
    out = run(torch.ones((1, 3)))
    assert tuple(out["out"].shape) == (1, 3)
    assert calls == [(4, 3)]


def test_microbatched_zero_remainder_untrimmed():
    """Exact division: no pad, no trim."""
    calls = []
    run = R.microbatched(_counted(calls), 3)
    x = torch.arange(18.0).reshape(6, 3)
    out = run(x)
    assert tuple(out["out"].shape) == (6, 3)
    assert torch.equal(out["out"], x * 2.0)


def test_microbatched_single_shape_across_ragged_totals():
    """One call shape serves totals 6, 5, 3, 1 at microbatch 3 -- the
    one-program-for-ragged-batches property the serving loop needs."""
    calls = []
    run = R.microbatched(_counted(calls), 3)
    for total in (6, 5, 3, 1):
        out = run(torch.ones((total, 4)))
        assert tuple(out["out"].shape) == (total, 4)
    assert set(calls) == {(3, 4)}, f"expected one shape, saw {calls}"


def test_microbatched_strict_and_empty():
    run = R.microbatched(lambda x: x, 2, pad=False)
    with pytest.raises(ValueError, match="does not divide"):
        run(torch.ones((5, 2)))
    with pytest.raises(ValueError, match="empty"):
        R.microbatched(lambda x: x, 2)(torch.ones((0, 2)))
    with pytest.raises(ValueError, match="positive"):
        R.microbatched(lambda x: x, 0)


def test_microbatched_sparse_linear_bit_identical():
    """Padded-and-trimmed microbatched SpMM == the slices' own rows,
    bitwise."""
    rng = np.random.default_rng(7)
    w = torch.from_numpy(rng.standard_normal((12, 20)).astype(np.float32))
    sl = S.SparseLinear.from_dense(w, 0.4)
    x = torch.from_numpy(rng.standard_normal((5, 3, 12)).astype(np.float32))

    def fn(xi):
        return sl(xi, EC(impl="torch"))

    got = R.microbatched(fn, 2)(x)
    want = torch.stack([fn(x[i:i + 2])[j] for i, j in
                        ((0, 0), (0, 1), (2, 0), (2, 1), (4, 0))])
    assert torch.equal(got, want)


# ------------------------------------------------------- bucket ladder ---


def test_ladder_rounding_and_caps():
    lad = BucketLadder.from_max(100, 8, min_len=8)
    assert lad.lengths == (8, 16, 32, 64, 128)
    assert lad.batches == (1, 2, 4, 8)
    assert lad.length_bucket(1) == 8
    assert lad.length_bucket(9) == 16
    assert lad.length_bucket(128) == 128
    assert lad.batch_bucket(3) == 4
    with pytest.raises(ValueError, match="exceeds the largest bucket"):
        lad.length_bucket(129)
    with pytest.raises(ValueError, match="positive"):
        lad.length_bucket(0)
    with pytest.raises(ValueError, match="ascending"):
        BucketLadder(lengths=(8, 8), batches=(1,))
    with pytest.raises(ValueError, match="empty"):
        BucketLadder(lengths=(), batches=(1,))


def test_ladder_waste_bounded():
    """Above the floor, a power-of-two rung is always < 2x its occupant."""
    lad = BucketLadder.from_max(256, 16, min_len=8)
    for n in range(8, 257):
        assert n <= lad.length_bucket(n) < 2 * n
    for c in range(1, 17):
        assert c <= lad.batch_bucket(c) < 2 * c


def test_pack_groups_fifo_chunks():
    lad = BucketLadder(lengths=(8, 16), batches=(1, 2, 4))
    pbs = pack([3, 12, 8, 15, 2, 9, 1, 5, 7], lad)
    by_len = {pb.length: [] for pb in pbs}
    for pb in pbs:
        by_len[pb.length].extend(pb.indices)
    assert by_len[8] == [0, 2, 4, 6, 7, 8]     # FIFO within a bucket
    assert by_len[16] == [1, 3, 5]
    # 6 short requests at max_batch 4 -> chunks of 4 + 2
    assert [pb.batch for pb in pbs if pb.length == 8] == [4, 2]


def test_pack_exactly_once_fixed_cases():
    lad = BucketLadder.from_max(100, 8)
    for lengths in ([], [1], [100] * 20, [3, 99, 8, 8, 8, 8, 8, 1, 64],
                    list(range(1, 41))):
        served = sorted(i for pb in pack(lengths, lad) for i in pb.indices)
        assert served == list(range(len(lengths)))


def test_poisson_schedule_deterministic():
    for seed in (0, 7, 12345):
        a = loadgen.poisson_schedule(12, 50.0, (1, 32), seed=seed)
        assert a == loadgen.poisson_schedule(12, 50.0, (1, 32), seed=seed)
        assert all(x.at_s <= y.at_s for x, y in zip(a, a[1:]))
        assert all(1 <= x.length <= 32 for x in a)
    assert loadgen.poisson_schedule(12, 50.0, (1, 32), seed=0) != \
        loadgen.poisson_schedule(12, 50.0, (1, 32), seed=1)


@pytest.mark.parametrize("max_len,max_batch,min_len", [
    (100, 8, 8), (32, 4, 8), (256, 16, 4), (5, 1, 8)])
def test_ladder_shapes_and_pack_equal_reference(max_len, max_batch,
                                                min_len):
    lad = BucketLadder.from_max(max_len, max_batch, min_len=min_len)
    jlad = JBucketLadder.from_max(max_len, max_batch, min_len=min_len)
    assert (lad.lengths, lad.batches) == (jlad.lengths, jlad.batches)
    assert lad.shapes() == jlad.shapes()
    lengths = np.random.default_rng(max_len).integers(
        1, lad.max_len + 1, 40).tolist()
    got = [(pb.length, pb.batch, pb.indices) for pb in pack(lengths, lad)]
    want = [(pb.length, pb.batch, pb.indices)
            for pb in jpack(lengths, jlad)]
    assert got == want


@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_schedule_and_tokens_equal_reference(seed):
    got = loadgen.poisson_schedule(20, 37.5, (8, 32), seed=seed)
    want = jloadgen.poisson_schedule(20, 37.5, (8, 32), seed=seed)
    assert [(a.at_s, a.length) for a in got] == \
        [(a.at_s, a.length) for a in want]
    for i, a in enumerate(got):
        np.testing.assert_array_equal(
            loadgen.make_tokens(a.length, 512, seed * 100003 + i),
            jloadgen.make_tokens(a.length, 512, seed * 100003 + i))


# ---------------------------------------------------- server end-to-end ---


def _scorer(seed=11, vocab=37, d_model=16, d_ff=48):
    """Tiny SpMM scorer with a row-independent forward (plain versions)."""
    rng = np.random.default_rng(seed)

    def t(shape):
        return torch.from_numpy(
            rng.normal(0, 0.1, shape).astype(np.float32))

    state = {"embed": t((vocab, d_model)),
             "mlp": S.prune_mlp({"w1": t((d_model, d_ff)),
                                 "w2": t((d_ff, d_model))}, 0.4)}

    def forward(state, tokens):
        h = state["embed"][tokens]
        h = h + S.sparse_mlp_apply(state["mlp"], h, None,
                                   exec=EC(impl="torch"))
        return h @ state["embed"].T

    return forward, state, vocab


def test_server_warmup_builds_every_bucket_and_no_recompiles():
    fwd, state, vocab = _scorer()
    lad = BucketLadder(lengths=(4, 8), batches=(1, 2, 4))
    srv = Server(fwd, state, lad, name="t.warm")
    srv.warmup()
    st_ = srv.programs.stats()
    assert st_.misses == len(lad.shapes()) == 6
    assert sorted(srv.programs.keys()) == sorted(lad.shapes())
    srv.warmup()                      # idempotent: all hits
    assert srv.programs.stats().misses == 6
    assert srv.recompiles() == 0


def test_server_bit_identical_to_packed_forward():
    """Packed rows == the eager forward of the same packed token matrix,
    bitwise, and a solo forward at batch bucket 1 to 2e-5 (another B
    width, so another summation order in the SpMM's plain version).

    Requests of mixed lengths are submitted *before* start() so the
    batcher drains them into maximal packed batches."""
    fwd, state, vocab = _scorer()
    lad = BucketLadder(lengths=(4, 8), batches=(1, 2, 4))
    lens = [3, 8, 4, 7, 1, 5]
    reqs = [loadgen.make_tokens(n, vocab, seed=100 + n) for n in lens]
    srv = Server(fwd, state, lad, name="t.bitid")
    futs = [srv.submit(t) for t in reqs]
    srv.start()
    outs = [f.result(timeout=T) for f in futs]
    srv.stop(timeout=T)
    assert srv.recompiles() == 0
    # All queued before start(): the batcher drains max_batch requests at
    # a time in submission order and packs each drain.
    groups = [(s, pb) for s in range(0, len(lens), lad.max_batch)
              for pb in pack(lens[s:s + lad.max_batch], lad)]
    with torch.no_grad():
        for s, pb in groups:
            mat = np.zeros((pb.batch, pb.length), np.int64)
            for row, i in enumerate(pb.indices):
                mat[row, :lens[s + i]] = reqs[s + i]
            packed = fwd(srv.state, torch.from_numpy(mat))
            for row, i in enumerate(pb.indices):
                assert torch.equal(outs[s + i], packed[row, :lens[s + i]])
        for toks, out in zip(reqs, outs):
            n = len(toks)
            mat = np.zeros((lad.batch_bucket(1), lad.length_bucket(n)),
                           np.int64)
            mat[0, :n] = toks
            want = fwd(state, torch.from_numpy(mat))[0][:n]
            assert tuple(out.shape) == (n, vocab)
            torch.testing.assert_close(out, want, rtol=2e-5, atol=2e-5)
    assert any(pb.batch > 1 for _, pb in groups)


def test_server_batches_instead_of_serving_solo():
    """16 same-length requests, max_batch 8 -> exactly 2 executed batches
    (occupancy histogram count delta), vs 16 for a batch-1 ladder.
    Count-based: no timing."""
    fwd, state, vocab = _scorer()
    occ = obs.registry.get("serve_batch_occupancy")
    reqs = [loadgen.make_tokens(6, vocab, seed=i) for i in range(16)]

    def count_batches(batches):
        srv = Server(fwd, state, BucketLadder(lengths=(8,), batches=batches),
                     name=f"t.occ{len(batches)}")
        before = sum(c.count for c in occ.children())
        futs = [srv.submit(t) for t in reqs]
        srv.start()
        for f in futs:
            f.result(timeout=T)
        srv.stop(timeout=T)
        assert srv.recompiles() == 0
        return sum(c.count for c in occ.children()) - before

    assert count_batches((1, 2, 4, 8)) == 2
    assert count_batches((1,)) == 16


def test_server_sheds_deterministically_under_overload():
    """Bounded queue + expired deadlines: 20 offered, depth 2 -> all 20
    shed (18 at admission, 2 at dequeue), exact counter accounting."""
    fwd, state, vocab = _scorer()
    fam = obs.registry.counter("serve_requests_total",
                               "served requests by outcome",
                               labels=("outcome",))
    shed_c = fam.labels(outcome="shed")
    ok_c = fam.labels(outcome="ok")
    before_shed, before_ok = shed_c.value, ok_c.value
    srv = Server(fwd, state, BucketLadder(lengths=(4,), batches=(1, 2)),
                 queue_depth=2, name="t.shed")
    futs = [srv.submit(loadgen.make_tokens(4, vocab, seed=i),
                       deadline_s=1e-9) for i in range(20)]
    srv.start()
    for f in futs:
        with pytest.raises(RequestShed):
            f.result(timeout=T)
    srv.stop(timeout=T)
    assert shed_c.value - before_shed == 20
    assert ok_c.value - before_ok == 0
    with pytest.raises(ServerClosed):
        srv.submit(loadgen.make_tokens(4, vocab, seed=0))


def test_server_rejects_oversized_and_bad_requests():
    fwd, state, vocab = _scorer()
    srv = Server(fwd, state, BucketLadder(lengths=(4,), batches=(1,)),
                 name="t.rej")
    with pytest.raises(ValueError, match="exceeds the largest bucket"):
        srv.submit(np.zeros(5, np.int32))
    with pytest.raises(ValueError, match="1-D"):
        srv.submit(np.zeros((2, 3), np.int32))
    with pytest.raises(ValueError, match="integers"):
        srv.submit(np.zeros(3, np.float32))


def test_server_retries_transient_failures():
    """Two injected OSErrors then success: the request completes, and the
    retries land on serve_retries_total."""
    fwd, state, vocab = _scorer()

    class Flaky(Server):
        fails = 2

        def _call_program(self, program, tokens):
            if self.fails:
                self.fails -= 1
                raise OSError("injected transient fault")
            return super()._call_program(program, tokens)

    retries = obs.registry.counter(
        "serve_retries_total", "transient execution failures retried")
    before = retries.value
    srv = Flaky(fwd, state, BucketLadder(lengths=(4,), batches=(1,)),
                retry_backoff_s=0.001, name="t.retry")
    fut = srv.submit(loadgen.make_tokens(3, vocab, seed=1))
    srv.start()
    out = fut.result(timeout=T)
    srv.stop(timeout=T)
    assert tuple(out.shape) == (3, vocab)
    assert retries.value - before == 2


def test_server_exhausted_retries_fail_the_future():
    fwd, state, vocab = _scorer()

    class Dead(Server):
        def _call_program(self, program, tokens):
            raise OSError("permanent fault")

    srv = Dead(fwd, state, BucketLadder(lengths=(4,), batches=(1,)),
               retry_attempts=2, retry_backoff_s=0.001, name="t.dead")
    fut = srv.submit(loadgen.make_tokens(2, vocab, seed=1))
    srv.start()
    with pytest.raises(OSError, match="permanent"):
        fut.result(timeout=T)
    srv.stop(timeout=T)


# ------------------------------------------------- lockstep over a mesh ---


class _Channel(Lockstep):
    """A lockstep channel without a process group: the leader's messages
    are recorded, a follower's are scripted."""

    def __init__(self, rank, script=()):
        self.rank, self.world = rank, 2
        self.sent, self.script = [], list(script)

    def send(self, op, batch=0, length=0, tokens=None):
        self.sent.append((op, batch, length, tokens))

    def recv(self):
        return self.script.pop(0)


def test_lockstep_leader_announces_every_build_and_call():
    """The leader sends a build before each program it builds, WARM after
    warmup, RUN with the packed tokens before each call, STOP after the
    batcher ends; retries are off; a ladder the program cache cannot hold
    whole is refused."""
    fwd, state, vocab = _scorer()
    lad = BucketLadder(lengths=(4,), batches=(1, 2))
    ch = _Channel(0)
    srv = Server(fwd, state, lad, lockstep=ch, name="t.lead")
    assert srv.retry_attempts == 1
    srv.warmup()
    assert [m[:3] for m in ch.sent] == [("build", 1, 4), ("build", 2, 4),
                                        ("warm", 0, 0)]
    futs = [srv.submit(loadgen.make_tokens(n, vocab, seed=n))
            for n in (3, 4)]
    srv.start()
    outs = [f.result(timeout=T) for f in futs]
    srv.stop(timeout=T)
    runs = [m for m in ch.sent if m[0] == "run"]
    assert len(runs) == 1 and runs[0][1:3] == (2, 4)
    np.testing.assert_array_equal(runs[0][3].numpy(), futs[0].packed)
    assert ch.sent[-1][:3] == ("stop", 0, 0)
    assert (srv.forwards, list(srv.ran)) == (1, [(2, 4)])
    with torch.inference_mode():
        want = fwd(state, torch.from_numpy(futs[0].packed))
    for i, out in enumerate(outs):
        assert torch.equal(out, want[i, :3 + i])
    with pytest.raises(ValueError, match="keeps every bucket"):
        Server(fwd, state, BucketLadder(lengths=tuple(range(1, 66)),
                                        batches=(1,)), lockstep=_Channel(0))


def test_lockstep_leader_failure_fails_the_rest_and_holds_the_followers():
    """An execution error under lockstep: one attempt, that batch's and
    every queued request's futures fail, later submits are refused, and
    stop() raises without sending STOP."""
    fwd, state, vocab = _scorer()
    calls = []

    class Dead(Server):
        def _call_program(self, program, tokens):
            calls.append(tuple(tokens.shape))
            raise OSError("permanent fault")

    ch = _Channel(0)
    srv = Dead(fwd, state, BucketLadder(lengths=(4,), batches=(1,)),
               lockstep=ch, name="t.lead_dead").warmup()
    futs = [srv.submit(loadgen.make_tokens(2, vocab, seed=s))
            for s in range(3)]
    srv.start()
    for f in futs:
        with pytest.raises(OSError, match="permanent"):
            f.result(timeout=T)
    assert calls == [(1, 4)]
    with pytest.raises(RuntimeError, match="failed under lockstep"):
        srv.stop(timeout=T)
    with pytest.raises(ServerClosed):
        srv.submit(loadgen.make_tokens(2, vocab, seed=9))
    assert "stop" not in [m[0] for m in ch.sent]


def test_lockstep_failure_fails_the_rest_of_its_window_unrun():
    """Two length buckets drained in one window, the first one's forward
    raising: its RUN is the only one sent, and both buckets' futures and
    the queued request's fail (the followers may still wait in the failed
    bucket's collectives, so nothing more may run)."""
    fwd, state, vocab = _scorer()
    calls = []

    def dead(st, tok):
        calls.append(tuple(tok.shape))
        raise OSError("permanent fault")

    ch = _Channel(0)
    srv = Server(dead, state, BucketLadder(lengths=(4, 8), batches=(1, 2)),
                 lockstep=ch, batch_window_s=5.0, name="t.lead_window")
    srv.warmup()
    assert calls == []
    futs = [srv.submit(loadgen.make_tokens(n, vocab, seed=n))
            for n in (3, 7, 2)]
    srv.start()
    for f in futs:
        with pytest.raises(OSError, match="permanent"):
            f.result(timeout=T)
    runs = [m[:3] for m in ch.sent if m[0] == "run"]
    assert len(runs) == 1 and len(calls) == 1
    assert runs[0][1:] == calls[0] in ((1, 4), (1, 8))
    assert srv.forwards == 0
    with pytest.raises(RuntimeError, match="failed under lockstep"):
        srv.stop(timeout=T)
    assert "stop" not in [m[0] for m in ch.sent]


def test_lockstep_follower_runs_what_the_leader_says():
    """A follower builds at BUILD, ends its warmup at WARM, runs RUN's
    tokens, skips IDLE and returns at STOP; it takes no request."""
    fwd, state, vocab = _scorer()
    seen = []

    def counted(st, tok):
        seen.append(tok.clone())
        return fwd(st, tok)

    tok = torch.from_numpy(np.stack([loadgen.make_tokens(
        4, vocab, seed=s) for s in (1, 2)]).astype(np.int64))
    ch = _Channel(1, [("build", 1, 4, None), ("build", 2, 4, None),
                      ("warm", 0, 0, None), ("run", 2, 4, tok),
                      ("idle", 0, 0, None), ("stop", 0, 0, None)])
    srv = Server(counted, state, BucketLadder(lengths=(4,), batches=(1, 2)),
                 lockstep=ch, name="t.follow")
    srv.warmup()
    assert sorted(srv.programs.keys()) == [(1, 4), (2, 4)]
    assert len(ch.script) == 3
    for what in (lambda: srv.submit(tok[0].numpy()), srv.start,
                 lambda: srv.probe(1, 4)):
        with pytest.raises(RuntimeError, match="follows rank 0"):
            what()
    assert srv.forwards == 0
    srv.follow()
    assert ch.script == [] and len(seen) == 1
    assert torch.equal(seen[0], tok)
    assert srv.recompiles() == 0
    assert (srv.forwards, list(srv.ran)) == (1, [(2, 4)])


def test_server_concurrent_submitters():
    """Many client threads racing submit, the interpreter switching
    threads often: every request served once, each with its own rid."""
    fwd, state, vocab = _scorer()
    srv = Server(fwd, state, BucketLadder(lengths=(8,), batches=(1, 4)),
                 name="t.conc").start()
    results, rids = {}, {}

    def client(i):
        n = 1 + (i % 8)
        fut = srv.submit(loadgen.make_tokens(n, vocab, seed=i))
        rids[i] = fut.rid
        results[i] = tuple(fut.result(timeout=T).shape) == (n, vocab)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(48)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=T)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    srv.stop(timeout=T)
    assert len(results) == 48 and all(results.values())
    assert sorted(rids.values()) == list(range(48))
    assert srv.recompiles() == 0


# ------------------------------------------------------- program cache ---


def test_program_cache_hit_miss_evict():
    pc = ProgramCache(maxsize=2, name="t.pc")
    built = []

    def mk(k):
        return lambda: built.append(k) or k

    assert pc.get("a", mk("a")) == "a"
    assert pc.get("a", mk("a2")) == "a"
    assert pc.get("b", mk("b")) == "b"
    assert pc.get("c", mk("c")) == "c"          # evicts "a" (LRU)
    assert pc.keys() == ["b", "c"]
    s = pc.stats()
    assert (s.hits, s.misses, s.evictions, s.size) == (1, 3, 1, 2)
    assert built == ["a", "b", "c"]
    pc.clear()
    assert len(pc) == 0 and pc.stats().misses == 0


# -------------------------------------------------------- serve.py CLI ---


def test_serve_flags_require_prune_ffn(capsys):
    for argv in (["--microbatch", "2"], ["--spmm-method", "merge"],
                 ["--serve"]):
        with pytest.raises(SystemExit) as ei:
            serve.main(argv + ["--smoke", "--device", "cpu"])
        assert ei.value.code == 2
        assert "no effect without --prune-ffn" in capsys.readouterr().err


def test_check_replans_raises():
    assert serve._check_replans(SimpleNamespace(misses=3),
                                SimpleNamespace(misses=3)) == 0
    with pytest.raises(RuntimeError, match="replanned: 2"):
        serve._check_replans(SimpleNamespace(misses=3),
                             SimpleNamespace(misses=5))


# ------------------------------------------------------------- loadgen ---


def test_run_load_serves_schedule():
    fwd, state, vocab = _scorer()
    srv = Server(fwd, state, BucketLadder(lengths=(4, 8), batches=(1, 2)),
                 name="t.load").start()
    sched = loadgen.poisson_schedule(8, 500.0, (1, 8), seed=5)
    rep = loadgen.run_load(srv, sched, vocab=vocab, seed=5, timeout_s=T)
    srv.stop(timeout=T)
    assert (rep.n, rep.ok, rep.shed, rep.error) == (8, 8, 0, 0)
    assert rep.throughput_rps > 0 and rep.p99_us >= rep.p50_us
    assert srv.recompiles() == 0


def test_run_load_keeps_served_requests_at_their_buckets():
    """``keep``: every served request's future names the bucket, row and
    packed token matrix it ran in, and its rows are bit-equal to the eager
    forward of that matrix; each future was stamped (``done_s``) before it
    resolved, so the latencies need no done-callback."""
    fwd, state, vocab = _scorer()
    srv = Server(fwd, state, BucketLadder(lengths=(4, 8), batches=(1, 2)),
                 name="t.keep").start()
    sched = loadgen.poisson_schedule(12, 2000.0, (1, 8), seed=9)
    rep = loadgen.run_load(srv, sched, vocab=vocab, seed=9, timeout_s=T,
                           keep=True)
    srv.stop(timeout=T)
    assert rep.ok == len(rep.served) == 12
    with torch.no_grad():
        for tokens, fut in rep.served:
            n = len(tokens)
            assert fut.bucket == fut.packed.shape
            assert fut.bucket in srv.ladder.shapes()
            np.testing.assert_array_equal(fut.packed[fut.row, :n], tokens)
            want = fwd(srv.state, torch.from_numpy(fut.packed))
            assert torch.equal(fut.result(timeout=T), want[fut.row, :n])
            assert fut.done_s is not None
    srv = Server(fwd, state, BucketLadder(lengths=(8,), batches=(1,)),
                 name="t.nokeep").start()
    plain = loadgen.run_load(srv, sched[:2], vocab=vocab, timeout_s=T)
    srv.stop(timeout=T)
    assert plain.ok == 2 and plain.served == []


def test_shed_and_failed_futures_are_stamped():
    fwd, state, vocab = _scorer()

    class Broken(Server):
        def _call_program(self, program, tokens):
            raise ValueError("not transient")

    srv = Broken(fwd, state, BucketLadder(lengths=(8,), batches=(1,)),
                 queue_depth=1, name="t.stamp")
    kept = srv.submit(loadgen.make_tokens(3, vocab, seed=1))
    shed = srv.submit(loadgen.make_tokens(3, vocab, seed=2))
    with pytest.raises(RequestShed):
        shed.result(timeout=T)
    assert shed.done_s is not None and shed.bucket is None
    srv.start()
    with pytest.raises(ValueError, match="not transient"):
        kept.result(timeout=T)
    srv.stop(timeout=T)
    assert kept.done_s is not None and kept.bucket == (1, 8)


def test_loadgen_rejects_degenerate_schedules():
    with pytest.raises(ValueError, match="positive request count"):
        loadgen.poisson_schedule(0, 1.0, (1, 4))
    with pytest.raises(ValueError, match="positive rate"):
        loadgen.poisson_schedule(1, 0.0, (1, 4))


def _children(name):
    fam = obs.registry.get(name)
    return {} if fam is None else {tuple(c.labels.items()): c
                                   for c in fam.children()}


def _counts(name):
    return {k: c.count for k, c in _children(name).items()}


def _sums(name):
    return {k: c.sum for k, c in _children(name).items()}


def _delta(after, before):
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v - before.get(k, 0)}


PHASES = ("idle", "window", "assemble", "launch", "sync", "resolve")


def test_server_latency_phases_recorded():
    """A request observes queue_wait, batch_wait and total once; its call
    observes assemble, launch, sync and resolve once, its window window
    once; idle closes at the window's first dequeue and at the end."""
    fwd, state, vocab = _scorer()
    before = _counts("serve_request_latency_us")
    phases = _counts("serve_batcher_us")
    srv = Server(fwd, state, BucketLadder(lengths=(4,), batches=(1,)),
                 name="t.lat").start()
    srv.submit(loadgen.make_tokens(3, vocab, seed=2)).result(timeout=T)
    srv.stop(timeout=T)
    assert _delta(_counts("serve_request_latency_us"), before) == {
        (("phase", p),): 1 for p in ("queue_wait", "batch_wait", "total")}
    want = {(("phase", p),): 1 for p in PHASES}
    want[(("phase", "idle"),)] = 2
    assert _delta(_counts("serve_batcher_us"), phases) == want


def _scripted(monkeypatch, launch_s, sync_s):
    """The scorer with a scripted cost a served call: its forward sleeps
    ``launch_s(i)`` and the stream's sync ``sync_s(i)`` on the ``i``-th
    call after ``arm()`` (the CPU's sync drains nothing by itself)."""
    from repro_torch.serving import server as server_mod
    fwd, state, vocab = _scorer()
    calls = {"fwd": None, "sync": None}

    def forward(st, tokens):
        if calls["fwd"] is not None:
            time.sleep(launch_s(calls["fwd"]))
            calls["fwd"] += 1
        return fwd(st, tokens)

    def sync(device):
        if calls["sync"] is not None:
            time.sleep(sync_s(calls["sync"]))
            calls["sync"] += 1

    def arm():
        calls["fwd"] = calls["sync"] = 0

    monkeypatch.setattr(server_mod, "_sync", sync)
    return forward, state, vocab, arm


def test_server_phases_tile_the_batchers_wall_time(monkeypatch):
    """Six calls that each launch for 10 ms and sync for 20 ms, 40 ms
    apart: the six phases sum to the wall time from start() to stop()
    within 5 %, sync holds at least the scripted syncs, launch the
    scripted forwards, and a call's device time (on the CPU, launch to
    sync) both."""
    forward, state, vocab, arm = _scripted(
        monkeypatch, lambda i: 0.01, lambda i: 0.02)
    srv = Server(forward, state, BucketLadder(lengths=(4,), batches=(1,)),
                 name="t.tile").warmup()
    arm()
    sums, dev = _sums("serve_batcher_us"), _sums("serve_call_device_us")
    t0 = time.perf_counter()
    srv.start()
    for i in range(6):
        srv.submit(loadgen.make_tokens(3, vocab, seed=i)).result(timeout=T)
        time.sleep(0.04)
    srv.stop(timeout=T)
    wall = time.perf_counter() - t0
    got = {k[0][1]: v / 1e6 for k, v in
           _delta(_sums("serve_batcher_us"), sums).items()}
    assert set(got) == set(PHASES)
    assert 0.95 * wall <= sum(got.values()) <= wall
    assert got["sync"] >= 6 * 0.02 and got["launch"] >= 6 * 0.01
    assert got["idle"] >= 5 * 0.04
    (device_us,) = _delta(_sums("serve_call_device_us"), dev).values()
    assert device_us / 1e6 >= 6 * (0.01 + 0.02)


def test_later_bucket_of_a_window_waits_out_the_earlier_calls(monkeypatch):
    """Two lengths in one window run as two bucket calls, one after the
    other: the second call's request shows a batch_wait of at least the
    first call's launch + sync (here 30 + 30 ms, the second call's
    nothing)."""
    forward, state, vocab, arm = _scripted(
        monkeypatch, lambda i: 0.03 if i == 0 else 0.0,
        lambda i: 0.03 if i == 0 else 0.0)
    srv = Server(forward, state,
                 BucketLadder(lengths=(4, 8), batches=(1, 2)),
                 name="t.bwait").warmup()
    futs = [srv.submit(loadgen.make_tokens(n, vocab, seed=n))
            for n in (3, 7)]
    fams = [obs.registry.get(n) for n in ("serve_request_latency_us",
                                          "serve_batcher_us")]
    for fam in fams:
        fam.reset()
    arm()
    srv.start()
    for f in futs:
        f.result(timeout=T)
    srv.stop(timeout=T)
    assert {f.bucket for f in futs} == {(1, 4), (1, 8)}
    wait = fams[0].labels(phase="batch_wait").snapshot()
    launch = fams[1].labels(phase="launch").snapshot()
    sync = fams[1].labels(phase="sync").snapshot()
    assert wait["count"] == launch["count"] == sync["count"] == 2
    assert launch["max"] >= 3e4 and sync["max"] >= 3e4
    assert wait["min"] < launch["max"]
    assert wait["max"] >= launch["max"] + sync["max"]


def test_call_device_time_once_a_served_call_by_bucket():
    """serve_call_device_us: one observation a served call under its
    bucket's labels; the probe and the programs' build observe none."""
    fwd, state, vocab = _scorer()
    before = _counts("serve_call_device_us")
    srv = Server(fwd, state,
                 BucketLadder(lengths=(4, 8), batches=(1, 2, 4)),
                 name="t.dev").warmup()
    srv.probe(2, 8)
    assert _delta(_counts("serve_call_device_us"), before) == {}
    futs = [srv.submit(loadgen.make_tokens(n, vocab, seed=n))
            for n in (3, 7, 8)]
    srv.start()
    for f in futs:
        f.result(timeout=T)
    srv.stop(timeout=T)
    assert _delta(_counts("serve_call_device_us"), before) == {
        (("batch", "1"), ("length", "4")): 1,
        (("batch", "2"), ("length", "8")): 1}


def test_traced_requests_land_in_exactly_one_call():
    """Under tracing: every enqueued rid is in one call's rids, and only
    one; a call's batch, execute and resolve spans share its call id; each
    window has its idle and window spans; a span's ts lies between two
    perf_counter() reads around the run; the export names its clock."""
    fwd, state, vocab = _scorer()
    lad = BucketLadder(lengths=(4, 8), batches=(1, 2))
    with obs.tracing() as tr:
        t0 = time.perf_counter()
        srv = Server(fwd, state, lad, name="t.rids").warmup()
        futs = [srv.submit(loadgen.make_tokens(n, vocab, seed=i))
                for i, n in enumerate((3, 7, 2, 8, 5))]
        srv.start()
        for f in futs:
            f.result(timeout=T)
        futs.append(srv.submit(loadgen.make_tokens(4, vocab, seed=9)))
        futs[-1].result(timeout=T)
        srv.stop(timeout=T)
        t1 = time.perf_counter()
        doc = tr.chrome_trace()
    evs = [e for e in doc["traceEvents"] if e["cat"] == "serve"]
    by = collections.defaultdict(list)
    for e in evs:
        by[e["name"]].append(e)
    rids = [e["args"]["rid"] for e in by["serve.enqueue"]]
    assert sorted(rids) == sorted(f.rid for f in futs) == list(range(6))
    called = [r for e in by["serve.batch"] for r in e["args"]["rids"]]
    assert sorted(called) == sorted(rids)
    calls = {e["args"]["call"] for e in by["serve.batch"]}
    assert len(calls) == len(by["serve.batch"]) >= 3
    for name in ("serve.execute", "serve.resolve"):
        assert sorted(e["args"]["call"] for e in by[name]) == sorted(calls)
    for e in by["serve.execute"]:
        assert e["args"]["device_us"] > 0
        (b,) = [x for x in by["serve.batch"]
                if x["args"]["call"] == e["args"]["call"]]
        assert e["args"]["rids"] == b["args"]["rids"]
        assert e["args"]["window"] == b["args"]["window"]
    windows = {e["args"]["window"] for e in by["serve.batch"]}
    for name in ("serve.idle", "serve.window"):
        assert {e["args"]["window"] for e in by[name]} == windows
        assert len(by[name]) == len(windows)
    assert sum(e["args"]["n"] for e in by["serve.window"]) == 6
    for e in evs:
        assert t0 * 1e6 <= e["ts"] <= e["ts"] + e.get("dur", 0) <= t1 * 1e6
    assert doc["otherData"]["clock"] == "perf_counter_us"


def test_untraced_server_records_nothing_and_still_counts(monkeypatch):
    """Tracing off: the server enters no profiler range, reads no trace
    clock and records no span or event; its histograms still count."""
    from repro_torch.obs import trace as ttrace

    def boom(*a, **k):
        raise AssertionError("entered while tracing is off")

    fwd, state, vocab = _scorer()
    names = ("serve_batcher_us", "serve_call_device_us",
             "serve_request_latency_us")
    with obs.tracing() as tr:
        obs.disable()
        monkeypatch.setattr(torch.profiler, "record_function", boom)
        monkeypatch.setattr(ttrace, "_now_us", boom)
        monkeypatch.setattr(ttrace.Tracer, "record", boom)
        before = [_counts(n) for n in names]
        srv = Server(fwd, state, BucketLadder(lengths=(4,), batches=(1, 2)),
                     name="t.off")
        futs = [srv.submit(loadgen.make_tokens(3, vocab, seed=i))
                for i in range(3)]
        srv.start()
        for f in futs:
            f.result(timeout=T)
        srv.stop(timeout=T)
        assert len(tr) == 0 and tr.dropped == 0
    got = [_delta(_counts(n), b) for n, b in zip(names, before)]
    assert got[0][(("phase", "window"),)] >= 1
    assert sum(got[1].values()) == got[0][(("phase", "launch"),)] >= 2
    assert got[2][(("phase", "batch_wait"),)] == 3


# ---------------------------------------------- the smoke Llama, served ---


def test_server_on_smoke_llama_matches_reference():
    """The port's server on the smoke Llama pruned forward (f32 compute,
    the reference's params carried across) against the reference's
    ``make_pruned_forward`` on each request's packed bucket matrix: the
    two packages differ only in summation order, 1e-4."""
    import dataclasses
    jcfg = dataclasses.replace(jget_smoke("llama3.2-1b"),
                               compute_dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config("llama3.2-1b"),
                               compute_dtype="float32")
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    jblocks = jserve.prune_ffn_blocks(
        jparams, jcfg, 0.25, policy=JPlanPolicy(method="rowsplit",
                                                tunedb=None))
    jfwd = jax.jit(jserve.make_pruned_forward(jcfg))
    tparams = convert.params_from_numpy(
        jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    tblocks = serve.prune_ffn_blocks(tparams, tcfg, 0.25)
    base = serve.make_pruned_forward(tcfg)
    lad = BucketLadder.from_max(16, 2, min_len=8)
    srv = Server(lambda st, tok: base(st[0], st[1], tok), (tparams, tblocks),
                 lad, name="t.llama")
    lens = [5, 16, 8, 11]
    reqs = [loadgen.make_tokens(n, tcfg.vocab_size, seed=n) for n in lens]
    futs = [srv.submit(r) for r in reqs]
    srv.start()
    outs = [f.result(timeout=T) for f in futs]
    srv.stop(timeout=T)
    assert srv.recompiles() == 0
    for pb in pack(lens, lad):
        mat = np.zeros((pb.batch, pb.length), np.int32)
        for row, i in enumerate(pb.indices):
            mat[row, :lens[i]] = reqs[i]
        want = np.asarray(jfwd(jparams, jblocks, mat))
        for row, i in enumerate(pb.indices):
            np.testing.assert_allclose(outs[i].numpy(),
                                       want[row, :lens[i]], rtol=1e-4,
                                       atol=1e-4)
