"""The program a serving bucket holds (``repro_torch.engine.programs``):
chosen by the state's device -- the eager forward on a CPU state, one CUDA
graph on a CUDA state -- with no fallback.  PyTorch alone (no JAX), so
the card's cases run on a machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_programs.py

The ``cuda`` cases decide inside the test whether a card is present and
skip without one.  On the card a replay must equal the eager forward of
the same token matrix bit for bit: the same kernels at the same shapes.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.core import ExecutionConfig, PlanPolicy  # noqa: E402
from repro_torch.engine import (EagerProgram, GraphProgram,  # noqa: E402
                                bucket_program)
from repro_torch.engine.programs import state_device  # noqa: E402
from repro_torch.kernels import rowsplit_spmm  # noqa: E402
from repro_torch.models import sparse as S  # noqa: E402
from repro_torch.serving import BucketLadder, Server, loadgen  # noqa: E402

T = 120                          # seconds: every future and join


def _scorer(device, seed=11, vocab=37, d_model=16, d_ff=48):
    """Tiny SpMM scorer with a row-independent forward, its two SpMMs on
    the row-split kernel."""
    rng = np.random.default_rng(seed)

    def t(shape):
        return torch.from_numpy(
            rng.normal(0, 0.1, shape).astype(np.float32)).to(device)

    state = {"embed": t((vocab, d_model)),
             "mlp": S.prune_mlp({"w1": t((d_model, d_ff)),
                                 "w2": t((d_ff, d_model))}, 0.4,
                                PlanPolicy(method="rowsplit"))}

    def forward(state, tokens):
        h = state["embed"][tokens]
        h = h + S.sparse_mlp_apply(state["mlp"], h, None,
                                   exec=ExecutionConfig())
        return h @ state["embed"].T

    return forward, state, vocab


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def test_state_device_walks_the_tree():
    _, state, _ = _scorer("cpu")
    assert state_device(state) == torch.device("cpu")
    assert state_device(([], {"mlp": state["mlp"]})) == torch.device("cpu")
    with pytest.raises(ValueError, match="no tensor"):
        state_device({"a": [1, 2], "b": ()})


def test_cpu_state_gets_the_eager_program():
    fwd, state, vocab = _scorer("cpu")
    prog = bucket_program(fwd, state, 2, 8)
    assert isinstance(prog, EagerProgram)
    tok = torch.from_numpy(np.stack([
        loadgen.make_tokens(8, vocab, seed=s) for s in (1, 2)]).astype(
            np.int64))
    out = prog(tok)
    assert out.is_inference()
    with torch.no_grad():
        assert torch.equal(out, fwd(state, tok))
    assert prog(tok) is not out          # a fresh output every call


class _StubMeta:
    """A plan's meta as the program rule reads it: ``spmd_mesh()``."""

    def __init__(self, mesh):
        self.mesh = mesh

    def spmd_mesh(self):
        return self.mesh


def _stub_state(spmd: bool):
    import dataclasses

    @dataclasses.dataclass
    class Plan:
        meta: _StubMeta

    _, state, _ = _scorer("cpu")
    return dict(state, sharded=[{"w1": Plan(_StubMeta(
        "mesh" if spmd else None))}])


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("spmd", [False, True])
def test_bucket_program_eager_exactly_when_a_plan_runs_spmd(
        monkeypatch, device, spmd):
    """The program rule, with the device faked and the programs recorded
    (no card needed): a state holding a plan whose ``spmd_mesh()`` is set
    gets an eager program on either device, with a warm call at the
    bucket's shape on a CUDA state; otherwise a CUDA state gets its graph
    and a CPU state a plain eager program."""
    from repro_torch.engine import programs
    fwd, _, _ = _scorer("cpu")
    state = _stub_state(spmd)
    assert programs.runs_collectives(state) is spmd
    built = []
    monkeypatch.setattr(programs, "state_device",
                        lambda st: torch.device(device))
    monkeypatch.setattr(programs, "GraphProgram",
                        lambda *a: built.append(("graph", a[2:4])))
    monkeypatch.setattr(programs, "EagerProgram",
                        lambda f, st, warm=None: built.append(("eager",
                                                               warm)))
    programs.bucket_program(fwd, state, 2, 8)
    cuda = device == "cuda"
    want = ("eager", (2, 8) if cuda else None) if spmd else \
        ("graph", (2, 8)) if cuda else ("eager", None)
    assert built == [want]


def test_eager_program_warm_call_runs_the_forward_once():
    fwd, state, _ = _scorer("cpu")
    shapes = []

    def counted(st, tok):
        shapes.append(tuple(tok.shape))
        return fwd(st, tok)

    EagerProgram(counted, state, warm=(2, 8))
    assert shapes == [(2, 8)]
    EagerProgram(counted, state)
    assert shapes == [(2, 8)]


def test_other_devices_are_refused():
    fwd, state, _ = _scorer("cpu")
    meta = {"embed": torch.empty(3, device="meta")}
    with pytest.raises(ValueError, match="cuda or cpu"):
        bucket_program(fwd, meta, 1, 4)


@pytest.mark.cuda
def test_graph_replay_bit_equal_to_eager():
    """Each bucket's graph replays the eager forward bit for bit, in any
    order of buckets, and launches the row-split kernel only while it is
    built (a replay goes through no wrapper)."""
    dev = _card()
    fwd, state, vocab = _scorer(dev)
    progs = {}
    for shape in ((1, 8), (4, 8), (2, 4)):
        before = rowsplit_spmm.LAUNCHES
        progs[shape] = bucket_program(fwd, state, *shape)
        assert isinstance(progs[shape], GraphProgram)
        assert rowsplit_spmm.LAUNCHES - before == 4   # warm call + capture
        assert progs[shape].capture_s > 0
    gen = np.random.default_rng(3)
    for shape in ((4, 8), (1, 8), (2, 4), (4, 8)):
        tok = torch.from_numpy(gen.integers(0, vocab, shape)).to(dev)
        before = rowsplit_spmm.LAUNCHES
        got = progs[shape](tok).clone()
        assert rowsplit_spmm.LAUNCHES == before
        with torch.inference_mode():
            want = fwd(state, tok)
        assert torch.equal(got, want), shape


@pytest.mark.cuda
def test_server_on_the_card_serves_through_graphs():
    """Requests of every bucket, queued before start so the batcher packs
    them: each result equals the eager forward of its packed matrix."""
    dev = _card()
    fwd, state, vocab = _scorer(dev)
    lad = BucketLadder(lengths=(4, 8), batches=(1, 2, 4))
    srv = Server(fwd, state, lad, name="t.card")
    lens = [3, 8, 4, 7, 1, 5, 8, 2]
    reqs = [loadgen.make_tokens(n, vocab, seed=200 + i)
            for i, n in enumerate(lens)]
    futs = [srv.submit(r) for r in reqs]
    srv.start()
    outs = [f.result(timeout=T) for f in futs]
    srv.stop(timeout=T)
    assert srv.recompiles() == 0
    assert all(isinstance(srv.program(*s), GraphProgram)
               for s in lad.shapes())
    from repro_torch.serving import pack
    with torch.inference_mode():
        for s in range(0, len(lens), lad.max_batch):
            for pb in pack(lens[s:s + lad.max_batch], lad):
                mat = np.zeros((pb.batch, pb.length), np.int64)
                for row, i in enumerate(pb.indices):
                    mat[row, :lens[s + i]] = reqs[s + i]
                want = fwd(srv.state, torch.from_numpy(mat).to(dev))
                for row, i in enumerate(pb.indices):
                    assert torch.equal(outs[s + i],
                                       want[row, :lens[s + i]])


def test_marker_is_registered(pytestconfig):
    markers = pytestconfig.getini("markers")
    assert any(m.startswith("cuda:") for m in markers)
