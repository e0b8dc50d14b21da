"""The whole slice — pruned-FFN serving of the smoke Llama config — in the
port against the JAX reference: the reference's params carried across by
``repro_torch.convert``, both packages prune and plan, and the logits of
``make_pruned_forward`` are compared for every SpMM method; plus the
serve CLI on the CPU: pruned scoring, microbatched scoring and online
serving (``--serve``)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.core import PlanPolicy as JPlanPolicy  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import PlanPolicy  # noqa: E402
from repro_torch.engine import cache_stats  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

ARCH = "llama3.2-1b"
KEEP = 0.25


def _configs(compute_dtype):
    jcfg = dataclasses.replace(jget_smoke(ARCH), compute_dtype=compute_dtype)
    tcfg = dataclasses.replace(get_smoke_config(ARCH),
                               compute_dtype=compute_dtype)
    return jcfg, tcfg


def _logits_both(compute_dtype, method, batch=2, seq=8):
    jcfg, tcfg = _configs(compute_dtype)
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (batch, seq)).astype(np.int32)
    jblocks = jserve.prune_ffn_blocks(
        jparams, jcfg, KEEP, policy=JPlanPolicy(method=method, tunedb=None))
    want = jax.jit(jserve.make_pruned_forward(jcfg))(jparams, jblocks,
                                                     tokens)
    tparams = convert.params_from_numpy(
        jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    tblocks = serve.prune_ffn_blocks(tparams, tcfg, KEEP,
                                     policy=PlanPolicy(method=method))
    for jb, tb in zip(jblocks, tblocks):          # same pruned patterns
        for name, jl in jb["mlp"].items():
            tl = tb["mlp"][name]
            assert tl.method == jl.method
            assert tl.plan.bwd is None      # serving plans forward only
            np.testing.assert_array_equal(tl.weight.col_ind.numpy(),
                                          np.asarray(jl.weight.col_ind))
    fwd = serve.make_pruned_forward(tcfg)
    before = cache_stats()
    with torch.no_grad():
        got = fwd(tparams, tblocks, torch.from_numpy(tokens).long())
    assert cache_stats().misses == before.misses   # the forward never plans
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("method", ["auto", "merge", "rowsplit",
                                    "rowgroup"])
def test_pruned_forward_matches_reference_f32(method):
    """f32 compute: the two packages differ only in summation order, so
    the logits (|logits| ~ 1) agree to 1e-4."""
    want, got = _logits_both("float32", method)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("method", ["merge", "rowsplit", "rowgroup"])
def test_pruned_forward_matches_reference_bf16(method):
    """The default bf16 compute rounds every activation to 8 bits of
    mantissa, and the frameworks round at different points (bf16 matmul
    outputs, silu), so a one-ulp difference (2^-8 relative) can pass
    through two layers: the logits agree to 5e-2."""
    want, got = _logits_both("bfloat16", method)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=5e-2, atol=5e-2)


def test_serve_pruned_builds_no_plan_while_serving(capsys):
    _, tcfg = _configs("bfloat16")
    from repro_torch.models import model
    params = model.init_params(tcfg, 0, device="cpu")
    prompt = torch.randint(0, tcfg.vocab_size, (2, 8))
    rep = serve.serve_pruned(tcfg, params, prompt, KEEP)
    assert rep.replans == 0
    assert rep.methods == {"w1": "rowsplit", "w3": "rowsplit",
                           "w2": "rowsplit"}
    assert rep.logits.shape == (2, 8, tcfg.vocab_size)
    assert torch.isfinite(rep.logits).all()
    assert "plans built during serving: 0" in capsys.readouterr().out


@pytest.mark.parametrize("method", ["auto", "merge", "rowgroup"])
def test_main_smoke_on_cpu(method, capsys):
    argv = ["--smoke", "--prune-ffn", "0.25", "--device", "cpu",
            "--batch", "2", "--prompt-len", "8", "--spmm-method", method]
    assert serve.main(argv) == 0
    assert "pruned-FFN logits (2, 8, 512)" in capsys.readouterr().out


def test_main_default_args_smoke_on_cpu():
    assert serve.main(["--smoke", "--prune-ffn", "0.25",
                       "--device", "cpu"]) == 0


@pytest.mark.parametrize("argv", [
    ["--smoke", "--device", "cpu", "--mesh", "2"],
    ["--smoke", "--device", "cpu", "--prune-ffn", "0.25", "--mesh", "2"],
    ["--smoke", "--device", "cpu", "--prune-ffn", "0.25", "--serve",
     "--mesh", "2"],
])
def test_main_mesh_refuses_more_ranks_than_the_group(argv, capsys):
    """What ``--mesh`` refuses: without ``--prune-ffn`` it is a dead flag;
    ``--mesh 2`` in one CPU process exceeds its one rank (naming
    torchrun), with or without ``--serve``."""
    with pytest.raises(SystemExit) as e:
        serve.main(argv)
    if "--prune-ffn" not in argv:
        assert e.value.code == 2
        assert "--mesh: no effect without --prune-ffn" in \
            capsys.readouterr().err
    else:
        assert "--mesh 2 exceeds the 1 local device(s)" in str(e.value)
        assert "torchrun --nproc-per-node 2" in str(e.value)


def test_main_mesh_one_rank_runs_the_shard_loop(tmp_path, capsys):
    """``--mesh 1`` in one process: every pruned-FFN weight gets a
    one-shard plan (the per-shard loop, no process group), and the logits
    equal the unsharded run's."""
    paths = [tmp_path / "mesh.pt", tmp_path / "flat.pt"]
    base = ["--smoke", "--prune-ffn", "0.25", "--device", "cpu",
            "--batch", "2", "--prompt-len", "8"]
    assert serve.main(base + ["--mesh", "1", "--logits-out",
                              str(paths[0])]) == 0
    out = capsys.readouterr().out
    assert "sharding pruned-FFN plans over 1 rank(s)" in out
    assert "plans built during serving: 0" in out
    assert serve.main(base + ["--logits-out", str(paths[1])]) == 0
    assert torch.equal(torch.load(paths[0]), torch.load(paths[1]))


def test_main_serve_on_cpu(capsys, tmp_path):
    """``--serve`` on the CPU: every request served, no program built and
    no plan built after warmup, and the metrics dumped."""
    out = tmp_path / "metrics.json"
    assert serve.main(["--smoke", "--prune-ffn", "0.25", "--serve",
                       "--device", "cpu", "--serve-requests", "12",
                       "--metrics-out", str(out)]) == 0
    text = capsys.readouterr().out
    assert "12/12 ok (0 shed, 0 error)" in text
    assert "recompiles after warmup: 0" in text
    assert "plans built during serving: 0" in text
    import json
    metrics = json.loads(out.read_text())["metrics"]
    served = {tuple(v["labels"].items()): v["value"]
              for v in metrics["serve_requests_total"]["values"]}
    assert served[(("outcome", "ok"),)] >= 12


def test_main_serve_mesh_one_rank_runs_the_shard_loop(capsys):
    """``--serve --mesh 1`` in one process: every request served through
    one-shard plans (the per-shard loop, no process group, no lockstep),
    nothing built after warmup; every forward dispatches each of its
    pruned matrices down the loop path."""
    from repro_torch import obs
    _, tcfg = _configs("bfloat16")
    with obs.tracing() as tr:
        assert serve.main(["--smoke", "--prune-ffn", "0.25", "--serve",
                           "--mesh", "1", "--device", "cpu", "--batch",
                           "2", "--prompt-len", "8", "--serve-requests",
                           "12", "--serve-rate", "200"]) == 0
    text = capsys.readouterr().out
    assert "sharding pruned-FFN plans over 1 rank(s)" in text
    assert "eager) in" in text and "lockstep" not in text
    assert "12/12 ok (0 shed, 0 error)" in text
    assert "recompiles after warmup: 0" in text
    assert "plans built during serving: 0" in text
    ds = tr.events(cat="dispatch", name="dispatch.sharded")
    per_forward = 3 * tcfg.num_layers
    assert ds and len(ds) % per_forward == 0
    assert {(d["args"]["path"], d["args"]["n_shards"]) for d in ds} == \
        {("loop", 1)}
    batches = tr.events(cat="serve", name="serve.batch")   # no probe
    assert len(ds) == per_forward * len(batches)


def _smoke_f32():
    from repro_torch.models import model
    _, tcfg = _configs("float32")
    params = model.init_params(tcfg, 0, device="cpu")
    prompt = torch.from_numpy(np.random.default_rng(2).integers(
        0, tcfg.vocab_size, (4, 16)))
    return tcfg, params, prompt


def test_microbatch_matches_unbatched_logits(capsys):
    """``serve_pruned(..., microbatch=2)`` scores 4 rows as two slices of
    2: each row's logits as unbatched, to f32 summation order (the SpMMs'
    B is half as wide)."""
    tcfg, params, prompt = _smoke_f32()
    want = serve.serve_pruned(tcfg, params, prompt, KEEP).logits
    rep = serve.serve_pruned(tcfg, params, prompt, KEEP, microbatch=2)
    assert rep.replans == 0 and rep.logits.shape == want.shape
    torch.testing.assert_close(rep.logits, want, rtol=1e-5, atol=1e-5)
    assert "(microbatch=2)" in capsys.readouterr().out
    # A ragged tail pads and trims: 3 rows at microbatch 2.
    rep3 = serve.serve_pruned(tcfg, params, prompt[:3], KEEP, microbatch=2)
    torch.testing.assert_close(rep3.logits, want[:3], rtol=1e-5, atol=1e-5)


def test_rowgroup_logits_equal_rowsplit():
    """The pruned FFN keeps a fixed share of every row, so each matrix is
    one rowgroup bucket whose ELL block is row-split's: the same bits."""
    tcfg, params, prompt = _smoke_f32()
    want = serve.serve_pruned(tcfg, params, prompt, KEEP,
                              policy=PlanPolicy(method="rowsplit"))
    got = serve.serve_pruned(tcfg, params, prompt, KEEP,
                             policy=PlanPolicy(method="rowgroup"))
    assert set(got.methods.values()) == {"rowgroup"}
    for blk in serve.prune_ffn_blocks(params, tcfg, KEEP,
                                      PlanPolicy(method="rowgroup")):
        for sl in blk["mlp"].values():
            assert len(sl.plan.meta.extra) == 1     # one bucket a matrix
    assert torch.equal(got.logits, want.logits)
