"""The whole slice — pruned-FFN serving of the smoke Llama config — in the
port against the JAX reference: the reference's params carried across by
``repro_torch.convert``, both packages prune and plan, and the logits of
``make_pruned_forward`` are compared for both SpMM methods."""
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


@pytest.mark.parametrize("method", ["auto", "merge", "rowsplit"])
def test_pruned_forward_matches_reference_f32(method):
    """f32 compute: the two packages differ only in summation order, so
    the logits (|logits| ~ 1) agree to 1e-4."""
    want, got = _logits_both("float32", method)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("method", ["merge", "rowsplit"])
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


@pytest.mark.parametrize("method", ["auto", "merge"])
def test_main_smoke_on_cpu(method, capsys):
    argv = ["--smoke", "--prune-ffn", "0.25", "--device", "cpu",
            "--batch", "2", "--prompt-len", "8", "--spmm-method", method]
    assert serve.main(argv) == 0
    assert "pruned-FFN logits (2, 8, 512)" in capsys.readouterr().out


def test_main_default_args_smoke_on_cpu():
    assert serve.main(["--smoke", "--prune-ffn", "0.25",
                       "--device", "cpu"]) == 0


@pytest.mark.parametrize("argv", [
    ["--smoke", "--device", "cpu"],                        # dense path
    ["--smoke", "--device", "cpu", "--prune-ffn", "0.25", "--gen", "4"],
    ["--smoke", "--device", "cpu", "--prune-ffn", "0.25", "--serve"],
    ["--smoke", "--device", "cpu", "--prune-ffn", "0.25", "--mesh", "2"],
])
def test_main_rejects_paths_not_ported(argv, capsys):
    with pytest.raises(SystemExit) as e:
        serve.main(argv)
    assert e.value.code == 2
    assert "not ported" in capsys.readouterr().err
