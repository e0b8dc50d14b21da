"""The decode slice — prefill into KV caches, decode steps and greedy
``generate`` — in the port against the JAX reference, for the dense
(Llama, GQA) and the MoE (OLMoE) smoke configs at f32 compute, from the
reference's params carried across by ``repro_torch.convert``.

f32 compute isolates the algorithm: the two packages then differ only in
summation order (logits and caches agree to 1e-4), and top-k routing,
which is discontinuous, sees no bf16 noise that could flip a near-tied
expert choice (tests/test_models.py compares MoE decoding in f32 for the
same reason)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

ARCHS = ["llama3.2-1b", "olmoe-1b-7b"]
TOL = dict(rtol=1e-4, atol=1e-4)


def _both(arch, seed=0):
    jcfg = dataclasses.replace(jget_smoke(arch), compute_dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(arch),
                               compute_dtype="float32")
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(seed))
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _layer_caches(jcaches, cfg):
    """The reference's caches (stacked per segment) as one dict per layer,
    in the port's layer order."""
    out = []
    for si, (pattern, count) in enumerate(cfg.segments):
        for ci in range(count):
            for pi in range(len(pattern)):
                out.append({k: np.asarray(v[ci])
                            for k, v in jcaches[si][pi].items()})
    return out


def _check_caches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for name in ("k", "v"):
            np.testing.assert_allclose(g[name].numpy(), w[name], **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_steps_match_reference(arch):
    jcfg, tcfg, jparams, tparams = _both(arch)
    b, s, steps = 2, 8, 3
    toks = _tokens(jcfg, (b, s + steps))
    cache_len = s + steps + 2
    jprefill = jax.jit(lambda p, t: jmodel.prefill(
        p, jcfg, {"tokens": t}, cache_len=cache_len))
    jdecode = jax.jit(lambda p, c, t, i: jmodel.decode_step(
        p, jcfg, c, {"tokens": t}, i))
    jcaches, jlogits, jpos = jprefill(jparams, jnp.asarray(toks[:, :s]))
    tt = torch.from_numpy(toks).long()
    caches, logits, pos = M.prefill(tparams, tcfg, {"tokens": tt[:, :s]},
                                    cache_len=cache_len)
    assert logits.dtype == torch.float32
    assert logits.shape == (b, 1, tcfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    _check_caches(caches, _layer_caches(jcaches, jcfg))
    for i in range(s, s + steps):
        jlogits, jcaches = jdecode(jparams, jcaches,
                                   jnp.asarray(toks[:, i:i + 1]), jpos)
        logits, caches = M.decode_step(tparams, tcfg, caches,
                                       {"tokens": tt[:, i:i + 1]}, pos)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **TOL)
        _check_caches(caches, _layer_caches(jcaches, jcfg))
        jpos, pos = jpos + 1, pos + 1


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_reference(arch):
    jcfg, tcfg, jparams, tparams = _both(arch, seed=2)
    prompt = _tokens(jcfg, (2, 6), seed=3)
    want = np.asarray(jserve.generate(jcfg, jparams, jnp.asarray(prompt), 5))
    times = []
    got = serve.generate(tcfg, tparams, torch.from_numpy(prompt), 5,
                         times=times)
    assert got.dtype == torch.int32 and got.shape == (2, 11)
    assert len(times) == 6                       # the prefill + 5 steps
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_consistency(arch):
    """The port alone: prefill(s) + one decode step gives the logits of the
    teacher-forced full forward at positions s - 1 and s."""
    _, tcfg, _, tparams = _both(arch, seed=4)
    b, s = 1, 12
    toks = torch.from_numpy(_tokens(tcfg, (b, s + 1), seed=5)).long()
    with torch.no_grad():
        h = M.embed_inputs(tparams, tcfg, {"tokens": toks})
        h, _, _ = M.forward(tparams, tcfg, h)
        h = L.norm_apply(tparams["final_norm"], h, tcfg.norm)
        full = h.float() @ M.unembed_matrix(tparams, tcfg).T.float()
        caches, pre, pos = M.prefill(tparams, tcfg, {"tokens": toks[:, :s]},
                                     cache_len=s + 4)
        dec, _ = M.decode_step(tparams, tcfg, caches,
                               {"tokens": toks[:, s:s + 1]}, pos)
    torch.testing.assert_close(pre[:, 0], full[:, s - 1], **TOL)
    torch.testing.assert_close(dec[:, 0], full[:, s], **TOL)


def test_decode_cache_write_is_per_row():
    """Each sequence writes its k/v at its own position, and the old cache
    is left as it was."""
    cfg = dataclasses.replace(get_smoke_config("llama3.2-1b"),
                              compute_dtype="float32")
    params = M.init_params(cfg, 0, device="cpu")
    cache = M.init_block_cache("attn", cfg, 2, 6, "cpu")
    x = torch.randn(2, 1, cfg.d_model)
    pos = torch.tensor([1, 4])
    _, new = L.attention_apply(params["blocks"][0]["attn"], x, cfg,
                               positions=pos[:, None], cache=cache, pos=pos)
    assert (cache["k"] == 0).all()
    written = new["k"].abs().sum((2, 3)) > 0
    assert written.tolist() == [[False, True, False, False, False, False],
                                [False, False, False, False, True, False]]


def test_params_from_numpy_carries_the_moe_tree():
    """The reference's stacked MoE leaves — (L, E, d, ff) experts and the
    router — unstack into per-layer params of the port's shapes."""
    jcfg, tcfg, jparams, tparams = _both("olmoe-1b-7b")
    jmoe = jparams["segments"][0][0]["moe"]
    assert jmoe["w1"].shape == (tcfg.num_layers, tcfg.num_experts,
                                tcfg.d_model, tcfg.d_ff)
    assert set(tparams) == {"embed", "unembed", "final_norm", "blocks"}
    assert len(tparams["blocks"]) == tcfg.num_layers
    for i, blk in enumerate(tparams["blocks"]):
        assert set(blk) == {"ln1", "attn", "ln2", "moe"}
        for name, leaf in blk["moe"].items():
            np.testing.assert_array_equal(leaf.numpy(),
                                          np.asarray(jmoe[name][i]))
    ref = M.init_params(tcfg, 0, device="cpu")
    for name, leaf in ref["blocks"][0]["moe"].items():
        assert leaf.shape == tparams["blocks"][0]["moe"][name].shape
        assert leaf.dtype == tparams["blocks"][0]["moe"][name].dtype


def test_main_generates_olmoe_smoke_on_cpu(capsys):
    argv = ["--arch", "olmoe-1b-7b", "--smoke", "--gen", "4",
            "--device", "cpu"]
    assert serve.main(argv) == 0
    out = capsys.readouterr().out
    assert "generated (4, 36) in " in out and "tok/s" in out


def test_main_rejects_moe_under_prune_ffn():
    with pytest.raises(SystemExit, match="MoE"):
        serve.main(["--arch", "olmoe-1b-7b", "--smoke", "--prune-ffn",
                    "0.25", "--device", "cpu"])
