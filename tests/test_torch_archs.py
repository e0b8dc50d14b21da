"""The other eight architectures in the port against the JAX reference:
their configs, the four model options (LayerNorm, sinusoidal positions,
sliding-window and local attention, embedding inputs), the SSD and RG-LRU
blocks, and the whole models at smoke size — prefill, decode steps,
greedy ``generate``, ``loss_and_aux`` with its gradients, and pruned-FFN
serving of RecurrentGemma — from the reference's params carried across by
``repro_torch.convert`` and inputs made with numpy from a seed.

f32 compute isolates the algorithm (the packages then differ in
summation order, and in the RG-LRU's scan tree: the reference's
``associative_scan`` against the port's doubling scan): model paths at
1e-4, gradients at the trainer's bars (tests/test_torch_trainer.py), and
bf16 at the reference's own 3e-2 (tests/test_models.py).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.core import PlanPolicy as JPlanPolicy  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import ARCHS, get_config, get_smoke_config  # noqa
from repro_torch.core import PlanPolicy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import rglru as R  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.runtime import steps  # noqa: E402
from repro_torch.tree import leaves, paths  # noqa: E402

NEW = ["command-r-35b", "granite-3-2b", "internvl2-76b", "mamba2-1.3b",
       "mixtral-8x22b", "musicgen-large", "qwen2-72b", "recurrentgemma-2b"]
TOKEN_ARCHS = [a for a in NEW if a not in ("internvl2-76b",
                                           "musicgen-large")]
TOL = dict(rtol=1e-4, atol=1e-4)
GRAD = dict(rtol=1e-4, atol=1e-5)                # test_torch_trainer.py
BF16 = dict(rtol=3e-2, atol=3e-2)                # tests/test_models.py


def _np(t):
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _jnp(x, dtype=None):
    out = jnp.asarray(x)
    return out if dtype is None else out.astype(dtype)


def _cfgs(arch, compute="float32"):
    return (dataclasses.replace(jget_smoke(arch), compute_dtype=compute),
            dataclasses.replace(get_smoke_config(arch),
                                compute_dtype=compute))


def _both(arch, seed=0, compute="float32"):
    jcfg, tcfg = _cfgs(arch, compute)
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(seed))
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _inputs(cfg, b, s, seed=1):
    """A numpy batch of inputs: tokens, or embeds for embeddings archs."""
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "tokens":
        return {"tokens": rng.integers(0, cfg.vocab_size,
                                       (b, s)).astype(np.int32)}
    return {"embeds": rng.standard_normal((b, s, cfg.d_model)).astype(
        np.float32)}


def _cut(batch, lo, hi):
    return {k: v[:, lo:hi] for k, v in batch.items()}


def _port(batch):
    return {k: torch.from_numpy(np.array(v)).long()
            if v.dtype == np.int32 else torch.from_numpy(np.array(v))
            for k, v in batch.items()}


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


def _check_caches(got, want, tol=TOL):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w), i
        for name, wv in w.items():
            assert str(g[name].dtype).removeprefix("torch.") == \
                str(wv.dtype), (i, name, g[name].dtype, wv.dtype)
            np.testing.assert_allclose(_np(g[name]), np.asarray(
                wv, np.float32), err_msg=f"layer {i} {name}", **tol)


# ------------------------------------------------------------ configs ---


@pytest.mark.parametrize("smoke", [False, True], ids=["published", "smoke"])
@pytest.mark.parametrize("arch", NEW)
def test_config_matches_reference(arch, smoke):
    got = get_smoke_config(arch) if smoke else get_config(arch)
    want = jget_smoke(arch) if smoke else jget_config(arch)
    names = [f.name for f in dataclasses.fields(want)]
    assert [f.name for f in dataclasses.fields(got)] == names
    for name in names:
        assert getattr(got, name) == getattr(want, name), name
    assert got.block_types() == list(want.block_types())


def test_registry_holds_the_reference_archs():
    from repro.configs import ARCHS as JARCHS
    assert ARCHS == JARCHS


# ------------------------------------------------------------ options ---


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm_matches_reference(kind, dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3 + 1
    p = {"scale": rng.standard_normal(64).astype(np.float32)}
    if kind == "layernorm":
        p["bias"] = rng.standard_normal(64).astype(np.float32)
    want = jlayers.norm_apply({k: _jnp(v) for k, v in p.items()},
                              _jnp(x, dtype), kind)
    got = L.norm_apply({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x).to(getattr(torch, dtype)), kind)
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **(TOL if dtype == "float32" else BF16))
    init = L.init_norm(64, kind, torch.float32, "cpu")
    jinit = jlayers.init_norm(64, kind, jnp.float32)
    assert sorted(init) == sorted(jinit)


def test_norm_refuses_an_unknown_kind():
    with pytest.raises(ValueError, match="groupnorm"):
        L.init_norm(8, "groupnorm", torch.float32, "cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sinusoidal_matches_reference(dtype):
    """Prefill positions (1, s) and decode positions (b, 1), added to
    embeddings of ``dtype`` as ``embed_inputs`` adds them."""
    rng = np.random.default_rng(2)
    for pos in (np.arange(40)[None], np.array([[3], [517], [4095]])):
        want = jlayers.sinusoidal(_jnp(pos), 64)
        got = L.sinusoidal(torch.from_numpy(pos), 64)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        h = rng.standard_normal(want.shape).astype(np.float32)
        jh = _jnp(h, dtype) + want.astype(dtype)
        th = torch.from_numpy(h).to(getattr(torch, dtype)) + \
            got.to(getattr(torch, dtype))
        np.testing.assert_allclose(_np(th), np.asarray(jh, np.float32),
                                   **(TOL if dtype == "float32" else BF16))


@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("window", [8, 32])
def test_windowed_prefill_attention_matches_reference(window, groups):
    """The port's one-block masked attention against the reference's
    blockwise kernel, which fetches only the key chunks a window sees."""
    b, s, kvh, dh = 2, 64, 2, 16
    rng = np.random.default_rng(window + groups)
    q = rng.standard_normal((b, s, kvh * groups, dh)).astype(np.float32)
    k = rng.standard_normal((b, s, kvh, dh)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, dh)).astype(np.float32)
    want = jlayers.flash_attention(_jnp(q), _jnp(k), _jnp(v), window=window,
                                   q_chunk=16, kv_chunk=16)
    got = L.causal_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    full = L.causal_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v))
    assert not torch.allclose(got[:, window:], full[:, window:], **TOL)
    torch.testing.assert_close(got[:, :window], full[:, :window])


@pytest.mark.parametrize("window", [8, 32], ids=["under", "over"])
def test_windowed_decode_attention_matches_reference(window):
    """A window under the cache length (24) attends to pos + 1 - window …
    pos; one over it, to the whole causal prefix."""
    b, cache, kvh, g, dh = 3, 24, 2, 2, 16
    rng = np.random.default_rng(window)
    q = rng.standard_normal((b, 1, kvh * g, dh)).astype(np.float32)
    kc = rng.standard_normal((b, cache, kvh, dh)).astype(np.float32)
    vc = rng.standard_normal((b, cache, kvh, dh)).astype(np.float32)
    pos = np.array([3, 12, 23], np.int32)
    want = jlayers.decode_attention(_jnp(q), _jnp(kc), _jnp(vc), _jnp(pos),
                                    window=window)
    got = L.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                             torch.from_numpy(vc), torch.from_numpy(pos),
                             window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", ["musicgen-large", "internvl2-76b",
                                  "recurrentgemma-2b"])
def test_embed_inputs_matches_reference(arch):
    """Embedding inputs, sinusoidal positions (MusicGen, also at decode
    positions) and ``embed_scale`` (RecurrentGemma), in bf16."""
    jcfg, tcfg, jparams, tparams = _both(arch, compute="bfloat16")
    batch = _inputs(jcfg, 2, 6, seed=3)
    jb = {k: _jnp(v) for k, v in batch.items()}
    want = jmodel.embed_inputs(jparams, jcfg, jb)
    got = M.embed_inputs(tparams, tcfg, _port(batch))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=1e-2, atol=1e-2)
    pos = np.array([[5], [9]])
    one = _cut(batch, 0, 1)
    want = jmodel.embed_inputs(jparams, jcfg, {k: _jnp(v) for k, v in
                                               one.items()},
                               positions=_jnp(pos))
    got = M.embed_inputs(tparams, tcfg, _port(one),
                         positions=torch.from_numpy(pos))
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=1e-2, atol=1e-2)


# ------------------------------------------------------------- blocks ---


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_ssd_scan_chunked_matches_reference(chunk):
    bs, s, h, p, n = 2, 32, 3, 4, 5
    rng = np.random.default_rng(chunk)
    x = rng.standard_normal((bs, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((bs, s, h)))).astype(
        np.float32)
    a = -np.exp(rng.standard_normal(h)).astype(np.float32)
    b = rng.standard_normal((bs, s, n)).astype(np.float32)
    c = rng.standard_normal((bs, s, n)).astype(np.float32)
    jy, jst = jssm.ssd_scan_chunked(*map(_jnp, (x, dt, a, b, c)),
                                    chunk=chunk)
    ty, tst = S.ssd_scan_chunked(*map(torch.from_numpy, (x, dt, a, b, c)),
                                 chunk=chunk)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(tst.numpy(), np.asarray(jst), **TOL)


def _block(kind, compute="float32"):
    arch = "mamba2-1.3b" if kind == "ssd" else "recurrentgemma-2b"
    jcfg, tcfg = _cfgs(arch, compute)
    if kind == "ssd":
        jp = jssm.init_ssd(jax.random.PRNGKey(0), jcfg)
        jfn, tapply = jssm.ssd_apply, S.ssd_apply
    else:
        jp = jrglru.init_rglru(jax.random.PRNGKey(0), jcfg)
        # non-zero gates, so r and i depend on x
        jp = dict(jp, gate_a=jnp.linspace(-1.0, 1.0, jcfg.lru_width),
                  gate_x=jnp.linspace(1.0, -1.0, jcfg.lru_width))
        jfn, tapply = jrglru.rglru_apply, R.rglru_apply
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    japply = jax.jit(lambda p, u, state=None: jfn(p, u, jcfg, state=state))
    return jcfg, tcfg, jp, tp, japply, tapply


def _states(got, want, tol):
    for name, w in want.items():
        assert str(got[name].dtype).removeprefix("torch.") == str(w.dtype), \
            name
        np.testing.assert_allclose(_np(got[name]), np.asarray(w, np.float32),
                                   err_msg=name, **tol)


@pytest.mark.parametrize("kind", ["ssd", "rglru"])
def test_block_prefill_and_decode_match_reference(kind):
    """A prefill of 13 tokens (not a multiple of the smoke SSD chunk, 8),
    then three decode steps: outputs and states (conv and SSM/LRU)."""
    jcfg, tcfg, jp, tp, japply, tapply = _block(kind)
    u = np.random.default_rng(5).standard_normal(
        (2, 16, jcfg.d_model)).astype(np.float32)
    jy, jst = japply(jp, _jnp(u[:, :13]))
    ty, tst = tapply(tp, torch.from_numpy(u[:, :13]), tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    _states(tst, jst, TOL)
    for t in range(13, 16):
        jy, jst = japply(jp, _jnp(u[:, t:t + 1]), state=jst)
        ty, tst = tapply(tp, torch.from_numpy(u[:, t:t + 1]), tcfg,
                         state=tst)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
        _states(tst, jst, TOL)


@pytest.mark.parametrize("kind", ["ssd", "rglru"])
def test_block_bf16_matches_reference(kind):
    """bf16 compute: the SSD's products of bf16-rounded operands in f32
    against the reference's bf16 einsums with f32 accumulation."""
    jcfg, tcfg, jp, tp, japply, tapply = _block(kind, "bfloat16")
    u = np.random.default_rng(6).standard_normal(
        (2, 12, jcfg.d_model)).astype(np.float32)
    jy, jst = japply(jp, _jnp(u, jnp.bfloat16))
    ty, tst = tapply(tp, torch.from_numpy(u).bfloat16(), tcfg)
    assert ty.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(ty), np.asarray(jy, np.float32), **BF16)
    _states(tst, jst, BF16)


def test_linear_scan_matches_a_loop():
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, 37, 3)))
    b = torch.from_numpy(rng.standard_normal((2, 37, 3)))
    h, want = torch.zeros(2, 3, dtype=torch.float64), []
    for t in range(37):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    torch.testing.assert_close(R.linear_scan(a, b), torch.stack(want, 1))


def test_ssd_prefill_final_state_is_exact_under_padding():
    """The identity steps padding 13 tokens to a chunk multiple leave the
    final state as 13 one-token decode steps from zero leave it."""
    _, cfg, _, p, _, apply = _block("ssd")
    u = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (1, 13, cfg.d_model)).astype(np.float32))
    _, pre = apply(p, u, cfg)
    st = S.init_ssd_state(cfg, 1, "cpu")
    for t in range(13):
        _, st = apply(p, u[:, t:t + 1], cfg, state=st)
    torch.testing.assert_close(pre["ssm"], st["ssm"], **TOL)


# ------------------------------------------------------------- models ---


@pytest.fixture(scope="module")
def jref():
    """The reference's prefill, decode step and loss gradient, jitted once
    each per arch for the module."""
    cache = {}

    def get(kind, arch, **kw):
        key = (kind, arch, tuple(sorted(kw.items())))
        if key not in cache:
            jcfg, _ = _cfgs(arch)
            if kind == "prefill":
                fn = lambda p, b: jmodel.prefill(  # noqa: E731
                    p, jcfg, b, cache_len=kw["cache_len"])
            elif kind == "decode":
                fn = lambda p, c, b, i: jmodel.decode_step(  # noqa: E731
                    p, jcfg, c, b, i)
            else:
                fn = jax.value_and_grad(
                    lambda p, b: jmodel.loss_and_aux(p, jcfg, b,
                                                     loss_chunk=8),
                    has_aux=True)
            cache[key] = jax.jit(fn)
        return cache[key]

    return get


@pytest.mark.parametrize("arch", NEW)
def test_prefill_and_decode_steps_match_reference(jref, arch):
    """Logits and every layer's cache (KV, or conv and recurrent state,
    with their dtypes) after a prefill of 11 and three decode steps; the
    11 prompt positions are not a multiple of the smoke SSD chunk, and
    the RecurrentGemma and Mixtral windows (16) bite in decode."""
    jcfg, tcfg, jparams, tparams = _both(arch)
    b, s, n = 2, 11, 8
    batch = _inputs(jcfg, b, s + n)
    cache_len = s + n + 1
    jcaches, jlogits, jpos = jref("prefill", arch, cache_len=cache_len)(
        jparams, {k: _jnp(v) for k, v in _cut(batch, 0, s).items()})
    tb = _port(batch)
    caches, logits, pos = M.prefill(tparams, tcfg, _cut(tb, 0, s),
                                    cache_len=cache_len)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    _check_caches(caches, _layer_caches(jcaches, jcfg))
    jdecode = jref("decode", arch)
    for i in range(s, s + n):
        jlogits, jcaches = jdecode(jparams, jcaches, {
            k: _jnp(v) for k, v in _cut(batch, i, i + 1).items()}, jpos)
        logits, caches = M.decode_step(tparams, tcfg, caches,
                                       _cut(tb, i, i + 1), pos)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   err_msg=f"step {i}", **TOL)
        _check_caches(caches, _layer_caches(jcaches, jcfg))
        jpos, pos = jpos + 1, pos + 1


def test_moe_capacity_drops_match_reference(jref):
    """Where an expert overflows its capacity (the smoke Mixtral at 16 rows
    of 32 tokens), the port drops the replicas the reference drops:
    prefill and decode logits agree at f32, although neither matches its
    own teacher-forced full forward, whose longer rows drop others
    (capacity-limited dispatch is not causal)."""
    arch = "mixtral-8x22b"
    jcfg, tcfg, jparams, tparams = _both(arch)
    b, s, n = 16, 32, 2
    batch = _inputs(jcfg, b, s + n)
    jcaches, jlogits, jpos = jref("prefill", arch, cache_len=s + n)(
        jparams, {k: _jnp(v) for k, v in _cut(batch, 0, s).items()})
    tb = _port(batch)
    with torch.no_grad():
        caches, logits, pos = M.prefill(tparams, tcfg, _cut(tb, 0, s),
                                        cache_len=s + n)
        got, want = [logits[:, 0]], [np.asarray(jlogits)[:, 0]]
        for i in range(s, s + n):
            jlogits, jcaches = jref("decode", arch)(jparams, jcaches, {
                k: _jnp(v) for k, v in _cut(batch, i, i + 1).items()}, jpos)
            logits, caches = M.decode_step(tparams, tcfg, caches,
                                           _cut(tb, i, i + 1), pos)
            got.append(logits[:, 0])
            want.append(np.asarray(jlogits)[:, 0])
            jpos, pos = jpos + 1, pos + 1
        h = M.embed_inputs(tparams, tcfg, tb)
        h, _, _ = M.forward(tparams, tcfg, h)
        h = L.norm_apply(tparams["final_norm"], h[:, s - 1:s + n],
                         tcfg.norm)
        full = h.float() @ M.unembed_matrix(tparams, tcfg).T.float()
    got = torch.stack(got, 1)
    np.testing.assert_allclose(got.numpy(), np.stack(want, 1), **TOL)
    assert (got - full).abs().max().item() > 0.1


@pytest.mark.parametrize("arch", TOKEN_ARCHS)
def test_generate_matches_reference(arch):
    jcfg, tcfg, jparams, tparams = _both(arch, seed=2)
    prompt = _inputs(jcfg, 2, 6, seed=3)["tokens"]
    want = np.asarray(jserve.generate(jcfg, jparams, _jnp(prompt), 5))
    got = serve.generate(tcfg, tparams, torch.from_numpy(prompt), 5)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "mamba2-1.3b",
                                  "musicgen-large", "mixtral-8x22b"])
def test_prefill_decode_consistency(arch):
    """The port alone: prefill(s) + one decode step gives the logits of the
    teacher-forced full forward at positions s - 1 and s (s = 20 past the
    smoke window, 16, and two and a half SSD chunks)."""
    _, tcfg, _, tparams = _both(arch, seed=4)
    s = 20
    tb = _port(_inputs(tcfg, 1, s + 1, seed=5))
    with torch.no_grad():
        h = M.embed_inputs(tparams, tcfg, tb)
        h, _, _ = M.forward(tparams, tcfg, h)
        h = L.norm_apply(tparams["final_norm"], h, tcfg.norm)
        full = h.float() @ M.unembed_matrix(tparams, tcfg).T.float()
        caches, pre, pos = M.prefill(tparams, tcfg, _cut(tb, 0, s),
                                     cache_len=s + 4)
        dec, _ = M.decode_step(tparams, tcfg, caches, _cut(tb, s, s + 1),
                               pos)
    torch.testing.assert_close(pre[:, 0], full[:, s - 1], **TOL)
    torch.testing.assert_close(dec[:, 0], full[:, s], **TOL)


@pytest.mark.parametrize("arch", NEW)
def test_loss_and_gradients_match_reference(jref, arch):
    jcfg, tcfg, jparams, tparams = _both(arch)
    batch = _inputs(jcfg, 2, 16, seed=6)
    batch["labels"] = np.random.default_rng(7).integers(
        0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    (jloss, jaux), jgrads = jref("grad", arch)(
        jparams, {k: _jnp(v) for k, v in batch.items()})
    loss, aux, grads = steps.loss_and_grads(tparams, tcfg, _port(batch),
                                            loss_chunk=8)
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    np.testing.assert_allclose(aux["nll"].item(), float(jaux["nll"]), **TOL)
    want = convert.params_from_numpy(jax.tree.map(np.asarray, jgrads), tcfg,
                                     device="cpu")
    assert paths(grads) == paths(want)
    for p, g, w in zip(paths(grads), leaves(grads), leaves(want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=p, **GRAD)


def test_params_from_numpy_carries_hybrid_and_embeddings_trees():
    """RecurrentGemma's (rglru, rglru, attn) x 1 + (rglru, rglru) x 1
    unstacks in layer order; an embeddings model has no ``embed``; the
    port's own init gives the same keys, shapes and dtypes."""
    for arch in ("recurrentgemma-2b", "musicgen-large"):
        jcfg, tcfg, jparams, tparams = _both(arch)
        ref = M.init_params(tcfg, 0, device="cpu")
        assert paths(ref) == paths(tparams)
        for a, b in zip(leaves(ref), leaves(tparams)):
            assert a.shape == b.shape and a.dtype == b.dtype
    assert "embed" not in tparams and "unembed" in tparams
    jcfg, tcfg, jparams, tparams = _both("recurrentgemma-2b")
    order = [(0, 0, 0), (0, 0, 1), (0, 0, 2), (1, 0, 0), (1, 0, 1)]
    kinds = ["rec", "rec", "attn", "rec", "rec"]
    for blk, (si, ci, pi), kind in zip(tparams["blocks"], order, kinds):
        assert kind in blk
        np.testing.assert_array_equal(
            blk["ln1"]["scale"].numpy(),
            np.asarray(jparams["segments"][si][pi]["ln1"]["scale"][ci]))
        np.testing.assert_array_equal(
            blk["mlp"]["w1"].numpy(),
            np.asarray(jparams["segments"][si][pi]["mlp"]["w1"][ci]))


def test_stack_keys_follow_the_hybrid_segments():
    """int8 error feedback shares one scale over a reference stack: each
    stack key names as many layers as that stack holds, and its leaves
    have the stacked tensor's per-layer shape."""
    cfg = get_config("recurrentgemma-2b")
    small = dataclasses.replace(get_smoke_config("recurrentgemma-2b"),
                                num_layers=26, segments=cfg.segments)
    params = M.init_params(small, 0, device="cpu")
    keys = M.stack_keys(params, small)
    by_key = {}
    for k, p, leaf in zip(keys, paths(params), leaves(params)):
        by_key.setdefault(k, []).append((p, leaf.shape))
    assert len(by_key["blocks/0.0/rec/lam"]) == 8
    assert len(by_key["blocks/0.2/attn/wq"]) == 8
    assert len(by_key["blocks/1.1/mlp/w2"]) == 1
    assert [p for p, _ in by_key["blocks/0.1/ln1/scale"]] == [
        f"blocks/{i}/ln1/scale" for i in range(1, 24, 3)]
    for k, members in by_key.items():
        assert len({shape for _, shape in members}) == 1, k


def test_train_step_int8_runs_on_the_hybrid():
    """One int8 error-feedback step on the smoke RecurrentGemma: finite,
    and the residual holds the quantization error of each stack."""
    cfg = dataclasses.replace(get_smoke_config("recurrentgemma-2b"),
                              compute_dtype="float32")
    from repro_torch.optim import adamw
    step = steps.make_train_step(cfg, adamw.AdamWConfig(), loss_chunk=8,
                                 grad_compression="int8_ef")
    state = steps.init_train_state(cfg, 0, grad_compression="int8_ef",
                                   device="cpu")
    batch = _port(_inputs(cfg, 2, 16, seed=8))
    batch["labels"] = batch["tokens"]
    new, metrics = step(state, batch)
    assert torch.isfinite(metrics["loss"]) and float(metrics["skipped"]) == 0
    assert any(float(r.abs().max()) > 0 for r in leaves(new["residual"]))


# ------------------------------------------------------------ serving ---


def test_serve_pruned_recurrentgemma_matches_reference():
    """Pruned-FFN scoring of the smoke RecurrentGemma: every RG-LRU and
    attention block's MLP pruned and planned in both packages (the same
    patterns), the port's logits against the reference's."""
    jcfg, tcfg, jparams, tparams = _both("recurrentgemma-2b", seed=9)
    tokens = _inputs(jcfg, 2, 8, seed=10)["tokens"]
    jblocks = jserve.prune_ffn_blocks(
        jparams, jcfg, 0.25, policy=JPlanPolicy(method="auto", tunedb=None))
    want = jax.jit(jserve.make_pruned_forward(jcfg))(jparams, jblocks,
                                                     tokens)
    rep = serve.serve_pruned(tcfg, tparams, torch.from_numpy(tokens).long(),
                             0.25, policy=PlanPolicy(method="auto"))
    assert rep.replans == 0
    np.testing.assert_allclose(rep.logits.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "mixtral-8x22b"])
def test_check_prunable_refuses_ssd_and_moe(arch):
    with pytest.raises(SystemExit, match="SSD cores"):
        serve.check_prunable(get_smoke_config(arch))
    with pytest.raises(SystemExit, match="SSD cores"):
        jserve.check_prunable(jget_smoke(arch))
