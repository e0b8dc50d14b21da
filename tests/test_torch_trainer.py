"""The dense trainer -- chunked cross-entropy, ``loss_and_aux`` with remat,
and ``make_train_step`` (microbatches, int8 error feedback, zero1) -- in the
port against the JAX reference, for the dense (Llama) and the MoE (OLMoE)
smoke configs, from the reference's own initial state carried across by
``repro_torch.convert.train_state_from_numpy``.

f32 compute isolates the algorithm (the packages differ only in
summation order; top-k routing sees no bf16 noise that could flip a
near-tied expert): values at the f32 bar, gradients at rtol 1e-4 / atol
1e-5 (tests/test_spmm_grad.py), bf16 compute at 2e-2.  Adam's first update
is about sign(g)·lr, so a gradient near 0 may move an element 2·lr apart
between the packages; the optimizer alone is held on equal grads in
tests/test_torch_optim.py, and the steps here run the reference trainer's
default config, whose first-step lr (3e-6, in warmup) keeps that inside
the f32 bar.  Each reference function is jitted once for the module.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.models import losses as jlosses  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.runtime import steps as jsteps  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import moe_gemm  # noqa: E402
from repro_torch.models import losses  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import steps  # noqa: E402
from repro_torch.tree import leaves, paths  # noqa: E402

ARCHS = ["llama3.2-1b", "olmoe-1b-7b"]
F32 = dict(rtol=2e-5, atol=2e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
B, S, CHUNK = 4, 16, 8


def _cfgs(arch, compute="float32"):
    return (dataclasses.replace(jget_smoke(arch), compute_dtype=compute),
            dataclasses.replace(get_smoke_config(arch),
                                compute_dtype=compute))


def _batch(cfg, b=B, s=S, step=0):
    src = JSyntheticLM(JDataConfig(vocab_size=cfg.vocab_size, seq_len=s,
                                   global_batch=b, seed=3))
    return {k: np.asarray(v) for k, v in src.batch_at(step).items()}


def _tbatch(batch):
    return {k: torch.from_numpy(np.array(v)).long() for k, v in
            batch.items()}


def _np(t):
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _port_tree(jtree, cfg):
    """A reference param-shaped tree (grads, moments) in the port's
    layout."""
    return convert.params_from_numpy(jax.tree.map(np.asarray, jtree), cfg,
                                     device="cpu")


def _check_tree(got, want, tol, what, scaled=False):
    """Each leaf within ``tol``; ``scaled`` takes atol relative to the
    leaf's largest |want|, for leaves far below 1 (the moments)."""
    assert paths(got) == paths(want)
    for p, g, w in zip(paths(got), leaves(got), leaves(want)):
        g, w = _np(g), _np(w)
        atol = tol["atol"] * (float(np.abs(w).max()) if scaled else 1.0)
        np.testing.assert_allclose(g, w, err_msg=f"{what} {p}",
                                   rtol=tol["rtol"], atol=atol)


@pytest.fixture(scope="module")
def ref():
    """The reference's loss, gradient and train steps, jitted once each
    per (arch, options) for the module."""
    cache = {}

    def get(kind, arch, **kw):
        key = (kind, arch, tuple(sorted(kw.items())))
        if key not in cache:
            jcfg, _ = _cfgs(arch, kw.pop("compute", "float32"))
            if kind == "grad":
                fn = jax.value_and_grad(
                    lambda p, b: jmodel.loss_and_aux(p, jcfg, b,
                                                     loss_chunk=CHUNK),
                    has_aux=True)
            else:
                fn = jsteps.make_train_step(jcfg, jadamw.AdamWConfig(),
                                            loss_chunk=CHUNK, **kw)
            cache[key] = jax.jit(fn)
        return cache[key]

    return get


# ------------------------------------------------------ the grouped GEMM ---


def test_grouped_gemm_kernel_refuses_operands_that_require_grad():
    x = torch.randn(64, 8, requires_grad=True)
    w = torch.randn(2, 8, 8)
    be = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="backward"):
        moe_gemm.moe_group_gemm_cuda(x, w, be, tt=64)
    with pytest.raises(RuntimeError, match="backward"):
        moe_gemm.moe_group_gemm_cuda(x.detach(), w.requires_grad_(), be,
                                     tt=64)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensors"):
        moe_gemm.moe_group_gemm_cuda(x, w, be, tt=64)


def test_loss_and_aux_gives_every_expert_weight_a_gradient():
    _, cfg = _cfgs("olmoe-1b-7b")
    params = M.init_params(cfg, 0, "cpu")
    batch = _tbatch(_batch(cfg))
    before = moe_gemm.LAUNCHES
    _, _, grads = steps.loss_and_grads(params, cfg, batch, loss_chunk=CHUNK)
    assert moe_gemm.LAUNCHES == before
    for i, blk in enumerate(grads["blocks"]):
        for name in ("router", "w1", "w3", "w2"):
            g = blk["moe"][name]
            assert g is not None and g.shape == \
                params["blocks"][i]["moe"][name].shape
            assert float(g.abs().max()) > 0, f"block {i} {name}"


# -------------------------------------------------------------- the loss ---


@pytest.mark.parametrize("softcap", [0.0, 5.0], ids=["plain", "softcap"])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "mask"])
def test_chunked_cross_entropy_matches_reference(softcap, masked):
    rng = np.random.default_rng(int(softcap) + 2 * masked)
    b, s, d, v = 2, 12, 16, 40
    h = rng.standard_normal((b, s, d)).astype(np.float32)
    w = (rng.standard_normal((v, d)) * d ** -0.5).astype(np.float32)
    y = rng.integers(0, v, (b, s)).astype(np.int32)
    mask = (rng.random((b, s)) < 0.7).astype(np.float32) if masked else None

    def jloss(h, w):
        return jlosses.chunked_cross_entropy(
            h, w, jnp.asarray(y), chunk=4, logit_softcap=softcap,
            mask=None if mask is None else jnp.asarray(mask))

    jnll, jcnt = jax.jit(jloss)(h, w)
    jg = jax.jit(jax.grad(lambda h, w: jloss(h, w)[0], argnums=(0, 1)))(h, w)
    th = torch.from_numpy(h).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    nll, cnt = losses.chunked_cross_entropy(
        th, tw, torch.from_numpy(y).long(), chunk=4, logit_softcap=softcap,
        mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(nll.item(), float(jnll), **F32)
    assert cnt.item() == float(jcnt)
    gh, gw = torch.autograd.grad(nll, (th, tw))
    np.testing.assert_allclose(gh.numpy(), np.asarray(jg[0]), **GRAD)
    np.testing.assert_allclose(gw.numpy(), np.asarray(jg[1]), **GRAD)


def test_chunked_cross_entropy_refuses_a_ragged_chunk():
    h = torch.zeros(1, 6, 4)
    with pytest.raises(ValueError, match="multiple"):
        losses.chunked_cross_entropy(h, torch.zeros(8, 4),
                                     torch.zeros(1, 6, dtype=torch.long),
                                     chunk=4)


# ------------------------------------------------------------- the model ---


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no-remat"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_aux_and_gradients_match_reference(ref, arch, remat):
    jcfg, cfg = _cfgs(arch)
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    params = _port_tree(jparams, cfg)
    batch = _batch(cfg)
    (jloss, jaux), jgrads = ref("grad", arch)(jparams, _jax_batch(batch))
    loss, aux, grads = steps.loss_and_grads(params, cfg, _tbatch(batch),
                                            remat=remat, loss_chunk=CHUNK)
    np.testing.assert_allclose(loss.item(), float(jloss), **F32)
    for k in ("nll", "aux", "tokens"):
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), **F32)
    if arch.startswith("olmoe"):
        assert float(aux["aux"]) > 0
    _check_tree(grads, _port_tree(jgrads, cfg), GRAD, f"{arch} grad")


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _states(arch, compute, **kw):
    jcfg, cfg = _cfgs(arch, compute)
    jstate = jsteps.init_train_state(jcfg, jax.random.PRNGKey(1), **kw)
    tstate = convert.train_state_from_numpy(
        jax.tree.map(np.asarray, jstate), cfg, device="cpu")
    return jcfg, cfg, jstate, tstate


def _mb(batch, microbatches):
    if microbatches == 1:
        return batch
    return {k: v.reshape(microbatches, -1, *v.shape[1:])
            for k, v in batch.items()}


def _check_int8_step(new, m, jnew, jm, cfg, tol):
    """Error feedback after one step from zero moments and residual: an
    element's pre-quantization value x is what its int8 value sends plus
    what the residual carries, x = m / ((1 - b1)·c) + residual (c the
    clip factor).  x is held at the gradient bar everywhere.  Grads that
    agree only to that bar can round to int8 values one apart where x
    lies on a rounding edge: there m, v and the residual differ by one
    quantum (max |x| / 127 over the reference's stacked tensor), at no
    more than one element in a thousand."""
    b1, clip = adamw.AdamWConfig().b1, adamw.AdamWConfig().grad_clip
    cs = [min(1.0, clip / float(gn)) for gn in (m["grad_norm"],
                                                jm["grad_norm"])]
    ours = [[_np(t) for t in leaves(new["opt"]["m"])],
            [_np(t) for t in leaves(new["opt"]["v"])],
            [_np(t) for t in leaves(new["residual"])]]
    theirs = [[_np(t) for t in leaves(_port_tree(jnew["opt"][k], cfg))]
              for k in ("m", "v")]
    theirs.append([_np(t) for t in leaves(_port_tree(jnew["residual"],
                                                    cfg))])
    xs = [[mm / ((1 - b1) * c) + r for mm, r in zip(side[0], side[2])]
          for side, c in ((ours, cs[0]), (theirs, cs[1]))]
    keys = M.stack_keys(new["residual"], cfg)
    top = {}
    for k, x in zip(keys, xs[1]):
        top[k] = max(top.get(k, 0.0), float(np.abs(x).max()))
    flips = total = 0
    for i, p in enumerate(paths(new["residual"])):
        np.testing.assert_allclose(xs[0][i], xs[1][i],
                                   err_msg=f"carried x {p}", **tol)
        (mo, vo, ro), (mt, vt, rt) = ([side[j][i] for j in range(3)]
                                      for side in (ours, theirs))
        quantum = top[keys[i]] / 127.0
        off = ~np.isclose(ro, rt, **tol)
        assert np.all(np.abs(np.abs(ro - rt)[off] - quantum)
                      <= 1e-2 * quantum), p
        for a, b in ((mo, mt), (vo, vt)):
            assert np.all(np.isclose(a, b, **tol) | off), p
        flips += int(off.sum())
        total += off.size
    assert flips <= total // 1000, (flips, total)


def _check_step(jnew, jm, new, m, cfg, tol, grad_tol, scaled=False):
    """The step's metrics, params and moments against the reference's.
    At bf16 (``scaled``) m, ~0.1·g, is held with atol relative to each
    leaf's largest value, since an absolute 2e-2 would pass zero gradients;
    v, ~1e-3·g², doubles g's relative bf16 noise and keeps the absolute
    bar."""
    for k in ("loss", "nll", "aux", "lr", "skipped"):
        np.testing.assert_allclose(m[k].item(), float(jm[k]), err_msg=k,
                                   **tol)
    np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]),
                               **grad_tol)
    assert int(new["opt"]["step"]) == int(jnew["opt"]["step"]) == 1
    _check_tree(new["params"], _port_tree(jnew["params"], cfg), tol,
                "params")
    if "master" in jnew["opt"]:
        _check_tree(new["opt"]["master"],
                    _port_tree(jnew["opt"]["master"], cfg), tol, "master")
    if "residual" in jnew:
        _check_int8_step(new, m, jnew, jm, cfg, grad_tol)
        return
    for k in ("m", "v"):
        _check_tree(new["opt"][k], _port_tree(jnew["opt"][k], cfg),
                    grad_tol, k, scaled=scaled and k == "m")


@pytest.mark.parametrize("microbatches,compression",
                         [(1, "none"), (2, "none"), (2, "int8_ef")],
                         ids=["mb1", "mb2", "mb2-int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_f32_matches_reference(ref, arch, microbatches,
                                          compression):
    jcfg, cfg, jstate, state = _states(arch, "float32",
                                       grad_compression=compression)
    batch = _batch(cfg)
    jnew, jm = ref("step", arch, microbatches=microbatches,
                   grad_compression=compression)(
        jstate, _mb(_jax_batch(batch), microbatches))
    step = steps.make_train_step(cfg, adamw.AdamWConfig(),
                                 microbatches=microbatches,
                                 loss_chunk=CHUNK,
                                 grad_compression=compression)
    new, m = step(state, _mb(_tbatch(batch), microbatches))
    _check_step(jnew, jm, new, m, cfg, F32, GRAD)
    assert int(state["opt"]["step"]) == 0      # the old state is untouched


@pytest.mark.parametrize("arch,param_mode", [("llama3.2-1b", "fsdp"),
                                             ("olmoe-1b-7b", "zero1")])
def test_train_step_bf16_matches_reference(ref, arch, param_mode):
    jcfg, cfg, jstate, state = _states(arch, "bfloat16",
                                       param_mode=param_mode)
    batch = _batch(cfg)
    jnew, jm = ref("step", arch, compute="bfloat16",
                   param_mode=param_mode)(jstate, _jax_batch(batch))
    step = steps.make_train_step(cfg, adamw.AdamWConfig(), loss_chunk=CHUNK,
                                 param_mode=param_mode)
    new, m = step(state, _tbatch(batch))
    if param_mode == "zero1":
        assert all(t.dtype == torch.bfloat16 for t in leaves(new["params"]))
    _check_step(jnew, jm, new, m, cfg, BF16, BF16, scaled=True)


def test_train_state_modes_are_checked():
    _, cfg = _cfgs("llama3.2-1b")
    with pytest.raises(ValueError, match="param_mode"):
        steps.make_train_step(cfg, adamw.AdamWConfig(), param_mode="ddp")
    with pytest.raises(ValueError, match="param_mode"):
        steps.init_train_state(cfg, 0, param_mode="ddp", device="cpu")
    with pytest.raises(ValueError, match="grad_compression"):
        steps.make_train_step(cfg, adamw.AdamWConfig(),
                              grad_compression="int4")


def test_train_step_loss_falls_on_a_fixed_batch():
    _, cfg = _cfgs("llama3.2-1b", "bfloat16")
    state = steps.init_train_state(cfg, 0, device="cpu")
    step = steps.make_train_step(
        cfg, adamw.AdamWConfig(learning_rate=1e-2, warmup_steps=0,
                               total_steps=6), loss_chunk=CHUNK)
    batch = _tbatch(_batch(cfg))
    losses_ = []
    for _ in range(6):
        state, m = step(state, batch)
        losses_.append(m["loss"].item())
        assert m["skipped"].item() == 0.0
    assert losses_[-1] < losses_[0] - 0.5, losses_
