"""The optimizer slice -- AdamW, its schedule, the zero1 master copy and
int8 error-feedback compression -- in the port against the JAX reference,
on the same numpy inputs.

Each reference function is jitted once for the module.  Both packages get
the same params, grads and state, so the optimizer is held alone at the
f32 bar (rtol/atol 2e-5, tests/test_kernels.py); the int8 payload and
scales are array-equal (both round half to even).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import compression as jcomp  # noqa: E402
from repro_torch.optim import adamw, compression  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

F32 = dict(rtol=2e-5, atol=2e-5)
SHAPES = {"a": (4, 5), "b": [(3,), (2, 3)], "c": {"w": (7, 2)}}
CFG = adamw.AdamWConfig(learning_rate=1e-2, warmup_steps=10,
                        total_steps=50)
JCFG = jadamw.AdamWConfig(learning_rate=1e-2, warmup_steps=10,
                          total_steps=50)


def _tree(rng, scale=1.0, positive=False, dtype=np.float32):
    """Arrays of SHAPES' shapes (its tuples are shapes, not nodes)."""
    def draw(shape):
        if isinstance(shape, dict):
            return {k: draw(v) for k, v in shape.items()}
        if isinstance(shape, list):
            return [draw(v) for v in shape]
        x = rng.standard_normal(shape) * scale
        return (np.abs(x) if positive else x).astype(dtype)
    return draw(SHAPES)


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    def conv(x):
        x = np.asarray(x)
        if x.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(x.view(np.uint16).astype(np.int16)
                                    ).view(torch.bfloat16)
        return torch.from_numpy(np.array(x))
    return jax.tree.map(conv, tree)


def _np(t):
    if t.dtype == torch.bfloat16:
        return t.float().numpy()
    return t.numpy()


def _check_tree(got, want, tol=F32):
    got, want = leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w, np.float32), **tol)


def _state(rng, step):
    return {"step": np.asarray(step, np.int32),
            "m": _tree(rng, 0.1), "v": _tree(rng, 0.01, positive=True)}


@pytest.fixture(scope="module")
def ref():
    """The reference's functions, each jitted once for the module."""
    return {
        "schedule": jax.jit(lambda s: jadamw.schedule(JCFG, s)),
        "apply": jax.jit(lambda p, g, s: jadamw.apply_updates(p, g, s,
                                                              JCFG)),
        "zero1": jax.jit(lambda p, g, s: jadamw.apply_updates_zero1(
            p, g, s, JCFG)),
        "compress": jax.jit(jcomp.compress),
        "roundtrip": jax.jit(jcomp.roundtrip),
    }


@pytest.mark.parametrize("cfg_name", ["small", "default"])
def test_schedule_matches_reference_over_every_step(ref, cfg_name):
    if cfg_name == "small":
        cfg, fn = CFG, ref["schedule"]
    else:
        cfg = adamw.AdamWConfig()
        fn = jax.jit(lambda s: jadamw.schedule(jadamw.AdamWConfig(), s))
    steps = np.arange(cfg.total_steps + 1, dtype=np.int32)
    got = adamw.schedule(cfg, torch.from_numpy(steps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(fn(steps)), **F32)


def test_config_defaults_match_reference():
    import dataclasses
    assert dataclasses.asdict(adamw.AdamWConfig()) == dataclasses.asdict(
        jadamw.AdamWConfig())


@pytest.mark.parametrize("grad_scale,step", [(0.05, 0), (3.0, 4), (1.0, 17)],
                         ids=["unclipped-first", "clipped", "cosine"])
def test_apply_updates_matches_reference(ref, grad_scale, step):
    rng = np.random.default_rng(step)
    params, grads = _tree(rng), _tree(rng, grad_scale)
    state = _state(rng, step)
    jp, js, jm = ref["apply"](_jax(params), _jax(grads), _jax(state))
    tstate = _torch(state)
    tp, ts, tm = adamw.apply_updates(_torch(params), _torch(grads), tstate,
                                     CFG)
    _check_tree(tp, jp)
    _check_tree(ts["m"], js["m"])
    _check_tree(ts["v"], js["v"])
    assert ts["step"].dtype == torch.int32 and ts["step"].dim() == 0
    assert int(ts["step"]) == int(js["step"]) == step + 1
    for k in ("grad_norm", "lr", "skipped"):
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]), **F32)
    assert float(tm["skipped"]) == 0.0
    # functional: the state handed in is left as it was
    assert int(tstate["step"]) == step


def test_apply_updates_skips_a_nonfinite_step_like_reference(ref):
    rng = np.random.default_rng(5)
    params, grads = _tree(rng), _tree(rng)
    grads["b"][1][0, 1] = np.nan
    grads["a"][2, 2] = np.inf
    state = _state(rng, 3)
    jp, js, jm = ref["apply"](_jax(params), _jax(grads), _jax(state))
    tp, ts, tm = adamw.apply_updates(_torch(params), _torch(grads),
                                     _torch(state), CFG)
    assert float(tm["skipped"]) == float(jm["skipped"]) == 1.0
    assert int(ts["step"]) == int(js["step"]) == 3
    for got, want in ((tp, params), (ts["m"], state["m"]),
                      (ts["v"], state["v"])):
        for g, w in zip(leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(g.numpy(), w)
    assert not np.isfinite(float(tm["grad_norm"]))


def test_apply_updates_zero1_matches_reference(ref):
    rng = np.random.default_rng(11)
    master = _tree(rng)
    grads = jax.tree.map(lambda x: x.astype(ml_dtypes.bfloat16),
                         _tree(rng, 0.5))
    jparams, jstate = jadamw.init_state_zero1(_jax(master), jnp.bfloat16)
    tparams, tstate = adamw.init_state_zero1(_torch(master),
                                             torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in leaves(tparams))
    _check_tree(tparams, jparams)
    jstate = dict(jstate, **{k: _jax(v) for k, v in _state(rng, 2).items()})
    tstate = dict(tstate, **_torch({k: jax.tree.map(np.asarray, v)
                                    for k, v in jstate.items()
                                    if k != "master"}))
    jp, js, jm = ref["zero1"](jparams, _jax(grads), jstate)
    tp, ts, tm = adamw.apply_updates_zero1(tparams, _torch(grads), tstate,
                                           CFG)
    _check_tree(ts["master"], js["master"])
    _check_tree(ts["m"], js["m"])
    _check_tree(ts["v"], js["v"])
    _check_tree(tp, jp)
    for p, mp in zip(leaves(tp), leaves(ts["master"])):
        assert p.dtype == torch.bfloat16
        assert torch.equal(p, mp.to(torch.bfloat16))
    np.testing.assert_allclose(tm["grad_norm"].numpy(),
                               np.asarray(jm["grad_norm"]), **F32)


def test_global_norm_matches_reference():
    rng = np.random.default_rng(2)
    g = _tree(rng, 2.0)
    np.testing.assert_allclose(
        adamw.global_norm(_torch(g)).numpy(),
        np.asarray(jadamw.global_norm(_jax(g))), **F32)


def _grads_and_residual(seed, dtype):
    rng = np.random.default_rng(seed)
    g = _tree(rng, 1.0, dtype=dtype)
    g["a"][0, 0] = 40.0            # one large entry sets the scale
    return g, _tree(rng, 0.02)


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int8_payload_and_scales_array_equal_to_reference(ref, seed, dtype):
    g, res = _grads_and_residual(seed, dtype)
    jq, js, jerr = ref["compress"](_jax(g), _jax(res))
    tq, ts, terr = compression.compress(_torch(g), _torch(res))
    for got, want in zip(leaves(tq), jax.tree.leaves(jq)):
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(leaves(ts), jax.tree.leaves(js)):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _check_tree(terr, jerr)


def test_roundtrip_and_residual_match_reference(ref):
    g, res = _grads_and_residual(7, np.float32)
    jout, jres = ref["roundtrip"](_jax(g), _jax(res))
    tout, tres = compression.roundtrip(_torch(g), _torch(res))
    _check_tree(tout, jout)
    _check_tree(tres, jres)
    zeros = compression.init_residual(_torch(g))
    assert all(float(z.abs().max()) == 0.0 and z.dtype == torch.float32
               for z in leaves(zeros))


def test_grouped_leaves_share_the_scale_of_the_stacked_tensor(ref):
    """Two leaves of one group quantize as the reference quantizes the
    tensor that stacks them (a segment's layers on a leading axis)."""
    rng = np.random.default_rng(9)
    layers = [rng.standard_normal((3, 4)).astype(np.float32) * s
              for s in (1.0, 5.0)]
    res = [np.zeros((3, 4), np.float32)] * 2
    jq, js, jerr = ref["compress"]({"w": jnp.asarray(np.stack(layers))},
                                   {"w": jnp.asarray(np.stack(res))})
    tq, ts, terr = compression.compress(
        [torch.from_numpy(x) for x in layers],
        [torch.from_numpy(r) for r in res], groups=["w", "w"])
    for i in range(2):
        np.testing.assert_array_equal(tq[i].numpy(), np.asarray(jq["w"][i]))
        np.testing.assert_array_equal(ts[i].numpy(), np.asarray(js["w"]))
        np.testing.assert_allclose(terr[i].numpy(), np.asarray(jerr["w"][i]),
                                   **F32)
