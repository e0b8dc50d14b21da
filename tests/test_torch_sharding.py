"""The port's sharding rules, constraint and elastic resharding against
the reference's ``repro.distributed`` (``sharding.py``, ``elastic.py``).

Specs: ``param_pspec`` in its three modes, ``cache_pspec`` and
``batch_pspec`` equal the reference's for every leaf of every arch's
smoke config and of the full Granite-3-2B (vocab 49155) and OLMoE-1B-7B
(3-D experts), on the reference tests' ``FakeMesh`` stubs (16 x 16 and 2
x 16 x 16): the reference's leaves from ``jax.eval_shape``, the port's
meta tensors; a port leaf is one layer of the reference's stacked leaf,
so its spec is the reference's without the leading ``None``.

One group of four gloo CPU ranks (``tests/torch_mesh_worker.py``, a
module fixture) runs a 2 x 2 mesh: the train step over the mesh
(``fsdp``, ``zero1``) against the one-process step on the same inputs,
and a 2 x 2 -> 4 x 1 -> 2 x 2 reshard, bit-equal."""
import os
import subprocess
import sys
import time

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.tree_util import DictKey  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.distributed import elastic as jelastic  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import ARCHS, get_config, get_smoke_config  # noqa
from repro_torch.distributed import elastic, sharding as sh  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.runtime import steps as R  # noqa: E402
from repro_torch.tree import leaves, paths  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "torch_mesh_worker.py")
JOIN_S = 150
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)     # tests/test_spmm_grad.py:23
F32_TOL = dict(rtol=2e-5, atol=2e-5)      # tests/test_kernels.py:33


class Mesh16:
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


class Mesh2x16:
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 16, "model": 16}


MESHES = {"16x16": Mesh16, "2x16x16": Mesh2x16}
# Every arch's smoke config, and two at full width.
CONFIGS = [(a, True) for a in ARCHS] + [("granite-3-2b", False),
                                         ("olmoe-1b-7b", False)]


def _padded(spec, ndim) -> tuple:
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


def _ref_key(path) -> str:
    """A reference leaf's path in the port's ``stack_keys`` form."""
    parts = []
    for k in path:
        if isinstance(k, DictKey):
            parts.append(str(k.key))
        else:
            parts.append(str(k.idx))
    if parts[0] == "segments":
        parts = ["blocks", f"{parts[1]}.{parts[2]}"] + parts[3:]
    return "/".join(parts)


def _ref_params(arch, smoke):
    cfg = jget_smoke(arch) if smoke else jget_config(arch)
    tree = jax.eval_shape(lambda: JM.init_params(cfg, jax.random.PRNGKey(0)))
    return {_ref_key(p): (p, x) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,smoke", CONFIGS,
                         ids=[f"{a}{'' if s else '-full'}" for a, s in
                              CONFIGS])
def test_param_pspec_matches_reference(arch, smoke, mesh):
    fake = MESHES[mesh]
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    params = specs.params_specs(cfg)
    ref = _ref_params(arch, smoke)
    keys = M.stack_keys(params, cfg)
    assert set(keys) == set(ref)
    for mode in sh.PARAM_MODES:
        for path, key, leaf in zip(paths(params), keys, leaves(params)):
            rpath, rleaf = ref[key]
            want = _padded(jsh.param_pspec(rpath, rleaf, fake, mode),
                           len(rleaf.shape))
            stacked = path.startswith("blocks/")
            if stacked:
                assert tuple(leaf.shape) == rleaf.shape[1:], key
                assert want[0] is None
                want = want[1:]
            got = sh.param_pspec(path, leaf, fake, mode)
            assert got == want, (mode, path, got, want)


def _ref_caches(cfg, b, s):
    tree = jax.eval_shape(lambda: JM.init_caches(cfg, b, s))
    out = {}
    for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
        si, pi = p[0].idx, p[1].idx
        out[(si, pi, str(p[-1].key))] = (p, x)
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_batch_pspec_match_reference(arch, mesh):
    fake = MESHES[mesh]
    cfg = get_smoke_config(arch)
    where = [(si, pi) for si, (pattern, count) in enumerate(cfg.segments)
             for _ in range(count) for pi in range(len(pattern))]
    for b in (32, 1):                 # batch over dp, and the 500k case
        ref = _ref_caches(jget_smoke(arch), b, 64)
        caches = specs.cache_specs(cfg, b, 64)
        for i, layer in enumerate(caches):
            for name, leaf in layer.items():
                rpath, rleaf = ref[(*where[i], name)]
                assert tuple(leaf.shape) == rleaf.shape[1:]
                want = _padded(jsh.cache_pspec(rpath, rleaf, fake),
                               len(rleaf.shape))
                assert want[0] is None
                got = sh.cache_pspec(f"{i}/{name}", leaf, fake)
                assert got == want[1:], (arch, b, name, got, want)
    for shape, axis, model in (((256, 4096), 0, False),
                               ((16, 16, 4096), 1, False),
                               ((256, 4096, 64), 0, True),
                               ((24, 7), 0, False), ((1, 5), 0, True)):
        assert sh.batch_pspec(shape, fake, axis, model) == _padded(
            jsh.batch_pspec(shape, fake, axis, model), len(shape))


def test_fit_and_placements():
    assert sh._fit(Mesh16, 49155, ("data",)) is None      # granite vocab
    assert sh._fit(Mesh16, 49152, ("data",)) == "data"
    assert sh._fit(Mesh2x16, 128, ("pod", "data")) == ("pod", "data")
    assert sh._fit(Mesh2x16, 24, ("pod", "data")) == "pod"
    assert sh.placements(Mesh2x16, (("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert sh.placements(Mesh16, (None, None)) == (Replicate(), Replicate())
    with pytest.raises(ValueError, match="mesh's order"):
        sh.placements(Mesh16, (("model", "data"),))
    with pytest.raises(ValueError, match="shards two dims"):
        sh.placements(Mesh16, ("data", "data"))
    assert sh.local_shape((49155, 64), sh.Sharding(
        Mesh16, sh.param_pspec("embed", torch.empty(49155, 64,
                                                    device="meta"),
                               Mesh16))) == (49155, 4)


def test_constrain_is_noop_without_mesh():
    x = torch.randn(4, 8, 16)
    assert sh.active_mesh() is None
    assert sh.constrain(x, "dp", None, "model") is x
    assert sh.whole(x, -1) is x


def test_elastic_validate_matches_reference():
    class Mesh4x1:
        axis_names = ("data", "model")
        shape = {"data": 4, "model": 1}

    class Mesh8x2:
        axis_names = ("data", "model")
        shape = {"data": 8, "model": 2}

    for old, new, batch in ((Mesh16, Mesh4x1, 256), (Mesh16, Mesh8x2, 12),
                            (Mesh8x2, Mesh16, 256), (Mesh2x16, Mesh16, 48),
                            (Mesh16, Mesh2x16, 64)):
        want = jelastic.validate_elastic_resize(old, new, batch)
        assert elastic.validate_elastic_resize(old, new, batch) == want


# ------------------------------------------------- the 4-rank gloo group --


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh4")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), HERE]
        + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
           if p]))
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), "4", str(tmp / "store"), str(tmp)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(4)]
    deadline = time.monotonic() + JOIN_S
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log}"
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(4)]


sys.path.insert(0, HERE)
import torch_mesh_worker as W  # noqa: E402


def _close(got, want, tol, what):
    for p, g, w in zip(paths(want), leaves(got), leaves(want), strict=True):
        torch.testing.assert_close(g, w, **tol, msg=f"{what} {p}")


@pytest.mark.parametrize("name,mode,mb", W.MODES,
                         ids=[m[0] for m in W.MODES])
def test_mesh_step_matches_one_process(ranks, name, mode, mb):
    """Over the 2 x 2 mesh: the first batch's loss and gradients, each
    rank's gathered copy, at the gradient bar; two steps' losses and the
    state after them at the f32 bar (moments at the gradient bar)."""
    cfg = W.config()
    state = R.init_train_state(cfg, 0, param_mode=mode, device="cpu")
    bs = W.batches(cfg, mb)
    first = bs[0] if mb == 1 else {k: v[0] for k, v in bs[0].items()}
    loss, _, grads = R.loss_and_grads(state["params"], cfg, first)
    step = R.make_train_step(cfg, R.adamw.AdamWConfig(), microbatches=mb,
                             param_mode=mode)
    losses = []
    st = state
    for b in bs:
        st, m = step(st, b)
        losses.append(m["loss"])
    for r, res in enumerate(ranks):
        got = res[name]
        torch.testing.assert_close(got["grad_loss"], loss, **F32_TOL)
        _close(got["grads"], grads, GRAD_TOL, f"rank {r} grad")
        torch.testing.assert_close(got["losses"], torch.stack(losses),
                                   **F32_TOL)
        _close(got["state"]["params"], st["params"], F32_TOL,
               f"rank {r} params")
        _close(got["state"]["opt"], st["opt"], GRAD_TOL, f"rank {r} opt")
        # Each gradient took its param's placements.
        assert got["grad_placements"] == got["param_placements"]
    # A sharded leaf really is sharded over both axes.
    assert "Shard(dim=0), Shard(dim=1)" in ranks[0]["fsdp"][
        "param_placements"][0]


def test_reshard_2x2_4x1_2x2_is_bit_equal(ranks):
    for res in ranks:
        rs = res["reshard"]
        for a, b, c in zip(leaves(rs["before"]), leaves(rs["4x1"]),
                           leaves(rs["after"]), strict=True):
            assert a.dtype == b.dtype == c.dtype
            assert torch.equal(a, b) and torch.equal(a, c)
        assert rs["placements_back"]
        assert rs["validate"] == [
            "model-axis resize changes TP layout; requires full re-shard "
            "(supported, but flagging for operator confirmation)"]
        # On 4 x 1 the FSDP dim is in 4 parts, the model dim whole.
        assert "(Shard(dim=0), Shard(dim=1))" in rs["placements_4x1"]
