"""The port's MoE slice against the JAX reference on the same numpy
inputs: the grouped GEMM's block→expert plan, ``ops.moe_group_gemm`` (the
plain version the CPU runs) against the reference's Pallas kernel in
interpret mode, and ``moe_apply`` against the reference's; plus the
no-fallback contract of the CUDA wrapper.

Tolerances are the reference's: the grouped GEMM f32 rtol/atol 2e-5 and
bf16 2e-2 (tests/test_kernels.py), the MoE output 2e-4 and its aux loss
rtol 1e-5 at f32 compute (tests/test_models.py)."""
import dataclasses
import re

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.kernels import moe_gemm as jmoe_gemm  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import _cuda, moe_gemm, ops, ref  # noqa: E402
from repro_torch.models import moe  # noqa: E402

ARCH = "olmoe-1b-7b"
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
# tests/test_kernels.py test_moe_group_gemm_sweep: sizes, d_in, d_out.
SWEEP = [((64, 0, 64, 128), 64, 96),
         ((8, 8, 8, 8), 16, 16),
         ((256,), 32, 48)]


def _tol(dt):
    return dict(rtol=2e-2, atol=2e-2) if dt == "bf16" \
        else dict(rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("sizes,tokens,tt", [
    ((64, 0, 64, 128), 256, 8),
    ((0, 0, 64, 0, 64), 128, 64),
    ((8, 8, 8, 8), 32, 8),
    ((64,) * 64, 4096, 64),
    ((128, 0, 0, 64, 0, 64), 256, 64),
    ((64, 32), 128, 32),         # sizes summing below tokens_pad
])
def test_plan_groups_matches_reference(sizes, tokens, tt):
    sizes = np.asarray(sizes, np.int32)
    want = np.asarray(jmoe_gemm.plan_groups(jnp.asarray(sizes), tokens, tt))
    got = moe_gemm.plan_groups(torch.from_numpy(sizes), tokens, tt)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("sizes,din,dout", SWEEP)
def test_group_gemm_matches_reference_pallas(sizes, din, dout, dt):
    """The port's plain grouped GEMM against the reference's Pallas kernel
    (interpret mode, as tests/test_kernels.py runs it), tt = 8."""
    tt = 8
    e = len(sizes)
    sizes = np.asarray(sizes, np.int32)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((int(sizes.sum()), din)).astype(np.float32)
    w = rng.standard_normal((e, din, dout)).astype(np.float32)
    jdt, tdt = DTYPES[dt]
    want = jops.moe_group_gemm(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                               jnp.asarray(sizes), tt=tt)
    got = ops.moe_group_gemm(torch.from_numpy(x).to(tdt),
                             torch.from_numpy(w).to(tdt),
                             torch.from_numpy(sizes), tt=tt)
    assert got.dtype == tdt and got.shape == (x.shape[0], dout)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_tol(dt))


def test_group_gemm_plain_matches_per_token_oracle():
    """The per-block plain version equals the reference's per-token
    oracle ``x[i] @ w[group_ids[i]]``, and a block past the last group is
    zeros."""
    rng = np.random.default_rng(1)
    sizes = torch.tensor([16, 0, 8, 0], dtype=torch.int32)
    x = torch.from_numpy(rng.standard_normal((32, 12)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((4, 12, 5)).astype(np.float32))
    got = ops.moe_group_gemm(x, w, sizes, tt=8)
    ids = torch.repeat_interleave(torch.arange(4), sizes.long())
    want = torch.einsum("td,tdo->to", x[:24], w[ids])
    torch.testing.assert_close(got[:24], want, rtol=2e-5, atol=2e-5)
    assert (got[24:] == 0).all()


def test_impl_dispatch_and_no_fallback():
    sizes = torch.tensor([8, 8], dtype=torch.int32)
    x = torch.randn(16, 4)
    w = torch.randn(2, 4, 3)
    block_expert = moe_gemm.plan_groups(sizes, 16, 8)
    want = ref.moe_group_gemm_ref(x, w, block_expert, 8)
    torch.testing.assert_close(ops.moe_group_gemm(x, w, sizes, tt=8), want)
    torch.testing.assert_close(
        ops.moe_group_gemm(x, w, sizes, tt=8, impl="torch"), want)
    before = moe_gemm.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        ops.moe_group_gemm(x, w, sizes, tt=8, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        moe_gemm.moe_group_gemm_cuda(x, w, torch.zeros(2, dtype=torch.int32),
                                     tt=8)
    assert moe_gemm.LAUNCHES == before
    with pytest.raises(ValueError, match="unknown impl"):
        ops.moe_group_gemm(x, w, sizes, tt=8, impl="pallas")
    with pytest.raises(ValueError, match="multiple of tt"):
        ops.moe_group_gemm(x[:12], w, sizes, tt=8)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("tt,d_in,d_out,aligned,bf16_body", [
    (8, 64, 96, True, "wmma"),        # the reference's tt-8 sweep
    (8, 16, 16, True, "wmma"),
    (8, 32, 48, True, "wmma"),
    (96, 100, 200, True, "wmma"),     # ragged tt and d_in
    (64, 2048, 1024, True, "wgmma"),  # OLMoE-1B-7B w1 / w3
    (64, 1024, 2048, True, "wgmma"),  # OLMoE-1B-7B w2
    (128, 1024, 384, True, "wgmma"),  # two row tiles a block
    (64, 2056, 256, True, "wgmma"),   # d_in past a 64-deep stage
    (64, 512, 200, True, "wgmma"),    # d_out past a 128-column tile
    (64, 2052, 256, True, "wmma"),    # d_in not a multiple of 8
    (64, 512, 204, True, "wmma"),     # d_out not a multiple of 8
    (64, 0, 128, True, "wmma"),       # no d_in: TMA maps no empty dim
    (32, 2048, 1024, True, "wmma"),   # tt below a wgmma tile
    (64, 2048, 1024, False, "wmma"),  # an operand off 16 bytes
])
def test_body_rule(tt, d_in, d_out, aligned, bf16_body, dt):
    """Which body the kernel runs, as the C entry reports it and
    chip_smoke.py asserts it on the card: wgmma for bf16 at tt a multiple
    of 64, d_in a positive multiple of 8, d_out a multiple of 8 and
    16-byte aligned operands; WMMA for the other bf16 calls; SIMT for
    f32."""
    tdt = DTYPES[dt][1]
    want = "simt" if tdt == torch.float32 else bf16_body
    assert moe_gemm.body_for(tdt, tt, d_in, d_out, aligned=aligned) == want
    with pytest.raises(TypeError):
        moe_gemm.body_for(torch.float16, tt, d_in, d_out)


def test_body_codes_match_the_kernel():
    """BODIES names the codes that the C entry reports (enum MoeBody in
    csrc/moe_gemm.cu)."""
    src = (_cuda.CSRC / "moe_gemm.cu").read_text()
    enum = re.search(r"enum MoeBody : int \{([^}]*)\}", src).group(1)
    codes = {name.strip(): int(val) for name, val in
             (item.split("=") for item in enum.split(","))}
    assert codes == {"kBodySimt": moe_gemm.BODIES.index("simt"),
                     "kBodyWmma": moe_gemm.BODIES.index("wmma"),
                     "kBodyWgmma": moe_gemm.BODIES.index("wgmma")}


@pytest.mark.parametrize("impl", [None, "torch"])
def test_plain_runs_count_no_launch(impl):
    """On the CPU, and under impl="torch", the op runs the plain version:
    no launch is counted, by body or in all."""
    sizes = torch.tensor([64, 0, 64], dtype=torch.int32)
    x = torch.randn(128, 16, dtype=torch.bfloat16)
    w = torch.randn(3, 16, 24, dtype=torch.bfloat16)
    before = moe_gemm.LAUNCHES
    by_body = dict(moe_gemm.LAUNCHES_BY_BODY)
    ops.moe_group_gemm(x, w, sizes, tt=64, impl=impl)
    assert moe_gemm.LAUNCHES == before
    assert moe_gemm.LAUNCHES_BY_BODY == by_body == {}


def _moe_both(capacity_factor, seed=0, batch=2, seq=8):
    """The smoke OLMoE MoE layer in both packages at f32 compute, the
    reference's params carried across."""
    jcfg = dataclasses.replace(jget_smoke(ARCH), compute_dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(ARCH),
                               compute_dtype="float32")
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = np.random.default_rng(seed + 1).standard_normal(
        (batch, seq, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, tp, x


@pytest.mark.parametrize("capacity_factor", [1.25, 0.25])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_moe_apply_matches_reference(capacity_factor, use_kernel):
    """Sort dispatch at the default capacity and at one low enough to drop
    replicas (tt = 8 so that the capacity binds: 64 tokens x top-2 over 8
    experts); the port through the batched matmul and through the grouped
    GEMM op (its plain version on the CPU), both against the reference's
    XLA path."""
    jcfg, tcfg, jp, tp, x = _moe_both(capacity_factor, batch=4, seq=16)
    want, jaux = jmoe.moe_apply(jp, jnp.asarray(x), jcfg, tt=8,
                                use_kernel=False,
                                capacity_factor=capacity_factor)
    got, aux = moe.moe_apply(tp, torch.from_numpy(x), tcfg, tt=8,
                             use_kernel=use_kernel,
                             capacity_factor=capacity_factor)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def test_moe_dispatch_drops_beyond_capacity():
    """With tt = 8 and capacity factor 0.25, experts overflow: the dropped
    replicas match the reference's, and the outputs agree."""
    jcfg, tcfg, jp, tp, x = _moe_both(0.25, seed=3, batch=4, seq=16)
    xt = x.reshape(-1, jcfg.d_model)
    _, jexp, _ = jmoe.route(jp, jnp.asarray(xt), jcfg)
    _, jmeta = jmoe._sorted_dispatch(jnp.asarray(xt), jexp, jcfg, 8, 0.25)
    _, texp, _ = moe.route(tp, torch.from_numpy(xt), tcfg)
    np.testing.assert_array_equal(texp.numpy(), np.asarray(jexp))
    buf, meta = moe._sorted_dispatch(torch.from_numpy(xt), texp, tcfg, 8,
                                     0.25)
    np.testing.assert_array_equal(meta["keep"].numpy(),
                                  np.asarray(jmeta["keep"]))
    np.testing.assert_array_equal(meta["slot"].numpy(),
                                  np.asarray(jmeta["slot"]))
    assert meta["cap"] == jmeta["cap"]
    assert not meta["keep"].all()                 # some replicas dropped
    want, _ = jmoe.moe_apply(jp, jnp.asarray(x), jcfg, tt=8,
                             use_kernel=False, capacity_factor=0.25)
    got, _ = moe.moe_apply(tp, torch.from_numpy(x), tcfg, tt=8,
                           use_kernel=True, capacity_factor=0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def test_sort_matches_dense_at_full_capacity():
    """The port's sort dispatch equals its dense einsum baseline when the
    capacity holds every replica (tests/test_models.py
    test_moe_sort_matches_dense)."""
    _, tcfg, _, tp, x = _moe_both(1.25)
    xt = torch.from_numpy(x)
    y_sort, aux1 = moe.moe_apply(tp, xt, tcfg, use_kernel=True,
                                 capacity_factor=float(tcfg.num_experts))
    y_dense, aux2 = moe.moe_apply(
        tp, xt, dataclasses.replace(tcfg, moe_impl="dense"))
    torch.testing.assert_close(y_sort, y_dense, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(aux1, aux2, rtol=1e-5, atol=0)


def test_moe_groups_raise():
    # A capacity low enough that some experts of each group drop replicas
    # and others do not.
    for use_kernel in (False, True):
        _moe_groups_case(0.25, use_kernel)


def _moe_groups_case(capacity_factor, use_kernel):
    """``moe_groups = 2`` (it raised before the hierarchical dispatch was
    ported): two groups of 32 tokens, each with its own capacity and
    drops, against the reference's ``vmap`` over the groups, and not the
    ungrouped result; through the batched matmul and the grouped GEMM op
    (its plain version here, the groups folded into one call a
    weight)."""
    jcfg, tcfg, jp, tp, x = _moe_both(capacity_factor, batch=4, seq=16)
    jcfg = dataclasses.replace(jcfg, moe_groups=2)
    tcfg = dataclasses.replace(tcfg, moe_groups=2)
    want, jaux = jmoe.moe_apply(jp, jnp.asarray(x), jcfg, tt=8,
                                use_kernel=False,
                                capacity_factor=capacity_factor)
    got, aux = moe.moe_apply(tp, torch.from_numpy(x), tcfg, tt=8,
                             use_kernel=use_kernel,
                             capacity_factor=capacity_factor)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    flat, _ = moe.moe_apply(tp, torch.from_numpy(x),
                            dataclasses.replace(tcfg, moe_groups=0), tt=8,
                            use_kernel=use_kernel,
                            capacity_factor=capacity_factor)
    assert not torch.allclose(flat, got, rtol=2e-4, atol=2e-4)


def test_moe_groups_indivisible_takes_the_ungrouped_path():
    """``b·s`` not divisible by ``moe_groups``: the ungrouped dispatch, as
    in the reference."""
    jcfg, tcfg, jp, tp, x = _moe_both(1.25, batch=3, seq=5)
    got, _ = moe.moe_apply(tp, torch.from_numpy(x),
                           dataclasses.replace(tcfg, moe_groups=4))
    flat, _ = moe.moe_apply(tp, torch.from_numpy(x), tcfg)
    assert torch.equal(got, flat)
    want, _ = jmoe.moe_apply(jp, jnp.asarray(x),
                             dataclasses.replace(jcfg, moe_groups=4),
                             use_kernel=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def test_full_width_capacity_is_one_block_per_expert():
    """OLMoE at its published widths: the capacity is one 64-token block
    per expert at prefill (4 x 32 tokens) and decode (4 tokens), so every
    grouped GEMM launch has 64 x 64 = 4096 rows."""
    cfg = get_config(ARCH)
    x = torch.zeros(1, cfg.d_model)
    for t in (128, 4):
        experts = torch.zeros(t, cfg.top_k, dtype=torch.int64)
        buf, meta = moe._sorted_dispatch(x.expand(t, -1), experts, cfg,
                                         moe.TT)
        assert meta["cap"] == 64 and buf.shape == (4096, cfg.d_model)
