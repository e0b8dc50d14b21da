"""The port's flash attention against the JAX reference on the same numpy
inputs: ``ops.flash_attention`` (the plain version the CPU runs) against
the reference's ``ops.flash_attention``, which runs the Pallas kernel in
interpret mode as tests/test_flash_kernel.py runs it; the plain version
against the port's model-path ``layers.causal_attention``; the exactness
of its query chunking; and the no-fallback contract of the CUDA wrapper.

Tolerances are the reference's (tests/test_flash_kernel.py): f32
rtol/atol 2e-5, bf16 3e-2."""
import re

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    _cuda, flash_attention, ops, ref)
from repro_torch.models import layers  # noqa: E402

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": dict(rtol=2e-5, atol=2e-5), "bf16": dict(rtol=3e-2, atol=3e-2)}


def _mk(b, s, h, kvh, dh, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, dh)).astype(np.float32),
            rng.standard_normal((b, s, kvh, dh)).astype(np.float32),
            rng.standard_normal((b, s, kvh, dh)).astype(np.float32))


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("b,s,h,kvh,dh", [
    (1, 256, 4, 4, 64),     # the reference's sweep: MHA
    (2, 128, 4, 2, 32),     # GQA g=2
    (1, 384, 8, 2, 64),     # GQA g=4, 3 blocks
    (1, 200, 4, 4, 32),     # ragged s (the reference pads to 256)
    (4, 32, 8, 2, 16),      # a served prefill shape, s below one block
    # The CUDA kernel's tile edges (its wgmma body at dh 64 and 128:
    # 128-key tiles, query tiles of 192 and 128 rows), b = 2 and g = 4:
    # s = 129 puts one key past a tile and a tile across the diagonal;
    # s = 200 leaves ragged last tiles, which the card zero-fills without
    # reading the next batch.
    (2, 129, 8, 2, 64),
    (2, 200, 8, 2, 64),
    (2, 129, 8, 2, 128),
    (2, 200, 8, 2, 128),
])
def test_flash_matches_reference_pallas(b, s, h, kvh, dh, dt):
    arrays = _mk(b, s, h, kvh, dh, seed=b * 1000 + s)
    jdt, tdt = DTYPES[dt]
    want = jops.flash_attention(*(jnp.asarray(x, jdt) for x in arrays),
                                bq=128, bk=128)
    got = ops.flash_attention(*(torch.from_numpy(x).to(tdt)
                                for x in arrays), bq=128, bk=128)
    assert got.dtype == tdt and got.shape == (b, s, h, dh)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dt])


def test_plain_matches_model_path_attention():
    """The plain version agrees with the attention the port's model path
    computes (the reference's test_flash_kernel_matches_model_flash)."""
    q, k, v = (torch.from_numpy(x) for x in _mk(2, 256, 4, 2, 64, seed=5))
    got = ops.flash_attention(q, k, v)
    want = layers.causal_attention(q, k, v)
    torch.testing.assert_close(got, want, **TOL["f32"])


def test_plain_query_chunks_are_exact():
    """Each row's softmax is its own, so chunking the query rows changes
    nothing, bit for bit (s > the default chunk of 1024 rows)."""
    q, k, v = (torch.from_numpy(x) for x in _mk(1, 1100, 4, 2, 32, seed=7))
    chunked = ref.flash_attention_ref(q, k, v)
    whole = ref.flash_attention_ref(q, k, v, chunk=1100)
    small = ref.flash_attention_ref(q, k, v, chunk=100)
    assert torch.equal(chunked, whole) and torch.equal(small, whole)


def test_dispatch_has_no_fallback():
    q, k, v = (torch.from_numpy(x) for x in _mk(1, 64, 4, 2, 32))
    before = flash_attention.LAUNCHES
    ops.flash_attention(q, k, v)                  # impl=None on the CPU
    assert flash_attention.LAUNCHES == before == 0
    assert flash_attention.LAUNCHES_BY_BODY == {}
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.flash_attention(q, k, v, impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        ops.flash_attention(q, k, v, impl="xla")
    with pytest.raises(ValueError, match="bq"):
        ops.flash_attention(q, k, v, bq=0)
    k3 = k[:, :, :1].expand(1, 64, 3, 32)
    with pytest.raises(ValueError, match="heads"):
        ops.flash_attention(q, k3, k3)
    with pytest.raises(ValueError, match="head_dim 24"):
        flash_attention.flash_attention_cuda(q[..., :24], k[..., :24],
                                             v[..., :24])
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention.flash_attention_cuda(q.requires_grad_(), k, v)
    assert flash_attention.LAUNCHES == 0
    assert flash_attention.LAUNCHES_BY_BODY == {}


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("dh", flash_attention.HEAD_DIMS)
def test_body_rule(dh, dt):
    """Which body the kernel runs, as chip_smoke.py asserts it on the card:
    wgmma for bf16 at the served models' dh 64 and 128, mma.sync for bf16
    at the other head dims, SIMT for f32."""
    tdt = DTYPES[dt][1]
    want = ("simt" if tdt == torch.float32
            else "wgmma" if dh in (64, 128) else "mma_sync")
    assert flash_attention.body_for(tdt, dh) == want
    with pytest.raises(TypeError):
        flash_attention.body_for(torch.float16, dh)


def test_body_codes_match_the_kernel():
    """BODIES names the codes that the C entry reports (enum Body in
    csrc/flash_attention.cu)."""
    src = (_cuda.CSRC / "flash_attention.cu").read_text()
    enum = re.search(r"enum Body : int \{([^}]*)\}", src).group(1)
    codes = {name.strip(): int(val) for name, val in
             (item.split("=") for item in enum.split(","))}
    assert codes == {"kSimt": flash_attention.BODIES.index("simt"),
                     "kMmaSync": flash_attention.BODIES.index("mma_sync"),
                     "kWgmma": flash_attention.BODIES.index("wgmma")}


def test_plain_is_differentiable_on_cpu():
    """The plain version is ordinary autograd on the CPU (the kernel, like
    the reference's, has no backward)."""
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _mk(1, 40, 2, 1, 16, seed=9))
    ops.flash_attention(q, k, v).sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in (q, k, v))


# ---------------------------------------------------------------------------
# The model path's blockwise attention (``layers.flash_attention``) against
# the reference's ``repro.models.layers.flash_attention`` (plain JAX, no
# Pallas) on the same numpy inputs: f32 at 2e-5, gradients at the
# reference's gradient bar (tests/test_spmm_grad.py:23).

import jax  # noqa: E402

from repro.models import layers as jlayers  # noqa: E402

GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
# The cases whose gradients are held too (a window, an offset, a softcap).
GRAD_CASES = ("full", "swa96_offset", "softcap")
# (window, softcap, q_offset, sq): the full causal case, sliding window
# 96 (a span of 192 keys a 64-query chunk, its first chunk masked for
# every query), a logit softcap, and a continuation whose 128 queries sit
# at positions 128-255 of a 256-key cache.
BLOCKWISE = {"full": (None, 0.0, 0, 256), "swa96": (96, 0.0, 0, 256),
             "softcap": (None, 30.0, 0, 256),
             "full_offset": (None, 0.0, 128, 128),
             "swa96_offset": (96, 0.0, 128, 128),
             "softcap_offset": (None, 30.0, 128, 128)}


@pytest.fixture
def one_thread():
    """Small blocks: one intra-op thread (many threads only wait on each
    other at these sizes when the host is shared)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _blockwise_inputs(sq, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, sq, 4, 32)).astype(np.float32)
    k = rng.standard_normal((2, 256, 2, 32)).astype(np.float32)
    v = rng.standard_normal((2, 256, 2, 32)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("case", list(BLOCKWISE))
def test_blockwise_matches_reference(case, one_thread):
    window, softcap, off, sq = BLOCKWISE[case]
    q, k, v = _blockwise_inputs(sq, seed=len(case))
    kw = dict(q_offset=off, window=window, softcap=softcap, q_chunk=64,
              kv_chunk=64)
    ts = [torch.from_numpy(x).requires_grad_(case in GRAD_CASES)
          for x in (q, k, v)]
    got = layers.flash_attention(*ts, **kw)
    jin = [jnp.asarray(x) for x in (q, k, v)]
    if case not in GRAD_CASES:
        want = jlayers.flash_attention(*jin, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-5)
        return
    # Gradients of sum(out * w) for q, k and v, from one trace.
    want, vjp = jax.vjp(lambda *a: jlayers.flash_attention(*a, **kw), *jin)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    w = np.random.default_rng(7).standard_normal(want.shape).astype(
        np.float32)
    (got * torch.from_numpy(w)).sum().backward()
    for name, t, j in zip("qkv", ts, vjp(jnp.asarray(w))):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j),
                                   **GRAD_TOL, err_msg=name)


def test_blockwise_skip_of_masked_blocks_keeps_the_bits(monkeypatch,
                                                       one_thread):
    """Skipping a block whose every key is masked (above the diagonal, or
    out of the window) leaves every bit of the output and the gradients."""
    q, k, v = _blockwise_inputs(256, seed=3)

    def run():
        out = {}
        for name, window in (("full", None), ("swa96", 96)):
            ts = [torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v)]
            o = layers.flash_attention(*ts, window=window, q_chunk=64,
                                       kv_chunk=64)
            (o * o).sum().backward()
            out[name] = [o.detach()] + [t.grad for t in ts]
        return out

    skipped = run()
    monkeypatch.setattr(layers, "SKIP_MASKED_BLOCKS", False)
    every = run()
    for name in skipped:
        for a, b in zip(skipped[name], every[name]):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), \
                name


def test_blockwise_largest_tensor_is_a_block(one_thread):
    """At s = 2048 with 512-chunks no tensor made inside the attention,
    forward or backward, holds more than a few blocks' scores: its size is
    O(b · h · q_chunk · kv_chunk), not the O(b · h · s²) of the whole
    score matrix."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Largest(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.numel = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor):
                    self.numel = max(self.numel, t.numel())
            return out

    b, s, h, kvh, dh, c = 1, 2048, 4, 2, 16, 512
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(b, s, n, dh, generator=g).requires_grad_(True)
               for n in (h, kvh, kvh))
    block = b * h * c * c
    with Largest() as fwd:
        out = layers.flash_attention(q, k, v, q_chunk=c, kv_chunk=c)
    with Largest() as bwd:
        out.sum().backward()
    assert max(fwd.numel, bwd.numel) <= block, (fwd.numel, bwd.numel)
    assert b * h * s * s == 16 * block
    # The model path takes the reference's chunk: 1024 to 8192 tokens,
    # 512 above.
    assert [layers.attention_chunk(n) for n in (32, 8192, 8193, 32768)] \
        == [1024, 1024, 512, 512]


@pytest.mark.parametrize("window", [None, 96])
def test_model_path_takes_a_ragged_length(window, one_thread):
    """The model path's attention at a length past its 1024-chunk that is
    no multiple of it (1100 tokens, padded to 2048 inside) against every
    score of the prompt at once, f32."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((1, 1100, 2, 16)).astype(
        np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((1, 1100, 1, 16)).astype(
        np.float32)) for _ in range(2))
    got = layers.causal_attention(q, k, v, window=window)
    sc = torch.einsum("bqgd,bskd->bgqs", q, k) * 16 ** -0.5
    pos = torch.arange(1100)
    mask = pos[:, None] >= pos[None, :]
    if window is not None:
        mask &= pos[None, :] > pos[:, None] - window
    p = torch.softmax(sc.masked_fill(~mask, float("-inf")), dim=-1)
    want = torch.einsum("bgqs,bskd->bqgd", p, v)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
