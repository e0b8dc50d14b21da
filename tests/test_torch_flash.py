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
