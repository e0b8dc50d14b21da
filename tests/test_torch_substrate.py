"""The trainer's substrate in the port: the data pipeline against the JAX
reference (tokens and labels array-equal), and port-only twins of the
reference's checkpoint and fault tests (tests/test_substrate.py, which
needs hypothesis) and of its train CLI, on the CPU."""
import os
import signal

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import make_source as jmake_source  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM, make_source  # noqa: E402
from repro_torch.distributed import fault  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.runtime import steps as R  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402



@pytest.fixture(autouse=True)
def _keep_sigterm():
    """The CLI installs its preemption handler; give the test process its
    own back afterwards."""
    prev = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, prev)


# ------------------------------------------------------------------ data ---


@pytest.mark.parametrize("seed,step,shards", [(0, 0, 1), (3, 7, 2),
                                              (11, 123456, 4)])
def test_synthetic_batches_array_equal_to_reference(seed, step, shards):
    kw = dict(vocab_size=50304, seq_len=16, global_batch=8, seed=seed)
    for shard in range(shards):
        want = jmake_source(JDataConfig(**kw), None, shard,
                            shards).batch_at(step)
        got = make_source(DataConfig(**kw), None, shard,
                          shards).batch_at(step)
        for k in ("tokens", "labels"):
            assert got[k].dtype == torch.int64 and got[k].device.type == \
                "cpu"
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))


def test_embedding_batches_array_equal_to_reference():
    kw = dict(vocab_size=101, seq_len=8, global_batch=2, seed=1,
              input_mode="embeddings", d_model=12)
    want = jmake_source(JDataConfig(**kw)).batch_at(3)
    got = make_source(DataConfig(**kw)).batch_at(3)
    np.testing.assert_array_equal(got["embeds"].numpy(),
                                  np.asarray(want["embeds"]))
    np.testing.assert_array_equal(got["labels"].numpy(),
                                  np.asarray(want["labels"]))


def test_packed_file_batches_array_equal_to_reference(tmp_path):
    path = str(tmp_path / "tokens.bin")
    np.random.default_rng(0).integers(0, 1000, 997).astype(
        np.int32).tofile(path)
    kw = dict(vocab_size=1000, seq_len=16, global_batch=4)
    for step in (0, 5, 40):
        want = jmake_source(JDataConfig(**kw), path, 1, 2).batch_at(step)
        got = make_source(DataConfig(**kw), path, 1, 2).batch_at(step)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))


def test_data_labels_are_shifted_tokens():
    b = SyntheticLM(DataConfig(vocab_size=50, seq_len=12,
                               global_batch=2)).batch_at(0)
    assert b["tokens"].shape == b["labels"].shape == (2, 12)
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    assert int(b["tokens"].max()) < 50


# ------------------------------------------------------------ checkpoint ---


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(4, 5, generator=g),
                       "b": torch.zeros(5),
                       "blocks": [{"h": torch.randn(3, generator=g).to(
                           torch.bfloat16)}]},
            "opt": {"step": torch.tensor(7, dtype=torch.int32)}}


def _assert_bit_equal(a, b):
    for x, y in zip(leaves(a), leaves(b), strict=True):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def test_checkpoint_roundtrip_with_a_bf16_leaf(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    t = _tree()
    mgr.save(10, t, extra={"data_step": 10})
    restored, step, extra = mgr.restore_latest(_tree(seed=1))
    assert step == 10 and extra["data_step"] == 10
    _assert_bit_equal(restored, t)
    assert restored["params"]["blocks"][0]["h"].dtype == torch.bfloat16


def test_checkpoint_retention_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree())
    assert mgr.all_steps() == [3, 4]
    with open(tmp_path / "LATEST") as f:
        assert f.read() == "step_00000004"


def test_checkpoint_corruption_fallback(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    t = _tree()
    mgr.save(1, t)
    mgr.save(2, _tree(seed=5))
    # corrupt the newest step's first array
    victim = os.path.join(str(tmp_path), "step_00000002", "arr_00000_p00.npy")
    arr = np.load(victim)
    np.save(victim, arr + 1)
    restored, step, _ = mgr.restore_latest(t)
    assert step == 1  # fell back past the corrupt step
    _assert_bit_equal(restored, t)


def test_checkpoint_of_another_tree_is_not_restored(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree())
    other = _tree()
    other["params"]["extra"] = torch.zeros(2)
    assert mgr.restore_latest(other) == (None, -1, {})


def test_checkpoint_atomicity_no_partial_dirs(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(5, _tree())
    entries = os.listdir(str(tmp_path))
    assert not any(e.endswith(".tmp0") for e in entries)
    assert "LATEST" in entries


# ----------------------------------------------------------------- fault ---


def test_straggler_watermark_flags_slow_steps():
    w = fault.StragglerWatermark(factor=2.0, warmup=3)
    for i in range(10):
        w.observe(i, 1.0)
    assert w.observe(10, 5.0) is True
    assert not w.observe(11, 1.0)
    assert w.flagged and w.flagged[0][0] == 10


def test_preemption_guard_sets_its_flag_on_sigterm():
    guard = fault.PreemptionGuard().install().install()
    assert not guard.should_checkpoint()
    os.kill(os.getpid(), signal.SIGTERM)
    assert guard.should_checkpoint()


def test_step_timer_measures_its_block():
    with fault.StepTimer() as t:
        sum(range(1000))
    assert 0.0 <= t.seconds < 5.0


def test_retry_retries_then_succeeds():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise IOError("transient")
        return "ok"

    assert fault.retry(flaky, attempts=5, backoff=0.0) == "ok"
    assert calls["n"] == 3


# ------------------------------------------------------------------- CLI ---

SMOKE = ["--smoke", "--device", "cpu", "--global-batch", "2", "--seq-len",
         "16", "--log-every", "1"]




def test_train_cli_runs_and_resumes(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    metrics = str(tmp_path / "m.json")
    assert train.main(SMOKE + ["--steps", "2", "--ckpt-dir", ck,
                               "--metrics-out", metrics]) == 0
    out = capsys.readouterr().out
    assert "step     1 loss=" in out and "resumed" not in out
    assert os.path.exists(metrics)
    assert train.main(SMOKE + ["--steps", "3", "--ckpt-dir", ck,
                               "--microbatches", "2"]) == 0
    out = capsys.readouterr().out
    assert "[train] resumed from step 2" in out
    assert "step     2 loss=" in out and "step     1 " not in out
    assert CheckpointManager(ck).all_steps() == [2, 3]


def test_train_cli_int8_moe_runs(capsys):
    assert train.main(SMOKE + ["--arch", "olmoe-1b-7b", "--steps", "1",
                               "--grad-compression", "int8_ef"]) == 0
    assert "step     0 loss=" in capsys.readouterr().out


@pytest.mark.parametrize("args", [["--spmm-shards"], ["--spmm-shards", "2"]])
def test_train_cli_refuses_unported_flags(args, capsys):
    """``--spmm-shards`` (refused before the sharding slice): without a
    count it is an argparse error, as the reference's ``type=int`` flag;
    ``--spmm-shards 2`` trains, and says it sharded nothing (the dense
    smoke model has no sparse leaf)."""
    if len(args) == 1:
        with pytest.raises(SystemExit) as e:
            train.main(SMOKE + args)
        assert e.value.code == 2
        assert "expected one argument" in capsys.readouterr().err
        return
    assert train.main(SMOKE + args + ["--steps", "2"]) == 0
    out = capsys.readouterr().out
    assert "[train] 0 sparse leaves sharded into 2" in out
    assert "step     1 loss=" in out


def test_train_spmm_shards_policy_shards_sparse_leaves():
    """The train CLI's ``--spmm-shards`` policy on a tree that has a
    ``SparseLinear``: ``ensure_spmm_plans`` attaches a two-shard plan, run
    as the per-shard loop (no process group), equal to the unsharded
    layer."""
    from repro_torch.core import PlanPolicy, ShardSpec
    from repro_torch.core.csr import random_csr
    from repro_torch.models.sparse import SparseLinear
    w = random_csr(3, 48, 32, nnz_per_row=(1, 9))
    tree = {"blocks": [{"mlp": {"w1": SparseLinear(w, None)}}], "x": 1}
    policy = PlanPolicy(shards=ShardSpec(n=2, mesh=None))
    out = R.ensure_spmm_plans(tree, policy=policy)
    assert R.count_sparse_leaves(out) == 1
    layer = out["blocks"][0]["mlp"]["w1"]
    assert layer.plan.meta.n_shards == 2 and layer.plan.meta.spmd_mesh() \
        is None
    x = torch.randn(5, 32, generator=torch.Generator().manual_seed(0))
    flat = SparseLinear(w, None)
    torch.testing.assert_close(layer(x), flat(x), rtol=2e-5, atol=2e-5)


def test_train_cli_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(SystemExit, match="--device cpu"):
        train.main(["--smoke", "--steps", "1"])
