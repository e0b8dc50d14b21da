"""The dry run (``python -m repro_torch.launch.dryrun``) on one cell, in a
child process: its fake process group of 256 ranks is global to the
process, so none is left up in a test worker.  The cell's placements
must compose, and its per-rank bytes must equal what the reference's
sharding rules give on the reference's own leaves."""
import json
import math
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import SHAPES, get_config  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Mesh16:
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


def _local_bytes(tree, spec_of) -> int:
    """Bytes of the largest per-rank block of each leaf under the
    reference's spec for it, summed."""
    total = 0
    for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
        spec = tuple(spec_of(path, x)) + (None,) * len(x.shape)
        n = 1
        for d, a in zip(x.shape, spec):
            n *= -(-d // jsh._axis_size(Mesh16, a))
        total += n * jnp.dtype(x.dtype).itemsize
    return total


def test_dryrun_cell_in_child(tmp_path):
    arch, shape = "llama3.2-1b", "decode_32k"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src")] + [p for p in os.environ.get(
            "PYTHONPATH", "").split(os.pathsep) if p]))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--out", str(tmp_path)], env=env,
        capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "dry-run: 1/1 cells composed" in proc.stdout
    with open(tmp_path / f"{arch}__{shape}__16x16.json",
              encoding="utf-8") as f:
        rec = json.load(f)
    assert rec["ok"] and rec["mesh"] == "16x16" and rec["fits_card"]

    want = jspecs.input_specs(arch, shape)
    cfg, shp = get_config(arch), SHAPES[shape]
    got = rec["per_rank_bytes"]
    assert got["params"] == _local_bytes(
        want["params"], lambda p, x: jsh.param_pspec(p, x, Mesh16))
    assert got["caches"] == _local_bytes(
        want["caches"], lambda p, x: jsh.cache_pspec(p, x, Mesh16))
    # The same by hand: k and v, batch over 16, sequence over 16, bf16.
    assert got["caches"] == 2 * cfg.num_layers * math.prod(
        (shp.global_batch // 16, shp.seq_len // 16, cfg.num_kv_heads,
         cfg.head_dim)) * 2
    # The port's tokens are int64 (the reference's int32).
    assert got["batch"] == shp.global_batch // 16 * 8
    assert got["opt"] == got["grads"] == 0
    assert rec["per_rank_total"] == sum(got.values())
    assert rec["model_params"] == sum(
        math.prod(x.shape) for x in jax.tree.leaves(want["params"]))
