"""Architectures as files: a configuration names its architecture, whose
code the harness loads from ``bench/archs/<arch>/``.  A new one is new
files only, and each is held to its own reference; the dense one is the
code that the cells ran before it moved there."""
import hashlib
import json
import shutil

import pytest

import counts
import harness
from conftest import CELLS, DENSE, smoke_config

SEED = 2 ** 31 + 17
BACKLOG = "granite-3-2b-smoke.score-backlog"
FINAL_NORM = 'prec.act(rms_norm(x, w["final_norm"], cfg["rms_norm_eps"]))'


def with_probe(root, *, reference_fault=False):
    """The smoke root with ``archs/probe``, a copy of ``archs/dense`` whose
    ``request_flops`` counts each token a second at the card's bf16 peak,
    a configuration ``probe`` (Granite's smoke variant) naming it, and a
    cell ``probe`` of the Granite backlog's traffic and metrics.  With
    ``reference_fault`` the probe's reference leaves out the final norm."""
    archs = root / "bench" / "archs"
    shutil.copytree(archs / "dense", archs / "probe",
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(archs / "probe" / "counts.py", "a") as f:
        f.write("\n\ndef request_flops(cfg, length):\n"
                "    return counts.PEAK_BF16_FLOPS * length\n")
    if reference_fault:
        ref = archs / "probe" / "reference.py"
        src = ref.read_text()
        assert src.count(FINAL_NORM) == 1
        ref.write_text(src.replace(FINAL_NORM, "prec.act(x)"))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cell = next(w for w in spec["workloads"] if w["name"] == BACKLOG)
    base = next(c for c in spec["configs"] if c["name"] == cell["config"])
    cfg = json.loads((root / base["file"]).read_text())
    cfg.update(name="probe", arch="probe")
    (root / "bench" / "configs" / "probe.json").write_text(json.dumps(cfg))
    spec["configs"].append(dict(base, name="probe",
                                file="bench/configs/probe.json"))
    spec["workloads"].append(dict(cell, name="probe", config="probe"))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if BACKLOG in m.get("workloads", []):
            m["workloads"].append("probe")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def run(root, *, trace):
    return harness.run_cell(harness.Cells(root), "probe", seed=SEED,
                            seconds=1.5, trace=trace, device="cpu",
                            t_start=0.0)


def test_a_new_architecture_is_new_files_only(root):
    out = run(with_probe(root), trace=True)
    assert out["correct"], out["compared"]
    # A share of the peak over 100 % is the probe's count, no real one.
    assert out["metrics"]["step.mfu.backlog"]["value"] > 100
    assert out["metrics"]["step.mfu_calls.backlog"]["value"] > 100


def test_an_architecture_is_held_to_its_own_reference(root):
    out = run(with_probe(root, reference_fault=True), trace=False)
    assert not out["correct"], out["compared"]


# Read at the commit before the dense code moved (4183a8f: bench/weights.py
# and bench/counts.py), from the root of its tree, ``digest`` pasted in:
#   python3 -c 'import sys; sys.path[:0] = ["bench", "bench/tests"]
#   import hashlib, json, weights, counts, conftest
#   def digest(w): ...
#   for n in ("granite-3-2b", "qwen2-72b-stage8"):
#       print(digest(weights.make(conftest.smoke_config(n), 2 ** 31 + 7,
#                                 "cpu")))
#       cfg = json.load(open(f"bench/configs/{n}.json"))
#       print([counts.request_flops(cfg, x) for x in (1, 69, 256, 1024)])'
WEIGHTS_SEED = 2 ** 31 + 7
WEIGHTS_SHA256 = {
    "granite-3-2b":
        "2407c049249c8aeb3a086e29b2aefb6c947aec02088f00fdc362f8902ed382bc",
    "qwen2-72b-stage8":
        "76cfb6389735e338af580e657c1ad1b325948425b52cffa12d6f7f45fc378eac"}
LENGTHS = (1, 69, 256, 1024)
REQUEST_FLOPS = {
    "granite-3-2b": (2047160320.0, 142022799360.0, 534768517120.0,
                     2267923087360.0),
    "qwen2-72b-stage8": (7814250496.0, 539798274048.0, 2009004507136.0,
                         8139097243648.0)}


def digest(w: dict) -> str:
    """SHA-256 over every weight's name and float32 bytes, in order."""
    h = hashlib.sha256()
    parts = [(k, w[k]) for k in ("embed", "unembed", "final_norm") if k in w]
    for i, lw in enumerate(w["layers"]):
        parts += [(f"{i}.{k}", lw[k]) for k in sorted(lw)]
    for name, t in parts:
        h.update(name.encode())
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(WEIGHTS_SHA256))
def test_dense_weights_are_the_parents(name):
    w = DENSE.weights.make(smoke_config(name), WEIGHTS_SEED, "cpu")
    assert digest(w) == WEIGHTS_SHA256[name]


@pytest.mark.parametrize("name", sorted(REQUEST_FLOPS))
def test_dense_request_flops_are_the_parents(name):
    cfg = CELLS.config(name)
    got = tuple(DENSE.counts.request_flops(cfg, n) for n in LENGTHS)
    assert got == REQUEST_FLOPS[name]


@pytest.mark.parametrize("name", sorted(REQUEST_FLOPS))
def test_dense_spmm_launches_are_each_layers_ffn_matrices(name):
    cfg = CELLS.config(name)
    one = [(m, k, nnz) for _, m, k, nnz in counts.ffn_matrices(cfg)]
    assert DENSE.counts.spmm_launches(cfg) == \
        one * cfg["num_hidden_layers"]
