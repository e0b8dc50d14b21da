"""The benchmark's own tests (not collected by the repo's suite):

    python -m pytest -q bench/tests            # on the CPU
    python -m pytest -q -m cuda bench/tests    # on the card

Cells at a size the CPU holds are made from the committed configuration
files by :func:`smoke_root`: the same file with the keys its architecture
cuts (``archs/<arch>/weights.py``'s ``SMOKE``) cut, in a copy of the
benchmark under a temporary root.
"""
import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

import harness  # noqa: E402

CELLS = harness.Cells(ROOT)
CONFIGS = tuple(c["name"] for c in CELLS.spec["configs"])
DENSE = harness.Arch.load(BENCH, "dense")


def smoke_config(name: str) -> dict:
    cfg = CELLS.config(name)
    cfg.update(CELLS.arch(cfg).weights.SMOKE, name=f"{name}-smoke")
    return cfg


def smoke_root(tmp: Path) -> Path:
    """A root with BENCHMARK.json and a copy of ``bench/`` whose cells are
    the committed ones at smoke size (the traffic's ladders and lengths
    cut to match), and the per-layer metrics listing them."""
    root = tmp / "root"
    shutil.copytree(BENCH, root / "bench",
                    ignore=shutil.ignore_patterns("tests", ".cache",
                                                  "__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    rename = {}
    for c in spec["configs"]:
        cfg = smoke_config(c["name"])
        c["name"], c["file"] = cfg["name"], f"bench/configs/{cfg['name']}.json"
        (root / c["file"]).write_text(json.dumps(cfg))
    for w in spec["workloads"]:
        t = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                       .read_text())
        t["ladder"]["lengths"] = [x // 8 for x in t["ladder"]["lengths"]]
        t["lengths"]["min"] = max(1, t["lengths"]["min"] // 8)
        t["lengths"]["max"] //= 8
        if "median" in t["lengths"]:
            t["lengths"]["median"] //= 8
        if t["loop"] == "open":
            t["rate_rps"] = 20.0
        name = w["traffic"] + "-smoke"
        (root / "bench" / "traffic" / f"{name}.json").write_text(
            json.dumps(t))
        old = w["name"]
        w["config"] += "-smoke"
        w["traffic"] = name
        w["name"] = old.replace(".", "-smoke.", 1)
        rename[old] = w["name"]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [rename[x] for x in m["workloads"]]
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root


@pytest.fixture
def root(tmp_path):
    return smoke_root(tmp_path)
