"""No module of the benchmark imports JAX or the JAX package, by top-level
name compared whole (``repro_torch`` begins with ``repro`` and is not
it); only the files named ``system.py`` (``bench/system.py`` and each
``archs/<arch>/system.py``) import the program, and no architecture's
reference imports the program or the benchmark's modules."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
PROGRAM = "repro_torch"


def imported_top_names(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_jax_or_jax_package(path):
    assert not imported_top_names(path) & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in SOURCES
                                  if p.parent != BENCH / "tests"
                                  and p.name != "system.py"],
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_only_system_imports_the_program(path):
    assert PROGRAM not in imported_top_names(path)


REFERENCES = sorted(BENCH.glob("archs/*/reference.py"))
# The benchmark's own modules: ``system`` imports the program, and the
# rest stand between it and the reference.
BENCH_MODULES = ({p.stem for p in BENCH.glob("*.py")}
                 | {p.stem for p in BENCH.glob("archs/*/*.py")})


@pytest.mark.parametrize("path", REFERENCES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_a_reference_imports_no_program(path):
    names = imported_top_names(path)
    assert "torch" in names
    assert not names & ({PROGRAM} | BENCH_MODULES)


def test_whole_name_comparison(tmp_path):
    src = tmp_path / "probe.py"
    src.write_text("import repro_torch.serving\nimport reprox\n")
    assert imported_top_names(src) & FORBIDDEN == set()
    src.write_text("from repro.core import spmm\n")
    assert imported_top_names(src) & FORBIDDEN == {"repro"}


def test_run_refuses_a_loaded_jax_package(monkeypatch):
    import sys

    import harness
    monkeypatch.setitem(sys.modules, "repro_torch_fake", object())
    assert "repro" not in harness.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert "repro" in harness.loaded_forbidden()
