"""The port stands alone: nothing under src/repro_torch/, nor
chip_smoke.py, imports JAX or the JAX package ``repro``, nor ``msgpack``
or ``zstandard``: the port runs on hosts without them."""
import ast
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
PORT = os.path.join(ROOT, "src", "repro_torch")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, dirnames, filenames in os.walk(PORT):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        out += [os.path.join(dirpath, f) for f in sorted(filenames)
                if f.endswith(".py")]
    return sorted(out)


def _imported_modules(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", None)) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


# The JAX package, and what the port runs without (the reference's
# checkpoint index is msgpack + zstandard; the port's is JSON + zlib).
FORBIDDEN = ("jax", "jaxlib", "repro", "msgpack", "zstandard")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


def test_port_files_exist():
    files = _port_files()
    assert len(files) > 15, files


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_import(path):
    bad = sorted({m for m in _imported_modules(path) if _forbidden(m)})
    assert not bad, f"{path} imports {bad}"


def test_importing_the_port_leaves_jax_out():
    code = ("import sys, repro_torch.launch.serve, repro_torch.convert,"
            " repro_torch.runtime.steps, repro_torch.models.moe,"
            " repro_torch.kernels.moe_gemm,"
            " repro_torch.kernels.flash_attention, repro_torch.tune,"
            " repro_torch.tune.cli, repro_torch.matrices,"
            " repro_torch.launch.train, repro_torch.optim,"
            " repro_torch.checkpoint, repro_torch.data,"
            " repro_torch.distributed.spmm, repro_torch.launch.mesh,"
            " repro_torch.core.partition;"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r});"
            "print(bad); raise SystemExit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src")]
        + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env)
    assert out.returncode == 0, out.stdout + out.stderr
