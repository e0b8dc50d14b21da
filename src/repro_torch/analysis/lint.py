"""AST lint of the port: the call-site disciplines review keeps enforcing.

The port's own copy of the reference's ``repro.analysis.lint`` rules that
apply to it (suppress a line with ``# noqa: RLxxx`` or a bare ``# noqa``):

* **RL001** -- no host-sync calls (``.item()``, ``.cpu()``,
  ``.tolist()``, ``np.asarray``/``np.array``, ``float(...)`` of a
  non-literal) where the device cannot wait for the host.  On the port
  that is the body of a ``with torch.cuda.graph(...)`` block: a sync
  there breaks the capture (``engine.programs.GraphProgram``,
  ``tune.timing``).  The reference's own scope, functions decorated with
  ``jit``/``custom_vjp``/``custom_vmap`` (directly or through
  ``functools.partial``), registered via ``X.defvjp(...)``/
  ``X.def_vmap(...)``, or Pallas kernel bodies (calls of
  ``pl.program_id``/``pl.when``/``pl.load``/``pl.store``), is kept as it
  states it, for a JAX-style module handed to ``lint``; the port's
  PyTorch modules hold none of those markers.
* **RL002** -- no legacy pre-v1 kwargs at call sites of ``spmm``/
  ``execute_plan``/``get_plan``: the v1 spelling folds
  them into ``PlanPolicy``/``ExecutionConfig`` (tests of the deprecation
  shims, ``tests/test_api.py``, are exempt).
* **RL003** -- every ``MethodSpec(...)`` registration supplies the
  complete hook set as keywords, so no method is stranded outside the
  tuner, heuristic and audit machinery.

The reference's RL004-RL006 concern its ``benchmarks/`` and ``Makefile``
and stay with its lint.  The default roots are the port's files:
``src/repro_torch``, ``chip_smoke.py`` and ``tests/test_torch_*.py``.
``run_lint(paths)`` returns ``Diagnostic`` rows with ``file:line``
locations; ``python -m repro_torch.analysis lint`` exits non-zero on any
finding.
"""
from __future__ import annotations

import ast
import glob
import os
import re
from collections.abc import Iterable

from .diagnostics import Diagnostic

_JIT_MARKERS = {"jit", "custom_vjp", "custom_vmap", "pallas_call"}
_KERNEL_MARKERS = {"program_id", "when", "load", "store"}
_NP_ALIASES = {"np", "numpy", "onp"}
_HOST_SYNC_NP = {"asarray", "array"}
_HOST_SYNC_METHODS = {"item", "cpu", "tolist"}

#: first-party entry point -> pre-v1 kwargs that fold into
#: PlanPolicy/ExecutionConfig (see core/spmm.py, engine/cache.py).
LEGACY_KWARGS = {
    "spmm": {"method", "l_pad", "t", "heuristic", "impl", "tk"},
    "execute_plan": {"impl", "tk"},
    "get_plan": {"method", "heuristic", "t", "tl", "l_pad",
                 "with_transpose", "tunedb"},
}

#: the complete MethodSpec hook set (kernels/registry.py) — RL003.
METHODSPEC_FIELDS = {
    "name", "description", "build_structure", "execute", "inline",
    "resolve_params", "tune_candidates", "heuristic_rank", "traffic",
}

_NOQA_RE = re.compile(r"#\s*noqa(?::\s*(?P<codes>[A-Z0-9, ]+))?",
                      re.IGNORECASE)


def _suppressed(lines: list[str], lineno: int, code: str) -> bool:
    if not 1 <= lineno <= len(lines):
        return False
    m = _NOQA_RE.search(lines[lineno - 1])
    if not m:
        return False
    codes = m.group("codes")
    if codes is None:
        return True
    return code in {c.strip().upper() for c in codes.split(",")}


def _dotted_names(node: ast.AST) -> Iterable[str]:
    """Every Name id / Attribute attr under ``node`` (decorator scan)."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name):
            yield sub.id
        elif isinstance(sub, ast.Attribute):
            yield sub.attr


def _call_name(call: ast.Call) -> str | None:
    """The final identifier of the called object (``f`` / ``mod.f``)."""
    f = call.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


def _defvjp_targets(tree: ast.Module) -> set[str]:
    """Function names registered through ``X.defvjp(f, g)`` / def_vmap."""
    out: set[str] = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("defvjp", "def_vmap")):
            for arg in node.args:
                if isinstance(arg, ast.Name):
                    out.add(arg.id)
    return out


def _is_jit_reachable(fn: ast.FunctionDef, vjp_targets: set[str]) -> bool:
    if fn.name in vjp_targets:
        return True
    for dec in fn.decorator_list:
        if _JIT_MARKERS.intersection(_dotted_names(dec)):
            return True
    for node in ast.walk(fn):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "pl"
                and node.func.attr in _KERNEL_MARKERS):
            return True
    return False


def _check_host_sync(node: ast.AST, scope: str, path: str, lines,
                     diags: list) -> None:
    """RL001 over the calls under ``node``; ``scope`` names it."""
    for call in ast.walk(node):
        if not isinstance(call, ast.Call):
            continue
        where = f"{path}:{call.lineno}"
        f = call.func
        if isinstance(f, ast.Attribute) and f.attr in _HOST_SYNC_METHODS \
                and not call.args:
            msg = (f"host sync `.{f.attr}()` inside {scope} — return the "
                   "tensor, or read it before the capture")
        elif (isinstance(f, ast.Attribute)
              and f.attr in _HOST_SYNC_NP
              and isinstance(f.value, ast.Name)
              and f.value.id in _NP_ALIASES):
            msg = (f"`{f.value.id}.{f.attr}(...)` inside {scope} pulls a "
                   "device value to host — hoist it to plan build time")
        elif (isinstance(f, ast.Name) and f.id == "float" and call.args
              and not isinstance(call.args[0], ast.Constant)):
            msg = (f"`float(...)` on a non-literal inside {scope} forces "
                   "a device sync")
        else:
            continue
        if not _suppressed(lines, call.lineno, "RL001"):
            diags.append(Diagnostic("RL001", where, msg))


def _is_graph_capture(node: ast.With) -> bool:
    """``with torch.cuda.graph(g):`` (any spelling ending in ``graph``)."""
    return any(isinstance(it.context_expr, ast.Call)
               and _call_name(it.context_expr) == "graph"
               for it in node.items)


def _check_legacy_kwargs(tree, path: str, lines, diags: list) -> None:
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = _call_name(node)
        legacy = LEGACY_KWARGS.get(name or "")
        if not legacy:
            continue
        used = sorted(kw.arg for kw in node.keywords
                      if kw.arg in legacy)
        if used and not _suppressed(lines, node.lineno, "RL002"):
            diags.append(Diagnostic(
                "RL002", f"{path}:{node.lineno}",
                f"legacy pre-v1 kwargs {used} on `{name}` — fold into "
                "PlanPolicy/ExecutionConfig (README: Migrating to API "
                "v1)"))


def _check_methodspec(tree, path: str, lines, diags: list) -> None:
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        if _call_name(node) != "MethodSpec":
            continue
        if _suppressed(lines, node.lineno, "RL003"):
            continue
        where = f"{path}:{node.lineno}"
        if node.args:
            diags.append(Diagnostic(
                "RL003", where,
                "MethodSpec must be constructed with keywords only, so "
                "the full hook set is auditable"))
            continue
        given = {kw.arg for kw in node.keywords if kw.arg}
        missing = sorted(METHODSPEC_FIELDS - given)
        if missing:
            diags.append(Diagnostic(
                "RL003", where,
                f"MethodSpec registration missing hooks {missing} — "
                "every method supplies the complete set (explicit None "
                "is fine) so tuner/heuristic/audit coverage is total"))


def lint_file(path: str, *, rules=("RL001", "RL002", "RL003"),
              _exempt_legacy=("tests/test_api.py",)) -> list[Diagnostic]:
    with open(path, encoding="utf-8") as f:
        src = f.read()
    lines = src.splitlines()
    try:
        tree = ast.parse(src, path)
    except SyntaxError as e:
        return [Diagnostic("RL000", f"{path}:{e.lineno or 1}",
                           f"does not parse: {e.msg}")]
    diags: list[Diagnostic] = []
    if "RL001" in rules:
        vjp_targets = _defvjp_targets(tree)
        for node in ast.walk(tree):
            if isinstance(node, ast.FunctionDef) and \
                    _is_jit_reachable(node, vjp_targets):
                _check_host_sync(node, f"jit-reachable `{node.name}`",
                                 path, lines, diags)
            elif isinstance(node, ast.With) and _is_graph_capture(node):
                for stmt in node.body:
                    _check_host_sync(stmt, "a CUDA graph capture", path,
                                     lines, diags)
    norm = path.replace(os.sep, "/")
    if "RL002" in rules and not any(norm.endswith(e)
                                    for e in _exempt_legacy):
        _check_legacy_kwargs(tree, path, lines, diags)
    if "RL003" in rules:
        _check_methodspec(tree, path, lines, diags)
    return diags


def default_roots(repo_root: str) -> list[str]:
    """``src/repro_torch``, ``chip_smoke.py`` and ``tests/test_torch_*.py``
    under the repo root (those that exist)."""
    roots = [os.path.join(repo_root, rel)
             for rel in (os.path.join("src", "repro_torch"), "chip_smoke.py")]
    roots = [p for p in roots if os.path.exists(p)]
    roots += sorted(glob.glob(os.path.join(repo_root, "tests",
                                           "test_torch_*.py")))
    return roots


def _py_files(paths: Iterable[str]) -> list[str]:
    out = []
    for p in paths:
        if os.path.isfile(p):
            out.append(p)
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = [d for d in dirnames
                           if d not in ("__pycache__", ".git", "build")]
            out.extend(os.path.join(dirpath, f)
                       for f in sorted(filenames) if f.endswith(".py"))
    return sorted(out)


def run_lint(paths: Iterable[str] | None = None, *,
             repo_root: str | None = None) -> list[Diagnostic]:
    """Lint ``paths`` (default: :func:`default_roots` of the repo root);
    returns diagnostics."""
    if repo_root is None:
        repo_root = os.getcwd()
    targets = list(paths) if paths else default_roots(repo_root)
    diags: list[Diagnostic] = []
    for path in _py_files(targets):
        diags.extend(lint_file(path))
    return diags
