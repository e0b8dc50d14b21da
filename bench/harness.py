"""One run of one cell: the benchmark's measurement, driven by data.

``BENCHMARK.json`` names the cell; the cell names its configuration
(``bench/configs/<config>.json``) and its traffic mix
(``bench/traffic/<traffic>.json``); each per-layer metric is a reader
``bench/metrics/<metric>.py`` with ``read(window) -> float | None``.  A
configuration names its architecture under ``"arch"``, ``dense`` where
the key is absent: the code in ``bench/archs/<arch>/`` that makes its
weights (``weights.py``), scores it plainly (``reference.py``), builds the
program over it (``system.py``) and counts its operations
(``counts.py``).  A later cell, mix, metric or architecture is new files
and new entries, never an edit.

A run: weights from the seed on the device, the program built and warmed
up (set-up), one window of traffic with tracing off, whose answers are
compared and whose readings give the end-to-end metrics (``--trace 0``)
or the per-layer metrics read from the program's counters and the host's
clock (``--trace 1``); with ``--trace 1`` a second window of the same
traffic, of at most ``TRACE_SECONDS``, follows under the profiler,
recording the card's operations alone, for the metrics read from the
device trace.  Then the peak memory is read, the program freed, and the
sampled answers compared with the reference.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import re
import sys
import time
from collections.abc import Callable
from pathlib import Path
from types import ModuleType

import numpy as np
import torch

import check
import devtrace
import loadgen
import system

DRAIN_S = 60.0
# The traced window's length at most: the profiler's stop and read take
# ~32 µs a device operation, and the online cell runs ~90,000 a second.
TRACE_SECONDS = 20.0
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")
DEFAULT_ARCH = "dense"


def loaded_forbidden() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX or the
    JAX package (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load(path: Path, name: str) -> ModuleType:
    """The module at ``path`` under ``name``, kept in ``sys.modules`` (a
    dataclass looks its module up there) and loaded anew where the name
    holds another file."""
    mod = sys.modules.get(name)
    if mod is not None and getattr(mod, "__file__", None) == str(path):
        return mod
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _module_name(kind: str, name: str) -> str:
    return f"bench_{kind}_" + name.replace(".", "_").replace("-", "_")


@dataclasses.dataclass(frozen=True)
class Arch:
    """A configuration's architecture: ``weights.make(cfg, seed, device)``
    and ``weights.SMOKE``; ``reference.score(w, cfg, prompts, *,
    control=False, on_logits=None)``, plain float32 torch that imports
    nothing of the program; ``system.build(cfg, w, traffic)``, the warmed
    server; ``counts.request_flops(cfg, length)`` and
    ``counts.spmm_launches(cfg)``, the ``(m, k, nnz)`` of every row-split
    launch of one forward in launch order."""

    weights: ModuleType
    reference: ModuleType
    system: ModuleType
    counts: ModuleType

    @classmethod
    def load(cls, bench: Path, name: str) -> Arch:
        """The architecture ``name`` from ``bench/archs/<name>/``, its
        modules under names of its own."""
        where = bench / "archs" / name
        if not where.is_dir():
            raise SystemExit(f"no architecture {name!r}: {where} is not a "
                             "directory")
        parts = ("weights", "reference", "system", "counts")
        return cls(*(load(where / f"{p}.py",
                          _module_name("arch", f"{name}_{p}"))
                     for p in parts))


@dataclasses.dataclass
class Cells:
    """``BENCHMARK.json`` and the files its names lead to."""

    root: Path

    def __post_init__(self):
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self.bench = self.root / "bench"

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; known: "
                         f"{[w['name'] for w in self.spec['workloads']]}")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise SystemExit(f"no config {name!r} in BENCHMARK.json")

    def arch(self, cfg: dict) -> Arch:
        """The architecture a configuration names, ``dense`` where it
        names none."""
        return Arch.load(self.bench, cfg.get("arch", DEFAULT_ARCH))

    def traffic(self, name: str) -> dict:
        return json.loads((self.bench / "traffic" / f"{name}.json")
                          .read_text())

    def metrics(self, cell: str, per_layer: bool) -> list[dict]:
        """The metrics a cell reports: an entry with ``workloads`` in the
        cells it lists; a per-layer one without, in every cell that
        reports the end-to-end metric it moves."""
        e2e = [m for m in self.spec["end_to_end"]
               if cell in m.get("workloads", [cell])]
        if not per_layer:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.spec["per_layer"]
                if cell in m.get("workloads", [cell] if m["moves"] in names
                                 else [])]

    def reader(self, metric: str) -> Callable:
        return load(self.bench / "metrics" / f"{metric}.py",
                    _module_name("metric", metric)).read


@dataclasses.dataclass
class Window:
    """What one measured window saw, for the metric readers."""

    cell: dict
    config: dict
    arch: Arch
    traffic: dict
    outcomes: list
    t_open: float
    t_close: float
    counters_open: dict
    counters_close: dict
    calls: list                 # (batch, length) of each program call
    # The window's end: t_close, or in a closed loop the first result at
    # or after it.
    t_end: float = 0.0
    trace: devtrace.DeviceTrace | None = None
    traced: Window | None = None    # the traced window of a --trace 1 run

    @property
    def seconds(self) -> float:
        return self.t_end - self.t_open

    def completed(self) -> list:
        return loadgen.completed_in_window(self.outcomes, self.t_open,
                                           self.t_end)

    def counter_delta(self, key: str) -> dict:
        """A program counter's change over the window."""
        a = self.counters_open.get(key, {})
        b = self.counters_close.get(key, {})
        return {k: v - a.get(k, 0) for k, v in b.items()}


def end_to_end(win: Window, name: str, setup_s: float) -> float:
    if name == "setup_s":
        return setup_s
    if name == "tokens_per_s":
        return sum(o.length for o in win.completed()) / win.seconds
    tail = re.fullmatch(r"latency_p(\d+)_ms", name)
    if tail:
        q = int(tail.group(1)) / 100
        return 1e3 * loadgen.latency_quantile(win.outcomes, q,
                                              time.perf_counter())
    raise KeyError(f"no end-to-end metric {name!r} in the harness")


def sample(traffic: dict, tape, seed: int) -> list:
    """The requests whose answers are compared: ``check.sample`` drawn
    from the seed among the candidates, with one of the longest."""
    n = traffic["check"]["sample"]
    if traffic["loop"] == "open":
        cands = tape
    else:
        cands = [tape[i] for i in range(traffic["check"]["within"])]
    rng = np.random.default_rng([seed % (1 << 63), 3])
    longest = max(cands, key=lambda r: (r.length, -r.index))
    picked = rng.choice(len(cands), size=min(n, len(cands)), replace=False)
    out = {cands[i].index: cands[i] for i in picked}
    out[longest.index] = longest
    return sorted(out.values(), key=lambda r: r.index)


def _log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def measure(server, cell: dict, cfg: dict, arch: Arch, traffic: dict,
            tape, *, seed: int, seconds: float, device: str,
            keep: frozenset = frozenset(), trace: bool = False):
    """One window of the cell's traffic on the started server; returns the
    :class:`Window` and its client.  With ``trace`` the window runs under a
    capture of the card's operations."""
    client = loadgen.Client(server, vocab=cfg["vocab_size"], seed=seed,
                            keep=keep, spans=trace)
    with (devtrace.capture(device == "cuda") if trace
          else contextlib.nullcontext()) as cap:
        if trace:
            cap.mark()
        f0 = server.forwards
        c_open = system.counters()
        if traffic["loop"] == "open":
            client.run_open(tape, seconds)
        else:
            client.run_closed(tape, traffic["clients"], seconds)
        c_close = system.counters()
        drained = client.drain(DRAIN_S)
        _sync(device)
        calls = list(server.ran)[len(server.ran) - (server.forwards - f0):]
        t_stop = time.perf_counter()
    t_end = (client.t_close if traffic["loop"] == "open" else
             loadgen.closed_window_end(client.outcomes, client.t_close))
    win = Window(cell, cfg, arch, traffic, client.outcomes, client.t_open,
                 client.t_close, c_open, c_close, calls, t_end)
    if trace:
        win.trace = cap.trace(client.t_open, t_end, client.spans)
        _log(f"profiler stopped in {cap.stop_s:.3f} s, its "
             f"{len(cap.device)} device operations read in "
             f"{time.perf_counter() - t_stop - cap.stop_s:.3f} s")
    _log(f"{cell['name']}: {'traced' if trace else 'untraced'} window "
         f"{win.seconds:.3f} s, {len(win.outcomes)} requests, "
         f"{len(calls)} program calls, generator late by at most "
         f"{client.late_s * 1e3:.3f} ms, all resolved: {drained}")
    return win, client


def run_cell(cells: Cells, name: str, *, seed: int, seconds: float,
             trace: bool, device: str, t_start: float,
             build: Callable | None = None) -> dict:
    """One run; returns the result line's object (``compared`` last).
    ``build`` stands in for the architecture's ``system.build``."""
    cell = cells.workload(name)
    cfg = cells.config(cell["config"])
    arch = cells.arch(cfg)
    traffic = cells.traffic(cell["traffic"])
    t0 = time.perf_counter()
    w = arch.weights.make(cfg, seed, device)
    _sync(device)
    t1 = time.perf_counter()
    server = (build or arch.system.build)(cfg, w, traffic)
    del w
    _log(f"{name}: process start to weights {t0 - t_start:.3f} s, weights "
         f"{t1 - t0:.3f} s, pruning, planning and warmup "
         f"{time.perf_counter() - t1:.3f} s")
    if traffic["loop"] == "open":
        tape = loadgen.open_tape(traffic, seconds, seed)
    else:
        tape = loadgen.ClosedTape(traffic, seed)
    picked = sample(traffic, tape, seed)
    _sync(device)
    server.start()
    setup_s = time.perf_counter() - t_start
    _log(f"{name}: set-up {setup_s:.3f} s")
    win, client = measure(server, cell, cfg, arch, traffic, tape,
                          seed=seed, seconds=seconds, device=device,
                          keep=frozenset(r.index for r in picked))
    outcomes = list(win.outcomes)
    if trace:
        traced_s = min(seconds, TRACE_SECONDS)
        if traffic["loop"] == "open":
            tape = loadgen.open_tape(traffic, traced_s, seed)
        else:
            tape = loadgen.ClosedTape(traffic, seed)
        win.traced, _ = measure(server, cell, cfg, arch, traffic, tape,
                                seed=seed, seconds=traced_s,
                                device=device, trace=True)
        outcomes += win.traced.outcomes
    mem = (torch.cuda.max_memory_allocated() if device == "cuda" else 0)
    metrics = {}
    for m in cells.metrics(name, per_layer=trace):
        if trace:
            value = cells.reader(m["name"])(win)
        else:
            value = end_to_end(win, m["name"], setup_s)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    kept = {o.index: o.output.cpu() for o in client.outcomes
            if o.output is not None}
    attempted = len(win.outcomes)
    failed = sum(1 for o in win.outcomes if not o.ok)
    # Never answered, or failed in execution (a shed is a refusal, counted
    # in ``failed`` alone), in either window; with the sampled requests
    # left unanswered.
    def unanswered(outs) -> set:
        return {o.index for o in outs
                if o.done is None or (not o.ok and o.error != "RequestShed")}

    lost = len(unanswered(client.outcomes)
               | {r.index for r in picked if r.index not in kept})
    if trace:
        lost += len(unanswered(win.traced.outcomes))
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else "cpu"),
           "count": 1, "memory_peak_bytes": mem}
    breakdown = None
    if trace:
        tr = win.traced.trace
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        breakdown = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    for o in outcomes:
        o.output = o.batch = None
    system.release(server)
    del server, client, win, outcomes
    gc.collect()
    correct, compared = compare(arch, cfg, seed, device, picked, kept,
                                missing=lost)
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["compared"] = compared
    return out


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def compare(arch: Arch, cfg: dict, seed: int, device: str, picked: list,
            served: dict, *, missing: int) -> tuple[bool, dict]:
    """Score the picked requests with the architecture's reference
    (weights made again from the seed) and hold the served logits against
    its own; ``missing`` requests went unanswered."""
    w = arch.weights.make(cfg, seed, device)
    answered = [r for r in picked if r.index in served]
    prompts = [torch.from_numpy(loadgen.request_tokens(
        seed, r.index, r.length, cfg["vocab_size"])).to(device)
        for r in answered]
    worst = check.Worst()
    arch.reference.score(w, cfg, prompts, on_logits=lambda i, logits:
                         worst.add(served[answered[i].index], logits))
    del w
    return check.verdict(worst, cfg["limits"], missing=missing)
