"""Host cost of the pruned Llama-3.2-1B forward and of one SpMM dispatch on
a CUDA card, with tracing off and on, for one or more source trees of the
port.

    python3 tools/host_cost.py                     # this checkout's src/
    python3 tools/host_cost.py --trees A B         # A, B, B, A in one run

Each tree runs in a process of its own (its ``repro_torch`` on the path,
its kernels built from its ``csrc/``): Llama-3.2-1B at full width, random
f32 weights from seed 0, its 16 FFNs pruned to keep 0.25 and planned by
the §5.4 rule (row-split), a 4 x 32 prompt.  It prints one JSON line:

* ``forward_ms``: the warm forward's host ms, each the median of 9
  synchronised calls, tracing off, on, on, off (on only where the tree
  has ``repro_torch.obs.trace``);
* ``dispatch_us``: the host µs of one ``execute_plan`` of layer 0's w1
  plan, the median of 15 windows of 48 unsynchronised calls, off and on in
  turns;
* ``parts_us`` (trees with ``repro_torch.obs.trace``): what tracing adds to a
  dispatch, each part the median µs a call over 15 windows of 480 calls:
  a ``record_function`` range entered and left outside a profiler
  capture, the ``plan_execute_total`` increment with its label formatted
  and looked up, the same increment on the bound child, and the whole
  ``dispatch`` record (bound increment and event).

With ``--trees`` the processes run in the order A, B, B, A and a summary
line follows.  Needs one card; the card's name and power limit are
printed with the results.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
DEFAULT_SRC = os.path.join(HERE, "..", "src")
KEEP, BATCH, PROMPT, SEED = 0.25, 4, 32, 0


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def per_call_us(fn, calls: int, windows: int = 15) -> float:
    out = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out.append((time.perf_counter() - t0) / calls * 1e6)
    return statistics.median(out)


def measure(src: str) -> dict:
    """The measurements of one tree (run in a process of its own)."""
    sys.path.insert(0, os.path.abspath(src))
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import execute_plan
    from repro_torch.kernels import _cuda
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    try:            # a tree from before the port's tracing has no trace
        from repro_torch.obs import trace as obs
    except ImportError:
        obs = None
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _cuda.build()
    build_s = time.perf_counter() - t0
    cfg = get_config("llama3.2-1b")
    params = M.init_params(cfg, SEED, dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=g,
                           device=dev)
    blocks = serve.prune_ffn_blocks(params, cfg, KEEP)
    fwd = serve.make_pruned_forward(cfg)

    def forward():
        with torch.no_grad():
            fwd(params, blocks, prompt)

    def forward_ms(reps: int = 9) -> float:
        forward()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            forward()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    host = {"off": [], "on": []}
    for mode in ("off", "on", "on", "off"):
        if mode == "off":
            host["off"].append(forward_ms())
        elif obs is not None:
            with obs.tracing():
                host["on"].append(forward_ms())

    sl = blocks[0]["mlp"]["w1"]
    plans = 3 * cfg.num_layers
    b = torch.randn(sl.weight.k, BATCH * PROMPT, device=dev)

    def window_us():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(plans):
            execute_plan(sl.plan, sl.weight.vals, b)
        us = (time.perf_counter() - t0) / plans * 1e6
        torch.cuda.synchronize()
        return us

    calls = {"off": [], "on": []}
    with torch.no_grad():
        window_us()
        for _ in range(15):
            calls["off"].append(window_us())
            if obs is not None:
                with obs.tracing():
                    calls["on"].append(window_us())
    out = dict(src=os.path.abspath(src), card=card_line(),
               build_s=build_s, methods=sorted({
                   blk["mlp"][w].plan.meta.method for blk in blocks
                   for w in ("w1", "w3", "w2")}),
               forward_ms=host,
               dispatch_us={k: statistics.median(v)
                            for k, v in calls.items() if v})
    if obs is not None:
        import importlib

        from repro_torch.core import ExecutionConfig
        S = importlib.import_module("repro_torch.core.spmm")
        meta = sl.plan.meta
        exe = S._resolve_exec("execute_plan", meta.m, sl.weight.vals, b,
                              ExecutionConfig(), None, None)

        def range_outside_capture():
            with torch.profiler.record_function("spmm_rowsplit_cuda"):
                pass

        def unbound_inc():
            S._plan_execute.labels(plan=S._plan_label(meta),
                                   impl=exe.impl).inc()

        def bound_inc():
            S._execute_counter(meta, exe.impl).inc()

        def dispatch_record():
            S._record_dispatch(meta, b, exe)

        parts = {}
        with obs.tracing(capacity=1024):
            for name, fn in (("record_function", range_outside_capture),
                             ("counter_unbound", unbound_inc),
                             ("counter_bound", bound_inc),
                             ("dispatch_record", dispatch_record)):
                parts[name] = per_call_us(fn, calls=480)
        out["parts_us"] = parts
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=DEFAULT_SRC,
                    help="the source root holding repro_torch (one tree)")
    ap.add_argument("--trees", nargs=2, metavar=("A", "B"),
                    help="two source roots, run A, B, B, A")
    args = ap.parse_args(argv)
    if args.trees is None:
        import torch
        if not torch.cuda.is_available():
            print("host_cost: torch sees no CUDA device", file=sys.stderr)
            return 1
        print(json.dumps(measure(args.src)), flush=True)
        return 0
    runs = []
    for src in (args.trees[0], args.trees[1], args.trees[1],
                args.trees[0]):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--src", src],
            capture_output=True, text=True, timeout=900)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode:
            print(f"host_cost: {src} exited {proc.returncode}",
                  file=sys.stderr)
            return proc.returncode
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    summary = {}
    for tag, src in zip("AB", args.trees):
        mine = [r for r in runs if r["src"] == os.path.abspath(src)]
        summary[tag] = dict(
            src=os.path.abspath(src),
            forward_off_ms=[x for r in mine for x in r["forward_ms"]["off"]],
            forward_on_ms=[x for r in mine for x in r["forward_ms"]["on"]],
            dispatch_off_us=[r["dispatch_us"]["off"] for r in mine],
            dispatch_on_us=[r["dispatch_us"].get("on") for r in mine])
    print(json.dumps(dict(order="A, B, B, A", card=runs[0]["card"],
                          **summary)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
