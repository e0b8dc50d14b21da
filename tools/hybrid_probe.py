"""Granite-4.0-H-Micro's served pruned forward on the card, called eagerly:
the mixer readings of the benchmark held against the model's own profiler
ranges, and a planted fault held against the reference.

    python3 tools/hybrid_probe.py [--seed N] [--batch 2] [--length 4096]
        [--out artifacts/hybrid_probe.json]

The benchmark's configuration ``granite-4-h-micro`` at its own size: its
weights from the seed (``bench/archs/granitemoehybrid/weights.py``), every
``shared_mlp`` pruned and planned by ``launch.serve.prune_ffn_blocks``, the
forward of ``launch.serve.make_pruned_forward``, one ``(batch, length)``
matrix of the benchmark's request tokens copied to the card as the server
copies a call's tokens.  After a warm call:

* one call under ``torch.profiler`` with tracing on, so each mixer runs in
  an ``ssd_mixer`` or ``attention`` range: the device time the profiler
  attributes to each kind of range, against ``bench/mixers.py``'s
  segments fenced by the row-split launches in the same capture (the
  segments add each layer's residual adds and norms); the row-split time
  and the call's busy time beside them; for each attention layer and
  the second and last Mamba2 layers, the kernels of the fenced segment
  and those the profiler attributes to the layer's range, summed by
  name and by the operation the profiler attributes them to (a kernel
  launched while the host waited on a full launch queue is attributed to
  its operation and again to a ``Command Buffer Full`` event, so the
  ranges' time is also given with that second count left out);
* the served logits against the reference's (``reference.score``) at the
  configuration's limits, then the same with planted faults: the scan's
  state dropped between chunks (each chunk scanned from a zero state),
  which has to fail them; the whole scan (its summed decay, products,
  outputs and carried state) in bfloat16; the gated norm in bfloat16;
  and the forward computed in float32 (the reference's own precision:
  the algorithm alone).

Prints one JSON line, also written to ``--out``; needs one card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent.parent
CONFIG = "granite-4-h-micro"
RANGES = {"mamba": "ssd_mixer", "attention": "attention"}
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
QUEUE_FULL = "Command Buffer Full"


def _device_ops(prof, devtrace) -> list:
    """The capture's device operations ``(name, t0, t1)`` (ns), read as
    ``bench/devtrace.py`` reads them, less the ranges' own images on the
    device's timeline (which span a range's idle gaps too; the benchmark's
    traced window has tracing off and holds none)."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        if (devtrace._kind(ev) in DEVICE_KINDS
                and ev.name() not in RANGES.values()):
            out.append((ev.name(), ev.start_ns(),
                        ev.start_ns() + ev.duration_ns()))
    return out


def profiler_ms(prof) -> tuple[dict, dict]:
    """Per range name, the device time (ms) the profiler attributes to its
    host ranges (``device_time_total``: the kernels launched inside them),
    and the number of ranges."""
    import torch

    total, count = {}, {}
    for ev in prof.events():
        # the host's ranges, not their images on the device's timeline
        if (ev.name in RANGES.values()
                and ev.device_type == torch.autograd.DeviceType.CPU):
            total[ev.name] = total.get(ev.name, 0.0) + \
                ev.device_time_total / 1e3
            count[ev.name] = count.get(ev.name, 0) + 1
    return total, count


def range_kernels(prof, name: str) -> list:
    """Per host range ``name``, in time order, the kernels the profiler
    attributes to it (those its ``device_time_total`` sums: the range's
    own and its child operations'): ``[(owner, kernel, µs), ...]``."""
    import torch

    rngs = sorted((ev for ev in prof.events() if ev.name == name and
                   ev.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda ev: ev.time_range.start)
    out = []
    for rng in rngs:
        got, todo = [], [rng]
        while todo:
            ev = todo.pop()
            got += [(ev.name, k.name, k.duration) for k in ev.kernels]
            todo += ev.cpu_children
        out.append(got)
    return out


def fence_kernels(tr, layer: int) -> list:
    """The device operations of ``layer``'s fenced segment in a capture of
    one call, from the end of the previous layer's last row-split launch
    to the start of this layer's first: ``(kernel, µs)``."""
    ks = tr.kernels("rowsplit_kernel")
    a, b = ks[3 * layer - 1][2], ks[3 * layer][1]
    return [(n, (t1 - t0) / 1e3) for n, t0, t1 in tr.device
            if t0 >= a and t1 <= b]


def by_name(pairs) -> dict:
    """``(name, µs)`` pairs summed by name: ``{name: [count, µs]}``."""
    out = {}
    for name, us in pairs:
        c = out.setdefault(name[:100], [0, 0.0])
        c[0] += 1
        c[1] += us
    return out


def layer_kernels(prof, tr, kinds: list, kind: str, pick=None) -> list:
    """Per layer of ``kind`` (those in ``pick``, else all but layer 0):
    its fenced segment against the kernels the profiler attributes to its
    range, summed by name; the names whose time differs most, and the
    range's kernels by the operation they are attributed to."""
    layers = [i for i, k in enumerate(kinds) if k == kind]
    out = []
    for layer, ranged in zip(layers, range_kernels(prof, RANGES[kind])):
        if layer == 0 or (pick is not None and layer not in pick):
            continue
        fenced = by_name(fence_kernels(tr, layer))
        attributed = by_name((k, us) for _, k, us in ranged)
        owners = by_name((o, us) for o, _, us in ranged)
        names = set(fenced) | set(attributed)
        diff = sorted(names, key=lambda n: -abs(
            attributed.get(n, [0, 0])[1] - fenced.get(n, [0, 0])[1]))
        out.append({
            "layer": layer,
            "fenced_ms": sum(v[1] for v in fenced.values()) / 1e3,
            "range_ms": sum(v[1] for v in attributed.values()) / 1e3,
            "fenced_n": sum(v[0] for v in fenced.values()),
            "range_n": sum(v[0] for v in attributed.values()),
            "differ": [{"kernel": n, "fenced": fenced.get(n, [0, 0.0]),
                        "range": attributed.get(n, [0, 0.0])}
                       for n in diff[:5]],
            "range_owners": sorted(
                ([o, c, us] for o, (c, us) in owners.items()),
                key=lambda r: -r[2])[:6]})
    return out


def scan_in_bf16(ssm):
    """``ssm.ssd_scan_chunked`` run wholly in bfloat16: its summed decay,
    its products, its outputs and the state it carries between chunks."""
    import torch

    scan = ssm.ssd_scan_chunked
    bf = torch.bfloat16

    def broken(x, dt, a, b, c, *, chunk, mac_dtype=None):
        mac = ssm._mac
        ssm._mac = lambda t, dtype: t.to(dtype)     # no f32 products
        try:
            y, st = scan(x.to(bf), dt.to(bf), a.to(bf), b.to(bf), c.to(bf),
                         chunk=chunk, mac_dtype=bf)
        finally:
            ssm._mac = mac
        return y.float(), st.float()

    return broken


def gate_in_bf16(ssm):
    """``ssm._gate`` with the gated norm computed in bfloat16."""
    import torch
    import torch.nn.functional as F

    def broken(y, z, p, cfg, dtype):
        bf = torch.bfloat16
        g = y.to(bf) * F.silu(z.to(bf))
        g = g * torch.rsqrt(g.pow(2).mean(-1, keepdim=True) + cfg.norm_eps)
        return (g * p["norm"].to(bf)).to(dtype)

    return broken


def drop_inter_chunk(ssm):
    """``ssm.ssd_scan_chunked`` with every chunk scanned from a zero
    state: the state handed between chunks dropped."""
    scan = ssm.ssd_scan_chunked

    def broken(x, dt, a, b, c, *, chunk, mac_dtype=None):
        bs, s, h, p = x.shape
        nc = s // chunk
        y, st = scan(x.reshape(bs * nc, chunk, h, p),
                     dt.reshape(bs * nc, chunk, h), a,
                     b.reshape(bs * nc, chunk, -1),
                     c.reshape(bs * nc, chunk, -1), chunk=chunk,
                     mac_dtype=mac_dtype)
        return y.reshape(bs, s, h, p), st[-bs:]

    return broken


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=2 ** 31 + 333)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--length", type=int, default=4096)
    ap.add_argument("--out", default=str(ROOT / "artifacts" /
                                         "hybrid_probe.json"))
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]

    import numpy as np
    import torch

    import check
    import devtrace
    import harness
    import loadgen
    import mixers
    from repro_torch import obs
    from repro_torch.launch import serve
    from repro_torch.models import ssm

    if not torch.cuda.is_available():
        print("hybrid_probe: torch sees no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cells = harness.Cells(ROOT)
    cfg = cells.config(CONFIG)
    arch = cells.arch(cfg)
    w = arch.weights.make(cfg, args.seed, "cuda")
    mc = arch.system.model_config(cfg)
    params = arch.system.port_params(w)
    t0 = time.perf_counter()
    blocks = serve.prune_ffn_blocks(params, mc, cfg["keep"])
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    fwd = serve.make_pruned_forward(mc)
    mat = np.stack([loadgen.request_tokens(args.seed, i, args.length,
                                           cfg["vocab_size"])
                    for i in range(args.batch)])

    def call(fwd=fwd):
        with torch.inference_mode():
            out = fwd(params, blocks, torch.from_numpy(mat).to("cuda"))
        torch.cuda.synchronize()
        return out

    call()
    t0 = time.perf_counter()
    sound = call()
    eager_s = time.perf_counter() - t0
    obs.enable()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        call()
    obs.disable()
    device = _device_ops(prof, devtrace)
    ranged, counts = profiler_ms(prof)
    tr = devtrace.DeviceTrace(device, [], (min(e[1] for e in device) - 1,
                                           max(e[2] for e in device) + 1))
    win = SimpleNamespace(traced=SimpleNamespace(
        trace=tr, arch=arch, config=cfg, calls=[(args.batch, args.length)]))
    fenced = {kind: mixers.segments_ms(win, kind) for kind in RANGES}
    kinds = arch.counts.layer_kinds(cfg)
    once = {kind: sum(us for got in range_kernels(prof, RANGES[kind])
                      for owner, _, us in got if owner != QUEUE_FULL) / 1e3
            for kind in RANGES}
    mamba = [i for i, k in enumerate(kinds) if k == "mamba"]
    listed = {"attention": layer_kernels(prof, tr, kinds, "attention"),
              "mamba": layer_kernels(prof, tr, kinds, "mamba",
                                     (mamba[1], mamba[-1]))}
    rowsplit = tr.kernels("rowsplit_kernel")
    first = [name for name, *_ in device[:6]]

    prompts = [torch.from_numpy(row).to("cuda") for row in mat]

    def held(out):
        worst = check.Worst()
        arch.reference.score(w, cfg, prompts, on_logits=lambda i, lg:
                             worst.add(out[i], lg))
        return check.verdict(worst, cfg["limits"], missing=0)

    sound_ok, sound_cmp = held(sound)
    del sound
    planted = {}
    for key, attr, make in (
            ("inter_chunk_dropped", "ssd_scan_chunked", drop_inter_chunk),
            ("scan_bf16", "ssd_scan_chunked", scan_in_bf16),
            ("gated_norm_bf16", "_gate", gate_in_bf16)):
        kept = getattr(ssm, attr)
        setattr(ssm, attr, make(ssm))
        try:
            faulty = call()
        finally:
            setattr(ssm, attr, kept)
        ok, cmp = held(faulty)
        planted[key] = {"correct": ok, "compared": cmp}
        del faulty
    f32 = dataclasses.replace(mc, compute_dtype="float32")
    f32_ok, f32_cmp = held(call(serve.make_pruned_forward(f32)))
    result = {
        "card": torch.cuda.get_device_name(0), "seed": args.seed,
        "call": [args.batch, args.length], "plan_s": plan_s,
        "eager_call_s": eager_s, "first_device_ops": first,
        "ranges": counts, "rowsplit_launches": len(rowsplit),
        "ranges_ms": {k: ranged.get(RANGES[k]) for k in RANGES},
        "ranges_once_ms": once,
        "fenced_ms": {k: v[0] if v else None for k, v in fenced.items()},
        "rowsplit_ms": sum(b - a for _, a, b in rowsplit) / 1e6,
        "busy_ms": tr.busy_s() * 1e3,
        "sound": {"correct": sound_ok, "compared": sound_cmp},
        **planted,
        "kernels": listed,
        "float32_compute": {"correct": f32_ok, "compared": f32_cmp},
        "memory_peak_bytes": torch.cuda.max_memory_allocated()}
    line = json.dumps(result)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
