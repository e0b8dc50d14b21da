"""The program's side of the benchmark that every architecture shares:
the online server over a forward, the program's metrics registry, and the
release of its device state.

Each architecture's ``archs/<arch>/system.py`` builds its forward as the
program's launcher builds it and hands it to :func:`serve`.  The files
named ``system.py`` are the only ones of the benchmark that import the
program; the benchmark takes from them the server, its futures' stamps
and its metrics registry.
"""
from __future__ import annotations

import gc

import torch


def serve(forward, state, traffic: dict):
    """The warmed-up, not yet started ``serving.Server`` of
    ``forward(state, tokens)`` over the traffic's bucket ladder, whose
    ``warmup`` captures one CUDA graph a bucket."""
    from repro_torch import serving

    ladder = serving.BucketLadder(lengths=tuple(traffic["ladder"]["lengths"]),
                                  batches=tuple(traffic["ladder"]["batches"]))
    server = serving.Server(forward, state, ladder,
                            queue_depth=traffic["queue_depth"],
                            name="bench")
    return server.warmup()


def counters() -> dict:
    """The program's metrics registry: ``name{label=value,...}`` → the
    count and sum of a histogram, or the value of a counter or gauge."""
    from repro_torch.obs import registry

    out = {}
    for fam in registry.families():
        for child in fam.children():
            key = fam.name + "{" + ",".join(
                f"{k}={v}" for k, v in sorted(child.labels.items())) + "}"
            if fam.kind == "histogram":
                out[key] = {"count": child.count, "sum": child.sum}
            else:
                out[key] = {"value": child.value}
    return out


def release(server) -> None:
    """Stop the server and free the program's device state: its bucket
    programs, its parameters and the plan cache's plans."""
    from repro_torch import engine

    server.stop(timeout=120)
    server.programs.clear()
    server.state = None
    engine.clear_cache()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
