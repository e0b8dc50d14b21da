"""Reductions of the server's own phase clock and call timer, shared by
the per-layer metric readers in ``metrics/``.

The program's batcher times each stretch of its wall time under one
phase of ``serve_batcher_us`` and each served bucket call's device time
in ``serve_call_device_us{batch,length}``; a request's wait from its
dequeue to its call is ``serve_request_latency_us{phase=batch_wait}``.
Each reduction takes the measured :class:`harness.Window` and reads the
change of those counters over the untraced window, at the load the
end-to-end metrics see; a share is taken over ``t_close - t_open``, the
span between the two counter reads.  Where the program keeps no such
counter, or the window holds nothing, it returns None.
"""
from __future__ import annotations

import counts
import loadgen

# The batcher's phases outside a call's launch and sync: the card idle
# while the server held requests.
HOST_PHASES = ("window", "assemble", "resolve")
DEVICE_KEY = "serve_call_device_us{"


def _span_s(win) -> float:
    return win.t_close - win.t_open


def host_gap_share(win) -> float | None:
    """Σ of ``serve_batcher_us`` over the window, assemble and resolve
    phases, over the window (%)."""
    keys = [f"serve_batcher_us{{phase={p}}}" for p in HOST_PHASES]
    if not any(k in win.counters_close for k in keys) or _span_s(win) <= 0:
        return None
    us = sum(win.counter_delta(k).get("sum", 0.0) for k in keys)
    return 100.0 * us / 1e6 / _span_s(win)


def batch_wait_ms(win) -> float | None:
    """Mean wait of the requests served in the window from their dequeue
    to the start of their bucket call."""
    d = win.counter_delta("serve_request_latency_us{phase=batch_wait}")
    if not d.get("count"):
        return None
    return d["sum"] / d["count"] / 1e3


def call_device_s(win) -> float | None:
    """Σ device time of the bucket calls served in the window (s)."""
    keys = [k for k in win.counters_close if k.startswith(DEVICE_KEY)]
    if not keys:
        return None
    return sum(win.counter_delta(k).get("sum", 0.0) for k in keys) / 1e6


def call_device_share(win) -> float | None:
    """:func:`call_device_s` over the window (%)."""
    dev = call_device_s(win)
    if dev is None or _span_s(win) <= 0:
        return None
    return 100.0 * dev / _span_s(win)


def step_mfu_calls(win) -> float | None:
    """Model FLOPs of the prompts answered in the window (no padding) over
    the calls' device time there at the card's bf16 peak (%)."""
    dev = call_device_s(win)
    done = loadgen.completed_in_window(win.outcomes, win.t_open, win.t_close)
    if not dev or not done:
        return None
    flops = sum(win.arch.counts.request_flops(win.config, o.length)
                for o in done)
    return 100.0 * flops / (dev * counts.PEAK_BF16_FLOPS)
