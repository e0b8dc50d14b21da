"""Reductions shared by the per-layer metric readers in ``metrics/``.

Each takes the measured :class:`harness.Window` and returns the metric,
or None where the window holds nothing to read it from.  The program's
counters and the host's clock are read from the untraced window, at the
load the end-to-end metrics see; the device trace from the traced window
that follows it (``win.traced``).
"""
from __future__ import annotations

import counts

ROWSPLIT_KERNEL = "rowsplit_kernel"


def queue_wait_ms(win) -> float | None:
    """Mean queue wait of the requests dequeued in the window: the change
    of the program's ``serve_request_latency_us{phase=queue_wait}`` sum
    over the change of its count."""
    d = win.counter_delta("serve_request_latency_us{phase=queue_wait}")
    if not d.get("count"):
        return None
    return d["sum"] / d["count"] / 1e3


def pad_share(win) -> float | None:
    """Padded token slots over all slots (%) of the bucket calls whose
    requests completed in the window, from each request's bucket and
    length."""
    calls = {}
    for o in win.completed():
        if o.bucket is None or o.batch is None:
            continue
        b, l = o.bucket
        slots, used = calls.get(id(o.batch), (b * l, 0))
        calls[id(o.batch)] = (slots, used + o.length)
    if not calls:
        return None
    slots = sum(s for s, _ in calls.values())
    used = sum(u for _, u in calls.values())
    return 100.0 * (1.0 - used / slots)


def step_mfu(win) -> float | None:
    """Model FLOPs of the prompts completed in the window over the window
    at the card's bf16 peak (%)."""
    done = win.completed()
    if not done:
        return None
    flops = sum(win.arch.counts.request_flops(win.config, o.length)
                for o in done)
    return 100.0 * flops / (win.seconds * counts.PEAK_BF16_FLOPS)


def step_mfu_busy(win) -> float | None:
    """Model FLOPs of the prompts completed in the traced window over the
    card's busy time there at its bf16 peak (%): the steps' own share of
    the peak, whatever the offered rate."""
    t = win.traced
    if t is None or t.trace is None:
        return None
    done = t.completed()
    busy = t.trace.busy_s()
    if not done or busy <= 0:
        return None
    flops = sum(t.arch.counts.request_flops(t.config, o.length)
                for o in done)
    return 100.0 * flops / (busy * counts.PEAK_BF16_FLOPS)


def rowsplit_roofline(win) -> float | None:
    """Σ bound over Σ device time (%) of the row-split launches of the
    program calls that ran wholly inside the traced window.  A call
    launches the architecture's ``spmm_launches``; where the capture holds
    another count of them, there is nothing to read."""
    if win.traced is None or win.traced.trace is None:
        return None
    win = win.traced
    tr = win.trace
    ks = tr.kernels(ROWSPLIT_KERNEL)
    launches = win.arch.counts.spmm_launches(win.config)
    per_call = len(launches)
    if not ks or len(ks) != per_call * len(win.calls):
        return None
    w0, w1 = tr.window
    bound = busy = 0.0
    for i, (b, l) in enumerate(win.calls):
        grp = ks[i * per_call:(i + 1) * per_call]
        if grp[0][1] < w0 or grp[-1][2] > w1:
            continue
        bound += counts.forward_spmm_bound_s(launches, b * l)
        busy += sum(t1 - t0 for _, t0, t1 in grp) / 1e9
    return 100.0 * bound / busy if busy > 0 else None


def idle_share(win) -> float | None:
    """The share (%) of the traced window with no operation on the card."""
    if win.traced is None or win.traced.trace is None:
        return None
    tr = win.traced.trace
    if tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
