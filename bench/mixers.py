"""Device time of a hybrid model's mixers, read from the traced window by
fencing each layer with its row-split launches.

A layer's mixer runs before its three FFN launches (w1, w3, w2), so its
segment of a program call is the device operations between the end of
the previous layer's w2 launch and the start of this layer's w1 launch;
layer 0's segment starts at the call's start, the end of the last
host-to-device copy (the call's tokens) after the previous call's
launches.  A segment holds the mixer, the residual add and norm before it
and the norm after it.  The row-split launches are found as
``readers.rowsplit_roofline`` finds them, and the layer kinds come from
the architecture's ``counts.layer_kinds``.  Where the architecture names
no kinds, or the capture holds another count of launches, there is
nothing to read.
"""
from __future__ import annotations

import bisect

import readers

TOKENS_COPY = "HtoD"


def _busy_ns(ops: list, starts: list, a: int, b: int) -> int:
    """The union of the device operations' intervals inside ``[a, b]``;
    ``ops`` sorted by start, ``starts`` their starts."""
    busy, reach = 0, a
    lo = bisect.bisect_left(starts, a)
    # an operation that began before a may still run into [a, b]
    while lo > 0 and ops[lo - 1][2] > a:
        lo -= 1
    for _, t0, t1 in ops[lo:bisect.bisect_right(starts, b)]:
        t0, t1 = max(t0, reach), min(t1, b)
        if t1 > t0:
            busy += t1 - t0
            reach = t1
    return busy


def _call_start(ops: list, starts: list, after: int | None,
                first: int) -> int | None:
    """The end of the last tokens copy that starts before ``first`` (the
    call's first launch) and after ``after`` (the previous call's last)."""
    hi = bisect.bisect_left(starts, first)
    for name, t0, t1 in reversed(ops[:hi]):
        if after is not None and t0 < after:
            return None
        if TOKENS_COPY in name:
            return t1
    return None


def segments_ms(win, kind: str) -> list[float] | None:
    """Per program call wholly inside the traced window, the device time
    (ms) of the segments of its layers of ``kind``."""
    t = win.traced
    if t is None or t.trace is None:
        return None
    layer_kinds = getattr(t.arch.counts, "layer_kinds", None)
    if layer_kinds is None:
        return None
    kinds = layer_kinds(t.config)
    if kind not in kinds:
        return None
    tr = t.trace
    ks = tr.kernels(readers.ROWSPLIT_KERNEL)
    per_call = len(t.arch.counts.spmm_launches(t.config))
    if (per_call != 3 * len(kinds) or not ks
            or len(ks) != per_call * len(t.calls)):
        return None
    ops = tr.device
    starts = [e[1] for e in ops]
    w0, w1 = tr.window
    out = []
    for i in range(len(t.calls)):
        grp = ks[i * per_call:(i + 1) * per_call]
        if grp[0][1] < w0 or grp[-1][2] > w1:
            continue
        start = _call_start(ops, starts, ks[i * per_call - 1][2] if i
                            else None, grp[0][1])
        if start is None:
            continue
        ns = 0
        for layer, k in enumerate(kinds):
            if k == kind:
                a = grp[3 * layer - 1][2] if layer else start
                ns += _busy_ns(ops, starts, a, grp[3 * layer][1])
        out.append(ns / 1e6)
    return out


def mixer_ms(win, kind: str) -> float | None:
    """Mean over the calls of :func:`segments_ms`."""
    calls = segments_ms(win, kind)
    if not calls:
        return None
    return sum(calls) / len(calls)
