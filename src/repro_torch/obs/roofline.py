"""Live roofline accountant: measured device time vs. modeled minimum
bytes (the reference's ``repro.obs.roofline``, its byte and flop models
function for function).

The paper's verdict criterion is *distance to the memory-bandwidth roof*:
merge-based balancing and coalesced access matter exactly because SpMM at
interesting sparsities is bandwidth-bound.  This module makes that a
measurement:

* :func:`spmm_min_bytes` / :func:`plan_min_bytes` -- the compulsory-traffic
  model (each operand/result crosses HBM once),
* :func:`plan_bwd_min_bytes` / :func:`sddmm_min_bytes` -- the same model
  for the backward (transpose-merge dB + SDDMM dvals),
* :func:`measure_roof` -- a streaming (copy-scale) pass calibrating the
  device's achievable bandwidth once, cached under ``artifacts/`` keyed by
  the card,
* :class:`RooflineAccountant` -- per ``(kind, method, impl, dtype)`` key,
  accumulates measured time next to modeled minimum bytes and reports
  achieved bandwidth as a fraction of the measured roof: "kernel X ran at
  Y% of roof".

Feed the accountant device times (CUDA-event medians of the kernel), not
host wall time: the serving and decode paths are host-bound, and a host
time would put a kernel far below the roof for a reason that is not the
kernel's.  The fraction is a *lower bound* on efficiency (the model counts
compulsory bytes only; a kernel moving more than compulsory traffic looks
worse, never better).
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time

import torch

# ------------------------------------------------------ bytes/flops model ---


def spmm_min_bytes(m: int, k: int, n: int, nnz: int, *, val_bytes: int = 4,
                   idx_bytes: int = 4, out_bytes: int = 4) -> int:
    """Compulsory traffic of one CSR SpMM: vals + col indices once, the
    dense B panel once, the output C once."""
    return (nnz * (val_bytes + idx_bytes) + k * n * val_bytes
            + m * n * out_bytes)


def epilogue_tail_bytes(m: int, n: int, *, out_bytes: int = 4,
                        bias: bool = False, residual: bool = False) -> int:
    """Traffic of a *separate* elementwise tail program: read C, read the
    epilogue operands, write the result."""
    extra = (m * out_bytes if bias else 0) + \
        (m * n * out_bytes if residual else 0)
    return 2 * m * n * out_bytes + extra


def fused_epilogue_ceiling(m: int, k: int, n: int, nnz: int, *,
                           val_bytes: int = 4, out_bytes: int = 4,
                           bias: bool = True,
                           residual: bool = False) -> float:
    """Bytes-moved speedup ceiling of fusing the tail into the SpMM."""
    spmm = spmm_min_bytes(m, k, n, nnz, val_bytes=val_bytes,
                          out_bytes=out_bytes)
    tail = epilogue_tail_bytes(m, n, out_bytes=out_bytes, bias=bias,
                               residual=residual)
    fused_extra = (m * out_bytes if bias else 0) + \
        (m * n * out_bytes if residual else 0)
    return (spmm + tail) / (spmm + fused_extra)


_DTYPE_BYTES = {"float64": 8, "float32": 4, "bfloat16": 2, "float16": 2}


def _dtype_bytes(name: str | None) -> int:
    return _DTYPE_BYTES.get(str(name), 4)


def plan_min_bytes(meta, n: int, *, val_dtype: str = "float32",
                   out_dtype: str | None = None, batch: int = 1,
                   epilogue=None, b_dtype: str | None = None) -> int:
    """Compulsory bytes of executing a plan against an n-column B.

    ``meta`` is a ``core.plan.PlanMeta``: it carries ``shape`` and
    ``nnz_pad`` (the static nonzero capacity the kernels actually stream,
    padding included).
    ``batch`` scales the dense legs (B, C, a flagged residual);
    ``b_dtype`` widens/narrows the B leg independently of the values
    (defaults to ``val_dtype``); a fused ``epilogue`` adds its operand
    reads (bias once, residual per batch).
    """
    m, k = meta.shape
    vb = _dtype_bytes(val_dtype)
    bb = _dtype_bytes(b_dtype or val_dtype)
    ob = _dtype_bytes(out_dtype or val_dtype)
    total = (meta.nnz_pad * (vb + 4) + batch * k * n * bb
             + batch * m * n * ob)
    if epilogue is not None:
        if getattr(epilogue, "bias", False):
            total += m * bb
        if getattr(epilogue, "residual", False):
            total += batch * m * n * bb
    return total


def sddmm_min_bytes(nnz: int, m: int, k: int, n: int, *, batch: int = 1,
                    dc_dtype: str = "float32",
                    b_dtype: str = "float32") -> int:
    """Compulsory traffic of the SDDMM values-cotangent pass: read the
    output cotangent and B once, the nonzero coordinate streams once,
    write one f32 value per nonzero (``kernels.sddmm``)."""
    dcb = _dtype_bytes(dc_dtype)
    bb = _dtype_bytes(b_dtype)
    return (batch * m * n * dcb + batch * k * n * bb
            + nnz * (4 + 4) + nnz * 4)


def plan_bwd_min_bytes(meta, n: int, *, val_dtype: str = "float32",
                       b_dtype: str | None = None,
                       batch: int = 1) -> int:
    """Compulsory *extra* bytes of the custom-VJP backward, on top of
    the forward: the transpose-merge dB pass (stream the transposed
    structure and values, read the f32 output cotangent, write dB in
    B's dtype) plus the SDDMM dvals pass (:func:`sddmm_min_bytes`).
    """
    m, k = meta.shape
    vb = _dtype_bytes(val_dtype)
    bb = _dtype_bytes(b_dtype or val_dtype)
    db = (meta.nnz_pad * (vb + 4) + batch * m * n * 4
          + batch * k * n * bb)
    return db + sddmm_min_bytes(meta.nnz_pad, m, k, n, batch=batch,
                                b_dtype=b_dtype or val_dtype)


def spmm_flops(nnz: int, n: int) -> float:
    """Useful flops of one SpMM: a multiply-add per (nonzero, column)."""
    return 2.0 * nnz * n


# ------------------------------------------------------- roof calibration ---


@dataclasses.dataclass(frozen=True)
class Roof:
    """A device's measured streaming-bandwidth roof."""

    backend: str                   # "cuda:<card name>" | "cpu"
    bytes_per_s: float
    elements: int                  # array length of the calibration run
    source: str                    # "measured" | "cached"

    @property
    def gb_per_s(self) -> float:
        return self.bytes_per_s / 1e9


# Not the reference's roofline_roof.json: its "cpu" record is JAX's copy.
_ROOF_CACHE_FILE = "roofline_roof_torch.json"
_roof_memo: dict[str, Roof] = {}
_roof_lock = threading.Lock()

# f32 elements of the calibration array.  On a card 1 << 26 (256 MiB, x and
# y each) is more than 5x an H100's 50 MB L2, so the passes cannot run
# from cache (the reference's 1 << 24, 64 MiB, is barely above it);
# the CPU keeps the reference's 1 << 24.
DEFAULT_ELEMENTS = {"cuda": 1 << 26, "cpu": 1 << 24}


def _measure_stream_bw(elements: int, repeat: int,
                       device: torch.device) -> float:
    """Best-case streaming bandwidth of the copy-scale pass.

    ``y = x * 1.5 + 0.25`` over an f32 array, as eager PyTorch runs it: a
    scale pass into ``y`` and an add pass over ``y`` in place, each one
    read and one write an element (16 bytes an element in all).  Both are
    contiguous elementwise kernels with Python-scalar operands, which
    PyTorch runs with vector loads; a one-pass ``addcmul`` over broadcast
    0-d tensors would take its strided path, which falls short of the
    streaming rate.  On a card each run is timed with CUDA events
    around its two launches; on the CPU with the host clock.  The
    *minimum* over ``repeat`` runs is the roof -- the question is what the
    memory system can do, not what it does on an average run.  This is a
    calibration of the device, not a kernel of the port.
    """
    x = torch.ones(elements, dtype=torch.float32, device=device)
    y = torch.empty_like(x)

    def run():
        torch.mul(x, 1.5, out=y)
        y.add_(0.25)

    run()                                  # warm: allocator, launch path
    best = float("inf")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(repeat):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            run()
            t1.record()
            t1.synchronize()
            best = min(best, t0.elapsed_time(t1) / 1e3)
    else:
        for _ in range(repeat):
            t0 = time.perf_counter()
            run()
            best = min(best, time.perf_counter() - t0)
    return 4.0 * elements * 4 / best


def measure_roof(*, cache_dir: str | None = "artifacts", force: bool = False,
                 elements: int | None = None, repeat: int = 5,
                 device=None) -> Roof:
    """The device's streaming roof, calibrated once and cached.

    ``device``: the card (default ``"cuda"``; raises without one) or
    ``"cpu"``.  ``elements`` defaults to :data:`DEFAULT_ELEMENTS` of the
    device's type.  Cached two ways: in-process (per card name, or
    ``"cpu"``) and in ``<cache_dir>/roofline_roof_torch.json``, so every run on
    this machine shares one calibration.  ``force`` re-measures.
    ``cache_dir=None`` skips the file cache.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("measure_roof: torch sees no CUDA device; pass "
                           "device='cpu' to calibrate the host")
    if elements is None:
        elements = DEFAULT_ELEMENTS.get(device.type, 1 << 24)
    # Keyed by the card's name (never a bare "gpu"), or "cpu".
    backend = ("cuda:" + torch.cuda.get_device_name(device)
               if device.type == "cuda" else device.type)
    with _roof_lock:
        memo = _roof_memo.get(backend)
    if memo is not None and not force:
        return memo
    path = (os.path.join(cache_dir, _ROOF_CACHE_FILE)
            if cache_dir else None)
    if path and not force and os.path.exists(path):
        try:
            with open(path) as f:
                data = json.load(f)
            rec = data.get(backend)
            if rec and rec.get("bytes_per_s", 0) > 0:
                roof = Roof(backend=backend,
                            bytes_per_s=float(rec["bytes_per_s"]),
                            elements=int(rec.get("elements", elements)),
                            source="cached")
                with _roof_lock:
                    _roof_memo[backend] = roof
                return roof
        except (OSError, ValueError, KeyError):
            pass                    # unreadable cache: re-measure
    bw = _measure_stream_bw(elements, repeat, device)
    roof = Roof(backend=backend, bytes_per_s=bw, elements=elements,
                source="measured")
    with _roof_lock:
        _roof_memo[backend] = roof
    if path:
        try:
            os.makedirs(cache_dir, exist_ok=True)
            data = {}
            if os.path.exists(path):
                try:
                    with open(path) as f:
                        data = json.load(f)
                except (OSError, ValueError):
                    data = {}
            data[backend] = {"bytes_per_s": bw, "elements": elements,
                             "measured_at": time.time()}
            with open(path, "w") as f:
                json.dump(data, f, indent=1)
        except OSError:
            pass                    # read-only checkout: memo still holds
    return roof


def clear_roof_memo() -> None:
    """Forget in-process roof calibrations (tests)."""
    with _roof_lock:
        _roof_memo.clear()


# ------------------------------------------------------------- accountant ---


@dataclasses.dataclass
class _Entry:
    calls: int = 0
    wall_us: float = 0.0
    min_bytes: float = 0.0
    flops: float = 0.0


class RooflineAccountant:
    """Accumulates (measured time, modeled bytes) per execution key.

    Keys are ``(kind, method, impl, dtype)`` tuples -- e.g. ``("spmm",
    "merge", "cuda", "float32")``.  Feed it from any site that owns a
    device time for a known program (``chip_smoke.py``'s obs phase feeds
    each kernel's CUDA-event medians).
    """

    def __init__(self):
        self._entries: dict[tuple, _Entry] = {}
        self._lock = threading.Lock()

    def record(self, key: tuple, *, wall_us: float, min_bytes: float,
               flops: float = 0.0, calls: int = 1) -> None:
        """Add ``calls`` executions totaling ``wall_us`` that each moved
        at least ``min_bytes / calls`` compulsory bytes."""
        with self._lock:
            e = self._entries.setdefault(tuple(key), _Entry())
            e.calls += calls
            e.wall_us += wall_us
            e.min_bytes += min_bytes
            e.flops += flops

    def account_plan(self, meta, n: int, *, wall_us: float,
                     impl: str = "cuda", val_dtype: str = "float32",
                     out_dtype: str | None = None,
                     calls: int = 1) -> None:
        """Record executions of a plan (``meta``: a PlanMeta)
        against an n-column B, deriving bytes/flops from the model."""
        method = getattr(meta, "method", "?")
        per_call = plan_min_bytes(meta, n, val_dtype=val_dtype,
                                  out_dtype=out_dtype)
        self.record(("spmm", method, impl, str(val_dtype)),
                    wall_us=wall_us, min_bytes=per_call * calls,
                    flops=spmm_flops(meta.nnz_pad, n) * calls,
                    calls=calls)

    def rows(self, roof: Roof | None = None) -> list[dict]:
        """One dict per key: achieved bandwidth, roof fraction, flops."""
        with self._lock:
            items = sorted(self._entries.items())
        out = []
        for key, e in items:
            secs = e.wall_us / 1e6
            bw = e.min_bytes / secs if secs > 0 else 0.0
            row = {
                "kind": key[0],
                "method": key[1] if len(key) > 1 else "",
                "impl": key[2] if len(key) > 2 else "",
                "dtype": key[3] if len(key) > 3 else "",
                "calls": e.calls,
                "wall_us": e.wall_us,
                "min_bytes": e.min_bytes,
                "achieved_bytes_per_s": bw,
                "gflops_per_s": (e.flops / secs / 1e9) if secs > 0 else 0.0,
            }
            if roof is not None and roof.bytes_per_s > 0:
                row["roof_bytes_per_s"] = roof.bytes_per_s
                row["roof_fraction"] = bw / roof.bytes_per_s
            out.append(row)
        return out

    def report(self, roof: Roof | None = None) -> str:
        """Text verdicts: "kernel X ran at Y% of roof"."""
        rows = self.rows(roof)
        if not rows:
            return "roofline: no executions recorded"
        lines = []
        if roof is not None:
            lines.append(
                f"roofline roof ({roof.backend}, {roof.source}): "
                f"{roof.gb_per_s:.2f} GB/s streaming")
        for r in rows:
            head = (f"{r['kind']} {r['method']}/{r['impl']} {r['dtype']}: "
                    f"{r['achieved_bytes_per_s'] / 1e9:.2f} GB/s achieved")
            if "roof_fraction" in r:
                head += f" = {r['roof_fraction'] * 100:.1f}% of roof"
            head += (f" ({r['calls']} calls, "
                     f"{r['min_bytes'] / max(r['calls'], 1) / 1e6:.2f} "
                     "MB/call min)")
            lines.append(head)
        return "\n".join(lines)

    def reset(self) -> None:
        with self._lock:
            self._entries.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)
