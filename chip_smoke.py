#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Run from the repository root, with no arguments, on a machine with one
NVIDIA H100 (sm_90a) and the CUDA toolkit.  Phases, each timed:

1. build    — compile the hand-written CUDA kernels from ``src/repro_torch/
              csrc`` with nvcc (printing what ptxas reports);
2. parity   — hold each kernel against its plain PyTorch version on the
              card: the six matrix kinds of the reference's kernel tests and
              the two Llama-3.2-1B FFN shapes, n in {1, 32, 128, 160}, f32
              and bf16, 2-D and batched; the SpMMs with three epilogues, the
              SDDMM also on a 0-nnz pattern;
3. grad     — ``execute_plan`` under autograd, kernels against plain
              versions: dvals, dB, d_bias and d_res, both methods, three
              epilogues, 2-D and batched B, with the backward's launches;
4. timing   — at the serving path's shapes: kernel, plain version, the
              cuSPARSE call (``torch.sparse.mm`` / ``sampled_addmm``, a
              yardstick the port never calls) and the least time the card
              could take, for the forward SpMMs and the backward's SDDMM and
              dB (merge on the transpose plan);
5. serving  — ``serve_pruned`` on Llama-3.2-1B at full width (16 layers,
              random weights from a seed), batch 4 x prompt 32, keep 0.25,
              once with the §5.4 rule (row-split) and once forcing merge,
              with launch counts, plans built while serving, and the two
              runs' logits compared; plus the smoke config on the card
              against the same model on the CPU;
6. training — sparse fine-tuning of layer 0's pruned FFN at full width
              (``make_sparse_train_step``, 5 SGD steps toward the dense
              FFN's output) for both methods: losses, step times, device
              busy share, peak memory, plans built, launches per step, and
              the kernel step's gradients against the plain step's;
7. summary  — a ``kernels`` JSON line, the card's name and power limit, and
              last the ``{"ok": true, ...}`` line.

Exits non-zero, printing no result, when torch sees no CUDA device, when
the package is not beside this script, or when any phase fails.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
import warnings

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# Kernel vs plain version on the same card and inputs.  f32: the
# reference's 2e-5 (both sum in f32, in other orders — the merge kernel's
# atomics change its order from run to run).  bf16 outputs: 2e-2, one
# bf16 rounding (2^-8 relative) of f32 sums that differ in the last bits.
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
# Llama-3.2-1B logits of the row-split run vs the merge run: the SpMMs are
# f32 in both, but the bf16 residual stream rounds each layer's output
# (2^-8 relative), so a last-bit difference of one SpMM can flip a bf16
# rounding and travel through 16 layers.  |logits| ~ 1 after the final
# norm.
SERVE_TOL = dict(max_abs=0.25, rel_fro=2e-2)
# The smoke model in f32 on the card vs the CPU: summation order only.
SMOKE_TOL = dict(rtol=1e-4, atol=1e-4)
# SDDMM kernel vs plain version.  f32: both sum n <= 160 products of unit
# normals in f32, in other orders (lane partials and a shuffle tree against
# torch's reduction); the dots reach ~50, so a dot that cancels to near 0
# keeps an absolute error of a few 1e-6 — atol 1e-4 covers it with margin.
# bf16 outputs: one bf16 rounding of f32 sums that differ in the last bits.
SDDMM_TOL = {"float32": dict(rtol=2e-5, atol=1e-4),
             "bfloat16": dict(rtol=2e-2, atol=2e-2)}
# Gradients, kernels vs plain versions: the reference's gradient rtol 1e-4;
# atol 1e-4 because dvals and dB are f32 sums of up to 2 x 128 (dvals) and
# 2048 (dB of w1) products summed in other orders, dB's with the merge
# kernel's atomics in an order that changes from run to run.  bf16: one
# bf16 rounding of the forward and of each cotangent.
GRAD_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
            "bfloat16": dict(rtol=2e-2, atol=2e-2)}
# The full-width kernel step's gradients vs the plain step's: rtol 1e-4 and
# atol 1e-4 of the largest |dvals| of the matrix — f32 sums over 128 tokens
# and up to 8192 columns in other orders, through three layers.
TRAIN_TOL = dict(rtol=1e-4, atol_of_max=1e-4)
# |C| below which relu's derivative is left out of the gradient parity.
RELU_KINK = 1e-4
# SGD on the CSR values toward the dense FFN's output, MSE over 128 tokens:
# the loss halves in 5 steps at every width tried on the CPU (d_model 128 to
# 768, d_ff = 4 d_model), and diverges from lr ~ 128 up at d_model 512.
LR, TRAIN_STEPS = 16.0, 5

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12        # H100 SXM, float32 outside tensor cores

MATRIX_KINDS = {               # tests/test_kernels.py MATRIX_KINDS
    "regular_long": (64, 96, 33),
    "irregular": (48, 64, (0, 24)),
    "short_rows": (96, 64, (0, 4)),
    "empty_heavy": (64, 32, (0, 2)),
    "single_row": (1, 128, 64),
    "single_col": (64, 1, 1),
}
# Llama-3.2-1B FFN matrices as the port stores them (d_out, d_in), keep
# 0.25: w1/w3 (8192, 2048) with 512 nonzeros a row, w2 (2048, 8192) with
# 2048; init scale d_in^-0.5 as the model's init.
LLAMA_FFN = {"w1": (8192, 2048), "w2": (2048, 8192)}
KEEP = 0.25
SERVE_BATCH, SERVE_PROMPT, SEED = 4, 32, 0

KERNELS = {
    "rowsplit_spmm": dict(
        method="rowsplit", source="src/repro_torch/csrc/rowsplit_spmm.cu",
        replaces="src/repro/kernels/rowsplit_spmm.py:94"),
    "merge_spmm": dict(
        method="merge", source="src/repro_torch/csrc/merge_spmm.cu",
        replaces="src/repro/kernels/merge_spmm.py:193"),
    "sddmm": dict(
        method=None, source="src/repro_torch/csrc/sddmm.cu",
        replaces="src/repro/kernels/sddmm.py:38"),
}


def phase(name):
    print(f"\n== {name} ==", flush=True)
    return time.perf_counter()


def done(name, t0):
    print(f"[{name}] wall {time.perf_counter() - t0:.2f}s", flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps=7, inner=10) -> float:
    """Median over ``reps`` CUDA-event windows of the mean time of
    ``inner`` back-to-back calls (after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def profile_device(fn, top=8) -> float:
    """Device time of one warm call of ``fn`` by kernel (torch.profiler,
    device events only: a CPU op's own device time repeats its kernels');
    prints the largest kernels and returns the total device ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    for ms, count, name in rows[:top]:
        print(f"  device {ms:8.3f} ms  x{count:<4d} {name[:90]}")
    if not rows:
        print("  the profiler saw no device time")
    return total


def host_ms(fn, reps=5) -> float:
    """Median host-clock time of a synchronised call (after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def check_close(what, got, want, tol):
    """Raise unless ``got`` matches ``want`` (shape, dtype, values; NaN
    fails); returns (max |d|, worst |d| / (atol + rtol |want|))."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {tuple(got.shape)} {got.dtype} vs "
                             f"{tuple(want.shape)} {want.dtype}")
    g, w = got.float(), want.float()
    if not g.numel():
        return 0.0, 0.0
    d = (g - w).abs()
    if not torch.allclose(g, w, **tol):
        bad = ~torch.isclose(g, w, **tol)
        raise AssertionError(
            f"{what}: kernel disagrees with its plain version (tol {tol}): "
            f"{int(bad.sum())} of {g.numel()} elements, max |d| "
            f"{d.nan_to_num(float('inf')).max().item():.3e}")
    return d.max().item(), (d / (tol["atol"] + tol["rtol"] * w.abs())
                            ).max().item()


def parity_sddmm(matrices, dev) -> float:
    """The SDDMM kernel against its plain version on the card (through
    ``ops.sddmm``, one counted launch a call); raises on a disagreement or
    on a nonzero in a padded slot; returns the worst |error|."""
    from repro_torch.core import PlanPolicy, build_plan
    from repro_torch.kernels import ops, sddmm
    worst, seed = 0.0, 500
    for mname, a in matrices.items():
        fwd = build_plan(a, PlanPolicy(method="merge",
                                       with_transpose=False)).fwd
        coords = [fwd[n] for n in ("nz_rows", "nz_cols", "nz_valid")]
        pad = ~fwd["nz_valid"]
        m, k = a.shape
        for dt in (torch.float32, torch.bfloat16):
            tol = SDDMM_TOL[str(dt).removeprefix("torch.")]
            max_abs = ratio = 0.0
            cases = 0
            for n in (1, 32, 128, 160):
                for lead in ((), (2,)):
                    seed += 1
                    g = torch.Generator(device=dev).manual_seed(seed)
                    dc = torch.randn(lead + (m, n), generator=g,
                                     device=dev).to(dt)
                    b = torch.randn(lead + (k, n), generator=g,
                                    device=dev).to(dt)
                    before = sddmm.LAUNCHES
                    got = ops.sddmm(*coords, dc, b, impl="cuda")
                    if sddmm.LAUNCHES - before != 1:
                        raise AssertionError(
                            f"sddmm {mname}: counted "
                            f"{sddmm.LAUNCHES - before} launches, expected 1")
                    want = ops.sddmm(*coords, dc, b, impl="torch")
                    torch.cuda.synchronize()
                    if got[..., pad].any():
                        raise AssertionError(
                            f"sddmm {mname}: nonzero dvals in a padded slot")
                    d, r = check_close(
                        f"sddmm {mname} {dt} n={n} batch={lead}", got, want,
                        tol)
                    max_abs, ratio = max(max_abs, d), max(ratio, r)
                    cases += 1
            print(f"parity sddmm         {mname:13s} {a.shape} {str(dt):14s} "
                  f"cases {cases}: max_abs {max_abs:.3e} (tol rtol "
                  f"{tol['rtol']} atol {tol['atol']}; worst |d|/(atol+rtol"
                  f"|want|) {ratio:.3f}); padded slots "
                  f"{int(pad.sum())}, all 0")
            worst = max(worst, max_abs)
    return worst


def parity_grad(matrices, eps, dev, read_counts) -> dict:
    """``execute_plan`` under autograd, impl="cuda" against impl="torch":
    dvals, dB, d_bias and d_res.  Checks that one backward needing dvals
    and dB launches 1 merge (transpose plan) and 1 SDDMM, and the merge
    epilogue iff B is bf16 (dB is written in B's dtype).  Returns the worst
    |error| of dvals (the SDDMM) and dB (the merge kernel)."""
    from repro_torch.core import ExecutionConfig, PlanPolicy, build_plan, \
        execute_plan
    worst = {"sddmm": 0.0, "merge_spmm": 0.0}
    seed = 900
    for method in ("merge", "rowsplit"):
        for mname, a in matrices.items():
            plan = build_plan(a, PlanPolicy(method=method))
            m, k = a.shape
            n = 128 if mname.startswith("llama") else 40
            for dt in (torch.float32, torch.bfloat16):
                tol = GRAD_TOL[str(dt).removeprefix("torch.")]
                err = {"dvals": 0.0, "dB": 0.0, "d_bias": 0.0, "d_res": 0.0}
                ratio, cases = 0.0, 0
                for ep_name, ep in eps.items():
                    for lead in ((), (2,)):
                        seed += 1
                        g = torch.Generator(device=dev).manual_seed(seed)
                        b = torch.randn(lead + (k, n), generator=g,
                                        device=dev).to(dt)
                        bias = torch.randn(m, generator=g, device=dev)
                        res = torch.randn(lead + (m, n), generator=g,
                                          device=dev)
                        ct = torch.randn(lead + (m, n), generator=g,
                                         device=dev).to(dt)
                        if ep is not None and ep.activation == "relu":
                            # relu' jumps at 0: where |C| is within the
                            # f32 sum-order noise of 0, the two forwards
                            # may take opposite sides (a few of the 2M
                            # entries at the Llama shapes), so the test
                            # cotangent is 0 there.
                            with torch.no_grad():
                                c = execute_plan(
                                    plan, a.vals.to(dt), b,
                                    ExecutionConfig(impl="torch"))
                            ct = torch.where(c.abs() < RELU_KINK, 0, ct)
                        grads = {}
                        for impl in ("cuda", "torch"):
                            ins = {"dvals": a.vals.to(dt), "dB": b}
                            if ep is not None and ep.bias:
                                ins["d_bias"] = bias
                            if ep is not None and ep.residual:
                                ins["d_res"] = res
                            ins = {key: t.detach().clone().requires_grad_()
                                   for key, t in ins.items()}
                            out = execute_plan(
                                plan, ins["dvals"], ins["dB"],
                                ExecutionConfig(impl=impl, epilogue=ep),
                                bias=ins.get("d_bias"),
                                residual=ins.get("d_res"))
                            before = read_counts()
                            got = torch.autograd.grad(out, list(ins.values()),
                                                      ct)
                            ran = {key: v - before[key]
                                   for key, v in read_counts().items()}
                            want = dict(rowsplit_spmm=0, merge_spmm=0,
                                        sddmm=0, merge_epilogue=0)
                            if impl == "cuda":
                                want.update(merge_spmm=1, sddmm=1,
                                            merge_epilogue=int(
                                                dt != torch.float32))
                            if ran != want:
                                raise AssertionError(
                                    f"grad {method} {mname}: the backward "
                                    f"launched {ran}, expected {want}")
                            grads[impl] = dict(zip(ins, got))
                        torch.cuda.synchronize()
                        for key, kern in grads["cuda"].items():
                            d, r = check_close(
                                f"grad {key} {method} {mname} {dt} "
                                f"{ep_name} batch={lead}", kern,
                                grads["torch"][key], tol)
                            err[key] = max(err[key], d)
                            ratio = max(ratio, r)
                        cases += 1
                print(f"grad {method:8s} {mname:13s} {a.shape} "
                      f"{str(dt):14s} n={n} cases {cases}: max_abs "
                      + ", ".join(f"{key} {v:.3e}" for key, v in err.items())
                      + f" (tol rtol {tol['rtol']} atol {tol['atol']}; "
                      f"worst |d|/(atol+rtol|want|) {ratio:.3f})")
                worst["sddmm"] = max(worst["sddmm"], err["dvals"])
                worst["merge_spmm"] = max(worst["merge_spmm"], err["dB"])
    print("backward launches per call needing dvals and dB: 1 merge on "
          "the transpose plan + 1 SDDMM (+1 merge epilogue for bf16 B), "
          "checked on every case")
    return worst


def timing_backward(llama_matrix, dev, card) -> dict:
    """The backward's kernels at the training path's shapes (n = 128, f32):
    the SDDMM (dvals) and dB = Aᵀ·g by the merge kernel on the transpose
    plan, each with its plain version, the cuSPARSE call and the
    function's bound, per matrix and per FFN layer (w1 + w3 + w2)."""
    from repro_torch.core import PlanPolicy, build_plan
    from repro_torch.core.plan import transpose_pattern
    from repro_torch.kernels import merge_spmm, ops, ref, sddmm
    n = SERVE_BATCH * SERVE_PROMPT
    acc = {name: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0,
                      flops=0) for name in ("sddmm", "merge_dB")}
    for mat_name, (m, k) in LLAMA_FFN.items():
        a = llama_matrix(mat_name, 20)
        uses = 2 if mat_name == "w1" else 1
        plan = build_plan(a, PlanPolicy(method="merge"))
        rows, cols, valid = (plan.fwd[x] for x in
                             ("nz_rows", "nz_cols", "nz_valid"))
        gen = torch.Generator(device=dev).manual_seed(40)
        g = torch.randn(m, n, generator=gen, device=dev)      # dC of C = AB
        b = torch.randn(k, n, generator=gen, device=dev)
        nnz = a.nnz()
        flops = 2 * nnz * n
        csr_index = nnz * 4 + (m + 1) * 4
        with warnings.catch_warnings():      # "beta state" notices
            warnings.simplefilter("ignore")
            sp = torch.sparse_csr_tensor(a.row_ptr, a.col_ind, a.vals,
                                         (m, k), check_invariants=True)
            a_t, perm = transpose_pattern(a)
            vals_t = torch.cat([a.vals, a.vals.new_zeros(1)])[perm.long()]
            sp_t = torch.sparse_csr_tensor(a_t.row_ptr, a_t.col_ind, vals_t,
                                           (k, m), check_invariants=True)
        bt = b.T.contiguous()
        cases = {
            # dvals = (g·Bᵀ) at the pattern: reads col_ind, row_ptr, g and
            # B once, writes one f32 per nonzero.
            "sddmm": dict(
                kernel=lambda: sddmm.sddmm_cuda(rows, cols, valid, g[None],
                                                b[None]),
                plain=lambda: ref.sddmm_ref(rows, cols, valid, g, b),
                library=lambda: torch.sparse.sampled_addmm(sp, g, bt,
                                                           beta=0.0),
                check=lambda out, lib: (out[0], lib.values()),
                nbytes=csr_index + (m * n + k * n) * 4 + nnz * 4),
            # dB = Aᵀ·g: reads A's CSR (values too) and g once, writes dB.
            "merge_dB": dict(
                kernel=lambda: merge_spmm.merge_spmm_cuda(plan.bwd, a.vals,
                                                          g[None], k),
                plain=lambda: ops.merge_execute(plan.bwd, a.vals, g, m=k,
                                                impl="torch"),
                library=lambda: torch.sparse.mm(sp_t, g),
                check=lambda out, lib: (out[0], lib),
                nbytes=csr_index + nnz * 4 + (m * n + k * n) * 4),
        }
        for name, c in cases.items():
            kern, lib = c["kernel"](), c["library"]()
            torch.cuda.synchronize()
            # The yardstick computes the same function (loose: it is only
            # a timing reference).
            x, y = c["check"](kern, lib)
            if not torch.allclose(x, y, rtol=1e-3, atol=1e-3):
                raise AssertionError(f"{name} {mat_name}: the library call "
                                     "computes something else")
            k_ms = time_ms(c["kernel"])
            p_ms = time_ms(c["plain"], reps=5, inner=3)
            l_ms = time_ms(c["library"])
            t_b = c["nbytes"] / HBM_BYTES_PER_S
            t_o = flops / FP32_FLOP_PER_S
            bound = max(t_b, t_o) * 1e3
            by = "bytes" if t_b >= t_o else "operations"
            print(f"timing {name:9s} {mat_name} {(m, k)} nnz {nnz} n {n}: "
                  f"kernel {k_ms:.4f} ms ({k_ms / bound:.1f}x bound), plain "
                  f"{p_ms:.4f} ms, library {l_ms:.4f} ms, bound "
                  f"{bound:.6f} ms ({by}: {c['nbytes']} B, {flops} flop); "
                  f"{card}")
            s = acc[name]
            s["ms"] += uses * k_ms
            s["plain_ms"] += uses * p_ms
            s["library_ms"] += uses * l_ms
            s["bytes"] += uses * c["nbytes"]
            s["flops"] += uses * flops
        del sp, sp_t, a_t, vals_t, plan
    out = {}
    for name, s in acc.items():
        t_b, t_o = s["bytes"] / HBM_BYTES_PER_S, s["flops"] / FP32_FLOP_PER_S
        out[name] = dict(ms=s["ms"], plain_ms=s["plain_ms"],
                         library_ms=s["library_ms"],
                         bound_ms=max(t_b, t_o) * 1e3,
                         bound_by="bytes" if t_b >= t_o else "operations")
        print(f"timing {name:9s} per FFN layer (w1+w3+w2): kernel "
              f"{s['ms']:.4f} ms ({s['ms'] / out[name]['bound_ms']:.1f}x "
              f"bound), plain {s['plain_ms']:.4f} ms, library "
              f"{s['library_ms']:.4f} ms, bound {out[name]['bound_ms']:.6f} "
              f"ms ({out[name]['bound_by']}: {s['bytes']} B, {s['flops']} "
              f"flop); {card}")
    print("library: torch.sparse.sampled_addmm (cuSPARSE SDDMM) for sddmm, "
          "torch.sparse.mm on a CSR of A^T for merge_dB; neither is called "
          "by the port")
    return out


def training(cfg, dev, card, reset_counts, read_counts) -> dict:
    """Sparse fine-tuning of layer 0's pruned FFN at full width, once with
    the §5.4 rule (row-split) and once forcing merge; returns the launches
    of each kernel over both runs' steps."""
    import torch.nn.functional as F

    from repro_torch.core import ExecutionConfig, PlanPolicy
    from repro_torch.engine import cache_stats, clear_cache
    from repro_torch.models import model as M
    from repro_torch.models import sparse as S
    from repro_torch.runtime import steps
    params = M.init_params(cfg, SEED, dev)
    mlp = params["blocks"][0]["mlp"]
    del params
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    x = torch.randn(SERVE_BATCH, SERVE_PROMPT, cfg.d_model, generator=gen,
                    device=dev)
    # The target: the dense FFN (f32, TF32 off) on x, so the pruned layer
    # is fine-tuned toward the weights it came from.
    y = (F.silu(x @ mlp["w1"]) * (x @ mlp["w3"])) @ mlp["w2"]
    shapes = ", ".join(f"{k} {tuple(w.shape)}" for k, w in mlp.items())
    print(f"model {cfg.name} layer 0 FFN: d_model {cfg.d_model}, d_ff "
          f"{cfg.d_ff} ({cfg.mlp}), {shapes} f32 from init_params seed "
          f"{SEED}; keep {KEEP}; x "
          f"{tuple(x.shape)} from seed {SEED + 2}, target the dense FFN's "
          f"output; SGD lr {LR}, {TRAIN_STEPS} steps")
    totals = {"rowsplit_spmm": 0, "merge_spmm": 0, "sddmm": 0}
    for kname, method in (("rowsplit_spmm", "auto"),
                          ("merge_spmm", "merge")):
        clear_cache()           # earlier phases' and runs' plans
        torch.cuda.empty_cache()
        sparse_p = S.prune_mlp(mlp, KEEP, policy=PlanPolicy(method=method))
        used = {sl.method for sl in sparse_p.values()}
        if used != {KERNELS[kname]["method"]}:
            raise AssertionError(f"method={method} planned {used}")
        step, vals0 = steps.make_sparse_train_step(sparse_p, lr=LR)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev) / 2**30
        misses = cache_stats().misses
        vals, losses, times = vals0, [], []
        reset_counts()
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            vals, loss = step(vals, x, y)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss.item())
        counts = read_counts()
        replans = cache_stats().misses - misses
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        for name in totals:
            totals[name] += counts[name]
        per_step = {name: v / TRAIN_STEPS for name, v in counts.items()}
        want = dict(rowsplit_spmm=0.0, merge_spmm=1.0, sddmm=3.0,
                    merge_epilogue=0.0)
        want[kname] += 3.0
        cold, warm = times[0], statistics.median(times[1:])

        def forward():
            with torch.no_grad():
                S.sparse_mlp_apply(sparse_p, x, None)

        fwd_ms = host_ms(forward)
        busy = profile_device(lambda: step(vals, x, y))
        print(f"train method={method} ({kname}): losses "
              + ", ".join(f"{v:.6f}" for v in losses)
              + f"; step cold {cold:.3f} ms, warm {warm:.3f} ms (median of "
              f"{TRAIN_STEPS - 1}); forward only {fwd_ms:.3f} ms, "
              f"step/forward {warm / fwd_ms:.2f}x; device busy "
              f"{busy:.3f} ms of a warm step (idle share "
              f"{1 - busy / warm:.3f}); device memory {held:.3f} GiB held "
              f"before the steps (dense and pruned FFN, plans, x, y), "
              f"{peak:.3f} GiB peak during them; "
              f"plans built during the steps {replans}; launches per step "
              f"{per_step}; {card}")
        if per_step != want:
            raise AssertionError(f"train {method}: launches per step "
                                 f"{per_step}, expected {want}")
        if replans:
            raise AssertionError(f"train {method}: {replans} plans built "
                                 "during the steps")
        if not all(map(math.isfinite, losses)) or \
                not all(b < a for a, b in zip(losses, losses[1:])):
            raise AssertionError(f"train {method}: the loss did not fall: "
                                 f"{losses}")
        # The kernel step against the plain step, from the same start.
        _, gk = steps.sparse_mlp_grads(sparse_p, vals0, x, y,
                                       ExecutionConfig(impl="cuda"))
        _, gp = steps.sparse_mlp_grads(sparse_p, vals0, x, y,
                                       ExecutionConfig(impl="torch"))
        torch.cuda.synchronize()
        for name in gk:
            scale = gp[name].abs().max().item()
            tol = dict(rtol=TRAIN_TOL["rtol"],
                       atol=TRAIN_TOL["atol_of_max"] * scale)
            d, r = check_close(f"train {method} dvals[{name}]", gk[name],
                               gp[name], tol)
            print(f"train {method} dvals[{name}] kernel vs plain: max |d| "
                  f"{d:.3e}, max |dvals| {scale:.3e} (tol rtol {tol['rtol']} "
                  f"atol {tol['atol']:.3e}; worst ratio {r:.3f})")
        del sparse_p, step, vals0, vals, gk, gp
        torch.cuda.empty_cache()
    return totals


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core import (Epilogue, PlanPolicy, build_plan, csr,
                                  prune_to_csr)
    from repro_torch.kernels import (_cuda, merge_spmm, ops, rowsplit_spmm,
                                     sddmm)
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = gpu_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; python {sys.version.split()[0]}")
    execs = {"rowsplit": ops.rowsplit_execute, "merge": ops.merge_execute}
    counters = {"rowsplit": rowsplit_spmm, "merge": merge_spmm}
    by_kernel = {"rowsplit_spmm": rowsplit_spmm, "merge_spmm": merge_spmm,
                 "sddmm": sddmm}

    def reset_counts():
        for mod in by_kernel.values():
            mod.LAUNCHES = 0
        merge_spmm.EPILOGUE_LAUNCHES = 0

    def read_counts() -> dict:
        counts = {name: mod.LAUNCHES for name, mod in by_kernel.items()}
        counts["merge_epilogue"] = merge_spmm.EPILOGUE_LAUNCHES
        return counts

    # ------------------------------------------------------------ build --
    t0 = phase("build")
    print(f"library: {_cuda.build(verbose=True)}")
    done("build", t0)

    def llama_matrix(name, seed):
        m, k = LLAMA_FFN[name]
        g = torch.Generator(device=dev).manual_seed(seed)
        w = torch.randn(m, k, generator=g, device=dev) * k ** -0.5
        return prune_to_csr(w, KEEP)

    # ----------------------------------------------------------- parity --
    t0 = phase("parity")
    worst = {name: 0.0 for name in KERNELS}
    rng_seed = 100
    matrices = {kind: csr.random_csr(i, m, k, nnz_per_row=npr, device=dev)
                for i, (kind, (m, k, npr)) in enumerate(
                    MATRIX_KINDS.items())}
    matrices.update({f"llama_{n}": llama_matrix(n, 10 + i)
                     for i, n in enumerate(LLAMA_FFN)})
    # A 0-nnz pattern: one padded slot, which the SDDMM must leave at 0.
    zero_nnz = {"zero_nnz": csr.random_csr(99, 64, 32, nnz_per_row=0,
                                           device=dev)}
    eps = {"none": None,
           "bias+gelu": Epilogue(bias=True, activation="gelu"),
           "relu+scale+residual": Epilogue(activation="relu", scale=0.5,
                                           residual=True)}
    for kname, kspec in KERNELS.items():
        method = kspec["method"]
        if method is None:                      # the SDDMM, below
            continue
        fn = execs[method]
        for mname, a in matrices.items():
            plan = build_plan(a, PlanPolicy(method=method))
            m, k = a.shape
            for dt in (torch.float32, torch.bfloat16):
                tol = TOL[str(dt).removeprefix("torch.")]
                max_abs = max_rel = ratio = 0.0
                cases = 0
                for n in (1, 32, 128, 160):
                    for lead in ((), (2,)):
                        rng_seed += 1
                        g = torch.Generator(device=dev).manual_seed(rng_seed)
                        b = torch.randn(lead + (k, n), generator=g,
                                        device=dev).to(dt)
                        bias = torch.randn(m, generator=g, device=dev)
                        res = torch.randn(lead + (m, n), generator=g,
                                          device=dev)
                        for ep in eps.values():
                            kw = dict(m=m, epilogue=ep)
                            if ep is not None and ep.bias:
                                kw["bias"] = bias
                            if ep is not None and ep.residual:
                                kw["residual"] = res
                            vals = a.vals.to(dt)
                            mod = counters[method]
                            before = (mod.LAUNCHES,
                                      merge_spmm.EPILOGUE_LAUNCHES)
                            got = fn(plan.fwd, vals, b, impl="cuda", **kw)
                            ran = (mod.LAUNCHES - before[0],
                                   merge_spmm.EPILOGUE_LAUNCHES - before[1])
                            epi = int(method == "merge" and (
                                ep is not None or dt != torch.float32))
                            if ran != (1, epi):
                                raise AssertionError(
                                    f"{kname} {mname}: counted launches "
                                    f"(kernel, merge epilogue) {ran}, "
                                    f"expected (1, {epi})")
                            want = fn(plan.fwd, vals, b, impl="torch", **kw)
                            torch.cuda.synchronize()
                            if got.shape != want.shape or \
                                    got.dtype != want.dtype:
                                raise AssertionError(
                                    f"{kname} {mname}: {got.shape} "
                                    f"{got.dtype} vs {want.shape} "
                                    f"{want.dtype}")
                            if not torch.allclose(got.float(), want.float(),
                                                  **tol):   # NaN fails too
                                raise AssertionError(
                                    f"{kname} disagrees with its plain "
                                    f"version on {mname} {dt} n={n} "
                                    f"batch={lead} epilogue={ep}")
                            d = (got.float() - want.float()).abs()
                            w = want.float().abs()
                            if d.numel():
                                max_abs = max(max_abs, d.max().item())
                                max_rel = max(max_rel, (d / w.clamp(
                                    min=tol["atol"])).max().item())
                                ratio = max(ratio, (d / (
                                    tol["atol"] + tol["rtol"] * w)
                                ).max().item())
                            cases += 1
                print(f"parity {kname:13s} {mname:13s} {a.shape} "
                      f"{str(dt):14s} cases {cases}: max_abs {max_abs:.3e} "
                      f"max_rel {max_rel:.3e} (tol rtol {tol['rtol']} "
                      f"atol {tol['atol']}; worst |d|/(atol+rtol|want|) "
                      f"{ratio:.3f})")
                worst[kname] = max(worst[kname], max_abs)
    worst["sddmm"] = parity_sddmm(dict(matrices, **zero_nnz), dev)
    done("parity", t0)

    # ------------------------------------------------------------- grad --
    t0 = phase("grad")
    for name, err in parity_grad(dict(matrices, **zero_nnz), eps, dev,
                                 read_counts).items():
        worst[name] = max(worst[name], err)
    done("grad", t0)

    # ----------------------------------------------------------- timing --
    t0 = phase("timing")
    print("shapes of the serving path: B (k, 128) f32 row-major, vals f32, "
          "no epilogue (swiglu); one call's CSR and plan (> 50 MB) exceed "
          "the 50 MB L2, as they do cycling over 48 matrices")
    # The bound is the function's, C = A·B on A's CSR, and one for both
    # kernels: values, column indices and row pointers read once, B read
    # once, C written once — not the bytes of a kernel's plan layout.
    # What a plan reads beyond the CSR's index arrays is printed apart.
    per_layer = {name: dict(ms=0.0, plain_ms=0.0, library_ms=0.0)
                 for name, spec in KERNELS.items() if spec["method"]}
    layer_bytes = layer_flops = 0
    n = SERVE_BATCH * SERVE_PROMPT
    for mat_name, (m, k) in LLAMA_FFN.items():
        a = llama_matrix(mat_name, 20)
        uses = 2 if mat_name == "w1" else 1       # w1 and w3 share a shape
        g = torch.Generator(device=dev).manual_seed(30)
        b = torch.randn(k, n, generator=g, device=dev)
        b3 = b[None]
        nnz = a.nnz()
        index_bytes = nnz * a.col_ind.element_size() + \
            a.row_ptr.numel() * a.row_ptr.element_size()
        nbytes = nnz * a.vals.element_size() + index_bytes + \
            b.numel() * b.element_size() + m * n * 4
        flops = 2 * nnz * n
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
        bound = max(t_bytes, t_ops) * 1e3
        by = "bytes" if t_bytes >= t_ops else "operations"
        layer_bytes += uses * nbytes
        layer_flops += uses * flops
        print(f"bound {mat_name} {(m, k)} nnz {nnz} n {n}: {bound:.6f} ms "
              f"({by}: {nbytes} B of CSR + B + C, {flops} flop)")
        with warnings.catch_warnings():      # "beta state" notices
            warnings.simplefilter("ignore")
            sp = torch.sparse_csr_tensor(a.row_ptr, a.col_ind, a.vals,
                                         (m, k), check_invariants=True)
        lib_ms = time_ms(lambda: torch.sparse.mm(sp, b))
        for kname in per_layer:
            method = KERNELS[kname]["method"]
            plan = build_plan(a, PlanPolicy(method=method,
                                            with_transpose=False))
            fwd = plan.fwd
            if method == "rowsplit":
                reads = [fwd["cols"], fwd["slot_nz"]]
                kern = lambda: rowsplit_spmm.rowsplit_spmm_cuda(
                    fwd, a.vals, b3, m)
            else:
                reads = [fwd["cols"], fwd["lrow"], fwd["slot_nz"],
                         fwd["tile"]]
                kern = lambda: merge_spmm.merge_spmm_cuda(
                    fwd, a.vals, b3, m)
            plain = lambda: execs[method](
                fwd, a.vals, b, m=m, impl="torch")
            plan_bytes = sum(t.numel() * t.element_size() for t in reads)
            k_ms = time_ms(kern)
            p_ms = time_ms(plain, reps=5, inner=3)
            print(f"timing {kname:13s} {mat_name} {(m, k)} nnz {nnz} n {n}: "
                  f"kernel {k_ms:.4f} ms ({k_ms / bound:.1f}x bound), plain "
                  f"{p_ms:.4f} ms, cuSPARSE {lib_ms:.4f} ms, bound "
                  f"{bound:.6f} ms; plan arrays read {plan_bytes} B, "
                  f"{plan_bytes - index_bytes} B beyond the CSR's index "
                  f"arrays; {card}")
            acc = per_layer[kname]
            acc["ms"] += uses * k_ms
            acc["plain_ms"] += uses * p_ms
            acc["library_ms"] += uses * lib_ms
    t_bytes = layer_bytes / HBM_BYTES_PER_S
    t_ops = layer_flops / FP32_FLOP_PER_S
    for kname, acc in per_layer.items():
        acc["bound_ms"] = max(t_bytes, t_ops) * 1e3
        acc["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        print(f"timing {kname:13s} per FFN layer (w1+w3+w2): kernel "
              f"{acc['ms']:.4f} ms ({acc['ms'] / acc['bound_ms']:.1f}x "
              f"bound), plain {acc['plain_ms']:.4f} ms, cuSPARSE "
              f"{acc['library_ms']:.4f} ms, bound {acc['bound_ms']:.6f} ms "
              f"({acc['bound_by']}: {layer_bytes} B, {layer_flops} flop); "
              f"{card}")
    backward = timing_backward(llama_matrix, dev, card)
    per_layer["sddmm"] = backward["sddmm"]
    done("timing", t0)

    # ---------------------------------------------------------- serving --
    t0 = phase("serving")
    cfg = get_config("llama3.2-1b")
    print(f"model {cfg.name}: {cfg.num_layers} layers (no depth cut), "
          f"d_model {cfg.d_model}, d_ff {cfg.d_ff}, heads {cfg.num_heads}/"
          f"{cfg.num_kv_heads}, vocab {cfg.vocab_size}; random weights "
          f"from seed {SEED}; batch {SERVE_BATCH} x prompt {SERVE_PROMPT}, "
          f"keep {KEEP}")
    params = M.init_params(cfg, SEED, dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    prompt = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                           generator=g, device=dev)
    forwards = 2                      # serve_pruned's cold + warm calls
    serving = {name: 0 for name in KERNELS}
    logits = {}
    for kname, method in (("rowsplit_spmm", "auto"),
                          ("merge_spmm", "merge")):
        reset_counts()
        rep = serve.serve_pruned(cfg, params, prompt, KEEP,
                                 policy=PlanPolicy(method=method))
        counts = read_counts()
        epilogues = counts.pop("merge_epilogue")
        for name in KERNELS:
            serving[name] += counts[name]
        used = KERNELS[kname]["method"]
        print(f"serve method={method}: methods {rep.methods}; plan "
              f"{rep.plan_s:.3f} s, cold forward {rep.cold_s * 1e3:.2f} ms, "
              f"warm forward {rep.warm_s * 1e3:.2f} ms, {rep.tok_per_s:.0f} "
              f"tok/s; plans built during serving {rep.replans}; launches "
              f"{counts} over {forwards} forwards ("
              f"{counts[kname] // forwards} of {kname} a forward), merge "
              f"epilogue kernel {epilogues} (f32, no epilogue); device "
              f"memory "
              f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB held, "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB "
              f"peak (params, cached plans of the run so far); {card}")
        want = 3 * cfg.num_layers * forwards
        if set(rep.methods.values()) != {used} or epilogues or \
                counts[kname] != want or sum(counts.values()) != want:
            raise AssertionError(
                f"method={method}: expected {want} launches of {kname} "
                f"alone, got {counts} and {epilogues} of the merge "
                f"epilogue (plans {rep.methods})")
        lg = rep.logits
        if lg.shape != (SERVE_BATCH, SERVE_PROMPT, cfg.vocab_size) or \
                not torch.isfinite(lg).all():
            raise AssertionError(f"bad logits: {lg.shape}, finite "
                                 f"{torch.isfinite(lg).all().item()}")
        logits[kname] = lg
        blocks = serve.prune_ffn_blocks(params, cfg, KEEP,
                                        PlanPolicy(method=method))
        fwd = serve.make_pruned_forward(cfg)

        def forward():
            with torch.no_grad():
                fwd(params, blocks, prompt)

        dev_ms = profile_device(forward)
        print(f"profile method={method}: device busy {dev_ms:.3f} ms of the "
              f"{rep.warm_s * 1e3:.2f} ms warm forward (idle share "
              f"{1 - dev_ms / (rep.warm_s * 1e3):.3f}); {card}")
        del rep, blocks, fwd
    d = (logits["rowsplit_spmm"] - logits["merge_spmm"]).abs()
    rel = (torch.linalg.vector_norm(d) / torch.linalg.vector_norm(
        logits["merge_spmm"])).item()
    print(f"logits row-split vs merge: max |d| {d.max().item():.4e}, "
          f"relative Frobenius {rel:.4e}, max |logit| "
          f"{logits['merge_spmm'].abs().max().item():.3f} (tol max_abs "
          f"{SERVE_TOL['max_abs']}, rel_fro {SERVE_TOL['rel_fro']})")
    if not (d.max().item() <= SERVE_TOL["max_abs"]
            and rel <= SERVE_TOL["rel_fro"]):
        raise AssertionError("row-split and merge serving disagree")
    del params, logits
    torch.cuda.empty_cache()

    # The same small model, f32 compute, on the card (kernels) and on the
    # CPU (plain versions): the port's whole path against its reference.
    scfg = dataclasses.replace(get_smoke_config("llama3.2-1b"),
                               compute_dtype="float32")
    sp_cpu = M.init_params(scfg, SEED, "cpu")
    sp_gpu = {"embed": sp_cpu["embed"].to(dev),
              "final_norm": {"scale": sp_cpu["final_norm"]["scale"].to(dev)},
              "blocks": [{name: {w: t.to(dev) for w, t in sub.items()}
                          for name, sub in blk.items()}
                         for blk in sp_cpu["blocks"]]}
    tokens = torch.randint(0, scfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(3))
    fwd = serve.make_pruned_forward(scfg)
    for method in ("rowsplit", "merge"):
        pol = PlanPolicy(method=method)
        with torch.no_grad():
            want = fwd(sp_cpu, serve.prune_ffn_blocks(sp_cpu, scfg, KEEP,
                                                      pol), tokens)
            got = fwd(sp_gpu, serve.prune_ffn_blocks(sp_gpu, scfg, KEEP,
                                                     pol), tokens.to(dev))
        err = (got.cpu() - want).abs().max().item()
        print(f"smoke model f32, {method}: card vs CPU max |d| {err:.3e} "
              f"(tol rtol {SMOKE_TOL['rtol']} atol {SMOKE_TOL['atol']})")
        torch.testing.assert_close(got.cpu(), want, **SMOKE_TOL)
    done("serving", t0)

    # --------------------------------------------------------- training --
    t0 = phase("training")
    train = training(cfg, dev, card, reset_counts, read_counts)
    done("training", t0)

    # ---------------------------------------------------------- summary --
    rows = []
    for kname, kspec in KERNELS.items():
        acc = per_layer[kname]
        row = {
            "name": kname, "route": "cuda", "source": kspec["source"],
            "replaces": kspec["replaces"],
            "launches": serving[kname] + train[kname],
            "launches_serving": serving[kname],
            "launches_training": train[kname],
            "max_abs_err": worst[kname], "ms": acc["ms"],
            "plain_ms": acc["plain_ms"], "bound_ms": acc["bound_ms"],
            "bound_by": acc["bound_by"], "library_ms": acc["library_ms"]}
        if kname == "merge_spmm":
            row["backward_dB"] = backward["merge_dB"]
        rows.append(row)
    print("(ms, plain_ms, bound_ms, library_ms: one FFN layer's three "
          "matrices at n=128 f32 — the forward SpMM for rowsplit_spmm and "
          "merge_spmm, the values cotangent for sddmm, dB = A^T g on the "
          "transpose plan in merge_spmm's backward_dB; launches: the "
          f"serving runs ({forwards} forwards of each method) plus the "
          f"training runs ({TRAIN_STEPS} steps of each method); "
          "max_abs_err: worst parity case, forward and gradient)")
    print(json.dumps({"kernels": rows}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
