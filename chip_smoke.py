#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Run from the repository root, with no arguments, on a machine with one
NVIDIA H100 (sm_90a) and the CUDA toolkit.  Phases, each timed:

1. build   — compile the hand-written CUDA kernels from ``src/repro_torch/
             csrc`` with nvcc (printing what ptxas reports);
2. parity  — hold each kernel against its plain PyTorch version on the
             card: the six matrix kinds of the reference's kernel tests and
             the two Llama-3.2-1B FFN shapes, n in {1, 32, 128, 160}, f32
             and bf16, three epilogues, 2-D and batched B;
3. timing  — at the serving path's shapes: kernel, plain version, cuSPARSE
             (``torch.sparse.mm``, a yardstick the port never calls) and
             the least time the card could take;
4. serving — ``serve_pruned`` on Llama-3.2-1B at full width (16 layers,
             random weights from a seed), batch 4 x prompt 32, keep 0.25,
             once with the §5.4 rule (row-split) and once forcing merge,
             with launch counts, plans built while serving, and the two
             runs' logits compared; plus the smoke config on the card
             against the same model on the CPU;
5. summary — a ``kernels`` JSON line, the card's name and power limit, and
             last the ``{"ok": true, ...}`` line.

Exits non-zero, printing no result, when torch sees no CUDA device, when
the package is not beside this script, or when any phase fails.
"""
from __future__ import annotations

import dataclasses
import json
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


def profile_forward(fwd, params, blocks, prompt, top=8) -> float:
    """Device time of one warm forward by kernel (torch.profiler, device
    events only: a CPU op's own device time repeats its kernels'); prints
    the largest kernels and returns the total device ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with torch.no_grad():
        fwd(params, blocks, prompt)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fwd(params, blocks, prompt)
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
    from repro_torch.kernels import _cuda, merge_spmm, ops, rowsplit_spmm
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
    eps = {"none": None,
           "bias+gelu": Epilogue(bias=True, activation="gelu"),
           "relu+scale+residual": Epilogue(activation="relu", scale=0.5,
                                           residual=True)}
    for kname, kspec in KERNELS.items():
        method = kspec["method"]
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
    done("parity", t0)

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
                 for name in KERNELS}
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
        for kname, kspec in KERNELS.items():
            method = kspec["method"]
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
    launches, logits = {}, {}
    for kname, method in (("rowsplit_spmm", "auto"),
                          ("merge_spmm", "merge")):
        for mod in counters.values():
            mod.LAUNCHES = 0
        merge_spmm.EPILOGUE_LAUNCHES = 0
        rep = serve.serve_pruned(cfg, params, prompt, KEEP,
                                 policy=PlanPolicy(method=method))
        counts = {f"{k}_spmm": mod.LAUNCHES for k, mod in counters.items()}
        epilogues = merge_spmm.EPILOGUE_LAUNCHES
        launches[kname] = counts[kname]
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
        dev_ms = profile_forward(serve.make_pruned_forward(cfg), params,
                                 blocks, prompt)
        print(f"profile method={method}: device busy {dev_ms:.3f} ms of the "
              f"{rep.warm_s * 1e3:.2f} ms warm forward (idle share "
              f"{1 - dev_ms / (rep.warm_s * 1e3):.3f}); {card}")
        del rep, blocks
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

    # ---------------------------------------------------------- summary --
    rows = []
    for kname, kspec in KERNELS.items():
        acc = per_layer[kname]
        rows.append({
            "name": kname, "route": "cuda", "source": kspec["source"],
            "replaces": kspec["replaces"], "launches": launches[kname],
            "max_abs_err": worst[kname], "ms": acc["ms"],
            "plain_ms": acc["plain_ms"], "bound_ms": acc["bound_ms"],
            "bound_by": acc["bound_by"], "library_ms": acc["library_ms"]})
    print("(ms, plain_ms, bound_ms, library_ms: one FFN layer's three "
          "SpMMs at n=128 f32; launches: the serving run of that method, "
          f"{forwards} forwards; max_abs_err: worst parity case)")
    print(json.dumps({"kernels": rows}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
