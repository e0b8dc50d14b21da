#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Run from the repository root, with no arguments, on a machine with one
NVIDIA H100 (sm_90a) and the CUDA toolkit.  Phases, each timed:

1. build    — compile the hand-written CUDA kernels from ``src/repro_torch/
              csrc`` with nvcc (printing what ptxas reports, the row-split,
              SDDMM and merge kernels' three bodies', the flash attention
              wgmma body's and the grouped GEMM's three bodies' registers,
              spills and shared memory; the f32 vector bodies of row-split
              and the SDDMM and the grouped GEMM's wgmma body must not
              spill);
2. parity   — hold each kernel against its plain PyTorch version on the
              card: the six matrix kinds of the reference's kernel tests,
              the two Llama-3.2-1B FFN shapes, a 0-nnz pattern (every row
              epilogue(0)) and merge's schedule edges (rows of 2200-4100
              nonzeros; 16 rows then 1084 empty ones), the SpMMs at n in
              {1, 8, 16, 32, 64, 128, 160} (the SDDMM at {1, 32, 128,
              160}), f32 and bf16, 2-D and batched; the SpMMs with three
              epilogues; every SpMM and SDDMM call bit-identical to a
              second one and its body (f32x4, bf16x8, scalar) held to
              ``_cuda.body_for``; row-split also with each row split in
              each other number of parts of 1, 2 and 8; merge on rows
              across three or more of its workers and on workers with no
              live slot; the grouped GEMM on the
              reference's sweep, a ragged case, the wgmma body's edges
              (d_in past a 64-deep stage, d_out past a 128-column tile
              and a weight box wholly past d_out, two row tiles a block,
              skewed sizes with empty experts, a tail block past the last
              group) and OLMoE's two full-width
              shapes with skewed group sizes, f32 and bf16, each call's
              body (wgmma, wmma, simt) held to ``moe_gemm.body_for``;
3. grad     — ``execute_plan`` under autograd, kernels against plain
              versions: dvals, dB, d_bias and d_res, both methods, three
              epilogues, 2-D and batched B, with the backward's launches;
4. timing   — at the serving path's shapes: kernel, plain version, the
              cuSPARSE call (``torch.sparse.mm`` / ``sampled_addmm``, a
              yardstick the port never calls), the least time the card
              could take and the rate of B rows gathered, for the forward
              SpMMs (row-split with its parts r, and r = 1 beside) and the
              backward's SDDMM and dB (merge on the transpose plan); the
              device operations of one merge call (its range kernel and
              fix-up, no fill or memset);
              merge, row-split, rowgroup and ``torch.sparse.mm`` on a
              skewed power-law matrix (rowgroup, one row-split launch a
              length bucket, held to its plain version, its buckets and
              their row parts printed; the others to the library call); the
              grouped GEMM at the
              MoE path's shapes against ``torch.bmm`` and its bound;
5. serving  — ``serve_pruned`` on Llama-3.2-1B at full width (16 layers,
              random weights from a seed), batch 4 x prompt 32, keep 0.25,
              once with the §5.4 rule (row-split), once forcing merge and
              once forcing rowgroup (its length buckets printed; one a
              matrix, so its logits equal row-split's bit for bit), with
              launch counts, plans built while serving, the SpMMs' device
              time, and the runs' logits compared; plus the smoke config
              on the card against the same model on the CPU;
   online   — ``serve_online`` on the same model and params: 9 bucket
              programs (lengths 8/16/32 x batches 1/2/4), each a CUDA
              graph, with its capture seconds; 64 Poisson requests of
              lengths 8-32 at the auto rate (ok/shed/error, req/s, p50,
              p99, recompiles and plans built after warmup, both 0); per
              bucket the row-split kernel against its plain version on the
              served plans of the first and last layers at the bucket's
              width, and the eager forward against the graph replay (host
              ms synchronised and device busy, each replay bit-equal to the
              eager forward); every request of the load run held bit for
              bit to the eager forward of the bucket matrix it was packed
              in and, packed with others, to a solo forward within the
              serving bars; ``serve_pruned(..., microbatch=2)`` held to the
              unbatched logits;
   tune     — the autotuner (``repro_torch.tune``) on the card: every
              method's kernel held to its plain version on the ``paper``
              suite, then ``tune_suite`` over it (merge t 8/16/32,
              row-split pads, rowgroup) into a TuneDB keyed on the card,
              and ``tune_pattern`` on card-sized crossover matrices
              (uniform, irregular, power-law, banded and block-sparse
              families, layer 0's pruned Llama FFN matrices, the power-law
              matrix above), each row-split ELL's bytes printed first,
              each method's kernel held to its plain version at every
              candidate the tuner times; per matrix each method's µs, the
              winner and ``torch.sparse.mm``;
              the threshold calibrated on the card and its agreement
              against the paper's 9.35; geomean and peak speedup over
              ``torch.sparse.mm`` of the oracle, §5.4 and calibrated picks;
              the served model's 48 FFN patterns tuned, the DB loaded with
              ``engine.load_tunedb`` and ``serve_pruned`` run twice through
              the ladder (48 exact hits, 0 plans built while serving,
              logits bit-equal to the forced method's run, the eager warm
              forward beside row-split forced); ``python -m
              repro_torch.tune --suite mini`` and ``python -m
              repro_torch.launch.serve --prune-ffn 0.25 --tunedb`` on the
              card; the power-law matrix's DB pick against the §5.4 pick;
6. training — sparse fine-tuning of layer 0's pruned FFN at full width
              (``make_sparse_train_step``, 5 SGD steps toward the dense
              FFN's output) for both methods: losses, step times, device
              busy share and the SDDMMs' device time, peak memory, plans
              built, launches per step and their bodies, and the kernel
              step's gradients against the plain step's;
   dense    — the dense trainer (``runtime.steps.make_train_step``):
   training   Llama-3.2-1B at full width (16 layers, random f32 params
              from a seed, bf16 compute, SyntheticLM 8 x 128, AdamW lr
              3e-4 warmup 20, remat, loss chunk 128): the state reckoned
              against the card, one warm step and 5 timed (host ms, loss,
              nll, grad norm, lr, skipped 0), tokens/s, device busy and
              idle share of a profiled step with its top device ops, the
              chunked loss's f32 logits alone, peak memory, the
              optimizer's bytes and the matmuls' work as floors; 10 steps
              on one fixed batch at lr 1e-3 (the loss must fall);
              OLMoE-1B-7B cut to 2 of 16 layers (3 steps, 0 grouped-GEMM
              launches, every expert weight's gradient non-zero); both
              smoke configs one step on the card against the CPU
              (microbatches 1 and 2, int8 error feedback on and off, bf16
              bar); smoke Llama saved, restored bit-equal into a fresh
              state and resumed against a straight run; ``python -m
              repro_torch.launch.train`` at full width (3 steps) and
              twice at smoke size on one checkpoint directory (the second
              resumes); none of the five kernels may launch;
7. attention — the flash attention kernel against its plain version on
              the reference's sweep, its ragged case, the wgmma body's tile
              edges (ragged s at b = 2, s = 129, GQA g = 4 at dh 128) and
              the two served models' prefill shapes (4 x 32 and 1 x 2048),
              f32 and bf16, each call's body (wgmma, mma_sync, simt) held
              to ``flash_attention.body_for``; the main path,
              ``ops.flash_attention`` on Llama-3.2-1B's and OLMoE-1B-7B's
              full-width layer-0 q/k/v, one wgmma launch a call, held
              against the model path's ``layers.causal_attention``;
              kernel, plain version, ``scaled_dot_product_attention`` (a
              yardstick the port never calls; default dispatch, and each
              backend it accepts) and the bound at 4 x 32, Llama 1 x 8192
              and OLMoE 1 x 4096, bf16 and f32;
8. decode   — ``generate`` (prefill + 16 greedy decode steps) of
              OLMoE-1B-7B at full width (16 layers, 64 experts top-8,
              random weights from a seed, bf16 compute), batch 4 x prompt
              32, its MoE FFNs through the grouped GEMM kernel: prefill and
              decode-step times, tokens/s, launches per forward and over
              the run (all wgmma), peak memory, a profiled decode step and
              the grouped GEMM's share of it; layers 0 and
              15 held against the plain version on their own inputs; the
              smoke OLMoE on the card against the CPU (the same tokens);
              and Llama-3.2-1B's ``generate`` (the GQA decode path) timed;
9. archs    — the other eight architectures at published widths (random
              weights from a seed, f32 params, bf16 compute):
              RecurrentGemma-2B at full depth, ``serve_pruned`` batch 4 x
              prompt 32 at keep 0.25 by the §5.4 rule (row-split) and with
              merge forced, through the serving phase's loop (78 launches a
              forward each, all f32x4, 0 plans built while serving, warm
              forward, the SpMMs' device ms a layer, device busy, peak
              memory); the served plans of layers 0 and 25 held against
              their plain versions at the parity bar, the smoke model's
              pruned forward card vs CPU, the two methods at f32 compute
              (their bf16 gap printed); then a dense ``generate`` 1 x 3072
              x 16 past its 2048 local window; Mamba2-1.3B at full depth,
              ``generate`` 4 x 512 x 16 (four SSD chunks), a profiled
              decode step (busy, idle share); Mixtral-8x22B cut to 2 of 56
              layers, ``generate`` 4 x 32 x 4 through the grouped GEMM (6
              launches a forward, all wgmma), both MoE blocks held against
              the plain version (bf16 and f32), and the capacity drops and
              routing flips that part its 4-row prefill from the full
              forward; Granite-3-2B and MusicGen-large at full depth,
              Command-R-35B, Qwen2-72B and InternVL2-76B cut to 2 layers
              (MusicGen and InternVL2 on seeded embeddings), with times and
              peak memory.  Every model's prefill and decode steps are held
              to teacher forcing: f32 at 3e-2, bf16 below 0.1 relative
              Frobenius (the MoE cut at f32 only, on one row), a bar that
              cuts of Mamba2 and Granite at 2 to 48 layers show stands
              between the sound gap and injected faults.  Last, the eight
              smoke configs at f32 on the card against the CPU (logits and
              caches);
10. obs      — observability and plan verification (``repro_torch.obs``,
              ``repro_torch.analysis``): the card's copy-scale roof
              (``obs.measure_roof``) against the data sheet's 3.35 TB/s;
              the accountant fed with the timing and attention phases'
              kernel medians and the reference's byte models, its report,
              each kernel's roof fraction and bound at the measured roof;
              Llama-3.2-1B ``serve_pruned`` from a cold plan cache under
              ``obs.tracing()`` with ``REPRO_VERIFY_PLANS`` on (48 plans
              resolved, built and verified, 0 findings, ms a plan; 48
              ``dispatch`` events a forward; the serve.* spans; the trace
              validated), the warm forward's host ms and a dispatch's host
              µs with tracing off and on, a ``torch.profiler`` capture of a
              warm forward (``serve.forward_warm`` and 48
              ``spmm_rowsplit_cuda`` ranges,
              each over a kernel launch); ``serve_online`` of 16 requests
              under trace and verification (9 graphs captured, replays and
              requests bit-equal to the eager forward, events counted, every
              dispatch row-split on ``cuda``, its launches counted and held
              to row-split alone, metrics validated); ``planlint --suite
              mini`` on the card;
              the train CLI with ``--trace-out`` / ``--metrics-out``;
11. analysis — (in a process of its own, whose profiler capture is its
              first) the CUDA launch models (``repro_torch.kernels.
              introspect``) held against the card: row-split at
              Llama-3.2-1B layer 0's
              w1, w3, w2 (n = 128, f32, and w1 in bf16), rowgroup's
              buckets, merge's range kernel and fix-up and the SDDMM on
              the same matrices, the grouped GEMM's wgmma body at
              OLMoE-1B-7B's two layer shapes (bf16) and flash attention's
              wgmma body at Llama-3.2-1B 1 x 2048 (bf16), each launched
              once under ``torch.profiler``, each call in its own range:
              the port's kernels in a call's range equal, in order, its
              models, none left over; the trace's grid, block and
              shared memory equal to the model's, its registers equal to
              ``cuobjdump -res-usage``'s and times the block and the
              ``__launch_bounds__`` blocks within an SM's 65,536, the
              static shared memory it reports equal to the model's; each
              launch's requested
              bytes, their ratio to its compulsory bytes and the request
              rate over its CUDA-event time; ``python -m
              repro_torch.analysis all`` on the card (lint, planlint,
              audit, ``traffic --check``, exit 0);
12. sharded — nnz-balanced sharded SpMM (``repro_torch.distributed.
              spmm``): Llama-3.2-1B at full width, keep 0.25, batch 4 x
              prompt 32, every pruned-FFN weight in 4 shards by rows, then
              by cols, on the per-shard loop (each shard's methods and nnz
              imbalance, launches a forward, warm forward host ms, device
              busy and idle share beside the unsharded forward's, the
              logits within the serving bars and at f32 within 2e-5, the
              bits printed); layer 0's pruned FFN trained 5 SGD steps
              through 2 shards by rows and by cols (SDDMM and merge-dB
              launches, dvals and dB against the unsharded plans' at rtol
              1e-4 / atol 1e-5 of the gradient's max); 2 ranks on the one card over gloo
              (``spmd_child``: each layer-0 matrix by rows and cols,
              forward and backward, the SPMD path against the loop path),
              then ``serve_online`` over the 2 ranks in lockstep on
              Llama-3.2-1B at full width (24 Poisson requests at the auto
              rate, eager buckets over gloo; every served request's rows
              against the unsharded eager forward of its bucket matrix
              within the serving bars, every rank's bucket sequence the
              leader's, 0 programs and 0 plans built after warmup, each
              rank's row-split launches 48 a forward), then ``torchrun
              --nproc-per-node 2 -m repro_torch.launch.serve --prune-ffn
              0.25 --mesh 2`` at full width against the unsharded logits
              and ``... --serve --mesh 2`` (24/24 ok, 0 recompiles, 0
              plans built while serving); the power law in 4 row
              shards by the §5.4 rule (each shard's method, uniform,
              device ms against unsharded row-split and merge, C against
              the plain version and the unsharded merge C); an OLMoE-1B-7B MoE layer at
              ``moe_groups`` 4 against its plain version and ``moe_groups``
              0.  ``python3 chip_smoke.py --sharded-only`` runs the build
              and this phase alone; the sharded training's dvals are also
              held, sharded and unsharded, against float64 dvals;
13. model_parallel — Llama-3.2-1B at full width pruned at 0.25, one
              prompt of 32,768 tokens (``prefill_32k``'s sequence) through
              ``serve.prune_ffn_blocks`` and ``serve.generate`` (the
              prefill, then 4 greedy tokens), its SpMM launches by kernel
              and body counted from 0, the prefill's host ms and device
              span, the peak memory (under 24 GB); layer 0's w1 at n =
              32,768 by row-split and merge against their plain versions
              and the 2·nnz·n bound; the blockwise ``layers.
              flash_attention`` on layer 0's q/k/v at 1 x 8192 against
              the flash kernel (bf16) and the unchunked formula (f32);
              four gloo ranks on the one card (``mesh_child``) in a 2 x 2
              mesh, ``launch.dryrun.build_step_and_shardings`` for
              train_4k's kind on Llama-3.2-1B cut to 2 layers (f32),
              the gradients and 2 steps' losses against the one-process
              step, then the state resharded 2 x 2 -> 4 x 1 -> 2 x 2 bit
              for bit; and ``python -m repro_torch.launch.dryrun`` on two
              cells in child processes (the host's CPU, a fake group),
              each cell's per-rank bytes.  ``python3 chip_smoke.py
              --model-parallel-only`` runs the build and this phase alone;
14. summary — a ``kernels`` JSON line (each row with its roof fraction
              and its launch model), the card's name and power limit, and
              last the ``{"ok": true, ...}`` line.

Exits non-zero, printing no result, when torch sees no CUDA device, when
the package is not beside this script, or when any phase fails.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
import warnings

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# Kernel vs plain version on the same card and inputs.  f32: the
# reference's 2e-5 (both sum in f32, in other orders — the merge kernel
# sums a row's partials range by range, then its split rows' partials in
# worker order; the plain version scatter-adds).  bf16 outputs: 2e-2, one
# bf16 rounding (2^-8 relative) of f32 sums that differ in the last bits.
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
# B widths of the SpMM parity: 1, the online path's n = batch x length of
# its buckets (8, 16, 32, 64, 128), and 160, past one 128-column slice.
PARITY_N = (1, 8, 16, 32, 64, 128, 160)
# Llama-3.2-1B logits of the row-split run vs the merge run: the SpMMs are
# f32 in both, but the bf16 residual stream rounds each layer's output
# (2^-8 relative), so a last-bit difference of one SpMM can flip a bf16
# rounding and travel through 16 layers.  |logits| ~ 1 after the final
# norm.
SERVE_TOL = dict(max_abs=0.25, rel_fro=2e-2)
# Rowgroup's kernels vs its plain version on the power-law matrix, and
# every method's kernel vs its plain version on the paper suite (the tune
# phase): f32 sums of up to 11,853 products in other orders (the kernel's
# slots 32 at a time in r parts, the plain version's batched dot
# products).  The error of such a sum grows with the row's magnitude, not
# the element's, so the absolute part is 2e-5 of the largest |C|: on the
# paper suite's heavy-tailed graph (rows up to 2048, |C| up to ~150) the
# plain f32 version itself lies 1.3e-4 from a float64 sum.
POWER_LAW_TOL = dict(rtol=2e-5, atol_of_max=2e-5)
# The online phase: the reference serve CLI's --serve path at batch 4 x
# prompt 32 (buckets 8/16/32 x 1/2/4), 64 Poisson requests of lengths
# 8-32 (prompt / 4 to prompt) at the auto rate.
ONLINE_REQUESTS = 64
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
# 2048 (dB of w1) products summed in other orders (dB's by the merge
# kernel's ranges and split-row fix-up, in the same order on every call).
# bf16: one bf16 rounding of the forward and of each cotangent.
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
BF16_FLOP_PER_S = 989e12       # H100 SXM, bf16 tensor cores, dense

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
GEN_LEN = 16                   # the reference serve CLI's --gen default

# The skewed matrix of the timing phase: power_law_csr (the reference's
# power_law recipe) at m = k = 262,144 with mean row length 16, about as
# many nonzeros as one Llama FFN matrix, held to nothing.
POWER_LAW = dict(seed=SEED, m=262_144, d=16, alpha=1.6)

# The tune phase.  The reference's corpus suites are sized for CPU timing
# and launch-bound on the card, so the §5.4 crossover is also measured on
# card-sized matrices of the same generators, name -> (generator, args,
# kwargs), at B (k, CROSS_N) f32: uniform and uniform_irregular at
# 131,072², d 1-64; power_law (alpha 1.6) at 65,536², d 2-32 (its
# row-split ELL grows with the longest row: at 131,072 rows and d 32 it
# would take ~25 GB, so that size is left out); banded 131,072², half-width
# 1/4/16; block_sparse 8192², blocks of 8 and 16, keep 0.1 and 0.25.  The
# Llama-3.2-1B FFN matrices (layer 0's w1 and w2 as serving prunes them)
# and the timing phase's power-law matrix join them at the serving width.
CROSS_M, CROSS_N = 131_072, 64
TUNE_WARMUP, TUNE_REPEAT = 2, 5     # timed graph replays a tune candidate
PLAIN_BLOCK_BYTES = 2**31           # row-split's plain gather, a row block
CROSSOVER = {
    **{f"uniform_131k_d{d}": ("uniform", (60 + i, CROSS_M, CROSS_M, d), {})
       for i, d in enumerate((1, 2, 4, 8, 16, 32, 64))},
    **{f"uniform_irr_131k_d{d}": ("uniform_irregular",
                                  (70 + i, CROSS_M, CROSS_M, d), {})
       for i, d in enumerate((1, 2, 4, 8, 16, 32, 64))},
    **{f"powlaw_65k_d{d}": ("power_law", (7, 65_536, 65_536, d), {})
       for d in (2, 4, 8, 16, 32)},
    **{f"banded_131k_b{b}": ("banded", (90 + i, CROSS_M, CROSS_M, b), {})
       for i, b in enumerate((1, 4, 16))},
    **{f"block{blk}_8k_keep{keep}": ("block_sparse", (95 + i, 8192, 8192),
                                     dict(block=blk, keep=keep))
       for i, (blk, keep) in enumerate(((8, 0.1), (8, 0.25), (16, 0.1),
                                        (16, 0.25)))},
}

# The grouped GEMM: the reference's sweep (tests/test_kernels.py, sizes,
# d_in, d_out at tt 8) and OLMoE-1B-7B's two shapes — w1/w3 (d_model ->
# d_ff) and w2 (d_ff -> d_model) over 64 experts x one 64-token block.
MOE_SWEEP = [((64, 0, 64, 128), 64, 96), ((8, 8, 8, 8), 16, 16),
             ((256,), 32, 48)]
MOE_EXPERTS, MOE_TT, MOE_TOKENS = 64, 64, 4096
# The wgmma body's edges: name -> (sizes, d_in, d_out, tt, tokens or None
# for the sizes' sum).  Stages are 64 deep and items 64 rows x 128 columns
# (two 64-column weight boxes; at d_out 136 the last item's second box
# lies wholly past d_out and is not loaded).
MOE_EDGES = {
    "wgmma d_in 2056": ((64, 0, 128, 64), 2056, 256, 64, None),
    "wgmma d_out 200": ((128, 64, 0, 64), 512, 200, 64, None),
    "wgmma d_out 136 (box past)": ((64, 64), 256, 136, 64, None),
    "wgmma tt 128": ((256, 0, 128, 128), 1024, 384, 128, None),
    "wgmma skewed, empty experts": ((320, 0, 0, 64, 0, 128, 0, 0), 1024,
                                    512, 64, None),
    "wgmma tail past last group": ((64, 0, 128), 512, 256, 64, 384),
}
MOE_FULL = [(2048, 1024), (1024, 2048)]
MOE_HOLD_LAYERS = (0, 15)
# moe_apply through the kernel vs through its plain version, on the same h
# (so the same routing): bf16 compute — three bf16 GEMM outputs and the
# bf16 scatter-add (atomics on the card) round in other places, 2e-2; f32
# compute — the reference's MoE tolerance (tests/test_models.py), 2e-4.
MOE_TOL = {"bfloat16": dict(rtol=2e-2, atol=2e-2),
           "float32": dict(rtol=2e-4, atol=2e-4)}

# Flash attention, (b, s, h, kv, dh): the reference's sweep and ragged
# case (tests/test_flash_kernel.py), the wgmma body's tile edges (query
# tiles of 192 rows at dh 64 and 128 at dh 128, key tiles of 128; a ragged
# s at b = 2, which TMA zero-fills without reading the next batch; s = 129,
# one key past a tile; GQA g = 4 at dh 128), the two served models'
# prefill shapes at batch 4 x prompt 32 (Llama-3.2-1B: 32 query / 8 KV
# heads of 64; OLMoE-1B-7B: 16 heads of 128) and both at batch 1 x 2048.
FLASH_PARITY = [
    ("sweep MHA", (1, 256, 4, 4, 64)),
    ("sweep GQA g=2", (2, 128, 4, 2, 32)),
    ("sweep GQA g=4", (1, 384, 8, 2, 64)),
    ("ragged s", (1, 200, 4, 4, 32)),
    ("ragged s b2 dh64", (2, 200, 8, 2, 64)),
    ("ragged s b2 dh128", (2, 333, 16, 16, 128)),
    ("s 129 dh64", (2, 129, 8, 2, 64)),
    ("s 129 dh128", (2, 129, 8, 2, 128)),
    ("GQA g=4 dh128", (1, 384, 8, 2, 128)),
    ("llama3.2-1b 4x32", (4, 32, 32, 8, 64)),
    ("olmoe-1b-7b 4x32", (4, 32, 16, 16, 128)),
    ("llama3.2-1b 1x2048", (1, 2048, 32, 8, 64)),
    ("olmoe-1b-7b 1x2048", (1, 2048, 16, 16, 128)),
]
# The kernel vs its plain version, and vs the model path's attention: the
# reference's tolerances (tests/test_flash_kernel.py).  f32 2e-5: both sum
# in f32, in other orders.  bf16 3e-2: the kernel rounds p to bf16 against
# a running max, the plain version against the row's final max, and the
# output is rounded to bf16.
FLASH_TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
             "bfloat16": dict(rtol=3e-2, atol=3e-2)}
# The main path: layer 0's q/k/v of each model at batch x prompt.
FLASH_MODEL_SHAPES = ((4, 32), (1, 2048))
# Timing: (model, batch, s) — the served prefill, and long prefills.
FLASH_TIMING = [("llama3.2-1b", 4, 32), ("olmoe-1b-7b", 4, 32),
                ("llama3.2-1b", 1, 8192), ("olmoe-1b-7b", 1, 4096)]
FLASH_SUMMARY = ("llama3.2-1b", 1, 8192, "bfloat16")
# The softmax's second limit: one exp per score at 16 a clock on each of
# the 132 SMs at the H100 SXM's 1.98 GHz boost clock (data sheet).
SM_COUNT, EXP_PER_CLOCK, SM_CLOCK_HZ = 132, 16, 1.98e9

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
    "moe_gemm": dict(
        method=None, source="src/repro_torch/csrc/moe_gemm.cu",
        replaces="src/repro/kernels/moe_gemm.py:40"),
    "flash_attention": dict(
        method=None, source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:33"),
}

# The kernel a plan method's forward launches (rowgroup: row-split's).
KERNEL_OF = {"rowsplit": "rowsplit_spmm", "merge": "merge_spmm",
             "rowgroup": "rowsplit_spmm"}


def forward_launches(metas) -> collections.Counter:
    """The kernel launches of one forward through plans of ``metas``: one
    a plan, rowgroup's one a length bucket."""
    want = collections.Counter()
    for meta in metas:
        want[KERNEL_OF[meta.method]] += (len(meta.extra) if meta.method ==
                                         "rowgroup" else 1)
    return want


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


def device_ops(fn) -> list:
    """The device operations of one warm call of ``fn`` (torch.profiler,
    device events only: a CPU op's own device time repeats its kernels'),
    as (ms, count, name), largest first."""
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
    return sorted(rows, reverse=True)


def profile_device(fn, top=8, part=None):
    """Device time of one warm call of ``fn`` by kernel; prints the
    largest kernels and returns the total device ms, and with ``part`` also
    the ms of the kernels whose name holds ``part``."""
    rows = device_ops(fn)
    total = sum(r[0] for r in rows)
    for ms, count, name in rows[:top]:
        print(f"  device {ms:8.3f} ms  x{count:<4d} {name[:90]}")
    if not rows:
        print("  the profiler saw no device time")
    if part is None:
        return total
    return total, sum(r[0] for r in rows if part in r[2])


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


def gather_tb_s(nnz, n, itemsize, ms) -> str:
    """The rate at which a kernel gathers B rows (one row of n values a
    nonzero, from L2 where B fits it), as printed beside the bound."""
    return f"{nnz * n * itemsize / (ms * 1e-3) / 1e12:.2f} TB/s"


def logits_gap(got, want) -> tuple:
    """(max |d|, relative Frobenius |d| / |want|) of two logits tensors."""
    d = (got.float() - want.float()).abs()
    return d.max().item(), (torch.linalg.vector_norm(d) /
                            torch.linalg.vector_norm(want.float())).item()


def serve_gap(what, got, want) -> float:
    """Print the gap between two serving runs' logits and raise unless it
    is within SERVE_TOL; returns max |d|."""
    d, rel = logits_gap(got, want)
    print(f"{what}: max |d| {d:.4e}, relative Frobenius {rel:.4e}, max "
          f"|logit| {want.abs().max().item():.3f} (tol max_abs "
          f"{SERVE_TOL['max_abs']}, rel_fro {SERVE_TOL['rel_fro']})")
    if not (d <= SERVE_TOL["max_abs"] and rel <= SERVE_TOL["rel_fro"]):
        raise AssertionError(f"{what}: outside the serving bars")
    return d


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
            f"{what}: disagrees with its reference (tol {tol}): "
            f"{int(bad.sum())} of {g.numel()} elements, max |d| "
            f"{d.nan_to_num(float('inf')).max().item():.3e}")
    return d.max().item(), (d / (tol["atol"] + tol["rtol"] * w.abs())
                            ).max().item()


def schedule_facts(structure, nnz_pad, g):
    """For the merge kernel's ranges of ``g`` chunks: (the most workers
    whose ranges hold nonzeros of one row, the workers whose range holds no
    live slot)."""
    from repro_torch.kernels import merge_spmm
    n_chunks, t = structure["cols"].shape
    workers = -(-n_chunks // g)
    live = (structure["slot_nz"] < nnz_pad).reshape(-1)
    worker = torch.arange(n_chunks * t, device=live.device) // (t * g)
    rows = (structure["tile"].long()[:, None] * merge_spmm.TM
            + structure["lrow"].long()).reshape(-1)
    held = torch.bincount(worker[live], minlength=workers)
    pairs = torch.unique(rows[live] * workers + worker[live])
    span = int(torch.bincount(pairs // workers).max()) if pairs.numel() \
        else 0
    return span, int((held == 0).sum())


def check_body(what, mod, before, body, calls=1):
    """Raise unless the calls of kernel module ``mod`` (merge_spmm,
    rowsplit_spmm or sddmm) since ``before`` (a copy of its
    ``LAUNCHES_BY_BODY``) were ``calls`` launches of ``body``."""
    ran = {key: v - before.get(key, 0)
           for key, v in mod.LAUNCHES_BY_BODY.items()
           if v != before.get(key, 0)}
    if ran != {body: calls}:
        raise AssertionError(f"{what}: the kernel ran {ran}, expected "
                             f"{{{body!r}: {calls}}} (_cuda.body_for)")


def rowsplit_parts_call(fwd, vals, b, m, parts, kw):
    """The row-split kernel on ``b`` (..., k, n) with its rows split in
    ``parts`` (the op takes the rule's): as ``ops.rowsplit_execute`` folds
    the batch and the residual for the launch."""
    from repro_torch.kernels import rowsplit_spmm
    lead, (k, n) = tuple(b.shape[:-2]), b.shape[-2:]
    res = kw.get("residual")
    out = rowsplit_spmm.rowsplit_spmm_cuda(
        fwd, vals, b.reshape(-1, k, n), m, epilogue=kw.get("epilogue"),
        bias=kw.get("bias"),
        residual=None if res is None else res.reshape(-1, m, n).contiguous(),
        out_dtype=b.dtype, parts=parts)
    return out.reshape(lead + (m, n))


def profile_merge_call(fn) -> None:
    """The device operations of one merge call: exactly the range kernel
    and its fix-up, no fill or memset (the kernel zeroes nothing)."""
    rows = device_ops(fn)
    for ms, count, name in rows:
        print(f"  merge call, device {ms:8.4f} ms  x{count:<3d} {name[:100]}")
    names = [name for _, _, name in rows]
    bad = [name for name in names
           if "fill" in name.lower() or "memset" in name.lower()]
    if bad:
        raise AssertionError(f"a merge call fills or zeroes memory: {bad}")
    if sorted(count for _, count, _ in rows) != [1, 1] or not (
            any("merge_range_kernel" in x for x in names)
            and any("merge_fixup_kernel" in x for x in names)):
        raise AssertionError(f"a merge call ran {rows}, expected one range "
                             "kernel and one fix-up")


# Row-split's staged body where the benchmark runs it: C (batch, m, n) of
# w1 and w2 at the Granite backlog's 8 x 256 (Granite-3.0-2B's FFN widths
# are Llama-3.2-1B's), and k much larger than m at the Qwen2 backlog's
# 4 x 256 (Qwen2-72B's w2 width, 2048 rows: the fewest whose tiles fill
# the card); the plain version a block of STAGED_PLAIN_COLS columns at a
# time.
STAGED_PARITY = {"llama_w1": (8, 256), "llama_w2": (8, 256),
                 "qwen2_w2_2048": (4, 256)}
QWEN2_W2 = (2048, 29568)
STAGED_PLAIN_COLS = 64


def parity_staged(matrices, eps, dev) -> float:
    """The row-split op (``ops.rowsplit_execute``, as the model calls it)
    at STAGED_PARITY's launches, each epilogue: the rule must pick the
    staged body, its C must equal a second call's and the warp-per-row
    body's at one part bit for bit, and agree with the plain version at
    the f32 bar; raises otherwise; returns the worst |error|."""
    from repro_torch.core import PlanPolicy, build_plan
    from repro_torch.kernels import _cuda, ops, ref, rowsplit_spmm
    sms = _cuda.sm_count(dev)
    worst, seed = 0.0, 400
    for mname, (batch, n) in STAGED_PARITY.items():
        a = matrices[mname]
        plan = build_plan(a, PlanPolicy(method="rowsplit",
                                        with_transpose=False))
        m, k = a.shape
        if not rowsplit_spmm.use_staged("f32x4", plan.fwd["ascending"], m,
                                        n, batch, sms):
            raise AssertionError(f"staged parity {mname} {batch}x{n}: the "
                                 "rule does not pick the staged body")
        max_abs = ratio = 0.0
        for ename, ep in eps.items():
            seed += 1
            g = torch.Generator(device=dev).manual_seed(seed)
            b = torch.randn(batch, k, n, generator=g, device=dev)
            kw = dict(m=m, epilogue=ep)
            if ep is not None and ep.bias:
                kw["bias"] = torch.randn(m, generator=g, device=dev)
            if ep is not None and ep.residual:
                kw["residual"] = torch.randn(batch, m, n, generator=g,
                                             device=dev)
            what = f"staged parity {mname} {(m, k)} {batch}x{n} {ename}"
            by_body = dict(rowsplit_spmm.LAUNCHES_BY_BODY)
            got, again = (ops.rowsplit_execute(plan.fwd, a.vals, b,
                                               impl="cuda", **kw)
                          for _ in range(2))
            check_body(what, rowsplit_spmm, by_body, "staged", calls=2)
            by_body = dict(rowsplit_spmm.LAUNCHES_BY_BODY)
            row = rowsplit_parts_call(plan.fwd, a.vals, b, m, 1, kw)
            check_body(f"{what} r=1", rowsplit_spmm, by_body, "f32x4")
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"{what}: two calls differ")
            if not torch.equal(got, row):
                raise AssertionError(f"{what}: the staged body differs from "
                                     "the warp-per-row body at r=1")
            del again, row
            res = kw.pop("residual", None)
            for i in range(batch):
                for c in range(0, n, STAGED_PLAIN_COLS):
                    cs = slice(c, c + STAGED_PLAIN_COLS)
                    if res is not None:
                        kw["residual"] = res[i, :, cs]
                    want = ref.rowsplit_execute_ref(
                        plan.fwd, a.vals, b[i, :, cs], **kw)
                    d, r = check_close(f"{what} batch {i} columns {c}+",
                                       got[i, :, cs], want, TOL["float32"])
                    max_abs, ratio = max(max_abs, d), max(ratio, r)
            del got, want, b, res
        print(f"parity rowsplit staged {mname:13s} {(m, k)} {batch}x{n} "
              f"float32, epilogues {list(eps)}: the staged body by the "
              f"rule, bit-equal to a second call and to r=1; vs plain max "
              f"|d| {max_abs:.3e} (tol rtol {TOL['float32']['rtol']} atol "
              f"{TOL['float32']['atol']}; worst ratio {ratio:.3f})")
        worst = max(worst, max_abs)
    return worst


def parity_sddmm(matrices, dev) -> float:
    """The SDDMM kernel against its plain version on the card (through
    ``ops.sddmm``, one counted launch a call, its body held to
    ``_cuda.body_for``, bit-identical to a second call); raises on a
    disagreement or on a nonzero in a padded slot; returns the worst
    |error|."""
    from repro_torch.core import PlanPolicy, build_plan
    from repro_torch.kernels import _cuda, ops, sddmm
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
            bodies = {}
            for n in (1, 32, 128, 160):
                for lead in ((), (2,)):
                    seed += 1
                    g = torch.Generator(device=dev).manual_seed(seed)
                    dc = torch.randn(lead + (m, n), generator=g,
                                     device=dev).to(dt)
                    b = torch.randn(lead + (k, n), generator=g,
                                    device=dev).to(dt)
                    what = f"sddmm {mname} {dt} n={n} batch={lead}"
                    before = sddmm.LAUNCHES
                    by_body = dict(sddmm.LAUNCHES_BY_BODY)
                    got = ops.sddmm(*coords, dc, b, impl="cuda")
                    if sddmm.LAUNCHES - before != 1:
                        raise AssertionError(
                            f"{what}: counted "
                            f"{sddmm.LAUNCHES - before} launches, expected 1")
                    body = _cuda.body_for(dt, n)
                    check_body(what, sddmm, by_body, body)
                    bodies[body] = bodies.get(body, 0) + 1
                    again = ops.sddmm(*coords, dc, b, impl="cuda")
                    want = ops.sddmm(*coords, dc, b, impl="torch")
                    torch.cuda.synchronize()
                    if not torch.equal(got, again):
                        raise AssertionError(f"{what}: two calls on the same "
                                             "inputs differ")
                    if got[..., pad].any():
                        raise AssertionError(
                            f"sddmm {mname}: nonzero dvals in a padded slot")
                    d, r = check_close(what, got, want, tol)
                    max_abs, ratio = max(max_abs, d), max(ratio, r)
                    cases += 1
            print(f"parity sddmm         {mname:13s} {a.shape} {str(dt):14s} "
                  f"cases {cases}: max_abs {max_abs:.3e} (tol rtol "
                  f"{tol['rtol']} atol {tol['atol']}; worst |d|/(atol+rtol"
                  f"|want|) {ratio:.3f}); padded slots "
                  f"{int(pad.sum())}, all 0; bodies {bodies}, each call "
                  "bit-identical to a second one")
            worst = max(worst, max_abs)
    return worst


def parity_grad(matrices, eps, dev, read_counts) -> dict:
    """``execute_plan`` under autograd, impl="cuda" against impl="torch":
    dvals, dB, d_bias and d_res.  Checks that one backward needing dvals
    and dB launches 1 merge (transpose plan; its range kernel and fix-up)
    and 1 SDDMM.  Returns the worst |error| of dvals (the SDDMM) and dB
    (the merge kernel)."""
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
                            want = dict.fromkeys(ran, 0)
                            if impl == "cuda":
                                want.update(merge_spmm=1, sddmm=1)
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
          "the transpose plan (range kernel + fix-up) + 1 SDDMM, checked on "
          "every case")
    return worst


def timing_backward(llama_matrix, dev, card, calls) -> dict:
    """The backward's kernels at the training path's shapes (n = 128, f32):
    the SDDMM (dvals) and dB = Aᵀ·g by the merge kernel on the transpose
    plan, each with its plain version, the cuSPARSE call and the
    function's bound, per matrix and per FFN layer (w1 + w3 + w2).
    ``calls[name]`` gets each matrix's (plan meta, kernel ms, uses) for
    the obs phase's accountant."""
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
                  f"kernel {k_ms:.4f} ms ({k_ms / bound:.1f}x bound), B rows "
                  f"gathered {gather_tb_s(nnz, n, 4, k_ms)}, plain "
                  f"{p_ms:.4f} ms, library {l_ms:.4f} ms, bound "
                  f"{bound:.6f} ms ({by}: {c['nbytes']} B, {flops} flop); "
                  f"{card}")
            calls.setdefault(name, []).append((plan.meta, k_ms, uses))
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


def timing_power_law(dev, card) -> dict:
    """Merge, row-split, rowgroup and ``torch.sparse.mm`` on a skewed
    matrix, where the merge path is meant to win: ``power_law_csr`` at
    POWER_LAW (about as many nonzeros as one Llama FFN matrix, row lengths
    from 1 to ~12 k), B (k, 128) f32.  Row-split's plan pads every row to
    the longest (~25 GB of ELL arrays, which the planner fills a block of
    rows at a time); rowgroup pads each length octave to its own longest
    and runs one row-split launch a bucket, held to its plain version.
    Timed and printed, each agreeing with the library call."""
    from repro_torch.core import PlanPolicy, build_plan, power_law_csr
    from repro_torch.kernels import (_cuda, merge_spmm, ops, rowgroup_spmm,
                                     rowsplit_spmm)
    seed, m, d, alpha = (POWER_LAW[x] for x in ("seed", "m", "d", "alpha"))
    n = SERVE_BATCH * SERVE_PROMPT
    t0 = time.perf_counter()
    a = power_law_csr(seed, m, m, d, alpha=alpha, device=dev)
    made_s = time.perf_counter() - t0
    nnz = a.nnz()
    lengths = a.row_lengths()
    longest = int(lengths.max())
    gen = torch.Generator(device=dev).manual_seed(50)
    b = torch.randn(m, n, generator=gen, device=dev)
    fwd = build_plan(a, PlanPolicy(method="merge",
                                   with_transpose=False)).fwd
    ell = build_plan(a, PlanPolicy(method="rowsplit",
                                   with_transpose=False)).fwd
    l = ell["cols"].shape[1]
    with warnings.catch_warnings():      # "beta state" notices
        warnings.simplefilter("ignore")
        sp = torch.sparse_csr_tensor(a.row_ptr, a.col_ind, a.vals, (m, m),
                                     check_invariants=True)
    t0 = time.perf_counter()
    rg = build_plan(a, PlanPolicy(method="rowgroup", with_transpose=False))
    rg_s = time.perf_counter() - t0
    sms = _cuda.sm_count(dev)
    buckets = [(m_g, l_g, rowsplit_spmm.row_parts(m_g, n, l_g, 1, sms))
               for m_g, l_g in rg.meta.extra]
    rg_bytes = sum(g[key].numel() * 4 for g in rg.fwd["groups"]
                   for key in ("cols", "slot_nz"))

    def rowgroup(impl):
        return rowgroup_spmm.rowgroup_execute_parts(
            rg.meta.extra, rg.fwd, a.vals, b, impl=impl)

    cases = {
        "merge": lambda: merge_spmm.merge_spmm_cuda(fwd, a.vals, b[None], m),
        "rowsplit": lambda: rowsplit_spmm.rowsplit_spmm_cuda(
            ell, a.vals, b[None], m),
        "rowgroup": lambda: rowgroup("cuda"),
        "library": lambda: torch.sparse.mm(sp, b),
    }
    lib = cases["library"]()
    for name in ("merge", "rowsplit"):
        got = cases[name]()[0]
        torch.cuda.synchronize()
        if not torch.allclose(got, lib, rtol=1e-3, atol=1e-3):
            raise AssertionError(f"power law: {name} disagrees with "
                                 "torch.sparse.mm")
    # Rowgroup: one counted row-split launch a bucket, held to its plain
    # version (and, like the others, to the library call).
    before = rowsplit_spmm.LAUNCHES
    got = rowgroup("cuda")
    launched = rowsplit_spmm.LAUNCHES - before
    want = rowgroup("torch")
    torch.cuda.synchronize()
    if launched != len(buckets):
        raise AssertionError(f"power law: rowgroup launched {launched} "
                             f"row-split kernels for {len(buckets)} buckets")
    tol = dict(rtol=POWER_LAW_TOL["rtol"], atol=POWER_LAW_TOL["atol_of_max"]
               * want.abs().max().item())
    rg_err, _ = check_close("power law rowgroup", got, want, tol)
    if not torch.allclose(got, lib, rtol=1e-3, atol=1e-3):
        raise AssertionError("power law: rowgroup disagrees with "
                             "torch.sparse.mm")
    plain_ms = time_ms(lambda: rowgroup("torch"), reps=3, inner=1)
    del got, want
    out = {name: time_ms(fn, reps=5, inner=5) for name, fn in cases.items()}
    nbytes = nnz * 8 + (m + 1) * 4 + 2 * m * n * 4
    t_b, t_o = nbytes / HBM_BYTES_PER_S, 2 * nnz * n / FP32_FLOP_PER_S
    out.update(bound_ms=max(t_b, t_o) * 1e3,
               bound_by="bytes" if t_b >= t_o else "operations", nnz=nnz,
               longest_row=longest, ell_width=l, rowgroup_plain_ms=plain_ms,
               rowgroup_max_abs_err=rg_err, rowgroup_buckets=buckets,
               rowgroup_ell_bytes=rg_bytes, rowsplit_ell_bytes=2 * m * l * 4)
    # Where rowgroup's time goes: each bucket's launch alone, and the
    # device operations of one call (the launches, the concatenation and
    # the un-permuting gather).
    bucket_ms = []
    for (m_g, l_g, r), gs in zip(buckets, rg.fwd["groups"]):
        ms = time_ms(lambda gs=gs, m_g=m_g: ops.rowsplit_execute(
            gs, a.vals, b, m=m_g, impl="cuda"), reps=5, inner=5)
        bucket_ms.append(ms)
        print(f"power law rowgroup bucket: {m_g} rows padded to {l_g} slots, "
              f"row parts r {r}: {ms:.4f} ms alone")
    out["rowgroup_bucket_ms"] = bucket_ms
    busy = profile_device(lambda: rowgroup("cuda"), top=6)
    print(f"power law rowgroup call: device busy {busy:.4f} ms, the buckets "
          f"alone {sum(bucket_ms):.4f} ms")
    print(f"power law rowgroup: {len(buckets)} buckets (plan {rg_s:.1f} s), "
          f"ELL {rg_bytes} B ({rg_bytes / 2**30:.3f} GiB) against row-split's "
          f"{2 * m * l * 4} B; {launched} row-split launches a call, held to "
          f"its plain version (max |d| {rg_err:.3e}, tol rtol "
          f"{tol['rtol']} atol {tol['atol']:.3e}); kernel "
          f"{out['rowgroup']:.4f} ms "
          f"({gather_tb_s(nnz, n, 4, out['rowgroup'])}), plain "
          f"{plain_ms:.4f} ms; {card}")
    print(f"power law {m} x {m} (seed {seed}, d {d}, alpha {alpha}; made in "
          f"{made_s:.1f} s on the host): nnz {nnz}, rows {int(lengths.min())}"
          f"-{longest} long (mean {nnz / m:.2f}), n {n} f32: merge "
          f"{out['merge']:.4f} ms ({gather_tb_s(nnz, n, 4, out['merge'])}), "
          f"row-split {out['rowsplit']:.4f} ms "
          f"({gather_tb_s(nnz, n, 4, out['rowsplit'])}; ELL {m} x {l}, "
          f"{2 * m * l * 4 / 2**30:.2f} GiB of plan arrays), "
          f"torch.sparse.mm {out['library']:.4f} ms, bound "
          f"{out['bound_ms']:.6f} ms ({out['bound_by']}); {card}")
    del ell, fwd, sp, a, b, lib, rg
    torch.cuda.empty_cache()
    return out


def rowsplit_plain_blocked(fwd, vals, b, m):
    """Row-split's plain version (``ref.rowsplit_execute_ref``) a block of
    ELL rows at a time: its gather holds rows x slots x n floats (100 GB on
    ``powlaw_65k_d32``, 400 GB on a 65,536-row shard of the power law)."""
    from repro_torch.kernels import ref
    slots = fwd["cols"].shape[1]
    step = max(1, PLAIN_BLOCK_BYTES // (slots * b.shape[-1] * 4))
    return torch.cat([ref.rowsplit_execute_ref(
        {key: fwd[key][r:r + step] for key in ("cols", "slot_nz")}, vals, b,
        min(step, m - r)) for r in range(0, m, step)])


def tune(cfg, params, prompt, forced, dev, card, reset_counts,
         read_counts) -> dict:
    """The autotuner on the card, through ``repro_torch.tune``.

    1. The ``paper`` suite: each method's kernel held to its plain version
       on every matrix, ``torch.sparse.mm`` timed (a yardstick the port
       never calls), then ``tune_suite(..., wide=True)`` into a TuneDB
       keyed on this card.
    2. The §5.4 crossover at card sizes: CROSSOVER, layer 0's pruned w1/w2
       and the POWER_LAW matrix through ``tune_pattern``, each row-split
       ELL's bytes printed first and each method's kernel held to its plain
       version at every candidate the tuner times; the calibrated
       threshold and its oracle
       agreement against the paper's 9.35 on the same records; geomean and
       peak speedup over ``torch.sparse.mm`` of the oracle pick, the §5.4
       pick and the calibrated pick.
    3. The main path with the DB: the served model's other 46 pruned FFN
       patterns tuned in, the DB saved and loaded with
       ``engine.load_tunedb``, ``serve_pruned`` run twice through the
       ladder (every plan an exact hit, resolved by the first run and
       served from the cache's alias map to the second, none built while
       serving, logits
       bit-equal to the serving phase's run with the picked method
       forced), the eager warm forward timed beside row-split forced's;
       ``python -m repro_torch.tune --suite mini`` and ``python -m
       repro_torch.launch.serve --prune-ffn 0.25 --tunedb`` in
       subprocesses, both on the card.
    4. The power-law matrix resolved through the DB, against the §5.4
       pick, with both times.

    The launches: the tuner's and the two serving runs'.  For each timed
    candidate ``timeit`` makes one warm call, captures INNER calls into a
    graph and replays it TUNE_WARMUP + TUNE_REPEAT times.  The wrappers
    count the warm call and the captured calls, which only record their
    launches; the replays run INNER calls each and pass no wrapper.  So
    the wrappers' count while tuning is held to (1 + INNER) calls a
    candidate, and the launches that ran are (1 + (TUNE_WARMUP +
    TUNE_REPEAT) x INNER) calls a candidate, a call being one launch (one
    a length bucket for rowgroup).  The parity checks' launches are kept
    off both."""
    import ast

    from repro_torch import engine
    from repro_torch import matrices as G
    from repro_torch.core import (PAPER_THRESHOLD, ExecutionConfig,
                                  Heuristic, PlanPolicy, build_plan,
                                  execute_plan, pattern_fingerprint,
                                  power_law_csr, prune_to_csr)
    from repro_torch.core.config import resolve_counts
    from repro_torch.kernels import _cuda, registry, rowsplit_spmm
    from repro_torch.launch import serve
    from repro_torch.tune import TuneDB, timeit, tune_pattern, tune_suite
    from repro_torch.tune.timing import INNER

    out_dir = _cuda.BUILD_DIR / "tune"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "tune.json"
    db = TuneDB()
    print(f"TuneDB backend {db.backend!r}, written to {path}")
    worst = {"merge_spmm": 0.0, "rowsplit_spmm": 0.0}
    library = {}
    # The tuner's kernel calls: what the wrappers count, what runs; and the
    # parity checks' launches, kept off the phase's count.
    counted, ran = dict.fromkeys(worst, 0), dict.fromkeys(worst, 0)
    excluded = dict.fromkeys(worst, 0)

    def expect_tuning(a):
        """Add one ``tune_pattern(a, wide=True)``'s calls to counted/ran."""
        for method in registry.method_names():
            per_call = len(PlanPolicy(method=method, with_transpose=False)
                           .resolve(a).extra) if method == "rowgroup" else 1
            calls = per_call * len(registry.get_method(method)
                                   .tune_candidates(a, True))
            counted[KERNEL_OF[method]] += calls * (1 + INNER)
            ran[KERNEL_OF[method]] += calls * (
                1 + (TUNE_WARMUP + TUNE_REPEAT) * INNER)

    def plain(method, plan, vals, b, m):
        """The method's plain version; row-split's a block of ELL rows at
        a time (its gather holds rows x slots x n floats: 100 GB on
        ``powlaw_65k_d32``)."""
        if method != "rowsplit":
            return execute_plan(plan, vals, b, ExecutionConfig(impl="torch"))
        return rowsplit_plain_blocked(plan.fwd, vals, b, m)

    def hold(a, n, what):
        """Each method's kernel at every candidate the tuner times on ``a``
        against its plain version, B (k, n) from a seed, at the suite's
        bar; the worst error a method."""
        before = read_counts()
        g = torch.Generator(device=dev).manual_seed(11)
        b = torch.randn(a.k, n, generator=g, device=dev)
        errs = {}
        for method in registry.method_names():
            for cand in registry.get_method(method).tune_candidates(a, True):
                plan = build_plan(a, PlanPolicy(method=method,
                                                with_transpose=False, **cand))
                got = execute_plan(plan, a.vals, b,
                                   ExecutionConfig(impl="cuda"))
                want = plain(method, plan, a.vals, b, a.m)
                tol = dict(rtol=POWER_LAW_TOL["rtol"],
                           atol=POWER_LAW_TOL["atol_of_max"]
                           * want.abs().max().item())
                params = "".join(f" {k}={v}" for k, v in cand.items())
                err, _ = check_close(f"tune parity {method}{params} {what}",
                                     got, want, tol)
                errs[method] = max(errs.get(method, 0.0), err)
                worst[KERNEL_OF[method]] = max(worst[KERNEL_OF[method]], err)
                del plan, got, want
                torch.cuda.empty_cache()
        after = read_counts()
        for key in excluded:
            excluded[key] += after[key] - before[key]
        return errs

    def library_us(a, n):
        g = torch.Generator(device=dev).manual_seed(7)
        b = torch.randn(a.k, n, generator=g, device=dev)
        nnz = a.nnz()
        with warnings.catch_warnings():      # "beta state" notices
            warnings.simplefilter("ignore")
            sp = torch.sparse_csr_tensor(a.row_ptr, a.col_ind[:nnz],
                                         a.vals[:nnz], a.shape,
                                         check_invariants=True)
        return timeit(torch.sparse.mm, sp, b)

    def ell_bytes(a):
        tl, tm = rowsplit_spmm.DEFAULT_TL, rowsplit_spmm.TM
        longest = max(int(a.row_lengths().max()), 1)
        return 2 * 4 * tm * -(-a.m // tm) * tl * -(-longest // tl)

    # 1. The paper suite: parity, the library call, then the tuner.
    for spec in G.get_suite("paper"):
        a = spec().to(dev)
        g = torch.Generator(device=dev).manual_seed(11)
        b = torch.randn(a.k, CROSS_N, generator=g, device=dev)
        errs, eager = {}, {}
        for method in registry.method_names():
            plan = build_plan(a, PlanPolicy(method=method,
                                            with_transpose=False))
            kname = KERNEL_OF[method]
            before = read_counts()[kname]
            got = execute_plan(plan, a.vals, b, ExecutionConfig(impl="cuda"))
            launched = read_counts()[kname] - before
            # Eager calls back to back (CUDA events), against the tuner's
            # graph replays below: where the host's dispatch sets the time.
            eager[method] = time_ms(lambda: execute_plan(
                plan, a.vals, b, ExecutionConfig(impl="cuda"))) * 1e3
            want = execute_plan(plan, a.vals, b,
                                ExecutionConfig(impl="torch"))
            exact = execute_plan(plan, a.vals.double(), b.double(),
                                 ExecutionConfig(impl="torch"))
            expect = len(plan.meta.extra) if method == "rowgroup" else 1
            if launched != expect:
                raise AssertionError(f"tune parity {method} {spec.name}: "
                                     f"{launched} launches, want {expect}")
            tol = dict(rtol=POWER_LAW_TOL["rtol"],
                       atol=POWER_LAW_TOL["atol_of_max"]
                       * want.abs().max().item())
            err, _ = check_close(f"tune parity {method} {spec.name}", got,
                                 want, tol)
            errs[method] = (err, tol["atol"],
                            (got.double() - exact).abs().max().item(),
                            (want.double() - exact).abs().max().item())
            worst[kname] = max(worst[kname], err)
        library[spec.name] = library_us(a, CROSS_N)
        expect_tuning(a)
        s = G.compute_stats(a)
        print(f"tune parity {spec.name} {a.shape} nnz {s.nnz} d {s.d:.2f} "
              f"cv {s.cv:.2f} rows up to {s.max_len}: kernel vs plain max "
              f"|d| (atol; kernel / plain vs a float64 sum) "
              + ", ".join(f"{k} {e:.3e} ({t:.1e}; {x:.3e} / {y:.3e})"
                          for k, (e, t, x, y) in errs.items())
              + f", rtol {POWER_LAW_TOL['rtol']}; row-split ELL "
              f"{ell_bytes(a)} B; eager back-to-back calls "
              + ", ".join(f"{k} {v:.3f} us" for k, v in eager.items())
              + f"; torch.sparse.mm {float(library[spec.name]):.3f} us")
    reset_counts()
    t0 = time.perf_counter()
    tune_suite(G.get_suite("paper"), db, n=CROSS_N, wide=True, device=dev,
               warmup=TUNE_WARMUP, repeat=TUNE_REPEAT, log=print)
    print(f"tune paper suite: {len(db)} matrices in "
          f"{time.perf_counter() - t0:.1f} s")

    # 2. The crossover at card sizes.
    layer0 = params["blocks"][0]["mlp"]
    specs = [(name, lambda fn=fn, args=args, kw=kw: getattr(G, fn)(
        *args, **kw, device=dev), CROSS_N)
        for name, (fn, args, kw) in CROSSOVER.items()]
    n_serve = SERVE_BATCH * SERVE_PROMPT
    specs += [(f"llama_{w}_layer0", lambda w=w: prune_to_csr(
        layer0[w].T, KEEP), n_serve) for w in ("w1", "w2")]
    specs.append(("power_law_262k", lambda: power_law_csr(
        POWER_LAW["seed"], POWER_LAW["m"], POWER_LAW["m"], POWER_LAW["d"],
        alpha=POWER_LAW["alpha"], device=dev), n_serve))
    clash = {name for name, _, _ in specs} & set(library)
    if clash:
        raise AssertionError(f"crossover names shared with the suite: "
                             f"{sorted(clash)}")
    t_cross = time.perf_counter()
    for name, build, n in specs:
        t0 = time.perf_counter()
        a = build()
        made = time.perf_counter() - t0
        s = G.compute_stats(a)
        eb = ell_bytes(a)
        print(f"tune {name}: {a.shape} nnz {s.nnz} d {s.d:.2f} cv "
              f"{s.cv:.2f} rows up to {s.max_len} long, n {n} (made in "
              f"{made:.1f} s); row-split ELL {eb} B ({eb / 2**30:.3f} GiB)",
              flush=True)
        errs = hold(a, n, name)
        print(f"tune parity {name}: kernel vs plain max |d| at every tuned "
              f"candidate " + ", ".join(f"{k} {e:.3e}"
                                        for k, e in errs.items())
              + f" (rtol {POWER_LAW_TOL['rtol']}, atol "
              f"{POWER_LAW_TOL['atol_of_max']} of the largest |C|)",
              flush=True)
        expect_tuning(a)
        db.record(pattern_fingerprint(a), tune_pattern(
            a, n=n, wide=True, name=name, warmup=TUNE_WARMUP,
            repeat=TUNE_REPEAT, log=print))
        library[name] = library_us(a, n)
        if name == "power_law_262k":
            power_law = a
        del a
    torch.cuda.empty_cache()
    print(f"tune crossover: {len(specs)} matrices in "
          f"{time.perf_counter() - t_cross:.1f} s")
    thr, acc = db.calibrate_threshold()
    recs = {rec.name: rec for rec in db.entries.values()}
    rows = [(name, recs[name], library[name]) for name in library]
    for name, rec, lib in rows:
        best = rec.timings[rec.method]
        won = "".join(f" {k}={v}" for k, v in (("t", rec.t),
                                               ("l_pad", rec.l_pad))
                      if v is not None)
        print(f"tune row {name}: m {rec.m} k {rec.k} d {rec.d:.2f} cv "
              f"{rec.cv:.2f} n {rec.n}: "
              + ", ".join(f"{m} {us:.3f} us" for m, us in
                          sorted(rec.timings.items()))
              + f"; winner {rec.method}{won}; merge/row-split oracle "
              f"{rec.oracle}; torch.sparse.mm {float(lib):.3f} us, the "
              f"winner {float(lib) / best:.3f}x faster; {card}")

    def pick(rec, threshold):
        return "merge" if rec.d < threshold else "rowsplit"

    paper_acc = statistics.fmean(pick(r, PAPER_THRESHOLD) == r.oracle
                                 for _, r, _ in rows)
    speedups = {}
    for label, chooser in (("oracle", lambda r: r.method),
                           ("paper_9.35", lambda r: pick(r, PAPER_THRESHOLD)),
                           ("calibrated", lambda r: pick(r, thr))):
        xs = [float(lib) / r.timings[chooser(r)] for _, r, lib in rows]
        speedups[label] = dict(geomean=statistics.geometric_mean(xs),
                               peak=max(xs))
    print(f"tune crossover over {len(rows)} matrices (paper suite + "
          f"crossover): calibrated threshold {thr:.4f}, oracle agreement "
          f"{acc * 100:.1f}%; the paper's {PAPER_THRESHOLD} agrees on "
          f"{paper_acc * 100:.1f}%; speedup over torch.sparse.mm "
          + "; ".join(f"{k} geomean {v['geomean']:.3f}x peak "
                      f"{v['peak']:.3f}x" for k, v in speedups.items())
          + f"; {card}")

    # 3. The main path with the DB.
    t0 = time.perf_counter()
    for li, lp in enumerate(params["blocks"]):
        for w, weight in lp["mlp"].items():
            a = prune_to_csr(weight.T, KEEP)
            fp = pattern_fingerprint(a)
            if db.lookup_exact(fp) is None:
                expect_tuning(a)
                db.record(fp, tune_pattern(
                    a, n=n_serve, wide=True, name=f"llama_{w}_layer{li}",
                    warmup=TUNE_WARMUP, repeat=TUNE_REPEAT))
    now = read_counts()
    tuning = {key: v - excluded.get(key, 0) for key, v in now.items()}
    db.save(path)
    print(f"tune served patterns: {len(db) - len(rows)} more in "
          f"{time.perf_counter() - t0:.1f} s; saved {len(db)} records; "
          f"the wrappers counted {tuning} while tuning (parity checks' "
          f"{excluded} left out), expected {counted}: a warm call and "
          f"{INNER} captured calls a candidate; launches that ran "
          f"{ran}: a warm call and {TUNE_WARMUP + TUNE_REPEAT} replays of "
          f"{INNER} calls a candidate")
    if tuning != dict(dict.fromkeys(tuning, 0), **counted):
        raise AssertionError(f"tune: the wrappers counted {tuning} while "
                             f"tuning, expected {counted}")
    loaded = engine.load_tunedb(path)
    if len(loaded) != len(db):
        raise AssertionError(f"{path}: loaded {len(loaded)} of {len(db)}")
    launches = dict(ran)
    first = None
    for run in ("first", "again"):
        before = resolve_counts()
        reset_counts()
        rep = serve.serve_pruned(cfg, params, prompt, KEEP)
        counts = read_counts()
        rungs = resolve_counts(since=before)
        blocks = serve.prune_ffn_blocks(params, cfg, KEEP)
        picks = {(li, w): sl.plan for li, blk in enumerate(blocks)
                 for w, sl in blk["mlp"].items()}
        by = {}
        for (li, w), plan in picks.items():
            by.setdefault(w, {}).setdefault(plan.meta.method, 0)
            by[w][plan.meta.method] += 1
            rec = loaded.lookup_exact(pattern_fingerprint(
                blocks[li]["mlp"][w].weight))
            if plan.meta.method != rec.method:
                raise AssertionError(f"layer {li} {w}: planned "
                                     f"{plan.meta.method}, DB {rec.method}")
        per_forward = {"rowsplit_spmm": 0, "merge_spmm": 0}
        for plan in picks.values():
            method = plan.meta.method
            per_forward[KERNEL_OF[method]] += \
                len(plan.meta.extra) if method == "rowgroup" else 1
        want = {name: 2 * per_forward.get(name, 0) for name in counts}
        print(f"serve with the TuneDB ({run}): plan_resolve_total {rungs}; "
              f"methods by matrix {by}; plans built during serving "
              f"{rep.replans}; warm forward {rep.warm_s * 1e3:.2f} ms; "
              f"launches {counts} over 2 forwards; {card}")
        # The plan cache's alias map answers the second run's requests
        # without resolving them again: every plan an exact hit, then none.
        resolved = len(picks) if run == "first" else 0
        if set(r for r, _ in rungs) - {"exact"} or \
                sum(rungs.values()) != resolved:
            raise AssertionError(f"serving with the DB resolved {rungs}, "
                                 f"expected {resolved} exact hits")
        if rep.replans or counts != want:
            raise AssertionError(f"serving with the DB: {rep.replans} "
                                 f"replans, launches {counts} != {want}")
        for method in sorted(set(p.meta.method for p in picks.values())):
            if not torch.equal(rep.logits, forced[method]):
                raise AssertionError(f"logits with the DB differ from the "
                                     f"run with {method} forced")
        print(f"logits with the TuneDB bit-equal to the run with "
              f"{sorted(set(p.meta.method for p in picks.values()))} "
              f"forced: True")
        if first is not None and not torch.equal(rep.logits, first):
            raise AssertionError("the second run with the DB differs")
        first = rep.logits
        for name, c in counts.items():
            launches[name] = launches.get(name, 0) + c
        del rep, blocks, picks
    # What the DB's picks cost the eager caller, whose forward is host
    # bound: the warm forward with the DB's plans beside row-split forced,
    # in the order DB, row-split, row-split, DB (host clock, synchronised,
    # each the median of 5 after a warm call; kernels uncounted).
    fwd = serve.make_pruned_forward(cfg)
    policies = {"tunedb": None, "rowsplit": PlanPolicy(method="rowsplit")}
    eager = {label: [] for label in policies}
    for label in ("tunedb", "rowsplit", "rowsplit", "tunedb"):
        blocks = serve.prune_ffn_blocks(params, cfg, KEEP, policies[label])

        def forward(blocks=blocks):
            with torch.no_grad():
                fwd(params, blocks, prompt)

        eager[label].append(host_ms(forward))
        del blocks
    print(f"eager warm forward with the TuneDB's picks "
          + ", ".join(f"{ms:.3f}" for ms in eager["tunedb"])
          + " ms, with row-split forced "
          + ", ".join(f"{ms:.3f}" for ms in eager["rowsplit"])
          + f" ms (DB, row-split, row-split, DB); {card}")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [SRC] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    mini = out_dir / "mini.json"
    mini.unlink(missing_ok=True)
    torch.cuda.empty_cache()
    for argv, limit in (
            (["-m", "repro_torch.tune", "--suite", "mini", "--out",
              str(mini), "--warmup", "1", "--repeat", "2"], 300),
            (["-m", "repro_torch.launch.serve", "--prune-ffn", str(KEEP),
              "--tunedb", str(path)], 600)):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, *argv], capture_output=True,
                              text=True, env=env, timeout=limit, cwd=ROOT)
        print(f"$ python {' '.join(argv)}  (exit {proc.returncode}, "
              f"{time.perf_counter() - t0:.1f} s)")
        print("\n".join(proc.stdout.splitlines()[-12:]))
        if proc.returncode != 0:
            raise AssertionError(f"{argv[1]} exited {proc.returncode}: "
                                 f"{proc.stderr[-3000:]}")
    line = next(ln for ln in proc.stdout.splitlines()
                if "plan_resolve_total of this run" in ln)
    cli_rungs = ast.literal_eval(line.split(": ", 1)[1])
    if "plans built during serving: 0" not in proc.stdout or \
            not all(k.startswith("exact/") for k in cli_rungs):
        raise AssertionError(f"serve --tunedb: {line}")

    # 4. The power-law matrix through the DB.
    before = resolve_counts()
    r = PlanPolicy(tunedb=loaded).resolve(power_law)
    (rung, _), = resolve_counts(since=before)
    paper = Heuristic().choose(power_law)
    rec = loaded.lookup_exact(pattern_fingerprint(power_law))
    print(f"power law {POWER_LAW['m']}² through the TuneDB: rung {rung}, "
          f"pick {r.method} {rec.timings[r.method]:.3f} us, against the "
          f"§5.4 pick {paper} {rec.timings[paper]:.3f} us "
          f"({rec.timings[paper] / rec.timings[r.method]:.2f}x); d "
          f"{rec.d:.2f}, n {rec.n}; {card}")
    if rung != "exact" or r.method != rec.method:
        raise AssertionError(f"power law resolved {r.method} from {rung}")
    engine.set_tunedb(None)
    del power_law
    torch.cuda.empty_cache()
    return dict(launches=launches, worst=worst, threshold=thr,
                eager_forward_ms=eager,
                threshold_accuracy=acc, paper_accuracy=paper_acc,
                speedups=speedups, records=len(rows),
                power_law=dict(rung=rung, pick=r.method, paper_pick=paper,
                               us=rec.timings))


def serve_methods(cfg, params, prompt, runs, dev, card, reset_counts,
                  read_counts) -> dict:
    """``serve.serve_pruned`` (keep KEEP) once for each (kernel,
    --spmm-method, the plans' method) of ``runs``.  Each run must plan that
    method, build no plan while serving, launch that kernel alone — one
    launch a matrix, one a length bucket for rowgroup, over the cold and
    warm forwards — all ``f32x4`` (B (d_in, 128) f32), and give finite
    logits; then one warm forward is profiled.  Returns, by the plans'
    method: the run's counts, its logits, the pruned blocks and the
    launches a forward."""
    from repro_torch.core import PlanPolicy
    from repro_torch.kernels import merge_spmm, rowsplit_spmm
    from repro_torch.launch import serve
    mods = {"rowsplit_spmm": rowsplit_spmm, "merge_spmm": merge_spmm}
    forwards = 2                      # serve_pruned's cold + warm calls
    out = {}
    for kname, method, planned in runs:
        policy = PlanPolicy(method=method)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        rep = serve.serve_pruned(cfg, params, prompt, KEEP, policy=policy)
        counts = read_counts()
        bodies = dict(mods[kname].LAUNCHES_BY_BODY)
        blocks = serve.prune_ffn_blocks(params, cfg, KEEP, policy)
        per_forward = sum(max(1, len(sl.plan.meta.extra)) if planned ==
                          "rowgroup" else 1 for blk in blocks
                          for sl in blk["mlp"].values())
        if planned == "rowgroup":
            groups = sorted({(name, sl.plan.meta.extra)
                             for blk in blocks
                             for name, sl in blk["mlp"].items()})
            print(f"serve method=rowgroup: length buckets (m_g, l_g) of the "
                  f"{len(blocks)} layers' matrices: {groups}")
        want = per_forward * forwards
        print(f"serve {cfg.name} method={method}: methods {rep.methods}; "
              f"plan {rep.plan_s:.3f} s, cold forward "
              f"{rep.cold_s * 1e3:.2f} ms, warm forward "
              f"{rep.warm_s * 1e3:.2f} ms, {rep.tok_per_s:.0f} tok/s; plans "
              f"built during serving {rep.replans}; launches {counts} over "
              f"{forwards} forwards ({counts[kname] // forwards} of {kname} "
              f"a forward), bodies {bodies}; device memory "
              f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB held, "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB peak "
              f"in the run (params, the plans cached so far); {card}")
        if set(rep.methods.values()) != {planned} or rep.replans or \
                counts[kname] != want or sum(counts.values()) != want:
            raise AssertionError(f"{cfg.name} method={method}: expected "
                                 f"{want} launches of {kname} alone, got "
                                 f"{counts} (plans {rep.methods})")
        if bodies != {"f32x4": want}:
            raise AssertionError(f"{cfg.name}: {kname} ran {bodies}, "
                                 "expected f32x4 (B (d_in, 128) f32)")
        lg = rep.logits
        if lg.shape != (*prompt.shape, cfg.vocab_size) or \
                not torch.isfinite(lg).all():
            raise AssertionError(f"{cfg.name}: bad logits {lg.shape}")
        fwd = serve.make_pruned_forward(cfg)

        def forward():
            with torch.no_grad():
                fwd(params, blocks, prompt)

        # The SpMM kernels by name: rowsplit_kernel; merge_range_kernel
        # and merge_fixup_kernel.
        part = "merge_" if kname == "merge_spmm" else "rowsplit_kernel"
        busy, spmm_ms = profile_device(forward, part=part)
        print(f"profile {cfg.name} method={method}: device busy {busy:.3f} "
              f"ms of the {rep.warm_s * 1e3:.2f} ms warm forward (idle share "
              f"{1 - busy / (rep.warm_s * 1e3):.3f}); the {per_forward} SpMM "
              f"launches {spmm_ms:.3f} ms, {spmm_ms / cfg.num_layers:.4f} ms "
              f"a layer ({blocks[0]['mlp']['w1'].weight.nnz()} nonzeros in "
              f"layer 0's w1); {card}")
        out[planned] = dict(counts=counts, logits=lg, blocks=blocks,
                            per_forward=per_forward)
    return out


def hold_served_plans(label, blocks, layers, kname, dev, read_counts):
    """The served plans of ``layers``' w1, w3 and w2, each on a seeded B
    (d_in, SERVE_BATCH x SERVE_PROMPT) f32, as the pruned forward gives
    it: the kernel (``impl="cuda"``, one counted launch of ``kname``)
    against its plain version (``impl="torch"``) at the parity phase's f32
    TOL.  Returns the worst max |d|."""
    from repro_torch.core import ExecutionConfig
    n = SERVE_BATCH * SERVE_PROMPT
    tol = TOL["float32"]
    worst = 0.0
    for li in layers:
        for name, sl in blocks[li]["mlp"].items():
            (m, k), a = sl.weight.shape, sl.matrix
            g = torch.Generator(device=dev).manual_seed(40 + li)
            b = torch.randn(k, n, generator=g, device=dev)
            before = read_counts()[kname]
            got = a.matmul(b, ExecutionConfig(impl="cuda"))
            ran = read_counts()[kname] - before
            want = a.matmul(b, ExecutionConfig(impl="torch"))
            torch.cuda.synchronize()
            if ran != 1:
                raise AssertionError(f"{label} layer {li} {name}: {ran} "
                                     f"launches of {kname}, expected 1")
            what = f"{label} layer {li} {name} {(m, k)}"
            d, r = check_close(f"{what} kernel vs plain", got, want, tol)
            print(f"{what} nnz {sl.weight.nnz()} n {n} f32: {kname} vs its "
                  f"plain version max |d| {d:.3e}, max |C| "
                  f"{want.abs().max().item():.3f} (tol rtol {tol['rtol']} "
                  f"atol {tol['atol']}; worst ratio {r:.3f})")
            worst = max(worst, d)
    return worst


def smoke_pruned_parity(arch, methods, dev, read_counts) -> None:
    """The smoke ``arch`` at f32 compute, its FFNs pruned and planned with
    each of ``methods``: the pruned forward on the card (kernels, which
    must launch) against the CPU (plain versions) from the same params
    and tokens, at SMOKE_TOL."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import PlanPolicy
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    scfg = dataclasses.replace(get_smoke_config(arch),
                               compute_dtype="float32")
    sp_cpu = M.init_params(scfg, SEED, "cpu")
    sp_gpu = to_device(sp_cpu, dev)
    tokens = torch.randint(0, scfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(3))
    fwd = serve.make_pruned_forward(scfg)
    for method in methods:
        pol = PlanPolicy(method=method)
        with torch.no_grad():
            want = fwd(sp_cpu, serve.prune_ffn_blocks(sp_cpu, scfg, KEEP,
                                                      pol), tokens)
            gpu_blocks = serve.prune_ffn_blocks(sp_gpu, scfg, KEEP, pol)
            before = sum(read_counts().values())
            got = fwd(sp_gpu, gpu_blocks, tokens.to(dev))
            ran = sum(read_counts().values()) - before
        err = (got.cpu() - want).abs().max().item()
        print(f"smoke {arch} f32 pruned forward, {method}: card ({ran} "
              f"kernel launches) vs CPU max |d| {err:.3e} (tol rtol "
              f"{SMOKE_TOL['rtol']} atol {SMOKE_TOL['atol']})")
        if not ran:
            raise AssertionError(f"smoke {arch} {method}: no kernel ran")
        torch.testing.assert_close(got.cpu(), want, **SMOKE_TOL)


def online(cfg, params, prompt, unbatched, dev, card, reset_counts,
           read_counts) -> dict:
    """The serve CLI's ``--serve`` path, ``serve.serve_online``, on the
    serving phase's full-width model and params (row-split by the §5.4
    rule); then, per bucket, the row-split kernel held to its plain version
    on the served plans at the bucket's width and the graph replay held to
    the eager forward; every request of the load run held to the eager
    forward of the bucket matrix it was packed in; microbatched scoring
    held to the unbatched logits.

    Launches on this path: the wrappers count each bucket's warm eager call
    and its capture.  The capture only records its launches, which run when
    the graph replays, and a replay passes through no wrapper.  So the
    path's launches are the warm calls' plus, for each graph, its
    ``replays`` times the launches of one eager forward at its bucket
    (measured here; the wrapper count must be twice their sum, a warm call
    and a capture a bucket)."""
    from repro_torch.core import ExecutionConfig
    from repro_torch.engine import GraphProgram
    from repro_torch.launch import serve
    reset_counts()
    t0 = time.perf_counter()
    rep = serve.serve_online(cfg, params, KEEP, batch=SERVE_BATCH,
                             prompt_len=SERVE_PROMPT,
                             requests=ONLINE_REQUESTS, seed=SEED,
                             keep_served=True)
    run_s = time.perf_counter() - t0
    counts = read_counts()
    srv, load = rep.server, rep.load
    shapes = srv.ladder.shapes()
    progs = {sh: srv.program(*sh) for sh in shapes}
    replays = {sh: prog.replays for sh, prog in progs.items()}
    print(f"online: {len(progs)} bucket programs {sorted(progs)} built in "
          f"{rep.warmup_s:.3f} s; offered {rep.rate_rps:.1f} req/s; "
          f"{load.ok}/{load.n} ok, {load.shed} shed, {load.error} error in "
          f"{load.wall_s:.3f} s = {load.throughput_rps:.2f} req/s, p50 "
          f"{load.p50_us / 1e3:.3f} ms, p99 {load.p99_us / 1e3:.3f} ms; "
          f"recompiles after warmup {rep.recompiles}, plans built while "
          f"serving {rep.replans}; wrapper launches {counts} (warm calls "
          f"and captures), replays {sum(replays.values())} {replays}; "
          f"run {run_s:.2f} s; {card}")
    if len(progs) != 9 or not all(isinstance(p, GraphProgram)
                                  for p in progs.values()):
        raise AssertionError(f"online: expected 9 CUDA graphs, got "
                             f"{ {k: type(v).__name__ for k, v in progs.items()} }")
    if (load.ok, load.shed, load.error) != (ONLINE_REQUESTS, 0, 0) or \
            rep.recompiles or rep.replans:
        raise AssertionError("online: a request was not served, or the run "
                             "built a program or a plan after warmup")
    p, blocks = srv.state
    base = serve.make_pruned_forward(cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    per_forward = {}
    buckets = {}
    max_abs = 0.0
    # The kernel at each bucket's width n = batch x length, on the served
    # plans of the first and last layers (w1/w3 8192 x 2048, w2 2048 x 8192)
    # with B f32 as the forward gives it, against its plain version.
    held = [(f"layer {i} {name}", sl) for i in (0, len(blocks) - 1)
            for name, sl in blocks[i]["mlp"].items()]
    for bb, lb in shapes:
        for what, sl in held:
            x = torch.randn((bb, lb, sl.weight.k), generator=gen,
                            device=dev)
            before = read_counts()["rowsplit_spmm"]
            with torch.inference_mode():
                got = sl(x, ExecutionConfig(impl="cuda"))
                want = sl(x, ExecutionConfig(impl="torch"))
            if read_counts()["rowsplit_spmm"] - before != 1:
                raise AssertionError(f"online {bb}x{lb} {what}: expected 1 "
                                     "row-split launch")
            d, _ = check_close(f"online {bb}x{lb} {what} (n={bb * lb})",
                               got, want, TOL["float32"])
            max_abs = max(max_abs, d)
        tok = torch.randint(0, cfg.vocab_size, (bb, lb), generator=gen,
                            device=dev)
        prog = progs[(bb, lb)]

        def eager():
            with torch.inference_mode():
                return base(p, blocks, tok)

        def replay():
            return prog(tok)

        before = read_counts()
        want = eager()
        after = read_counts()
        launched = {k: after[k] - before[k] for k in after}
        if launched["rowsplit_spmm"] != sum(launched.values()) or \
                not launched["rowsplit_spmm"]:
            raise AssertionError(f"online {bb}x{lb}: the eager forward "
                                 f"launched {launched}")
        per_forward[(bb, lb)] = launched["rowsplit_spmm"]
        got = replay().clone()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            d = (got - want).abs().max().item()
            raise AssertionError(f"online {bb}x{lb}: the graph replay "
                                 f"differs from the eager forward (max |d| "
                                 f"{d:.3e})")
        e_ms, r_ms = host_ms(eager), host_ms(replay)
        r_event = time_ms(replay, reps=5, inner=3)
        e_busy = profile_device(eager, top=0)
        r_busy = profile_device(replay, top=4)
        buckets[f"{bb}x{lb}"] = dict(
            capture_s=prog.capture_s, eager_ms=e_ms, replay_ms=r_ms,
            replay_event_ms=r_event, eager_busy_ms=e_busy,
            replay_busy_ms=r_busy)
        print(f"online bucket {bb}x{lb}: row-split kernel vs plain version "
              f"on the {len(held)} matrices of layers 0 and "
              f"{len(blocks) - 1} at n={bb * lb}, max |d| so far "
              f"{max_abs:.3e} (tol {TOL['float32']}); captured in "
              f"{prog.capture_s:.3f} s (warm call + capture); eager "
              f"{e_ms:.3f} ms host, {e_busy:.3f} ms device busy; graph "
              f"replay {r_ms:.3f} ms host, {r_busy:.3f} ms device busy, "
              f"{r_event:.3f} ms by CUDA events; replay bit-equal to eager; "
              f"{per_forward[(bb, lb)]} row-split launches a forward; {card}")
        del got, want
    warm = sum(per_forward.values())
    if counts["rowsplit_spmm"] != 2 * warm:
        raise AssertionError(f"online: the wrappers counted "
                             f"{counts['rowsplit_spmm']} launches, expected "
                             f"a warm call and a capture a bucket, 2 x {warm}")
    launches = warm + sum(n * per_forward[sh] for sh, n in replays.items())
    srv.programs.clear()
    del progs, prog
    # Every request of the load run: its rows bit-equal to the eager forward
    # of the bucket matrix the batcher packed it in (same shape, so the same
    # kernels and algorithms), and, packed with others, within the serving
    # bars of a solo forward at batch bucket 1.
    mix, solo_gap = {}, 0.0
    batches = {}
    for tokens, fut in load.served:
        batches.setdefault(id(fut.packed), []).append((tokens, fut))
    with torch.inference_mode():
        for group in batches.values():
            packed = group[0][1].packed
            bb, lb = packed.shape
            want = base(p, blocks, torch.from_numpy(packed).to(dev))
            mix[f"{bb}x{lb}"] = mix.get(f"{bb}x{lb}", 0) + len(group)
            for tokens, fut in group:
                n = len(tokens)
                if fut.bucket != (bb, lb) or \
                        not (packed[fut.row, :n] == tokens).all():
                    raise AssertionError(f"online: a request's packed row "
                                         f"is not its tokens ({fut.bucket})")
                if not torch.equal(fut.result(), want[fut.row, :n]):
                    raise AssertionError(
                        f"online: a request of length {n} served in row "
                        f"{fut.row} of bucket {bb}x{lb} differs from the "
                        "eager forward of that bucket matrix")
                if bb > 1:
                    mat = torch.zeros((1, lb), dtype=torch.int64)
                    mat[0, :n] = torch.from_numpy(tokens)
                    solo = base(p, blocks, mat.to(dev))[0, :n]
                    solo_gap = max(solo_gap, serve_gap(
                        f"online request (length {n}) at bucket {bb}x{lb} "
                        f"vs solo at 1x{lb}", fut.result(), solo))
    print(f"online load run: all {len(load.served)} served requests, in "
          f"{len(batches)} bucket batches {mix} (requests a bucket), "
          f"bit-equal to the eager forwards of their packed bucket "
          f"matrices; largest gap to a solo forward {solo_gap:.4e}")
    served = dict(ok=load.ok, shed=load.shed, error=load.error,
                  req_per_s=load.throughput_rps, p50_ms=load.p50_us / 1e3,
                  p99_ms=load.p99_us / 1e3)
    del rep, srv, load, batches
    torch.cuda.empty_cache()
    mb = serve.serve_pruned(cfg, params, prompt, KEEP, microbatch=2)
    mb_gap = serve_gap("logits microbatch=2 vs unbatched", mb.logits,
                       unbatched)
    return dict(launches=launches, wrapper_launches=counts["rowsplit_spmm"],
                warm_launches=warm, replays=sum(replays.values()),
                **served, buckets=buckets, mix=mix, solo_gap=solo_gap,
                microbatch_gap=mb_gap, max_abs=max_abs)


def training(cfg, dev, card, reset_counts, read_counts) -> dict:
    """Sparse fine-tuning of layer 0's pruned FFN at full width, once with
    the §5.4 rule (row-split) and once forcing merge; returns the launches
    of each kernel over both runs' steps."""
    import torch.nn.functional as F

    from repro_torch.core import ExecutionConfig, PlanPolicy
    from repro_torch.engine import cache_stats, clear_cache
    from repro_torch.kernels import merge_spmm, rowsplit_spmm, sddmm
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
        bodies = {name: dict(mod.LAUNCHES_BY_BODY) for name, mod in (
            ("rowsplit_spmm", rowsplit_spmm), ("merge_spmm", merge_spmm),
            ("sddmm", sddmm))}
        replans = cache_stats().misses - misses
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        for name in totals:
            totals[name] += counts[name]
        per_step = {name: v / TRAIN_STEPS for name, v in counts.items()}
        # A step: 3 forward SpMMs, 3 SDDMMs (dvals) and 1 merge (dB for the
        # hidden activation that feeds w2, on the transpose plan; x needs
        # none); a merge call is its range kernel and fix-up, counted once.
        want = dict.fromkeys(per_step, 0.0)
        want.update(merge_spmm=1.0, sddmm=3.0)
        want[kname] += 3.0
        cold, warm = times[0], statistics.median(times[1:])

        def forward():
            with torch.no_grad():
                S.sparse_mlp_apply(sparse_p, x, None)

        fwd_ms = host_ms(forward)
        busy, sddmm_ms = profile_device(lambda: step(vals, x, y),
                                        part="sddmm_kernel")
        print(f"train method={method} ({kname}): losses "
              + ", ".join(f"{v:.6f}" for v in losses)
              + f"; step cold {cold:.3f} ms, warm {warm:.3f} ms (median of "
              f"{TRAIN_STEPS - 1}); forward only {fwd_ms:.3f} ms, "
              f"step/forward {warm / fwd_ms:.2f}x; device busy "
              f"{busy:.3f} ms of a warm step, the 3 SDDMMs {sddmm_ms:.3f} "
              f"(idle share {1 - busy / warm:.3f}); device memory "
              f"{held:.3f} GiB held before the steps (dense and pruned "
              f"FFN, plans, x, y), "
              f"{peak:.3f} GiB peak during them; "
              f"plans built during the steps {replans}; launches per step "
              f"{per_step}, bodies {bodies}; {card}")
        for name, ran in bodies.items():
            if ran != ({"f32x4": counts[name]} if counts[name] else {}):
                raise AssertionError(f"train {method}: {name} ran bodies "
                                     f"{ran}, expected f32x4 only")
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


def to_device(tree, dev):
    """A copy of a params tree (dicts, lists, tensors) on ``dev``."""
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.to(dev), tree)


def skewed_sizes(gen, n_experts, n_blocks, tt, dev):
    """Padded group sizes of ``n_blocks`` blocks of ``tt`` over the
    experts, skewed (weight 1/(e+1)): hot experts own several blocks,
    some own none."""
    weights = 1.0 / torch.arange(1, n_experts + 1, dtype=torch.float32,
                                 device=dev)
    picks = torch.multinomial(weights, n_blocks, replacement=True,
                              generator=gen)
    sizes = torch.zeros(n_experts, dtype=torch.int32, device=dev)
    sizes.index_add_(0, picks, torch.full_like(picks, tt, dtype=torch.int32))
    return sizes


def parity_moe(dev) -> float:
    """The grouped GEMM kernel against its plain version on the card
    (through ``ops.moe_group_gemm``, one counted launch a call): the
    reference's sweep (tests/test_kernels.py, tt 8), a ragged case with
    two row tiles per block, the wgmma body's edges and OLMoE's two
    full-width shapes with skewed group sizes that leave some experts
    empty; f32 and bf16, each call's body held to ``moe_gemm.body_for``.
    Returns the worst |error|."""
    from repro_torch.kernels import moe_gemm, ops
    e_full, tt_full = MOE_EXPERTS, MOE_TT
    cases = [(f"sweep {sizes}", sizes, din, dout, 8, None)
             for sizes, din, dout in MOE_SWEEP]
    cases.append(("ragged (192, 0, 96) tt 96", (192, 0, 96), 100, 200, 96,
                  None))
    cases += [(name, sizes, din, dout, tt, tokens)
              for name, (sizes, din, dout, tt, tokens) in MOE_EDGES.items()]
    for din, dout in MOE_FULL:
        cases.append((f"full {MOE_TOKENS}x{din}->{dout}", None, din, dout,
                      tt_full, None))
    worst, seed = 0.0, 700
    for name, sizes, din, dout, tt, tokens in cases:
        seed += 1
        g = torch.Generator(device=dev).manual_seed(seed)
        if sizes is None:
            sz = skewed_sizes(g, e_full, MOE_TOKENS // tt_full, tt_full, dev)
            empty = int((sz == 0).sum())
            if not empty or int(sz.max()) <= tt_full:
                raise AssertionError(f"moe parity {name}: sizes {sz} are "
                                     "not skewed")
            note = (f"{empty} empty groups, largest "
                    f"{int(sz.max()) // tt_full} blocks")
        else:
            sz = torch.tensor(sizes, dtype=torch.int32, device=dev)
            note = f"sizes {sizes}"
        tokens = tokens or int(sz.sum())
        e = sz.numel()
        if tokens > int(sz.sum()):
            note += f", {(tokens - int(sz.sum())) // tt} tail blocks"
        x32 = torch.randn(tokens, din, generator=g, device=dev)
        w32 = torch.randn(e, din, dout, generator=g, device=dev) * din ** -0.5
        for dt in (torch.float32, torch.bfloat16):
            tol = TOL[str(dt).removeprefix("torch.")]
            x, w = x32.to(dt), w32.to(dt)
            before = moe_gemm.LAUNCHES
            moe_gemm.LAUNCHES_BY_BODY.clear()
            got = ops.moe_group_gemm(x, w, sz, tt=tt, impl="cuda")
            body = moe_gemm.body_for(dt, tt, din, dout)
            if moe_gemm.LAUNCHES - before != 1 or \
                    moe_gemm.LAUNCHES_BY_BODY != {body: 1}:
                raise AssertionError(
                    f"moe_gemm {name} {dt}: counted "
                    f"{moe_gemm.LAUNCHES - before} launches, by body "
                    f"{moe_gemm.LAUNCHES_BY_BODY}; body_for names {body}")
            want = ops.moe_group_gemm(x, w, sz, tt=tt, impl="torch")
            torch.cuda.synchronize()
            d, r = check_close(f"moe_gemm {name} {dt}", got, want, tol)
            if tokens > int(sz.sum()) and \
                    got[int(sz.sum()):].float().abs().max().item() != 0:
                raise AssertionError(f"moe_gemm {name} {dt}: a tail block "
                                     "is not zeros")
            print(f"parity moe_gemm  {name:28s} ({tokens}, {din}) x ({e}, "
                  f"{din}, {dout}) tt {tt} {str(dt):14s} {body:5s}: max_abs "
                  f"{d:.3e} (tol rtol {tol['rtol']} atol {tol['atol']}; "
                  f"worst |d|/(atol+rtol|want|) {r:.3f}); {note}")
            worst = max(worst, d)
        del x32, w32
    return worst


def moe_bound(tokens, d_in, d_out, n_live, itemsize):
    """(ms, "bytes"/"operations", bytes, flops) of one grouped GEMM: x and
    the weights of the ``n_live`` experts that own a block read once, the
    output written once, against 2·tokens·d_in·d_out operations at the
    operands' peak (bf16 tensor cores, or f32 outside them)."""
    nbytes = (tokens * d_in + n_live * d_in * d_out + tokens * d_out) \
        * itemsize
    flops = 2 * tokens * d_in * d_out
    peak = BF16_FLOP_PER_S if itemsize == 2 else FP32_FLOP_PER_S
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / peak
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations",
            nbytes, flops)


def timing_moe(dev, card) -> dict:
    """The grouped GEMM at the MoE path's shapes (OLMoE-1B-7B, bf16, every
    expert one block of 64 — the capacity at batch 4 x 32 and at decode):
    kernel, plain version, ``torch.bmm`` over the (E, cap, d) layout (the
    yardstick; the port never calls it) and the bound, per launch and per
    MoE layer (w1 + w3: 4096 x 2048 -> 1024, w2: 4096 x 1024 -> 2048);
    and the per-forward f32 -> bf16 weight cast the path keeps from the
    reference."""
    from repro_torch.kernels import moe_gemm, ops, ref
    e, tt, tokens = MOE_EXPERTS, MOE_TT, MOE_TOKENS
    sizes = torch.full((e,), tokens // e, dtype=torch.int32, device=dev)
    block_expert = moe_gemm.plan_groups(sizes, tokens, tt)
    layer = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, cast_ms=0.0,
                 bytes=0, flops=0, body="wgmma")
    for (din, dout), uses in zip(MOE_FULL, (2, 1)):
        g = torch.Generator(device=dev).manual_seed(40 + din)
        x = torch.randn(tokens, din, generator=g, device=dev).to(
            torch.bfloat16)
        w32 = torch.randn(e, din, dout, generator=g, device=dev) * \
            din ** -0.5
        w = w32.to(torch.bfloat16)
        kern = lambda: moe_gemm.moe_group_gemm_cuda(x, w, block_expert,
                                                    tt=tt)
        moe_gemm.LAUNCHES_BY_BODY.clear()
        plain = lambda: ref.moe_group_gemm_ref(x, w, block_expert, tt)
        lib = lambda: torch.bmm(x.view(e, tokens // e, din), w)
        out, want = kern(), lib().reshape(tokens, dout)
        torch.cuda.synchronize()
        body = moe_gemm.body_for(x.dtype, tt, din, dout)
        if moe_gemm.LAUNCHES_BY_BODY != {body: 1} or body != "wgmma":
            raise AssertionError(f"timing moe_gemm {din}->{dout}: ran "
                                 f"{moe_gemm.LAUNCHES_BY_BODY}, body_for "
                                 f"names {body}")
        # The yardstick computes the same function (loose: timing only).
        if not torch.allclose(out.float(), want.float(), rtol=2e-2,
                              atol=2e-2):
            raise AssertionError("torch.bmm computes something else")
        bound, by, nbytes, flops = moe_bound(tokens, din, dout, e, 2)
        k_ms = time_ms(kern)
        p_ms = time_ms(plain, reps=5, inner=3)
        l_ms = time_ms(lib)
        c_ms = time_ms(lambda: w32.to(torch.bfloat16))
        print(f"timing moe_gemm {tokens}x{din}->{dout} E {e} bf16 ({body}): "
              f"kernel {k_ms:.4f} ms ({k_ms / bound:.3f}x bound, "
              f"{k_ms / l_ms:.3f}x torch.bmm), plain {p_ms:.4f} ms, "
              f"torch.bmm {l_ms:.4f} ms, bound {bound:.6f} ms ({by}: "
              f"{nbytes} B, {flops} flop); the f32->bf16 cast of this "
              f"weight {c_ms:.4f} ms; {card}")
        layer["ms"] += uses * k_ms
        layer["plain_ms"] += uses * p_ms
        layer["library_ms"] += uses * l_ms
        layer["bytes"] += uses * nbytes
        layer["flops"] += uses * flops
        layer["cast_ms"] += uses * c_ms
        del x, w, w32
    t_b = layer["bytes"] / HBM_BYTES_PER_S
    t_o = layer["flops"] / BF16_FLOP_PER_S
    layer["bound_ms"] = max(t_b, t_o) * 1e3
    layer["bound_by"] = "bytes" if t_b >= t_o else "operations"
    print(f"timing moe_gemm per MoE layer (w1+w3+w2): kernel "
          f"{layer['ms']:.4f} ms ({layer['ms'] / layer['bound_ms']:.3f}x "
          f"bound, {layer['ms'] / layer['library_ms']:.3f}x torch.bmm), "
          f"plain {layer['plain_ms']:.4f} ms, torch.bmm "
          f"{layer['library_ms']:.4f} ms, bound {layer['bound_ms']:.6f} ms "
          f"({layer['bound_by']}: {layer['bytes']} B, {layer['flops']} "
          f"flop); the three weight casts {layer['cast_ms']:.4f} ms; {card}")
    return layer


def hold_moe_layers(cfg, params, prompt, dev, read_counts,
                    layers=MOE_HOLD_LAYERS):
    """The MoE blocks of ``layers`` (OLMoE-1B-7B's 0 and 15 by default):
    ``moe_apply`` on the same input h (the layer's own, from the prompt)
    once through the kernel and once through its plain version
    (``impl="torch"``).  The router is the
    same torch code on the same h, so the routing is identical and only
    the grouped GEMMs differ.  bf16 compute at 2e-2, and f32 compute at
    the reference's MoE tolerance 2e-4."""
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.models import moe
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    worst = 0.0
    with torch.no_grad():
        x = M.embed_inputs(params, cfg, {"tokens": prompt})
        for i, lp in enumerate(params["blocks"]):
            a, _ = L.attention_apply(lp["attn"], L.norm_apply(
                lp["ln1"], x, cfg.norm), cfg)
            x = x + a
            h = L.norm_apply(lp["ln2"], x, cfg.norm)
            if i in layers:
                for c, hh, tol in ((cfg, h, MOE_TOL["bfloat16"]),
                                   (cfg32, h.float(), MOE_TOL["float32"])):
                    before = read_counts()["moe_gemm"]
                    got, aux = moe.moe_apply(lp["moe"], hh, c)
                    mid = read_counts()["moe_gemm"]
                    want, _ = moe.moe_apply(lp["moe"], hh, c, impl="torch")
                    if (mid - before, read_counts()["moe_gemm"] - mid) != \
                            (3, 0):
                        raise AssertionError(
                            f"layer {i}: the kernel run launched "
                            f"{mid - before}, the plain run "
                            f"{read_counts()['moe_gemm'] - mid}")
                    torch.cuda.synchronize()
                    d, r = check_close(f"moe layer {i} {c.compute_dtype}",
                                       got, want, tol)
                    xt = hh.reshape(-1, c.d_model)
                    if not torch.equal(moe.route(lp["moe"], xt, c)[1],
                                       moe.route(lp["moe"], xt, c)[1]):
                        raise AssertionError(f"layer {i}: the routing is "
                                             "not reproducible")
                    print(f"moe layer {i:2d} {c.compute_dtype:8s} kernel vs "
                          f"plain on h {tuple(hh.shape)}: max |d| {d:.3e}, "
                          f"max |y| {want.abs().max().item():.3f} (tol rtol "
                          f"{tol['rtol']} atol {tol['atol']}; worst ratio "
                          f"{r:.3f}); aux loss {aux.item():.6f}")
                    worst = max(worst, d)
            y, _ = moe.moe_apply(lp["moe"], h, cfg)
            x = x + y
    return worst


def run_generate(cfg, params, prompt, dev, card, reset_counts, read_counts,
                 label, gen=GEN_LEN):
    """``generate`` at batch x prompt x ``gen``, each forward timed;
    prints and returns (tokens, counts, times, peak GiB)."""
    from repro_torch.launch import serve
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    reset_counts()
    out = serve.generate(cfg, params, prompt, gen, times=times)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    total = sum(times)
    b, s = prompt.shape
    if out.shape != (b, s + gen) or not torch.equal(out[:, :s], prompt) \
            or int(out.min()) < 0 or int(out.max()) >= cfg.vocab_size:
        raise AssertionError(f"{label}: bad tokens {tuple(out.shape)}")
    print(f"generate {label}: batch {b} x prompt {s} x gen {gen}: "
          f"prefill {times[0]:.3f} ms, decode step median "
          f"{statistics.median(times[1:]):.3f} ms (min {min(times[1:]):.3f}, "
          f"max {max(times[1:]):.3f}), {len(times)} forwards in "
          f"{total:.3f} ms, {b * gen / (total / 1e3):.1f} tok/s "
          f"(generated tokens over the synchronised forwards); peak device "
          f"memory {peak:.3f} GiB; launches {counts}; {card}")
    print(f"generate {label}: tokens[0] {out[0, s:].tolist()}")
    return out, counts, times, peak


def decode(dev, card, reset_counts, read_counts) -> dict:
    """Greedy decode (``generate``) of OLMoE-1B-7B at full width, the MoE
    FFNs through the grouped GEMM kernel; its layers 0 and 15 held against
    the plain version; the smoke OLMoE on the card against the CPU; and
    Llama-3.2-1B (the GQA decode path, no kernel of ours) timed.  Returns
    the grouped GEMM's launches in the OLMoE run and its worst |error|."""
    from repro_torch import tree
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.engine import clear_cache
    from repro_torch.kernels import moe_gemm
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.runtime import steps
    clear_cache()               # the earlier phases' plans
    torch.cuda.empty_cache()
    cfg = get_config("olmoe-1b-7b")
    print(f"model {cfg.name}: {cfg.num_layers} layers (no depth cut), "
          f"d_model {cfg.d_model}, heads {cfg.num_heads}/{cfg.num_kv_heads} "
          f"(head_dim {cfg.head_dim}), {cfg.num_experts} experts top-"
          f"{cfg.top_k}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size} untied; "
          f"{cfg.param_dtype} params, {cfg.compute_dtype} compute; random "
          f"weights from seed {SEED}; batch {SERVE_BATCH} x prompt "
          f"{SERVE_PROMPT} x gen {GEN_LEN}")
    params = M.init_params(cfg, SEED, dev)
    n_params = sum(t.numel() for t in tree.leaves(params))
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    prompt = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                           generator=g, device=dev)
    print(f"params {n_params} ({n_params * 4 / 1e9:.2f} GB f32) on the card")
    forwards = GEN_LEN + 1
    per_forward = 3 * cfg.num_layers
    out, counts, times, peak = run_generate(
        cfg, params, prompt, dev, card, reset_counts, read_counts,
        "olmoe-1b-7b")
    want = dict.fromkeys(counts, 0)
    want["moe_gemm"] = per_forward * forwards
    if counts != want:
        raise AssertionError(f"generate launched {counts}, expected {want}")
    bodies = dict(moe_gemm.LAUNCHES_BY_BODY)
    print(f"grouped GEMM bodies over the generate run: {bodies}")
    if bodies != {"wgmma": want["moe_gemm"]}:
        raise AssertionError(f"generate's grouped GEMMs ran {bodies}, "
                             f"expected {want['moe_gemm']} wgmma")
    # One prefill and one decode step alone: 48 launches each.
    prefill = steps.make_prefill_step(cfg, cache_len=SERVE_PROMPT + GEN_LEN
                                      + 8)
    decode_step = steps.make_decode_step(cfg)
    with torch.no_grad():
        reset_counts()
        st = prefill(params, {"tokens": prompt})
        n_pre = read_counts()["moe_gemm"]
        tok = st["logits"][:, -1].argmax(-1)[:, None]
        reset_counts()
        decode_step(params, st["caches"], {"tokens": tok}, st["pos"])
        n_dec = read_counts()["moe_gemm"]
    print(f"grouped GEMM launches: prefill {n_pre}, one decode step {n_dec} "
          f"(expected {per_forward} each); over the generate run "
          f"{counts['moe_gemm']} (expected {per_forward} x {forwards})")
    if (n_pre, n_dec) != (per_forward, per_forward):
        raise AssertionError("launches per forward differ from 3 a layer")

    def one_prefill():
        with torch.no_grad():
            prefill(params, {"tokens": prompt})

    def one_step():
        with torch.no_grad():
            decode_step(params, st["caches"], {"tokens": tok}, st["pos"])

    pre_ms = host_ms(one_prefill)
    pre_busy = profile_device(one_prefill, top=4)
    step_ms = host_ms(one_step)
    busy, gemm_ms = profile_device(one_step, top=10,
                                   part="moe_gemm_wgmma_kernel")
    print(f"profile prefill: device busy {pre_busy:.3f} ms of the "
          f"{pre_ms:.3f} ms warm prefill (host clock, median of 5; the "
          f"generate run's first prefill {times[0]:.3f} ms includes CUDA's "
          f"lazy set-up; idle share {1 - pre_busy / pre_ms:.3f}); {card}")
    print(f"profile decode step: device busy {busy:.3f} ms of the "
          f"{step_ms:.3f} ms warm step (host clock, median of 5; idle share "
          f"{1 - busy / step_ms:.3f}); steady decode "
          f"{SERVE_BATCH * 1e3 / step_ms:.1f} tok/s (batch / warm step); "
          f"grouped GEMM (wgmma) {gemm_ms:.3f} ms of the device time "
          f"({gemm_ms / busy:.3f}); {card}")
    worst = hold_moe_layers(cfg, params, prompt, dev, read_counts)
    del params, st, one_step, one_prefill
    torch.cuda.empty_cache()

    # The smoke OLMoE, f32 compute, on the card and on the CPU: the same
    # tokens.
    scfg = dataclasses.replace(get_smoke_config("olmoe-1b-7b"),
                               compute_dtype="float32")
    sp_cpu = M.init_params(scfg, SEED, "cpu")
    sprompt = torch.randint(0, scfg.vocab_size, (2, 16),
                            generator=torch.Generator().manual_seed(3))
    want_tok = serve.generate(scfg, sp_cpu, sprompt, GEN_LEN)
    reset_counts()
    got_tok = serve.generate(scfg, to_device(sp_cpu, dev), sprompt.to(dev),
                             GEN_LEN)
    n_smoke = read_counts()["moe_gemm"]
    same = torch.equal(got_tok.cpu(), want_tok)
    print(f"smoke {scfg.name} f32 generate (2 x 16 x {GEN_LEN}): card "
          f"(grouped GEMM kernel, {n_smoke} launches) vs CPU (plain "
          f"version): tokens equal {same}; {got_tok[0, 16:].tolist()}")
    if not same or not n_smoke:
        raise AssertionError("smoke generate: the card and the CPU differ")

    # Llama-3.2-1B: the GQA decode path (32 query / 8 KV heads), timed.
    lcfg = get_config("llama3.2-1b")
    lparams = M.init_params(lcfg, SEED, dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    lprompt = torch.randint(0, lcfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                            generator=g, device=dev)
    run_generate(lcfg, lparams, lprompt, dev, card, reset_counts,
                 read_counts, "llama3.2-1b")
    del lparams
    torch.cuda.empty_cache()
    return dict(launches=counts["moe_gemm"], worst=worst, peak=peak,
                times=times)


# The archs phase: the eight architectures beyond Llama and OLMoE.
# Teacher forcing — prefill + decode steps against the full forward of the
# same inputs.  At f32 compute the two paths differ in summation order
# only, so f32 holds the algorithm (a wrong window, cache or state), at the
# reference's bar (tests/test_models.py, test_prefill_decode_consistency).
# At bf16 compute, the served path, they round at other places (the SSD's
# bf16 decay in a prefill against f32 in a step, a longer sequence's
# matmul shapes), and a flipped bf16 rounding of the residual stream
# travels through every later layer of a random-weight model.
# ``bf16_depth_gaps`` reads that gap on cuts of the same weights at
# BF16_DEPTHS, beside a decode with a fault put in, and the bf16 bar
# stands between the two readings (PERF.md §6).  The bf16 cast
# order itself is held against the JAX package on the CPU
# (tests/test_torch_archs.py).
TEACHER_TOL = dict(rtol=3e-2, atol=3e-2)
TEACHER_BF16_REL_FRO = 0.1
# arch -> (depths, faults the bar must catch, faults only read).  "stale"
# decodes every step from the prefill's state (the step's new state
# dropped); "pos+1" decodes each token one position late (RoPE and the KV
# slot); "state_bf16" keeps the recurrent state (SSD "ssm", RG-LRU "h")
# in bf16 between forwards, which moves the logits less than bf16's own
# noise (PERF.md §6), so no teacher-forcing bar can see it.
BF16_DEPTHS = {"mamba2-1.3b": ((2, 8, 24, 48), ("stale",), ("state_bf16",)),
               "granite-3-2b": ((2, 8, 24, 40), ("pos+1",), ())}
# Two SpMM methods' logits at f32 compute: f32 sums in other orders
# through 26 layers, where bf16 compute's gap is ~2e-2.
METHODS_F32_REL_FRO = 1e-3
# RecurrentGemma-2B's dense generate: a prompt past its local window
# (2048), a multiple of the reference's 1024-query prefill chunk.
RG_LONG = dict(batch=1, prompt=3072, gen=GEN_LEN)
# Mamba2-1.3B: four of its 128-token SSD chunks, so the inter-chunk
# recurrence runs.
MAMBA_GEN = dict(batch=4, prompt=512, gen=GEN_LEN)
# Mixtral-8x22B's cut: its 56 layers hold 141 B params, 564 GB at f32;
# one card holds 80 GB.  Two layers keep every width.
MIXTRAL_LAYERS, MIXTRAL_GEN = 2, 4
# (arch, layers kept or None for full depth): the dense and embeddings
# models, prefill 4 x 32 and 4 decode steps each.  The three cut models
# hold 35-76 B params (140-300 GB at f32) at full depth.
ARCH_RUNS = (("granite-3-2b", None), ("musicgen-large", None),
             ("command-r-35b", 2), ("qwen2-72b", 2), ("internvl2-76b", 2))
ARCH_STEPS = 4
# The new smoke configs at f32 compute, the card vs the CPU.
NEW_ARCHS = ("command-r-35b", "granite-3-2b", "internvl2-76b",
             "mamba2-1.3b", "mixtral-8x22b", "musicgen-large", "qwen2-72b",
             "recurrentgemma-2b")


def cut_config(cfg, layers):
    """``cfg`` with its first ``layers`` layers (one segment of its one
    block type), every width kept."""
    (btype,) = set(cfg.block_types())
    return dataclasses.replace(cfg, num_layers=layers,
                               segments=(((btype,), layers),))


def seeded_inputs(cfg, b, s, dev, seed):
    """Tokens (b, s), or unit-normal embeds (b, s, d) for an embeddings
    model (its frontend is a stub), from ``seed`` on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if cfg.input_mode == "tokens":
        return {"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                        generator=g, device=dev)}
    return {"embeds": torch.randn(b, s, cfg.d_model, generator=g,
                                  device=dev)}


def teacher_logits(params, cfg, batch, at):
    """f32 logits (b, len(at), vocab) of the full forward over ``batch``
    at positions ``at``."""
    from repro_torch.models import layers as L
    from repro_torch.models import losses
    from repro_torch.models import model as M
    with torch.no_grad():
        h = M.embed_inputs(params, cfg, batch)
        h, _, _ = M.forward(params, cfg, h)
        h = L.norm_apply(params["final_norm"], h[:, at], cfg.norm)
        return losses.logits(h, M.unembed_matrix(params, cfg),
                             cfg.logit_softcap)


def stepped_logits(params, cfg, batch, s, steps_n, times=None, fault=None):
    """f32 logits (b, 1 + steps_n, vocab): the prefill of ``batch``'s
    first ``s`` positions, then ``steps_n`` decode steps fed its next
    positions.  With ``times``, a warm prefill first, then each forward's
    host ms (synchronised) appended.  ``fault`` (a BF16_DEPTHS fault)
    puts a known error into the decode."""
    from repro_torch.runtime import steps
    prefill = steps.make_prefill_step(cfg, cache_len=s + steps_n + 8)
    decode = steps.make_decode_step(cfg)
    cut = {k: v[:, :s] for k, v in batch.items()}

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        if times is not None:
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return out

    def hurt(caches):
        if fault != "state_bf16":
            return caches
        return [{k: v.bfloat16().to(v.dtype) if k in ("ssm", "h") else v
                 for k, v in c.items()} for c in caches]

    with torch.no_grad():
        if times is not None:
            prefill(params, cut)
            torch.cuda.synchronize()
        st = timed(prefill, params, cut)
        got = [st["logits"][:, 0]]
        caches, pos = hurt(st["caches"]), st["pos"]
        for i in range(s, s + steps_n):
            lg, new = timed(decode, params, caches,
                            {k: v[:, i:i + 1] for k, v in batch.items()},
                            pos + 1 if fault == "pos+1" else pos)
            caches = caches if fault == "stale" else hurt(new)
            got.append(lg[:, 0])
            pos = pos + 1
    return torch.stack(got, dim=1)


def teacher_forcing(label, params, cfg, batch, s, steps_n):
    """Prefill + ``steps_n`` decode steps against the teacher-forced full
    forward at the positions they predict from: at ``cfg``'s compute
    (bf16), timed, with the relative Frobenius gap below
    TEACHER_BF16_REL_FRO (for an MoE model printed only: the reference
    holds its MoE archs at f32 alone); and at f32 compute within
    TEACHER_TOL.  Returns (prefill ms, decode-step ms median) of the bf16
    run, host clock, synchronised."""
    bf16_held = not cfg.num_experts
    at = list(range(s - 1, s + steps_n))
    times = []
    got = stepped_logits(params, cfg, batch, s, steps_n, times)
    if not torch.isfinite(got).all():
        raise AssertionError(f"{label}: non-finite logits")
    want = teacher_logits(params, cfg, batch, at)
    d, rel = logits_gap(got, want)
    print(f"{label} {cfg.compute_dtype}: warm prefill {times[0]:.3f} ms, "
          f"decode step median {statistics.median(times[1:]):.3f} ms (host "
          f"clock, synchronised); prefill + {steps_n} decode steps vs the "
          f"teacher-forced full forward: max |d| {d:.4e}, relative "
          f"Frobenius {rel:.4e}, max |logit| {want.abs().max().item():.3f} "
          + (f"(bar: relative Frobenius {TEACHER_BF16_REL_FRO})"
             if bf16_held else "(printed, not held)"))
    if bf16_held and not rel <= TEACHER_BF16_REL_FRO:
        raise AssertionError(f"{label}: bf16 teacher forcing {rel:.3e}")
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    got = stepped_logits(params, cfg32, batch, s, steps_n)
    want = teacher_logits(params, cfg32, batch, at)
    d, r = check_close(f"{label} f32 prefill + decode vs teacher forcing",
                       got, want, TEACHER_TOL)
    print(f"{label} float32: prefill + {steps_n} decode steps vs the "
          f"teacher-forced full forward: max |d| {d:.3e}, max |logit| "
          f"{want.abs().max().item():.3f} (tol rtol {TEACHER_TOL['rtol']} "
          f"atol {TEACHER_TOL['atol']}; worst ratio {r:.3f})")
    return times[0], statistics.median(times[1:])


def bf16_depth_gaps(arch, params, cfg, batch, s, steps_n) -> dict:
    """The witness for the bf16 bar: the bf16 teacher-forcing gap
    (relative Frobenius) of the model's first L layers, the same weights,
    at each of BF16_DEPTHS[arch], sound and with each of its faults put
    into the decode.  Raises unless every sound gap is within the bar and
    every fault the bar must catch is outside it.  Returns {L: {None or
    fault: gap}}."""
    depths, caught, read = BF16_DEPTHS[arch]
    faults = caught + read
    at = list(range(s - 1, s + steps_n))
    gaps = {}
    for depth in depths:
        c = cut_config(cfg, depth)
        p = dict(params, blocks=params["blocks"][:depth])
        want = teacher_logits(p, c, batch, at)
        gaps[depth] = {f: logits_gap(stepped_logits(
            p, c, batch, s, steps_n, fault=f), want)[1]
            for f in (None, *faults)}
        print(f"{arch} first {depth} of {cfg.num_layers} layers, bf16: "
              f"prefill + {steps_n} decode steps vs teacher forcing, "
              f"relative Frobenius {gaps[depth][None]:.4e} sound; with a "
              "fault " + ", ".join(f"{f} {gaps[depth][f]:.4e}"
                                   for f in faults)
              + f" (bar {TEACHER_BF16_REL_FRO}; caught: {caught})")
        if not (gaps[depth][None] <= TEACHER_BF16_REL_FRO < min(
                gaps[depth][f] for f in caught)):
            raise AssertionError(f"{arch} at {depth} layers: the bf16 bar "
                                 "does not part the sound run from faults")
    return gaps


def archs_recurrentgemma(dev, card, reset_counts, read_counts) -> dict:
    """RecurrentGemma-2B at full width: pruned-FFN serving by the §5.4
    rule (row-split) and with merge forced, the served plans of the first
    and last layers held against their plain versions, and the smoke
    model's pruned forward on the card against the CPU; then a dense
    ``generate`` past the local window.  Returns the serving runs'
    launches and each SpMM kernel's worst |d| against its plain version."""
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.engine import clear_cache
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    cfg = get_config("recurrentgemma-2b")
    print(f"model {cfg.name}: {cfg.num_layers} layers (no depth cut: "
          f"{cfg.segments}), d_model {cfg.d_model}, lru_width "
          f"{cfg.lru_width}, d_ff {cfg.d_ff}, heads {cfg.num_heads}/"
          f"{cfg.num_kv_heads} (head_dim {cfg.head_dim}), {cfg.attention} "
          f"window {cfg.window}, vocab {cfg.vocab_size} tied; "
          f"{cfg.param_dtype} params, {cfg.compute_dtype} compute; random "
          f"weights from seed {SEED}")
    params = M.init_params(cfg, SEED, dev)
    prompt = seeded_inputs(cfg, SERVE_BATCH, SERVE_PROMPT, dev,
                           SEED + 1)["tokens"]
    runs = (("rowsplit_spmm", "auto", "rowsplit"),
            ("merge_spmm", "merge", "merge"))
    served = serve_methods(cfg, params, prompt, runs, dev, card,
                           reset_counts, read_counts)
    launches, worst = {}, {}
    for kname, _, planned in runs:
        launches[kname] = served[planned]["counts"][kname]
        worst[kname] = hold_served_plans(
            f"{cfg.name} {planned}", served[planned]["blocks"],
            (0, cfg.num_layers - 1), kname, dev, read_counts)
    logits = {m: run["logits"] for m, run in served.items()}
    # At bf16 compute the methods' f32 sums, in other orders, flip bf16
    # roundings that travel through 26 layers: the gap is printed; each
    # method is held against its plain version above and at f32 below.
    d, rel = logits_gap(logits["rowsplit"], logits["merge"])
    print(f"{cfg.name} logits row-split vs merge, bf16 compute: max |d| "
          f"{d:.4e}, relative Frobenius {rel:.4e} (printed, not held)")
    print(f"{cfg.name} logits row-split vs merge bit-identical: "
          f"{torch.equal(logits['rowsplit'], logits['merge'])} (Llama-3.2-1B "
          "at its shapes: bit-identical)")
    # The same served plans at f32 compute: the methods' f32 sums only.
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    fwd32 = serve.make_pruned_forward(cfg32)
    with torch.no_grad():
        lg32 = {m: fwd32(params, run["blocks"], prompt)
                for m, run in served.items()}
    d, rel = logits_gap(lg32["rowsplit"], lg32["merge"])
    print(f"{cfg.name} logits row-split vs merge at f32 compute: max |d| "
          f"{d:.4e}, relative Frobenius {rel:.4e} (tol "
          f"{METHODS_F32_REL_FRO})")
    if not rel <= METHODS_F32_REL_FRO:
        raise AssertionError(f"{cfg.name}: the methods differ at f32")
    del logits, served, lg32
    clear_cache()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"device memory held after the served plans are freed: "
          f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB (f32 params "
          f"{sum(t.numel() for t in tree.leaves(params)) * 4 / 2**30:.2f} "
          "GiB)")
    smoke_pruned_parity(cfg.name, ("rowsplit", "merge"), dev, read_counts)

    # Dense generate past the window: prefill 3072 (the window masks the
    # keys 2048 or more back), then decode steps over a longer cache.
    g = RG_LONG
    batch = seeded_inputs(cfg, g["batch"], g["prompt"], dev, SEED + 2)
    out, counts, _, _ = run_generate(
        cfg, params, batch["tokens"], dev, card, reset_counts, read_counts,
        f"{cfg.name} (window {cfg.window})", gen=g["gen"])
    if any(counts.values()):
        raise AssertionError(f"dense generate launched {counts}")
    teacher_forcing(f"{cfg.name} 1 x {g['prompt']}", params, cfg,
                    {"tokens": out}, g["prompt"], 1)
    del params, out
    torch.cuda.empty_cache()
    return dict(launches=launches, worst=worst)


def archs_mamba(dev, card, reset_counts, read_counts) -> None:
    """Mamba2-1.3B at full width: ``generate`` over 512-token prompts,
    a profiled decode step, teacher forcing and the bf16 depth witness."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.runtime import steps
    cfg = get_config("mamba2-1.3b")
    g = MAMBA_GEN
    print(f"model {cfg.name}: {cfg.num_layers} SSD layers (no depth cut), "
          f"d_model {cfg.d_model}, state {cfg.ssm_state}, head_dim "
          f"{cfg.ssm_head_dim}, expand {cfg.ssm_expand}, chunk "
          f"{cfg.ssm_chunk}, vocab {cfg.vocab_size} tied; random weights "
          f"from seed {SEED}; batch {g['batch']} x prompt {g['prompt']} "
          f"({g['prompt'] // cfg.ssm_chunk} chunks) x gen {g['gen']}")
    params = M.init_params(cfg, SEED, dev)
    batch = seeded_inputs(cfg, g["batch"], g["prompt"], dev, SEED + 3)
    out, counts, _, _ = run_generate(
        cfg, params, batch["tokens"], dev, card, reset_counts, read_counts,
        cfg.name, gen=g["gen"])
    if any(counts.values()):
        raise AssertionError(f"generate launched {counts}")
    prefill = steps.make_prefill_step(cfg, cache_len=g["prompt"] + 8)
    decode = steps.make_decode_step(cfg)
    with torch.no_grad():
        st = prefill(params, batch)
    tok = st["logits"][:, -1].argmax(-1)[:, None]

    def one_step():
        with torch.no_grad():
            decode(params, st["caches"], {"tokens": tok}, st["pos"])

    step_ms = host_ms(one_step)
    busy = profile_device(one_step, top=8)
    print(f"profile {cfg.name} decode step: device busy {busy:.3f} ms of "
          f"the {step_ms:.3f} ms warm step (host clock, median of 5; idle "
          f"share {1 - busy / step_ms:.3f}); steady decode "
          f"{g['batch'] * 1e3 / step_ms:.1f} tok/s; {card}")
    teacher_forcing(f"{cfg.name} {g['batch']} x {g['prompt']}", params,
                    cfg, {"tokens": out}, g["prompt"], ARCH_STEPS)
    bf16_depth_gaps(cfg.name, params, cfg, {"tokens": out}, g["prompt"],
                    ARCH_STEPS)
    del params, st, one_step
    torch.cuda.empty_cache()


def routing_witness(cfg, params, tokens, s) -> list:
    """For each MoE layer: the tokens of ``tokens[:, :s]`` whose top-k
    expert set differs between the forward over those s positions (a
    prefill's) and the forward over all of ``tokens`` (teacher forcing's),
    and the replicas the sorted dispatch drops past an expert's capacity
    in each of the two forwards.  Returns [(flips, drops at s, drops at
    all), ...]."""
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.models import moe
    rows = []
    with torch.no_grad():
        xs = [M.embed_inputs(params, cfg, {"tokens": t})
              for t in (tokens[:, :s], tokens)]
        for lp in params["blocks"]:
            sets, drops = [], []
            for i, x in enumerate(xs):
                a, _ = L.attention_apply(lp["attn"], L.norm_apply(
                    lp["ln1"], x, cfg.norm), cfg)
                x = x + a
                h = L.norm_apply(lp["ln2"], x, cfg.norm)
                xt = h.reshape(-1, cfg.d_model)
                experts = moe.route(lp["moe"], xt, cfg)[1]
                keep = moe._sorted_dispatch(xt, experts, cfg,
                                            moe.TT)[1]["keep"]
                drops.append(int((~keep).sum()))
                sets.append(experts.reshape(*h.shape[:2], -1)[:, :s]
                            .sort(-1).values)
                xs[i] = x + moe.moe_apply(lp["moe"], h, cfg)[0]
            rows.append((int((sets[0] != sets[1]).any(-1).sum()), *drops))
    return rows


def archs_mixtral(dev, card, reset_counts, read_counts) -> dict:
    """Mixtral-8x22B cut to MIXTRAL_LAYERS layers: ``generate`` through the
    grouped GEMM, both MoE blocks held against the kernel's plain version
    (``hold_moe_layers``), and teacher forcing on the first generated row.
    Returns the generate run's launches and the worst |d|.

    Teacher forcing is held on one row, at f32 only, as the reference
    holds its MoE archs (tests/test_models.py,
    test_prefill_decode_consistency).  One row is t <= 64 tokens, within
    the least capacity (one 64-row tile an expert), so no replica drops.
    With four rows an expert that takes more than its capacity drops
    replicas, and the 32-token prefill drops others than the 36-token
    full forward: capacity-limited dispatch is not causal, in the
    reference too (PERF.md §6).  That gap is printed beside
    ``routing_witness``'s drops and routing flips."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import moe_gemm
    from repro_torch.models import model as M
    full = get_config("mixtral-8x22b")
    cfg = cut_config(full, MIXTRAL_LAYERS)
    print(f"model {cfg.name}: cut to {MIXTRAL_LAYERS} of its "
          f"{full.num_layers} layers (at f32 the whole model's params take "
          f"~564 GB; the card holds 80 GB), published widths: d_model "
          f"{cfg.d_model}, {cfg.num_experts} experts top-{cfg.top_k}, d_ff "
          f"{cfg.d_ff}, heads {cfg.num_heads}/{cfg.num_kv_heads}, "
          f"{cfg.attention} window {cfg.window}, vocab {cfg.vocab_size} "
          f"untied; random weights from seed {SEED}")
    params = M.init_params(cfg, SEED, dev)
    prompt = seeded_inputs(cfg, SERVE_BATCH, SERVE_PROMPT, dev,
                           SEED + 4)["tokens"]
    out, counts, _, _ = run_generate(
        cfg, params, prompt, dev, card, reset_counts, read_counts, cfg.name,
        gen=MIXTRAL_GEN)
    bodies = dict(moe_gemm.LAUNCHES_BY_BODY)
    per_forward = 3 * MIXTRAL_LAYERS
    want = dict.fromkeys(counts, 0)
    want["moe_gemm"] = per_forward * (MIXTRAL_GEN + 1)
    print(f"{cfg.name}: grouped GEMM launches {counts['moe_gemm']} "
          f"({per_forward} a forward x {MIXTRAL_GEN + 1} forwards), bodies "
          f"{bodies} (moe_gemm.body_for: "
          f"{moe_gemm.body_for(torch.bfloat16, 64, cfg.d_model, cfg.d_ff)} "
          f"/ {moe_gemm.body_for(torch.bfloat16, 64, cfg.d_ff, cfg.d_model)})")
    if counts != want or bodies != {"wgmma": want["moe_gemm"]}:
        raise AssertionError(f"{cfg.name}: launched {counts} {bodies}, "
                             f"expected {want} all wgmma")
    worst = hold_moe_layers(cfg, params, prompt, dev, read_counts,
                            layers=range(MIXTRAL_LAYERS))
    s = SERVE_PROMPT
    teacher_forcing(f"{cfg.name} 1 x {s}", params, cfg,
                    {"tokens": out[:1]}, s, MIXTRAL_GEN)
    at = list(range(s - 1, s + MIXTRAL_GEN))
    for c in (cfg, dataclasses.replace(cfg, compute_dtype="float32")):
        d, rel = logits_gap(stepped_logits(params, c, {"tokens": out}, s,
                                           MIXTRAL_GEN),
                            teacher_logits(params, c, {"tokens": out}, at))
        print(f"{cfg.name} {SERVE_BATCH} x {s} {c.compute_dtype}: prefill "
              f"+ {MIXTRAL_GEN} decode steps vs teacher forcing, max |d| "
              f"{d:.4e}, relative Frobenius {rel:.4e} (printed, not held); "
              f"a layer, (prompt tokens routed to another top-{cfg.top_k} "
              f"set, replicas dropped at {s} and at {s + MIXTRAL_GEN} "
              f"tokens a row): "
              f"{routing_witness(c, params, out, s)}")
    del params, out
    torch.cuda.empty_cache()
    return dict(launches=want["moe_gemm"], worst=worst)


def archs_dense(dev, card, reset_counts, read_counts) -> None:
    """Granite-3-2B and MusicGen-large at full depth, Command-R-35B,
    Qwen2-72B and InternVL2-76B cut: prefill and decode steps held to
    teacher forcing; no kernel of ours may launch."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    for arch, layers in ARCH_RUNS:
        full = get_config(arch)
        cfg = full if layers is None else cut_config(full, layers)
        depth = "no depth cut" if layers is None else (
            f"cut to {layers} of {full.num_layers} layers: at full depth "
            f"its f32 params do not fit the card")
        print(f"model {arch}: {cfg.num_layers} layers ({depth}), d_model "
              f"{cfg.d_model}, d_ff {cfg.d_ff}, heads {cfg.num_heads}/"
              f"{cfg.num_kv_heads}, vocab {cfg.vocab_size}, norm {cfg.norm}, "
              f"mlp {cfg.mlp}, inputs {cfg.input_mode}, "
              f"{'sinusoidal' if not cfg.rope_theta else 'rope'} positions, "
              f"parallel_block {cfg.parallel_block}, qkv_bias "
              f"{cfg.qkv_bias}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        params = M.init_params(cfg, SEED, dev)
        batch = seeded_inputs(cfg, SERVE_BATCH, SERVE_PROMPT + ARCH_STEPS,
                              dev, SEED + 5)
        reset_counts()
        pre_ms, step_ms = teacher_forcing(
            f"{arch} {SERVE_BATCH} x {SERVE_PROMPT}", params, cfg, batch,
            SERVE_PROMPT, ARCH_STEPS)
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        print(f"{arch}: prefill {pre_ms:.3f} ms, decode step median "
              f"{step_ms:.3f} ms (host clock, synchronised, after a warm "
              f"prefill); peak device memory {peak:.2f} GiB; launches "
              f"{counts}; {card}")
        if any(counts.values()):
            raise AssertionError(f"{arch}: launched {counts}")
        if arch in BF16_DEPTHS:
            bf16_depth_gaps(arch, params, cfg, batch, SERVE_PROMPT,
                            ARCH_STEPS)
        del params, batch
        torch.cuda.empty_cache()


def archs_smoke(dev) -> None:
    """The new smoke configs at f32 compute, TF32 off: prefill and three
    decode steps on the card and on the CPU from the same params and
    inputs; logits and every layer's cache at SMOKE_TOL."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M
    for arch in NEW_ARCHS:
        cfg = dataclasses.replace(get_smoke_config(arch),
                                  compute_dtype="float32")
        p_cpu = M.init_params(cfg, SEED, "cpu")
        p_dev = to_device(p_cpu, dev)
        b_cpu = {k: v.cpu() for k, v in seeded_inputs(
            cfg, 2, 14, dev, SEED + 6).items()}
        worst = 0.0
        runs = {}
        for where, p in (("cpu", p_cpu), ("card", p_dev)):
            b = {k: v.to(p["final_norm"]["scale"].device)
                 for k, v in b_cpu.items()}
            with torch.no_grad():
                caches, lg, pos = M.prefill(p, cfg, {k: v[:, :11] for k, v
                                                     in b.items()},
                                            cache_len=16)
                outs = [(lg, caches)]
                for i in range(11, 14):
                    lg, caches = M.decode_step(
                        p, cfg, caches, {k: v[:, i:i + 1] for k, v in
                                         b.items()}, pos)
                    outs.append((lg, caches))
                    pos = pos + 1
            runs[where] = outs
        for step, ((lw, cw), (lg, cg)) in enumerate(zip(runs["cpu"],
                                                        runs["card"])):
            worst = max(worst, check_close(f"smoke {arch} step {step}",
                                           lg.cpu(), lw, SMOKE_TOL)[0])
            for li, (gc, wc) in enumerate(zip(cg, cw)):
                for name in wc:
                    worst = max(worst, check_close(
                        f"smoke {arch} step {step} layer {li} {name}",
                        gc[name].cpu(), wc[name], SMOKE_TOL)[0])
        print(f"smoke {arch} f32: prefill 2 x 11 + 3 decode steps, card vs "
              f"CPU, logits and caches: max |d| {worst:.3e} (tol rtol "
              f"{SMOKE_TOL['rtol']} atol {SMOKE_TOL['atol']})")


def archs(dev, card, reset_counts, read_counts) -> dict:
    """The ``archs`` phase.  Returns each kernel's main-path launches (the
    RecurrentGemma serving runs and the Mixtral generate run) and its
    worst |d| against its plain version at this phase's shapes."""
    rg = archs_recurrentgemma(dev, card, reset_counts, read_counts)
    archs_mamba(dev, card, reset_counts, read_counts)
    mix = archs_mixtral(dev, card, reset_counts, read_counts)
    archs_dense(dev, card, reset_counts, read_counts)
    archs_smoke(dev)
    return dict(launches=dict(rg["launches"], moe_gemm=mix["launches"]),
                worst=dict(rg["worst"], moe_gemm=mix["worst"]))


def flash_inputs(gen, b, s, h, kvh, dh, dt, dev):
    """Unit-normal q (b, s, h, dh), k and v (b, s, kv, dh) in ``dt``."""
    return tuple(torch.randn(b, s, heads, dh, generator=gen,
                             device=dev).to(dt)
                 for heads in (h, kvh, kvh))


def flash_bound(b, s, h, kvh, dh, itemsize):
    """(ms, "bytes"/"operations", bytes, flops, exp ms) of one causal call:
    q, k, v read once and o written once, against 4·b·h·dh·s(s+1)/2
    operations (Q·Kᵀ and P·V over the triangle) at the operands' peak
    (bf16 tensor cores, or f32 outside them); beside it the time of the
    softmax's b·h·s(s+1)/2 exps at 16 a clock an SM."""
    nbytes = (2 * b * s * h * dh + 2 * b * s * kvh * dh) * itemsize
    flops = 4 * b * h * dh * s * (s + 1) // 2
    peak = BF16_FLOP_PER_S if itemsize == 2 else FP32_FLOP_PER_S
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / peak
    exps = b * h * s * (s + 1) // 2
    exp_ms = exps / (SM_COUNT * EXP_PER_CLOCK * SM_CLOCK_HZ) * 1e3
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations",
            nbytes, flops, exp_ms)


def flash_call(fn, what, dt, dh):
    """One kernel call through ``fn``; returns (output, body) and raises
    unless it launched exactly the body ``flash_attention.body_for`` names
    for (dt, dh)."""
    from repro_torch.kernels import flash_attention
    before = dict(flash_attention.LAUNCHES_BY_BODY)
    out = fn()
    ran = {b: n - before.get(b, 0)
           for b, n in flash_attention.LAUNCHES_BY_BODY.items()
           if n != before.get(b, 0)}
    want = flash_attention.body_for(dt, dh)
    if ran != {want: 1}:
        raise AssertionError(f"flash_attention {what}: launched {ran}, "
                             f"expected one {want} launch")
    return out, want


def parity_flash(dev) -> float:
    """The flash attention kernel against its plain version on the card
    (through ``ops.flash_attention``, one counted launch a call) on
    FLASH_PARITY, f32 and bf16; returns the worst |error|."""
    from repro_torch.kernels import flash_attention, ops
    worst, seed = 0.0, 1100
    for name, (b, s, h, kvh, dh) in FLASH_PARITY:
        for dt in (torch.float32, torch.bfloat16):
            seed += 1
            tol = FLASH_TOL[str(dt).removeprefix("torch.")]
            g = torch.Generator(device=dev).manual_seed(seed)
            q, k, v = flash_inputs(g, b, s, h, kvh, dh, dt, dev)
            before = flash_attention.LAUNCHES
            got, body = flash_call(lambda: ops.flash_attention(q, k, v),
                                   f"{name} {dt}", dt, dh)
            if flash_attention.LAUNCHES - before != 1:
                raise AssertionError(
                    f"flash_attention {name}: counted "
                    f"{flash_attention.LAUNCHES - before} launches")
            want = ops.flash_attention(q, k, v, impl="torch")
            torch.cuda.synchronize()
            d, r = check_close(f"flash_attention {name} {dt}", got, want,
                               tol)
            print(f"parity flash_attention {name:19s} (b, s, h, kv, dh) "
                  f"{(b, s, h, kvh, dh)} {str(dt):14s} {body:8s}: max_abs "
                  f"{d:.3e} (tol rtol {tol['rtol']} atol {tol['atol']}; "
                  f"worst |d|/(atol+rtol|want|) {r:.3f})")
            worst = max(worst, d)
            del q, k, v, got, want
    return worst


def model_qkv(arch, batch, s, dev):
    """Layer 0's q, k, v of ``arch`` at full width: an attention layer
    from ``layers.init_attention`` (seeded), a random prompt through an
    embedding table drawn as the model's, the block's RMSNorm, ``_qkv``
    and RoPE — what ``attention_apply`` hands its attention."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    cfg = get_config(arch)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    p = L.init_attention(gen, cfg)
    embed = L.normal_init(gen, (cfg.vocab_size, cfg.d_model), cfg.pdtype,
                          cfg.d_model ** -0.5)
    tokens = torch.randint(0, cfg.vocab_size, (batch, s), generator=gen,
                           device=dev)
    x = embed[tokens].to(cfg.cdtype)
    del embed
    ln = L.init_norm(cfg.d_model, cfg.norm, cfg.pdtype, dev)
    q, k, v = L._qkv(p, L.norm_apply(ln, x, cfg.norm), cfg)
    positions = torch.arange(s, device=dev)[None, :]
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    return q.contiguous(), k.contiguous(), v.contiguous()


def hold_flash_models(dev, reset_counts, read_counts):
    """The main path: ``ops.flash_attention`` (the kernel) on Llama-3.2-1B's
    and OLMoE-1B-7B's layer-0 q/k/v at full width (FLASH_MODEL_SHAPES, bf16
    compute), counted from 0, then each result held against the model
    path's ``layers.causal_attention`` on the same tensors.  Returns the
    launches and the worst |error|."""
    from repro_torch.kernels import flash_attention, ops
    from repro_torch.models import layers as L
    cases = [(arch, b, s, *model_qkv(arch, b, s, dev))
             for arch in ("llama3.2-1b", "olmoe-1b-7b")
             for b, s in FLASH_MODEL_SHAPES]
    torch.cuda.synchronize()
    reset_counts()
    with torch.no_grad():
        outs = [ops.flash_attention(q, k, v) for *_, q, k, v in cases]
    counts = read_counts()
    bodies = dict(flash_attention.LAUNCHES_BY_BODY)
    want_counts = dict.fromkeys(counts, 0)
    want_counts["flash_attention"] = len(cases)
    print(f"main path: {len(cases)} ops.flash_attention calls on the "
          f"models' q/k/v launched {counts}, by body {bodies}")
    if counts != want_counts:
        raise AssertionError(f"the main path launched {counts}, expected "
                             f"{want_counts}")
    if bodies != {"wgmma": len(cases)}:
        raise AssertionError(f"the main path's flash_attention launches "
                             f"ran the bodies {bodies}, expected "
                             f"{len(cases)} wgmma")
    worst = 0.0
    tol = FLASH_TOL["bfloat16"]
    for (arch, b, s, q, k, v), got in zip(cases, outs):
        want = L.causal_attention(q, k, v)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError(f"flash_attention {arch}: non-finite")
        d, r = check_close(f"flash_attention vs causal_attention {arch} "
                           f"{b}x{s}", got, want, tol)
        print(f"model path {arch:12s} layer 0 at {b} x {s} (q "
              f"{tuple(q.shape)}, k/v {tuple(k.shape)}, {q.dtype}): "
              f"kernel vs layers.causal_attention max |d| {d:.3e}, max "
              f"|o| {want.float().abs().max().item():.3f} (tol rtol "
              f"{tol['rtol']} atol {tol['atol']}; worst ratio {r:.3f})")
        worst = max(worst, d)
    return counts["flash_attention"], worst


def sdpa_backend_ms(lib) -> dict:
    """``lib`` (an SDPA call) timed under each backend alone
    (``torch.nn.attention.sdpa_kernel``): {name: ms, or None where the
    backend declines the call}."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    out = {}
    for be in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
               SDPBackend.CUDNN_ATTENTION):
        try:
            with sdpa_kernel([be]), warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                out[be.name] = time_ms(lib)
        except RuntimeError:
            out[be.name] = None
    return out


def timing_flash(dev, card) -> dict:
    """Kernel, plain version, ``scaled_dot_product_attention(is_causal,
    enable_gqa)`` on (b, h, s, dh) views (the yardstick; the port never
    calls it: its default dispatch is ``library_ms``, each backend alone
    is printed beside it) and the bound, at FLASH_TIMING in bf16 and f32.
    Returns {(model, b, s, dtype): row}."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention, ref
    rows = {}
    for arch, b, s in FLASH_TIMING:
        cfg = get_config(arch)
        h, kvh, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        for dt in (torch.bfloat16, torch.float32):
            dname = str(dt).removeprefix("torch.")
            g = torch.Generator(device=dev).manual_seed(60 + s)
            q, k, v = flash_inputs(g, b, s, h, kvh, dh, dt, dev)
            kern = lambda: flash_attention.flash_attention_cuda(q, k, v)
            plain = lambda: ref.flash_attention_ref(q, k, v)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            lib = lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)
            out, body = flash_call(kern, f"timing {arch} {b}x{s}", dt, dh)
            want = lib().transpose(1, 2)
            torch.cuda.synchronize()
            # The yardstick computes the same function (loose: timing only).
            if not torch.allclose(out.float(), want.float(), rtol=3e-2,
                                  atol=3e-2):
                raise AssertionError("scaled_dot_product_attention computes "
                                     "something else")
            del out, want
            bound, by, nbytes, flops, exp_ms = flash_bound(
                b, s, h, kvh, dh, q.element_size())
            k_ms = time_ms(kern)
            p_ms = time_ms(plain, reps=5, inner=3)
            l_ms = time_ms(lib)
            backends = sdpa_backend_ms(lib)
            print(f"timing flash_attention {arch} b {b} s {s} (h {h}, kv "
                  f"{kvh}, dh {dh}) {dname} {body}: kernel {k_ms:.4f} ms "
                  f"({k_ms / bound:.2f}x bound), plain {p_ms:.4f} ms, "
                  f"sdpa {l_ms:.4f} ms (kernel / sdpa {k_ms / l_ms:.2f}), "
                  f"bound {bound:.6f} ms ({by}: {nbytes} B, {flops} flop); "
                  f"exp limit {exp_ms:.6f} ms; {card}")
            print("  sdpa by backend: " + ", ".join(
                f"{name} " + ("refused" if ms is None else f"{ms:.4f} ms")
                for name, ms in backends.items()))
            if s >= 4096 and dt == torch.bfloat16:
                print("  sdpa's default dispatch, device kernels:")
                profile_device(lib, top=3)
            rows[(arch, b, s, dname)] = dict(
                ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=bound,
                bound_by=by, bytes=nbytes, flops=flops, exp_ms=exp_ms,
                body=body,
                sdpa_backends_ms=backends)
            del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    return rows


def attention(dev, card, reset_counts, read_counts) -> dict:
    """The flash attention phase: parity, the main path against the model
    path's attention, timing.  Returns the summary row's numbers."""
    torch.cuda.empty_cache()
    worst = parity_flash(dev)
    launches, w_model = hold_flash_models(dev, reset_counts, read_counts)
    rows = timing_flash(dev, card)
    row = dict(rows[FLASH_SUMMARY])
    row.update(launches=launches, worst=max(worst, w_model))
    return row


# What ptxas reports, by source: (kernel name as mangled, label).
PTXAS_KERNELS = {
    "rowsplit_spmm.cu": [("rowsplit_kernelILi1EfffEE", "rowsplit f32x4"),
                         ("rowsplit_kernelILi3EfffEE", "rowsplit staged"),
                         ("rowsplit_kernelILi2E13__nv_bfloat16S1_S1_EE",
                          "rowsplit bf16x8"),
                         ("rowsplit_kernelILi0EfffEE", "rowsplit scalar")],
    "sddmm.cu": [("sddmm_kernelILi1EffEE", "sddmm f32x4"),
                 ("sddmm_kernelILi2E13__nv_bfloat16S1_EE", "sddmm bf16x8"),
                 ("sddmm_kernelILi0EffEE", "sddmm scalar")],
    "merge_spmm.cu": [("merge_range_kernelILi1EfffEE", "merge f32x4"),
                      ("merge_range_kernelILi2E13__nv_bfloat16S1_S1_EE",
                       "merge bf16x8"),
                      ("merge_range_kernelILi0EfffEE", "merge scalar"),
                      ("merge_fixup_kernelILi1EfEE", "merge fix-up")],
    "flash_attention.cu": [("flash_wgmma_kernel", "flash_wgmma_kernel")],
    "moe_gemm.cu": [("moe_gemm_wgmma_kernel", "moe_gemm wgmma"),
                    ("moe_gemm_bf16_kernelILb1", "moe_gemm wmma (16-byte)"),
                    ("moe_gemm_bf16_kernelILb0", "moe_gemm wmma (scalar)"),
                    ("moe_gemm_f32_kernel", "moe_gemm simt")],
}


# Bodies that must not spill: the grouped GEMM's wgmma body and the f32
# vector bodies of row-split and the SDDMM (the serving and training
# paths').
NO_SPILLS = ("moe_gemm wgmma", "rowsplit f32x4", "sddmm f32x4")


def print_ptxas(log: str) -> None:
    """What ptxas reported for the row-split, SDDMM and merge kernels'
    bodies, merge's fix-up, the flash attention wgmma body (one instance a
    head dim) and the grouped GEMM's bodies: registers, spills, static
    shared memory and any performance note; fails if a body of NO_SPILLS
    spills.  A library built by an earlier run of the same sources is
    loaded as it is, and ptxas has nothing to report."""
    lines = log.splitlines()
    for src, kernels in PTXAS_KERNELS.items():
        if f"[nvcc {src}]" not in log:
            print(f"ptxas {src}: not run (the library for these sources "
                  "was built before)")
            continue
        for mangled, label in kernels:
            found = False
            for i, line in enumerate(lines):
                if "Function properties for" in line and mangled in line:
                    if mangled == "flash_wgmma_kernel":
                        dh = line.split("flash_wgmma_kernelILi")[1]
                        label = f"flash_wgmma_kernel<{dh.split('E')[0]}>"
                    spills = lines[i + 1].strip()
                    print(f"ptxas {label}: {spills}; "
                          f"{lines[i + 2].replace('ptxas info    : ', '')}"
                          .strip())
                    if label in NO_SPILLS and not spills.startswith(
                            "0 bytes stack frame, 0 bytes spill stores"):
                        raise AssertionError(f"ptxas: {label} spills")
                    found = True
                elif mangled in line and "(C7" in line:
                    print(f"ptxas note: {line.strip()}")
            if not found:
                raise AssertionError(f"ptxas reported no {mangled}")


# ----------------------------------------------------- dense training --
# The train CLI's defaults: batch 8 x 128, lr 3e-4, warmup 20, 100 steps.
DENSE_BATCH, DENSE_SEQ, DENSE_CHUNK = 8, 128, 128
DENSE_LR, DENSE_WARMUP, DENSE_TOTAL = 3e-4, 20, 100
DENSE_STEPS = 5                    # timed, after one warm step
FIXED_STEPS, FIXED_LR = 10, 1e-3   # one fixed batch, no warmup
OLMOE_CUT, OLMOE_STEPS = 2, 3      # OLMoE-1B-7B at 2 of its 16 layers
# Card against CPU, and a resumed run against a straight one: bf16
# compute, so the bf16 bar.
DENSE_TOL = dict(rtol=2e-2, atol=2e-2)
# The card's backward against the CPU's at f32 compute (TF32 off): the
# reference's gradient bar (tests/test_spmm_grad.py).
DENSE_GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
# The card's optimizer against the CPU's on equal grads, at an lr whose
# update (~1e-2 an element) stands far above the bar: the f32 bar.
DENSE_OPT_TOL = dict(rtol=2e-5, atol=2e-5)
DENSE_OPT_LR = 1e-2
# Peak rates of one H100 SXM (data sheet, dense): bf16 tensor cores, and
# float32 outside the tensor cores (TF32 is off).
BF16_FLOP_S, F32_FLOP_S = 989e12, 67e12


def tree_gap(what, got, want, tol) -> float:
    """:func:`check_close` over every leaf of two trees, on the CPU;
    returns the largest |d|."""
    from repro_torch.tree import leaves, paths
    return max(check_close(f"{what} {p}", g.cpu(), w.cpu(), tol)[0]
               for p, g, w in zip(paths(want), leaves(got), leaves(want),
                                  strict=True))


def bit_equal(a, b) -> bool:
    from repro_torch.tree import leaves
    return all(x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu())
               for x, y in zip(leaves(a), leaves(b), strict=True))


def dense_batches(cfg, dev, steps, b=None, s=None):
    """The first ``steps`` SyntheticLM batches (b x s, by default the
    phase's) on ``dev``."""
    from repro_torch.data import DataConfig, SyntheticLM
    src = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                 seq_len=s or DENSE_SEQ,
                                 global_batch=b or DENSE_BATCH, seed=SEED))
    return [{k: v.to(dev) for k, v in src.batch_at(i).items()}
            for i in range(steps)]


def run_steps(step, state, batches, times=None):
    """``step`` over ``batches``; returns the state and each step's
    metrics as floats (read after a synchronise)."""
    out = []
    for batch in batches:
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        if times is not None:
            times.append((time.perf_counter() - t0) * 1e3)
        out.append({k: v.item() for k, v in m.items()})
    return state, out


def dense_llama(dev, card) -> None:
    """Llama-3.2-1B at full width: timed steps, the profile, the floors,
    then a falling loss on one fixed batch."""
    from repro_torch.configs import get_config
    from repro_torch.models.losses import chunked_cross_entropy
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps
    from repro_torch.tree import leaves as flat
    cfg = get_config("llama3.2-1b")
    torch.cuda.empty_cache()
    state = steps.init_train_state(cfg, SEED, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    n = sum(p.numel() for p in flat(state["params"]))
    tokens = DENSE_BATCH * DENSE_SEQ
    total = torch.cuda.get_device_properties(dev).total_memory
    print(f"model {cfg.name}: {cfg.num_layers} layers, d {cfg.d_model}, "
          f"vocab {cfg.vocab_size}, f32 params from seed {SEED}, bf16 "
          f"compute; {n / 1e6:.1f} M params; params + m + v "
          f"{12 * n / 1e9:.1f} GB, grads {4 * n / 1e9:.1f} GB, new params "
          f"+ m + v {12 * n / 1e9:.1f} GB (a step is functional) of the "
          f"card's {total / 1e9:.1f} GB; SyntheticLM {DENSE_BATCH} x "
          f"{DENSE_SEQ}, AdamW lr {DENSE_LR} warmup {DENSE_WARMUP}, remat, "
          f"loss chunk {DENSE_CHUNK}, TF32 off")
    if 28 * n > total:
        raise AssertionError("the training state does not fit the card")
    opt = adamw.AdamWConfig(learning_rate=DENSE_LR,
                            warmup_steps=DENSE_WARMUP,
                            total_steps=DENSE_TOTAL)
    step = steps.make_train_step(cfg, opt, loss_chunk=DENSE_CHUNK)
    batches = dense_batches(cfg, dev, DENSE_STEPS + 1)
    times = []
    state, metrics = run_steps(step, state, batches, times)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    for i, (ms, m) in enumerate(zip(times, metrics)):
        print(f"dense step {i}{' (warm-up)' if i == 0 else ''}: host "
              f"{ms:.3f} ms synchronised; loss {m['loss']:.6f} nll "
              f"{m['nll']:.6f} grad norm {m['grad_norm']:.4f} lr "
              f"{m['lr']:.3e} skipped {m['skipped']:.0f}")
        if m["skipped"] or not math.isfinite(m["loss"]):
            raise AssertionError(f"dense step {i}: {m}")
    warm = statistics.median(times[1:])
    busy = profile_device(lambda: step(state, batches[-1]), top=12)
    # The loss alone at the step's shapes: forward, the checkpoint's
    # recompute and the backward of the f32 logits product.
    labels = batches[0]["labels"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    h = torch.randn(*labels.shape, cfg.d_model, generator=gen,
                    device=dev).to(cfg.cdtype).requires_grad_(True)
    w = state["params"]["embed"].detach().requires_grad_(True)

    def loss_fb():
        nll, _ = chunked_cross_entropy(h, w, labels, chunk=DENSE_CHUNK)
        return torch.autograd.grad(nll, (h, w))

    print("the chunked loss alone (forward, recompute, backward):")
    loss_ms = profile_device(loss_fb, top=4)
    print("forward and backward alone (steps.loss_and_grads):")
    fb_ms = profile_device(lambda: steps.loss_and_grads(
        state["params"], cfg, batches[-1], loss_chunk=DENSE_CHUNK), top=4)
    # The moments stand in for the grads: the update's time does not
    # depend on their values.
    print("the optimizer alone (adamw.apply_updates):")
    opt_ms = profile_device(lambda: adamw.apply_updates(
        state["params"], state["opt"]["m"], state["opt"], opt), top=4)
    loss_flop = 8 * tokens * cfg.d_model * cfg.vocab_size
    opt_bytes = 28 * n
    mm_flop = 6 * n * tokens
    print(f"dense Llama-3.2-1B step: warm {warm:.3f} ms host (median of "
          f"{DENSE_STEPS}; warm-up {times[0]:.3f}), "
          f"{tokens / (warm / 1e3):.1f} tokens/s; device busy {busy:.3f} "
          f"ms, idle share {1 - busy / warm:.3f}; peak memory {peak:.3f} "
          f"GiB; forward + backward {fb_ms:.3f} device ms, optimizer "
          f"{opt_ms:.3f} ({opt_ms / (opt_bytes / HBM_BYTES_PER_S * 1e3):.2f}"
          f"x its floor); the loss's f32 logits {loss_ms:.3f} device ms "
          f"({loss_ms / busy:.3f} of busy; {loss_flop / 1e12:.3f} TFLOP, "
          f"floor {loss_flop / F32_FLOP_S * 1e3:.3f} ms at 67 TFLOP/s); "
          f"floors: optimizer 28 B a param = {opt_bytes / 1e9:.2f} GB, "
          f"{opt_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms at 3.35 TB/s; "
          f"matmuls 6 N tokens = {mm_flop / 1e12:.3f} TFLOP, "
          f"{mm_flop / BF16_FLOP_S * 1e3:.3f} ms at 989 TFLOP/s; {card}")
    del state, h, w
    torch.cuda.empty_cache()
    state = steps.init_train_state(cfg, SEED, device=dev)
    fixed = adamw.AdamWConfig(learning_rate=FIXED_LR, warmup_steps=0,
                              total_steps=FIXED_STEPS)
    step = steps.make_train_step(cfg, fixed, loss_chunk=DENSE_CHUNK)
    state, metrics = run_steps(step, state, batches[:1] * FIXED_STEPS)
    losses = [m["loss"] for m in metrics]
    print(f"dense fixed batch, lr {FIXED_LR}, no warmup, {FIXED_STEPS} "
          f"steps: loss first {losses[0]:.6f}, last {losses[-1]:.6f} ("
          + ", ".join(f"{v:.4f}" for v in losses) + f"); {card}")
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"dense fixed batch: the loss did not fall: "
                             f"{losses}")
    del state, step, batches
    torch.cuda.empty_cache()


def dense_olmoe(dev, card, read_counts) -> None:
    """OLMoE-1B-7B cut to OLMOE_CUT layers: steps through the batched
    experts, no grouped-GEMM launch, every expert weight's gradient."""
    from repro_torch.configs import get_config
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps
    from repro_torch.tree import leaves as flat
    full = get_config("olmoe-1b-7b")
    cfg = cut_config(full, OLMOE_CUT)
    torch.cuda.empty_cache()
    state = steps.init_train_state(cfg, SEED, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    n = sum(p.numel() for p in flat(state["params"]))
    per_layer = (n - 2 * full.vocab_size * full.d_model
                 - full.d_model) / OLMOE_CUT
    n_full = n + per_layer * (full.num_layers - OLMOE_CUT)
    print(f"model {cfg.name} cut to {OLMOE_CUT} of {full.num_layers} "
          f"layers, published widths ({full.num_experts} experts top-"
          f"{full.top_k}, d {full.d_model}, d_ff {full.d_ff}): {n / 1e6:.1f} "
          f"M params; at full depth {n_full / 1e9:.2f} B, whose f32 params, "
          f"m, v and grads take {16 * n_full / 1e9:.1f} GB, more than the "
          f"card holds")
    step = steps.make_train_step(
        cfg, adamw.AdamWConfig(learning_rate=DENSE_LR,
                               warmup_steps=DENSE_WARMUP,
                               total_steps=DENSE_TOTAL),
        loss_chunk=DENSE_CHUNK)
    batches = dense_batches(cfg, dev, OLMOE_STEPS)
    before = read_counts()["moe_gemm"]
    times = []
    new, metrics = run_steps(step, state, batches, times)
    _, _, grads = steps.loss_and_grads(state["params"], cfg, batches[0],
                                       loss_chunk=DENSE_CHUNK)
    torch.cuda.synchronize()
    launches = read_counts()["moe_gemm"] - before
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    zero = [f"blocks/{i}/moe/{k}" for i, blk in enumerate(grads["blocks"])
            for k in ("router", "w1", "w3", "w2")
            if blk["moe"][k] is None or not blk["moe"][k].abs().max() > 0]
    print(f"dense OLMoE cut: host ms " + ", ".join(f"{t:.3f}" for t in times)
          + "; losses " + ", ".join(f"{m['loss']:.6f}" for m in metrics)
          + f"; aux {metrics[-1]['aux']:.6f}; skipped "
          f"{sum(m['skipped'] for m in metrics):.0f}; peak memory "
          f"{peak:.3f} GiB; grouped-GEMM launches {launches}; expert "
          f"weights with a zero or missing gradient: {zero or 'none'} (of "
          f"{4 * OLMOE_CUT}); {card}")
    if launches or zero or any(m["skipped"] for m in metrics):
        raise AssertionError("dense OLMoE cut: the batched experts did not "
                             "carry the step")
    del state, new, grads, step, batches
    torch.cuda.empty_cache()


def dense_smoke_parity(dev) -> float:
    """Both smoke configs, card against CPU from the same params and batch:
    the f32 gradients of ``steps.loss_and_grads`` at the gradient bar;
    ``adamw.apply_updates`` on those equal grads at lr DENSE_OPT_LR at the
    f32 bar; and one bf16 step, microbatches 1 and 2, with and without int8
    error feedback, its loss, grad norm and params at the bf16 bar.
    Returns the largest |d| of the step's params."""
    from repro_torch.configs import get_smoke_config
    from repro_torch import tree
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps
    worst = 0.0
    for arch in ("llama3.2-1b", "olmoe-1b-7b"):
        cfg = get_smoke_config(arch)
        cpu_b = dense_batches(cfg, "cpu", 1, b=4, s=32)[0]
        dev_b = {k: v.to(dev) for k, v in cpu_b.items()}
        f32 = dataclasses.replace(cfg, compute_dtype="float32")
        cpu_s = steps.init_train_state(f32, SEED, device="cpu")
        want_l, _, want_g = steps.loss_and_grads(cpu_s["params"], f32, cpu_b,
                                                 loss_chunk=16)
        got_l, _, got_g = steps.loss_and_grads(
            to_device(cpu_s["params"], dev), f32, dev_b, loss_chunk=16)
        g_gap = tree_gap(f"dense smoke {arch} f32 grads", got_g, want_g,
                         DENSE_GRAD_TOL)
        check_close(f"dense smoke {arch} f32 loss", got_l.cpu(), want_l,
                    DENSE_GRAD_TOL)
        opt = adamw.AdamWConfig(learning_rate=DENSE_OPT_LR, warmup_steps=0,
                                total_steps=10)
        want_p, want_o, _ = adamw.apply_updates(cpu_s["params"], want_g,
                                                cpu_s["opt"], opt)
        got_p, got_o, _ = adamw.apply_updates(
            to_device(cpu_s["params"], dev), to_device(want_g, dev),
            to_device(cpu_s["opt"], dev), opt)
        o_gap = max(tree_gap(f"dense smoke {arch} optimizer {k}", got, want,
                             DENSE_OPT_TOL)
                    for k, got, want in (("params", got_p, want_p),
                                         ("m", got_o["m"], want_o["m"]),
                                         ("v", got_o["v"], want_o["v"])))
        moved = max((a - b).abs().max().item() for a, b in zip(
            tree.leaves(want_p), tree.leaves(cpu_s["params"])))
        print(f"dense smoke {arch}: card vs CPU f32 grads max |d| "
              f"{g_gap:.3e} (tol {DENSE_GRAD_TOL}); optimizer on equal "
              f"grads at lr {DENSE_OPT_LR}: params, m, v max |d| "
              f"{o_gap:.3e} (tol {DENSE_OPT_TOL}), largest update "
              f"{moved:.3e}")
        for comp in ("none", "int8_ef"):
            cpu_s = steps.init_train_state(cfg, SEED, grad_compression=comp,
                                           device="cpu")
            for mb in (1, 2):
                step = steps.make_train_step(
                    cfg, adamw.AdamWConfig(), microbatches=mb,
                    loss_chunk=16, grad_compression=comp)
                b = {k: v.reshape(mb, -1, v.shape[-1]) if mb > 1 else v
                     for k, v in cpu_b.items()}
                want_s, want_m = step(cpu_s, b)
                got_s, got_m = step(to_device(cpu_s, dev),
                                    {k: v.to(dev) for k, v in b.items()})
                what = f"dense smoke {arch} mb {mb} {comp}"
                gap = tree_gap(what, got_s["params"], want_s["params"],
                               DENSE_TOL)
                for k in ("loss", "grad_norm"):
                    check_close(f"{what} {k}", got_m[k].cpu(), want_m[k],
                                DENSE_TOL)
                print(f"{what}: card vs CPU loss {got_m['loss'].item():.6f}"
                      f" / {want_m['loss'].item():.6f}, grad norm "
                      f"{got_m['grad_norm'].item():.6f} / "
                      f"{want_m['grad_norm'].item():.6f}, params max |d| "
                      f"{gap:.3e} (tol {DENSE_TOL})")
                worst = max(worst, gap)
    return worst


def dense_resume(dev) -> None:
    """Smoke Llama: 4 steps straight against 2, save, restore into a fresh
    state and 2 more."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_smoke_config
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps
    cfg = get_smoke_config("llama3.2-1b")
    step = steps.make_train_step(cfg, adamw.AdamWConfig(
        learning_rate=DENSE_LR, warmup_steps=DENSE_WARMUP, total_steps=4),
        loss_chunk=16)
    batches = dense_batches(cfg, dev, 4, b=4, s=32)
    start = steps.init_train_state(cfg, SEED, device=dev)
    straight, m_straight = run_steps(step, start, batches)
    half, m_first = run_steps(step, start, batches[:2])
    ckpt = os.path.join(SRC, "repro_torch", "build", "dense_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        mgr = CheckpointManager(ckpt, keep=2)
        mgr.save(2, half)
        fresh = steps.init_train_state(cfg, SEED + 1, device=dev)
        restored, at, _ = mgr.restore_latest(fresh)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    if at != 2 or not bit_equal(restored, half):
        raise AssertionError("dense resume: the restored state is not the "
                             "saved one bit for bit")
    resumed, m_rest = run_steps(step, restored, batches[2:])
    losses = [m["loss"] for m in m_first + m_rest]
    want = [m["loss"] for m in m_straight]
    same = bit_equal(resumed, straight) and losses == want
    gap = tree_gap("dense resume params", resumed["params"],
                   straight["params"], DENSE_TOL)
    if not all(math.isclose(a, b, rel_tol=DENSE_TOL["rtol"],
                            abs_tol=DENSE_TOL["atol"])
               for a, b in zip(losses, want)):
        raise AssertionError(f"dense resume: losses {losses} vs {want}")
    print(f"dense resume (smoke Llama, saved at step 2, restored into a "
          f"fresh state): restored state bit-equal to the saved one; "
          f"resumed losses " + ", ".join(f"{v:.6f}" for v in losses)
          + " vs straight " + ", ".join(f"{v:.6f}" for v in want)
          + f"; resumed run bit-equal to the straight one: {same} "
          f"(params max |d| {gap:.3e})")


def dense_cli() -> None:
    """The train CLI as a subprocess: full width with no checkpoint, then
    a smoke run twice on one checkpoint directory."""
    env = dict(os.environ, PYTHONPATH=SRC)
    ckpt = os.path.join(SRC, "repro_torch", "build", "dense_cli_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    runs = [["--arch", "llama3.2-1b", "--steps", "3", "--log-every", "1"],
            ["--smoke", "--ckpt-dir", ckpt, "--steps", "4"],
            ["--smoke", "--ckpt-dir", ckpt, "--steps", "6"]]
    try:
        for i, args in enumerate(runs):
            cmd = [sys.executable, "-m", "repro_torch.launch.train", *args]
            t0 = time.perf_counter()
            out = subprocess.run(cmd, capture_output=True, text=True,
                                 env=env, cwd=ROOT, timeout=600)
            dt = time.perf_counter() - t0
            print(f"$ {' '.join(cmd[1:])}  -> exit {out.returncode} in "
                  f"{dt:.1f}s")
            print("  " + "\n  ".join(out.stdout.strip().splitlines()[-5:]))
            if out.returncode:
                print(out.stderr[-3000:], file=sys.stderr)
                raise AssertionError(f"train CLI exited {out.returncode}")
            if i == 2 and "[train] resumed from step 4" not in out.stdout:
                raise AssertionError("train CLI: the second smoke run did "
                                     "not resume")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


def dense_training(dev, card, reset_counts, read_counts) -> dict:
    """The dense trainer (``runtime.steps.make_train_step``, the train
    CLI): its path launches none of the five kernels; returns their
    launches over the phase's in-process runs (the Llama steps and
    profiles, the OLMoE cut, the smoke parity and the resume), all 0,
    checked.  The CLI runs are subprocesses, whose launches these
    counts do not see."""
    from repro_torch.engine import clear_cache
    clear_cache()               # earlier phases' plans
    torch.cuda.empty_cache()
    print(f"device memory held before the phase: "
          f"{torch.cuda.memory_allocated(dev) / 2**30:.3f} GiB")
    reset_counts()
    t0 = time.perf_counter()
    dense_llama(dev, card)
    llama = read_counts()
    print(f"[dense training] Llama part {time.perf_counter() - t0:.1f}s; "
          f"launches {llama}")
    dense_olmoe(dev, card, read_counts)
    worst = dense_smoke_parity(dev)
    dense_resume(dev)
    counts = read_counts()
    if any(counts.values()):
        raise AssertionError(f"dense training launched kernels: {counts}")
    dense_cli()
    print(f"dense training launches (in-process runs; the CLI "
          f"subprocesses are not counted): {counts}; card vs CPU worst "
          f"params |d| {worst:.3e}")
    return counts


# The obs phase: the online run under trace (16 Poisson requests over the
# online phase's 9 buckets) and the four serve.* categories every trace of
# the serving path must hold.
OBS_REQUESTS = 16
OBS_CATS = ("plan", "cache", "dispatch", "serve")
OBS_METRICS = ("plan_resolve_total", "plan_cache_events_total",
               "serve_latency_us")


def account_kernels(timings, dev, card) -> dict:
    """The card's measured streaming roof (``obs.measure_roof``: the
    copy-scale pass ``x * 1.5 + 0.25`` over 1 << 26 f32, the least of 5
    CUDA-event windows) and the accountant (``obs.accountant``) fed with
    the kernel medians the timing and attention phases measured and each
    kernel's compulsory bytes by the reference's models: row-split and
    merge forward through ``account_plan`` at n = 128 (one FFN layer, w1 +
    w3 + w2), the SDDMM through ``sddmm_min_bytes``, merge's dB through
    ``plan_bwd_min_bytes`` less the SDDMM's, the grouped GEMM and flash
    with the bytes ``moe_bound`` / ``flash_bound`` count.  Device times
    only: a host time of these host-bound paths would put a kernel below
    the roof for a reason that is not the kernel's.  Returns, per kernel,
    its roof fraction and its bound at the measured roof beside the data
    sheet's."""
    from repro_torch import obs
    from repro_torch.obs import roofline as R
    roof = obs.measure_roof(force=True, device=dev)
    print(f"roof: {roof.gb_per_s:.2f} GB/s ({roof.backend}, {roof.source}: "
          f"copy-scale over {roof.elements} f32, the least of 5 runs), "
          f"{roof.bytes_per_s / HBM_BYTES_PER_S:.4f} of the data sheet's "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s; {card}")
    acc = obs.accountant
    acc.reset()
    n = SERVE_BATCH * SERVE_PROMPT
    keys = {}
    for kname in ("rowsplit_spmm", "merge_spmm"):
        for meta, ms, uses in timings[kname]:
            acc.account_plan(meta, n, wall_us=uses * ms * 1e3, impl="cuda",
                             calls=uses)
        keys[kname] = ("spmm", KERNELS[kname]["method"], "cuda", "float32")
    for name, key in (("sddmm", ("sddmm", "sddmm", "cuda", "float32")),
                      ("merge_dB", ("spmm_dB", "merge", "cuda",
                                    "float32"))):
        for meta, ms, uses in timings[name]:
            m, k = meta.shape
            sd = R.sddmm_min_bytes(meta.nnz_pad, m, k, n)
            nbytes = sd if name == "sddmm" else \
                R.plan_bwd_min_bytes(meta, n) - sd
            acc.record(key, wall_us=uses * ms * 1e3,
                       min_bytes=uses * nbytes,
                       flops=uses * R.spmm_flops(meta.nnz_pad, n),
                       calls=uses)
        keys[name] = key
    for name, key, calls in (
            ("moe_gemm", ("moe", "grouped_gemm", "cuda", "bfloat16"), 3),
            ("flash_attention", ("attention", "flash", "cuda", "bfloat16"),
             1)):
        t = timings[name]
        acc.record(key, wall_us=t["ms"] * 1e3, min_bytes=t["bytes"],
                   flops=t["flops"], calls=calls)
        keys[name] = key
    print(obs.report(roof=roof))
    rows = {(r["kind"], r["method"], r["impl"], r["dtype"]): r
            for r in acc.rows(roof)}
    out = {}
    for name, key in keys.items():
        r = rows[key]
        out[name] = dict(
            roof_fraction=r["roof_fraction"],
            roof_bound_ms=r["min_bytes"] / roof.bytes_per_s * 1e3,
            datasheet_bound_ms=r["min_bytes"] / HBM_BYTES_PER_S * 1e3,
            ms=r["wall_us"] / 1e3, min_bytes=r["min_bytes"])
        print(f"roofline {name:15s}: {out[name]['ms']:.4f} ms for "
              f"{r['min_bytes']:.0f} compulsory bytes ({r['calls']} calls); "
              f"bound at the measured roof {out[name]['roof_bound_ms']:.6f} "
              f"ms, at the data sheet's {out[name]['datasheet_bound_ms']:.6f}"
              f" ms; roof fraction {r['roof_fraction']:.4f}; {card}")
    return dict(roof_gb_s=roof.gb_per_s,
                roof_of_datasheet=roof.bytes_per_s / HBM_BYTES_PER_S,
                kernels=out)


def trace_counts(tracer) -> dict:
    """Events of a trace ring by (category, name)."""
    out = {}
    for e in tracer.events():
        key = f"{e['cat']}/{e['name']}"
        out[key] = out.get(key, 0) + 1
    return dict(sorted(out.items()))


def check_trace(tracer, path, cats) -> None:
    """Export the ring and hold it to ``obs.validate`` (required
    categories); raises on any problem."""
    from repro_torch.obs import validate
    tracer.export(str(path))
    problems = validate.validate_trace(str(path), require_cats=cats)
    if problems:
        raise AssertionError(f"trace {path}: {problems}")


def traced_serving(cfg, params, prompt, out_dir, card, reset_counts,
                   read_counts) -> dict:
    """``serve_pruned`` on the serving phase's full-width model (row-split
    by the §5.4 rule) from a cold plan cache inside ``obs.tracing()``, with
    ``REPRO_VERIFY_PLANS`` on: every plan resolved, built and verified by
    the plan linter under trace (0 findings, ms a plan).  The trace is
    exported and validated; 48 ``dispatch`` events a forward; the serve.*
    spans' durations.  Then the warm forward's host ms with tracing off
    and on (off, on, on, off, as ``host_ms`` times it), the host µs of one
    dispatch off and on (15 windows each, in turns), and a
    ``torch.profiler`` capture of one warm forward with tracing on: the
    ``serve.forward_warm`` range and 48 ``spmm_rowsplit_cuda`` ranges,
    each holding its kernel's launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import engine, obs
    from repro_torch.analysis import planlint, set_verify_plans
    from repro_torch.core import execute_plan
    from repro_torch.launch import serve
    plans = 3 * cfg.num_layers
    engine.clear_cache()
    spent = []
    check = planlint.check_plan

    def timed_check(plan, a=None):
        t0 = time.perf_counter()
        check(plan, a)
        spent.append(time.perf_counter() - t0)

    planlint.check_plan = timed_check
    prev = set_verify_plans(True)
    try:
        reset_counts()
        with obs.tracing() as tr:
            rep = serve.serve_pruned(cfg, params, prompt, KEEP)
        counts = read_counts()
    finally:
        set_verify_plans(prev)
        planlint.check_plan = check
    check_trace(tr, out_dir / "serve_trace.json", OBS_CATS)
    by = trace_counts(tr)
    dispatch = tr.events(name="dispatch")
    spans = {e["name"]: e["dur"] / 1e3 for e in tr.events(cat="serve")}
    print(f"serving under trace: {len(tr)} events, {tr.dropped} dropped, "
          f"by category/name {by}; serve.* spans (ms) "
          + ", ".join(f"{k} {v:.3f}" for k, v in spans.items())
          + f"; launches {counts}; warm forward {rep.warm_s * 1e3:.3f} ms "
          f"host; {card}")
    if len(dispatch) != 2 * plans or any(
            (e["args"]["method"], e["args"]["impl"]) != ("rowsplit", "cuda")
            for e in dispatch):
        raise AssertionError(f"serving under trace: {len(dispatch)} "
                             f"dispatch events, expected {plans} a forward "
                             "of row-split on cuda")
    for name in ("plan/plan.resolve", "cache/cache.miss", "plan/plan.build"):
        if by.get(name) != plans:
            raise AssertionError(f"serving under trace: {by.get(name)} "
                                 f"{name}, expected {plans}")
    if set(spans) != {"serve.plan", "serve.forward_cold",
                      "serve.forward_warm"} or rep.replans:
        raise AssertionError(f"serving under trace: spans {sorted(spans)}, "
                             f"{rep.replans} plans built while serving")
    if counts["rowsplit_spmm"] != 2 * plans or \
            sum(counts.values()) != counts["rowsplit_spmm"]:
        raise AssertionError(f"serving under trace launched {counts}")
    if len(spent) != plans:
        raise AssertionError(f"the verify hook ran {len(spent)} times for "
                             f"{plans} plans built")
    verify_ms = [x * 1e3 for x in spent]
    print(f"plan verification (REPRO_VERIFY_PLANS on, at build): {plans} "
          f"plans, 0 findings, {statistics.median(verify_ms):.2f} ms a plan "
          f"(median; least {min(verify_ms):.2f}, most {max(verify_ms):.2f}, "
          f"all {sum(verify_ms):.1f} ms); {card}")

    blocks = serve.prune_ffn_blocks(params, cfg, KEEP)
    fwd = serve.make_pruned_forward(cfg)

    def forward():
        with torch.no_grad():
            fwd(params, blocks, prompt)

    host = {"off": [], "on": []}
    for mode in ("off", "on", "on", "off"):
        if mode == "on":
            with obs.tracing():
                host[mode].append(host_ms(forward, reps=9))
        else:
            host[mode].append(host_ms(forward, reps=9))
    print(f"warm forward host ms, tracing off {host['off']} and on "
          f"{host['on']} (off, on, on, off; each the median of 9 "
          f"synchronised calls); {card}")
    # The host cost of a dispatch, apart from the forward's spread: 48
    # back-to-back execute_plan calls of layer 0's w1 plan in one window,
    # not synchronised inside it (48 launches of ~0.16 ms stay far below
    # the launch queue's depth, so the window is the host's dispatch
    # time), tracing off and on in turns, 15 windows each.
    sl = blocks[0]["mlp"]["w1"]
    b = torch.randn(sl.weight.k, SERVE_BATCH * SERVE_PROMPT,
                    device=prompt.device)

    def dispatch_us():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(plans):
            execute_plan(sl.plan, sl.weight.vals, b)
        us = (time.perf_counter() - t0) / plans * 1e6
        torch.cuda.synchronize()
        return us

    calls = {"off": [], "on": []}
    with torch.no_grad():
        dispatch_us()
        for _ in range(15):
            calls["off"].append(dispatch_us())
            with obs.tracing():
                calls["on"].append(dispatch_us())
    off_us, on_us = (statistics.median(calls[k]) for k in ("off", "on"))
    print(f"host us a dispatch (execute_plan, 15 windows of {plans} calls "
          f"each way, in turns): tracing off {off_us:.2f} (quartiles "
          f"{statistics.quantiles(calls['off'], n=4)[0]:.2f}-"
          f"{statistics.quantiles(calls['off'], n=4)[2]:.2f}), on "
          f"{on_us:.2f} ({statistics.quantiles(calls['on'], n=4)[0]:.2f}-"
          f"{statistics.quantiles(calls['on'], n=4)[2]:.2f}): tracing adds "
          f"{on_us - off_us:.2f} us a dispatch, "
          f"{(on_us - off_us) * plans / 1e3:.3f} ms a forward of {plans}; "
          f"{card}")

    with obs.tracing():
        forward()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with obs.span("serve.forward_warm", cat="serve"):
                forward()
                torch.cuda.synchronize()
    evs = prof.events()
    cpu = [e for e in evs if e.device_type == DeviceType.CPU]
    ranges = [e for e in cpu if e.name == "spmm_rowsplit_cuda"]
    warm = [e for e in cpu if e.name == "serve.forward_warm"]
    launches = [e for e in cpu if "LaunchKernel" in e.name]
    kernels = [e for e in evs if e.device_type == DeviceType.CUDA
               and "rowsplit_kernel" in e.name]

    def holds_launch(r):
        return any(r.time_range.start <= x.time_range.start
                   and x.time_range.end <= r.time_range.end
                   for x in launches)

    under = sum(holds_launch(r) for r in ranges)
    print(f"profiler capture of one warm forward under trace: "
          f"serve.forward_warm ranges {len(warm)}, spmm_rowsplit_cuda ranges "
          f"{len(ranges)}, {under} of them holding a kernel launch; "
          f"row-split kernels on the device {len(kernels)}; launch events "
          f"{len(launches)}")
    if len(warm) != 1 or len(ranges) != plans or under != plans or \
            len(kernels) < plans:
        names = sorted({e.name for e in cpu})[:40]
        raise AssertionError(f"profiler capture: expected 1 "
                             f"serve.forward_warm and {plans} "
                             f"spmm_rowsplit_cuda ranges each over a kernel "
                             f"launch (CPU event names: {names})")
    return dict(launches=counts, host_off_ms=host["off"],
                host_on_ms=host["on"], dispatch_off_us=off_us,
                dispatch_on_us=on_us, spans_ms=spans, events=by,
                verify_ms_median=statistics.median(verify_ms))


def traced_online(cfg, params, out_dir, dev, card, reset_counts,
                  read_counts) -> dict:
    """``serve_online`` on the same model, 16 Poisson requests over the
    online phase's 9 buckets, with tracing on throughout and
    ``REPRO_VERIFY_PLANS`` on through the server's warmup: every plan it
    takes from the cache is verified there, before any capture (no
    ``PlanCache.get`` runs inside one); every bucket captures a CUDA
    graph whose replay is bit-equal to the eager forward, and every
    request to the eager forward of its packed bucket matrix.  The trace
    holds one ``serve.enqueue`` a request, one ``serve.execute`` and one
    ``serve.batch`` a batch run, no ``serve.shed`` unless the run shed,
    and ``dispatch`` events only from the warm calls and captures (a
    replay passes no Python), each of row-split on ``cuda``; the metrics
    dump passes the validator.  Launches, counted as the online phase
    counts them: the wrappers see each bucket's warm call and capture (48
    each, no other kernel), and the path's launches are the warm calls'
    plus 48 for each replay."""
    from repro_torch import obs
    from repro_torch.analysis import planlint, set_verify_plans
    from repro_torch.engine import GraphProgram
    from repro_torch.launch import serve
    from repro_torch.obs import validate
    from repro_torch.serving import Server
    verified = []
    check, warmup = planlint.check_plan, Server.warmup

    def counted_check(plan, a=None):
        verified.append(plan.meta.method)
        check(plan, a)

    def verified_warmup(self):
        # REPRO_VERIFY_PLANS on through the server's warmup: its
        # ensure_spmm_plans serves every plan from the cache (verified on
        # the hit), then the buckets capture.  (The prune before it would
        # verify the same 48 plans again at 0.2-0.3 s each.)
        prev = set_verify_plans(True)
        try:
            return warmup(self)
        finally:
            set_verify_plans(prev)

    planlint.check_plan, Server.warmup = counted_check, verified_warmup
    try:
        reset_counts()
        with obs.tracing() as tr:
            rep = serve.serve_online(cfg, params, KEEP, batch=SERVE_BATCH,
                                     prompt_len=SERVE_PROMPT,
                                     requests=OBS_REQUESTS, seed=SEED + 1,
                                     keep_served=True)
        counts = read_counts()
    finally:
        planlint.check_plan, Server.warmup = check, warmup
    check_trace(tr, out_dir / "online_trace.json", OBS_CATS)
    metrics = obs.dump_metrics(str(out_dir / "online_metrics.json"))
    problems = validate.validate_metrics(metrics, require_names=OBS_METRICS)
    if problems:
        raise AssertionError(f"metrics {metrics}: {problems}")
    srv, load = rep.server, rep.load
    shapes = srv.ladder.shapes()
    progs = {sh: srv.program(*sh) for sh in shapes}
    by = trace_counts(tr)
    batches = {}
    for tokens, fut in load.served:
        batches.setdefault(id(fut.packed), []).append((tokens, fut))
    plans = 3 * cfg.num_layers
    replays = sum(prog.replays for prog in progs.values())
    launches = plans * (len(shapes) + replays)
    print(f"online under trace: {load.ok}/{load.n} ok, {load.shed} shed, "
          f"{load.error} error in {len(batches)} batches; events by "
          f"category/name {by}; plans verified at warmup {len(verified)}; "
          f"recompiles {rep.recompiles}, plans built {rep.replans}; wrapper "
          f"launches {counts} (warm calls and captures), replays {replays}, "
          f"launches on the path {launches}; {card}")
    if len(progs) != 9 or not all(isinstance(p, GraphProgram)
                                  for p in progs.values()):
        raise AssertionError("online under trace: expected 9 CUDA graphs")
    if (load.ok, load.error) != (load.n - load.shed, 0) or \
            rep.recompiles or rep.replans:
        raise AssertionError("online under trace: a request failed, or the "
                             "run built a program or a plan after warmup")
    want = {"serve/serve.enqueue": load.n - load.shed,
            "serve/serve.execute": len(batches),
            "serve/serve.batch": len(batches),
            "serve/serve.warmup": 1,
            "dispatch/dispatch": 2 * plans * len(shapes)}
    got = {k: by.get(k, 0) for k in want}
    if got != want or by.get("serve/serve.shed", 0) != load.shed:
        raise AssertionError(f"online under trace: events {got}, expected "
                             f"{want} and {load.shed} serve.shed")
    routes = collections.Counter(
        (e["args"]["method"], e["args"]["impl"])
        for e in tr.events(name="dispatch"))
    if set(routes) != {("rowsplit", "cuda")}:
        raise AssertionError(f"online under trace: dispatches by (method, "
                             f"impl) {dict(routes)}, expected row-split on "
                             "cuda only")
    if counts["rowsplit_spmm"] != 2 * plans * len(shapes) or \
            sum(counts.values()) != counts["rowsplit_spmm"] or not replays:
        raise AssertionError(f"online under trace: the wrappers counted "
                             f"{counts} with {replays} replays, expected "
                             f"row-split only, a warm call and a capture a "
                             f"bucket (2 x {plans} x {len(shapes)})")
    if len(verified) != plans:
        raise AssertionError(f"online under trace: {len(verified)} plans "
                             f"verified at warmup, expected {plans}")
    p, blocks = srv.state
    base = serve.make_pruned_forward(cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    with torch.inference_mode():
        for (bb, lb), prog in progs.items():
            tok = torch.randint(0, cfg.vocab_size, (bb, lb), generator=gen,
                                device=dev)
            eager = base(p, blocks, tok)
            if not torch.equal(prog(tok).clone(), eager):
                raise AssertionError(f"online under trace {bb}x{lb}: the "
                                     "replay differs from the eager forward")
        for group in batches.values():
            packed = group[0][1].packed
            eager = base(p, blocks, torch.from_numpy(packed).to(dev))
            for tokens, fut in group:
                if not torch.equal(fut.result(),
                                   eager[fut.row, :len(tokens)]):
                    raise AssertionError("online under trace: a request "
                                         "differs from the eager forward "
                                         "of its bucket matrix")
    torch.cuda.synchronize()
    print(f"online under trace: {len(progs)} graphs captured with tracing "
          f"on, each replay bit-equal to the eager forward; all "
          f"{len(load.served)} requests bit-equal to the eager forwards of "
          f"their bucket matrices; trace and metrics validated")
    srv.programs.clear()
    return dict(requests=load.n, ok=load.ok, shed=load.shed,
                batches=len(batches), verified=len(verified), events=by,
                launches=launches, wrapper_launches=counts["rowsplit_spmm"],
                replays=replays)


def observability(timings, dev, card, reset_counts, read_counts) -> dict:
    """The obs phase (``repro_torch.obs`` and ``repro_torch.analysis``):
    the roof and the accountant (``account_kernels``), serving and online
    serving under trace with plan verification on (``traced_serving``,
    ``traced_online``), ``python -m repro_torch.analysis planlint --suite
    mini`` on the card, and the train CLI with ``--trace-out`` /
    ``--metrics-out`` at the smoke config (2 steps), both validated.
    Any validator problem, planlint finding, missing range or broken
    replay raises."""
    from repro_torch import obs
    from repro_torch.analysis import cli as lint_cli
    from repro_torch.configs import get_config
    from repro_torch.kernels import _cuda
    from repro_torch.launch import train
    from repro_torch.models import model as M
    from repro_torch.obs import validate
    out_dir = _cuda.BUILD_DIR / "obs"
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    roofline = account_kernels(timings, dev, card)
    print(f"[obs] roof and accountant {time.perf_counter() - t0:.2f} s")
    cfg = get_config("llama3.2-1b")
    params = M.init_params(cfg, SEED, dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    prompt = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                           generator=g, device=dev)
    t0 = time.perf_counter()
    serving = traced_serving(cfg, params, prompt, out_dir, card,
                             reset_counts, read_counts)
    print(f"[obs] serving under trace {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    online = traced_online(cfg, params, out_dir, dev, card, reset_counts,
                           read_counts)
    print(f"[obs] online under trace {time.perf_counter() - t0:.2f} s")
    del params, prompt
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rc = lint_cli.main(["planlint", "--suite", "mini", "--json",
                        str(out_dir / "planlint.json")])
    if rc:
        raise AssertionError(f"planlint --suite mini on the card: exit {rc}")
    trace = out_dir / "train_trace.json"
    metrics = out_dir / "train_metrics.json"
    with obs.tracing() as tr:
        rc = train.main(["--smoke", "--steps", "2", "--global-batch", "2",
                         "--seq-len", "16", "--trace-out", str(trace),
                         "--metrics-out", str(metrics)])
    problems = validate.validate_trace(str(trace)) + \
        validate.validate_metrics(str(metrics),
                                  require_names=("train_step_latency_us",))
    steps = tr.events(name="train.step")
    if rc or problems or len(steps) != 2:
        raise AssertionError(f"train CLI under trace: exit {rc}, "
                             f"{len(steps)} train.step spans, {problems}")
    print(f"train CLI --trace-out/--metrics-out, 2 smoke steps on the card: "
          f"train.step spans "
          + ", ".join(f"{e['dur'] / 1e3:.2f}" for e in steps)
          + f" ms; trace and metrics validated; planlint and the CLI "
          f"{time.perf_counter() - t0:.2f} s")
    return dict(roofline=roofline, serving=serving, online=online)


# ----------------------------------------------------------- analysis --


def kernel_resources(lib_path) -> dict:
    """Registers and static shared memory of every kernel entry of the
    library, by normalized demangled name: ``cuobjdump -res-usage`` of it
    (equal to ptxas's report, less the 1 KB a block its SHARED count
    adds), names demangled with ``c++filt`` (the toolkit's ``cu++filt``
    without it)."""
    import re
    from repro_torch.kernels import _cuda
    from repro_torch.kernels import introspect as I
    found = {}
    tool = os.path.join(os.path.dirname(_cuda.nvcc_path()), "cuobjdump")
    out = subprocess.run([tool, "-res-usage", str(lib_path)],
                         capture_output=True, text=True, check=True,
                         timeout=120).stdout.splitlines()
    for i, line in enumerate(out):
        mt = re.search(r"Function (\S+):", line)
        if mt and i + 1 < len(out):
            regs = re.search(r"REG:(\d+)", out[i + 1])
            smem = re.search(r"SHARED:(\d+)", out[i + 1])
            # SHARED adds the 1 KB a block the runtime reserves on sm_90
            # to a kernel with shared memory (ptxas's "bytes smem" does
            # not).
            found[mt.group(1)] = (int(regs.group(1)), max(
                int(smem.group(1)) - I.H100_SXM.smem_reserved_block, 0))
    if not found:
        raise AssertionError(f"cuobjdump -res-usage {lib_path}: no kernel")
    names = sorted(found)
    filt = shutil.which("c++filt") or os.path.join(
        os.path.dirname(_cuda.nvcc_path()), "cu++filt")
    dem = subprocess.run([filt, *names], capture_output=True, text=True,
                         check=True, timeout=60).stdout.splitlines()
    if len(dem) != len(names):
        raise AssertionError(f"{filt} demangled {len(dem)} of {len(names)} "
                             "kernel names")
    return {I.normalize_symbol(d): found[n] for n, d in zip(names, dem)}


def hold_launch(model, event, res, card, what) -> dict:
    """One modeled launch against the profiler's record of it (grid,
    block, shared memory, registers) and the library's resource usage
    (registers, static shared memory); raises on any mismatch."""
    from repro_torch.kernels import introspect as I
    args = event["args"]
    grid = tuple(args["grid"])
    block = tuple(args["block"])
    smem = int(args["shared memory"])
    regs = int(args["registers per thread"])
    sym = I.normalize_symbol(model.symbol)
    p_regs, p_smem = res.get(sym, (None, None))
    resident = max(model.min_blocks, 1)
    problems = []
    if grid != tuple(model.grid):
        problems.append(f"grid {grid} != model {model.grid}")
    if block != (model.block, 1, 1):
        problems.append(f"block {block} != model ({model.block}, 1, 1)")
    if smem != model.smem:
        problems.append(f"shared memory {smem} != model {model.smem} "
                        f"(dynamic {model.dynamic_smem} + static "
                        f"{model.static_smem})")
    if p_regs is None:
        problems.append(f"cuobjdump -res-usage reports no {sym}")
    else:
        if regs != p_regs:
            problems.append(f"registers {regs} != cuobjdump {p_regs}")
        if p_smem != model.static_smem:
            problems.append(f"static shared memory {p_smem} (cuobjdump) "
                            f"!= model {model.static_smem}")
    if regs * model.block * resident > card.regs_sm:
        problems.append(f"{regs} registers x {model.block} threads x "
                        f"{resident} blocks > {card.regs_sm} an SM")
    if problems:
        raise AssertionError(f"analysis {what} {model.label} ({sym}): "
                             + "; ".join(problems))
    return dict(grid=list(grid), block=model.block, smem_bytes=smem,
                registers=regs)


def call_windows(events: list, n_calls: int) -> tuple:
    """The port's (``repro::``) kernel events of a chrome trace, in time
    order, and those of each ``analysis call <i>`` range: a kernel belongs
    to the range that holds the runtime call launching it (matched by its
    correlation id).  Raises on a missing range or on a kernel outside
    every range."""
    from repro_torch.kernels import introspect as I
    spans = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation"
             and e["name"].startswith("analysis call ")}
    if len(spans) != n_calls:
        raise AssertionError(f"analysis: {len(spans)} call ranges in the "
                             f"trace for {n_calls} calls")
    ranges = [spans[f"analysis call {i}"] for i in range(n_calls)]
    launch_at = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    ours = sorted((e for e in events if e.get("cat") == "kernel"
                   and I.normalize_symbol(e["name"]).startswith("repro::")),
                  key=lambda e: e["ts"])
    windows = [[] for _ in range(n_calls)]
    for e in ours:
        t = launch_at.get(e["args"].get("correlation"))
        at = [i for i, (t0, t1) in enumerate(ranges)
              if t is not None and t0 <= t <= t1]
        if len(at) != 1:
            raise AssertionError(
                f"analysis: kernel {e['name'][:80]} launched outside every "
                f"call's range (launch at {t})")
        windows[at[0]].append(e)
    return ours, windows


def analysis(dev, card, lib_path, roof_gb_s) -> dict:
    """The ``analysis`` phase: each modeled launch of the main paths run
    once under ``torch.profiler`` and held against its launch model
    (``repro_torch.kernels.introspect``) and the library's resource
    usage: in each call's own ``record_function`` range, the port's
    kernels the trace shows equal, in order, the call's models that name a
    symbol, with none left over.  Then each one's requested
    bytes, their ratio to the compulsory bytes and the request rate over
    its CUDA-event time; then ``python -m repro_torch.analysis all`` on
    the card.  Any mismatch or finding raises."""
    from repro_torch.analysis import cli as lint_cli
    from repro_torch.analysis.kernel_audit import Variant
    from repro_torch.core import PlanPolicy, build_plan, prune_to_csr
    from repro_torch.kernels import _cuda, flash_attention, moe_gemm, sddmm
    from repro_torch.kernels import introspect as I
    from repro_torch.kernels import registry
    from repro_torch.obs import roofline as R
    from torch.profiler import ProfilerActivity, profile, record_function
    out_dir = _cuda.BUILD_DIR / "analysis"
    out_dir.mkdir(parents=True, exist_ok=True)
    res = kernel_resources(lib_path)
    print(f"analysis: {len(res)} kernel entries from cuobjdump -res-usage, "
          "e.g. " + ", ".join(sorted(res)[:3]))
    lim = I.card_of(dev)
    print(f"card limits (get_device_properties): {lim}")
    n = SERVE_BATCH * SERVE_PROMPT
    calls = []           # (kernel row, label, fn, models, compulsory bytes)
    narrow = {}          # w1 / w2 plans by method, for the model-only rows


    for i, (mname, (m, k)) in enumerate(
            (("w1", LLAMA_FFN["w1"]), ("w3", LLAMA_FFN["w1"]),
             ("w2", LLAMA_FFN["w2"]))):
        g = torch.Generator(device=dev).manual_seed(40 + i)
        w = torch.randn(m, k, generator=g, device=dev) * k ** -0.5
        a = prune_to_csr(w, KEEP)
        del w
        b = torch.randn(k, n, generator=g, device=dev)
        dts = ("float32", "bfloat16") if mname == "w1" else ("float32",)
        plans = {method: build_plan(a, PlanPolicy(method=method,
                                                  with_transpose=False))
                 for method in ("rowsplit", "rowgroup", "merge")}
        if mname != "w3":
            narrow[mname] = plans
        if mname == "w1":
            narrow_vals = a.vals
        for dt in dts:
            v = Variant(dt, dt, dt, "float32", None, None)
            tdt = getattr(torch, dt)
            vals, bb = a.vals.to(tdt), b.to(tdt)[None]
            floor = R.plan_min_bytes(plans["rowsplit"].meta, n, val_dtype=dt)
            for method in (plans if dt == "float32" else ("rowsplit",)):
                plan, spec = plans[method], registry.get_method(method)
                models = spec.traffic(plan, n, 1, v, lim)
                row = "merge_spmm" if method == "merge" else "rowsplit_spmm"
                fn = (lambda p=plan, s=spec, vv=vals, b3=bb:
                      s.execute(p.meta, p.fwd, vv, b3, impl="cuda"))
                calls.append((row, f"{method} {mname} {dt}", fn, models,
                              floor))
        fwd = plans["rowsplit"].fwd
        dc = torch.randn(1, m, n, generator=g, device=dev)
        models = sddmm.launch_models(
            fwd["nz_rows"], fwd["nz_cols"], fwd["nz_valid"], m=m, k=k, n=n,
            batch=1, dc_dtype="float32", b_dtype="float32")
        fn = (lambda f=fwd, d=dc, b3=b[None]: sddmm.sddmm_cuda(
            f["nz_rows"], f["nz_cols"], f["nz_valid"], d, b3))
        calls.append(("sddmm", f"sddmm {mname} float32", fn, models,
                      R.sddmm_min_bytes(a.nnz_pad, m, k, n)))
    n_exp, tt = 64, moe_gemm.TT
    be = torch.arange(n_exp, dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(50)
    for d_in, d_out in MOE_FULL:
        x = torch.randn(n_exp * tt, d_in, generator=g, device=dev).to(
            torch.bfloat16)
        wt = (torch.randn(n_exp, d_in, d_out, generator=g, device=dev)
              * d_in ** -0.5).to(torch.bfloat16)
        models = moe_gemm.launch_models(be, tokens=n_exp * tt, d_in=d_in,
                                        d_out=d_out, n_experts=n_exp,
                                        dtype="bfloat16", card=lim)
        floor = 2 * (x.numel() + wt.numel() + n_exp * tt * d_out) + 4 * n_exp
        fn = (lambda xx=x, ww=wt: moe_gemm.moe_group_gemm_cuda(xx, ww, be))
        calls.append(("moe_gemm", f"moe {d_in}x{d_out} bf16", fn, models,
                      floor))
    q, kk, vv = flash_inputs(torch.Generator(device=dev).manual_seed(51),
                             1, 2048, 32, 8, 64, torch.bfloat16, dev)
    models = flash_attention.launch_models(b=1, s=2048, h=32, kvh=8, dh=64,
                                           dtype="bfloat16")
    calls.append(("flash_attention", "flash 1x2048 bf16",
                  lambda: flash_attention.flash_attention_cuda(q, kk, vv),
                  models, 2 * (2 * q.numel() + kk.numel() + vv.numel())))
    # Row-split's staged body: w1 at the Granite backlog's batch 8 x 256,
    # wide enough for its rule.
    p, spec = narrow["w1"]["rowsplit"], registry.get_method("rowsplit")
    wide_b = torch.randn(8, LLAMA_FFN["w1"][1], 256, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(52))
    models = spec.traffic(p, 256, 8, Variant(
        "float32", "float32", "float32", "float32", None, None), lim)
    if [mm.body for mm in models] != ["staged"]:
        raise AssertionError(f"analysis: w1 at 8 x 256 models "
                             f"{[mm.body for mm in models]}, not staged")
    calls.append(("rowsplit_spmm", "rowsplit w1 float32 8x256", (
        lambda pp=p, ss=spec, vv=narrow_vals, b3=wide_b:
        ss.execute(pp.meta, pp.fwd, vv, b3, impl="cuda")), models,
        R.plan_min_bytes(p.meta, 8 * 256, val_dtype="float32")))
    # The models alone at the online buckets' narrower widths (no launch):
    # what a warp requests when 2 or 8 of its lanes hold columns.
    for mname in ("w1", "w2"):
        plan = narrow[mname]
        for method in ("rowsplit", "merge"):
            p = plan[method]
            per = {nn: sum(mm.requested_bytes() for mm in
                           registry.get_method(method).traffic(
                               p, nn, 1, Variant("f32", "float32",
                                                 "float32", "float32", None,
                                                 None), lim))
                   for nn in (8, 32, n)}
            print(f"analysis model {method} {mname} n 8 / 32 / {n}: "
                  + " / ".join(f"{b} B ({b / p.meta.nnz_pad:.2f} B a "
                               "nonzero)" for b in per.values()))
    del narrow
    for _, _, fn, _, _ in calls:                 # warm: nothing to build
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i, (_, _, fn, _, _) in enumerate(calls):
            with record_function(f"analysis call {i}"):
                fn()
                torch.cuda.synchronize()
    trace = out_dir / "launches_trace.json"
    prof.export_chrome_trace(str(trace))
    with open(trace, encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    ours, windows = call_windows(events, len(calls))
    print(f"analysis: {len(ours)} of the port's kernel events in "
          f"{trace.name}, each inside one call's range; registers and "
          "static shared memory from cuobjdump -res-usage")
    by_row = {name: [] for name in KERNELS}
    for (row, label, fn, models, floor), got in zip(calls, windows):
        modeled = [mm for mm in models if mm.symbol is not None]
        want = [I.normalize_symbol(mm.symbol) for mm in modeled]
        seen = [I.normalize_symbol(e["name"]) for e in got]
        if seen != want:
            raise AssertionError(
                f"analysis {label}: the trace's launches {seen} != the "
                f"models' {want}")
        held = [hold_launch(mm, e, res, lim, label)
                for mm, e in zip(modeled, got)]
        ms = time_ms(fn)
        req = sum(mm.requested_bytes() for mm in models)
        rec = dict(label=label, launches=held, requested_bytes=req,
                   compulsory_bytes=int(floor), ratio=req / floor, ms=ms,
                   request_tb_s=req / ms / 1e9)
        by_row[row].append(rec)
        print(f"analysis {label:24s}: "
              + "; ".join(f"{mm.label} grid {h['grid']} block {h['block']} "
                          f"smem {h['smem_bytes']} regs {h['registers']}"
                          for mm, h in zip([x for x in models if x.symbol],
                                           held))
              + f" -- held; requested {req} B, {req / floor:.2f}x the "
              f"{int(floor)} compulsory B; {ms:.4f} ms, requests at "
              f"{req / ms / 1e9:.3f} TB/s (measured roof {roof_gb_s:.2f} "
              f"GB/s); {card}")
    del calls, q, kk, vv, x, wt
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rc = lint_cli.main(["all", "--json", str(out_dir / "analysis_all.json")])
    if rc:
        raise AssertionError(f"python -m repro_torch.analysis all on the "
                             f"card: exit {rc}")
    print(f"python -m repro_torch.analysis all on the card: exit 0 "
          f"({time.perf_counter() - t0:.2f} s)")
    return by_row


def analysis_child() -> int:
    """The analysis phase in a process of its own (``python3 -c``, argv:
    the library, the measured roof in GB/s and the JSON path its result
    goes to): a profiler capture that is the process's first records every
    kernel launch, where one taken after the earlier phases' captures kept
    only the last few."""
    lib_path, roof, out = sys.argv[1:4]
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = analysis(torch.device("cuda", 0), gpu_line(), lib_path,
                    float(roof))
    with open(out, "w", encoding="utf-8") as f:
        json.dump(rows, f)
    return 0


def run_analysis(lib_path, roof_gb_s: float) -> dict:
    """:func:`analysis_child` as a subprocess; its launch-model rows."""
    from repro_torch.kernels import _cuda
    out_dir = _cuda.BUILD_DIR / "analysis"
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / "launch_models.json"
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); import chip_smoke; "
            "sys.exit(chip_smoke.analysis_child())")
    sys.stdout.flush()
    proc = subprocess.run([sys.executable, "-c", code, str(lib_path),
                           str(roof_gb_s), str(out)],
                          timeout=600, check=False)
    if proc.returncode:
        raise AssertionError(f"analysis phase: exit {proc.returncode}")
    with open(out, encoding="utf-8") as f:
        return json.load(f)


# ------------------------------------------------------------- sharded --

# The sharded phase (repro_torch.distributed.spmm): the serving cell's
# pruned FFNs in SHARD_N nnz-balanced shards by rows and by cols on the
# loop path; the power law in SHARD_N row shards; layer 0's pruned FFN
# trained through GRAD_SHARDS shards; the SPMD path in SPMD_RANKS ranks
# sharing the card over gloo; an OLMoE-1B-7B MoE layer at MOE_GROUPS.
SHARD_N, GRAD_SHARDS, SPMD_RANKS, MOE_GROUPS = 4, 2, 2, 4
# The f32-compute forwards, sharded against unsharded: the kernels' f32
# bar (the shards sum a row's or a column block's products in other
# orders).
SHARD_F32_TOL = dict(rtol=2e-5, atol=2e-5)
# Sharded against unsharded gradients, and the SPMD ranks against the
# loop path: the reference's gradient bar (tests/test_spmm_grad.py:23),
# rtol 1e-4 and atol 1e-5 at unit scale, so here atol 1e-5 of the
# gradient's largest |value| (at least 1): an entry is an f32 sum of up
# to 8192 products in another order (dB through the shards' transpose
# plans summed, the cotangents behind it), and where those products
# cancel, its error stays at their scale, not the entry's (the first card
# run's cols dvals of w1: 34 of 4.19 M entries 3.1e-5 off at |dvals| <=
# 39).
SHARD_GRAD_TOL = dict(rtol=1e-4, atol_of_max=1e-5)
# A rendezvous, a collective or a rank that has not ended by then fails
# the phase instead of eating the script's clock.
SPMD_INIT_S, SPMD_JOIN_S, TORCHRUN_S = 120, 300, 420
# Online serving over the SPMD ranks (and the serve CLI's default): 24
# Poisson requests at the auto rate.
MESH_ONLINE_REQUESTS = 24


def grad_tol(want) -> dict:
    """SHARD_GRAD_TOL with its atol at ``want``'s scale."""
    return dict(rtol=SHARD_GRAD_TOL["rtol"], atol=SHARD_GRAD_TOL[
        "atol_of_max"] * max(want.abs().max().item(), 1.0))


def shard_summary(plan) -> tuple:
    """(per-shard methods, nnz imbalance max/mean) of a sharded plan."""
    meta = plan.meta
    nnz = [int((s < meta.nnz_pad).sum()) for s in plan.vals_slots]
    mean = sum(nnz) / len(nnz)
    return ([lm.method for lm in meta.local_metas],
            max(nnz) / mean if mean else 1.0)


def sharded_llama(cfg, params, prompt, dev, card, reset_counts,
                  read_counts) -> dict:
    """Llama-3.2-1B at full width (16 layers), keep 0.25, batch 4 x prompt
    32: ``serve_pruned`` with every pruned-FFN weight in SHARD_N shards by
    rows, then by cols, on the per-shard loop (every shard's kernel on the
    one card), against the unsharded forward in the same call; the same
    three at f32 compute."""
    from repro_torch.core import PlanPolicy, ShardSpec
    from repro_torch.launch import serve
    fwd = serve.make_pruned_forward(cfg)
    base = serve.prune_ffn_blocks(params, cfg, KEEP)

    def forward(blocks):
        def run():
            with torch.no_grad():
                return fwd(params, blocks, prompt)
        return run

    flat = forward(base)()
    flat_host = host_ms(forward(base))
    flat_busy = profile_device(forward(base), top=0)
    print(f"sharded: unsharded forward {flat_host:.2f} ms host, device busy "
          f"{flat_busy:.3f} ms (idle share {1 - flat_busy / flat_host:.3f}); "
          f"{card}")
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    with torch.no_grad():
        flat32 = serve.make_pruned_forward(cfg32)(params, base, prompt)
    out = {"launches": collections.Counter(), "logits": flat}
    for dim in ("rows", "cols"):
        policy = PlanPolicy(shards=ShardSpec(n=SHARD_N, dim=dim))
        reset_counts()
        rep = serve.serve_pruned(cfg, params, prompt, KEEP, policy=policy)
        counts = read_counts()
        out["launches"].update(counts)
        blocks = serve.prune_ffn_blocks(params, cfg, KEEP, policy)
        mixes, worst_imb = collections.Counter(), 0.0
        for li, blk in enumerate(blocks):
            parts = []
            for name, sl in blk["mlp"].items():
                methods, imb = shard_summary(sl.plan)
                mixes[tuple(methods)] += 1
                worst_imb = max(worst_imb, imb)
                parts.append(f"{name} {'/'.join(methods)} imbalance "
                             f"{imb:.4f}")
            print(f"sharded {dim} layer {li:2d}: " + "; ".join(parts))
        per_forward = {k: v // 2 for k, v in counts.items() if v}
        metas = [sl.plan.meta for blk in blocks for sl in blk["mlp"].values()]
        want = forward_launches(lm for meta in metas
                                for lm in meta.local_metas)
        host = host_ms(forward(blocks))
        busy = profile_device(forward(blocks), top=4)
        with torch.no_grad():
            got32 = serve.make_pruned_forward(cfg32)(params, blocks, prompt)
        d32, r32 = check_close(f"sharded {dim} f32 logits vs unsharded",
                               got32, flat32, SHARD_F32_TOL)
        same = torch.equal(rep.logits, flat)
        print(f"sharded {dim} x {SHARD_N} loop: shard methods "
              f"{dict(mixes)} over {3 * len(blocks)} matrices, worst nnz "
              f"imbalance {worst_imb:.4f}; launches a forward {per_forward} "
              f"(over {sum(per_forward.values())}; unsharded 48); plans built "
              f"while serving {rep.replans}; warm forward {host:.2f} ms host "
              f"(unsharded {flat_host:.2f}), device busy {busy:.3f} ms "
              f"(unsharded {flat_busy:.3f}), idle share "
              f"{1 - busy / host:.3f}; f32 logits vs unsharded max |d| "
              f"{d32:.3e} (tol rtol {SHARD_F32_TOL['rtol']} atol "
              f"{SHARD_F32_TOL['atol']}; worst ratio {r32:.3f}); bf16 logits "
              f"the unsharded bits: {same}; {card}")
        serve_gap(f"sharded {dim} logits vs unsharded", rep.logits, flat)
        # Two forwards (cold, warm), each every shard's kernel of every
        # matrix, SHARD_N shards a matrix.
        if rep.replans or any(len(m.local_metas) != SHARD_N for m in metas) \
                or {k: v for k, v in counts.items() if v} != {
                    k: 2 * v for k, v in want.items() if v}:
            raise AssertionError(
                f"sharded {dim}: {rep.replans} plans built while serving, "
                f"shards a matrix {sorted({len(m.local_metas) for m in metas})}"
                f", launches {dict(counts)} for 2 forwards of {dict(want)}")
        out[dim] = dict(host_ms=host, busy_ms=busy, per_forward=per_forward,
                        imbalance=worst_imb, f32_max_abs=d32,
                        bf16_bits_equal=same)
        del blocks, rep, got32
    out.update(unsharded_host_ms=flat_host, unsharded_busy_ms=flat_busy)
    del base, flat32
    torch.cuda.empty_cache()
    return out


def sharded_power_law(dev, card) -> dict:
    """The timing phase's 262,144^2 power law in SHARD_N row shards, by the
    §5.4 rule with no TuneDB: each shard's method, whether the plan is
    uniform, its device ms against the unsharded row-split and merge (one
    call), each shard's kernel alone, and C against the plain version."""
    from repro_torch.core import (ExecutionConfig, PlanPolicy, ShardSpec,
                                  build_plan, power_law_csr)
    from repro_torch.distributed.spmm import build_sharded_plan
    from repro_torch.kernels import ops, rowsplit_spmm
    seed, m, d, alpha = (POWER_LAW[x] for x in ("seed", "m", "d", "alpha"))
    n = SERVE_BATCH * SERVE_PROMPT
    a = power_law_csr(seed, m, m, d, alpha=alpha, device=dev)
    gen = torch.Generator(device=dev).manual_seed(50)
    b = torch.randn(m, n, generator=gen, device=dev)
    flat, flat_c = {}, {}
    for method in ("rowsplit", "merge"):
        plan = build_plan(a, PlanPolicy(method=method, with_transpose=False))
        kern = getattr(ops, f"{method}_execute")
        flat[method] = time_ms(lambda: kern(plan.fwd, a.vals, b, m=m,
                                            impl="cuda"), reps=5, inner=5)
        with torch.no_grad():   # the unsharded C, to hold the sharding to
            flat_c[method] = kern(plan.fwd, a.vals, b, m=m, impl="cuda")
        del plan
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    plan = build_sharded_plan(a, PlanPolicy(
        tunedb=None, with_transpose=False, shards=ShardSpec(n=SHARD_N)))
    plan_s = time.perf_counter() - t0
    methods, imb = shard_summary(plan)
    if set(methods) != {"rowsplit"}:
        raise AssertionError(f"sharded power law: shards {methods}; the "
                             "check below holds row-split shards only")
    with torch.no_grad():
        before = rowsplit_spmm.LAUNCHES
        got = plan.execute(a.vals, b, ExecutionConfig(impl="cuda"))
        ran = rowsplit_spmm.LAUNCHES - before
        # The plain version of the loop path, each shard's row-split plain
        # version a block of rows at a time (one call would gather 400 GB).
        vals_ext = torch.cat([a.vals, a.vals.new_zeros(1)])
        want = torch.cat([
            rowsplit_plain_blocked(p.fwd, vals_ext[slot.long()], b,
                                   lm.m)[:hi - lo]
            for p, slot, lm, lo, hi in zip(
                plan.shards, plan.vals_slots, plan.meta.local_metas,
                plan.meta.bounds, plan.meta.bounds[1:])])
    torch.cuda.synchronize()
    tol = dict(rtol=POWER_LAW_TOL["rtol"], atol=POWER_LAW_TOL["atol_of_max"]
               * want.abs().max().item())
    err, _ = check_close("sharded power law vs its plain version", got, want,
                         tol)
    # The plain version above follows the plan's own cuts and slots; the
    # unsharded merge C (each kernel held to its plain version earlier)
    # does not, so a wrong cut, slot or row offset fails here.
    err_flat, _ = check_close("sharded power law vs unsharded merge", got,
                              flat_c["merge"], tol)
    same_rowsplit = torch.equal(got, flat_c["rowsplit"])
    del got, want, flat_c
    ms = time_ms(lambda: plan.execute(a.vals, b), reps=5, inner=5)
    shard_ms = []
    for p, slot, lm in zip(plan.shards, plan.vals_slots,
                           plan.meta.local_metas):
        lv = torch.cat([a.vals, a.vals.new_zeros(1)])[slot.long()]
        kern = getattr(ops, f"{lm.method}_execute")
        shard_ms.append(time_ms(lambda p=p, lv=lv, lm=lm: kern(
            p.fwd, lv, b, m=lm.m, impl="cuda"), reps=5, inner=5))
    print(f"sharded power law {m} x {m} (nnz {a.nnz()}) in {SHARD_N} row "
          f"shards by the §5.4 rule, no TuneDB: methods {methods}, uniform "
          f"{plan.meta.uniform}, bounds {plan.meta.bounds}, nnz imbalance "
          f"{imb:.4f}, l_pad {plan.meta.l_pad} (plan {plan_s:.1f} s); "
          f"{ran} row-split launches a call; device {ms:.4f} ms a call "
          f"(shards' kernels alone {', '.join(f'{x:.4f}' for x in shard_ms)}"
          f" ms) against unsharded row-split {flat['rowsplit']:.4f} ms and "
          f"merge {flat['merge']:.4f} ms; C vs its plain version max |d| "
          f"{err:.3e}, vs the unsharded merge C {err_flat:.3e} (tol rtol "
          f"{tol['rtol']} atol {tol['atol']:.3e}), the unsharded row-split "
          f"C's bits: {same_rowsplit}; {card}")
    out = dict(methods=methods, uniform=plan.meta.uniform, imbalance=imb,
               ms=ms, shard_ms=shard_ms, unsharded_rowsplit_ms=flat[
                   "rowsplit"], unsharded_merge_ms=flat["merge"],
               max_abs_err=err, max_abs_err_unsharded=err_flat,
               launches=ran)
    del plan, a, b
    torch.cuda.empty_cache()
    return out


def sharded_grads(cfg, mlp, dev, card, reset_counts, read_counts) -> dict:
    """Layer 0's pruned FFN at full width, TRAIN_STEPS SGD steps on the
    values through GRAD_SHARDS shards by rows and by cols (the training
    phase's x, target and lr), and the first step's dvals and dB (of x)
    against the unsharded plans' at the reference's gradient bar."""
    import torch.nn.functional as F

    from repro_torch.core import PlanPolicy, ShardSpec
    from repro_torch.models import sparse as S
    from repro_torch.runtime import steps
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    x = torch.randn(SERVE_BATCH, SERVE_PROMPT, cfg.d_model, generator=gen,
                    device=dev)
    y = (F.silu(x @ mlp["w1"]) * (x @ mlp["w3"])) @ mlp["w2"]
    flat = S.prune_mlp(mlp, KEEP)

    def grads(layers):
        vals = {k: v.detach().requires_grad_(True)
                for k, v in S.mlp_vals(layers).items()}
        xx = x.detach().requires_grad_(True)
        pred = S.sparse_mlp_apply(S.mlp_with_vals(layers, vals), xx, None)
        # A sum, not the step's mean: gradients at O(1), where the
        # reference's atol 1e-5 means something.
        loss = ((pred - y) ** 2).sum()
        g = torch.autograd.grad(loss, [*vals.values(), xx])
        return dict(zip([*vals, "dB(x)"], g))

    want = grads(flat)
    exact = f64_dvals(flat, x, y)
    out = {"launches": collections.Counter(), "f64": {}}
    worst = 0.0
    for dim in ("rows", "cols"):
        layers = {k: sl.shard(n=GRAD_SHARDS, dim=dim)
                  for k, sl in flat.items()}
        step, vals = steps.make_sparse_train_step(layers, lr=LR)
        reset_counts()
        losses = []
        for _ in range(TRAIN_STEPS):
            vals, loss = step(vals, x, y)
            losses.append(loss.item())
        counts = read_counts()
        out["launches"].update(counts)
        per_step = {k: v / TRAIN_STEPS for k, v in counts.items() if v}
        got = grads(layers)
        torch.cuda.synchronize()
        gaps = {}
        for name in want:
            d, _ = check_close(f"sharded {dim} {name}", got[name],
                               want[name], grad_tol(want[name]))
            # Entries outside the bar at unit scale (atol 1e-5 as is).
            over = int((~torch.isclose(got[name], want[name],
                                       rtol=SHARD_GRAD_TOL["rtol"],
                                       atol=SHARD_GRAD_TOL["atol_of_max"])
                        ).sum())
            gaps[name] = (f"{d:.3e} of max {want[name].abs().max().item():.3e}"
                          f" ({over} outside atol 1e-5 unscaled)")
            worst = max(worst, d)
            if name in exact:
                out["f64"][f"{dim} {name}"] = f64_gaps(
                    f"sharded {dim} {name}", got[name], want[name],
                    exact[name], card)
        print(f"sharded grads {dim} x {GRAD_SHARDS}: losses "
              + ", ".join(f"{v:.6f}" for v in losses)
              + f"; launches a step {per_step} (the forward SpMM and "
              f"the SDDMM of each of {3 * GRAD_SHARDS} shards, merge dB of "
              f"w2's {GRAD_SHARDS}); "
              f"the sum-of-squares loss's gradients vs unsharded max |d| "
              + ", ".join(f"{k} {v}" for k, v in gaps.items())
              + f" (tol rtol {SHARD_GRAD_TOL['rtol']} atol "
              f"{SHARD_GRAD_TOL['atol_of_max']} of max); {card}")
        # A step: each shard's forward SpMM by its method, an SDDMM a shard
        # (dvals), and w2's dB (its B, the hidden activation, needs one;
        # x none) on each of its shards' transpose plans, by merge.
        want_step = collections.Counter(sddmm=3 * GRAD_SHARDS,
                                        merge_spmm=GRAD_SHARDS)
        for sl in layers.values():
            for lm in sl.plan.meta.local_metas:
                want_step[KERNEL_OF[lm.method]] += 1
        if per_step != dict(want_step) or \
                not all(b < a for a, b in zip(losses, losses[1:])):
            raise AssertionError(f"sharded grads {dim}: launches {per_step}"
                                 f", losses {losses}")
        del layers, step, vals
    out["worst"] = worst
    return out


def f64_dvals(flat, x, y) -> dict:
    """The sum-of-squares loss's dvals of each pruned FFN matrix in
    float64 on the card: the CSR values scattered into dense float64
    weights, the MLP and its gradients in float64, each weight's gradient
    read at its pattern's entries (padded slots 0)."""
    import torch.nn.functional as F
    dense, where = {}, {}
    for name, sl in flat.items():
        a = sl.weight
        m, k = a.shape
        nnz = int(a.row_ptr[-1])
        rows = torch.repeat_interleave(
            torch.arange(m, device=x.device), a.row_ptr.diff().long())
        cols = a.col_ind[:nnz].long()
        w = torch.zeros(m, k, dtype=torch.float64, device=x.device)
        w[rows, cols] = a.vals[:nnz].double()
        dense[name] = w.requires_grad_(True)
        where[name] = (rows, cols, a.vals.shape[0])
    xd, yd = x.double(), y.double()
    h = F.silu(xd @ dense["w1"].T) * (xd @ dense["w3"].T)
    loss = ((h @ dense["w2"].T - yd) ** 2).sum()
    g = dict(zip(dense, torch.autograd.grad(loss, list(dense.values()))))
    out = {}
    for name, (rows, cols, n_pad) in where.items():
        d = torch.zeros(n_pad, dtype=torch.float64, device=x.device)
        d[:rows.numel()] = g[name][rows, cols]
        out[name] = d
    return out


def f64_gaps(what, got, want, exact, card) -> dict:
    """Sharded (``got``) and unsharded (``want``) float32 dvals against the
    float64 ones (``exact``): the largest error of each, over all entries
    and over the entries where the two float32 runs differ by more than
    the gradient bar's unscaled atol 1e-5 (rtol 1e-4)."""
    off = ~torch.isclose(got, want, rtol=SHARD_GRAD_TOL["rtol"],
                         atol=SHARD_GRAD_TOL["atol_of_max"])
    e_sh = (got.double() - exact).abs()
    e_un = (want.double() - exact).abs()
    res = dict(entries=int(off.sum()), max_sharded=e_sh.max().item(),
               max_unsharded=e_un.max().item(),
               off_sharded=e_sh[off].max().item() if off.any() else 0.0,
               off_unsharded=e_un[off].max().item() if off.any() else 0.0)
    print(f"{what} vs float64: sharded max |d| {res['max_sharded']:.3e}, "
          f"unsharded {res['max_unsharded']:.3e}; at the {res['entries']} "
          f"entries outside atol 1e-5 of each other: sharded "
          f"{res['off_sharded']:.3e}, unsharded {res['off_unsharded']:.3e}"
          f"; {card}")
    return res


def spmd_child() -> int:
    """One rank of the SPMD check (``python3 -c``; argv: rank, world, the
    rendezvous file, layer 0's FFN weights, the output directory): on
    ``cuda:0`` shared with the other ranks over gloo, each pruned matrix
    sharded by rows and by cols over a ``("data",)`` mesh of the ranks,
    forward and backward through the SPMD path (this rank's shard) and the
    loop path (every shard here), compared."""
    import datetime

    import torch.distributed as dist
    rank, world, store, weights, out_dir = sys.argv[1:6]
    rank, world = int(rank), int(world)
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.core import (ExecutionConfig, PlanPolicy, ShardSpec,
                                  prune_to_csr)
    from repro_torch.distributed import spmm as dspmm
    from repro_torch.engine import get_plan
    from repro_torch.kernels import merge_spmm, rowsplit_spmm, sddmm
    from repro_torch.launch.mesh import make_mesh
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=SPMD_INIT_S))
    mesh = make_mesh((world,), ("data",), "cuda")
    mods = {"rowsplit_spmm": rowsplit_spmm, "merge_spmm": merge_spmm,
            "sddmm": sddmm}
    res = {"backend": str(dist.get_backend()), "cases": []}
    n = SERVE_BATCH * SERVE_PROMPT
    for name, w in torch.load(weights, map_location=dev).items():
        a = prune_to_csr(w.T, KEEP)            # as SparseLinear.from_dense
        m, k = a.shape
        for dim in ("rows", "cols"):
            spmd = get_plan(a, PlanPolicy(shards=ShardSpec(
                mesh=mesh, axis="data", dim=dim)))
            loop = get_plan(a, PlanPolicy(shards=ShardSpec(n=world,
                                                           dim=dim)))
            g = torch.Generator(device=dev).manual_seed(60)
            b = torch.randn(k, n, generator=g, device=dev)
            wgt = torch.randn(m, n, generator=g, device=dev)

            def run(plan):
                vals = a.vals.clone().requires_grad_(True)
                bb = b.clone().requires_grad_(True)
                before = {key: mod.LAUNCHES for key, mod in mods.items()}
                c = dspmm.execute_sharded(plan, vals, bb,
                                          ExecutionConfig(impl="cuda"))
                (c * wgt).sum().backward()
                torch.cuda.synchronize()
                ran = {key: mod.LAUNCHES - before[key]
                       for key, mod in mods.items()}
                return (c.detach(), vals.grad, bb.grad), ran

            got, ran = run(spmd)
            want, _ = run(loop)
            case = dict(matrix=name, dim=dim, shape=[m, k],
                        spmd=spmd.meta.spmd_mesh() is not None,
                        methods=[lm.method for lm in spmd.meta.local_metas],
                        launches=ran)
            for what, x, y in zip(("C", "dvals", "dB"), got, want):
                tol = TOL["float32"] if what == "C" else grad_tol(y)
                case[what] = dict(
                    bits=bool(torch.equal(x, y)),
                    max_abs=(x - y).abs().max().item(),
                    ok=bool(torch.allclose(x, y, **tol)))
            res["cases"].append(case)
    res["online"] = spmd_online(mesh, dev, out_dir)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w",
              encoding="utf-8") as f:
        json.dump(res, f)
    dist.destroy_process_group()
    return 0


def spmd_online(mesh, dev, out_dir) -> dict:
    """One rank of ``serve_online`` over ``mesh`` in lockstep (a
    ``spmd_child`` stage): Llama-3.2-1B at full width from SEED, every
    pruned-FFN weight in row shards, one a rank; what this rank built,
    ran and launched, and on rank 0 the load's numbers, with every served
    request's tokens, bucket, row, packed matrix and rows saved to
    ``online_rows.pt`` beside the rank files."""
    from repro_torch.configs import get_config
    from repro_torch.core import PlanPolicy, ShardSpec
    from repro_torch.engine import EagerProgram
    from repro_torch.kernels import rowsplit_spmm
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    cfg = get_config("llama3.2-1b")
    params = M.init_params(cfg, SEED, dev)
    policy = PlanPolicy(shards=ShardSpec(mesh=mesh, axis="data"))
    before = rowsplit_spmm.LAUNCHES
    t0 = time.perf_counter()
    rep = serve.serve_online(cfg, params, KEEP, batch=SERVE_BATCH,
                             prompt_len=SERVE_PROMPT,
                             requests=MESH_ONLINE_REQUESTS, seed=SEED,
                             policy=policy, keep_served=True)
    torch.cuda.synchronize()
    srv = rep.server
    blocks = srv.state[1]
    out = dict(run_s=time.perf_counter() - t0, warmup_s=rep.warmup_s,
               launches=rowsplit_spmm.LAUNCHES - before,
               ran=[list(r) for r in rep.ran], forwards=rep.forwards,
               programs=rep.programs,
               replans=rep.replans, recompiles=rep.recompiles,
               eager=all(isinstance(srv.program(*sh), EagerProgram)
                         for sh in srv.ladder.shapes()),
               spmd=all(sl.plan.meta.spmd_mesh() is not None
                        for blk in blocks for sl in blk["mlp"].values()),
               methods=sorted({lm.method for blk in blocks
                               for sl in blk["mlp"].values()
                               for lm in sl.plan.meta.local_metas}))
    load = rep.load
    if load is not None:
        out.update(rate_rps=rep.rate_rps, n=load.n, ok=load.ok,
                   shed=load.shed, error=load.error, wall_s=load.wall_s,
                   req_per_s=load.throughput_rps, p50_ms=load.p50_us / 1e3,
                   p99_ms=load.p99_us / 1e3)
        torch.save([dict(tokens=tokens, bucket=fut.bucket, row=fut.row,
                         packed=fut.packed, rows=fut.result().cpu())
                    for tokens, fut in load.served],
                   os.path.join(out_dir, "online_rows.pt"))
    return out



def sharded_spmd(cfg, params, logits, dev, card) -> dict:
    """SPMD_RANKS processes on the one card over gloo (the library already
    built: the ranks load it): ``spmd_child`` on layer 0's pruned FFN and
    ``serve_online`` over the ranks (its rows held by ``mesh_online``),
    then ``torchrun -m repro_torch.launch.serve --prune-ffn 0.25 --mesh
    SPMD_RANKS`` at full width, its logits against ``logits`` (the
    unsharded forward, same params and prompt), and ``... --serve --mesh
    SPMD_RANKS``.  Ranks sharing a card measure correctness, not
    scaling."""
    mlp = params["blocks"][0]["mlp"]
    from repro_torch.kernels import _cuda
    out_dir = _cuda.BUILD_DIR / "sharded"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    weights = out_dir / "layer0_ffn.pt"
    torch.save({k: w.detach().cpu() for k, w in mlp.items()}, weights)
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); import chip_smoke; "
            "sys.exit(chip_smoke.spmd_child())")
    sys.stdout.flush()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(SPMD_RANKS),
         str(out_dir / "store"), str(weights), str(out_dir)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(SPMD_RANKS)]
    logs = []
    try:
        for p in procs:
            left = max(1.0, t0 + SPMD_JOIN_S - time.perf_counter())
            logs.append(p.communicate(timeout=left)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode:
            raise AssertionError(f"SPMD rank {r} exited {p.returncode}:\n"
                                 f"{log[-4000:]}")
    ranks_s = time.perf_counter() - t0
    bad = []
    ranks = []
    for r in range(SPMD_RANKS):
        with open(out_dir / f"rank{r}.json", encoding="utf-8") as f:
            res = json.load(f)
        ranks.append(res)
        for c in res["cases"]:
            gaps = ", ".join(
                f"{w} bits" if c[w]["bits"]
                else f"{w} max |d| {c[w]['max_abs']:.3e}"
                for w in ("C", "dvals", "dB"))
            print(f"spmd rank {r}/{SPMD_RANKS} ({res['backend']}) "
                  f"{c['matrix']} {tuple(c['shape'])} {c['dim']}: SPMD path "
                  f"{c['spmd']}, shards {c['methods']}, this rank's launches "
                  f"{c['launches']}; vs the loop path: {gaps}")
            if not c["spmd"] or not all(c[w]["ok"] for w in ("C", "dvals",
                                                               "dB")):
                bad.append((r, c["matrix"], c["dim"]))
    if bad:
        raise AssertionError(f"SPMD ranks disagree with the loop path: {bad}")
    online = mesh_online(cfg, params, [res["online"] for res in ranks],
                         out_dir, dev, card)
    path = out_dir / "logits.pt"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [SRC] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    argv = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", str(SPMD_RANKS), "-m",
            "repro_torch.launch.serve", "--arch", cfg.name, "--prune-ffn",
            str(KEEP), "--mesh", str(SPMD_RANKS), "--device", "cuda",
            "--logits-out", str(path)]
    t1 = time.perf_counter()
    proc = subprocess.run(argv, capture_output=True, text=True, env=env,
                          timeout=TORCHRUN_S, check=False)
    run_s = time.perf_counter() - t1
    tail = [ln for ln in proc.stdout.splitlines() if ln.startswith(
        ("[serve]", "pruned-FFN"))]
    print(f"$ torchrun --nproc-per-node {SPMD_RANKS} -m "
          f"repro_torch.launch.serve --arch {cfg.name} --prune-ffn {KEEP} "
          f"--mesh {SPMD_RANKS} --device cuda  (exit {proc.returncode}, "
          f"{run_s:.1f} s)")
    for ln in tail:
        print(f"  {ln}")
    if proc.returncode:
        raise AssertionError(f"torchrun serve --mesh exited "
                             f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    got = torch.load(path).to(dev)
    serve_gap(f"torchrun serve --mesh {SPMD_RANKS} logits vs unsharded",
              got, logits)
    same = torch.equal(got, logits)
    print(f"torchrun serve --mesh {SPMD_RANKS}: logits the unsharded bits: "
          f"{same}; ranks' check {ranks_s:.1f} s; {card}")
    cli = mesh_online_cli(cfg, env)
    return dict(backend=res["backend"], ranks_s=ranks_s, serve_s=run_s,
                serve_bits_equal=same, online=online, online_cli=cli)


def mesh_online(cfg, params, ranks, out_dir, dev, card) -> dict:
    """The ranks' ``serve_online`` in lockstep (``spmd_online``): every
    rank ran the leader's buckets in its order (each counted where its
    program call returned), built nothing after warmup, ran eager buckets
    on the SPMD path and launched row-split 48 times a forward (a warm
    call a build, a forward a program call); every served
    request's rows against the unsharded eager forward (same params,
    plans built here) of the bucket matrix it was packed in, within the
    serving bars."""
    from repro_torch.launch import serve
    lead = ranks[0]
    for r, o in enumerate(ranks):
        forwards = o["programs"] + o["forwards"]
        print(f"mesh online rank {r}/{SPMD_RANKS}: {o['programs']} bucket "
              f"programs, eager {o['eager']}, SPMD path {o['spmd']}, shard "
              f"methods {o['methods']}; {forwards} forwards ("
              f"{o['programs']} warm calls at build, {o['forwards']} "
              f"program calls); row-split launches {o['launches']} ("
              f"{o['launches'] / max(forwards, 1):.0f} a forward); recompiles after warmup {o['recompiles']}, plans "
              f"built while serving {o['replans']}; warmup {o['warmup_s']:.3f} "
              f"s, run {o['run_s']:.2f} s; eager buckets over gloo, "
              f"{SPMD_RANKS} ranks on one card; {card}")
        if o["ran"] != lead["ran"] or o["forwards"] != lead["forwards"] or \
                len(o["ran"]) != o["forwards"] or o["recompiles"] or \
                o["replans"] or not (o["eager"] and o["spmd"]) or \
                o["launches"] != 48 * forwards or o["programs"] != 9:
            raise AssertionError(f"mesh online rank {r}: {o}")
    if (lead["ok"], lead["shed"], lead["error"]) != (
            MESH_ONLINE_REQUESTS, 0, 0):
        raise AssertionError(f"mesh online: {lead}")
    served = torch.load(out_dir / "online_rows.pt", weights_only=False)
    blocks = serve.prune_ffn_blocks(params, cfg, KEEP)
    base = serve.make_pruned_forward(cfg)
    want, gap, rel_gap, bits = {}, 0.0, 0.0, 0
    with torch.inference_mode():
        for q in served:
            n = len(q["tokens"])
            key = q["packed"].tobytes()
            if key not in want:
                want[key] = base(params, blocks,
                                 torch.from_numpy(q["packed"]).to(dev))
            if tuple(q["bucket"]) != q["packed"].shape or \
                    not (q["packed"][q["row"], :n] == q["tokens"]).all():
                raise AssertionError("mesh online: a request's packed row "
                                     "is not its tokens")
            ref = want[key][q["row"], :n]
            got = q["rows"].to(dev)
            d, rel = logits_gap(got, ref)
            if not (d <= SERVE_TOL["max_abs"] and
                    rel <= SERVE_TOL["rel_fro"]):
                serve_gap(f"mesh online request (length {n}) at bucket "
                          f"{tuple(q['bucket'])} vs unsharded", got, ref)
            gap, rel_gap = max(gap, d), max(rel_gap, rel)
            bits += bool(torch.equal(got, ref))
    del blocks, want
    torch.cuda.empty_cache()
    print(f"mesh online: offered {lead['rate_rps']:.2f} req/s (auto rate), "
          f"{lead['ok']}/{lead['n']} ok, {lead['shed']} shed, "
          f"{lead['error']} error in {lead['wall_s']:.3f} s = "
          f"{lead['req_per_s']:.3f} req/s served, p50 {lead['p50_ms']:.3f} "
          f"ms, p99 {lead['p99_ms']:.3f} ms (of {lead['n']} latencies: "
          f"near the largest, one stall sets it), warmup "
          f"{lead['warmup_s']:.3f} s; "
          f"every served request's rows vs the unsharded eager forward of "
          f"its bucket matrix: max |d| {gap:.4e}, worst relative "
          f"Frobenius {rel_gap:.4e} (tol max_abs {SERVE_TOL['max_abs']}, "
          f"rel_fro {SERVE_TOL['rel_fro']}), "
          f"{bits}/{len(served)} bit-equal; eager buckets over gloo, "
          f"{SPMD_RANKS} ranks on one card; {card}")
    return dict({k: lead[k] for k in (
        "warmup_s", "rate_rps", "ok", "shed", "error", "req_per_s",
        "p50_ms", "p99_ms")}, rank_launches=[o["launches"] for o in ranks],
        max_abs=gap, rel_fro=rel_gap, bit_equal=bits, served=len(served))


def mesh_online_cli(cfg, env) -> dict:
    """``torchrun --nproc-per-node SPMD_RANKS -m repro_torch.launch.serve
    --prune-ffn KEEP --serve --mesh SPMD_RANKS``: exit 0, and rank 0's
    lines show every request served and nothing built after warmup."""
    argv = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", str(SPMD_RANKS), "-m",
            "repro_torch.launch.serve", "--arch", cfg.name, "--prune-ffn",
            str(KEEP), "--serve", "--mesh", str(SPMD_RANKS), "--device",
            "cuda"]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, capture_output=True, text=True, env=env,
                          timeout=TORCHRUN_S, check=False)
    run_s = time.perf_counter() - t0
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("[serve]")]
    print(f"$ torchrun --nproc-per-node {SPMD_RANKS} -m "
          f"repro_torch.launch.serve --arch {cfg.name} --prune-ffn {KEEP} "
          f"--serve --mesh {SPMD_RANKS} --device cuda  (exit "
          f"{proc.returncode}, {run_s:.1f} s)")
    for ln in lines:
        print(f"  {ln}")
    text = "\n".join(lines)
    want = (f"{MESH_ONLINE_REQUESTS}/{MESH_ONLINE_REQUESTS} ok (0 shed, "
            "0 error)", "recompiles after warmup: 0",
            "plans built during serving: 0",
            f"eager; lockstep over {SPMD_RANKS} ranks, gloo collectives")
    if proc.returncode or not all(w in text for w in want):
        raise AssertionError(f"torchrun serve --serve --mesh exited "
                             f"{proc.returncode}:\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-3000:]}")
    return dict(run_s=run_s, lines=lines)


def sharded_moe(dev, card, read_counts) -> dict:
    """An OLMoE-1B-7B MoE layer (published widths, bf16 compute, weights
    from a seed) on batch 4 x prompt 32 tokens at ``moe_groups`` =
    MOE_GROUPS: the grouped GEMM kernel against its plain version, and
    against ``moe_groups`` = 0 where no expert overflows."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config("olmoe-1b-7b")
    cfg_g = dataclasses.replace(cfg, moe_groups=MOE_GROUPS)
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    p = moe.init_moe(gen, cfg)
    x = torch.randn(SERVE_BATCH, SERVE_PROMPT, cfg.d_model, generator=gen,
                    device=dev).to(cfg.cdtype)
    with torch.no_grad():
        before = read_counts()["moe_gemm"]
        got, aux = moe.moe_apply(p, x, cfg_g)
        ran = read_counts()["moe_gemm"] - before
        want, _ = moe.moe_apply(p, x, cfg_g, impl="torch")
        flat, _ = moe.moe_apply(p, x, cfg)
        _, experts, _ = moe.route(p, x.reshape(-1, cfg.d_model), cfg)
    torch.cuda.synchronize()
    tol = MOE_TOL["bfloat16"]
    d, r = check_close(f"moe_groups={MOE_GROUPS} kernel vs plain", got, want,
                       tol)
    counts = moe._expert_counts(experts, cfg.num_experts)
    t = SERVE_BATCH * SERVE_PROMPT
    cap = moe.TT * max(1, -(-int(t * cfg.top_k * 1.25) //
                            (cfg.num_experts * moe.TT)))
    fits = int(counts.max()) <= cap
    dg, _ = check_close(f"moe_groups={MOE_GROUPS} vs ungrouped", got, flat,
                        tol) if fits else (float("nan"), None)
    print(f"sharded moe {cfg.name} layer (d {cfg.d_model}, ff {cfg.d_ff}, "
          f"{cfg.num_experts} experts top-{cfg.top_k}, bf16) on "
          f"{SERVE_BATCH} x {SERVE_PROMPT} tokens, moe_groups {MOE_GROUPS}: "
          f"{ran} grouped GEMM launches (the groups folded into one a "
          f"weight); kernel vs plain max |d| {d:.3e} (tol rtol {tol['rtol']}"
          f" atol {tol['atol']}; worst ratio {r:.3f}); vs moe_groups 0 "
          f"(busiest expert {int(counts.max())} of capacity {cap}: no "
          f"overflow {fits}) max |d| {dg:.3e}; aux {aux.item():.6f}; {card}")
    if ran != 3 or not fits:
        raise AssertionError(f"moe_groups: {ran} launches (want 3), "
                             f"busiest expert {int(counts.max())} of {cap}")
    return dict(launches=ran, max_abs=d, vs_ungrouped=dg)


def sharded(dev, card, reset_counts, read_counts) -> dict:
    """The sharded phase: returns the main path's launches by kernel (the
    Llama forwards' and the sharded training steps' in this process, the
    MoE layer's kernel run; not the SPMD ranks' nor the comparisons'), the
    worst kernel-vs-plain errors and what it measured."""
    from repro_torch.configs import get_config
    from repro_torch.engine import clear_cache
    from repro_torch.models import model as M
    clear_cache()
    torch.cuda.empty_cache()
    cfg = get_config("llama3.2-1b")
    params = M.init_params(cfg, SEED, dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    prompt = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                           generator=g, device=dev)
    print(f"sharded: {cfg.name} {cfg.num_layers} layers, keep {KEEP}, batch "
          f"{SERVE_BATCH} x prompt {SERVE_PROMPT}, seed {SEED}")
    llama = sharded_llama(cfg, params, prompt, dev, card, reset_counts,
                          read_counts)
    launches = collections.Counter(llama.pop("launches"))
    mlp = params["blocks"][0]["mlp"]
    clear_cache()
    grads = sharded_grads(cfg, mlp, dev, card, reset_counts, read_counts)
    launches.update(grads.pop("launches"))
    spmd = sharded_spmd(cfg, params, llama.pop("logits"), dev, card)
    del params, mlp
    clear_cache()
    torch.cuda.empty_cache()
    power = sharded_power_law(dev, card)
    mo = sharded_moe(dev, card, read_counts)
    launches["moe_gemm"] += mo["launches"]
    clear_cache()
    torch.cuda.empty_cache()
    return dict(launches=dict(launches), llama=llama, grads=grads,
                spmd=spmd, power_law=power, moe=mo,
                worst={"rowsplit_spmm": power["max_abs_err"],
                       "moe_gemm": mo["max_abs"]})


# ---------------------------------------------------------- model parallel --
# One prompt of prefill_32k's length through Llama-3.2-1B's pruned serve
# path, then LONG_GEN greedy tokens; its peak must stay under LONG_PEAK.
LONG_PREFILL, LONG_GEN, LONG_PEAK = 32_768, 4, 24e9
LONG_PLAIN_COLS = 256                # the plain versions, a column block
ATTN_PARITY_S = 8192
# The mesh step: MP_RANKS gloo ranks on the one card, a 2 x 2 mesh;
# Llama-3.2-1B at full width cut to MP_LAYERS layers, f32 compute.
MP_RANKS, MP_LAYERS, MP_BATCH, MP_SEQ, MP_STEPS = 4, 2, 4, 256, 2
MP_JOIN_S = 420
DRYRUNS = (("llama3.2-1b", "prefill_32k", ["--both-meshes"]),
           ("qwen2-72b", "train_4k", []))
DRYRUN_S = 700


class EventTimes(list):
    """``serve.generate``'s ``times``: each append, made after a forward
    and its synchronise, also records a CUDA event."""

    def __init__(self):
        super().__init__()
        self.events = []

    def append(self, ms):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append(ev)
        super().append(ms)


def long_spmm_hold(sl, x, dev, card) -> dict:
    """Layer 0's pruned w1 at n = LONG_PREFILL: the served B (x
    transposed, f32), row-split on the served plan and merge on a merge
    plan of the same pattern, each kernel held against its plain version
    (a block of LONG_PLAIN_COLS columns at a time) at the f32 parity bar,
    timed, and set beside the 2·nnz·n bound at 67 TFLOP/s."""
    from repro_torch.core import PlanPolicy, build_plan
    from repro_torch.kernels import merge_spmm, ops, rowsplit_spmm
    a = sl.weight
    m, k = a.shape
    b = x.transpose(-1, -2).float().contiguous()           # (1, k, n)
    n = b.shape[-1]
    nnz = a.nnz()
    bound = 2 * nnz * n / FP32_FLOP_PER_S * 1e3
    plans = {"rowsplit": sl.plan,
             "merge": build_plan(a, PlanPolicy(method="merge",
                                               with_transpose=False))}
    kernels = {"rowsplit": rowsplit_spmm.rowsplit_spmm_cuda,
               "merge": merge_spmm.merge_spmm_cuda}
    execs = {"rowsplit": ops.rowsplit_execute, "merge": ops.merge_execute}
    out = {}
    for method, plan in plans.items():
        if plan.meta.method != method:
            raise AssertionError(f"layer 0 w1's plan is {plan.meta.method}"
                                 f", expected {method}")
        fwd = plan.fwd
        by_body = dict(rowsplit_spmm.LAUNCHES_BY_BODY)
        got = kernels[method](fwd, a.vals, b, m)[0]
        ran = [key for key, v in rowsplit_spmm.LAUNCHES_BY_BODY.items()
               if v != by_body.get(key, 0)]
        want = torch.cat([execs[method](
            fwd, a.vals, b[0, :, c:c + LONG_PLAIN_COLS], m=m, impl="torch")
            for c in range(0, n, LONG_PLAIN_COLS)], dim=1)
        torch.cuda.synchronize()
        d, r = check_close(f"{method} at n={n}", got, want, TOL["float32"])
        del want
        ms = time_ms(lambda: kernels[method](fwd, a.vals, b, m), reps=3,
                     inner=3)
        out[method] = dict(n=n, nnz=nnz, ms=ms, bound_ms=bound, max_abs=d)
        extra = ""
        if method == "rowsplit":
            # The body the rule picks, and the warp-per-row body beside it
            # (bit-equal at one part; timed at the rule's parts).
            row = kernels[method](fwd, a.vals, b, m, parts=1)[0]
            torch.cuda.synchronize()
            if ran == ["staged"] and not torch.equal(got, row):
                raise AssertionError(f"long prefill at n={n}: the staged "
                                     "body differs from r=1")
            del row
            out[method].update(body=ran, rows_ms=time_ms(
                lambda: kernels[method](fwd, a.vals, b, m, staged=False),
                reps=3, inner=3))
            extra = (f"; body {ran}, the warp-per-row body "
                     f"{out[method]['rows_ms']:.4f} ms")
        del got
        print(f"long prefill {method} layer 0 w1 {(m, k)} nnz {nnz} n {n} "
              f"f32: kernel vs plain (blocks of {LONG_PLAIN_COLS} columns) "
              f"max |d| {d:.3e} (tol rtol {TOL['float32']['rtol']} atol "
              f"{TOL['float32']['atol']}; worst ratio {r:.3f}); kernel "
              f"{ms:.4f} ms, {ms / bound:.2f}x the 2*nnz*n bound {bound:.4f}"
              f" ms{extra}; {card}")
    return out


def long_prefill(dev, card, reset_counts, read_counts) -> dict:
    """Llama-3.2-1B at full width, keep KEEP: one prompt of LONG_PREFILL
    tokens through the serve path (``serve.prune_ffn_blocks``, then
    ``serve.generate``: the prefill, then LONG_GEN greedy decode steps),
    counted from 0; its SpMM launches by kernel and body, the prefill's
    host ms and device span, decode steps, and the peak memory."""
    from repro_torch.configs import get_config
    from repro_torch.engine import clear_cache
    from repro_torch.kernels import merge_spmm, rowsplit_spmm
    from repro_torch.launch import serve
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    clear_cache()
    torch.cuda.empty_cache()
    cfg = get_config("llama3.2-1b")
    params = M.init_params(cfg, SEED, dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    prompt = torch.randint(0, cfg.vocab_size, (1, LONG_PREFILL),
                           generator=g, device=dev)
    t0 = time.perf_counter()
    pruned = dict(params, blocks=serve.prune_ffn_blocks(params, cfg, KEEP))
    del params
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    methods = collections.Counter(sl.method for blk in pruned["blocks"]
                                  for sl in blk["mlp"].values())
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    reset_counts()
    times = EventTimes()
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    out = serve.generate(cfg, pruned, prompt, LONG_GEN, times=times)
    counts = read_counts()
    bodies = {name: dict(mod.LAUNCHES_BY_BODY) for name, mod in
              (("rowsplit_spmm", rowsplit_spmm), ("merge_spmm", merge_spmm))}
    peak = torch.cuda.max_memory_allocated()
    span = start.elapsed_time(times.events[0])
    want = dict.fromkeys(counts, 0)
    for method, n in methods.items():
        want[KERNEL_OF[method]] += n * (1 + LONG_GEN)
    print(f"long prefill {cfg.name} {cfg.num_layers} layers, keep {KEEP}, "
          f"1 x {LONG_PREFILL} tokens + {LONG_GEN} greedy: planned "
          f"{dict(methods)} in {plan_s:.2f} s; launches {counts} (want "
          f"{want}), by body {bodies}; prefill host {times[0]:.1f} ms "
          f"(synchronised), device span {span:.1f} ms (CUDA events, start "
          f"to the prefill's end); decode steps "
          + ", ".join(f"{t:.1f}" for t in times[1:])
          + f" ms; peak {peak / 1e9:.3f} GB (allocated before "
          f"{before / 1e9:.3f} GB; limit {LONG_PEAK / 1e9:.0f} GB); {card}")
    if counts != want:
        raise AssertionError(f"long prefill launched {counts}, want {want}")
    if peak >= LONG_PEAK:
        raise AssertionError(f"long prefill peak {peak / 1e9:.3f} GB")
    if out.shape != (1, LONG_PREFILL + LONG_GEN) or not bool(
            ((out >= 0) & (out < cfg.vocab_size)).all()) or not torch.equal(
            out[:, :LONG_PREFILL], prompt):
        raise AssertionError(f"long prefill generated {tuple(out.shape)}")
    print(f"long prefill tokens {out[0, LONG_PREFILL:].tolist()}")
    with torch.no_grad():
        x = M.embed_inputs(pruned, cfg, {"tokens": prompt})
        x = L.norm_apply(pruned["blocks"][0]["ln2"], x, cfg.norm)
        hold = long_spmm_hold(pruned["blocks"][0]["mlp"]["w1"], x, dev,
                              card)
    del pruned, x
    clear_cache()
    torch.cuda.empty_cache()
    return dict(launches=counts, bodies=bodies, prefill_host_ms=times[0],
                prefill_span_ms=span, decode_ms=list(times[1:]), peak=peak,
                hold=hold)


def dense_attention(q, k, v):
    """The unchunked causal GQA formula: every score of the prompt at
    once, f32 (for the parity check only)."""
    b, s, h, dh = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, s, kvh, h // kvh, dh).float()
    sc = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * dh ** -0.5
    pos = torch.arange(s, device=q.device)
    sc = sc.masked_fill(pos[:, None] < pos[None, :], float("-inf"))
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bkgqs,bskd->bkgqd", p, v.float())
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, dh).to(q.dtype)


def attention_parity(dev, card) -> dict:
    """Llama-3.2-1B's layer-0 q/k/v at 1 x ATTN_PARITY_S: the model path's
    blockwise ``layers.flash_attention`` (its chunk for the length) held
    against the CUDA ``ops.flash_attention`` in bf16 and against the
    unchunked formula in f32, with the times of each."""
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    q, k, v = model_qkv("llama3.2-1b", 1, ATTN_PARITY_S, dev)
    c = L.attention_chunk(ATTN_PARITY_S)
    res = {}
    with torch.no_grad():
        blk = L.flash_attention(q, k, v, q_chunk=c, kv_chunk=c)
        ker = ops.flash_attention(q, k, v, impl="cuda")
        torch.cuda.synchronize()
        d, r = check_close("blockwise vs flash kernel bf16", blk, ker,
                           FLASH_TOL["bfloat16"])
        res["bf16_vs_kernel"] = d
        blk_ms = time_ms(lambda: L.flash_attention(q, k, v, q_chunk=c,
                                                   kv_chunk=c),
                         reps=3, inner=2)
        ker_ms = time_ms(lambda: ops.flash_attention(q, k, v, impl="cuda"),
                         reps=3, inner=5)
        print(f"attention parity llama3.2-1b layer 0 1 x {ATTN_PARITY_S} "
              f"bf16: blockwise ({c}-chunks) vs the flash kernel max |d| "
              f"{d:.3e} (tol rtol {FLASH_TOL['bfloat16']['rtol']}; worst "
              f"ratio {r:.3f}); blockwise {blk_ms:.3f} ms, kernel "
              f"{ker_ms:.4f} ms; {card}")
        qf, kf, vf = q.float(), k.float(), v.float()
        del blk, ker, q, k, v
        blk = L.flash_attention(qf, kf, vf, q_chunk=c, kv_chunk=c)
        want = dense_attention(qf, kf, vf)
        torch.cuda.synchronize()
        d, r = check_close("blockwise vs unchunked f32", blk, want,
                           FLASH_TOL["float32"])
        res["f32_vs_unchunked"] = d
        print(f"attention parity f32: blockwise vs the unchunked formula "
              f"max |d| {d:.3e} (tol rtol {FLASH_TOL['float32']['rtol']} "
              f"atol {FLASH_TOL['float32']['atol']}; worst ratio {r:.3f});"
              f" {card}")
    del blk, want, qf, kf, vf
    torch.cuda.empty_cache()
    return dict(res, blockwise_ms=blk_ms, kernel_ms=ker_ms)


def mesh_child() -> int:
    """One rank of the mesh step (``python3 -c``; argv: rank, world, the
    rendezvous file, the output directory), on ``cuda:0`` shared with the
    other ranks over gloo: ``dryrun.build_step_and_shardings`` for
    train_4k's kind on Llama-3.2-1B cut to MP_LAYERS layers (f32 compute)
    over a 2 x 2 ("data", "model") mesh, the first batch's gradients and
    MP_STEPS steps; then the state resharded 2 x 2 -> 4 x 1 -> 2 x 2 with
    ``elastic``, each leaf gathered and compared.  Rank 0 last runs the
    one-process step on the same inputs and compares."""
    import datetime

    import torch.distributed as dist
    rank, world, store, out_dir = sys.argv[1:5]
    rank, world = int(rank), int(world)
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.distributed import elastic
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps as R
    from repro_torch.tree import leaves, paths
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=SPMD_INIT_S))
    launch_mesh.gloo_cuda_all_gather()
    mesh = launch_mesh.make_mesh((2, 2), ("data", "model"), "cuda")
    cfg = dataclasses.replace(cut_config(get_config("llama3.2-1b"),
                                         MP_LAYERS), compute_dtype="float32")
    shape = ShapeConfig("train_4k", MP_SEQ, MP_BATCH, "train")
    step, _, in_sh, out_sh, cfg = dryrun.build_step_and_shardings(
        cfg, shape, mesh, microbatches=1, param_mode="fsdp")
    run = sh.sharded(step, mesh, tuple(in_sh.values()), out_sh)
    state = R.init_train_state(cfg, SEED, device=dev)
    batches = dense_batches(cfg, dev, MP_STEPS, b=MP_BATCH, s=MP_SEQ)
    res = {"backend": str(dist.get_backend()), "mesh": "2x2"}
    t0 = time.perf_counter()
    dstate = sh.redistribute(state, in_sh["state"])
    with sh.use_mesh(mesh):
        loss_m, _, grads_m = R.loss_and_grads(
            dstate["params"], cfg, sh.redistribute(batches[0],
                                                   in_sh["batch"]))
    loss_m = loss_m.full_tensor().item()
    grads_m = sh.gather(grads_m)           # a collective: every rank
    res["grads_s"] = time.perf_counter() - t0
    if rank:
        del grads_m, state
    losses, steps_ms = [], []
    for b in batches:
        t1 = time.perf_counter()
        dstate, metrics = run(dstate, b)
        torch.cuda.synchronize()
        steps_ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(metrics["loss"].to_local().item())
    res.update(losses=losses, steps_ms=steps_ms,
               placements={p: str(s.placements) for p, s in zip(
                   paths(in_sh["state"]["params"]),
                   leaves(in_sh["state"]["params"]))
                   if "blocks/0" in p or "/" not in p})
    # Elastic: 2 x 2 -> 4 x 1 -> 2 x 2, every leaf gathered and compared.
    mesh41 = launch_mesh.make_mesh((4, 1), ("data", "model"), "cuda")
    res["validate_2x2_to_4x1"] = elastic.validate_elastic_resize(
        mesh, mesh41, MP_BATCH)

    def moved(st, to):
        return {"params": elastic.reshard_params(st["params"], to),
                "opt": elastic.reshard_state(st["opt"], to)}

    s41 = moved(dstate, mesh41)
    s22 = moved(s41, mesh)
    bits, n_leaves = True, 0
    for a, b, c in zip(leaves(dstate), leaves(s41), leaves(s22),
                       strict=True):
        fa, fb, fc = a.full_tensor(), b.full_tensor(), c.full_tensor()
        bits &= bool(torch.equal(fa, fb) and torch.equal(fa, fc)
                     and fa.dtype == fc.dtype)
        n_leaves += 1
    res.update(reshard_bits=bits, reshard_leaves=n_leaves,
               back_placements=all(
                   x.placements == y.placements
                   for x, y in zip(leaves(dstate), leaves(s22))))
    final = sh.gather(dstate)
    dist.barrier()
    if rank:
        del final
    else:
        # The one-process step on the same state and batches.
        loss_1, _, grads_1 = R.loss_and_grads(state["params"], cfg,
                                              batches[0])
        res["grad_loss"] = [loss_m, loss_1.item()]
        gaps = []
        for p, g_m, g_1 in zip(paths(grads_1), leaves(grads_m),
                               leaves(grads_1), strict=True):
            d = (g_m - g_1).abs()
            ok = bool(torch.allclose(g_m, g_1, **DENSE_GRAD_TOL))
            gaps.append((p, d.max().item(), g_1.abs().max().item(), ok))
        res["grads"] = gaps
        del grads_m, grads_1
        one = R.make_train_step(cfg, adamw.AdamWConfig())
        st, losses_1 = state, []
        for b in batches:
            st, m = one(st, b)
            losses_1.append(m["loss"].item())
        res["losses_one"] = losses_1
        res["state_max_abs"] = max(
            (x.float() - y.float()).abs().max().item()
            for x, y in zip(leaves(final), leaves(st), strict=True))
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w",
              encoding="utf-8") as f:
        json.dump(res, f)
    dist.destroy_process_group()
    return 0


def mesh_step(card) -> dict:
    """MP_RANKS processes of ``mesh_child`` on the one card over gloo,
    their results held: the mesh's gradients against the one-process
    step's at the dense trainer's gradient bar, its losses at the f32
    bar, and the 2 x 2 -> 4 x 1 -> 2 x 2 reshard bit-equal.  Ranks sharing
    a card measure correctness, not scaling."""
    from repro_torch.kernels import _cuda
    out_dir = _cuda.BUILD_DIR / "model_parallel" / "mesh"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); import chip_smoke; "
            "sys.exit(chip_smoke.mesh_child())")
    sys.stdout.flush()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(MP_RANKS),
         str(out_dir / "store"), str(out_dir)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(MP_RANKS)]
    logs = []
    try:
        for p in procs:
            left = max(1.0, t0 + MP_JOIN_S - time.perf_counter())
            logs.append(p.communicate(timeout=left)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode:
            raise AssertionError(f"mesh rank {r} exited {p.returncode}:\n"
                                 f"{log[-4000:]}")
    wall = time.perf_counter() - t0
    with open(out_dir / "rank0.json", encoding="utf-8") as f:
        res = json.load(f)
    worst = max(d for _, d, _, _ in res["grads"])
    bad = [p for p, _, _, ok in res["grads"] if not ok]
    loss_gap = max(abs(a - b) for a, b in zip(res["losses"],
                                              res["losses_one"]))
    loss_ok = all(math.isclose(a, b, rel_tol=DENSE_OPT_TOL["rtol"],
                               abs_tol=DENSE_OPT_TOL["atol"])
                  for a, b in zip(res["losses"], res["losses_one"]))
    print(f"mesh step: {MP_RANKS} ranks ({res['backend']}) on the one card, "
          f"2 x 2 (data, model); llama3.2-1b cut to {MP_LAYERS} layers, f32 "
          f"compute, batch {MP_BATCH} x {MP_SEQ}, fsdp; placements "
          f"{res['placements']}")
    print(f"mesh step: gradients of batch 0 vs the one-process step: loss "
          f"{res['grad_loss'][0]:.7f} / {res['grad_loss'][1]:.7f}, max |d| "
          f"{worst:.3e} over {len(res['grads'])} leaves (tol rtol "
          f"{DENSE_GRAD_TOL['rtol']} atol {DENSE_GRAD_TOL['atol']}; "
          f"outside: {bad}); losses {res['losses']} vs {res['losses_one']}"
          f" (max |d| {loss_gap:.3e}, tol rtol {DENSE_OPT_TOL['rtol']}); "
          f"state after {MP_STEPS} steps max |d| {res['state_max_abs']:.3e}"
          f"; step host ms {[round(t, 1) for t in res['steps_ms']]}; "
          f"gradients {res['grads_s']:.1f} s; ranks' wall {wall:.1f} s; "
          f"{card}")
    print(f"mesh step: reshard 2 x 2 -> 4 x 1 -> 2 x 2 of "
          f"{res['reshard_leaves']} leaves bit-equal {res['reshard_bits']}, "
          f"placements restored {res['back_placements']}; "
          f"validate_elastic_resize(2x2 -> 4x1, batch {MP_BATCH}): "
          f"{res['validate_2x2_to_4x1']}")
    if bad or not loss_ok or not res["reshard_bits"] or \
            not res["back_placements"]:
        raise AssertionError(f"mesh step: gradients outside {bad}, losses "
                             f"ok {loss_ok}, reshard bits "
                             f"{res['reshard_bits']}")
    return dict(grads_max_abs=worst, loss_gap=loss_gap, wall_s=wall,
                steps_ms=res["steps_ms"])


def dryrun_start() -> list:
    """The DRYRUNS cells, each ``python -m repro_torch.launch.dryrun`` in
    a process of its own (CPU, a fake group), started now."""
    from repro_torch.kernels import _cuda
    out = _cuda.BUILD_DIR / "model_parallel" / "dryrun"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [SRC] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]), CUDA_VISIBLE_DEVICES="")
    return [(arch, shp, out, subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shp, *flags, "--out", str(out)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for arch, shp, flags in DRYRUNS]


def dryrun_finish(runs, t0) -> dict:
    """Wait for the dry runs and print each cell's per-rank bytes."""
    cells = {}
    try:
        for arch, shp, out, p in runs:
            log = p.communicate(timeout=max(1.0, t0 + DRYRUN_S
                                            - time.perf_counter()))[0]
            if p.returncode:
                raise AssertionError(f"dryrun --arch {arch} --shape {shp} "
                                     f"exited {p.returncode}:\n{log[-3000:]}")
            for mesh_name in ("16x16", "2x16x16"):
                path = out / f"{arch}__{shp}__{mesh_name}.json"
                if not path.exists():
                    continue
                with open(path, encoding="utf-8") as f:
                    rec = json.load(f)
                cells[f"{arch} {shp} {mesh_name}"] = rec
                print(f"dryrun {arch} x {shp} x {mesh_name}: ok {rec['ok']}"
                      f", run {rec['run_s']} s ({rec['run_layers']} layers, "
                      f"1 of {rec['microbatches']} microbatches run); per "
                      "rank " + ", ".join(
                          f"{k} {v / 1e9:.4f} GB"
                          for k, v in rec["per_rank_bytes"].items())
                      + f", total {rec['per_rank_total'] / 1e9:.4f} GB, "
                      f"fits 80 GB {rec['fits_card']} (CPU, fake group of "
                      "512 ranks: placements, not the card)")
    finally:
        for *_, p in runs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return cells


def model_parallel(dev, card, reset_counts, read_counts) -> dict:
    """The model_parallel phase: the dry runs start in their own
    processes; the 32k pruned prefill (the main path's launches); the
    blockwise attention's parity; the 2 x 2 mesh step and reshard; then
    the dry runs' cells."""
    t0 = time.perf_counter()
    runs = dryrun_start()
    try:
        longp = long_prefill(dev, card, reset_counts, read_counts)
        attn = attention_parity(dev, card)
        mesh = mesh_step(card)
    finally:
        cells = dryrun_finish(runs, t0)
    if len(cells) != 3 or not all(c["ok"] for c in cells.values()):
        raise AssertionError(f"dry run cells: "
                             f"{ {k: c['ok'] for k, c in cells.items()} }")
    worst = {KERNEL_OF[m]: h["max_abs"] for m, h in longp["hold"].items()}
    return dict(launches=longp.pop("launches"), long_prefill=longp,
                attention=attn, mesh=mesh, worst=worst,
                dryrun={k: c["per_rank_total"] for k, c in cells.items()})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    from repro_torch.configs import get_config
    from repro_torch.core import (Epilogue, PlanPolicy, build_plan, csr,
                                  prune_to_csr)
    from repro_torch.kernels import (_cuda, flash_attention, merge_spmm,
                                     moe_gemm, ops, rowsplit_spmm, sddmm)
    from repro_torch.models import model as M
    from repro_torch.tune.timing import INNER

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = gpu_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; python {sys.version.split()[0]}")
    execs = {"rowsplit": ops.rowsplit_execute, "merge": ops.merge_execute}
    counters = {"rowsplit": rowsplit_spmm, "merge": merge_spmm}
    by_kernel = {"rowsplit_spmm": rowsplit_spmm, "merge_spmm": merge_spmm,
                 "sddmm": sddmm, "moe_gemm": moe_gemm,
                 "flash_attention": flash_attention}

    def reset_counts():
        for mod in by_kernel.values():
            mod.LAUNCHES = 0
        for mod in (merge_spmm, rowsplit_spmm, sddmm, flash_attention,
                    moe_gemm):
            mod.LAUNCHES_BY_BODY.clear()

    def read_counts() -> dict:
        return {name: mod.LAUNCHES for name, mod in by_kernel.items()}

    # ------------------------------------------------------------ build --
    t0 = phase("build")
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        lib_path = _cuda.build(verbose=True)
    print(log.getvalue(), end="")
    print(f"library: {lib_path}")
    print_ptxas(log.getvalue())
    done("build", t0)
    if sys.argv[1:] == ["--sharded-only"]:
        # A quick check of the sharded phase alone (no kernels line).
        t0 = phase("sharded")
        shard = sharded(dev, card, reset_counts, read_counts)
        done("sharded", t0)
        print(json.dumps({k: shard[k] for k in ("launches", "worst")}))
        print(gpu_line())
        return 0
    if sys.argv[1:] == ["--model-parallel-only"]:
        # A quick check of the model_parallel phase alone (no kernels
        # line).
        t0 = phase("model_parallel")
        mp = model_parallel(dev, card, reset_counts, read_counts)
        done("model_parallel", t0)
        print(json.dumps({k: mp[k] for k in ("launches", "worst")}))
        print(gpu_line())
        return 0

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
    # The merge schedule's edges at its ranges of 1024 slots: rows of
    # 2200-4100 nonzeros, each across three or more workers (values at
    # the Llama init scale k^-0.5, so C is O(1) as on the model path); and
    # 16 rows of 40 followed by 1084 empty ones, whose one-chunk tiles
    # leave whole ranges without a live slot (their rows are epilogue(0)).
    long_rows = csr.random_csr(97, 16, 8192, nnz_per_row=(2200, 4100),
                               device=dev)
    head = csr.random_csr(98, 16, 64, nnz_per_row=40, device=dev)
    merge_edges = {
        "long_rows": csr.CSR(long_rows.row_ptr, long_rows.col_ind,
                             long_rows.vals * 8192 ** -0.5, (16, 8192)),
        "empty_tail": csr.CSR(torch.cat([head.row_ptr, head.row_ptr[-1:]
                                         .repeat(1084)]),
                              head.col_ind, head.vals, (1100, 64))}
    eps = {"none": None,
           "bias+gelu": Epilogue(bias=True, activation="gelu"),
           "relu+scale+residual": Epilogue(activation="relu", scale=0.5,
                                           residual=True)}
    sms = _cuda.sm_count(dev)
    for kname, kspec in KERNELS.items():
        method = kspec["method"]
        if method is None:                      # the SDDMM, below
            continue
        fn = execs[method]
        mod = counters[method]
        # Both SpMMs also on the 0-nnz pattern (every row is epilogue(0),
        # which the plain version computes) and on merge's schedule edges
        # (row-split: rows of 69-129 groups of 32, split in parts, and 1084
        # empty rows).
        mats = dict(matrices, **zero_nnz, **merge_edges)
        spans = idles = 0
        for mname, a in mats.items():
            plan = build_plan(a, PlanPolicy(method=method))
            m, k = a.shape
            if method == "merge":
                span, idle = schedule_facts(
                    plan.fwd, a.nnz_pad, merge_spmm.range_chunks(
                        plan.fwd["cols"].shape[1]))
                spans, idles = max(spans, span), max(idles, idle)
            for dt in (torch.float32, torch.bfloat16):
                tol = TOL[str(dt).removeprefix("torch.")]
                max_abs = max_rel = ratio = 0.0
                cases = 0
                bodies, rules = {}, set()
                for n in PARITY_N:
                    for lead in ((), (2,)):
                        rng_seed += 1
                        g = torch.Generator(device=dev).manual_seed(rng_seed)
                        b = torch.randn(lead + (k, n), generator=g,
                                        device=dev).to(dt)
                        bias = torch.randn(m, generator=g, device=dev)
                        res = torch.randn(lead + (m, n), generator=g,
                                          device=dev)
                        body = _cuda.body_for(dt, n)
                        rule = rowsplit_spmm.row_parts(
                            m, n, plan.fwd["cols"].shape[1],
                            math.prod(lead), sms) \
                            if method == "rowsplit" else None
                        rules.add(rule)
                        for ep in eps.values():
                            kw = dict(m=m, epilogue=ep)
                            if ep is not None and ep.bias:
                                kw["bias"] = bias
                            if ep is not None and ep.residual:
                                kw["residual"] = res
                            vals = a.vals.to(dt)
                            what = (f"{kname} {mname} {dt} n={n} "
                                    f"batch={lead} epilogue={ep}")
                            before = mod.LAUNCHES
                            by_body = dict(mod.LAUNCHES_BY_BODY)
                            got = fn(plan.fwd, vals, b, impl="cuda", **kw)
                            if mod.LAUNCHES - before != 1:
                                raise AssertionError(
                                    f"{what}: counted "
                                    f"{mod.LAUNCHES - before} launches, "
                                    "expected 1")
                            check_body(what, mod, by_body, body)
                            bodies[body] = bodies.get(body, 0) + 1
                            runs = {f"r={rule}" if rule else "": (
                                got, fn(plan.fwd, vals, b, impl="cuda",
                                        **kw))}
                            # Row-split also with its rows split in each
                            # other number of parts it takes.
                            for parts in (1, 2, 8) if rule else ():
                                if parts == rule:
                                    continue
                                by_body = dict(mod.LAUNCHES_BY_BODY)
                                runs[f"r={parts}"] = tuple(
                                    rowsplit_parts_call(plan.fwd, vals, b, m,
                                                        parts, kw)
                                    for _ in range(2))
                                check_body(f"{what} r={parts}", mod,
                                           by_body, body, calls=2)
                            want = fn(plan.fwd, vals, b, impl="torch", **kw)
                            torch.cuda.synchronize()
                            for tag, (x, again) in runs.items():
                                if not torch.equal(x, again):
                                    raise AssertionError(
                                        f"{what} {tag}: two calls on the "
                                        "same inputs differ")
                                if x.shape != want.shape or \
                                        x.dtype != want.dtype:
                                    raise AssertionError(
                                        f"{what} {tag}: {x.shape} {x.dtype}"
                                        f" vs {want.shape} {want.dtype}")
                                if not torch.allclose(x.float(),
                                                      want.float(), **tol):
                                    raise AssertionError(
                                        f"{kname} disagrees with its plain "
                                        f"version on {what} {tag}")
                                d = (x.float() - want.float()).abs()
                                w = want.float().abs()
                                if d.numel():
                                    max_abs = max(max_abs, d.max().item())
                                    max_rel = max(max_rel, (d / w.clamp(
                                        min=tol["atol"])).max().item())
                                    ratio = max(ratio, (d / (
                                        tol["atol"] + tol["rtol"] * w)
                                    ).max().item())
                                cases += 1
                extra = f"; bodies {bodies}, each call bit-identical to a " \
                    "second one"
                if method == "merge":
                    extra += (f"; a row spans up to {span} workers, {idle} "
                              "workers hold no live slot")
                else:
                    extra += (f"; parts r by the rule {sorted(rules)}, and "
                              "each other r of 1, 2, 8")
                print(f"parity {kname:13s} {mname:13s} {a.shape} "
                      f"{str(dt):14s} cases {cases}: max_abs {max_abs:.3e} "
                      f"max_rel {max_rel:.3e} (tol rtol {tol['rtol']} "
                      f"atol {tol['atol']}; worst |d|/(atol+rtol|want|) "
                      f"{ratio:.3f}){extra}")
                worst[kname] = max(worst[kname], max_abs)
        if method == "merge" and (spans < 3 or idles < 1):
            raise AssertionError(f"merge parity missed its schedule's edges: "
                                 f"a row across {spans} workers (want >= 3), "
                                 f"{idles} workers without a live slot")
    qm, qk = QWEN2_W2
    g = torch.Generator(device=dev).manual_seed(20)
    worst["rowsplit_spmm"] = max(worst["rowsplit_spmm"], parity_staged(
        dict(matrices, qwen2_w2_2048=prune_to_csr(
            torch.randn(qm, qk, generator=g, device=dev) * qk ** -0.5,
            KEEP)), eps, dev))
    worst["sddmm"] = parity_sddmm(dict(matrices, **zero_nnz, **merge_edges),
                                  dev)
    worst["moe_gemm"] = parity_moe(dev)
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
    # Each timed matrix's (plan meta, kernel ms, uses), for the obs phase.
    timed_calls = {name: [] for name in per_layer}
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
            if method == "merge" and mat_name == "w1":
                profile_merge_call(kern)
            extra = ""
            if method == "rowsplit":
                r = rowsplit_spmm.row_parts(m, n, fwd["cols"].shape[1], 1,
                                            _cuda.sm_count(dev))
                extra = f"r {r}"
                if r != 1:
                    r1_ms = time_ms(lambda: rowsplit_spmm.rowsplit_spmm_cuda(
                        fwd, a.vals, b3, m, parts=1))
                    extra += f" (r 1: {r1_ms:.4f} ms)"
                extra += ", "
            print(f"timing {kname:13s} {mat_name} {(m, k)} nnz {nnz} n {n}: "
                  f"kernel {k_ms:.4f} ms ({k_ms / bound:.1f}x bound), "
                  f"{extra}B rows gathered {gather_tb_s(nnz, n, 4, k_ms)}, "
                  f"plain {p_ms:.4f} ms, cuSPARSE {lib_ms:.4f} ms, bound "
                  f"{bound:.6f} ms; plan arrays read {plan_bytes} B, "
                  f"{plan_bytes - index_bytes} B beyond the CSR's index "
                  f"arrays; {card}")
            timed_calls[kname].append((plan.meta, k_ms, uses))
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
    backward = timing_backward(llama_matrix, dev, card, timed_calls)
    power_law = timing_power_law(dev, card)
    per_layer["sddmm"] = backward["sddmm"]
    per_layer["moe_gemm"] = timing_moe(dev, card)
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
    # (kernel, --spmm-method, the plans' method): rowgroup runs the
    # row-split kernel once a length bucket.
    served = serve_methods(cfg, params, prompt,
                           (("rowsplit_spmm", "auto", "rowsplit"),
                            ("merge_spmm", "merge", "merge"),
                            ("rowsplit_spmm", "rowgroup", "rowgroup")),
                           dev, card, reset_counts, read_counts)
    # Comprehensions only: a loop variable would keep a run's pruned
    # blocks alive through the later phases.
    serving = {name: sum(r["counts"][name] for r in served.values())
               for name in KERNELS}
    logits = {m: r["logits"] for m, r in served.items()}
    per_forward = served["rowgroup"]["per_forward"]
    del served
    serve_gap("logits row-split vs merge", logits["rowsplit"],
              logits["merge"])
    # One length bucket a matrix (the pruned FFN keeps a fixed share of
    # every row): rowgroup's one ELL block a matrix and its row parts are
    # row-split's, so the same bits.
    one_bucket = per_forward == 3 * cfg.num_layers
    same = torch.equal(logits["rowgroup"], logits["rowsplit"])
    serve_gap("logits rowgroup vs row-split", logits["rowgroup"],
              logits["rowsplit"])
    print(f"logits rowgroup vs row-split bit-identical: {same} (one bucket "
          f"a matrix: {one_bucket})")
    if one_bucket and not same:
        raise AssertionError("rowgroup with one bucket a matrix differs from "
                             "row-split")

    # The same small model, f32 compute, on the card (kernels) and on the
    # CPU (plain versions): the port's whole path against its reference.
    smoke_pruned_parity("llama3.2-1b", ("rowsplit", "merge", "rowgroup"),
                        dev, read_counts)
    done("serving", t0)

    # ----------------------------------------------------------- online --
    t0 = phase("online")
    served_online = online(cfg, params, prompt, logits["rowsplit"], dev,
                           card, reset_counts, read_counts)
    worst["rowsplit_spmm"] = max(worst["rowsplit_spmm"],
                                 served_online["max_abs"])
    done("online", t0)

    # ------------------------------------------------------------- tune --
    t0 = phase("tune")
    tuned = tune(cfg, params, prompt, logits, dev, card, reset_counts,
                 read_counts)
    for name, err in tuned["worst"].items():
        worst[name] = max(worst[name], err)
    del params, logits
    torch.cuda.empty_cache()
    done("tune", t0)

    # --------------------------------------------------------- training --
    t0 = phase("training")
    train = training(cfg, dev, card, reset_counts, read_counts)
    done("training", t0)

    # --------------------------------------------------- dense training --
    t0 = phase("dense training")
    dense = dense_training(dev, card, reset_counts, read_counts)
    done("dense training", t0)

    # -------------------------------------------------------- attention --
    t0 = phase("attention")
    attn = attention(dev, card, reset_counts, read_counts)
    per_layer["flash_attention"] = attn
    worst["flash_attention"] = attn["worst"]
    done("attention", t0)

    # ----------------------------------------------------------- decode --
    t0 = phase("decode")
    dec = decode(dev, card, reset_counts, read_counts)
    worst["moe_gemm"] = max(worst["moe_gemm"], dec["worst"])
    done("decode", t0)

    # ------------------------------------------------------------ archs --
    t0 = phase("archs")
    arch = archs(dev, card, reset_counts, read_counts)
    for name, err in arch["worst"].items():
        worst[name] = max(worst[name], err)
    done("archs", t0)

    # -------------------------------------------------------------- obs --
    t0 = phase("obs")
    torch.cuda.empty_cache()
    observed = observability(
        dict(timed_calls, moe_gemm=per_layer["moe_gemm"],
             flash_attention=attn), dev, card, reset_counts, read_counts)
    roof_rows = observed["roofline"]["kernels"]
    done("obs", t0)

    # --------------------------------------------------------- analysis --
    t0 = phase("analysis")
    modeled = run_analysis(lib_path, observed["roofline"]["roof_gb_s"])
    done("analysis", t0)

    # ---------------------------------------------------------- sharded --
    t0 = phase("sharded")
    shard = sharded(dev, card, reset_counts, read_counts)
    for name, err in shard["worst"].items():
        worst[name] = max(worst[name], err)
    done("sharded", t0)

    # --------------------------------------------------- model parallel --
    t0 = phase("model_parallel")
    mp = model_parallel(dev, card, reset_counts, read_counts)
    for name, err in mp["worst"].items():
        worst[name] = max(worst[name], err)
    done("model_parallel", t0)

    # ---------------------------------------------------------- summary --
    rows = []
    for kname, kspec in KERNELS.items():
        acc = per_layer[kname]
        launches = {"serving": serving[kname],
                    "online": served_online["launches"]
                    if kname == "rowsplit_spmm" else 0,
                    "tune": tuned["launches"].get(kname, 0),
                    "training": train.get(kname, 0),
                    "dense_training": dense[kname],
                    "attention": attn["launches"]
                    if kname == "flash_attention" else 0,
                    "decode": dec["launches"] if kname == "moe_gemm" else 0,
                    "archs": arch["launches"].get(kname, 0),
                    "obs": observed["serving"]["launches"][kname]
                    + (observed["online"]["launches"]
                       if kname == "rowsplit_spmm" else 0),
                    "sharded": shard["launches"].get(kname, 0),
                    "model_parallel": mp["launches"].get(kname, 0)}
        row = {
            "name": kname, "route": "cuda", "source": kspec["source"],
            "replaces": kspec["replaces"],
            "launches": sum(launches.values()),
            **{f"launches_{k}": v for k, v in launches.items()},
            "max_abs_err": worst[kname], "ms": acc["ms"],
            "plain_ms": acc["plain_ms"], "bound_ms": acc["bound_ms"],
            "bound_by": acc["bound_by"], "library_ms": acc["library_ms"],
            "roof_fraction": roof_rows[kname]["roof_fraction"],
            "roof_bound_ms": roof_rows[kname]["roof_bound_ms"],
            "launch_model": modeled[kname]}
        if kname == "merge_spmm":
            row["backward_dB"] = dict(
                backward["merge_dB"],
                roof_fraction=roof_rows["merge_dB"]["roof_fraction"],
                roof_bound_ms=roof_rows["merge_dB"]["roof_bound_ms"])
            row["power_law"] = power_law
        if kname in ("merge_spmm", "rowsplit_spmm"):
            row["long_prefill"] = mp["long_prefill"]["hold"][
                kspec["method"]]
        if kname == "rowsplit_spmm":
            row["online"] = served_online
            row["sharded"] = {k: shard[k] for k in ("llama", "power_law",
                                                    "spmd")}
        if kname in ("merge_spmm", "rowsplit_spmm"):
            row["tune"] = {k: tuned[k] for k in (
                "threshold", "threshold_accuracy", "paper_accuracy",
                "speedups", "records", "power_law", "eager_forward_ms")}
        if kname == "moe_gemm":
            row["body"] = acc["body"]
        if kname == "flash_attention":
            row["exp_limit_ms"] = acc["exp_ms"]
            row["body"] = acc["body"]
            row["sdpa_backends_ms"] = acc["sdpa_backends_ms"]
        rows.append(row)
    print("(ms, plain_ms, bound_ms, library_ms: one FFN layer's three "
          "matrices at n=128 f32 — the forward SpMM for rowsplit_spmm and "
          "merge_spmm, the values cotangent for sddmm, dB = A^T g on the "
          "transpose plan in merge_spmm's backward_dB; for moe_gemm one "
          "OLMoE-1B-7B MoE layer's three grouped GEMMs in bf16 (4096 rows, "
          "64 experts; body the one the OLMoE path runs), library torch.bmm; "
          "for flash_attention one causal "
          "call at Llama-3.2-1B's widths, batch 1 x 8192, bf16 (its body "
          "beside it), library scaled_dot_product_attention's default "
          "dispatch (each backend alone in sdpa_backends_ms, null where "
          "it declines), exp_limit_ms the softmax's exps "
          "at 16 a clock an SM; launches: the serving runs "
          f"({forwards} forwards of each of three methods: rowgroup runs "
          "row-split's kernel once a length bucket), the online run "
          "(each bucket's warm eager call, plus each graph's replays times "
          "one eager forward's launches at its bucket; a capture records "
          "its launches and runs none), the tune phase (over the paper "
          "suite, the crossover matrices and the served patterns, each "
          "timed candidate's warm call plus its timing graph's replays "
          f"times the {INNER} calls it captured, a capture running none; "
          "and two serving runs with the TuneDB), "
          "the training runs "
          f"({TRAIN_STEPS} steps of each method), the dense training "
          "phase's in-process runs (0 for all five: a dense model has no "
          "sparse leaf, and the trainer's MoE takes the batched matmul; "
          "the train CLI's subprocesses are not counted), the attention "
          "phase's "
          f"main-path run ({2 * len(FLASH_MODEL_SHAPES)} ops.flash_attention "
          f"calls), the OLMoE generate run ({GEN_LEN + 1} forwards) and "
          "the archs phase's main paths (RecurrentGemma-2B's two serving "
          "runs, 156 launches each, and the Mixtral-8x22B cut's "
          f"generate, {MIXTRAL_GEN + 1} forwards); "
          "the obs phase's traced serve_pruned run (2 forwards by "
          "row-split, 96) and traced online run (counted as the online "
          "run); the sharded phase's Llama runs (2 forwards each of rows "
          f"and cols in {SHARD_N} shards, the per-shard loop), its "
          f"{TRAIN_STEPS} training steps of each dim in {GRAD_SHARDS} "
          f"shards and its moe_groups={MOE_GROUPS} layer (the SPMD ranks' "
          "launches, their lockstep serve_online run's included, are "
          "printed, not counted); the model_parallel phase's "
          f"pruned Llama prefill of 1 x {LONG_PREFILL} tokens and its "
          f"{LONG_GEN} decode steps (long_prefill: layer 0's w1 at n = "
          f"{LONG_PREFILL} f32 by each SpMM kernel, its ms, the 2*nnz*n "
          "bound at 67 TFLOP/s and max |d| against the plain version); "
          "roof_fraction: the "
          "compulsory bytes of ms "
          "(the reference's roofline models) over ms, as a fraction of the "
          "card's measured copy-scale roof, roof_bound_ms those bytes at "
          "that roof (bound_ms takes the data sheet's 3.35 TB/s and the "
          "operations); launch_model: the analysis phase's launches, each "
          "held to its launch model (grid, block, shared memory; "
          "registers from the profiler and cuobjdump), the bytes the model "
          "says it requests, their ratio to the call's compulsory bytes and "
          "their rate over its CUDA-event ms (launches made to hold the "
          "models are counted in no launches_* field); "
          "max_abs_err: worst parity case, forward, gradient, the online "
          "buckets' widths, the MoE layers (OLMoE's and the Mixtral "
          "cut's), RecurrentGemma-2B's served plans and the attention "
          "layers, each against its plain version)")
    print(json.dumps({"kernels": rows}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
