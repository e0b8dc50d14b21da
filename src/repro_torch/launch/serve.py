"""Serving entry point: prefill + batched greedy decode, pruned-FFN
prefill scoring through the SpMM engine, or online serving of ragged
requests over shape-bucket programs.

    python -m repro_torch.launch.serve --arch olmoe-1b-7b --gen 16
    python -m repro_torch.launch.serve --arch mamba2-1.3b --gen 16
    python -m repro_torch.launch.serve --arch recurrentgemma-2b \
        --prune-ffn 0.25
    python -m repro_torch.launch.serve --arch granite-4.0-h-micro \
        --prune-ffn 0.25 --serve
    python -m repro_torch.launch.serve --arch olmoe-1b-7b --smoke --gen 4 \
        --device cpu
    python -m repro_torch.launch.serve --prune-ffn 0.25
    python -m repro_torch.launch.serve --prune-ffn 0.25 --spmm-method merge
    python -m repro_torch.launch.serve --prune-ffn 0.25 --tunedb tune.json
    python -m repro_torch.launch.serve --prune-ffn 0.25 --microbatch 2
    python -m repro_torch.launch.serve --prune-ffn 0.25 --serve
    python -m repro_torch.launch.serve --smoke --prune-ffn 0.25 --device cpu
    torchrun --nproc-per-node 2 -m repro_torch.launch.serve \
        --prune-ffn 0.25 --mesh 2
    torchrun --nproc-per-node 2 -m repro_torch.launch.serve \
        --prune-ffn 0.25 --serve --mesh 2

Without ``--prune-ffn``, ``generate`` prefills the prompt into caches (KV
for attention, the recurrent state of SSD and RG-LRU blocks) and decodes
``--gen`` tokens greedily; MoE blocks run their expert FFNs through the
grouped GEMM kernel on the card.  The CLI drives token models; the
embeddings-input archs (MusicGen, InternVL2) run ``steps.make_prefill_step``
/ ``make_decode_step`` on a batch of ``embeds``.  With ``--prune-ffn``, every
FFN matrix is magnitude-pruned to CSR once, its plan built once through
the engine cache, and the forward then runs every FFN matmul as a planned
SpMM — the hand-written CUDA kernels on the card, their plain versions on
the CPU.  ``--serve`` serves a Poisson stream of ragged requests through
``repro_torch.serving.Server``: one program a ``(batch, length)`` bucket,
a CUDA graph on the card, all built at warmup.  ``--tunedb`` loads a TuneDB
(``python -m repro_torch.tune``) before the pruned-FFN plans are built, so
"auto" plans resolve their method from its measurements.
``--trace-out PATH`` turns tracing on (``repro_torch.obs``) and writes the
run's Chrome trace there; ``--metrics-out PATH`` dumps the metrics
registry (``python -m repro_torch.obs.validate`` checks both).
``--mesh N`` shards every pruned-FFN weight by rows over an N-rank
``data`` mesh (``torchrun --nproc-per-node N``; one rank a shard, ranks
sharing a card talk over gloo); only rank 0 prints.  With ``--serve``
every rank runs the server in lockstep (``serving.Lockstep``): rank 0
admits, batches and broadcasts each bucket batch, every rank runs it, and
their forwards all-reduce the sharded SpMMs' rows; the buckets are eager
programs there (no capture holds a gloo collective), retries are off,
and a failed bucket ends every rank's run non-zero.  ``--mesh 1`` in one
process runs the per-shard loop, with CUDA graphs on the card.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import engine, obs
from repro_torch.configs import (ARCHS, PORT_ARCHS, get_config,
                                 get_smoke_config)
from repro_torch.core import PlanPolicy, ShardSpec
from repro_torch.core.config import resolve_counts
from repro_torch.engine import cache_stats
from repro_torch.kernels import registry
from repro_torch.launch import mesh as launch_mesh
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import sparse as S
from repro_torch.runtime import steps as R

# blocks that own a dense "mlp"
_PRUNABLE_BTYPES = ("attn", "rglru", "ssd_mlp")

# Per-phase serving latency: "plan" (prune + plan build), "cold" (first
# forward), "warm" (steady state), "generate" (a whole greedy decode).
_serve_latency = obs.registry.histogram(
    "serve_latency_us", "serve.py phase latency", labels=("phase",))
_serve_replans = obs.registry.counter(
    "serve_replans_total",
    "plans built inside the serving forward (must stay 0)")


def _check_replans(before, after) -> int:
    """Count plan-cache misses between two ``cache_stats()`` snapshots and
    fail loudly if the serving forward built any (a real check, not an
    ``assert``, which ``python -O`` strips).  The count lands on
    ``serve_replans_total`` either way."""
    replans = after.misses - before.misses
    if replans:
        _serve_replans.inc(replans)
        raise RuntimeError(
            f"serving replanned: {replans} plan(s) built during the "
            f"forward (cache misses {before.misses} -> {after.misses}). "
            "Plans must be attached before serving — build the sparse "
            "params with prune_ffn_blocks first.")
    return replans


def generate(cfg, params, prompt_tokens, gen_len: int, *, cache_extra=8,
             times: list | None = None):
    """Greedy decode.  prompt_tokens (b, s) → (b, s + gen_len), in the
    prompt's dtype.

    One prefill into caches of ``s + gen_len + cache_extra`` positions,
    then ``gen_len`` decode steps, each feeding back the argmax of the last
    logits.  When ``times`` is a list, each forward (the prefill first) is
    synchronised and its host-clock milliseconds appended to it.
    """
    b, s = prompt_tokens.shape
    prefill = R.make_prefill_step(cfg, cache_len=s + gen_len + cache_extra)
    decode = R.make_decode_step(cfg)
    device = prompt_tokens.device

    def timed(fn, *args):
        if times is None:
            return fn(*args)
        t0 = time.perf_counter()
        out = fn(*args)
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
        return out

    with torch.no_grad():
        out = timed(prefill, params, {"tokens": prompt_tokens})
        caches, logits, pos = out["caches"], out["logits"], out["pos"]
        toks = [prompt_tokens]
        cur = logits[:, -1].argmax(-1).to(prompt_tokens.dtype)[:, None]
        for _ in range(gen_len):
            toks.append(cur)
            logits, caches = timed(decode, params, caches, {"tokens": cur},
                                   pos)
            cur = logits[:, -1].argmax(-1).to(prompt_tokens.dtype)[:, None]
            pos = pos + 1
    return torch.cat(toks, dim=1)


def check_prunable(cfg):
    btypes = set(cfg.block_types())
    unsupported = btypes - set(_PRUNABLE_BTYPES)
    if unsupported:
        raise SystemExit(
            f"--prune-ffn needs every block to own a dense MLP "
            f"(btypes {_PRUNABLE_BTYPES}); arch has {sorted(unsupported)} "
            "blocks (MoE experts / SSD cores have no per-block dense FFN "
            "to prune)")


def prune_ffn_blocks(params, cfg, keep: float, policy=None) -> list:
    """Each layer's params with its MLP pruned (on the weights' device)
    and planned through the engine cache; ``policy`` pins the plan
    request, e.g. a forced kernel method from ``--spmm-method``.  Serving
    runs forward only, so the plans leave out the transpose (CSC) plan of
    the backward."""
    policy = dataclasses.replace(policy or PlanPolicy(),
                                 with_transpose=False)
    return [dict(lp, mlp=S.prune_mlp(lp["mlp"], keep, policy=policy))
            for lp in params["blocks"]]


def make_pruned_forward(cfg):
    """Full forward with SparseLinear MLPs: tokens (b, s) → f32 logits
    (b, s, vocab).  Routes through ``model.block_apply``, so only
    ``mlp_apply`` differs from the dense model.  The logits are
    ``h.float() @ embed.T.float()``, a plain float32 matmul (TF32 off),
    divided by ``cfg.logits_scaling`` where that is set."""
    btypes = cfg.block_types()
    scaling = cfg.logits_scaling

    def fwd(params, blocks, tokens):
        h = M.embed_inputs(params, cfg, {"tokens": tokens})
        for btype, lp in zip(btypes, blocks):
            h, _, _ = M.block_apply(lp, btype, h, cfg)
        h = L.norm_apply(params["final_norm"], h, cfg.norm, eps=cfg.norm_eps)
        logits = h.float() @ M.unembed_matrix(params, cfg).T.float()
        return logits if scaling == 1.0 else logits / scaling

    return fwd


@dataclasses.dataclass
class ServeReport:
    """What one ``serve_pruned`` run measured (host clock, synchronised)."""

    logits: torch.Tensor
    methods: dict
    plan_s: float
    cold_s: float
    warm_s: float
    tok_per_s: float
    replans: int


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_pruned(cfg, params, prompt, keep: float, *, microbatch: int = 0,
                 policy=None) -> ServeReport:
    """Prune + plan every FFN, then score ``prompt`` twice (cold, warm);
    raises if the forward built a plan.  ``microbatch`` > 0 scores the
    prompt rows in fixed-size slices (``steps.microbatched``): one shape
    of every kernel launch serves any batch, its batch axis folded into
    the SpMM launches."""
    check_prunable(cfg)
    device = prompt.device
    _sync(device)
    t0 = time.perf_counter()
    with obs.span("serve.plan", cat="serve", keep=keep):
        blocks = prune_ffn_blocks(params, cfg, keep, policy=policy)
        _sync(device)
    t_plan = time.perf_counter() - t0
    _serve_latency.labels(phase="plan").observe(t_plan * 1e6)
    stats = cache_stats()
    methods = {k: v.method for k, v in blocks[0]["mlp"].items()}
    print(f"[serve] pruned {len(blocks)} MLPs (keep={keep:.0%}) "
          f"in {t_plan:.2f}s; methods={methods}; "
          f"plan cache: {stats.misses} built, {stats.hits} reused")
    fwd = make_pruned_forward(cfg)
    if microbatch:
        fwd = R.microbatched(fwd, microbatch, argnums=(2,))
    with torch.no_grad():
        t1 = time.perf_counter()
        with obs.span("serve.forward_cold", cat="serve"):
            fwd(params, blocks, prompt)
            _sync(device)
        t_cold = time.perf_counter() - t1
        _serve_latency.labels(phase="cold").observe(t_cold * 1e6)
        t2 = time.perf_counter()
        with obs.span("serve.forward_warm", cat="serve"):
            logits = fwd(params, blocks, prompt)
            _sync(device)
        t_warm = time.perf_counter() - t2
        _serve_latency.labels(phase="warm").observe(t_warm * 1e6)
    replans = _check_replans(stats, cache_stats())
    tok_s = prompt.numel() / t_warm
    mb = f" (microbatch={microbatch})" if microbatch else ""
    print(f"[serve] cold forward {t_cold * 1e3:.1f}ms; warm pruned "
          f"forward{mb} {t_warm * 1e3:.1f}ms ({tok_s:.0f} tok/s); plans "
          f"built during serving: {replans}")
    return ServeReport(logits, methods, t_plan, t_cold, t_warm, tok_s,
                       replans)


@dataclasses.dataclass
class OnlineReport:
    """What one ``serve_online`` run measured (host clock).  ``forwards``
    and ``ran`` are the server's (``serving.Server``): the program calls
    that returned on this rank and their buckets in order.  On a follower
    of a mesh ``load`` is None and ``rate_rps`` 0."""

    load: object                  # serving.loadgen.LoadReport
    server: object                # the stopped serving.Server
    warmup_s: float
    rate_rps: float
    replans: int
    recompiles: int
    programs: int = 0
    forwards: int = 0
    ran: list = dataclasses.field(default_factory=list)


def serve_online(cfg, params, keep: float, *, batch: int, prompt_len: int,
                 requests: int, rate: float = 0.0, deadline_ms: float = 0.0,
                 queue_depth: int = 64, seed: int = 0,
                 policy=None, keep_served: bool = False) -> OnlineReport:
    """``--serve``: online continuous batching over the pruned-FFN forward.

    Ragged Poisson arrivals pack into ``(batch, length)`` bucket programs
    (``repro_torch.serving``; a CUDA graph each on the card) built at
    warmup, lengths from 8 (or ``prompt_len``) doubling to ``prompt_len``,
    batches from 1 doubling to ``batch``.  ``rate`` 0 offers 4 requests in
    the time of one solo call at the longest bucket.  After warmup the run
    must neither replan nor build a program: both raise.
    ``keep_served`` keeps the served requests' tokens and futures in
    ``load.served``.

    Under a process group of several ranks with a ``policy`` sharded over
    a mesh, every rank calls this with the same params and policy: rank 0
    serves the load and the others follow it in lockstep
    (``serving.Lockstep``, over a gloo group of its own), each rank
    checking its own replans and recompiles.
    """
    from repro_torch import serving
    from repro_torch.engine import GraphProgram
    from repro_torch.serving import loadgen

    check_prunable(cfg)
    with obs.span("serve.plan", cat="serve", keep=keep):
        blocks = prune_ffn_blocks(params, cfg, keep, policy=policy)
    base = make_pruned_forward(cfg)

    def forward(state, tokens):
        p, blk = state
        return base(p, blk, tokens)

    ladder = serving.BucketLadder.from_max(
        prompt_len, max(batch, 1), min_len=min(8, prompt_len))
    shards = policy.shards if policy is not None else None
    group = (launch_mesh.control_group() if shards is not None
             and shards.mesh is not None and launch_mesh.world_size() > 1
             else None)
    lockstep = serving.Lockstep(group, ladder) if group is not None else None
    try:
        server = serving.Server(
            forward, (params, blocks), ladder, queue_depth=queue_depth,
            default_deadline_s=deadline_ms / 1e3 if deadline_ms else None,
            name="serve.online", lockstep=lockstep)
        t0 = time.perf_counter()
        server.warmup()
        warm_s = time.perf_counter() - t0
        graphs = isinstance(server.program(*ladder.shapes()[0]),
                            GraphProgram)
        kind = "CUDA graphs" if graphs else "eager"
        if lockstep is not None:
            kind += (f"; lockstep over {lockstep.world} ranks, "
                     f"{torch.distributed.get_backend()} collectives")
        print(f"[serve] built {len(ladder.shapes())} bucket programs "
              f"(lengths={ladder.lengths} batches={ladder.batches}; "
              f"{kind}) in {warm_s:.2f}s")
        plan_stats = cache_stats()
        load = None
        if lockstep is not None and not lockstep.leads:
            rate = 0.0
            server.follow()
        else:
            if rate <= 0:
                solo = min(server.probe(ladder.batches[0], ladder.max_len)
                           for _ in range(3))
                rate = 4.0 / solo
                print(f"[serve] auto rate: solo call {solo * 1e3:.2f}ms -> "
                      f"offered {rate:.1f} req/s")
            sched = loadgen.poisson_schedule(
                requests, rate, (max(1, prompt_len // 4), prompt_len),
                seed=seed)
            server.start()
            try:
                load = loadgen.run_load(server, sched, vocab=cfg.vocab_size,
                                        seed=seed, keep=keep_served)
            finally:
                server.stop()
        replans = _check_replans(plan_stats, cache_stats())
        rc = server.recompiles()
        if rc:
            raise RuntimeError(
                f"online serving built {rc} program(s) after warmup -- the "
                "bucket ladder must cover every served shape")
    finally:
        if group is not None:
            torch.distributed.destroy_process_group(group)
    if load is None:
        print(f"[serve] rank {lockstep.rank} followed: "
              f"{server.forwards} bucket runs; "
              f"recompiles after warmup: {rc}; plans built during "
              f"serving: {replans}")
    else:
        print(f"[serve] online: {load.ok}/{load.n} ok ({load.shed} shed, "
              f"{load.error} error) in {load.wall_s:.2f}s = "
              f"{load.throughput_rps:.1f} req/s; p50 "
              f"{load.p50_us / 1e3:.2f}ms p99 {load.p99_us / 1e3:.2f}ms; "
              f"recompiles after warmup: {rc}; plans built during "
              f"serving: {replans}")
    return OnlineReport(load, server, warm_s, rate, replans, rc,
                        programs=len(server.programs),
                        forwards=server.forwards, ran=list(server.ran))


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="greedy decode, pruned-FFN scoring through the SpMM "
        "engine, or online serving of ragged requests")
    ap.add_argument("--arch", choices=ARCHS + PORT_ARCHS,
                    default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prune-ffn", type=float, default=0.0, metavar="KEEP",
                    help="serve with magnitude-pruned FFNs (CSR SpMM via "
                    "the plan engine); KEEP is the kept fraction per row")
    ap.add_argument("--spmm-method", default="auto",
                    choices=("auto",) + registry.method_names(),
                    help="force the SpMM kernel method of the pruned-FFN "
                    "plans ('auto': the TuneDB ladder with --tunedb, else "
                    "the paper's §5.4 rule)")
    ap.add_argument("--tunedb", default="", metavar="PATH",
                    help="TuneDB JSON (python -m repro_torch.tune) of this "
                    "device: 'auto' pruned-FFN plans resolve their method "
                    "from its measurements instead of the paper's fixed "
                    "threshold")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the "
                    "kernels' plain versions)")
    ap.add_argument("--microbatch", type=int, default=0, metavar="MB",
                    help="score pruned-FFN requests in fixed-size "
                    "microbatches (a ragged tail is padded): one shape of "
                    "every launch, the batch axis folded into the SpMM "
                    "launches")
    ap.add_argument("--serve", action="store_true",
                    help="online mode: continuous batching of ragged "
                    "Poisson requests over shape-bucket programs (CUDA "
                    "graphs on the card; requires --prune-ffn); --batch and "
                    "--prompt-len bound the bucket ladder")
    ap.add_argument("--serve-requests", type=int, default=24, metavar="N",
                    help="requests in the Poisson load")
    ap.add_argument("--serve-rate", type=float, default=0.0, metavar="RPS",
                    help="offered load (0 = auto: 4x the measured solo-call "
                    "capacity)")
    ap.add_argument("--serve-deadline-ms", type=float, default=0.0,
                    metavar="MS", help="per-request deadline; expired "
                    "requests are shed, not served (0 = none)")
    ap.add_argument("--serve-queue-depth", type=int, default=64, metavar="N",
                    help="admission queue bound; submits beyond it are shed "
                    "at once")
    ap.add_argument("--trace-out", default="", metavar="PATH",
                    help="enable structured tracing and write the Chrome "
                    "trace-event JSON (Perfetto-viewable) here on exit "
                    "(REPRO_TRACE=1 enables tracing without a file)")
    ap.add_argument("--metrics-out", default="", metavar="PATH",
                    help="write a JSON snapshot of the metrics registry "
                    "(latency histograms, plan-cache counters, ladder rung "
                    "rates, serving and program-cache counters) here on "
                    "exit")
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="shard every pruned-FFN weight over an N-rank data "
                    "mesh: nnz-balanced row shards, one local plan a "
                    "shard, each rank running its own shard (run under "
                    "torchrun --nproc-per-node N; N = 1 in one process "
                    "runs the per-shard loop); with --serve every rank "
                    "runs the server in lockstep, rank 0 admitting and "
                    "broadcasting each bucket batch")
    ap.add_argument("--logits-out", default="", metavar="PATH",
                    help="save the pruned-FFN logits here (torch.save, on "
                    "the CPU; rank 0)")
    args = ap.parse_args(argv)
    if args.prune_ffn <= 0.0:
        # These flags only shape the pruned-FFN path; silently ignoring
        # them hides typos like a forgotten --prune-ffn.
        dead = [fl for fl, on in (
            ("--serve", args.serve),
            ("--microbatch", args.microbatch != 0),
            ("--spmm-method", args.spmm_method != "auto"),
            ("--tunedb", bool(args.tunedb)),
            ("--mesh", args.mesh != 0),
            ("--logits-out", bool(args.logits_out)),
        ) if on]
        if dead:
            ap.error(f"{', '.join(dead)}: no effect without --prune-ffn "
                     "KEEP (the dense decode path ignores these flags); add "
                     "--prune-ffn or drop them")
    if args.mesh < 0:
        ap.error(f"--mesh {args.mesh}: a rank count is positive")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda, but torch sees no CUDA device; "
                         "pass --device cpu to run the plain versions")
    own_group = not torch.distributed.is_initialized()
    try:
        shard_mesh = _data_mesh(args.mesh, device) if args.mesh else None
        with launch_mesh.rank0_prints():
            return _run(args, device, shard_mesh)
    finally:
        if own_group:       # the group torchrun's environment started here
            launch_mesh.shutdown()


def _data_mesh(n: int, device: torch.device):
    """The ``("data",)`` mesh of ``n`` ranks for ``--mesh n``: the
    process group ``torchrun`` describes, or this one process."""
    launch_mesh.init_from_env(device.type)
    world = launch_mesh.world_size()
    if n > world:
        raise SystemExit(
            f"--mesh {n} exceeds the {world} local device(s) (ranks of "
            f"this process group); run it as torchrun --nproc-per-node {n} "
            f"-m repro_torch.launch.serve ... --mesh {n}")
    if n < world:
        raise SystemExit(
            f"--mesh {n} uses {n} of the {world} ranks torchrun started; "
            f"start {n} (torchrun --nproc-per-node {n})")
    if world == 1:
        return launch_mesh.make_local_mesh(device_type=device.type)
    mesh = launch_mesh.make_mesh((n,), ("data",), device.type)
    print(f"[serve] rank {launch_mesh.rank()} of {world}: "
          f"{torch.distributed.get_backend()} collectives")
    return mesh


def _run(args, device: torch.device, shard_mesh) -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.trace_out:
        obs.enable()
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.input_mode != "tokens":
        raise SystemExit(
            f"--arch {args.arch}: serve.py drives token models; "
            "embeddings-mode archs use the prefill/decode steps directly "
            "(repro_torch.runtime.steps)")
    if args.prune_ffn > 0.0:
        check_prunable(cfg)
    params = M.init_params(cfg, args.seed, device)
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, device=device)
    if args.prune_ffn > 0.0:
        if args.tunedb:
            from repro_torch.tune import backend_key
            db = engine.load_tunedb(args.tunedb, backend=backend_key(device))
            print(f"[serve] tunedb {args.tunedb}: backend={db.backend} "
                  f"entries={len(db)} threshold={db.threshold}")
            resolved = resolve_counts()
        policy = PlanPolicy(method=args.spmm_method)
        if shard_mesh is not None:
            policy = dataclasses.replace(
                policy, shards=ShardSpec(mesh=shard_mesh, axis="data"))
            print(f"[serve] sharding pruned-FFN plans over {args.mesh} "
                  "rank(s) (nnz-balanced row shards)")
        if args.serve:
            serve_online(cfg, params, args.prune_ffn, batch=args.batch,
                         prompt_len=args.prompt_len,
                         requests=args.serve_requests, rate=args.serve_rate,
                         deadline_ms=args.serve_deadline_ms,
                         queue_depth=args.serve_queue_depth, seed=args.seed,
                         policy=policy)
        else:
            rep = serve_pruned(cfg, params, prompt, args.prune_ffn,
                               microbatch=args.microbatch, policy=policy)
            print(f"pruned-FFN logits {tuple(rep.logits.shape)}; "
                  f"argmax@last {rep.logits[:, -1].argmax(-1).tolist()}")
            if args.logits_out and launch_mesh.rank() == 0:
                torch.save(rep.logits.cpu(), args.logits_out)
                print(f"[serve] logits: {args.logits_out}")
        if args.tunedb:
            rungs = {f"{rung}/{method}": n for (rung, method), n in
                     resolve_counts(since=resolved).items()}
            print(f"[serve] plan_resolve_total of this run: {rungs}")
        _export_obs(args)
        return 0
    _sync(device)
    t0 = time.perf_counter()
    with obs.span("serve.generate", cat="serve", gen=args.gen):
        out = generate(cfg, params, prompt, args.gen)
        _sync(device)
    dt = time.perf_counter() - t0
    _serve_latency.labels(phase="generate").observe(dt * 1e6)
    print(f"generated {tuple(out.shape)} in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s)")
    print(out[0, -args.gen:].tolist())
    _export_obs(args)
    return 0


def _export_obs(args) -> None:
    if args.trace_out:
        tr = obs.get_tracer()
        print(f"[serve] trace: {tr.export(args.trace_out)} "
              f"({len(tr)} events)")
    if args.metrics_out:
        print(f"[serve] metrics: {obs.dump_metrics(args.metrics_out)}")


if __name__ == "__main__":
    raise SystemExit(main())
