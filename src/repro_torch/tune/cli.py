"""``python -m repro_torch.tune``: build or extend a TuneDB over a corpus.

    # tune the paper suite on the card and write the database
    python -m repro_torch.tune --suite paper --out tune.json

    # smoke: 3 matrices, short timing budget, on the CPU
    python -m repro_torch.tune --suite mini --out /tmp/t.json \
        --device cpu --warmup 1 --repeat 2

    # fold a directory of .mtx files into an existing DB
    python -m repro_torch.tune --mtx-dir ./suitesparse --out tune.json

The JSON is read back by ``repro_torch.engine.load_tunedb`` (``--tunedb``
on the serve launcher): "auto" plans then resolve their kernel method from
these measurements instead of the paper's K40c threshold.  A DB is keyed
to the device it was timed on and to what was timed
(``tune.db.backend_key``): ``--impl torch`` on a card writes the plain
versions' timings under their own key, which the card's launchers never
load as the kernels'.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.matrices.suites import (get_suite, specs_from_mtx_dir,
                                         suite_names)

from .autotune import tune_suite
from .db import TuneDB, backend_key


def _report(db: TuneDB) -> None:
    print(f"# TuneDB backend={db.backend} entries={len(db)}")
    print("name,m,k,d,cv,method,merge_us,rowsplit_us,speedup,timings")
    for rec in sorted(db.entries.values(), key=lambda r: r.name):
        lo, hi = sorted((rec.merge_us, rec.rowsplit_us))
        extras = ";".join(f"{m}={us:.1f}" for m, us in
                          sorted((rec.timings or {}).items()))
        print(f"{rec.name or '?'},{rec.m},{rec.k},{rec.d:.2f},"
              f"{rec.cv:.2f},{rec.method},{rec.merge_us:.1f},"
              f"{rec.rowsplit_us:.1f},{hi / max(lo, 1e-9):.2f}x,{extras}")
    if db.threshold is not None:
        print(f"# calibrated_threshold={db.threshold:.3f} "
              f"accuracy={db.threshold_accuracy * 100:.1f}%")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tune",
        description="empirically autotune the SpMM methods over a matrix "
                    "corpus and persist the winners in a TuneDB")
    ap.add_argument("--suite", choices=suite_names(), default=None,
                    help="named corpus suite (repro_torch.matrices.suites)")
    ap.add_argument("--mtx-dir", default=None,
                    help="directory of .mtx files to tune as well")
    ap.add_argument("--out", required=True, help="TuneDB JSON path "
                    "(loaded and extended if it exists)")
    ap.add_argument("--n", type=int, default=64,
                    help="dense B columns for timing (paper: n in 32-128)")
    ap.add_argument("--impl", default=None, choices=["cuda", "torch"],
                    help="what to time: the CUDA kernels or their plain "
                    "versions (default: by device)")
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--repeat", type=int, default=5)
    ap.add_argument("--wide", action="store_true",
                    help="also sweep l_pad/t candidates per method")
    ap.add_argument("--refresh", action="store_true",
                    help="re-time patterns already in the DB")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' times the "
                    "kernels' plain versions)")
    args = ap.parse_args(argv)

    if args.suite is None and args.mtx_dir is None:
        ap.error("nothing to tune: pass --suite and/or --mtx-dir")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda, but torch sees no CUDA device; "
                         "pass --device cpu to time the plain versions")

    specs = list(get_suite(args.suite)) if args.suite else []
    if args.mtx_dir:
        specs += specs_from_mtx_dir(args.mtx_dir)

    backend = backend_key(device, args.impl)
    try:
        # strict: a corrupt or backend/schema-mismatched existing DB must
        # error out, not degrade to empty and then be overwritten by
        # db.save() — launchers degrade gracefully, the builder does not.
        db = TuneDB.load(args.out, backend=backend, strict=True)
        print(f"# extending {args.out} ({len(db)} entries)")
    except FileNotFoundError:
        db = TuneDB(backend=backend)
        print(f"# new TuneDB for backend {backend}")
    except ValueError as e:
        ap.error(f"refusing to overwrite {args.out}: {e} "
                 "(move the file aside, or point --out elsewhere)")

    tune_suite(specs, db, n=args.n, impl=args.impl, warmup=args.warmup,
               repeat=args.repeat, wide=args.wide, refresh=args.refresh,
               device=device, log=lambda s: print(f"# {s}"))
    db.save(args.out)
    _report(db)
    print(f"# wrote {args.out}")
    return 0
