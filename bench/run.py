"""Run one cell of the benchmark and print its result line.

    python3 bench/run.py --workload granite-3-2b.score-online \
        --seed 1234 --seconds 51 --trace 0

Run from the root of a checkout on a machine with the cards the cell asks
for.  The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``compared``: each number the correctness check
compared, beside its limit.  The compared numbers are also the last lines
of standard error.  Exits non-zero, with no result line, without the
cards, or where the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Every cache the program or its libraries keep lives at a fixed path in
# the checkout, so only the first run there builds.
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "bench" / ".cache" / "triton")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path.insert(0, str(ROOT / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    import harness

    cells = harness.Cells(ROOT)
    cell = cells.workload(args.workload)
    if not torch.cuda.is_available():
        print("bench: torch sees no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"bench: {args.workload} needs {cell['chips']} cards, torch "
              f"sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    result = harness.run_cell(cells, args.workload, seed=args.seed,
                              seconds=args.seconds, trace=bool(args.trace),
                              device="cuda", t_start=T_START)
    bad = harness.loaded_forbidden()
    if bad:
        print(f"bench: the process loaded {bad}", file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
