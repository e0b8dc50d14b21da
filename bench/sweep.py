"""The knee sweep of an open-loop cell: the highest offered rate at which
completions keep up and the backlog does not grow over the window.

    python3 bench/sweep.py --workload granite-3-2b.score-online \
        --rates 5,10,15,20,25,30 --seconds 12 --seed 7

Builds the cell's server once, then offers each rate for one window (the
cell's traffic at that rate, the next window only once every request of
the last has resolved).  A rate keeps up when every request due in the
window is answered by its close plus ``--grace`` seconds, and the median
latency of the window's last third is at most ``--growth`` times that of
its first third: a queue that grows over the window reads higher at its
end, while ``--growth`` above 1 leaves room for where one seed's bursts
fall.  Prints one JSON line a rate and, last, the knee.
"""
import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def window_row(client, rate: float, grace: float) -> dict:
    import loadgen

    outs = client.outcomes
    now = time.perf_counter()
    late = [o for o in outs if not o.ok or o.done > client.t_close + grace]
    third = max(1, len(outs) // 3)
    first = [o.done - o.due for o in outs[:third] if o.ok]
    last = [o.done - o.due for o in outs[-third:] if o.ok]
    done = loadgen.completed_in_window(outs, client.t_open, client.t_close)
    return {
        "rate_rps": rate, "requests": len(outs),
        "completed_in_window": len(done),
        "tokens_per_s": sum(o.length for o in done) /
        (client.t_close - client.t_open),
        "unanswered_by_close_plus_grace": len(late),
        "p50_ms": 1e3 * loadgen.latency_quantile(outs, 0.5, now),
        "p95_ms": 1e3 * loadgen.latency_quantile(outs, 0.95, now),
        "first_third_p50_ms": 1e3 * statistics.median(first) if first
        else None,
        "last_third_p50_ms": 1e3 * statistics.median(last) if last else None,
    }


def main(argv=None) -> int:
    sys.path.insert(0, str(ROOT / "src"))
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=12.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--grace", type=float, default=2.0)
    ap.add_argument("--growth", type=float, default=1.25)
    args = ap.parse_args(argv)

    import torch

    import harness
    import loadgen
    import system

    if not torch.cuda.is_available():
        print("sweep: torch sees no CUDA device", file=sys.stderr)
        return 2
    cells = harness.Cells(ROOT)
    cell = cells.workload(args.workload)
    cfg = cells.config(cell["config"])
    arch = cells.arch(cfg)
    traffic = cells.traffic(cell["traffic"])
    if traffic["loop"] != "open":
        raise SystemExit("sweep: the knee is an open loop's")
    server = arch.system.build(cfg, arch.weights.make(cfg, args.seed, "cuda"),
                               traffic)
    server.start()
    knee = None
    try:
        for i, rate in enumerate(float(r) for r in args.rates.split(",")):
            mix = dict(traffic, rate_rps=rate)
            tape = loadgen.open_tape(mix, args.seconds, args.seed + i)
            client = loadgen.Client(server, vocab=cfg["vocab_size"],
                                    seed=args.seed + i)
            client.run_open(tape, args.seconds)
            client.drain(120.0)
            row = window_row(client, rate, args.grace)
            keeps = (row["unanswered_by_close_plus_grace"] == 0
                     and row["last_third_p50_ms"] is not None
                     and row["last_third_p50_ms"] <=
                     args.growth * row["first_third_p50_ms"])
            row["keeps_up"] = keeps
            print(json.dumps(row), flush=True)
            if keeps:
                knee = rate
            else:
                break
    finally:
        system.release(server)
    print(json.dumps({"workload": args.workload, "knee_rps": knee,
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
