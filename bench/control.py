"""The correctness check's control, read on the card at a cell's own size.

    python3 bench/control.py --workload granite-3-2b.score-online \
        --seeds 11,12,13 [--points f32]

For each seed: the cell's weights and the requests a run would compare
(the same tape, the same sample), scored by its architecture's reference
and by that reference one precision step lower
(``reference.score(control=True)``), which stands in the program's
place; with ``--points f32`` only the points the configuration states in
float32 are lowered (to bfloat16).
Prints one JSON line a seed with the compared numbers; the full control
has to fail the cell's limits.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control_numbers(cells, name: str, seed: int, seconds: float,
                    device: str, points: str = "all") -> dict:
    """The compared numbers of the control against the reference."""
    import torch

    import check
    import harness
    import loadgen

    cell = cells.workload(name)
    cfg = cells.config(cell["config"])
    arch = cells.arch(cfg)
    traffic = cells.traffic(cell["traffic"])
    if traffic["loop"] == "open":
        tape = loadgen.open_tape(traffic, seconds, seed)
    else:
        tape = loadgen.ClosedTape(traffic, seed)
    picked = harness.sample(traffic, tape, seed)
    prompts = [torch.from_numpy(loadgen.request_tokens(
        seed, r.index, r.length, cfg["vocab_size"])).to(device)
        for r in picked]
    w = arch.weights.make(cfg, seed, device)
    ref = arch.reference.score(w, cfg, prompts)
    worst = check.Worst()
    arch.reference.score(w, cfg, prompts,
                         control="f32" if points == "f32" else True,
                         on_logits=lambda i, lg: worst.add(lg, ref[i]))
    ok, compared = check.verdict(worst, cfg["limits"], missing=0)
    return {"workload": name, "seed": seed, "points": points, "passes": ok,
            "compared": compared}


def main(argv=None) -> int:
    sys.path.insert(0, str(ROOT / "src"))
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--points", choices=("all", "f32"), default="all",
                    help="lower every stated precision, or the float32 "
                    "points alone")
    args = ap.parse_args(argv)

    import torch

    import harness

    if not torch.cuda.is_available():
        print("control: torch sees no CUDA device", file=sys.stderr)
        return 2
    cells = harness.Cells(ROOT)
    seconds = cells.spec["run_seconds"]
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(control_numbers(cells, args.workload, seed,
                                         seconds, "cuda", args.points)),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
