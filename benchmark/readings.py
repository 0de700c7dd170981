"""The readings that the limits of `correct` are set from, for one cell and
many seeds in one process (set-up is most of a run):

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,3
        [--seconds 1] [--modes program,control,half_batch]

`program` is the run's own fits against the reference; `control` the
reference in TF32 in the program's place; `half_batch` the reference with
half its interior points left out (a planted fault); `ulp` the reference
from a start one float32 ulp away and `order` the reference with each
draw's points in reverse order (witnesses of rounding). Prints one JSON
line per seed. Needs a CUDA card.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, ".bench_cache", "triton")
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--modes", default="program,control,half_batch")
    ap.add_argument("--curves", default=None,
                    help="a JSON file for each compared fit's per-iteration "
                         "loss sums, both sides")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("readings: needs a CUDA card", file=sys.stderr)
        return 1
    from benchmark.harness import run_cell
    modes = tuple(args.modes.split(","))
    for seed in (int(s) for s in args.seeds.split(",")):
        tic = time.time()
        curves = []
        r = run_cell(args.workload, seed, args.seconds, False,
                     modes=modes, started=tic, curves=curves)
        if args.curves:
            with open(args.curves, "a") as f:
                f.write(json.dumps({"seed": seed, "curves": curves}) + "\n")
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": r["correct"],
                          "readings": r["readings"],
                          "metrics": r["metrics"],
                          "seconds": time.time() - tic}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
