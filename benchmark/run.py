"""The benchmark of `insr_pde_tpu_torch` on one NVIDIA card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Run from the root of a checkout. Prints one JSON object as the last line
of standard output: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics, or with `--trace 1` its per-layer metrics), `device`,
with `--trace 1` `breakdown`, and last `checks`, each compared number with
its limit (also the last lines of standard error). Exits 1 without a CUDA
card, and 3 if JAX or the JAX package was loaded.
"""

import os
import sys
import time

STARTED = time.time()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache of the run at a fixed path in the checkout
CACHE = os.path.join(ROOT, ".bench_cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from benchmark.harness import cell_spec, emit, log, run_cell
    spec = cell_spec(args.workload)
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"benchmark: needs {chips} CUDA card(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}")
        return 1
    torch.set_num_threads(2)
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), started=STARTED)
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
