"""Device time and events per Adam iteration of one fluid step phase, over
several traced fits.

    python -m insr_pde_tpu_torch.phase_trace [--phase solve_pressure]
        [--fits 7] [--iters 50]

Builds the split fluid model of `chip_smoke.py`'s main path (Taylor-Green,
SIREN 3x32, -sr 128: 16,384 points per iteration) without fitting it, then
traces `--fits` fits of `--iters` iterations of the phase, each under its
own `torch.profiler` session after one untraced fit. Prints, per fit, the
device events and the summed device time (busy) per iteration, then the
median of each, and per kernel name the events and ms per iteration of the
median fit, so that two trees traced in one call can be compared kernel by
kernel. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

_MODEL_ARGS = ["fluid", "--init_cond", "taylorgreen", "--num_hidden_layers",
               "3", "--hidden_features", "32", "-sr", "128", "-vr", "128",
               "--dt", "0.05", "-T", "1", "--max_n_iters", "500",
               "--chunk_size", "250", "--no_backup"]
_PHASES = ("advect_velocity", "solve_pressure", "projection")


def _median(values):
    s = sorted(values)
    return s[len(s) // 2]


def device_summary(prof, iters: int) -> tuple:
    """(events, busy ms, {kernel name: (events, ms)}), each per iteration,
    of the device events a `torch.profiler` session recorded over `iters`
    iterations; busy is their summed duration (one stream: they do not
    overlap)."""
    from torch.autograd import DeviceType
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, ms = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, ms + e.time_range.elapsed_us() / 1e3)
    events = sum(n for n, _ in by_name.values())
    busy = sum(ms for _, ms in by_name.values())
    return (events / iters, busy / iters,
            {k: (n / iters, ms / iters) for k, (n, ms) in by_name.items()})


def trace_fits(model, phase: str, fits: int, iters: int) -> list:
    """[(events per iteration, busy ms per iteration, {name: (events, ms)
    per iteration})] of `fits` traced fits of `iters` iterations."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from .models.solver import Solver

    v, p = model.fields["velocity"], model.fields["pressure"]
    loss, params, aux = {
        "advect_velocity": (model._advect_loss, v, {"prev": v}),
        "solve_pressure": (model._pressure_loss, p, {"vel": v}),
        "projection": (model._projection_loss, v,
                       {"prev": v, "pressure": p}),
    }[phase]
    solver = Solver(loss, model._points_with_bc, lr=model.cfg.lr,
                    max_n_iters=iters, chunk_size=iters, early_stop=False)
    solver.fit(params, aux)
    torch.cuda.synchronize()
    out = []
    for _ in range(fits):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            solver.fit(params, aux)
            torch.cuda.synchronize()
        out.append(device_summary(prof, iters))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phase", choices=_PHASES, default="solve_pressure")
    ap.add_argument("--fits", type=int, default=7)
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("phase_trace: needs a CUDA card")
    from .__main__ import build_model
    from .config import parse_args
    from .ops.precision import set_full_precision
    set_full_precision()
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as proj:
        cfg = parse_args(_MODEL_ARGS + ["--proj_dir", proj, "--tag", "trace"],
                         phase="train")
        model = build_model(cfg)
    fits = trace_fits(model, args.phase, args.fits, args.iters)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"phase_trace {args.phase}: {args.fits} fits of {args.iters} "
          f"iterations; {smi}")
    for i, (events, busy, _) in enumerate(fits):
        print(f"  fit {i}: {events:.2f} device events/iter, busy "
              f"{busy:.5f} ms/iter")
    events = _median([f[0] for f in fits])
    busy = _median([f[1] for f in fits])
    mid = sorted(fits, key=lambda f: f[1])[len(fits) // 2][2]
    print(f"median: {events:.2f} device events/iter, busy {busy:.5f} ms/iter")
    print("kernels of the median fit (events/iter, ms/iter):")
    for name, (n, ms) in sorted(mid.items(), key=lambda kv: -kv[1][1]):
        print(f"  {n:7.2f} {ms:.5f}  {name[:100]}")
    print(json.dumps({"phase": args.phase, "iters": args.iters,
                      "events_per_iter": [f[0] for f in fits],
                      "busy_ms_per_iter": [f[1] for f in fits],
                      "median_events": events, "median_busy_ms": busy,
                      "median_fit_kernels": mid}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
