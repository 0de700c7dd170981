"""Where one fluid Adam iteration's time goes (counterpart of
`tools/overhead_probe.py`).

    python -m insr_pde_tpu_torch.overhead_probe [--phase pressure|advect]
        [--iters 1000] [--sr 128] [--reps 3] [--trace_iters 50]
        [--device cuda]

The split fluid model of `scripts/fluid2Dtlgn.sh` (SIREN 3x32, -sr 128 =
16,384 points an iteration) runs one phase's iteration in loops of growing
body, each the eager loop the port runs:

  loss               the loss alone, at fixed points
  grad               its value and gradient (the work the MFU counts)
  grad_rng           + fresh points from the model's generator every iteration
  adam               + the port's Adam update of the flat parameters
  full_solver_chunk  the port's `Solver` itself (`Solver._run_chunk`:
                     + the plateau scheduler, the early-stop latch and the
                     per-iteration scalars), early stop off

The pressure phase runs the vgl kernel pair (`csrc/siren_vgl.cu`); the
advect phase the plain network chains. Each variant runs once untimed, then
`--reps` timed loops of `--iters` iterations, each ended by
`torch.cuda.synchronize()`: ms per iteration as their median, min and
count. A short traced loop of `--trace_iters` iterations after the timed
ones gives the device busy ms, device events and busy share per iteration
(`phase_trace.device_summary`). The differences between neighbouring rows
say which piece holds the time. No `torch.compile`, no CUDA graph.

Prints one JSON line per variant. `adam` and `full_solver_chunk` start from
the same generator state and parameters, so that while the scheduler has
not fired they end at the same parameters (`chip_smoke.py` checks it).
`--device cpu` is for the tests; a CPU run's numbers are no device's.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from typing import Callable, Dict

import torch

from .bench import _sync, device_record, summarize

VARIANTS = ("loss", "grad", "grad_rng", "adam", "full_solver_chunk")


def build(phase: str, sr: int, iters: int, device: str, work_dir: str,
          hidden: int = 32):
    """(model, Solver, params, aux) of one split fluid phase at the paper
    scale, early stop off."""
    from .config import Config
    from .models.fluid import Fluid2DModel
    from .models.solver import Solver
    cfg = Config(pde="fluid", proj_dir=work_dir, tag="ovh",
                 init_cond="taylorgreen", num_hidden_layers=3,
                 hidden_features=hidden, sample_resolution=sr,
                 vis_resolution=16, max_n_iters=iters, chunk_size=iters,
                 early_stop=False, backup_sources=False, device=device)
    cfg.setup_dirs()
    model = Fluid2DModel(cfg)
    if phase == "pressure":
        loss_fn = model._pressure_loss
        params = model.fields["pressure"]
        aux = {"vel": model.fields["velocity"]}
    else:
        loss_fn = model._advect_loss
        params = model.fields["velocity"]
        aux = {"prev": model.fields["velocity"]}
    solver = Solver(loss_fn, model._points_with_bc, lr=cfg.lr,
                    max_n_iters=iters, chunk_size=iters, early_stop=False)
    return model, solver, params, aux


def variants(model, solver, params, aux) -> Dict[str, Callable]:
    """name -> run(n): n iterations of that loop from the same parameters
    and, for the variants that draw, the same generator state; returns the
    final flat parameters and the Solver's state (None but for
    `full_solver_chunk`)."""
    from .models.solver import (SolveState, adam_init, adam_update,
                                plateau_init, ravel, unravel)
    flat0, shapes = ravel(params)
    flat0 = flat0.detach()
    fixed = model._points_with_bc()
    gen_state = model.generator.get_state()

    # each loop stacks its per-iteration losses, as a Solver chunk stacks
    # its scalars
    def loss(n):
        out = []
        with torch.no_grad():
            for _ in range(n):
                ld = solver.loss_fn(unravel(flat0, shapes), fixed, aux)
                out.append(sum(ld.values()))
        torch.stack(out)
        return flat0, None

    def grad(n):
        out = []
        for _ in range(n):
            ld, _ = solver.value_and_grad(flat0, shapes, fixed, aux)
            out.append(ld["main"])
        torch.stack(out)
        return flat0, None

    def grad_rng(n):
        model.generator.set_state(gen_state)
        out = []
        for _ in range(n):
            pts = model._points_with_bc()
            ld, _ = solver.value_and_grad(flat0, shapes, pts, aux)
            out.append(ld["main"])
        torch.stack(out)
        return flat0, None

    def adam(n):
        model.generator.set_state(gen_state)
        flat, opt, out = flat0, adam_init(flat0), []
        for _ in range(n):
            pts = model._points_with_bc()
            ld, g = solver.value_and_grad(flat, shapes, pts, aux)
            updates, opt = adam_update(g, opt, solver.lr)
            flat = flat + updates
            out.append(ld["main"])
        torch.stack(out)
        return flat, None

    def full_solver_chunk(n):
        model.generator.set_state(gen_state)
        state = SolveState(flat0, adam_init(flat0),
                           plateau_init(flat0.device))
        state, _, stacked = solver._run_chunk(state, shapes, aux, n)
        return state.params, state

    return {"loss": loss, "grad": grad, "grad_rng": grad_rng, "adam": adam,
            "full_solver_chunk": full_solver_chunk}


def time_variant(run: Callable, n: int, reps: int,
                 device: torch.device) -> list:
    """Seconds of `reps` timed loops of n iterations after one untimed."""
    run(n)
    _sync(device)
    secs = []
    for _ in range(reps):
        _sync(device)
        tic = time.perf_counter()
        run(n)
        _sync(device)
        secs.append(time.perf_counter() - tic)
    return secs


def traced(run: Callable, n: int, device: torch.device):
    """(device events, busy ms) per iteration of one loop of n iterations
    under torch.profiler; (None, None) where it saw no device event."""
    from torch.profiler import ProfilerActivity, profile
    from .phase_trace import device_summary
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        run(n)
        _sync(device)
    events, busy, _ = device_summary(prof, n)
    return (events, busy) if events else (None, None)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("overhead_probe",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--phase", choices=["pressure", "advect"],
                    default="pressure")
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--sr", type=int, default=128)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--trace_iters", type=int, default=50)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return ap


def main(argv=None) -> list:
    """Runs the probe; returns the printed records."""
    args = parser().parse_args(argv)
    from .ops.precision import resolve_device, set_full_precision
    device = resolve_device(args.device)
    set_full_precision()
    info = device_record(device)
    records = []
    with tempfile.TemporaryDirectory() as work:
        model, solver, params, aux = build(args.phase, args.sr, args.iters,
                                           args.device, work)
        runs = variants(model, solver, params, aux)
        n = args.iters
        for name in VARIANTS:
            secs = time_variant(runs[name], n, args.reps, device)
            events, busy = traced(runs[name], args.trace_iters, device)
            st = summarize([s / n * 1e3 for s in secs])
            rec = {"variant": name, "phase": args.phase,
                   "ms_per_iter": st["median"], "ms_per_iter_min": st["min"],
                   "n": st["n"], "sec_total": summarize(secs)["median"],
                   "iters": n, "pts": model.n_samples,
                   "device_events_per_iter": events,
                   "busy_ms_per_iter": busy,
                   "busy_share": (None if busy is None
                                  else busy / st["median"]),
                   "device": info}
            print(json.dumps(rec), flush=True)
            records.append(rec)
    return records


if __name__ == "__main__":
    main()
