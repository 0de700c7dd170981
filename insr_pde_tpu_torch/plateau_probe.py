"""Plateau-schedule study of the pressure phase's stall (counterpart of
`tools/plateau_probe.py`).

    python -m insr_pde_tpu_torch.plateau_probe [--sr 128] [--layers 3]
        [--hidden 32] [--candidates ref,p1500,...] [--chunk 1000]
        [--max_iters N] [--host_rng] [--device cuda]

One advected Taylor-Green velocity at the paper scale (the init fit, then
the advect phase, `BaseModel._run_phase`, at the reference schedule:
ReduceLROnPlateau factor 0.1, patience 500, rel threshold 1e-4, stop at lr
<= 1.1e-8), then the pressure phase fitted from the same initial pressure
parameters under each candidate schedule of CANDIDATES, through the port's
`Solver` and its plateau arguments. Every candidate starts from the same
state of the model's generator, so that the collocation draws are the same
and only the schedule differs (the JAX tool's fixed `PRNGKey(7)`).

`--max_iters` caps every fit (the setup fits and each candidate) for a cut
run; without it the budgets are the published ones (20,000 for the setup
fits, each candidate's own). `--host_rng` draws on the CPU and copies the
points to the device, so a card run draws what a CPU run draws.

Prints the setup's JSON line, then one per candidate: {"cand", "lr",
"max_iters", "factor", "patience", "threshold", "final", "tail_mean",
"best", "iters", "sec", ...}. `--device cpu` is for the tests.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time

import numpy as np

from .bench import _sync, device_record

# name -> (lr, max_n_iters, factor, patience, threshold), the JAX tool's
CANDIDATES = {
    # reference schedule (the measured ~8e-6 stall)
    "ref":      (1e-4, 20000, 0.1, 500, 1e-4),
    # more patience at each LR level
    "p1500":    (1e-4, 20000, 0.1, 1500, 1e-4),
    # rel-threshold 0: ANY improvement resets patience (slower decay)
    "t0":       (1e-4, 20000, 0.1, 500, 0.0),
    # gentler decay: more LR levels between 1e-4 and the 1e-8 stop floor
    "f5p300":   (1e-4, 20000, 0.5, 300, 1e-4),
    "f5p100":   (1e-4, 20000, 0.5, 100, 1e-4),
    # gentler decay with a bigger budget (decay chain is ~23 levels long)
    "f5p300x3": (1e-4, 60000, 0.5, 300, 1e-4),
    # higher entry LR, reference decay
    "lr3e4":    (3e-4, 20000, 0.1, 500, 1e-4),
    "lr1e3":    (1e-3, 20000, 0.1, 500, 1e-4),
    # higher entry LR + gentle decay
    "lr1e3f5":  (1e-3, 30000, 0.5, 200, 1e-4),
}
SETUP_ITERS = 20000


def _cap(n: int, cap) -> int:
    return n if cap is None else min(n, cap)


def setup(args, work_dir: str):
    """(model, the setup's record): the fluid model after its init fit and
    one advect phase."""
    from .config import Config
    from .models.fluid import Fluid2DModel
    cfg = Config(
        pde="fluid", proj_dir=work_dir, tag="plateau",
        init_cond="taylorgreen", num_hidden_layers=args.layers,
        hidden_features=args.hidden, sample_resolution=args.sr,
        vis_resolution=16, max_n_iters=_cap(SETUP_ITERS, args.max_iters),
        chunk_size=args.chunk, early_stop=True, dt=args.dt,
        vis_frequency=10 ** 9, backup_sources=False, overwrite=True,
        matmul_precision=args.precision, advect_sobolev=args.advect_sobolev,
        advect_scheme=args.advect_scheme, device=args.device,
        host_rng=args.host_rng)
    cfg.setup_dirs()
    model = Fluid2DModel(cfg)
    tic = time.time()
    model.initialize()
    model.fields["velocity_prev"] = model.fields["velocity"]
    res_a = model._run_phase("advect_velocity", model._advect_loss,
                             model._points_with_bc, model.fields["velocity"],
                             aux={"prev": model.fields["velocity_prev"]})
    model.fields["velocity"] = res_a.params
    return model, {"setup": "init+advect", "sec": time.time() - tic,
                   "advect_final": res_a.final_loss,
                   "init_iters": model.phase_timings[0]["n_iters"],
                   "advect_iters": res_a.n_iters}


def run_candidate(model, name: str, gen_state, chunk: int, cap=None) -> dict:
    """The pressure phase from the model's initial pressure under candidate
    `name`, from generator state `gen_state`; its record."""
    from .models.solver import Solver
    lr, max_it, factor, patience, threshold = CANDIDATES[name]
    max_it = _cap(max_it, cap)
    solver = Solver(model._pressure_loss, model._points_with_bc, lr=lr,
                    max_n_iters=max_it, chunk_size=chunk, early_stop=True,
                    plateau_factor=factor, plateau_patience=patience,
                    plateau_threshold=threshold)
    model.generator.set_state(gen_state)
    _sync(model.device)
    tic = time.time()
    res = solver.fit(model.fields["pressure"],
                     aux={"vel": model.fields["velocity"]})
    sec = time.time() - tic
    hist = np.asarray(res.history["main"])
    tail = hist[-200:] if hist.size >= 200 else hist
    return {"cand": name, "lr": lr, "max_iters": max_it, "factor": factor,
            "patience": patience, "threshold": threshold,
            "final": float(res.final_loss), "tail_mean": float(tail.mean()),
            "best": float(hist.min()), "iters": int(res.n_iters),
            "sec": sec}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("plateau_probe",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--sr", type=int, default=128)
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--dt", type=float, default=0.05)
    ap.add_argument("--precision", type=str, default="highest")
    ap.add_argument("--candidates", type=str, default=",".join(CANDIDATES))
    ap.add_argument("--chunk", type=int, default=1000)
    ap.add_argument("--advect_sobolev", type=float, default=0.0,
                    help="derivative-supervise the setup advect fit: the "
                         "pressure floor is the advect fit's derivative "
                         "noise, so this moves the TARGET, not the "
                         "schedule")
    ap.add_argument("--advect_scheme", type=str, default="semilag")
    ap.add_argument("--max_iters", type=int, default=None,
                    help="cap every fit at this many iterations (a cut run)")
    ap.add_argument("--host_rng", action="store_true")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return ap


def main(argv=None) -> list:
    """Runs the probe; returns the printed records, the setup's first."""
    args = parser().parse_args(argv)
    from .ops.precision import resolve_device
    device = resolve_device(args.device)
    info = device_record(device)
    records = []
    with tempfile.TemporaryDirectory() as work:
        model, rec = setup(args, work)
        rec["device"] = info
        print(json.dumps(rec), flush=True)
        records.append(rec)
        state = model.generator.get_state()
        for name in args.candidates.split(","):
            rec = {**run_candidate(model, name, state, args.chunk,
                                   args.max_iters), "device": info}
            print(json.dumps(rec), flush=True)
            records.append(rec)
    return records


if __name__ == "__main__":
    main()
