"""Fluid analytic golden of the port: per-timestep velocity rel L2 against the
exact Taylor-Green solution (counterpart of `tools/compare_fluid_tg.py`).

The fluid model is inviscid, and the Taylor-Green vortex whose cells align
with the free-slip box is a steady solution of the incompressible Euler
equations, so the exact solution at every timestep is the initial
condition: any drift is numerical error (fit error + time discretization).

    python -m insr_pde_tpu_torch.compare_fluid_tg [--timesteps 8]
        [--device cuda|cpu] [--sr 128] [--iters 20000] [--eval_res 256]
        [--fluid_step split|merged|merged2] [--advect_trace euler|rk2]
        [--advect_scheme semilag|maccormack] [--advect_sobolev W]

Prints one JSON line per timestep, {"t", "rel_l2", "amp", "sec"} (amp: the
best-fit amplitude of the exact mode, whose distance from 1 is the
dissipative part of the drift), and a final summary line.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time

import torch

from .config import Config
from .models.examples import taylorgreen_velocity
from .models.fluid import Fluid2DModel
from .ops.sampling import sample_uniform


def main(argv=None):
    ap = argparse.ArgumentParser("compare_fluid_tg")
    ap.add_argument("--timesteps", type=int, default=8)
    ap.add_argument("--device", type=str, default="cuda",
                    choices=["cuda", "cpu"])
    ap.add_argument("--sr", type=int, default=128)
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--iters", type=int, default=20000)
    ap.add_argument("--dt", type=float, default=0.05)
    ap.add_argument("--eval_res", type=int, default=256)
    ap.add_argument("--proj_dir", type=str, default=None)
    ap.add_argument("--precision", type=str, default="highest",
                    choices=["default", "high", "highest"],
                    help="accepted for parity with the JAX tool; the port "
                         "runs full f32 at every level")
    ap.add_argument("--plateau_patience", type=int, default=500)
    ap.add_argument("--plateau_threshold", type=float, default=1e-4)
    ap.add_argument("--plateau_factor", type=float, default=0.1)
    ap.add_argument("--advect_scheme", type=str, default="semilag",
                    choices=["semilag", "maccormack"])
    ap.add_argument("--advect_sobolev", type=float, default=0.0)
    ap.add_argument("--fluid_step", type=str, default="split",
                    choices=["split", "merged", "merged2"])
    ap.add_argument("--advect_trace", type=str, default="euler",
                    choices=["euler", "rk2"])
    ap.add_argument("--save_ckpt", action="store_true",
                    help="write a per-step checkpoint; needs --proj_dir")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest per-step checkpoint under "
                         "--proj_dir (the point draws after the resume "
                         "point differ from a continuous run's)")
    args = ap.parse_args(argv)

    tmp_ctx = tempfile.TemporaryDirectory()
    proj = args.proj_dir or tmp_ctx.name
    cfg = Config(
        pde="fluid", proj_dir=proj, tag="tg_golden",
        init_cond="taylorgreen", num_hidden_layers=args.layers,
        hidden_features=args.hidden, sample_resolution=args.sr,
        vis_resolution=32, max_n_iters=args.iters, chunk_size=1000,
        early_stop=True, dt=args.dt, vis_frequency=10 ** 9,
        backup_sources=False, overwrite=True,
        matmul_precision=args.precision,
        plateau_patience=args.plateau_patience,
        plateau_threshold=args.plateau_threshold,
        plateau_factor=args.plateau_factor,
        advect_scheme=args.advect_scheme,
        advect_sobolev=args.advect_sobolev,
        fluid_step=args.fluid_step,
        advect_trace=args.advect_trace,
        device=args.device,
    )
    if args.resume:
        cfg.ckpt = "latest"  # setup_dirs must not wipe the exp dir
    cfg.setup_dirs()
    model = Fluid2DModel(cfg)

    grid = sample_uniform(args.eval_res, 2, flatten=True, device=model.device)
    exact = taylorgreen_velocity(grid, rescale=True)
    exact_norm = torch.linalg.norm(exact)

    @torch.no_grad()
    def metrics(params):
        u = model.vel_net.apply(params, grid)
        rel = torch.linalg.norm(u - exact) / exact_norm
        alpha = torch.sum(u * exact) / exact_norm ** 2
        return float(rel), float(alpha)

    rows = []

    def report(k, sec):
        r, alpha = metrics(model.fields["velocity"])
        rows.append(r)
        print(json.dumps({"t": k, "rel_l2": round(r, 6),
                          "amp": round(alpha, 6), "sec": round(sec, 1)}),
              flush=True)

    start = 1
    if args.resume:
        model.load_ckpt("latest")
        start = model.timestep + 1
        print(json.dumps({"resumed_at": model.timestep}), flush=True)
    else:
        t0 = time.time()
        model.initialize()
        report(0, time.time() - t0)
        if args.save_ckpt:
            model.save_ckpt()
    for k in range(start, args.timesteps + 1):
        t0 = time.time()
        model.step()
        report(k, time.time() - t0)
        if args.save_ckpt:
            model.save_ckpt()

    summary = {
        "summary": "fluid_taylorgreen_analytic_golden",
        "device": str(model.device),
        "sr": args.sr, "iters": args.iters, "dt": args.dt,
        "hidden": args.hidden, "precision": args.precision,
        "plateau": [args.plateau_patience, args.plateau_threshold,
                    args.plateau_factor],
        "advect": [args.advect_scheme, args.advect_sobolev],
        "fluid_step": args.fluid_step,
        "advect_trace": args.advect_trace,
        "rel_l2_t0": round(rows[0], 6) if rows else None,
        "rel_l2_final": round(rows[-1], 6) if rows else None,
        "rel_l2_max": round(max(rows), 6) if rows else None,
        "timesteps": args.timesteps,
    }
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
