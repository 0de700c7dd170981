"""Training entry point of the port (counterpart of the repo's `main.py`).

    python -m insr_pde_tpu_torch {fluid,advection,elasticity} <the flags of
        main.py> [--device cpu]
    python -m insr_pde_tpu_torch vortex <the flags of starterL.py>
        [--device cpu]

t=0 fits the initial condition, t>=1 steps the PDE; outputs, checkpoints,
`timings.jsonl` and per-timestep `log/tNNN/scalars.jsonl` are written as the
JAX package writes them. Runs on the card (`--device cuda`, the default)
unless asked for the CPU; without a card, cuda raises.
"""

from __future__ import annotations

import json
import os
import sys
import time

from .config import parse_args


def build_model(cfg):
    if cfg.pde == "fluid":
        from .models.fluid import Fluid2DModel
        return Fluid2DModel(cfg)
    if cfg.pde == "advection":
        from .models.advection import Advection1DModel
        return Advection1DModel(cfg)
    if cfg.pde == "elasticity":
        from .models.elasticity import ElasticityModel
        return ElasticityModel(cfg)
    raise NotImplementedError(f"pde={cfg.pde}")


def main(argv=None):
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "vortex":
        from .starterL import main as vortex_main
        return vortex_main(argv[1:])
    cfg = parse_args(argv, phase="train")
    print(cfg)
    # raises on an unported option, a missing mesh or a missing card
    # before any IO
    model = build_model(cfg)
    cfg.setup_dirs()

    if (cfg.pde == "fluid" and cfg.fluid_step == "split"
            and cfg.n_timesteps > 1):
        print("note: --fluid_step split is reference parity (first-order "
              "splitting bias ~6e-4/step on Taylor-Green, measured by the "
              "JAX package). `--fluid_step merged2 --advect_trace rk2` "
              "measured 3x lower horizon error there (COMPARISON.md).")

    output_folder = os.path.join(cfg.exp_dir, "results")
    os.makedirs(output_folder, exist_ok=True)

    start_t = 0
    if cfg.ckpt is not None:
        name = int(cfg.ckpt) if cfg.ckpt.lstrip("-").isdigit() else cfg.ckpt
        model.load_ckpt(name)
        start_t = model.timestep + 1
        print(f"resumed from checkpoint at timestep {model.timestep}")

    profiler = None
    if cfg.profile_dir:
        import torch
        activities = [torch.profiler.ProfilerActivity.CPU]
        if model.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.__enter__()

    timings_path = os.path.join(cfg.exp_dir, "timings.jsonl")
    try:
        for t in range(start_t, cfg.n_timesteps + 1):
            tic = time.perf_counter()
            if t == 0:
                model.initialize()
            else:
                model.step()
            dt_wall = time.perf_counter() - tic
            print(f"timestep: {t}  ({dt_wall:.2f}s)")
            with open(timings_path, "a") as f:
                f.write(json.dumps({"timestep": t, "sec": dt_wall}) + "\n")
            model.write_output(output_folder)
    finally:
        if profiler is not None:
            profiler.__exit__(None, None, None)
            os.makedirs(cfg.profile_dir, exist_ok=True)
            profiler.export_chrome_trace(
                os.path.join(cfg.profile_dir, "trace.json"))
    return model


if __name__ == "__main__":
    main(sys.argv[1:])
