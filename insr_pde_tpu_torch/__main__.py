"""Training entry point of the port (counterpart of the repo's `main.py`).

    python -m insr_pde_tpu_torch {fluid,advection,elasticity} <the flags of
        main.py> [--device cpu]
    python -m insr_pde_tpu_torch vortex <the flags of starterL.py>
        [--device cpu]

t=0 fits the initial condition, t>=1 steps the PDE; outputs, checkpoints,
`timings.jsonl` and per-timestep `log/tNNN/scalars.jsonl` are written as the
JAX package writes them. Runs on the card (`--device cuda`, the default)
unless asked for the CPU; without a card, cuda raises.

Sharded, one process per rank (each fit's collocation points, and each
vortex system's rows, divided over the ranks):

    torchrun --standalone --nproc_per_node 2 -m insr_pde_tpu_torch fluid \
        <flags> --n_devices 2 [--dist_backend gloo]

`--n_devices` must be 0 (every rank) or the launch's world size; without a
launcher 0 and 1 run one process. Only rank 0 writes outputs, checkpoints,
`timings.jsonl` and `log/`.
"""

from __future__ import annotations

import json
import os
import sys
import time

from .config import parse_args
from .parallel.mesh import make_group


def build_model(cfg, group=None):
    if cfg.pde == "fluid":
        from .models.fluid import Fluid2DModel
        return Fluid2DModel(cfg, group)
    if cfg.pde == "advection":
        from .models.advection import Advection1DModel
        return Advection1DModel(cfg, group)
    if cfg.pde == "elasticity":
        from .models.elasticity import ElasticityModel
        return ElasticityModel(cfg, group)
    raise NotImplementedError(f"pde={cfg.pde}")


def main(argv=None):
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "vortex":
        from .starterL import main as vortex_main
        return vortex_main(argv[1:])
    cfg = parse_args(argv, phase="train")
    group = make_group(cfg.n_devices, cfg.dist_backend, cfg.device)
    main_rank = group is None or group.is_main
    if main_rank:
        print(cfg)
    # raises on an unported option, a missing mesh or a missing card
    # before any IO
    model = build_model(cfg, group)
    if main_rank:
        cfg.setup_dirs()

    if (main_rank and cfg.pde == "fluid" and cfg.fluid_step == "split"
            and cfg.n_timesteps > 1):
        print("note: --fluid_step split is reference parity (first-order "
              "splitting bias ~6e-4/step on Taylor-Green, measured by the "
              "JAX package). `--fluid_step merged2 --advect_trace rk2` "
              "measured 3x lower horizon error there (COMPARISON.md).")

    output_folder = os.path.join(cfg.exp_dir, "results")
    if main_rank:
        os.makedirs(output_folder, exist_ok=True)

    start_t = 0
    if cfg.ckpt is not None:
        name = int(cfg.ckpt) if cfg.ckpt.lstrip("-").isdigit() else cfg.ckpt
        model.load_ckpt(name)
        start_t = model.timestep + 1
        if main_rank:
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
            if not main_rank:
                continue
            print(f"timestep: {t}  ({dt_wall:.2f}s)")
            with open(timings_path, "a") as f:
                f.write(json.dumps({"timestep": t, "sec": dt_wall}) + "\n")
            model.write_output(output_folder)
    finally:
        if profiler is not None:
            profiler.__exit__(None, None, None)
        if profiler is not None and main_rank:
            os.makedirs(cfg.profile_dir, exist_ok=True)
            profiler.export_chrome_trace(
                os.path.join(cfg.profile_dir, "trace.json"))
    return model


if __name__ == "__main__":
    main(sys.argv[1:])
