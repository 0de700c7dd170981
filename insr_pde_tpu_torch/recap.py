"""Re-render a run's per-timestep outputs from its checkpoints (counterpart
of the repo's `recap.py`).

    python -m insr_pde_tpu_torch.recap {fluid,advection,elasticity} \\
        --proj_dir DIR --tag TAG [-vr N] [-o recap]
    python -m insr_pde_tpu_torch.recap vortex --ckpt vortex_ckpt.npz \\
        [-o recap] [-vr N] [--device cpu]

The first form restores the training-time config from the run's
`config.json` (the CLI keeps `-vr`, `-o`, `--proj_dir` and `--tag`), then
loads each timestep's checkpoint and calls the model's `write_output` into
`<proj_dir>/<tag>/<output>`, with no training; it stops at the first
missing checkpoint. Pass the training-time `-vr` to reproduce the training
outputs. The second re-renders a vortex checkpoint's slices: its basis is
drawn anew from the saved config, so no solve is needed.
"""

from __future__ import annotations

import argparse
import os
import sys

from .config import parse_args


def recap_vortex(argv):
    """Re-render vortex slices from a `vortex_ckpt.npz` of either package."""
    ap = argparse.ArgumentParser("insr_pde_tpu_torch.recap vortex")
    ap.add_argument("--ckpt", type=str, required=True,
                    help="vortex_ckpt.npz written by the vortex entry point")
    ap.add_argument("-o", "--output", type=str, default="recap",
                    help="output directory, relative to the checkpoint's")
    ap.add_argument("-vr", "--vis_resolution", type=int, default=0,
                    help="grid resolution (0: the checkpoint's config)")
    ap.add_argument("--device", type=str, default="cuda",
                    choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from .models.vortex import load_vortex_ckpt
    model = load_vortex_ckpt(args.ckpt, device=args.device)
    out = (args.output if os.path.isabs(args.output)
           else os.path.join(os.path.dirname(os.path.abspath(args.ckpt)),
                             args.output))
    model.write_output(out, resolution=args.vis_resolution)
    print(f"re-rendered {model.cfg.time_num} slices to {out}")
    return model


def main(argv=None):
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "vortex":
        return recap_vortex(argv[1:])
    from .__main__ import build_model

    cfg = parse_args(argv, phase="recap")
    print(cfg)
    model = build_model(cfg)
    output_folder = os.path.join(cfg.exp_dir, cfg.output)
    os.makedirs(output_folder, exist_ok=True)
    for t in range(cfg.n_timesteps + 1):
        try:
            model.load_ckpt(t)
        except FileNotFoundError:
            print(f"checkpoint for timestep {t} not found; stopping.")
            break
        print(f"timestep: {t}")
        model.write_output(output_folder)
    return model


if __name__ == "__main__":
    main(sys.argv[1:])
