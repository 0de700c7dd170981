"""Trajectory statistics of elasticity and fluid runs, from their outputs.

    python -m insr_pde_tpu_torch.elasticity_stats {3d,2d,stretch,fluid}
        RUN_DIR [RUN_DIR ...]

Reads the `results/tNNN_deformation.ply` files that the elasticity entry
points of both packages write (`python -m insr_pde_tpu_torch elasticity` and
the JAX package's `main.py elasticity`), or the fluid entry points'
`results/tNNN.npy` velocity grids, and prints one JSON line per run with
per-t statistics, then one with, per t, the mean over the runs and their
spread (max - min):

* 3d: z_min and z_mean of the output points;
* 2d: the centroid's y and the deepest penetration into the collision
  circle, whose centre and radius it reads from the run's `config.json`
  (`collide_circle_x`, `_y`, `_radius`);
* stretch (2D box scenes): the mean x of the box's right face and of its
  left face, the output points' last two groups of `res` points, res =
  min(vis_resolution, 200) from `config.json` (the stretch pulls the right
  face from x = +1 towards +1 + the offset against the constraint at x =
  -1);
* fluid: max |u| and the kinetic energy, mean of |u|^2 / 2, over the grid
  (the multi-scale Taylor-Green scene has no analytic solution after t =
  0).

Reads no model and imports no framework, so it holds two packages' runs to
one yardstick.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

import numpy as np

def read_ply(path: str) -> np.ndarray:
    """The (N, 3) points of an ASCII PLY file."""
    with open(path) as f:
        lines = f.read().splitlines()
    start = lines.index("end_header") + 1
    return np.loadtxt(lines[start:], dtype=np.float64, ndmin=2)[:, :3]


def step_stats(kind: str, pts: np.ndarray, circle=None, res=None) -> dict:
    """3D: z_min and z_mean of the points; 2D: the centroid's y and the
    deepest penetration into the circle ((cx, cy), r) (0 if none);
    stretch: the mean x of the last `res` points (the right face) and of
    the `res` before them (the left face)."""
    if kind == "3d":
        return {"z_min": float(pts[:, 2].min()),
                "z_mean": float(pts[:, 2].mean())}
    if kind == "stretch":
        return {"right_x": float(pts[-res:, 0].mean()),
                "left_x": float(pts[-2 * res:-res, 0].mean())}
    (cx, cy), r = circle
    dist = np.hypot(pts[:, 0] - cx, pts[:, 1] - cy)
    return {"centroid_y": float(pts[:, 1].mean()),
            "penetration": float(max(0.0, (r - dist).max()))}


def fluid_stats(u: np.ndarray) -> dict:
    """max |u| and the kinetic energy (mean |u|^2 / 2) of a velocity grid
    (..., 2)."""
    sq = np.sum(np.asarray(u, np.float64) ** 2, axis=-1)
    return {"max_u": float(np.sqrt(sq.max())),
            "energy": float(0.5 * sq.mean())}


def run_stats(kind: str, run_dir: str) -> list:
    """Per t (from 0, up to the last output) the statistics of one run."""
    if kind == "fluid":
        paths = sorted(glob.glob(os.path.join(run_dir, "results",
                                              "t[0-9][0-9][0-9].npy")))
        if not paths:
            raise FileNotFoundError(f"{run_dir}: no results/tNNN.npy")
        return [fluid_stats(np.load(p)) for p in paths]
    paths = sorted(glob.glob(os.path.join(run_dir, "results",
                                          "t*_deformation.ply")))
    if not paths:
        raise FileNotFoundError(f"{run_dir}: no results/tNNN_deformation.ply")
    circle = res = None
    if kind in ("2d", "stretch"):
        with open(os.path.join(run_dir, "config.json")) as f:
            cfg = json.load(f)
        if kind == "2d":
            circle = ((cfg["collide_circle_x"], cfg["collide_circle_y"]),
                      cfg["collide_circle_radius"])
        else:
            res = min(cfg["vis_resolution"], 200)
    return [step_stats(kind, read_ply(p), circle, res) for p in paths]


def summarize(runs: list) -> dict:
    """Per quantity and t: the mean over the runs and the spread (max -
    min), over the t that every run reached."""
    n_t = min(len(r) for r in runs)
    out = {}
    for key in runs[0][0]:
        vals = np.asarray([[run[t][key] for t in range(n_t)] for run in runs])
        out[key] = {"mean": vals.mean(0).tolist(),
                    "spread": (vals.max(0) - vals.min(0)).tolist()}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser("insr_pde_tpu_torch.elasticity_stats")
    ap.add_argument("kind", choices=["3d", "2d", "stretch", "fluid"])
    ap.add_argument("runs", nargs="+", help="experiment directories")
    args = ap.parse_args(argv)
    runs = []
    for run_dir in args.runs:
        stats = run_stats(args.kind, run_dir)
        print(json.dumps({"run": run_dir, "steps": stats}))
        runs.append(stats)
    summary = summarize(runs)
    print(json.dumps({"kind": args.kind, "runs": len(runs),
                      "summary": summary}))
    return summary


if __name__ == "__main__":
    main(sys.argv[1:])
