"""A configuration sweep of the vortex channel scene (counterpart of
`tools/vortex_sweep.py`): per configuration the inlet relative error and
the finite-difference relative divergence, with the f64 LSQR truth
(`vortex_truth.lsqr_truth`) and/or the port's f32 CGLS.

    python -m insr_pde_tpu_torch.vortex_sweep --configs sweep.json
        [--out results.json] [--device cpu]
    python -m insr_pde_tpu_torch.vortex_sweep --inline \\
        '[{"name": "a", "collocation_pts_num": 2000}]'

Each configuration is a JSON object of `VortexConfig` overrides plus
"name" (the row's label), "formulation" ("stream", the default, or
"velocity"), "solver" ("lsqr", the f64 truth and the default; "cgls",
the f32 path; or "both"), "lsqr_iters" (20,000) and "resolution" (64).
Prints one markdown row per (configuration, solver); the JAX package's
acceptance bar is inlet <= 1e-2 and rel_div <= 1e-2 at the reference
scale (400 basis x 10 slices, rho 1000, v 8). A configuration that fails
is reported and the sweep goes on; the exit code is 1 if any failed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .models.vortex import (StreamVortexModel, VortexConfig, VortexModel,
                            relative_divergence)
from .ops.precision import resolve_device, set_full_precision
from .vortex_truth import log, lsqr_truth, set_coefficients


def measure(model, resolution: int = 64):
    """(inlet rel err, FD relative divergence, per-slice inlet err) on the
    sampled grid; the per-slice errors tell early slices that the smooth
    time basis cannot fit at the impulsive start from a uniform miss."""
    vals = model.sample_field(resolution)[0].cpu().numpy()
    r = resolution
    g = vals.reshape(vals.shape[0], r, r, -1)
    v = model.cfg.internal_v
    per_slice = np.mean(np.abs(g[:, 0, :, 0] - v), axis=1) / max(abs(v),
                                                                  1e-30)
    inlet = float(np.mean(per_slice[1:]))
    return inlet, relative_divergence(model, resolution), per_slice


def run_config(spec: dict, device="cuda") -> list:
    """The rows of one configuration: an "lsqr64" row, a "cgls32" row or
    both."""
    spec = dict(spec)
    name = spec.pop("name", "cfg")
    formulation = spec.pop("formulation", "stream")
    solver = spec.pop("solver", "lsqr")
    lsqr_iters = spec.pop("lsqr_iters", 20000)
    resolution = spec.pop("resolution", 64)
    if solver not in ("lsqr", "cgls", "both"):
        raise ValueError(f"solver must be lsqr, cgls or both, got {solver!r}")

    fields = dict(rho=1000.0, internal_v=8.0, pou="smooth", band_width=1.0,
                  w_bc=5.0, picard_iters=1, cgls_maxiter=2000,
                  log_dir="./log/vortex_sweep")
    fields.update(spec)
    cfg = VortexConfig(**fields)
    cls = StreamVortexModel if formulation == "stream" else VortexModel
    t0 = time.perf_counter()
    model = cls(cfg, log=False, device=resolve_device(device))
    A, b = model.assemble(model.params.u)
    R, C = int(A.vals.shape[0]), int(A.n_cols)
    log(f"{name}: system {R} x {C} (ratio {R / C:.2f}), assemble "
        f"{time.perf_counter() - t0:.1f}s")

    rows = []

    def finish(tag, x, sec, extra):
        set_coefficients(model, x)
        inlet, rel_div, per_slice = measure(model, resolution)
        rows.append({"name": name, "solver": tag, "formulation": formulation,
                     "rows": R, "cols": C, "ratio": round(R / C, 3),
                     "inlet": inlet, "rel_div": rel_div,
                     "inlet_per_slice": [round(float(v), 4)
                                         for v in per_slice],
                     "solve_sec": round(sec, 1),
                     "blocks": {k: v["rms"] for k, v in
                                model.block_residuals().items()},
                     **extra})
        log(f"{name}/{tag}: inlet {inlet:.3e}  rel_div {rel_div:.3e}  "
            f"({sec:.0f}s)")

    if solver in ("lsqr", "both"):
        truth = lsqr_truth(model, lsqr_iters, cfg.cgls_damp, (A, b))
        finish("lsqr64", truth["x64"], truth["sec"],
               {"lsqr_itn": truth["itn"], "lsqr_istop": truth["istop"],
                "lsqr_r1norm": truth["r1norm"]})
    if solver in ("cgls", "both"):
        t0 = time.perf_counter()
        model.params = model.params._replace(
            u=torch.zeros_like(model.params.u))
        res = model.matrix_solver()
        finish("cgls32", model.params.u.reshape(-1).cpu().numpy(),
               time.perf_counter() - t0, {"cgls_residual": float(res)})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("insr_pde_tpu_torch.vortex_sweep")
    ap.add_argument("--configs", type=str, default="")
    ap.add_argument("--inline", type=str, default="")
    ap.add_argument("--out", type=str, default="")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    if args.inline:
        specs = json.loads(args.inline)
    else:
        with open(args.configs) as f:
            specs = json.load(f)

    set_full_precision()
    rows, failed = [], 0
    for spec in specs:
        try:
            rows.extend(run_config(spec, args.device))
        except Exception as e:  # report it, sweep the rest
            failed += 1
            log(f"{spec.get('name', '?')}: FAILED {type(e).__name__}: {e}")

    print("\n| name | solver | rows x cols (ratio) | inlet | rel_div | sec |")
    print("|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['name']} | {r['solver']} | {r['rows']} x {r['cols']} "
              f"({r['ratio']}) | {r['inlet']:.3e} | {r['rel_div']:.3e} | "
              f"{r['solve_sec']} |")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
