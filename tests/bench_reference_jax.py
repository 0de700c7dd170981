"""The JAX package's runs that set two bars of the port's bench
(`python -m insr_pde_tpu_torch.bench`), on the CPU.

    python tests/bench_reference_jax.py advect1d [--seed S] [--out FILE]
    python tests/bench_reference_jax.py vortex_channel [--seed S] [--out FILE]

Each runs the JAX model at the bench's configuration (`ADVECT1D`,
`VORTEX_CHANNEL` of `insr_pde_tpu_torch.bench`, imported from there so
that the two cannot drift apart; the test file `tests/test_torch_bench.py`
holds them to the repo's `bench.py`) through the sequence of calls the
bench makes, and prints one JSON object with the quantity the bench checks
after each call and their worst:

* advect1d: the init fit, the warm-up step and REPS["advect1d"] reps of
  ADV_STEPS_PER_REP steps (t = 0 .. 21); after each, the field's rel L2
  against the closed form on the -vr grid (`yardsticks.advect_rel_l2`);
* vortex_channel: the warm-up `matrix_solver()` and REPS["vortex_channel"]
  reps, one Picard iteration of VORTEX_CGLS_ITERS block-whitened CGLS
  iterations each; after each, the inlet error (`tools/vortex_truth.
  inlet_error`, the port's `models/vortex.inlet_error` copies it) and max
  |u| of the sampled field (the bench's max |u| bar is 3x the worst of
  these).

The bench's bars are 3x the printed worst (`ADVECT1D_REL_L2_JAX`,
`VORTEX_INLET_ERROR_JAX`, `VORTEX_MAX_U_JAX` in the bench module). On a
shared 8-core CPU the advect1d run took ~17 min (22 fits of 2,000
iterations), the vortex run ~6 min.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from insr_pde_tpu_torch import bench  # noqa: E402
from insr_pde_tpu_torch.yardsticks import advect_rel_l2  # noqa: E402


def run_advect1d(seed: int) -> dict:
    from insr_pde_tpu.config import Config
    from insr_pde_tpu.models.advection import Advection1DModel

    c = bench.ADVECT1D
    steps = 1 + bench.REPS["advect1d"] * bench.ADV_STEPS_PER_REP
    rel = []
    with tempfile.TemporaryDirectory() as tmp:
        cfg = Config(proj_dir=tmp, tag="bench", seed=seed, **c)
        cfg.setup_dirs()
        model = Advection1DModel(cfg)
        for t in range(steps + 1):
            tic = time.perf_counter()
            res = model.initialize() if t == 0 else model.step()
            u = np.asarray(model.sample_field(cfg.vis_resolution))
            rel.append(advect_rel_l2(u, cfg.vis_resolution, cfg.length,
                                     cfg.vel, cfg.dt, t))
            print(f"t={t} iters {res.n_iters} rel L2 {rel[-1]:.6e} "
                  f"({time.perf_counter() - tic:.1f}s)", file=sys.stderr,
                  flush=True)
    return {"rel_l2": rel, "worst": max(rel)}


def run_vortex_channel(seed: int) -> dict:
    from insr_pde_tpu.models.vortex import StreamVortexModel, VortexConfig
    from tools.vortex_truth import inlet_error

    inlet, max_u, residual = [], [], []
    with tempfile.TemporaryDirectory() as tmp:
        cfg = VortexConfig(**bench.VORTEX_CHANNEL, seed=seed, log_dir=tmp)
        model = StreamVortexModel(cfg, log=False)
        for call in range(1 + bench.REPS["vortex_channel"]):
            tic = time.perf_counter()
            residual.append(float(model.matrix_solver()))
            inlet.append(inlet_error(model))
            vals = np.asarray(model.sample_field(cfg.vis_resolution)[0])
            max_u.append(float(np.abs(vals[..., :cfg.n_velocity]).max()))
            print(f"call {call}: residual {residual[-1]:.6e} inlet error "
                  f"{inlet[-1]:.6e} max |u| {max_u[-1]:.4f} "
                  f"({time.perf_counter() - tic:.1f}s)", file=sys.stderr,
                  flush=True)
    return {"inlet_error": inlet, "max_u": max_u, "residual": residual,
            "worst": max(inlet), "worst_max_u": max(max_u)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kind", choices=["advect1d", "vortex_channel"])
    ap.add_argument("--seed", type=int, default=None,
                    help="the JAX config's seed (default: its own default)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import jax
    jax.config.update("jax_platforms", "cpu")
    if args.seed is None:
        from insr_pde_tpu.config import Config
        from insr_pde_tpu.models.vortex import VortexConfig
        args.seed = (Config().seed if args.kind == "advect1d"
                     else VortexConfig().seed)
    run = {"advect1d": run_advect1d,
           "vortex_channel": run_vortex_channel}[args.kind]
    out = {"kind": args.kind, "seed": args.seed, "jax": jax.__version__,
           **run(args.seed)}
    text = json.dumps(out)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
