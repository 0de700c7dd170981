"""The JAX package's elasticity runs that set the bars of the port's chip
check (`chip_smoke.py`, phases `elasticity3D` and `elasticity2D`), on the
CPU.

    python tests/elasticity_reference_jax.py 3d --seeds 0 1 2 --out DIR
    python -m insr_pde_tpu_torch.elasticity_stats 3d DIR/3d_seed*

Each seed runs `main.py elasticity` with the flags `chip_smoke.py` gives
the port (`ELA_3D_ARGS` or `ELA_2D_ARGS`: the published script cut to
`ELA_STEPS` and `ELA_ITERS`, on `statue_tet_mesh(ELA_MESH_N)` in 3D), taken
from there so that the two cannot drift apart, into `DIR/<kind>_seed<K>`,
and prints one JSON line per seed with the per-t statistics of its PLY
outputs, read with the port's yardstick (`elasticity_stats`, which reads
either package's files). Seeds may run in parallel, one process each, into
one DIR; `elasticity_stats` then prints, per t, the mean over the seeds and
their spread (max - min).

One change to the JAX run, in this script only: `jax.random.categorical`,
the JAX package's volume-weighted tet draw, is a Gumbel-max over every tet
(8,000 x 163,840 floats, 5.2 GB, each Adam iteration on the lucy-scale
stand-in), which a CPU cannot afford. The draw is replaced by the inverse
CDF of the same distribution (what the port does); the points keep their
distribution and only the random stream changes, as it does between seeds.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# the cut configuration the port is checked at (chip_smoke imports no JAX
# and nothing heavy at import), and the port's yardstick
from chip_smoke import (  # noqa: E402
    ELA_2D_ARGS, ELA_3D_ARGS, ELA_ITERS, ELA_MESH_N, ELA_STEPS)
from insr_pde_tpu_torch.elasticity_stats import run_stats  # noqa: E402


def _inverse_cdf_categorical():
    import jax
    import jax.numpy as jnp
    from insr_pde_tpu.geometry import mesh_ops

    def categorical(key, probs, n):
        cdf = jnp.cumsum(probs)
        u = jax.random.uniform(key, (n,), probs.dtype) * cdf[-1]
        idx = jnp.searchsorted(cdf, u, side="right")
        return jnp.minimum(idx, probs.shape[0] - 1)

    mesh_ops._categorical = categorical


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("kind", choices=["3d", "2d"])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4, 5])
    ap.add_argument("--out", required=True,
                    help="project directory of the runs")
    args = ap.parse_args(argv)

    import jax
    jax.config.update("jax_platforms", "cpu")
    import main as jax_main
    from insr_pde_tpu.geometry import statue_tet_mesh, write_medit

    flags = list(ELA_3D_ARGS if args.kind == "3d" else ELA_2D_ARGS)
    flags += ["--proj_dir", args.out]
    os.makedirs(args.out, exist_ok=True)
    if args.kind == "3d":
        # written whole under another name first: parallel seeds share it
        mesh = os.path.join(args.out, "statue.mesh")
        part = f"{mesh}.{os.getpid()}"
        V, T = statue_tet_mesh(ELA_MESH_N)
        write_medit(part, V, {"tetra": T})
        os.replace(part, mesh)
        flags += ["--mesh_path", mesh]
        _inverse_cdf_categorical()
    for seed in args.seeds:
        tag = f"{args.kind}_seed{seed}"
        jax_main.main(flags + ["--seed", str(seed), "--tag", tag])
        stats = run_stats(args.kind, os.path.join(args.out, tag))
        print(json.dumps({"seed": seed, "T": ELA_STEPS, "iters": ELA_ITERS,
                          "steps": stats}), flush=True)


if __name__ == "__main__":
    main()
