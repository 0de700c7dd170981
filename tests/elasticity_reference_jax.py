"""The JAX package's elasticity runs that set the bars of the port's chip
check (`chip_smoke.py`, phases `elasticity3D`, `elasticity2D` and
`paper_matrix`), on the CPU.

    python tests/elasticity_reference_jax.py 3d --seeds 0 1 2 --out DIR
    python -m insr_pde_tpu_torch.elasticity_stats 3d DIR/3d_seed*
    python tests/elasticity_reference_jax.py paired SCENE [--out DIR]

Paired mode (SCENE one of PAIRED): the port on the CPU with the flags the
chip check gives it (`--host_rng`, so that a card run draws the same
points), each draw of `sample_mesh` and `sample_random` recorded; then the
JAX package's `main.py elasticity` on the same flags, started from the
port's init and output points, its draws answered with the port's through
an ordered `io_callback` (`vortex_hashgrid_reference_jax.run_on_port_draws`;
the grids are deterministic and stay the JAX package's). It prints one JSON
object: per package the Adam iterations of each fit and the per-t
statistics, and the largest |port - JAX| of the final fields' parameters,
and writes it to DIR/SCENE.json when `--out` is given.

Seed mode:

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
    ELA_2D_ARGS, ELA_3D_ARGS, ELA_ITERS, ELA_MESH_N, ELA_STEPS, PAPER_MESH_N,
    paper_args)
from insr_pde_tpu_torch.elasticity_stats import run_stats  # noqa: E402

# paired scenes: chip_smoke phase -> (flags without the mesh, statistics
# kind, statue_tet_mesh size or None)
PAIRED = {
    "elasticity3D": (ELA_3D_ARGS, "3d", ELA_MESH_N),
    "elasticity2D": (ELA_2D_ARGS, "2d", None),
    "elasticity2Dstretch": (paper_args("elasticity2Dstretch"), "stretch",
                            None),
    "elasticity3Dbunny": (paper_args("elasticity3Dbunny"), "3d",
                          PAPER_MESH_N["elasticity3Dbunny"]),
    "elasticity3Dspot": (paper_args("elasticity3Dspot"), "3d",
                         PAPER_MESH_N["elasticity3Dspot"]),
}
_CONSTRAINTS = {"constraint", "constraint_right", "constraint_right_compress"}
# the elasticity samplers (insr_pde_tpu_torch/models/elasticity.py,
# insr_pde_tpu/models/elasticity.py): volume points of a mesh, and the
# box's points and face coordinates
SAMPLERS = {
    "sample_mesh": (lambda V, F, n, distrib=None: "mesh",
                    lambda V, F, n, distrib=None: (n, 3)),
    "sample_random": (lambda n, sdim=1: f"random{sdim}",
                      lambda n, sdim=1: (n, sdim)),
}


def _faces_unread(jm):
    """The JAX loss draws the box's face points in every step iteration;
    the port draws them only where a constraint term reads them. Where
    none does, the JAX model's draw (unread) is left out."""
    if not _CONSTRAINTS & set(jm.energy):
        jm._sample_fixed_in_training = lambda key: (None, None)


def paired(flags, kind, out_dir):
    """The elasticity scene `flags` on the port's draws: per package the
    iterations of each fit and the per-t statistics (`kind`), and the
    largest |port - JAX| of the final fields' parameters."""
    from insr_pde_tpu.models import elasticity as jela
    from insr_pde_tpu_torch.models import elasticity as tela
    from vortex_hashgrid_reference_jax import (param_max_abs_diff,
                                               run_on_port_draws)
    port, jm, port_iters, jax_iters = run_on_port_draws(
        flags, tela, jela, SAMPLERS, out_dir, adjust=_faces_unread)
    return {"port_cpu": {"iters": port_iters,
                         "stats": run_stats(kind, os.path.join(out_dir,
                                                               "port"))},
            "jax": {"iters": jax_iters,
                    "stats": run_stats(kind, os.path.join(out_dir, "jax"))},
            "param_max_abs_diff": param_max_abs_diff(port.fields,
                                                     jm.fields)}


def run_paired(scene, out=None):
    import tempfile
    from insr_pde_tpu_torch.geometry import statue_tet_mesh, write_medit
    flags, kind, mesh_n = PAIRED[scene]
    work = tempfile.mkdtemp(prefix=f"{scene}_paired_")
    flags = list(flags)
    if mesh_n is not None:
        mesh = os.path.join(work, "statue.mesh")
        V, T = statue_tet_mesh(mesh_n)
        write_medit(mesh, V, {"tetra": T})
        if "--mesh_path" in flags:
            flags[flags.index("--mesh_path") + 1] = mesh
        else:
            flags += ["--mesh_path", mesh]
    rec = {"scene": scene, **paired(flags, kind, work)}
    if out:
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, f"{scene}.json"), "w") as f:
            json.dump(rec, f)
    print(json.dumps(rec), flush=True)
    return rec


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
    ap.add_argument("kind", choices=["3d", "2d", "paired"])
    ap.add_argument("scene", nargs="?", choices=sorted(PAIRED),
                    help="paired mode: the chip check's phase")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4, 5])
    ap.add_argument("--out", default=None,
                    help="project directory of the runs (seed mode), or "
                         "where SCENE.json goes (paired mode)")
    args = ap.parse_args(argv)

    os.environ.setdefault("INSR_NO_COMPILATION_CACHE", "1")
    import jax
    jax.config.update("jax_platforms", "cpu")
    if args.kind == "paired":
        import torch
        torch.set_num_threads(1)
        if args.scene is None:
            ap.error("paired mode needs a SCENE")
        run_paired(args.scene, args.out)
        return
    if args.out is None:
        ap.error("seed mode needs --out")
    import main as jax_main
    from insr_pde_tpu.geometry import statue_tet_mesh, write_medit

    # --host_rng is a port option: the JAX package draws on its device
    flags = [a for a in (ELA_3D_ARGS if args.kind == "3d" else ELA_2D_ARGS)
             if a != "--host_rng"]
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
