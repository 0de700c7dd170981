"""What the paired elasticity bars of chip_smoke.py catch, on one card.

    python3 scripts/torch_paired_mutations.py [SCENE ...]

Each scene of chip_smoke's paired elasticity checks (elasticity3D,
elasticity2D, elasticity2Dstretch, elasticity3Dbunny, elasticity3Dspot;
all by default) runs through the port's entry point once per mutation of
its energy: the contact term dropped (`collision` or `collision_sphere`),
the right face's constraint dropped (`constraint_right`), and the ARAP
weight halved (`--ratio_arap`), each where the scene has it. A mutation is
made by the flags alone, the same as deleting the term or halving the
weight in the code. Each run's statistics are held to the JAX package's
run on the unmutated scene's draws with chip_smoke's bars
(`_against_paired`'s ELA_*_PAIRED / PAPER_PAIRED and PAIRED_BARS), and the
script prints, per mutation, the first bar it misses (caught) or that it
meets them all (missed). It raises nothing for a miss: it measures the
bars. Exits 1 if a scene could not run.
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

CONTACT = ("collision", "collision_sphere")


def scene_args(scene):
    """(flags, dim, statistics kind, the JAX reference) of one scene; the
    3D meshes are written under checkpoints/."""
    from insr_pde_tpu_torch.geometry import statue_tet_mesh, write_medit
    mesh_n = {"elasticity3D": cs.ELA_MESH_N, **cs.PAPER_MESH_N}.get(scene)
    mesh = None
    if mesh_n is not None:
        mesh = os.path.join(REPO, "checkpoints", "chip_smoke",
                            f"statue{mesh_n}.mesh")
        os.makedirs(os.path.dirname(mesh), exist_ok=True)
        V, T = statue_tet_mesh(mesh_n)
        write_medit(mesh, V, {"tetra": T})
    if scene == "elasticity3D":
        return (cs.ELA_3D_ARGS + ["--mesh_path", mesh], 3, "3d",
                cs.ELA_3D_PAIRED)
    if scene == "elasticity2D":
        return cs.ELA_2D_ARGS, 2, "2d", cs.ELA_2D_PAIRED
    kind = "stretch" if scene == "elasticity2Dstretch" else "3d"
    return (cs.paper_args(scene, mesh), 3 if mesh else 2, kind,
            cs.PAPER_PAIRED[scene])


def mutations(args):
    """name -> the mutated flags, for each mutation the scene admits."""
    out = {}
    i = args.index("--energy") + 1
    j = i
    while j < len(args) and not args[j].startswith("-"):
        j += 1
    energy = args[i:j]
    for term in energy:
        if term in CONTACT or term == "constraint_right":
            kept = [e for e in energy if e != term]
            out[f"drop {term}"] = args[:i] + kept + args[j:]
    k = args.index("--ratio_arap") + 1
    halved = list(args)
    halved[k] = repr(float(args[k]) / 2)
    out["ratio_arap halved"] = halved
    return out


def run(scene):
    args, dim, kind, ref = scene_args(scene)
    steps = int(args[args.index("-T") + 1])
    for name, mutated in mutations(args).items():
        tag = f"{scene}_mut"
        counts, model, exp_dir = cs._ela_run(tag, mutated, dim, steps)
        stats = cs._ela_stats(kind, exp_dir)
        try:
            cs._against_paired(tag, model, stats, ref, cs.PAIRED_BARS[scene])
            verdict = "MISSED: every paired bar met"
        except RuntimeError as e:
            verdict = f"caught: {e}"
        print(f"[mutation] {scene} {name}: {verdict}", flush=True)


def main(argv=None):
    scenes = ["elasticity3D", "elasticity2D", "elasticity2Dstretch",
              "elasticity3Dbunny", "elasticity3Dspot"]
    ap = argparse.ArgumentParser()
    ap.add_argument("scenes", nargs="*", help=f"of {scenes}; default all")
    args = ap.parse_args(argv)
    unknown = sorted(set(args.scenes) - set(scenes))
    if unknown:
        ap.error(f"unknown scenes {unknown}")
    cs.phase_device()
    from insr_pde_tpu_torch.ops.precision import set_full_precision
    set_full_precision()
    cs.phase_build()
    failed = 0
    for scene in args.scenes or scenes:
        try:
            run(scene)
        except Exception as e:  # report it, measure the other scenes
            failed += 1
            print(f"[mutation] {scene}: could not run: {e!r}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
