"""The paper-experiment matrix through the port's entry points (counterpart
of `tools/run_experiments.py`): the eight published configurations
(`scripts/*.sh`) plus the vortex channel scene.

    python -m insr_pde_tpu_torch.run_experiments [--smoke | --full]
        [--only NAME,NAME] [--proj_dir DIR] [--device cpu]

`--smoke` (the default) shrinks iterations, resolutions and horizons so
that the whole matrix finishes in minutes (structure and finite numbers);
`--full` passes the published flags verbatim (hours; run one experiment at
a time). The 3D mesh experiments run on the procedural box tet mesh unless
MESH_PATH names a MEDIT file (the reference's bunny and spot meshes load
unmodified).

Each experiment prints one JSON line, {name: {"ok", "outputs", "wall_s"}}
or {name: {"ok": false, "error"}}; the matrix goes on past a failed
experiment so that all of them are reported, then prints the summary line
and exits 1 if any experiment failed (0 if all are ok).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

NAMES = ("advect1D", "fluid2Dtlgn", "fluid2DtlgnM", "elasticity2Dstretch",
         "elasticity2Dcollide", "elasticity3Dbunny", "elasticity3Dspot",
         "elasticity3Dlucy", "vortex_channel")


def _write_box_mesh(path):
    from .geometry import box_tet_mesh, write_medit
    V, T = box_tet_mesh(3)
    write_medit(path, V, {"tetra": T})


def experiment_args(tmp, smoke: bool):
    """name -> argv of the nine experiments: the eight reference scripts
    and the vortex channel (argv of `starterL`, without `vortex`)."""
    mesh = os.environ.get("MESH_PATH")
    if not mesh:
        mesh = os.path.join(tmp, "box.mesh")
        _write_box_mesh(mesh)

    def shrink(args, iters, sr=None, T=None):
        if not smoke:
            return args
        out = list(args)

        def set_flag(flag, val):
            out[out.index(flag) + 1] = str(val)

        set_flag("--max_n_iters", iters)
        if sr is not None:
            set_flag("-sr", sr)
        if T is not None:
            set_flag("-T", T)
        return out

    ela3d_common = [
        "-sr", "20", "-vr", "2000", "-T", "20", "--dt", "0.1",
        "--max_n_iters", "20000", "--lr", "1e-4", "--dim", "3",
        "--energy", "arap", "kinematics", "collision", "external", "volume",
        "--ratio_volume", "1e3", "--ratio_collide", "1e6",
        "--ratio_kinematics", "1e0", "-f_ext_x", "0", "-f_ext_y", "0",
        "--plane_height", "-2", "--use_mesh", "1", "--mesh_path", mesh,
        "--sample_resolution_init", "8",
    ]
    return {
        "advect1D": shrink(
            ["advection", "--init_cond", "example1",
             "--num_hidden_layers", "2", "--hidden_features", "20",
             "-sr", "5000", "--dt", "0.05", "-T", "240",
             "--max_n_iters", "20000"], 300, sr=1000, T=2),
        "fluid2Dtlgn": shrink(
            ["fluid", "--init_cond", "taylorgreen",
             "--num_hidden_layers", "3", "--hidden_features", "32",
             "-sr", "128", "-vr", "32", "--dt", "0.05", "-T", "100",
             "--max_n_iters", "20000"], 200, sr=24, T=1),
        "fluid2DtlgnM": shrink(
            ["fluid", "--init_cond", "taylorgreen_multi",
             "--num_hidden_layers", "3", "--hidden_features", "32",
             "-sr", "128", "-vr", "32", "--dt", "0.05", "-T", "100",
             "--max_n_iters", "20000"], 200, sr=24, T=1),
        "elasticity2Dstretch": shrink(
            ["elasticity", "--num_hidden_layers", "3",
             "--hidden_features", "68", "-sr", "100", "-vr", "100",
             "-T", "1", "--max_n_iters", "100000", "--lr", "1e-4",
             "--dim", "2", "--energy", "arap", "constraint",
             "constraint_right", "volume", "--ratio_volume", "1e3",
             "--ratio_arap", "1e0", "--ratio_constraint", "1e4",
             "--constraint_right_offset_x", "2.0",
             "--sample_resolution_init", "20"], 300, sr=8, T=1),
        "elasticity2Dcollide": shrink(
            ["elasticity", "--num_hidden_layers", "3",
             "--hidden_features", "68", "-sr", "100", "-vr", "100",
             "-T", "20", "--dt", "0.1", "--max_n_iters", "20000",
             "--lr", "1e-5", "--dim", "2", "--energy", "arap", "kinematics",
             "collision_sphere", "external", "volume",
             "--ratio_volume", "1e3", "--ratio_arap", "2e1",
             "--ratio_collide", "1e4", "--ratio_kinematics", "1e1",
             "-f_ext_x", "0", "-f_ext_y=-2e2", "-T_ext", "2",
             "--sample_resolution_init", "20"], 300, sr=8, T=2),
        "elasticity3Dbunny": shrink(
            ["elasticity", "--num_hidden_layers", "3",
             "--hidden_features", "66", "--ratio_arap", "1e2",
             "-f_ext_z=-1e2", "-T_ext", "5"] + ela3d_common,
            200, sr=4, T=2),
        "elasticity3Dspot": shrink(
            ["elasticity", "--num_hidden_layers", "3",
             "--hidden_features", "66", "--ratio_arap", "1e2",
             "-f_ext_z=-1e2", "-T_ext", "5"] + ela3d_common,
            200, sr=4, T=2),
        "elasticity3Dlucy": shrink(
            ["elasticity", "--num_hidden_layers", "3",
             "--hidden_features", "128", "--ratio_arap", "1e3",
             "-f_ext_z=-2e1", "-T_ext", "10"] + ela3d_common,
            200, sr=4, T=2),
        # the vortex channel scene through starterL (the channel preset,
        # the JAX package's fix of the scene); its argv has no `vortex`
        "vortex_channel": (
            ["--preset", "channel", "--picard_iters", "1",
             "--n_spatial_basis", "36", "--time_num", "3",
             "--collocation", "300", "--boundary", "120",
             "--cgls_maxiter", "300", "--cgls_chunk", "150",
             "--rho", "1.0", "--internal_v", "1.0"] if smoke else
            ["--preset", "channel", "--picard_iters", "3"]),
    }


def _run_vortex(argv, out_dir):
    from .starterL import main as vortex_main
    vortex_main(argv)
    field = np.load(os.path.join(out_dir, "field.npy"))
    return bool(np.isfinite(field).all()), len(os.listdir(out_dir))


def _run_pde(argv, exp_dir):
    """One experiment through the entry point; (the last checkpoint is
    finite, the number of result files)."""
    from .__main__ import main as port_main
    port_main(argv)
    n_out = len(os.listdir(os.path.join(exp_dir, "results")))
    model_dir = os.path.join(exp_dir, "model")
    last = sorted(os.listdir(model_dir))[-1]
    ck = np.load(os.path.join(model_dir, last))
    finite = all(np.isfinite(ck[k]).all() for k in ck.files
                 if not k.startswith("__meta__"))
    return bool(finite), n_out


def run(names, experiments, proj, tmp, device):
    """Run each named experiment; returns name -> result record."""
    results = {}
    for name in names:
        if name == "vortex_channel":
            out_dir = os.path.join(proj, name)
            argv = experiments[name] + [
                "--output_path", out_dir, "--device", device,
                "--log_dir", os.path.join(tmp, "vortex_log")]
            fn, where = _run_vortex, out_dir
        else:
            argv = experiments[name] + [
                "--tag", name, "--proj_dir", proj, "--no_backup",
                "--vis_frequency", "1000000000", "--device", device]
            fn, where = _run_pde, os.path.join(proj, name)
        t0 = time.perf_counter()
        try:
            ok, n_out = fn(argv, where)
            results[name] = {"ok": ok, "outputs": n_out,
                             "wall_s": round(time.perf_counter() - t0, 1)}
        except (Exception, SystemExit) as e:  # report it, run the rest
            results[name] = {"ok": False, "error": repr(e)[:200]}
        print(json.dumps({name: results[name]}), flush=True)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("insr_pde_tpu_torch.run_experiments")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--only", type=str, default=None,
                    help="comma-separated experiment names")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--proj_dir", type=str, default=None)
    args = ap.parse_args(argv)

    names = args.only.split(",") if args.only else list(NAMES)
    unknown = sorted(set(names) - set(NAMES))
    if unknown:
        ap.error(f"unknown experiments {unknown}; known: {', '.join(NAMES)}")
    with tempfile.TemporaryDirectory() as tmp:
        proj = args.proj_dir or os.path.join(tmp, "exp")
        results = run(names, experiment_args(tmp, args.smoke), proj, tmp,
                      args.device)
    n_ok = sum(1 for r in results.values() if r["ok"])
    print(json.dumps({"summary": f"{n_ok}/{len(results)} experiments ok"}),
          flush=True)
    return 0 if n_ok == len(results) else 1


if __name__ == "__main__":
    sys.exit(main())
