"""PyTorch port, entry points and package rules: `python -m insr_pde_tpu_torch
fluid --device cpu` writes the JAX package's outputs with every fluid
timestep option, and so do `advection` and `elasticity`; a merged2 run
resumes its trapezoidal chain from a checkpoint; `python -m insr_pde_tpu_torch vortex` (default and `--preset
channel`) solves, saves, resumes and writes its field;
`python -m insr_pde_tpu_torch.compare_fluid_tg` reports the
Taylor-Green golden; `--network hashgrid` runs advection and fluid refuses
it; the vortex stack's flags run, `--host_sync` included (a missing card
raises);
no module of the port (nor chip_smoke.py) imports JAX or
the JAX package."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from insr_pde_tpu_torch import __main__ as cli
from insr_pde_tpu_torch.ops import precision

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--init_cond", "taylorgreen",
        "--num_hidden_layers", "2", "--hidden_features", "8", "-sr", "8",
        "-vr", "8", "--max_n_iters", "20", "--chunk_size", "10",
        "--no_backup"]


def test_cli_writes_outputs(tmp_path):
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "insr_pde_tpu_torch", "fluid", *TINY,
         "-T", "1", "--proj_dir", str(tmp_path), "--tag", "cli"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    exp = tmp_path / "cli"
    for rel in ("results/t000.npy", "results/t001.npy",
                "results/t001_vel.png", "results/t001_mag.png",
                "results/t001_curl.png", "model/ckpt_step_t001.npz",
                "log/t001/scalars.jsonl", "config.json"):
        assert (exp / rel).exists(), rel
    assert np.load(exp / "results/t001.npy").shape == (8, 8, 2)
    with open(exp / "timings.jsonl") as f:
        assert [json.loads(line)["timestep"] for line in f] == [0, 1]
    with open(exp / "log/t001/scalars.jsonl") as f:
        tags = {json.loads(line)["tag"] for line in f}
    assert tags == {"advect_velocity", "solve_pressure", "projection"}


ADVECTION = ["advection", "--device", "cpu", "--init_cond", "example1",
             "--num_hidden_layers", "2", "--hidden_features", "8", "-sr",
             "64", "-vr", "32", "--dt", "0.05", "--max_n_iters", "20",
             "--chunk_size", "10", "--no_backup"]


def test_cli_advection_writes_outputs(tmp_path):
    """`python -m insr_pde_tpu_torch advection` with the flags of
    scripts/advect1D.sh at a tiny size: JAX's per-step .npz/.png, the
    checkpoints and logs; the advect phase through `advect_fit`'s plain
    version (the CPU)."""
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "insr_pde_tpu_torch", *ADVECTION, "-T", "2",
         "--proj_dir", str(tmp_path), "--tag", "adv"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    exp = tmp_path / "adv"
    for t in range(3):
        for rel in (f"results/t{t:03d}.npz", f"results/t{t:03d}.png",
                    f"model/ckpt_step_t{t:03d}.npz",
                    f"log/t{t:03d}/scalars.jsonl"):
            assert (exp / rel).exists(), rel
    u = np.load(exp / "results/t002.npz")["arr_0"]
    assert u.shape == (32,) and np.isfinite(u).all()
    with open(exp / "log/t002/scalars.jsonl") as f:
        assert {json.loads(line)["tag"] for line in f} == {"advect"}
    # resumes from its checkpoint
    model = cli.main(ADVECTION + ["-T", "3", "--proj_dir", str(tmp_path),
                                  "--tag", "adv", "--ckpt", "latest"])
    assert model.timestep == 3
    assert [r["tag"] for r in model.phase_timings] == ["advect"]


@pytest.mark.parametrize("extra", [["--network", "hashgrid"], []])
def test_cli_host_rng_draws_what_a_cpu_run_draws(tmp_path, extra):
    """`--host_rng` keeps the model's generator on the CPU (the draws of a
    --device cpu run, which on the card are then copied to it): here, on
    the CPU, the run's init, points and outputs are those of the run
    without it, bit for bit, for the hash grid and the fused SIREN fit."""
    out = []
    for tag, rng in (("plain", []), ("host", ["--host_rng"])):
        model = cli.main(ADVECTION + extra + rng + [
            "-T", "1", "--proj_dir", str(tmp_path), "--tag", tag])
        assert model.generator.device.type == "cpu"
        out.append(np.load(tmp_path / tag / "results" / "t001.npz")["arr_0"])
    assert model.cfg.host_rng
    np.testing.assert_array_equal(out[0], out[1])


def test_cli_resume_continues_after_checkpoint(tmp_path):
    args = ["fluid", *TINY, "--proj_dir", str(tmp_path), "--tag", "res"]
    cli.main(args + ["-T", "1"])
    model = cli.main(args + ["-T", "2", "--ckpt", "latest"])
    assert model.timestep == 2
    assert (tmp_path / "res/results/t002.npy").exists()


def test_cli_profile_dir_writes_trace(tmp_path):
    cli.main(["fluid", *TINY, "-T", "0", "--proj_dir", str(tmp_path),
              "--profile_dir", str(tmp_path / "prof")])
    with open(tmp_path / "prof" / "trace.json") as f:
        assert json.load(f)["traceEvents"]


SPLIT = ["advect_velocity", "solve_pressure", "projection"]


@pytest.mark.parametrize("extra,tags", [
    (["--fluid_step", "merged"], ["solve_pressure_merged", "project_advect"]),
    (["--fluid_step", "merged2", "--advect_trace", "rk2", "--advect_sobolev",
      "0.3"], ["solve_pressure_m2boot", "solve_pressure_merged2",
               "project_advect2"]),
    (["--advect_scheme", "maccormack", "--advect_sobolev", "0.5"], SPLIT),
    (["--advect_trace", "rk2"], SPLIT)])
def test_cli_runs_every_fluid_option(tmp_path, extra, tags):
    model = cli.main(["fluid", *TINY, *extra, "-T", "1", "--proj_dir",
                      str(tmp_path), "--tag", "opt"])
    exp = tmp_path / "opt"
    u = np.load(exp / "results/t001.npy")
    assert u.shape == (8, 8, 2) and np.isfinite(u).all()
    assert [r["tag"] for r in model.phase_timings[1:]] == tags
    with open(exp / "log/t001/scalars.jsonl") as f:
        assert {json.loads(line)["tag"] for line in f} == set(tags)


def test_cli_merged2_resume_continues_the_trapezoidal_chain(tmp_path):
    """The checkpoint carries q_old (`pressure_prev`): a resumed merged2
    run makes no second bootstrap solve."""
    args = ["fluid", *TINY, "--fluid_step", "merged2", "--advect_trace",
            "rk2", "--proj_dir", str(tmp_path), "--tag", "m2"]
    first = cli.main(args + ["-T", "1"])
    model = cli.main(args + ["-T", "2", "--ckpt", "latest"])
    assert model.timestep == 2
    assert [r["tag"] for r in model.phase_timings] == [
        "solve_pressure_merged2", "project_advect2"]
    # q_old is now the t=2 solve's pressure, no longer t=1's
    assert not torch.equal(model.fields["pressure_prev"][0][0],
                           first.fields["pressure"][0][0])
    for (w, b), (pw, pb) in zip(model.fields["pressure_prev"],
                                model.fields["pressure"]):
        assert torch.equal(w, pw) and torch.equal(b, pb)


def test_compare_fluid_tg_reports_every_timestep(capsys):
    from insr_pde_tpu_torch import compare_fluid_tg
    summary = compare_fluid_tg.main([
        "--device", "cpu", "--timesteps", "1", "--sr", "8", "--layers", "2",
        "--hidden", "8", "--iters", "30", "--eval_res", "16",
        "--fluid_step", "merged2", "--advect_trace", "rk2"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert [r["t"] for r in lines[:-1]] == [0, 1]
    assert lines[-1] == summary and summary["device"] == "cpu"
    assert all(0.0 < r["rel_l2"] < 2.0 and np.isfinite(r["amp"])
               for r in lines[:-1])
    assert summary["rel_l2_final"] == lines[1]["rel_l2"]


@pytest.mark.parametrize("extra", [
    ["advection", "--network", "hashgrid"],
    ["fluid", "--network", "hashgrid"]])
def test_unported_paths_raise(tmp_path, extra):
    """`--network hashgrid` was refused everywhere before the hash grid was
    ported. Now advection runs it (the generic Solver, no fused fit) and
    fluid raises the JAX package's ValueError (a piecewise-linear field has
    no Laplacian for the pressure solve), before anything is written."""
    argv = extra + TINY + ["--proj_dir", str(tmp_path), "--tag", "run"]
    if extra[0] == "fluid":
        with pytest.raises(ValueError, match="second derivatives"):
            cli.main(argv)
        assert not (tmp_path / "run" / "results" / "t000.npy").exists()
        return
    argv = extra + ADVECTION[1:] + ["-T", "1", "--proj_dir", str(tmp_path),
                                    "--tag", "run"]
    model = cli.main(argv)
    assert type(model.net).__name__ == "HashGridField"
    assert model.advect_solver is None
    for t in (0, 1):
        u = np.load(tmp_path / "run" / "results" / f"t{t:03d}.npz")["arr_0"]
        assert u.shape == (32,) and np.isfinite(u).all()


def test_cli_elasticity_writes_outputs(tmp_path):
    """`python -m insr_pde_tpu_torch elasticity --device cpu` (the 2D box
    scene's defaults at a tiny size): the per-step points, checkpoints and
    the solve phase's log."""
    model = cli.main(["elasticity", "--device", "cpu", "--num_hidden_layers",
                      "2", "--hidden_features", "8", "-sr", "6",
                      "--sample_resolution_init", "6", "-vr", "6", "-T", "1",
                      "--max_n_iters", "20", "--chunk_size", "10",
                      "--no_backup", "--proj_dir", str(tmp_path), "--tag",
                      "ela"])
    exp = tmp_path / "ela"
    for rel in ("results/t001_deformation.ply",
                "results/t001_deformation.npy", "model/ckpt_step_t001.npz",
                "config.json", "timings.jsonl"):
        assert (exp / rel).exists(), rel
    pts = np.load(exp / "results/t001_deformation.npy")
    assert pts.shape == (36 + 12, 2) and np.isfinite(pts).all()
    with open(exp / "log/t001/scalars.jsonl") as f:
        assert {json.loads(line)["tag"] for line in f} == {
            "solve_deformation"}
    assert model.energy == ["arap", "kinematics", "external", "constraint"]


def test_cuda_without_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        precision.resolve_device("cuda")
    assert precision.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["vortex", *VORTEX[3:], "--output_path", str(tmp_path)])
    assert not (tmp_path / "field.npy").exists()
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["elasticity", "--proj_dir", str(tmp_path)])
    assert not (tmp_path / "run").exists()


VORTEX = ["vortex", "--device", "cpu", "--collocation", "40",
          "--boundary", "16", "--time_num", "3", "--n_spatial_basis", "16",
          "--cgls_maxiter", "30", "--picard_iters", "2", "--rho", "1",
          "--internal_v", "1"]


def test_cli_vortex_writes_outputs_and_resumes(tmp_path):
    """`python -m insr_pde_tpu_torch vortex` at starterL.py's defaults but
    for the size: the field (T, 100^2, 3), the checkpoint, the log; then a
    resumed round from the checkpoint in-process."""
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    out = tmp_path / "v"
    proc = subprocess.run(
        [sys.executable, "-m", "insr_pde_tpu_torch", *VORTEX,
         "--output_path", str(out), "--log_dir", str(tmp_path / "log")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "lstsq residual" in proc.stdout
    field = np.load(out / "field.npy")
    assert field.shape == (3, 100 * 100, 3) and np.isfinite(field).all()
    assert (out / "vortex_ckpt.npz").exists()
    assert (tmp_path / "log" / "scalars.jsonl").exists()
    model = cli.main(VORTEX + ["--output_path", str(tmp_path / "r"),
                               "--log_dir", str(tmp_path / "log2"),
                               "--resume", str(out / "vortex_ckpt.npz"),
                               "--picard_iters", "1", "--ckpt_path", "none"])
    assert model.cfg.picard_iters == 1 and model._picard_seen == 1
    assert not (tmp_path / "r" / "vortex_ckpt.npz").exists()


def test_cli_vortex_channel_preset(tmp_path):
    """--preset channel: the stream model with the preset's options, each
    overridable by a flag."""
    model = cli.main(VORTEX + ["--preset", "channel", "--collocation", "48",
                               "--output_path", str(tmp_path),
                               "--log_dir", str(tmp_path / "log")])
    cfg = model.cfg
    assert type(model).__name__ == "StreamVortexModel"
    assert (cfg.pou, cfg.pou_time, cfg.time_window, cfg.stream_bc) == (
        "smooth", "simple", 1, "both")
    assert (cfg.cgls_precondition, cfg.cgls_chunk, cfg.cgls_restart,
            cfg.reuse_whitener, cfg.warm_start) == ("block", 200, True, True,
                                                    1.0)
    assert (cfg.collocation_pts_num, cfg.boundary_num, cfg.band_width,
            cfg.w_bc, cfg.n_variables) == (48, 16, 1.0, 5.0, 2)
    assert np.isfinite(np.load(tmp_path / "field.npy")).all()
    assert len(model.picard_timings) == 2


@pytest.mark.parametrize("flag", [["--mode", "train"], ["--solver", "cg"],
                                  ["--rmv_gather"], ["--packed_vals"],
                                  ["--host_sync"]])
def test_cli_vortex_unported_flags_raise(tmp_path, flag):
    """The five flags of the vortex stack that raised before they were
    ported now run on the tiny config: `--mode train` prints the train
    loss, `--solver cg`, the two layouts and `--host_sync` (the system's
    round trip through host memory, recorded as `host_shipped`) the lstsq
    residual, each writing the field and checkpoint."""
    out = tmp_path / "out"
    argv = VORTEX + flag + ["--output_path", str(out), "--log_dir",
                            str(tmp_path / "log")]
    if flag == ["--rmv_gather"]:
        argv += ["--cgls_chunk", "10"]
    model = cli.main(argv)
    if flag == ["--mode", "train"]:
        assert model._step == 200 and not hasattr(model, "picard_timings")
    else:
        assert len(model.picard_timings) == 2
        assert all(t["host_shipped"] == (flag == ["--host_sync"])
                   for t in model.picard_timings)
    assert np.isfinite(np.load(out / "field.npy")).all()
    assert (out / "vortex_ckpt.npz").exists()


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, in a fresh interpreter:
    neither jax nor insr_pde_tpu may end up in sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import insr_pde_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "'insr_pde_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'jaxlib' or m == 'insr_pde_tpu' or "
        "m.startswith('insr_pde_tpu.')]\n"
        "assert not bad, bad\n"
        "assert 'insr_pde_tpu_torch.models.fluid' in names\n"
        "assert 'insr_pde_tpu_torch.models.advection' in names\n"
        "assert 'insr_pde_tpu_torch.ops.advect_fit' in names\n"
        "for n in ('ops.knn', 'ops.block_ell', 'ops.linalg', 'models.rbf',\n"
        "          'models.vortex', 'starterL', 'ops.svd', 'geometry',\n"
        "          'geometry.mesh_io', 'geometry.mesh_ops',\n"
        "          'geometry.procedural', 'models.elast_losses',\n"
        "          'models.elasticity', 'utils.io', 'recap',\n"
        "          'models.encodings', 'models.rbf_advection',\n"
        "          'parallel', 'parallel.mesh', 'run_experiments',\n"
        "          'vortex_truth', 'vortex_sweep'):\n"
        "    assert 'insr_pde_tpu_torch.' + n in names, n\n"
        "print(len(names))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.strip()) >= 30
