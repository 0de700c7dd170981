"""PyTorch port, entry point and package rules: `python -m insr_pde_tpu_torch
fluid --device cpu` writes the JAX package's outputs; the unported options
and a missing card raise; no module of the port (nor chip_smoke.py) imports
JAX or the JAX package."""

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


@pytest.mark.parametrize("extra", [
    ["advection"], ["elasticity"],
    ["fluid", "--fluid_step", "merged2"],
    ["fluid", "--advect_scheme", "maccormack"],
    ["fluid", "--advect_trace", "rk2"],
    ["fluid", "--advect_sobolev", "0.5"],
    ["fluid", "--network", "hashgrid"]])
def test_unported_paths_raise(tmp_path, extra):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cli.main(extra + TINY + ["--proj_dir", str(tmp_path)])
    assert not (tmp_path / "run").exists()


def test_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        precision.resolve_device("cuda")
    assert precision.resolve_device("cpu") == torch.device("cpu")


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
        "print(len(names))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.strip()) >= 15
