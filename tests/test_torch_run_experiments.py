"""PyTorch port, the paper-experiment matrix (`run_experiments`) against
the JAX package's `tools/run_experiments.py`: the same nine experiments
with the same flags, a smoke run of two of them through the port's entry
points on the CPU, and a failed experiment reported as such with exit
code 1."""

import json
import os

import numpy as np
import pytest
import torch

from insr_pde_tpu_torch import run_experiments
from tools import run_experiments as jax_tool

torch.set_num_threads(1)


def _without_mesh(argv):
    out = list(argv)
    if "--mesh_path" in out:
        out[out.index("--mesh_path") + 1] = "MESH"
    return out


@pytest.mark.parametrize("smoke", [True, False])
def test_experiment_args_equal_the_jax_tool(tmp_path, monkeypatch, smoke):
    monkeypatch.delenv("MESH_PATH", raising=False)
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    port = run_experiments.experiment_args(str(tmp_path / "port"), smoke)
    ref = jax_tool.experiment_args(str(tmp_path / "jax"), smoke)
    assert list(port) == list(ref) == list(run_experiments.NAMES)
    for name in ref:
        assert _without_mesh(port[name]) == _without_mesh(ref[name]), name
    # the port's box mesh is a MEDIT file of box_tet_mesh(3)
    from insr_pde_tpu_torch.geometry import read_mesh
    mesh = read_mesh(str(tmp_path / "port" / "box.mesh"))
    assert mesh.points.shape == (64, 3)


def test_mesh_path_comes_from_the_environment(tmp_path, monkeypatch):
    monkeypatch.setenv("MESH_PATH", "/data/bunny.mesh")
    args = run_experiments.experiment_args(str(tmp_path), smoke=False)
    assert args["elasticity3Dbunny"][
        args["elasticity3Dbunny"].index("--mesh_path") + 1] == \
        "/data/bunny.mesh"
    assert not (tmp_path / "box.mesh").exists()


def test_smoke_runs_two_experiments(tmp_path, capsys):
    rc = run_experiments.main(["--smoke", "--only",
                               "advect1D,elasticity2Dstretch", "--device",
                               "cpu", "--proj_dir", str(tmp_path)])
    lines = [json.loads(line) for line in
             capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert rc == 0
    results = {k: v for rec in lines for k, v in rec.items()}
    assert results["summary"] == "2/2 experiments ok"
    for name in ("advect1D", "elasticity2Dstretch"):
        assert results[name]["ok"] and results[name]["outputs"] > 0
        model_dir = tmp_path / name / "model"
        last = sorted(os.listdir(model_dir))[-1]
        ck = np.load(model_dir / last)
        assert all(np.isfinite(ck[k]).all() for k in ck.files)


def test_a_failed_experiment_is_reported_and_exits_1(tmp_path, capsys,
                                                      monkeypatch):
    from insr_pde_tpu_torch import __main__ as port_cli

    def broken(argv):
        raise RuntimeError("the entry point failed")

    monkeypatch.setattr(port_cli, "main", broken)
    rc = run_experiments.main(["--smoke", "--only", "fluid2Dtlgn",
                               "--device", "cpu", "--proj_dir",
                               str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 1
    rec = json.loads(out.splitlines()[0])["fluid2Dtlgn"]
    assert rec["ok"] is False and "the entry point failed" in rec["error"]
    assert '"0/1 experiments ok"' in out


def test_an_unknown_experiment_is_refused():
    with pytest.raises(SystemExit):
        run_experiments.main(["--only", "advect2D", "--device", "cpu"])
