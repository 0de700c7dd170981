"""PyTorch port, `python -m insr_pde_tpu_torch.recap`: a tiny run of each
INSR model re-rendered from its checkpoints gives the training run's
outputs again (elasticity's PLY byte for byte, the fields' arrays bit for
bit), recap stops at the first missing checkpoint, keeps its CLI `-vr`, and
`recap vortex` re-renders a vortex checkpoint's slices."""

import os

import numpy as np
import pytest
import torch

from insr_pde_tpu_torch import __main__ as cli
from insr_pde_tpu_torch import recap

torch.set_num_threads(1)

COMMON = ["--device", "cpu", "--num_hidden_layers", "2", "--hidden_features",
          "8", "--max_n_iters", "20", "--chunk_size", "10", "--no_backup"]
RUNS = {
    "fluid": (["fluid", "--init_cond", "taylorgreen", "-sr", "8"], "8",
              ".npy"),
    "advection": (["advection", "--init_cond", "example1", "-sr", "64",
                   "--dt", "0.05"], "32", ".npz"),
    "elasticity": (["elasticity", "-sr", "6", "--sample_resolution_init",
                    "6", "--dt", "0.1", "--energy", "arap", "kinematics",
                    "external", "volume", "collision_sphere",
                    "-f_ext_y=-100"], "10", "_deformation.ply"),
}


def _arrays(path):
    if path.endswith(".npz"):
        with np.load(path) as data:
            return {k: data[k] for k in data.files}
    if path.endswith(".npy"):
        return {"": np.load(path)}
    with open(path, "rb") as f:
        return {"": f.read()}


@pytest.mark.parametrize("pde", list(RUNS))
def test_recap_re_renders_the_training_outputs(tmp_path, pde):
    args, vr, suffix = RUNS[pde]
    cli.main(args + COMMON + ["-T", "2", "-vr", vr, "--proj_dir",
                              str(tmp_path), "--tag", "r"])
    model = recap.main([pde, "--proj_dir", str(tmp_path), "--tag", "r",
                        "-vr", vr])
    assert model.timestep == 2 and model.cfg.device == "cpu"
    exp = tmp_path / "r"
    for t in range(3):
        name = f"t{t:03d}{suffix}"
        got = _arrays(str(exp / "recap" / name))
        ref = _arrays(str(exp / "results" / name))
        assert got.keys() == ref.keys()
        for k in ref:
            if isinstance(ref[k], bytes):
                assert got[k] == ref[k], name
            else:
                np.testing.assert_array_equal(got[k], ref[k])
    if pde == "elasticity":
        for t in range(3):
            np.testing.assert_array_equal(
                np.load(exp / "recap" / f"t{t:03d}_deformation.npy"),
                np.load(exp / "results" / f"t{t:03d}_deformation.npy"))


def test_recap_stops_at_a_missing_checkpoint_and_keeps_its_vr(tmp_path,
                                                              capsys):
    args, _, _ = RUNS["elasticity"]
    cli.main(args + COMMON + ["-T", "2", "-vr", "10", "--proj_dir",
                              str(tmp_path), "--tag", "r"])
    os.remove(tmp_path / "r" / "model" / "ckpt_step_t002.npz")
    model = recap.main(["elasticity", "--proj_dir", str(tmp_path), "--tag",
                        "r", "-vr", "6", "-o", "again"])
    assert "timestep 2 not found" in capsys.readouterr().out
    out = tmp_path / "r" / "again"
    assert sorted(p.name for p in out.glob("*.npy")) == [
        "t000_deformation.npy", "t001_deformation.npy"]
    # -vr 6: a 6 x 6 grid and its two faces
    assert np.load(out / "t001_deformation.npy").shape == (36 + 12, 2)
    assert model.cfg.sample_resolution == 6


def test_recap_of_a_missing_run_raises(tmp_path):
    with pytest.raises(RuntimeError, match="not found"):
        recap.main(["elasticity", "--proj_dir", str(tmp_path), "--tag", "x"])


VORTEX = ["vortex", "--device", "cpu", "--collocation", "40",
          "--boundary", "16", "--time_num", "3", "--n_spatial_basis", "16",
          "--cgls_maxiter", "30", "--picard_iters", "1", "--rho", "1",
          "--internal_v", "1"]


@pytest.mark.parametrize("preset", [[], ["--preset", "channel"]])
def test_recap_vortex_re_renders_the_slices(tmp_path, preset):
    """The basis is drawn anew from the checkpoint's config: the same field
    as the solve wrote, on the checkpoint's grid and at another -vr."""
    out = tmp_path / "v"
    cli.main(VORTEX + preset + ["--output_path", str(out), "--log_dir",
                                str(tmp_path / "log")])
    ckpt = str(out / "vortex_ckpt.npz")
    model = recap.main(["vortex", "--ckpt", ckpt, "--device", "cpu"])
    np.testing.assert_allclose(np.load(out / "recap" / "field.npy"),
                               np.load(out / "field.npy"), rtol=1e-6,
                               atol=1e-6)
    assert model.device == torch.device("cpu")
    recap.main(["vortex", "--ckpt", ckpt, "--device", "cpu", "-vr", "7",
                "-o", str(tmp_path / "abs")])
    field = np.load(tmp_path / "abs" / "field.npy")
    assert field.shape[:2] == (3, 49) and np.isfinite(field).all()


def test_recap_re_renders_a_hashgrid_advection_run(tmp_path):
    """`recap advection` of a `--network hashgrid` run: the tables and head
    come back from each checkpoint and give the training outputs' bits."""
    args, vr, _ = RUNS["advection"]
    cli.main(args + COMMON + ["--network", "hashgrid", "-T", "2", "-vr", vr,
                              "--proj_dir", str(tmp_path), "--tag", "h"])
    model = recap.main(["advection", "--proj_dir", str(tmp_path), "--tag",
                        "h", "-vr", vr])
    assert type(model.net).__name__ == "HashGridField"
    exp = tmp_path / "h"
    for t in range(3):
        got = _arrays(str(exp / "recap" / f"t{t:03d}.npz"))
        ref = _arrays(str(exp / "results" / f"t{t:03d}.npz"))
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k])
