"""PyTorch port against the JAX package on the port's own draws, through
both entry points: the paired runs behind `chip_smoke.py`'s elasticity
and multi-scale Taylor-Green bars (`tests/elasticity_reference_jax.py
paired`, `tests/vortex_hashgrid_reference_jax.py tlgnM`), at a tiny size.

The port runs on the CPU with the chip check's flags cut to 3x16, -sr 8
(-sr 16 for the fluid), T = 1 and a few Adam iterations a fit; the JAX
package then runs from the port's init with each of its draws answered by
the port's. Each fit must take the same iterations in both, the final
parameters agree at 1e-4 and every per-t statistic at 1e-4 relative."""

import os

import pytest
import torch

import chip_smoke as cs
import elasticity_reference_jax as ela_ref
import vortex_hashgrid_reference_jax as fluid_ref
from insr_pde_tpu_torch.geometry import box_tet_mesh, write_medit

torch.set_num_threads(1)

TINY = {"--hidden_features": "16", "-sr": "8", "-T": "1",
        "--max_n_iters": "30", "-vr": "16"}


def _tiny(args, **over):
    out = list(args)
    for flag, value in {**TINY, **over}.items():
        out[out.index(flag) + 1] = value
    return out


def _scene(name, tmp_path):
    """(flags, statistics kind) of a tiny paired scene."""
    if name == "collide2d":
        return _tiny(cs.ELA_2D_ARGS) + ["--sample_resolution_init", "8"], "2d"
    if name == "stretch2d":
        return (_tiny(cs.paper_args("elasticity2Dstretch"))
                + ["--sample_resolution_init", "8"], "stretch")
    mesh = str(tmp_path / "box.mesh")
    V, T = box_tet_mesh(3)
    write_medit(mesh, V, {"tetra": T})
    return _tiny(cs.ELA_3D_ARGS) + ["--mesh_path", mesh], "3d"


def _check(rec, n_fits):
    port, ref = rec["port_cpu"], rec["jax"]
    assert port["iters"] == ref["iters"] and len(port["iters"]) == n_fits
    assert rec["param_max_abs_diff"] <= 1e-4
    assert len(port["stats"]) == len(ref["stats"]) == 2     # t = 0, 1
    for got, want in zip(port["stats"], ref["stats"]):
        assert set(got) == set(want)
        for key, value in want.items():
            assert got[key] == pytest.approx(value, rel=1e-4, abs=1e-9), key


@pytest.mark.parametrize("name", ["collide2d", "stretch2d", "box3d"])
def test_elasticity_matches_jax_on_the_ports_draws(tmp_path, name):
    flags, kind = _scene(name, tmp_path)
    rec = ela_ref.paired(flags, kind, str(tmp_path / "runs"))
    _check(rec, n_fits=2)
    assert os.path.exists(tmp_path / "runs" / "jax" / "results"
                          / "t001_deformation.ply")


def test_stretch_statistics_read_the_faces(tmp_path):
    """The stretch scene's right face moves right of its rest x = +1 by
    t = 1 and the left face stays near x = -1 (the constraint)."""
    flags, kind = _scene("stretch2d", tmp_path)
    flags = _tiny(flags, **{"--max_n_iters": "60"})
    rec = ela_ref.paired(flags, kind, str(tmp_path / "runs"))
    _check(rec, n_fits=2)
    t0, t1 = rec["port_cpu"]["stats"]
    assert t1["right_x"] > t0["right_x"]
    assert abs(t1["left_x"] + 1.0) < abs(t1["right_x"] - 1.0)


def test_multiscale_taylor_green_matches_jax_on_the_ports_draws(tmp_path):
    args = _tiny(cs.paper_args("fluid2DtlgnM"),
                 **{"-sr": "16", "--max_n_iters": "20"})
    rec = fluid_ref.tlgnM_pair(args, str(tmp_path / "runs"))
    _check(rec, n_fits=4)      # init, advect, pressure, projection


def test_a_draw_out_of_order_raises(tmp_path, monkeypatch):
    """Without leaving out the JAX loss's unread face draws, the collide
    scene's JAX run asks for face coordinates where the port drew box
    points: the draw order check raises."""
    flags, kind = _scene("collide2d", tmp_path)
    monkeypatch.setattr(ela_ref, "_faces_unread", lambda jm: None)
    with pytest.raises(Exception, match="draw order"):
        ela_ref.paired(flags, kind, str(tmp_path / "runs"))
