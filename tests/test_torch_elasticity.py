"""PyTorch port, elasticity model against the JAX package.

* Each energy term's loss and parameter gradient (and the init loss) on the
  points the JAX loss draws: the test replays JAX's `jax.random.split`
  order (elasticity.py:120-150,155-178,186-188) and hands the points to the
  port's pure loss, for the 2D box scene and the 3D tet-mesh scene.
* The deformation gradient F against JAX's `jacobian(q_fn, x)` itself (the
  energies are invariant under F -> F^T, so they alone would not catch a
  swapped layout).
* An init fit and one step through the models' own `initialize`/`step`,
  with the port fed JAX's per-iteration points: the fields' rel L2 against
  JAX's.
* The history nets go through `MLP.apply_fused`; the output points equal
  JAX's; the PLY bytes equal the JAX writer's; checkpoints of the three
  fields load both ways; the CLI runs the 2D box and the 3D mesh scenes on
  the CPU; a missing `--mesh_path` raises naming the flag."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insr_pde_tpu.config import Config as JConfig
from insr_pde_tpu.geometry import box_tet_mesh
from insr_pde_tpu.models.elasticity import ElasticityModel as JElasticity
from insr_pde_tpu.ops.diff import jacobian as jjacobian
from insr_pde_tpu.utils.io import write_pointcloud_to_file as jwrite_ply
from insr_pde_tpu_torch import __main__ as cli
from insr_pde_tpu_torch.config import Config as TConfig
from insr_pde_tpu_torch.convert import fields_from_jax, params_from_jax
from insr_pde_tpu_torch.geometry import write_medit
from insr_pde_tpu_torch.models import elasticity as telast
from insr_pde_tpu_torch.models.networks import MLP
from insr_pde_tpu_torch.utils.io import write_pointcloud_to_file

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALL_2D = ["arap", "volume", "kinematics", "external", "constraint",
          "constraint_right", "collision_sphere"]
ALL_3D = ["arap", "volume", "kinematics", "external", "collision"]
BOX = dict(pde="elasticity", dim=2, num_hidden_layers=2, hidden_features=16,
           sample_resolution=6, sample_resolution_init=6, vis_resolution=8,
           dt=0.1, backup_sources=False, external_force_x=30.0,
           external_force_y=-100.0, external_force_timesteps=2,
           collide_circle_y=-0.5, constraint_right_offset_x=0.5)


def _mesh_scene(tmp_path):
    """The 3D scene on a 2x2x2 tet box (27 vertices, 40 tets) written as
    MEDIT; its plane halfway up the normalised box."""
    path = str(tmp_path / "box.mesh")
    V, T = box_tet_mesh(2)
    write_medit(path, V, {"tetra": T})
    return dict(BOX, dim=3, use_mesh=True, mesh_path=path,
                sample_resolution=3, sample_resolution_init=3,
                vis_resolution=20, plane_height=0.0, external_force_z=-50.0)


def _models(tmp_path, scene="2d", **over):
    kw = {**(BOX if scene == "2d" else _mesh_scene(tmp_path)), **over}
    jcfg = JConfig(proj_dir=str(tmp_path), tag="jax", **kw)
    tcfg = TConfig(proj_dir=str(tmp_path), tag="torch", device="cpu", **kw)
    jm = JElasticity(jcfg)
    tm = telast.ElasticityModel(tcfg)
    tm.fields = fields_from_jax(
        {k: [(np.asarray(w), np.asarray(b)) for w, b in v]
         for k, v in jm.fields.items()})
    return jcfg, tcfg, jm, tm


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_points(jm, kind, key):
    """The points JAX's loss draws from `key`, in its split order."""
    if kind == "init":
        return {"x": _t(jm._sample_in_training(
            key, jm.n_random_init, resolution=jm.sample_resolution_init))}
    k1, k2 = jax.random.split(key)
    pts = {"x": _t(jm._sample_in_training(k1, jm.n_random))}
    left, right = jm._sample_fixed_in_training(k2)
    if left is not None:
        pts["left"], pts["right"] = _t(left), _t(right)
    return pts


def _history(jm):
    """Two other nets as prev and prev_prev, so that every kinematic term
    is far from zero."""
    return {name: jm.net.init(jax.random.PRNGKey(seed))
            for name, seed in (("prev", 21), ("prev_prev", 22))}


def _to_torch(p):
    return params_from_jax([(np.asarray(w), np.asarray(b)) for w, b in p])


# (scene, energy terms, timestep): each term alone and all together at
# timestep 1; the terms that read the timestep also at 3 (> T_ext = 2)
LOSS_CASES = ([("2d", [t], 1) for t in ALL_2D]
              + [("2d", ["constraint_right_compress"], 1), ("2d", ALL_2D, 1)]
              + [("3d", [t], 1) for t in ALL_3D] + [("3d", ALL_3D, 1)]
              + [("2d", ["external"], 3), ("2d", ALL_2D, 3),
                 ("3d", ALL_3D, 3)])


@pytest.mark.parametrize(
    "scene,energy,timestep", LOSS_CASES,
    ids=[f"{s}-{'+'.join(e) if len(e) < 3 else 'all'}-t{t}"
         for s, e, t in LOSS_CASES])
def test_deformation_loss_and_gradient_match_jax(tmp_path, scene, energy,
                                                 timestep):
    """Loss rtol 1e-4, parameter gradient within 1e-4 of its largest entry
    (the sums over the points run in another order), with the external
    force on (timestep 1) and off (timestep 3 > T_ext 2)."""
    _, _, jm, tm = _models(tmp_path, scene, energy=energy)
    key = jax.random.PRNGKey(11)
    hist = _history(jm)
    params = jm.fields["deformation"]
    jaux = {**hist, "timestep": jnp.asarray(timestep, jnp.float32)}
    taux = {k: _to_torch(v) for k, v in hist.items()}
    taux["external"] = timestep <= tm.external_force_timesteps

    def jtotal(p):
        ld = jm._deformation_loss(p, key, jaux)
        return sum(ld.values()), ld

    (_, jld), jgrad = jax.value_and_grad(jtotal, has_aux=True)(params)
    tparams = [(w.clone().requires_grad_(True), b.clone().requires_grad_(True))
               for w, b in _to_torch(params)]
    tld = tm._deformation_loss(tparams, _jax_points(jm, "step", key), taux)
    sum(tld.values()).backward()

    assert set(tld) == set(jld) == {"main"}
    np.testing.assert_allclose(tld["main"].item(), float(jld["main"]),
                               rtol=1e-4)
    if energy == ["external"] and timestep == 3:
        assert tld["main"].item() == 0.0
        return
    jl = jax.tree_util.tree_leaves(jgrad)
    scale = max(float(np.abs(np.asarray(g)).max()) for g in jl)
    for g, t in zip(jl, [t for wb in tparams for t in wb]):
        # the last bias does not reach F: no torch grad for the F-only terms
        tg = np.zeros(t.shape, np.float32) if t.grad is None else t.grad
        np.testing.assert_allclose(np.asarray(tg), np.asarray(g),
                                   atol=1e-4 * scale)


@pytest.mark.parametrize("scene", ["2d", "3d"])
def test_init_loss_and_gradient_match_jax(tmp_path, scene):
    _, _, jm, tm = _models(tmp_path, scene)
    key = jax.random.PRNGKey(5)
    params = jm.fields["deformation"]
    jval, jgrad = jax.value_and_grad(
        lambda p: jm._init_loss(p, key, None)["main"])(params)
    tparams = [(w.clone().requires_grad_(True), b.clone().requires_grad_(True))
               for w, b in _to_torch(params)]
    tval = tm._init_loss(tparams, _jax_points(jm, "init", key), None)["main"]
    tval.backward()
    np.testing.assert_allclose(tval.item(), float(jval), rtol=1e-5)
    for g, t in zip(jax.tree_util.tree_leaves(jgrad),
                    [t for wb in tparams for t in wb]):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.parametrize("scene,nonlinearity", [("2d", "sine"),
                                                ("3d", "sine"),
                                                ("2d", "elu")])
def test_deformation_gradient_equals_jax_jacobian(tmp_path, scene,
                                                  nonlinearity):
    """F[:, i, j] = d q_i / d x_j, held against JAX's jacobian(q_fn, x)
    entry by entry (atol 1e-4 of max |F|): the SIREN's forward chain, and
    vmapped jacfwd for another network."""
    _, _, jm, tm = _models(tmp_path, scene, nonlinearity=nonlinearity)
    params = jm.fields["deformation"]
    x = _jax_points(jm, "step", jax.random.PRNGKey(3))["x"]
    ref = np.asarray(jjacobian(lambda xi: jm.net.apply(params, xi) + xi,
                               jnp.asarray(x.numpy())))
    q, F = tm.deformation_gradient(_to_torch(params), x)
    assert F.shape == (x.shape[0], tm.dim, tm.dim)
    np.testing.assert_allclose(F.detach().numpy(), ref,
                               atol=1e-4 * np.abs(ref).max())
    np.testing.assert_allclose(
        q.detach().numpy(),
        np.asarray(jm.net.apply(params, jnp.asarray(x.numpy())))
        + x.numpy(), atol=1e-5)
    # the layout is not symmetric here, so a transpose would fail above
    assert np.abs(ref - np.swapaxes(ref, 1, 2)).max() > 1e-2


def test_history_nets_go_through_the_fused_forward(tmp_path, monkeypatch):
    """q_prev and q_prev_prev: two `apply_fused` calls per loss, under
    no_grad; the trained field takes `apply` (it needs a gradient)."""
    _, _, jm, tm = _models(tmp_path, "3d", energy=ALL_3D)
    calls = []
    real = MLP.apply_fused

    def spy(self, params, coords):
        calls.append(torch.is_grad_enabled())
        return real(self, params, coords)

    monkeypatch.setattr(MLP, "apply_fused", spy)
    hist = {k: _to_torch(v) for k, v in _history(jm).items()}
    tparams = [(w.requires_grad_(True), b.requires_grad_(True))
               for w, b in _to_torch(jm.fields["deformation"])]
    loss = tm._deformation_loss(tparams, tm._step_points(),
                                {**hist, "external": True})["main"]
    loss.backward()
    assert calls == [False, False]
    assert tparams[0][0].grad is not None


def _replay(jm, kind, fit_key):
    state = {"key": fit_key}

    def sample():
        state["key"], k = jax.random.split(state["key"])
        return _jax_points(jm, kind, k)
    return sample


@pytest.mark.parametrize("scene", ["2d", "3d"])
def test_initialize_and_step_match_jax_on_the_same_points(tmp_path, scene):
    """Both models run initialize + one step (every term of the scene, 60
    Adam iterations per fit at lr 1e-3) from the same fields, the port fed
    JAX's per-iteration points. Measured on the CPU: the deformed points'
    rel L2 against JAX's at the output points 7e-8 / 8e-5 (2D, t = 0 / 1)
    and 6e-8 / 3e-7 (3D). Bar 1e-3: the sums round in another order, and Adam's
    normalised step turns that into up to lr on a near-zero gradient
    component."""
    energy = ALL_2D if scene == "2d" else ALL_3D
    jcfg, tcfg, jm, tm = _models(tmp_path, scene, energy=energy,
                                 max_n_iters=60, chunk_size=30, lr=1e-3,
                                 early_stop=False)
    jcfg.setup_dirs()
    tcfg.setup_dirs()
    x = jm.sample_vis

    def rel(t_params, j_params):
        j = np.asarray(jm.net.apply(j_params, x) + x)
        t = (tm.net.apply(t_params, _t(x)) + _t(x)).detach().numpy()
        return float(np.linalg.norm(t - j) / np.linalg.norm(j))

    tm._init_points = _replay(jm, "init", jax.random.split(jm.key)[1])
    jres0 = jm.initialize()
    tres0 = tm.initialize()
    rel0 = rel(tm.fields["deformation"], jm.fields["deformation"])
    tm._step_points = _replay(jm, "step", jax.random.split(jm.key)[1])
    jres1 = jm.step()
    tres1 = tm.step()
    rel1 = rel(tm.fields["deformation"], jm.fields["deformation"])
    assert rel0 < 1e-3 and rel1 < 1e-3, (rel0, rel1)
    for jres, tres in ((jres0, tres0), (jres1, tres1)):
        assert tres.n_iters == jres.n_iters == 60
        jh = jres.history["main"]
        np.testing.assert_allclose(tres.history["main"], jh, rtol=1e-3,
                                   atol=1e-3 * np.abs(jh).max())
    # the history shifted as JAX's: prev is the t = 0 field
    for (w, b), (jw, jb) in zip(tm.fields["deformation_prev"],
                                jm.fields["deformation_prev"]):
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-3)
    assert [r["tag"] for r in tm.phase_timings] == ["initialize",
                                                    "solve_deformation"]


@pytest.mark.parametrize("scene", ["2d", "3d"])
def test_output_points_match_jax(tmp_path, scene):
    """sample_deformation (the fused forward on the output points) equals
    JAX's: the box's grid and faces bit for bit, the mesh's vertices to f32
    rounding (their surface points are drawn from another generator)."""
    _, _, jm, tm = _models(tmp_path, scene)
    jv, tv = np.asarray(jm.sample_vis), tm.sample_vis.numpy()
    if scene == "2d":
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_allclose(tm.sample_deformation().numpy(),
                                   np.asarray(jm.sample_deformation()),
                                   atol=1e-5)
    else:
        nv = jm.mesh_V.shape[0]
        assert tv.shape == jv.shape
        np.testing.assert_allclose(tv[-nv:], jv[-nv:], atol=1e-6)
        np.testing.assert_allclose(tm.vertex_area.numpy(),
                                   np.asarray(jm.vertex_area), rtol=1e-5)
        np.testing.assert_array_equal(tm.mesh_SF.numpy(),
                                      np.asarray(jm.mesh_SF))
        # the surface points lie on the normalised box's boundary
        assert np.allclose(np.abs(tv[:-nv]).max(axis=1),
                           np.abs(jv[-nv:]).max(), atol=1e-5)


def test_ply_bytes_equal_the_jax_writer(tmp_path):
    rng = np.random.default_rng(0)
    for d in (2, 3):
        pts = rng.standard_normal((50, d)).astype(np.float32) * 3
        a, b = str(tmp_path / f"j{d}.ply"), str(tmp_path / f"t{d}.ply")
        jwrite_ply(a, pts)
        write_pointcloud_to_file(b, pts)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    cols = rng.random((50, 3))
    jwrite_ply(str(tmp_path / "jc.ply"), pts, cols)
    write_pointcloud_to_file(str(tmp_path / "tc.ply"), pts, cols)
    assert ((tmp_path / "jc.ply").read_bytes()
            == (tmp_path / "tc.ply").read_bytes())


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_checkpoints_of_the_three_fields_load_both_ways(tmp_path, direction):
    jcfg, tcfg, jm, tm = _models(tmp_path)
    jcfg.setup_dirs()
    tcfg.setup_dirs()
    other = [(w * 0.5 + 0.01, b - 0.02) for w, b in jm.fields["deformation"]]
    jm.fields["deformation_prev"] = other
    jm.timestep = 4
    tm.timestep = 4
    tm.fields = fields_from_jax({k: [(np.asarray(w), np.asarray(b))
                                     for w, b in v]
                                 for k, v in jm.fields.items()})
    src, dst = (jm, tm) if direction == "jax_to_torch" else (tm, jm)
    src.save_ckpt()
    os.makedirs(dst.cfg.model_dir, exist_ok=True)
    os.replace(os.path.join(src.cfg.model_dir, "ckpt_step_t004.npz"),
               os.path.join(dst.cfg.model_dir, "ckpt_step_t004.npz"))
    dst.timestep = -1
    dst.load_ckpt(4)
    assert dst.timestep == 4
    for name in ("deformation", "deformation_prev", "deformation_prev_prev"):
        for (w, b), (jw, jb) in zip(tm.fields[name], jm.fields[name]):
            np.testing.assert_array_equal(np.asarray(w), np.asarray(jw))
            np.testing.assert_array_equal(np.asarray(b), np.asarray(jb))


TINY = ["--device", "cpu", "--num_hidden_layers", "2", "--hidden_features",
        "8", "--max_n_iters", "20", "--chunk_size", "10", "--dt", "0.1",
        "--no_backup"]


def test_cli_elasticity_2d_box_writes_outputs(tmp_path):
    """`python -m insr_pde_tpu_torch elasticity` with the flags of
    scripts/elasticity2Dcollide.sh at a tiny size, in a subprocess: the
    per-step PLY/NPY points, checkpoints, logs and timings."""
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "insr_pde_tpu_torch", "elasticity", *TINY,
         "-sr", "8", "--sample_resolution_init", "8", "-vr", "12", "-T", "2",
         "--energy", "arap", "kinematics", "collision_sphere", "external",
         "volume", "--ratio_volume", "1e3", "--ratio_arap", "2e1",
         "--ratio_collide", "1e4", "--ratio_kinematics", "1e1",
         "-f_ext_y=-2e2", "-T_ext", "2", "--proj_dir", str(tmp_path),
         "--tag", "e2d"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    exp = tmp_path / "e2d"
    for t in range(3):
        for rel in (f"results/t{t:03d}_deformation.ply",
                    f"results/t{t:03d}_deformation.npy",
                    f"model/ckpt_step_t{t:03d}.npz",
                    f"log/t{t:03d}/scalars.jsonl"):
            assert (exp / rel).exists(), rel
    pts = np.load(exp / "results/t002_deformation.npy")
    assert pts.shape == (12 * 12 + 2 * 12, 2) and np.isfinite(pts).all()


def test_cli_elasticity_3d_mesh_runs_and_resumes(tmp_path):
    """The 3D scene of scripts/elasticity3Dlucy.sh's flags on a box tet
    mesh in-process, then a resumed step from its checkpoint."""
    mesh = str(tmp_path / "box.mesh")
    V, T = box_tet_mesh(2)
    write_medit(mesh, V, {"tetra": T})
    args = ["elasticity", *TINY, "--dim", "3", "--use_mesh", "1",
            "--mesh_path", mesh, "-sr", "3", "-vr", "30", "--energy", "arap",
            "kinematics", "collision", "external", "volume",
            "--ratio_volume", "1e3", "--ratio_arap", "1e3",
            "--ratio_collide", "1e6", "-f_ext_z=-2e1", "-T_ext", "10",
            "--plane_height", "-2", "--proj_dir", str(tmp_path), "--tag",
            "e3d"]
    model = cli.main(args + ["-T", "1"])
    pts = np.load(tmp_path / "e3d/results/t001_deformation.npy")
    assert pts.shape == (30 + 27, 3) and np.isfinite(pts).all()
    assert model.n_random == 27 and model.mesh_V.shape == (27, 3)
    resumed = cli.main(args + ["-T", "2", "--ckpt", "latest"])
    assert resumed.timestep == 2
    assert [r["tag"] for r in resumed.phase_timings] == ["solve_deformation"]


def test_missing_mesh_raises_naming_the_flag(tmp_path):
    with pytest.raises(FileNotFoundError, match="--mesh_path"):
        cli.main(["elasticity", *TINY, "--dim", "3", "--use_mesh", "1",
                  "--mesh_path", str(tmp_path / "absent.mesh"),
                  "--proj_dir", str(tmp_path)])
    assert not (tmp_path / "run").exists()


def test_mesh_path_default_is_outside_the_jax_package():
    cfg = TConfig()
    assert "insr_pde_tpu" not in cfg.mesh_path
    assert not os.path.isabs(cfg.mesh_path)
    from insr_pde_tpu_torch.config import parse_args
    assert parse_args(["elasticity"]).mesh_path == cfg.mesh_path


def test_unknown_energy_and_pattern_raise(tmp_path):
    with pytest.raises(NotImplementedError, match="energy"):
        telast.ElasticityModel(TConfig(**{**BOX, "energy": ["bogus"]},
                                       device="cpu"))
    with pytest.raises(NotImplementedError, match="sample_pattern"):
        telast.ElasticityModel(TConfig(**{**BOX, "sample_pattern": ["grid"]},
                                       device="cpu"))


@pytest.mark.parametrize("kind", ["3d", "2d"])
def test_elasticity_stats_reads_either_packages_ply(tmp_path, kind):
    """The chip check's yardstick: per-t statistics of a run from its PLY
    files, the same for the JAX writer's and the port's files (their bytes
    are equal), the 2D circle read from the run's config.json, and the mean
    and spread over runs."""
    from insr_pde_tpu_torch import elasticity_stats as es
    rng = np.random.default_rng(1)
    runs = []
    for r, writer in enumerate((jwrite_ply, write_pointcloud_to_file)):
        res = tmp_path / f"run{r}" / "results"
        res.mkdir(parents=True)
        # not the flags' default circle ((0, -2), 1)
        (tmp_path / f"run{r}" / "config.json").write_text(json.dumps(
            {"collide_circle_x": 0.5, "collide_circle_y": -1.0,
             "collide_circle_radius": 1.5}))
        pts = []
        for t in range(3):
            p = rng.standard_normal((40, 3 if kind == "3d" else 2))
            p = (p - 0.5 * t).astype(np.float32)        # falling
            writer(str(res / f"t{t:03d}_deformation.ply"), p)
            pts.append(p.astype(np.float64))
        stats = es.run_stats(kind, str(tmp_path / f"run{r}"))
        for step, p in zip(stats, pts):
            if kind == "3d":
                np.testing.assert_allclose(step["z_min"], p[:, 2].min(),
                                           atol=1e-6)
                np.testing.assert_allclose(step["z_mean"], p[:, 2].mean(),
                                           atol=1e-6)
            else:
                np.testing.assert_allclose(step["centroid_y"],
                                           p[:, 1].mean(), atol=1e-6)
                dist = np.hypot(p[:, 0] - 0.5, p[:, 1] + 1.0)
                assert (dist < 1.5).any()
                np.testing.assert_allclose(
                    step["penetration"], max(0.0, (1.5 - dist).max()),
                    atol=1e-6)
        runs.append(stats)
    summary = es.main([kind, str(tmp_path / "run0"), str(tmp_path / "run1")])
    key = "z_min" if kind == "3d" else "centroid_y"
    a = np.array([s[key] for s in runs[0]])
    b = np.array([s[key] for s in runs[1]])
    np.testing.assert_allclose(summary[key]["mean"], (a + b) / 2)
    np.testing.assert_allclose(summary[key]["spread"], np.abs(a - b))


def test_elasticity_stats_2d_needs_the_runs_circle(tmp_path):
    """A 2D run's penetration is measured against the circle its own
    config.json records; without that file there is no circle to assume."""
    from insr_pde_tpu_torch import elasticity_stats as es
    res = tmp_path / "results"
    res.mkdir()
    write_pointcloud_to_file(str(res / "t000_deformation.ply"),
                             np.zeros((4, 2), np.float32))
    assert es.run_stats("3d", str(tmp_path))[0]["z_min"] == 0.0
    with pytest.raises(FileNotFoundError, match="config.json"):
        es.run_stats("2d", str(tmp_path))
