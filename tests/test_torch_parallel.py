"""PyTorch port, collocation sharding over `torch.distributed`
(`parallel/mesh.py`, `Solver(group=...)`, the models' budget split) against
the JAX package's mesh sharding.

Ranks are spawned by `parallel.launch` on the CPU over gloo (their bodies
are in tests/torch_ranks.py); the JAX side runs in this process on the
first k of the 8 virtual CPU devices of tests/conftest.py.
* `make_group` is None at world 1 and names `--n_devices` on a mismatch;
  the collectives reduce as `psum`/`pmean`/`pmax`/broadcast; a failing
  rank and a rank past the deadline make `launch` raise.
* A deterministic loss at worlds 2 and 4 equals the single run and the JAX
  `Solver` on a k-device mesh (rtol 1e-5, atol 1e-6).
* The sharded loss and gradient at world 2 against JAX's
  `Solver._value_and_grad` under `shard_map`, rank r on the points that
  `jax.random.fold_in(key, r)` draws: the fluid pressure loss and the 2D
  elasticity loss, at tests/test_torch_fluid.py's bars (loss rtol 1e-4,
  gradient within 1e-4 of its largest entry). JAX's sharded gradient is
  the sum over its k devices (k times the mean; see the test), the port's
  the mean.
* Every model's point budget divided over k = 2 and 3 ranks as JAX divides
  it over a k-device mesh (ragged counts included); the init draws are
  replicated and rank r > 0 samples from its own generator.
* The CLI under `torch.distributed.run` with `--n_devices 2`: rank 0 alone
  writes the outputs, the checkpoint loads at world 1, and `--n_devices 3`
  at world 2 raises."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from insr_pde_tpu.config import Config as JConfig
from insr_pde_tpu.models.advection import Advection1DModel as JAdvection
from insr_pde_tpu.models.elasticity import ElasticityModel as JElasticity
from insr_pde_tpu.models.fluid import Fluid2DModel as JFluid
from insr_pde_tpu.models.solver import Solver as JSolver
from insr_pde_tpu.ops.sampling import sample_boundary2D_separate, sample_random
from insr_pde_tpu_torch.__main__ import build_model
from insr_pde_tpu_torch.config import Config as TConfig
from insr_pde_tpu_torch.models.solver import Solver
from insr_pde_tpu_torch.parallel import (Group, broadcast, launch, make_group,
                                         pmax, pmean, psum)

import torch_ranks

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mesh(k):
    return Mesh(np.asarray(jax.devices()[:k]), ("data",))


def _np_fields(fields):
    return {k: [(np.asarray(w), np.asarray(b)) for w, b in v]
            for k, v in fields.items()}


# ------------------------------------------------------------ the group


@pytest.mark.parametrize("n_devices", [0, 1])
def test_make_group_is_none_at_world_one(n_devices, monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert make_group(n_devices, device="cpu") is None


def test_make_group_mismatch_raises_naming_the_flag(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="--n_devices 2"):
        make_group(2, device="cpu")


def test_collectives_are_the_identity_without_a_group():
    t = torch.tensor([1.0, -2.0])
    for op in (psum, pmean, pmax, broadcast):
        assert op(t, None) is t


def test_collectives_over_two_ranks():
    out = launch(torch_ranks.collectives, 2, "gloo", args=(2,))
    for r, res in enumerate(out):
        assert int(res["rank"]) == r and int(res["size"]) == 2
        np.testing.assert_array_equal(res["psum"], [3.0, -1.0])
        np.testing.assert_array_equal(res["pmean"], [1.5, -0.5])
        np.testing.assert_array_equal(res["pmax"], [2.0, 0.0])
        np.testing.assert_array_equal(res["broadcast"], [10.0, 0.0])


def test_launch_raises_for_a_failing_rank():
    with pytest.raises(RuntimeError, match="rank one fails on purpose"):
        launch(torch_ranks.fail_on_rank_one, 2, "gloo")


def test_launch_kills_ranks_past_the_deadline():
    with pytest.raises(RuntimeError, match="killed at the deadline"):
        launch(torch_ranks.sleep_past_deadline, 2, "gloo", deadline_s=6)


# ------------------------------------------------------------ the solver


def _jquadratic(params, key, aux):
    return {"main": jnp.sum((params - jnp.asarray([1.0, -2.0, 3.0])) ** 2)}


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_solver_matches_single_run_and_jax(world):
    """Every rank contributes the same deterministic loss: the sharded fit
    equals the single run and JAX's on a k-device mesh."""
    out = launch(torch_ranks.quadratic_fit, world, "gloo", args=(300,))
    single = Solver(torch_ranks.quadratic_loss, lambda: {}, lr=0.1,
                    max_n_iters=300, chunk_size=100,
                    early_stop=False).fit({"p": torch.zeros(3)})
    jres = JSolver(_jquadratic, lr=0.1, max_n_iters=300, chunk_size=100,
                   early_stop=False, mesh=_mesh(world)).fit(
        jnp.zeros(3), jax.random.PRNGKey(0))
    for res in out:
        np.testing.assert_array_equal(res["params"], out[0]["params"])
        np.testing.assert_allclose(res["params"], single.params["p"].numpy(),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(res["params"], np.asarray(jres.params),
                                   rtol=1e-5, atol=1e-6)


def _t(a):
    return np.array(a)


def _fluid_points(jm, key):
    """The points JAX's pressure loss draws from `key`, in its split order
    (tests/test_torch_fluid.py)."""
    k1, k2, k3 = jax.random.split(key, 3)
    return {"x": _t(sample_random(k1, jm.n_samples, 2)),
            "bx": _t(sample_boundary2D_separate(k2, jm.n_boundary,
                                                "horizontal")),
            "by": _t(sample_boundary2D_separate(k3, jm.n_boundary,
                                                "vertical"))}


def _elasticity_points(jm, key):
    """The points JAX's deformation loss draws from `key`
    (tests/test_torch_elasticity.py)."""
    k1, k2 = jax.random.split(key)
    pts = {"x": _t(jm._sample_in_training(k1, jm.n_random))}
    left, right = jm._sample_fixed_in_training(k2)
    if left is not None:
        pts["left"], pts["right"] = _t(left), _t(right)
    return pts


FLUID = dict(pde="fluid", init_cond="taylorgreen", num_hidden_layers=3,
             hidden_features=16, sample_resolution=24, vis_resolution=16,
             dt=0.05, backup_sources=False)
ELA_2D = dict(pde="elasticity", dim=2, num_hidden_layers=2, hidden_features=16,
              sample_resolution=6, sample_resolution_init=6, vis_resolution=8,
              dt=0.1, backup_sources=False, external_force_x=30.0,
              external_force_y=-100.0, external_force_timesteps=2,
              collide_circle_y=-0.5, constraint_right_offset_x=0.5,
              energy=["arap", "volume", "kinematics", "external",
                      "constraint", "constraint_right", "collision_sphere"])


@pytest.mark.parametrize("case", ["fluid_pressure", "elasticity_2d"])
def test_sharded_loss_and_gradient_match_jax(tmp_path, case):
    """The port at world 2 against JAX's sharded `_value_and_grad` on a
    2-device mesh, rank r given the points of `fold_in(key, r)`."""
    k = 2
    mesh = _mesh(k)
    key = jax.random.PRNGKey(11)
    if case == "fluid_pressure":
        kw = FLUID
        jm = JFluid(JConfig(proj_dir=str(tmp_path), tag="j", **kw), mesh)
        fields = dict(jm.fields)
        loss, field, aux_fields, aux_consts = (
            "_pressure_loss", "pressure", {"vel": "velocity"}, {})
        jaux = {"vel": fields["velocity"]}
        draw = _fluid_points
    else:
        kw = ELA_2D
        jm = JElasticity(JConfig(proj_dir=str(tmp_path), tag="j", **kw), mesh)
        fields = dict(jm.fields)
        # other nets as the history, so that every kinematic term counts
        fields["deformation_prev"] = jm.net.init(jax.random.PRNGKey(21))
        fields["deformation_prev_prev"] = jm.net.init(jax.random.PRNGKey(22))
        loss, field = "_deformation_loss", "deformation"
        aux_fields = {"prev": "deformation_prev",
                      "prev_prev": "deformation_prev_prev"}
        aux_consts = {"external": True}
        jaux = {"prev": fields["deformation_prev"],
                "prev_prev": fields["deformation_prev_prev"],
                "timestep": jnp.asarray(1.0, jnp.float32)}
        draw = _elasticity_points
    solver = JSolver(getattr(jm, loss), lr=1e-4, max_n_iters=1, mesh=mesh)
    state = solver.init_state(fields[field], key)
    jld, jgrad = jax.jit(solver._value_and_grad)(state.params, key, jaux)
    points = [draw(jm, jax.random.fold_in(key, r)) for r in range(k)]
    out = launch(torch_ranks.loss_grad, k, "gloo",
                 args=(kw["pde"], kw, _np_fields(fields), loss, field,
                       aux_fields, aux_consts, points))
    # JAX's gradient under shard_map is the SUM over the devices: the
    # replicated params enter each device's loss through an implicit
    # broadcast whose transpose is a psum, and the pmean that follows
    # averages k equal sums. Its losses are means. Adam is invariant to the
    # gradient's scale (up to eps); the port averages both.
    jgrad = np.asarray(jgrad) / k
    for res in out:
        assert {n[len("loss_"):] for n in res if n.startswith("loss_")} \
            == set(jld)
        for name, v in jld.items():
            np.testing.assert_allclose(res[f"loss_{name}"], float(v),
                                       rtol=1e-4)
        np.testing.assert_allclose(res["grad"], jgrad, rtol=1e-4,
                                   atol=1e-4 * np.abs(jgrad).max())
        np.testing.assert_array_equal(res["grad"], out[0]["grad"])


# ------------------------------------------------------ the budget split


BUDGETS = {
    "fluid": (dict(pde="fluid", init_cond="taylorgreen", num_hidden_layers=2,
                   hidden_features=8, sample_resolution=15), JFluid,
              ("n_samples", "n_boundary")),
    "advection": (dict(pde="advection", init_cond="example1",
                       num_hidden_layers=2, hidden_features=8,
                       sample_resolution=1001), JAdvection,
                  ("n_samples", "n_boundary")),
    "elasticity": (dict(ELA_2D, sample_resolution=7,
                        sample_resolution_init=11), JElasticity,
                   ("n_random", "n_fixed", "n_random_init")),
}


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("pde", list(BUDGETS))
def test_point_budget_divided_as_on_the_jax_mesh(tmp_path, pde, k):
    kw, jcls, names = BUDGETS[pde]
    kw = {**kw, "backup_sources": False}
    jm = jcls(JConfig(proj_dir=str(tmp_path), tag="j", **kw), _mesh(k))
    tm = build_model(TConfig(proj_dir=str(tmp_path), tag="t", device="cpu",
                             **kw), Group(rank=0, size=k, backend="gloo"))
    one = build_model(TConfig(proj_dir=str(tmp_path), tag="1", device="cpu",
                              **kw))
    for name in names:
        assert getattr(tm, name) == getattr(jm, name), name
    # the points per iteration split; the boundary floors may hold
    assert getattr(tm, names[0]) < getattr(one, names[0])


def test_ranks_share_the_init_and_draw_their_own_points(tmp_path):
    kw = dict(FLUID, sample_resolution=8)
    cfg = TConfig(proj_dir=str(tmp_path), tag="t", device="cpu", **kw)
    one = build_model(cfg)
    r0 = build_model(cfg, Group(rank=0, size=2, backend="gloo"))
    r1 = build_model(cfg, Group(rank=1, size=2, backend="gloo"))
    assert one.generator is one.init_generator
    assert r0.generator is r0.init_generator
    assert r1.generator is not r1.init_generator
    for name in one.fields:
        for (w, b), (w0, b0), (w1, b1) in zip(one.fields[name],
                                              r0.fields[name],
                                              r1.fields[name]):
            assert torch.equal(w, w0) and torch.equal(w, w1)
            assert torch.equal(b, b0) and torch.equal(b, b1)
    x0, x1 = r0._interior_points()["x"], r1._interior_points()["x"]
    assert x0.shape == x1.shape == (32, 2) and not torch.equal(x0, x1)


# --------------------------------------------------------------- the CLI


CLI = ["advection", "--device", "cpu", "--init_cond", "example1",
       "--num_hidden_layers", "2", "--hidden_features", "16", "-sr", "256",
       "-vr", "50", "-T", "1", "--max_n_iters", "40", "--chunk_size", "20",
       "--no-early_stop", "--no_backup"]


def test_cli_under_torchrun_writes_once_and_resumes_at_world_one(tmp_path):
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "insr_pde_tpu_torch", *CLI,
         "--n_devices", "2", "--proj_dir", str(tmp_path), "--tag", "dp"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    exp = tmp_path / "dp"
    assert sorted(p.name for p in (exp / "results").glob("*.npz")) == [
        "t000.npz", "t001.npz"]
    assert len((exp / "timings.jsonl").read_text().splitlines()) == 2
    assert proc.stdout.count("timestep: 1") == 1
    # the checkpoint of the sharded run loads at world 1
    cfg = TConfig(proj_dir=str(tmp_path), tag="dp", device="cpu",
                  pde="advection", init_cond="example1", num_hidden_layers=2,
                  hidden_features=16)
    model = build_model(cfg)
    model.load_ckpt(1)
    assert model.timestep == 1
    field = model.sample_field(50).numpy().reshape(-1)
    saved = np.load(exp / "results" / "t001.npz")["arr_0"].reshape(-1)
    np.testing.assert_allclose(field, saved, rtol=1e-5, atol=1e-6)


def test_cli_n_devices_other_than_the_world_raises(tmp_path):
    argv = CLI + ["--n_devices", "3", "--proj_dir", str(tmp_path),
                  "--tag", "bad"]
    with pytest.raises(RuntimeError, match="--n_devices 3 does not match "
                                           "the world size 2"):
        launch(torch_ranks.run_cli, 2, "gloo", args=(argv,))
    assert not (tmp_path / "bad").exists()
