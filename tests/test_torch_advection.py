"""PyTorch port, 1D advection model against the JAX package.

* `_init_loss` and `_advect_loss` get the points the JAX losses draw (the
  test replays JAX's `jax.random.split` order, advection.py:48,56-57,83);
  loss values and parameter gradients match to rtol 1e-4.
* A whole advect fit through `advect_fit` (its plain version on the CPU),
  fed JAX's per-iteration points, matches the JAX `_run_phase("advect")`.
* The whole model: both packages run `initialize` + one `step` from the
  same converted fields; they draw different points (see that test's bar).
* `write_output`'s `.npz` reads as the JAX one does; checkpoints resume
  across the packages both ways.
* A relu network (no SIREN, so no fused fit): `_advect_loss` and its
  gradient against JAX's at rtol 1e-5, and the advect phase through the
  generic `Solver`.
* `--debug_nan`: with a NaN parameter, the fused advect phase warns once
  per chunk, as the JAX Solver does on the same fields."""

import os
import warnings

import jax
import numpy as np
import pytest
import torch

from insr_pde_tpu.config import Config as JConfig
from insr_pde_tpu.models.advection import Advection1DModel as JAdv
from insr_pde_tpu.ops.sampling import (sample_boundary, sample_random,
                                       sample_uniform)
from insr_pde_tpu_torch.config import Config as TConfig
from insr_pde_tpu_torch.convert import fields_from_jax
from insr_pde_tpu_torch.models import advection as tadv
from insr_pde_tpu_torch.ops import advect_fit as af
from insr_pde_tpu_torch.utils import viz

torch.set_num_threads(1)

BASE = dict(pde="advection", init_cond="example1", num_hidden_layers=2,
            hidden_features=20, sample_resolution=256, vis_resolution=64,
            dt=0.05, backup_sources=False)


def _models(tmp_path, **over):
    kw = {**BASE, **over}
    jcfg = JConfig(proj_dir=str(tmp_path), tag="jax", **kw)
    tcfg = TConfig(proj_dir=str(tmp_path), tag="torch", device="cpu", **kw)
    jm = JAdv(jcfg)
    tm = tadv.Advection1DModel(tcfg)
    tm.fields = fields_from_jax(jm.fields)
    return jcfg, tcfg, jm, tm


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_points(jm, kind, key):
    """The points JAX's loss draws from `key`, in its split order."""
    half = jm.length / 2.0
    if kind == "init":
        return {"x": _t(sample_random(key, jm.n_samples, 1) * half)}
    k1, k2 = jax.random.split(key)
    return {"x": _t(sample_random(k1, jm.n_samples, 1) * half),
            "xb": _t(sample_boundary(k2, jm.n_boundary, 1) * half)}


@pytest.mark.parametrize("kind", ["init", "advect"])
def test_loss_and_gradient_match_jax(tmp_path, kind):
    _, _, jm, tm = _models(tmp_path)
    key = jax.random.PRNGKey(11)
    name = "_init_loss" if kind == "init" else "_advect_loss"
    # the previous field differs from the trained one, so every term is far
    # from zero
    jaux = None if kind == "init" else {"prev": jm.fields["field_prev"]}
    taux = None if kind == "init" else {"prev": tm.fields["field_prev"]}

    def jtotal(p):
        ld = getattr(jm, name)(p, key, jaux)
        return sum(ld.values()), ld

    (_, jld), jgrad = jax.value_and_grad(jtotal, has_aux=True)(
        jm.fields["field"])
    tparams = [(w.clone().requires_grad_(True), b.clone().requires_grad_(True))
               for w, b in tm.fields["field"]]
    tld = getattr(tm, name)(tparams, _jax_points(jm, kind, key), taux)
    sum(tld.values()).backward()
    assert set(tld) == set(jld)
    for k in jld:
        np.testing.assert_allclose(tld[k].item(), float(jld[k]), rtol=1e-4)
    for jl, tl in zip(jax.tree_util.tree_leaves(jgrad),
                      [t for wb in tparams for t in wb]):
        jl = np.asarray(jl)
        np.testing.assert_allclose(tl.grad.numpy(), jl, rtol=1e-4,
                                   atol=1e-4 * np.abs(jl).max())


def test_advect_fit_matches_jax_phase_on_the_same_points(tmp_path):
    """One whole advect fit (chunks of `advect_fit`, Adam, scheduler) from
    the same fields, with the port fed JAX's per-iteration points (the fit
    key from `_next_key`, then one split per iteration as `Solver._step`
    does). Measured on the CPU at this config (100 iterations at lr 1e-3,
    two chunks): fitted-field rel L2 5e-7, `main` history within 1.5e-5
    relative. Bar 1e-3, as for the fluid
    phases: sums round in another order, and Adam's normalized step turns
    that into up to lr per step on a near-zero gradient component."""
    _, tcfg, jm, tm = _models(tmp_path, max_n_iters=100, chunk_size=50,
                              lr=1e-3)
    tcfg.setup_dirs()
    jm.begin_timestep()
    tm.begin_timestep()
    prev_j, prev_t = jm.fields["field_prev"], tm.fields["field_prev"]
    fit_key = jax.random.split(jm.key)[1]      # what _next_key will hand out
    jres = jm._run_phase("advect", jm._advect_loss, jm.fields["field"],
                         aux={"prev": prev_j})
    state = {"key": fit_key}

    def replay(n):
        xs, xbs = [], []
        for _ in range(n):
            state["key"], k = jax.random.split(state["key"])
            pts = _jax_points(jm, "advect", k)
            xs.append(pts["x"][:, 0])
            xbs.append(pts["xb"][:, 0])
        return torch.stack(xs), torch.stack(xbs)

    solver = tadv.FusedAdvectSolver(replay, tm.advect_solver.widths,
                                    dt=tm.dt, vel=tm.vel,
                                    **tm._solver_options())
    tres = tm._run_phase("advect", tm._advect_loss, tm._advect_points,
                         tm.fields["field"], aux={"prev": prev_t},
                         solver=solver)
    g = sample_uniform(64, 1) * 2.0
    ju = np.asarray(jm.net.apply(jres.params, g))
    tu = tm.net.apply(tres.params, _t(g)).detach().numpy()
    assert np.linalg.norm(tu - ju) / np.linalg.norm(ju) < 1e-3
    assert tres.n_iters == jres.n_iters == 100
    for k in ("main", "bc", "_lr"):
        np.testing.assert_allclose(tres.history[k], jres.history[k],
                                   rtol=1e-3)
    # the phase's records and its log went through BaseModel as for any fit
    assert tm.phase_timings[-1]["tag"] == "advect"
    assert os.path.exists(os.path.join(tm.tb.log_path, "scalars.jsonl"))
    tm.tb.close()


def test_initialize_and_step_match_jax(tmp_path):
    """Both packages run initialize + one step from the same initial fields
    (2x20 SIREN, sr 256, 400 Adam iterations at lr 1e-3 per fit). They draw
    different points, so the fits land apart. Measured on the CPU at this
    config (field rel L2 on a 64-point grid, t = 0, 1): port vs JAX 0.044,
    0.059; two JAX runs that differ only in their point draws 0.049, 0.048;
    against the analytic bump, JAX 0.036, 0.035 and the port 0.032, 0.053.
    Bars: 3x the JAX-vs-JAX spread, and the port's distance to the analytic
    solution at most 2x the JAX run's + 0.02; a wrong sign or a lost term
    moves the field by O(1)."""
    jcfg, tcfg, jm, tm = _models(tmp_path, max_n_iters=400, chunk_size=200,
                                 lr=1e-3)
    jcfg.setup_dirs()
    tcfg.setup_dirs()
    g = sample_uniform(64, 1) * 2.0
    x = np.asarray(g)[:, 0]

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    for t, spread in enumerate((0.049, 0.048)):
        if t == 0:
            jm.initialize()
            tres = tm.initialize()
        else:
            jm.step()
            tres = tm.step()
        ju = np.asarray(jm.net.apply(jm.fields["field"], g))[:, 0]
        tu = tm.net.apply(tm.fields["field"], _t(g))[:, 0].detach().numpy()
        exact = np.exp(-0.5 * (x - tm.vel * tm.dt * t + 1.5) ** 2 / 0.01)
        assert np.isfinite(tres.final_loss)
        assert rel(tu, ju) < 3.0 * spread
        assert rel(tu, exact) < 2.0 * rel(ju, exact) + 0.02
    assert tm.timestep == 1
    assert [r["tag"] for r in tm.phase_timings] == ["initialize", "advect"]
    assert tres.final_loss < tres.history["main"][0]   # the residual drops


def test_write_output_reads_as_jax(tmp_path):
    _, tcfg, jm, tm = _models(tmp_path)
    jm.timestep = tm.timestep = 0
    jout, tout = tmp_path / "jout", tmp_path / "tout"
    os.makedirs(jout)
    os.makedirs(tout)
    jm.write_output(str(jout))
    tm.write_output(str(tout))
    ja = np.load(jout / "t000.npz")["arr_0"]
    ta = np.load(tout / "t000.npz")["arr_0"]
    assert ta.shape == ja.shape == (64,) and ta.dtype == ja.dtype
    np.testing.assert_allclose(ta, ja, atol=1e-6)
    assert (tout / "t000.png").exists()


def test_write_output_without_matplotlib(tmp_path, monkeypatch):
    _, _, _, tm = _models(tmp_path)
    tm.timestep = 0
    monkeypatch.setattr(viz, "available", lambda: False)
    with pytest.warns(UserWarning, match="matplotlib"):
        tm.write_output(str(tmp_path))
    assert (tmp_path / "t000.npz").exists()
    assert not (tmp_path / "t000.png").exists()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_resumes_across_packages(tmp_path, writer):
    """`field` and `field_prev` load leaf for leaf in the other package."""
    jcfg, tcfg, jm, tm = _models(tmp_path, seed=0)
    jcfg.setup_dirs()
    tcfg.tag = "jax"          # one model dir for both packages
    src, dst = (jm, tm) if writer == "jax" else (tm, jm)
    src.fields["field_prev"] = [(w * 0 + 0.25, b * 0 - 0.5)
                                for w, b in src.fields["field"]]
    src.timestep = 5
    src.save_ckpt()
    dst.fields = {k: [(w * 0, b * 0) for w, b in v]
                  for k, v in dst.fields.items()}
    dst.load_ckpt("latest")
    assert dst.timestep == 5
    for name in ("field", "field_prev"):
        for (sw, sb), (dw, db) in zip(src.fields[name], dst.fields[name]):
            for s, d in ((sw, dw), (sb, db)):
                s = s.numpy() if isinstance(s, torch.Tensor) else np.asarray(s)
                d = d.numpy() if isinstance(d, torch.Tensor) else np.asarray(d)
                np.testing.assert_array_equal(s, d)


def test_convert_carries_both_fields(tmp_path):
    """fields_from_jax and params_to_numpy move `field` and `field_prev`
    both ways unchanged."""
    from insr_pde_tpu_torch.convert import params_to_numpy
    _, _, jm, tm = _models(tmp_path)
    assert set(tm.fields) == set(jm.fields) == {"field", "field_prev"}
    for name in ("field", "field_prev"):
        back = params_to_numpy(tm.fields[name])
        for (jw, jb), (w, b) in zip(jm.fields[name], back):
            np.testing.assert_array_equal(w, np.asarray(jw))
            np.testing.assert_array_equal(b, np.asarray(jb))


def test_sample_boundary_matches_jax_geometry():
    """1D: n//2 points in the eps-shell of each end, left first; 2D: n//4
    per strip in the JAX strip order; `batch` stacks independent sets."""
    from insr_pde_tpu_torch.ops.sampling import sample_boundary as tsb
    gen = torch.Generator().manual_seed(0)
    jb = np.asarray(sample_boundary(jax.random.PRNGKey(0), 51, 1))
    tb = tsb(gen, 51, 1).numpy()
    assert tb.shape == jb.shape == (50, 1)
    for pts in (jb, tb):
        assert (np.abs(pts[:25] + 1.0) <= 1e-4 + 1e-7).all()
        assert (np.abs(pts[25:] - 1.0) <= 1e-4 + 1e-7).all()
    assert tsb(gen, 51, 1, batch=3).shape == (3, 50, 1)
    jb2 = np.asarray(sample_boundary(jax.random.PRNGKey(0), 41, 2))
    tb2 = tsb(gen, 41, 2).numpy()
    assert tb2.shape == jb2.shape == (40, 2)
    for pts in (jb2, tb2):
        strips = pts.reshape(4, 10, 2)
        assert (np.abs(strips[0, :, 1] + 1.0) <= 1e-4 + 1e-7).all()
        assert (np.abs(strips[1, :, 1] - 1.0) <= 1e-4 + 1e-7).all()
        assert (np.abs(strips[2, :, 0] + 1.0) <= 1e-4 + 1e-7).all()
        assert (np.abs(strips[3, :, 0] - 1.0) <= 1e-4 + 1e-7).all()


def test_non_siren_network_refused(tmp_path):
    """No network is refused any more: the hash grid, the last one the port
    lacked, builds the model and takes the generic Solver for the advect
    phase (no fused fit), as relu and elu nets do (the tests below)."""
    cfg = TConfig(proj_dir=str(tmp_path), device="cpu", network="hashgrid",
                  **BASE)
    tm = tadv.Advection1DModel(cfg)
    assert type(tm.net).__name__ == "HashGridField"
    assert tm.advect_solver is None
    assert set(tm.fields["field"]) == {"tables", "head"}


def _grad_leaves(tree):
    """A hash grid's parameter (or gradient) tree as its leaves in the JAX
    package's order (dict keys sorted: head, then tables)."""
    return ([t for wb in tree["head"] for t in wb] + list(tree["tables"]))


def test_hashgrid_advect_loss_matches_jax(tmp_path):
    """The pure `_advect_loss` of the hash-grid field (tables scaled up to
    O(1) entries so that the encoding carries the field) on JAX's points:
    loss terms at rtol 1e-5, gradients within 1e-5 of the largest entry."""
    _, _, jm, tm = _models(tmp_path, network="hashgrid")
    for name in ("field", "field_prev"):
        jm.fields[name] = {"tables": [t * 1e4 for t in
                                      jm.fields[name]["tables"]],
                           "head": jm.fields[name]["head"]}
    jm.fields["field_prev"] = {"tables": [t[::-1] for t in
                                          jm.fields["field_prev"]["tables"]],
                               "head": jm.fields["field_prev"]["head"]}
    tm.fields = fields_from_jax(jm.fields)
    key = jax.random.PRNGKey(7)
    jaux = {"prev": jm.fields["field_prev"]}

    def jtotal(p):
        ld = jm._advect_loss(p, key, jaux)
        return sum(ld.values()), ld

    (_, jld), jgrad = jax.value_and_grad(jtotal, has_aux=True)(
        jm.fields["field"])
    from insr_pde_tpu_torch.models.solver import ravel, unravel
    flat, spec = ravel(tm.fields["field"])
    flat = flat.requires_grad_(True)
    tld = tm._advect_loss(unravel(flat, spec),
                          _jax_points(jm, "advect", key),
                          {"prev": tm.fields["field_prev"]})
    sum(tld.values()).backward()
    assert set(tld) == set(jld) == {"main", "bc"}
    for k in jld:
        np.testing.assert_allclose(tld[k].item(), float(jld[k]), rtol=1e-5)
    jl = [np.asarray(a) for a in _grad_leaves(jgrad)]
    tl = _grad_leaves(unravel(flat.grad, spec))
    scale = max(float(np.abs(a).max()) for a in jl)
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_hashgrid_checkpoint_resumes_across_packages(tmp_path, writer):
    """A hash-grid advection run's checkpoint (`{"tables", "head"}` under
    the same path keys in both packages) loads leaf for leaf in the other
    package, and the run resumes there from it."""
    jcfg, tcfg, jm, tm = _models(tmp_path, network="hashgrid", seed=0,
                                 max_n_iters=5, chunk_size=5)
    jcfg.setup_dirs()
    tcfg.tag = "jax"          # one model dir for both packages
    src, dst = (jm, tm) if writer == "jax" else (tm, jm)
    src.fields["field"]["tables"][0] = src.fields["field"]["tables"][0] + 0.5
    src.timestep = 4
    src.save_ckpt()
    with np.load(os.path.join(jcfg.model_dir, "ckpt_step_t004.npz")) as d:
        assert "['field']['tables'][0]" in d.files
        assert "['field_prev']['head'][2][1]" in d.files
    dst.load_ckpt("latest")
    assert dst.timestep == 4
    for name in ("field", "field_prev"):
        for a, b in zip(_grad_leaves(src.fields[name]),
                        _grad_leaves(dst.fields[name])):
            a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
            b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
            np.testing.assert_array_equal(a, b)
    if writer == "jax":
        tm.cfg.setup_dirs()
        res = tm.step()
        assert tm.timestep == 5 and res.n_iters == 5


def test_relu_advect_loss_matches_jax(tmp_path):
    """The pure `_advect_loss` of a relu net (u and du/dx by vmapped
    jacfwd in both packages) on JAX's points: loss terms and gradients at
    rtol 1e-5 (atol 1e-5 of the largest gradient entry)."""
    _, _, jm, tm = _models(tmp_path, nonlinearity="relu")
    assert tm.advect_solver is None
    key = jax.random.PRNGKey(7)
    jaux = {"prev": jm.fields["field_prev"]}

    def jtotal(p):
        ld = jm._advect_loss(p, key, jaux)
        return sum(ld.values()), ld

    (_, jld), jgrad = jax.value_and_grad(jtotal, has_aux=True)(
        jm.fields["field"])
    tparams = [(w.clone().requires_grad_(True), b.clone().requires_grad_(True))
               for w, b in tm.fields["field"]]
    tld = tm._advect_loss(tparams, _jax_points(jm, "advect", key),
                          {"prev": tm.fields["field_prev"]})
    sum(tld.values()).backward()
    assert set(tld) == set(jld) == {"main", "bc"}
    for k in jld:
        np.testing.assert_allclose(tld[k].item(), float(jld[k]), rtol=1e-5)
    for jl, tl in zip(jax.tree_util.tree_leaves(jgrad),
                      [t for wb in tparams for t in wb]):
        jl = np.asarray(jl)
        np.testing.assert_allclose(tl.grad.numpy(), jl, rtol=1e-5,
                                   atol=1e-5 * np.abs(jl).max())


def test_relu_advect_phase_runs_the_generic_solver(tmp_path):
    """2x20 relu net, -sr 500, 200 iterations: the advect phase (as `step`
    runs it, against a previous field that differs from the trained one, so
    that the residual starts far from its minimum) is the generic Solver on
    `_advect_loss`, with no fused fit and no launch, and the residual
    drops."""
    _, tcfg, _, tm = _models(tmp_path, nonlinearity="relu",
                             sample_resolution=500, max_n_iters=200,
                             chunk_size=100, lr=1e-3)
    tcfg.setup_dirs()
    before = af.advect_fit.launches
    tm.begin_timestep()
    res = tm._run_phase("advect", tm._advect_loss, tm._advect_points,
                        tm.fields["field"],
                        aux={"prev": tm.fields["field_prev"]},
                        solver=tm.advect_solver)
    assert type(tm._solvers["advect"]) is tadv.Solver
    assert res.n_iters == 200 and af.advect_fit.launches == before
    main = res.history["main"]
    assert np.isfinite(main).all()
    assert main[-10:].mean() < 0.5 * main[:10].mean()
    tm.tb.close()


def test_debug_nan_warns_once_per_chunk_as_jax(tmp_path):
    """A NaN in one weight of the trained field: every gradient holds NaN,
    no iteration writes, and both packages warn once per chunk (two chunks
    of 10) with the same message."""
    jcfg, tcfg, jm, tm = _models(tmp_path, max_n_iters=20, chunk_size=10,
                                 debug_nan=True)
    jcfg.setup_dirs()
    tcfg.setup_dirs()
    w0, b0 = jm.fields["field"][1]
    jm.fields["field"][1] = (w0.at[3, 4].set(np.nan), b0)
    tm.fields["field"][1][0][3, 4] = float("nan")
    jm.begin_timestep()
    tm.begin_timestep()
    found = {}
    for name, run in (
            ("jax", lambda: jm._run_phase(
                "advect", jm._advect_loss, jm.fields["field"],
                aux={"prev": jm.fields["field_prev"]})),
            ("port", lambda: tm._run_phase(
                "advect", tm._advect_loss, tm._advect_points,
                tm.fields["field"], aux={"prev": tm.fields["field_prev"]},
                solver=tm.advect_solver))):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            run()
        found[name] = [str(w.message) for w in caught
                       if "NaN gradients" in str(w.message)]
    assert found["port"] == found["jax"] == [
        "NaN gradients detected in chunk ending at iteration 10",
        "NaN gradients detected in chunk ending at iteration 20"]
    tm.tb.close()


def test_advect_phase_counts_no_launch_on_the_cpu(tmp_path):
    _, tcfg, _, tm = _models(tmp_path, max_n_iters=20, chunk_size=10)
    tcfg.setup_dirs()
    before = af.advect_fit.launches
    tm.timestep = 0
    res = tm.step()
    assert res.n_iters == 20 and af.advect_fit.launches == before
    tm.tb.close()
