"""PyTorch port, the bench (`python -m insr_pde_tpu_torch.bench`) against
the repo's `bench.py` and the JAX package, on the CPU at small sizes.

* Each workload's configuration equals its source: `bench.py`'s constants
  and `Config(...)`/`VortexConfig(...)` keywords, read with `ast` (importing
  `bench.py` would turn on the JAX compilation cache), and for the lucy
  workload `chip_smoke.py`'s `ELA_3D_ARGS`.
* Fixed work: with early stop off every phase of a port timestep runs the
  iterations the JAX `Fluid2DModel` runs at the same `Config` (all of them,
  under a plateau schedule that would latch early stop inside the fit;
  with early stop on, both packages stop early under it).
* The vortex operand size of the port's `picard_timings` equals the JAX
  model's.
* The fluid FLOP count's matrix products equal `FlopCounterMode`'s count
  of one iteration of each phase on the CPU plain path.
* `main` at small configs prints a last line with every key; a workload
  that raises makes it raise with no NaN printed; a zeroed field fails its
  check and `main` returns 1; `--device cuda` without a card raises; the
  statistics helper on fixed lists.
"""

import ast
import json
import math
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import chip_smoke as cs
from insr_pde_tpu_torch import bench
from insr_pde_tpu_torch.config import Config as TConfig
from insr_pde_tpu_torch.config import parse_args
from insr_pde_tpu_torch.models.fluid import Fluid2DModel as TFluid
from insr_pde_tpu_torch.models.solver import Solver, ravel

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---- (a) the configurations against their sources ----

def _bench_py():
    """bench.py's module-level constants and, per function name, the
    keywords of its Config(...) / VortexConfig(...) call (values evaluated
    against the constants; `proj_dir`/`log_dir`/`tag` dropped)."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    consts = {}

    def value(node):
        return eval(compile(ast.Expression(node), "bench.py", "eval"),
                    {}, dict(consts))

    for node in tree.body:
        if isinstance(node, ast.Assign):
            try:
                v = value(node.value)
            except NameError:
                continue
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    consts[tgt.id] = v
                elif isinstance(tgt, ast.Tuple):
                    for name, item in zip(tgt.elts, v):
                        consts[name.id] = item
    calls = {}
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        for node in ast.walk(fn):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                    and node.func.id in ("Config", "VortexConfig")):
                calls[fn.name] = {
                    kw.arg: value(kw.value) for kw in node.keywords
                    if kw.arg not in ("proj_dir", "log_dir", "tag")}
    return consts, calls


@pytest.mark.parametrize("workload", bench.WORKLOADS)
def test_config_equals_its_source(workload):
    consts, calls = _bench_py()
    if workload == "fluid":
        assert bench.FLUID == calls["_fluid_model"]
        assert bench.REPS["fluid"] == consts["REPS"] == 5
        assert bench.TORCH_MEASURE_ITERS == consts["TORCH_MEASURE_ITERS"]
        assert bench.FLUID_ITERS == consts["FLUID_ITERS"]
    elif workload == "advect1d":
        assert bench.ADVECT1D == calls["bench_advect"]
        assert bench.REPS["advect1d"] == consts["REPS"]
        assert bench.ADV_STEPS_PER_REP == consts["ADV_STEPS_PER_REP"]
    elif workload == "vortex_channel":
        assert bench.VORTEX_CHANNEL == calls["bench_vortex"]
        assert bench.REPS["vortex_channel"] == consts["VORTEX_REPS"]
        assert bench.VORTEX_CGLS_ITERS == consts["VORTEX_CGLS_ITERS"]
    else:
        cfg = bench.ELASTICITY_LUCY
        assert cfg["args"] == cs.ELA_3D_ARGS
        assert cfg["mesh_n"] == cs.ELA_MESH_N
        assert cfg["iters"] == cs.ELA_ITERS
        assert bench.REPS["elasticity_lucy"] == cs.ELA_STEPS - 1
        argv = bench.elasticity_args(cfg, "m.mesh", "/tmp/x", "cpu", None)
        got = parse_args(argv)
        want = parse_args(cs.ELA_3D_ARGS + ["--mesh_path", "m.mesh"])
        assert not got.early_stop and want.early_stop
        assert got.max_n_iters == want.max_n_iters == cs.ELA_ITERS
        for field in ("num_hidden_layers", "hidden_features",
                      "sample_resolution", "vis_resolution", "lr", "dt",
                      "energy", "ratio_volume", "ratio_arap",
                      "ratio_collide", "plane_height", "external_force_z",
                      "host_rng", "use_mesh"):
            assert getattr(got, field) == getattr(want, field), field


def test_cuts_apply_to_their_workloads():
    args = bench.parser().parse_args(
        ["--workload", "advect1d,fluid", "--iters", "7", "--adv_iters", "9",
         "--cgls_iters", "11"])
    configs = bench.workload_configs(args)
    assert list(configs) == ["fluid", "advect1d"]     # the bench's order
    assert configs["fluid"]["max_n_iters"] == 7
    assert configs["advect1d"]["max_n_iters"] == 9
    assert configs["advect1d"]["chunk_size"] == 9
    args = bench.parser().parse_args([])
    configs = bench.workload_configs(args)
    assert list(configs) == list(bench.WORKLOADS)
    assert configs["vortex_channel"]["cgls_maxiter"] == 400
    assert configs["elasticity_lucy"]["iters"] == cs.ELA_ITERS
    with pytest.raises(ValueError, match="unknown"):
        bench.workload_configs(bench.parser().parse_args(
            ["--workload", "fluid,nope"]))


# ---- (b) fixed work ----

@pytest.mark.parametrize("early_stop", [False, True])
def test_fluid_phase_iterations_against_jax(tmp_path, early_stop):
    """A plateau schedule (patience 2, threshold 0.5) that cuts the lr to
    its floor inside the fit: with early stop off both packages run every
    iteration of every phase; with it on both stop early (where depends on
    each package's point draws), so the schedule would latch."""
    from insr_pde_tpu.config import Config as JConfig
    from insr_pde_tpu.models.fluid import Fluid2DModel as JFluid
    kw = dict(bench.FLUID, sample_resolution=8, num_hidden_layers=1,
              hidden_features=8, max_n_iters=40, chunk_size=10,
              early_stop=early_stop, plateau_patience=2,
              plateau_threshold=0.5, lr=1e-3)
    jm = JFluid(JConfig(proj_dir=str(tmp_path), tag="jax", **kw))
    tm = TFluid(TConfig(proj_dir=str(tmp_path), tag="torch", device="cpu",
                        **kw))
    iters = {}
    for name, m in (("jax", jm), ("port", tm)):
        m.cfg.setup_dirs()
        m.initialize()
        iters[name] = [r.n_iters for r in m.step()]
    if early_stop:
        assert max(iters["port"] + iters["jax"]) < kw["max_n_iters"]
    else:
        assert iters["port"] == iters["jax"] == [kw["max_n_iters"]] * 3


# ---- (c) the vortex operand size ----

def test_vortex_operand_mb_equals_jax(tmp_path):
    from insr_pde_tpu.models import vortex as jv
    from insr_pde_tpu_torch.models import vortex as tv
    kw = dict(bench.VORTEX_CHANNEL, n_spatial_basis=64, time_num=3,
              collocation_pts_num=400, boundary_num=160, cgls_maxiter=10,
              cgls_chunk=5, log_dir=str(tmp_path))
    jm = jv.StreamVortexModel(jv.VortexConfig(**kw), log=False)
    tm = tv.StreamVortexModel(tv.VortexConfig(**kw), log=False,
                              device="cpu")
    jm.matrix_solver()
    tm.matrix_solver()
    got = tm.picard_timings[-1]["operand_mb"]
    assert got == jm.picard_timings[-1]["operand_mb"]
    assert got >= 1.0


# ---- (d) the FLOP count ----

@pytest.mark.parametrize("phase", bench.PHASES)
@pytest.mark.parametrize("layers,hidden,sr", [(3, 32, 16), (1, 12, 12)])
def test_fluid_flops_equal_flop_counter(tmp_path, phase, layers, hidden, sr):
    cfg = TConfig(**dict(bench.FLUID, sample_resolution=sr,
                         num_hidden_layers=layers, hidden_features=hidden),
                  proj_dir=str(tmp_path), device="cpu")
    m = TFluid(cfg)
    v, p = m.fields["velocity"], m.fields["pressure"]
    loss, params, aux = {
        "advect_velocity": (m._advect_loss, v, {"prev": v}),
        "solve_pressure": (m._pressure_loss, p, {"vel": v}),
        "projection": (m._projection_loss, v, {"prev": v, "pressure": p}),
    }[phase]
    solver = Solver(loss, m._points_with_bc, lr=1e-4, max_n_iters=1,
                    early_stop=False)
    flat, shapes = ravel(params)
    pts = m._points_with_bc()
    with FlopCounterMode(display=False) as counter:
        solver.value_and_grad(flat, shapes, pts, aux)
    widths = [2] + [hidden] * (layers + 1) + [2]
    want = bench.fluid_flops_per_iter(widths, widths[:-1] + [1],
                                      m.n_samples, m.n_boundary)[phase]
    assert counter.get_total_flops() == want


# ---- (e), (f) main at small configs ----

def _small(monkeypatch):
    """Every workload at a size that runs in seconds on one CPU core."""
    args = list(bench.ELA_3D_ARGS)
    for flag, v in (("--hidden_features", "8"), ("-sr", "3"), ("-vr", "40"),
                    ("--num_hidden_layers", "1")):
        args[args.index(flag) + 1] = v
    monkeypatch.setitem(bench.BENCHES, "fluid", (bench.bench_fluid, dict(
        bench.FLUID, sample_resolution=8, num_hidden_layers=1,
        hidden_features=8, max_n_iters=6, chunk_size=3, vis_resolution=8)))
    monkeypatch.setitem(bench.BENCHES, "advect1d", (
        bench.bench_advect1d, dict(bench.ADVECT1D, sample_resolution=100,
                                   max_n_iters=5, chunk_size=5,
                                   vis_resolution=20)))
    monkeypatch.setitem(bench.BENCHES, "vortex_channel", (
        bench.bench_vortex_channel, dict(
            bench.VORTEX_CHANNEL, n_spatial_basis=25, time_num=3,
            collocation_pts_num=64, boundary_num=32, cgls_maxiter=6,
            cgls_chunk=3)))
    monkeypatch.setitem(bench.BENCHES, "elasticity_lucy", (
        bench.bench_elasticity_lucy, dict(args=args, mesh_n=2, iters=3)))
    monkeypatch.setattr(bench, "FLUID_TRACE_ITERS", 2)
    monkeypatch.setattr(bench, "ELA_TRACE_ITERS", 2)
    monkeypatch.setattr(bench, "TORCH_MEASURE_ITERS", 2)


def _last_json(out):
    lines = [line for line in out.splitlines() if line.strip()]
    return json.loads(lines[-1]), lines


def test_main_prints_every_key(monkeypatch, capsys):
    _small(monkeypatch)
    rc = bench.main(["--device", "cpu", "--reps", "3"])
    rec, lines = _last_json(capsys.readouterr().out)
    assert rc == (0 if all(rec[f"{w}_correct"] for w in bench.WORKLOADS)
                  else 1)
    missing = [k for k in bench.required_keys(bench.WORKLOADS)
               if k not in rec]
    assert not missing, missing
    assert rec["device"] == {"platform": "cpu", "name": "cpu",
                             "power_limit_w": None, "count": 0}
    assert rec["workloads"] == list(bench.WORKLOADS)
    for w in bench.WORKLOADS:
        assert rec[f"{w}_n"] == 3 and rec[f"{w}_pctl"] is None
        assert rec[f"{w}_launches"].keys() == bench.read_launches().keys()
    # the value is the fluid median; the plain versions run on the CPU, so
    # no kernel launched and no device busy share was measured
    assert rec["value"] == rec["fluid_median"]
    assert all(v == 0 for w in bench.WORKLOADS
               for v in rec[f"{w}_launches"].values())
    assert rec["advect1d_busy_share"] is None
    assert len(rec["fluid_tg_rel_l2"]) == 5          # t = 0 .. 4
    assert len(rec["advect1d_rel_l2"]) == 2 + 3 * bench.ADV_STEPS_PER_REP
    assert len(rec["elasticity_lucy_z_min"]) == 5    # t = 0 .. 4
    assert not any("nan" in line.lower() for line in lines)


def test_a_workload_that_raises_makes_main_raise(monkeypatch, capsys):
    _small(monkeypatch)

    def broken(self):
        raise RuntimeError("a broken step")

    monkeypatch.setattr(TFluid, "step", broken)
    with pytest.raises(RuntimeError, match="a broken step"):
        bench.main(["--device", "cpu", "--workload", "fluid", "--reps", "2"])
    assert "nan" not in capsys.readouterr().out.lower()


def test_a_zeroed_field_fails_its_check(monkeypatch, capsys):
    _small(monkeypatch)
    from insr_pde_tpu_torch.models.advection import Advection1DModel
    step = Advection1DModel.step

    def zeroed(self):
        res = step(self)
        self.fields["field"] = [(torch.zeros_like(w), torch.zeros_like(b))
                                for w, b in self.fields["field"]]
        return res

    monkeypatch.setattr(Advection1DModel, "step", zeroed)
    rc = bench.main(["--device", "cpu", "--workload", "advect1d",
                     "--reps", "2"])
    out = capsys.readouterr().out
    rec, lines = _last_json(out)
    assert rc == 1 and rec["advect1d_correct"] is False
    # the init fit's t=0 field is not zeroed; every stepped one is
    assert all(r == 1.0 for r in rec["advect1d_rel_l2"][1:])
    assert any("FAILED: advect1d t=1: rel L2" in line for line in lines)
    assert "nan" not in out.lower()


def test_elasticity_takes_three_reps_only(monkeypatch):
    _small(monkeypatch)
    with pytest.raises(ValueError, match="--reps must be 3"):
        bench.main(["--device", "cpu", "--workload", "elasticity_lucy",
                    "--reps", "2"])


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        bench.main(["--workload", "advect1d"])


# ---- (h) the statistics ----

@pytest.mark.parametrize("samples,want", [
    ([3.0, 1.0, 2.0, 5.0, 4.0],
     {"median": 3.0, "min": 1.0, "mean": 3.0, "spread_pct": 400.0, "n": 5,
      "pctl": None}),
    ([2.0, 4.0, 4.0, 6.0],
     {"median": 4.0, "min": 2.0, "mean": 4.0, "spread_pct": 200.0, "n": 4,
      "pctl": None}),
    ([float(i) for i in range(1, 21)],
     {"median": 10.5, "min": 1.0, "mean": 10.5, "spread_pct": 1900.0,
      "n": 20, "pctl": {"p": 50.0, "value": 10.0}}),
    ([float(i) for i in range(100, 0, -1)],
     {"median": 50.5, "min": 1.0, "mean": 50.5, "spread_pct": 9900.0,
      "n": 100, "pctl": {"p": 90.0, "value": 90.0}}),
])
def test_summarize(samples, want):
    got = bench.summarize(samples)
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, float):
            assert math.isclose(got[k], v, rel_tol=1e-12), k
        else:
            assert got[k] == v, k
    # bench.py's spread formula
    assert math.isclose(got["spread_pct"],
                        (max(samples) - min(samples)) / min(samples) * 100)
