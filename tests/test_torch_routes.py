"""PyTorch port: SIREN shapes past a kernel's limits take the JAX package's
route, and every shape the kernels take still goes to them.

* Fluid at 3x256 (past the vgl pair's 128): the pressure and every other
  loss and gradient match the JAX package at rtol 1e-4, as
  `test_torch_fluid.py` holds them at 3x16, and one `step()` runs, its
  Laplacian through the forward-Laplacian chain (`siren_vgl.chain_routes`).
* Advection at 2x80 (past `advect_fit`'s shared memory): the advect phase
  through the generic `Solver` matches the JAX phase on JAX's points, as
  `test_torch_advection.py` holds the fused fit at 2x20, with
  `advect_solver is None` and `advect_fit.solver_routes` counting the fit.
* `apply_fused` at width 256 equals `apply` (`siren_forward.apply_routes`).
* The three `takes` predicates agree with the limits in `csrc/*.cu`: their
  constants, and the kernels' own shape checks built for the host; every
  published configuration (`scripts/*.sh`) routes to its kernel.
"""

import ctypes
import os
import re
import shlex

import jax
import numpy as np
import pytest
import torch

from insr_pde_tpu.config import Config as JConfig
from insr_pde_tpu.models.advection import Advection1DModel as JAdv
from insr_pde_tpu.models.fluid import Fluid2DModel as JFluid
from insr_pde_tpu.ops.sampling import (sample_boundary,
                                       sample_boundary2D_separate,
                                       sample_random, sample_uniform)
from insr_pde_tpu_torch.config import Config as TConfig
from insr_pde_tpu_torch.convert import fields_from_jax
from insr_pde_tpu_torch.models import advection as tadv
from insr_pde_tpu_torch.models import fluid as tfluid
from insr_pde_tpu_torch.models.networks import MLP
from insr_pde_tpu_torch.ops import advect_fit as af
from insr_pde_tpu_torch.ops import cuda_build
from insr_pde_tpu_torch.ops import siren_forward as sf
from insr_pde_tpu_torch.ops import siren_vgl as sv

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.from_numpy(np.array(a))


# ---- fluid at 3x256 ----

FLUID = dict(pde="fluid", init_cond="taylorgreen", num_hidden_layers=3,
             hidden_features=256, sample_resolution=8, vis_resolution=8,
             dt=0.05, backup_sources=False)


def _fluid(tmp_path, **over):
    kw = {**FLUID, **over}
    jm = JFluid(JConfig(proj_dir=str(tmp_path), tag="jax", **kw))
    tcfg = TConfig(proj_dir=str(tmp_path), tag="torch", device="cpu", **kw)
    tm = tfluid.Fluid2DModel(tcfg)
    tm.fields = fields_from_jax(
        {k: [(np.asarray(w), np.asarray(b)) for w, b in v]
         for k, v in jm.fields.items()})
    return tcfg, jm, tm


def _fluid_points(jm, kind, key):
    """The points JAX's loss draws from `key` (test_torch_fluid.py)."""
    n, nb = jm.n_samples, jm.n_boundary
    if kind == "pressure":
        k1, kx, ky = jax.random.split(key, 3)
    else:
        k1, k2 = jax.random.split(key)
        kx, ky = jax.random.split(k2)
    return {"x": _t(sample_random(k1, n, 2)),
            "bx": _t(sample_boundary2D_separate(kx, nb, "horizontal")),
            "by": _t(sample_boundary2D_separate(ky, nb, "vertical"))}


@pytest.mark.parametrize("name,field,aux,kind", [
    ("_pressure_loss", "pressure", {"vel": "velocity"}, "pressure"),
    ("_advect_loss", "velocity_prev", {"prev": "velocity"}, "bc"),
    ("_projection_loss", "velocity_prev",
     {"prev": "velocity", "pressure": "pressure"}, "bc"),
])
def test_fluid_at_width_256_matches_jax(tmp_path, name, field, aux, kind):
    """At 3x256 and -sr 8 each split loss and its gradient match the JAX
    package at rtol 1e-4 (`test_torch_fluid.py`'s bar); the pressure
    Laplacian goes through the chain, not the vgl pair."""
    _, jm, tm = _fluid(tmp_path)
    key = jax.random.PRNGKey(11)
    jaux = {k: jm.fields[v] for k, v in aux.items()}
    taux = {k: tm.fields[v] for k, v in aux.items()}

    def jtotal(p):
        ld = getattr(jm, name)(p, key, jaux)
        return sum(ld.values()), ld

    (_, jld), jgrad = jax.value_and_grad(jtotal, has_aux=True)(
        jm.fields[field])
    tparams = [(w.clone().requires_grad_(True),
                b.clone().requires_grad_(True)) for w, b in tm.fields[field]]
    chain0 = sv.siren_vgl.chain_routes
    tld = getattr(tm, name)(tparams, _fluid_points(jm, kind, key), taux)
    sum(tld.values()).backward()
    assert sv.siren_vgl.chain_routes - chain0 == (kind == "pressure")
    assert set(tld) == set(jld)
    for k in jld:
        np.testing.assert_allclose(tld[k].item(), float(jld[k]), rtol=1e-4)
    for jl, tl in zip(jax.tree_util.tree_leaves(jgrad),
                      [t for wb in tparams for t in wb]):
        jl = np.asarray(jl)
        tg = np.zeros_like(jl) if tl.grad is None else tl.grad.numpy()
        np.testing.assert_allclose(tg, jl, rtol=1e-4,
                                   atol=1e-4 * np.abs(jl).max())


def test_fluid_step_runs_at_width_256(tmp_path):
    """One split step at 3x256 (it raised at the vgl pair's width check
    before): finite fields, one chain route per pressure iteration, the
    output through `apply`, not the SIREN forward kernel."""
    tcfg, _, tm = _fluid(tmp_path, max_n_iters=4, chunk_size=4)
    tcfg.setup_dirs()
    chain0 = sv.siren_vgl.chain_routes
    apply0 = sf.siren_forward.apply_routes
    res_a, res_p, res_j = tm.step()
    assert res_p.n_iters == 4
    assert sv.siren_vgl.chain_routes - chain0 == 4
    assert all(np.isfinite(r.final_loss) for r in (res_a, res_p, res_j))
    tm.write_output(str(tmp_path))
    assert sf.siren_forward.apply_routes - apply0 == 1
    assert np.isfinite(np.load(tmp_path / f"t{tm.timestep:03d}.npy")).all()


# ---- advection at 2x80 ----

ADV = dict(pde="advection", init_cond="example1", num_hidden_layers=2,
           hidden_features=80, sample_resolution=500, vis_resolution=64,
           dt=0.05, backup_sources=False)


def test_advection_at_width_80_matches_jax_phase(tmp_path):
    """At 2x80 (over advect_fit's shared memory) the model builds no fused
    solver, and its advect phase, the generic Solver on `_advect_loss` fed
    JAX's per-iteration points, matches the JAX `_run_phase("advect")` as
    `test_torch_advection.py` holds the fused fit at 2x20 (100 iterations
    at lr 1e-3, two chunks; field rel L2 under 1e-3, histories within
    rtol 1e-3, the same iterations). Then `step()` runs, counted in
    `advect_fit.solver_routes`."""
    kw = {**ADV, "max_n_iters": 100, "chunk_size": 50, "lr": 1e-3}
    jm = JAdv(JConfig(proj_dir=str(tmp_path), tag="jax", **kw))
    tcfg = TConfig(proj_dir=str(tmp_path), tag="torch", device="cpu", **kw)
    tm = tadv.Advection1DModel(tcfg)
    tm.fields = fields_from_jax(jm.fields)
    assert tm.advect_solver is None
    tcfg.setup_dirs()
    jm.begin_timestep()
    tm.begin_timestep()
    state = {"key": jax.random.split(jm.key)[1]}  # what _next_key hands out
    jres = jm._run_phase("advect", jm._advect_loss, jm.fields["field"],
                         aux={"prev": jm.fields["field_prev"]})
    half = jm.length / 2.0

    def replay():
        state["key"], key = jax.random.split(state["key"])
        k1, k2 = jax.random.split(key)
        return {"x": _t(sample_random(k1, jm.n_samples, 1) * half),
                "xb": _t(sample_boundary(k2, jm.n_boundary, 1) * half)}

    tres = tm._run_phase("advect_replay", tm._advect_loss, replay,
                         tm.fields["field"],
                         aux={"prev": tm.fields["field_prev"]})
    g = sample_uniform(64, 1) * 2.0
    ju = np.asarray(jm.net.apply(jres.params, g))
    tu = tm.net.apply(tres.params, _t(g)).detach().numpy()
    assert np.linalg.norm(tu - ju) / np.linalg.norm(ju) < 1e-3
    assert tres.n_iters == jres.n_iters == 100
    for k in ("main", "bc", "_lr"):
        np.testing.assert_allclose(tres.history[k], jres.history[k],
                                   rtol=1e-3)
    tm.tb.close()
    routes0, launches0 = af.advect_fit.solver_routes, af.advect_fit.launches
    tm.step()
    assert af.advect_fit.solver_routes - routes0 == 1
    assert af.advect_fit.launches == launches0
    assert np.isfinite(tm.sample_field(16).numpy()).all()


# ---- apply_fused past the forward kernel's width ----

@pytest.mark.parametrize("width,routed", [(256, True), (128, False)])
def test_apply_fused_past_the_kernel_equals_apply(width, routed):
    net = MLP(3, 3, 2, width)
    params = net.init(torch.Generator().manual_seed(0))
    x = torch.rand((2, 7, 3), generator=torch.Generator().manual_seed(1))
    before = sf.siren_forward.apply_routes
    out = net.apply_fused(params, x)
    assert sf.siren_forward.apply_routes - before == int(routed)
    ref = net.apply(params, x)
    if routed:
        torch.testing.assert_close(out, ref, rtol=0, atol=0)
    else:
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=5e-5)


def test_a_call_past_a_kernel_fails_the_bench_workload(capsys):
    """The bench's guard (`check_no_routes`, also behind chip_smoke.py's
    main paths): a call routed past its kernel is a failure naming the
    count; `reset_launches` sets the counts to 0. The note of the route is
    for card tensors only."""
    from insr_pde_tpu_torch import bench
    bench.reset_launches()
    failures = []
    bench.check_no_routes(failures, "w")
    assert failures == []
    net = MLP(3, 3, 2, 256)
    net.apply_fused(net.init(torch.Generator().manual_seed(0)),
                    torch.rand((4, 3)))
    assert bench.read_routes() == {"chain_routes": 0, "apply_routes": 1,
                                   "solver_routes": 0}
    bench.check_no_routes(failures, "w")
    assert len(failures) == 1 and "'apply_routes': 1" in failures[0]
    assert "note:" not in capsys.readouterr().out
    bench.reset_launches()
    assert not any(bench.read_routes().values())


def test_check_inputs_still_raises_where_a_caller_forces_the_kernel():
    params = MLP(2, 1, 3, 256).init(torch.Generator().manual_seed(0))
    x = torch.rand((5, 2))
    with pytest.raises(ValueError, match="widths up to 128"):
        sf.siren_forward(params, x)
    with pytest.raises(ValueError, match="widths up to 128"):
        sv.siren_vgl(params, x)
    deep = MLP(3, 3, 30, 128).init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="backward's buffers"):
        sv.siren_vgl(deep, torch.rand((5, 3)))


# ---- the predicates against the CUDA sources ----

def _constant(path, name):
    m = re.search(rf"constexpr int {name} = (\d+)", path.read_text())
    assert m, (path, name)
    return int(m.group(1))


def test_predicates_take_the_constants_of_the_cuda_sources():
    tile = cuda_build.CSRC / "sine_mlp_tile.cuh"
    vgl = cuda_build.CSRC / "siren_vgl.cu"
    adv = cuda_build.CSRC / "advect_fit.cu"
    assert sf.MAX_WIDTH == _constant(tile, "MAX_WIDTH")
    assert sf.MAX_LAYERS == _constant(tile, "MAX_LAYERS")
    assert sv.SMEM_LIMIT == _constant(tile, "SMEM_LIMIT")
    assert sv.CG == _constant(tile, "CG")
    assert sv.MAX_DIM == _constant(vgl, "MAX_D")
    assert af.MAX_LAYERS == _constant(adv, "MAX_LAYERS")
    assert af.MAX_HIDDEN == _constant(adv, "MAX_HIDDEN")
    assert af.SMEM_LIMIT == _constant(adv, "SMEM_LIMIT")
    assert af.ROW_STEP == _constant(adv, "ROW_STEP")
    assert af.MAX_ROWS == _constant(adv, "MAX_ROWS")
    # the edges: the widest and deepest shapes each kernel takes
    assert sf.takes([2] + [128] * 32) and not sf.takes([2] + [128] * 33)
    assert not sf.takes([2, 129, 1])
    assert sv.takes([2] + [128] * 4 + [1], 2)
    assert not sv.takes([2] + [256] * 4 + [1], 2)
    assert not sv.takes([4, 32, 1], 4)
    assert sv.takes([3] + [128] * 30 + [3], 3)       # 31 layers fit
    assert not sv.takes([3] + [128] * 31 + [3], 3)   # 32: the backward not
    # the widest advect nets at 2, 3 and 4 hidden layers (5,050 rows)
    for width, layers in ((66, 2), (53, 3), (46, 4)):
        assert af.takes([1] + [width] * (layers + 1) + [1], 5050)
        assert not af.takes([1] + [width + 1] * (layers + 1) + [1], 5050)
    assert af.takes([1, 20, 1], 5050)                # one sine layer
    assert not af.takes([1, 1], 5050)                # none


def _vgl_cases():
    return [[2] + [w] * (k + 1) + [1] for w in (8, 64, 120, 128)
            for k in (1, 3, 8)] + \
        [[3] + [128] * k + [3] for k in (20, 30, 31, 32)] + \
        [[1, 96, 96, 1], [3, 128, 7, 128, 3]]


def test_vgl_predicate_agrees_with_the_kernel_in_host_emulation(
        tmp_path_factory):
    """`siren_vgl.takes` against the CUDA source's own test
    (`siren_vgl_backward_blocks`, which plans the backward's rows) built
    for the host."""
    from test_torch_siren_vgl import host_build
    lib = host_build("siren_vgl", tmp_path_factory.mktemp("routes_vgl"))
    fn = lib.siren_vgl_backward_blocks
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    for widths in _vgl_cases():
        c = (ctypes.c_int * len(widths))(*widths)
        kernel = fn(16384, widths[0], len(widths) - 1, c) > 0
        assert kernel == sv.takes(widths, widths[0]), widths


def test_advect_predicate_agrees_with_the_kernel_in_host_emulation(
        tmp_path_factory):
    """`advect_fit.takes` against the CUDA source's own test
    (`advect_fit_grid`: make_dims, then the row plan and the co-resident
    grid) built for the host."""
    import subprocess
    import shutil
    from test_torch_advect_fit import _EMULATION_H
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ (C++20) to build the CUDA source for the host")
    out = tmp_path_factory.mktemp("routes_adv")
    src = (cuda_build.CSRC / "advect_fit.cu").read_text()
    (out / "cuda_runtime.h").write_text(_EMULATION_H)
    (out / "cooperative_groups.h").write_text("#pragma once\n")
    (out / "advect_fit.cpp").write_text(
        src.replace("extern __shared__ float4 smem4[];", ""))
    lib = out / "libadvect_fit_emu.so"
    proc = subprocess.run([cxx, "-std=c++20", "-fno-gnu-unique", "-O1",
                           "-fPIC", "-shared", f"-I{out}", "-o", str(lib),
                           str(out / "advect_fit.cpp"), "-lpthread"],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    fn = ctypes.CDLL(str(lib)).advect_fit_grid
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    cases = [[1] + [w] * (k + 1) + [1] for w in (4, 20, 46, 47, 53, 54, 66,
                                               67, 80, 81)
             for k in (1, 2, 3, 4)] + [[1] + [8] * 16 + [1],
                                       [1] + [8] * 17 + [1], [1, 20, 1]]
    for widths in cases:
        c = (ctypes.c_int * len(widths))(*widths)
        kernel = fn(5050, len(widths) - 1, c) > 0
        assert kernel == af.takes(widths, 5050), widths


def _published():
    """(script, pde, {flag: value}) of every `main.py` configuration in
    scripts/*.sh."""
    out = []
    for name in sorted(os.listdir(os.path.join(REPO, "scripts"))):
        if not name.endswith(".sh"):
            continue
        text = open(os.path.join(REPO, "scripts", name)).read()
        text = text.replace("\\\n", " ")
        for line in text.splitlines():
            if "main.py" not in line.split("#")[0]:
                continue
            words = shlex.split(line.split("#")[0])
            if len(words) > 2 and words[1] == "main.py":
                flags = {}
                for i, w in enumerate(words):
                    if w.startswith("-") and i + 1 < len(words):
                        flags[w.lstrip("-")] = words[i + 1]
                out.append((name, words[2], flags))
    return out


def test_every_published_configuration_routes_to_its_kernel(tmp_path):
    cases = _published()
    assert {pde for _, pde, _ in cases} == {"advection", "fluid",
                                           "elasticity"}
    for name, pde, flags in cases:
        layers = int(flags["num_hidden_layers"])
        width = int(flags["hidden_features"])
        hidden = [width] * (layers + 1)
        if pde == "fluid":
            assert sv.takes([2] + hidden + [1], 2), name
            assert sf.takes([2] + hidden + [2]), name
        elif pde == "elasticity":
            dim = int(flags.get("dim", 3))
            assert sf.takes([dim] + hidden + [dim]), name
        else:
            sr = int(flags["sample_resolution"]
                     if "sample_resolution" in flags else flags["sr"])
            cfg = TConfig(pde="advection", proj_dir=str(tmp_path), tag=name,
                          device="cpu", init_cond="example1",
                          num_hidden_layers=layers, hidden_features=width,
                          sample_resolution=sr, backup_sources=False)
            assert tadv.Advection1DModel(cfg).advect_solver is not None, name
