"""The port's bench: the counterpart of the repo's `bench.py`, on one NVIDIA
card, with every output checked in the same run.

    python -m insr_pde_tpu_torch.bench [--workload all | NAME[,NAME...]]
        [--seed S] [--reps N] [--iters N] [--adv_iters N] [--cgls_iters N]
        [--device cuda]

Four workloads, run in this order, each through the port's model classes
as `bench.py` drives the JAX ones, and each passing through the port's
kernels on the card:

* `fluid`: the paper-scale 2D fluid timestep (`scripts/fluid2Dtlgn.sh`:
  SIREN 3x32, -sr 128 = 16,384 points an iteration, 3,000 Adam iterations
  in each of the three phases, early stop off). Timed unit: one
  `model.step()` after `initialize()` and one warm-up step; 5 reps. The
  pressure phase runs the vgl kernel pair (`csrc/siren_vgl.cu`) every
  iteration.
* `advect1d`: `scripts/advect1D.sh` (SIREN 2x20, 5,000 points, 2,000
  iterations a step). Timed unit: ADV_STEPS_PER_REP steps, divided by
  their number; 5 reps. Each step is one launch of `csrc/advect_fit.cu`.
* `vortex_channel`: `bench.py`'s channel `VortexConfig` (stream form,
  243,210 rows, one Picard iteration of 400 block-whitened CGLS iterations
  from zero, the whitener recomputed each call; not `--preset channel`,
  which reuses it and warm-starts). Timed unit: one `matrix_solver()` after
  a warm-up call; 3 reps. Each CGLS iteration launches the block-ELL mv
  and rmv kernels (`csrc/block_ell.cu`).
* `elasticity_lucy`: the lucy scene of `scripts/elasticity3Dlucy.sh` at
  3x128 on the `statue_tet_mesh(32)` stand-in (`yardsticks.ELA_3D_ARGS`),
  300 iterations a fit, early stop off. Timed unit: one `model.step()` for
  t = 2, 3 and 4 after the init fit and the warm-up step t = 1; exactly 3
  reps, the t the JAX bars exist for. The history nets run the SIREN
  forward kernel (`csrc/siren_forward.cu`) twice an iteration.

Timing: the host clock around work that ends in a device synchronise, with
tracing off, after the warm-up (which takes the first nvcc build and the
first launches). A workload reports its median, min, mean, spread
((max - min) / min, `bench.py`'s), sample count and the highest percentile
that has at least ten samples beyond it (null below that many samples).
Per-layer numbers come from one traced unit after the timed reps: the
device busy share (`phase_trace.device_summary`), and the kernel launch
counts over one timed unit (the wrappers' counters).

Outputs are checked in the same run; the bars are stated beside their
constants below. The command prints what failed and exits 1 when a check
fails, and raises when a workload raises: no failure becomes a number. The
last line of standard output is one JSON object of every metric.

`fluid_achieved_gflops` counts the matrix products of one iteration of
each fluid phase from the widths and point counts (`fluid_flops_per_iter`,
2 per multiply-add); the sines, the elementwise chain rules, Adam and the
sampling are left out, so it and the MFU against the H100's published
FP32 rate are floors. The eager baselines are the reference repo's runtime
(from-scratch eager PyTorch of the same per-iteration math, `bench.py`'s
own), timed on the same device: a denominator, not the port's plain
kernel versions, which never run on the card's path.

`--device cpu` exists for the tests; a CPU run's numbers are no device's.
Without a card, `--device cuda` (the default) raises.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .yardsticks import (ELA_3D_ARGS, ELA_3D_JAX, ELA_ITERS, ELA_MESH_N,
                         ELA_PLANE, ELA_PLANE_SLACK, TG_REL_L2_BAR,
                         advect_rel_l2)

# ---- the workloads' configurations, copied from the repo's bench.py ----

# fluid paper scale (bench.py:47-50, :65-77; scripts/fluid2Dtlgn.sh)
FLUID_SR = 128
FLUID_LAYERS, FLUID_HIDDEN = 3, 32
FLUID_ITERS = 3000
FLUID = dict(pde="fluid", init_cond="taylorgreen",
             num_hidden_layers=FLUID_LAYERS, hidden_features=FLUID_HIDDEN,
             sample_resolution=FLUID_SR, vis_resolution=32,
             max_n_iters=FLUID_ITERS, chunk_size=1000, early_stop=False,
             dt=0.05, vis_frequency=10 ** 9, backup_sources=False)
# advect1D (bench.py:51-58, :219-229; scripts/advect1D.sh)
ADV_ITERS_PER_STEP = 2000
ADV_N_SAMPLES = 5000
ADV_STEPS_PER_REP = 4
ADVECT1D = dict(pde="advection", init_cond="example1", num_hidden_layers=2,
                hidden_features=20, sample_resolution=ADV_N_SAMPLES,
                vis_resolution=200, max_n_iters=ADV_ITERS_PER_STEP,
                chunk_size=ADV_ITERS_PER_STEP, early_stop=False, dt=0.05,
                length=4.0, vel=0.25, vis_frequency=10 ** 9,
                backup_sources=False)
# the vortex channel Picard iteration (bench.py:303-304, :323-330)
VORTEX_CGLS_ITERS = 400
VORTEX_CHANNEL = dict(rho=1000.0, internal_v=8.0, n_spatial_basis=400,
                      time_num=10, collocation_pts_num=8000,
                      boundary_num=3200, picard_iters=1,
                      cgls_maxiter=VORTEX_CGLS_ITERS, cgls_tol=0.0,
                      cgls_chunk=200, cgls_restart=True, pou="smooth",
                      pou_time="simple", time_window=1, band_width=1.0,
                      stream_bc="both", w_bc=5.0, pou_normalize=True,
                      cgls_precondition="block")
# the lucy scene (chip_smoke.py's ELA_3D_ARGS, scripts/elasticity3Dlucy.sh)
# on statue_tet_mesh(mesh_n), early stop off
ELASTICITY_LUCY = dict(args=ELA_3D_ARGS, mesh_n=ELA_MESH_N,
                       iters=ELA_ITERS)
# timed reps (bench.py:59, :304) and the eager baselines' timed iterations
# (bench.py:58)
REPS = {"fluid": 5, "advect1d": 5, "vortex_channel": 3, "elasticity_lucy": 3}
TORCH_MEASURE_ITERS = 20
WORKLOADS = ("fluid", "advect1d", "vortex_channel", "elasticity_lucy")
PHASES = ("advect_velocity", "solve_pressure", "projection")
# Adam iterations of each traced fit of the fluid phases and of the
# elasticity step: a profiler session over a whole 9,000-iteration fluid
# unit would hold ~3.4 million device events
FLUID_TRACE_ITERS = 50
ELA_TRACE_ITERS = 30

# NVIDIA's published dense FP32 rate of one H100 SXM (no tensor cores: the
# port runs f32 with TF32 off), for the MFU
H100_FP32_PEAK_FLOPS = 67e12

# ---- the bars ----
# fluid: velocity rel L2 against analytic Taylor-Green at every t
# (yardsticks.TG_REL_L2_BAR, PERF.md section 2).
# advect1d: rel L2 against the closed form (yardsticks.advect_rel_l2) at
# every t, under 3x the JAX package's worst t at this workload's settings:
# `python tests/bench_reference_jax.py advect1d` on a CPU (JAX 0.9.0, the
# bench's steps: the init fit, the warm-up step and 5 reps of 4 steps,
# t = 0..21; its rel L2 grows from 7.229e-3 at t = 0 to 1.204e-2 at t = 17
# and stays there).
ADVECT1D_REL_L2_JAX = 1.2044139206409454e-2
ADVECT1D_REL_L2_BAR = 3.0 * ADVECT1D_REL_L2_JAX
# vortex_channel: after every call the inlet error and max |u| of the
# sampled field, each under 3x the JAX package's worst at bench.py's config
# (`python tests/bench_reference_jax.py vortex_channel` on a CPU, JAX 0.9.0:
# the warm-up call and 3 reps, one Picard iteration of 400 CGLS iterations
# from zero each: inlet error 8.724e-4, 9.788e-4, 7.739e-4, 1.0001e-3; max
# |u| 42.30, 146.64, 95.44, 149.83). chip_smoke.py's bars (inlet error
# 1e-2, max |u| 100) were set at 3 Picard iterations of 2,000, warm-started
# with the whitener kept: at this config JAX itself passes max |u| 100.
VORTEX_INLET_ERROR_JAX = 1.0000865440815687e-3
VORTEX_INLET_ERROR_BAR = 3.0 * VORTEX_INLET_ERROR_JAX
VORTEX_MAX_U_JAX = 149.8251953125
VORTEX_MAX_U_BAR = 3.0 * VORTEX_MAX_U_JAX
# elasticity_lucy: z_min and z_mean at every t within 2x the JAX seeds'
# spread of their mean (yardsticks.ELA_3D_JAX), and z_min at the last t at
# least ELA_PLANE - ELA_PLANE_SLACK.

# ---- statistics ----

def percentile_with_tail(samples: List[float], least: int = 10):
    """The highest of the 99.9th, 99th, 95th, 90th, 75th and 50th
    percentiles (nearest rank) that has at least `least` samples above its
    rank, as {"p": p, "value": v}; None where there are too few samples."""
    s = sorted(samples)
    n = len(s)
    for p in (99.9, 99.0, 95.0, 90.0, 75.0, 50.0):
        rank = math.ceil(n * p / 100.0)
        if rank >= 1 and n - rank >= least:
            return {"p": p, "value": s[rank - 1]}
    return None


def summarize(samples: List[float]) -> dict:
    """median, min, mean, spread (bench.py's (max - min) / min, percent),
    the sample count and `percentile_with_tail`."""
    s = sorted(samples)
    n = len(s)
    if n == 0:
        raise ValueError("no samples")
    mid = n // 2
    median = s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])
    return {"median": median, "min": s[0], "mean": sum(s) / n,
            "spread_pct": (s[-1] - s[0]) / s[0] * 100.0, "n": n,
            "pctl": percentile_with_tail(s)}


def _stats_keys(name: str, samples: List[float], unit: str) -> dict:
    st = summarize(samples)
    out = {f"{name}_{k}": v for k, v in st.items()}
    out[f"{name}_unit"] = unit
    out[f"{name}_samples"] = list(samples)
    return out


# ---- the fluid FLOP count ----

def _macs(widths: List[int]) -> int:
    """Multiply-adds of one forward of an MLP of `widths` at one point."""
    return sum(a * b for a, b in zip(widths[:-1], widths[1:]))


def fluid_flops_per_iter(vel_widths: List[int], p_widths: List[int],
                         n: int, nb: int) -> Dict[str, int]:
    """Matrix-product FLOPs (2 per multiply-add) of one Adam iteration of
    each split fluid phase, n interior points and nb points on each of the
    two boundary strips. With F the multiply-adds of one forward at one
    point, w0 those of the first layer, d the input dimension:

    * a trained forward (value, backprop to the weights): F forward, F for
      the weight gradients, F - w0 for the activations' cotangents (the
      coordinates take none): T = 3 F - w0;
    * a frozen forward: F; a frozen value+Jacobian chain: (d + 1) F;
    * advect: the trained velocity and the frozen one at x and at the
      backtraced point, per interior point; the trained velocity per
      boundary point;
    * pressure: the frozen velocity's value+Jacobian chain and the
      value+gradient+Laplacian chain of the pressure net (the vgl pair:
      forward (d + 2) F, backward the forward again and 2 (d + 2) F for the
      weight gradients and cotangents) per interior point; per boundary
      point the trained value+Jacobian chain of the pressure net, whose
      value the Neumann term leaves unread (its last layer's value product
      takes no backward);
    * projection: the frozen velocity, the frozen pressure's value+Jacobian
      chain and the trained velocity per interior point; the trained
      velocity per boundary point."""
    d = vel_widths[0]
    fv, fp = _macs(vel_widths), _macs(p_widths)
    tv = 3 * fv - vel_widths[0] * vel_widths[1]
    p_last = p_widths[-2] * p_widths[-1]
    p_bc = (d + 1) * (3 * fp - p_widths[0] * p_widths[1]) - 2 * p_last
    macs = {
        "advect_velocity": n * (tv + 2 * fv) + 2 * nb * tv,
        "solve_pressure": n * ((d + 1) * fv + 4 * (d + 2) * fp)
        + 2 * nb * p_bc,
        "projection": n * (fv + (d + 1) * fp + tv) + 2 * nb * tv,
    }
    return {k: 2 * v for k, v in macs.items()}


# ---- device, counters, tracing ----

def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_record(device: torch.device) -> dict:
    """The card's name, power limit and count (`nvidia-smi`), or the CPU."""
    if device.type != "cuda":
        return {"platform": "cpu", "name": "cpu", "power_limit_w": None,
                "count": 0}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    limit = re.match(r"\s*([0-9.]+)", smi.rsplit(",", 1)[-1])
    return {"platform": "gpu", "name": torch.cuda.get_device_name(0),
            "power_limit_w": float(limit.group(1)) if limit else None,
            "count": torch.cuda.device_count(), "nvidia_smi": smi}


def _counters():
    from .ops import block_ell
    from .ops.advect_fit import advect_fit
    from .ops.siren_forward import siren_forward
    from .ops.siren_vgl import siren_vgl
    return block_ell, advect_fit, siren_forward, siren_vgl


def reset_launches() -> None:
    """Every kernel's launch count and every route count (`read_routes`)
    to 0."""
    block_ell, advect_fit, siren_forward, siren_vgl = _counters()
    siren_forward.launches = 0
    siren_vgl.fwd_launches = 0
    siren_vgl.bwd_launches = 0
    advect_fit.launches = 0
    block_ell.mv_launches = 0
    block_ell.rmv_launches = 0
    siren_vgl.chain_routes = 0
    siren_forward.apply_routes = 0
    advect_fit.solver_routes = 0


def read_launches() -> Dict[str, int]:
    """Each kernel's launches since `reset_launches`, by the names
    chip_smoke.py prints."""
    block_ell, advect_fit, siren_forward, siren_vgl = _counters()
    return {"siren_forward": siren_forward.launches,
            "siren_vgl_forward": siren_vgl.fwd_launches,
            "siren_vgl_backward": siren_vgl.bwd_launches,
            "advect_fit": advect_fit.launches,
            "block_ell_mv": block_ell.mv_launches,
            "block_ell_rmv": block_ell.rmv_launches}


def read_routes() -> Dict[str, int]:
    """The calls since `reset_launches` whose shapes a kernel does not take
    and which went to the JAX package's route in plain PyTorch instead:
    the forward-Laplacian chain, `MLP.apply`, the generic advect Solver."""
    _, advect_fit, siren_forward, siren_vgl = _counters()
    return {"chain_routes": siren_vgl.chain_routes,
            "apply_routes": siren_forward.apply_routes,
            "solver_routes": advect_fit.solver_routes}


def check_no_routes(failures: List[str], name: str) -> None:
    """A failure unless every call of the run since `reset_launches` went
    to its kernel's route (no shape went past a kernel)."""
    routes = read_routes()
    _check(failures, not any(routes.values()),
           f"{name}: shapes its kernels do not take went to plain PyTorch "
           f"{routes}")


def traced_busy_ms(fn: Callable[[], object], device: torch.device,
                   per: int = 1) -> Optional[float]:
    """Device busy ms of one call of `fn` (after one untraced call) under
    torch.profiler, divided by `per`; None where the profiler recorded no
    device event (a CPU run)."""
    from torch.profiler import ProfilerActivity, profile
    from .phase_trace import device_summary
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    fn()
    _sync(device)
    with profile(activities=activities) as prof:
        fn()
        _sync(device)
    events, busy, _ = device_summary(prof, per)
    return busy if events else None


def _share(busy_ms: Optional[float], wall_ms: float) -> Optional[float]:
    return None if busy_ms is None else busy_ms / wall_ms


def _check(failures: List[str], ok: bool, what: str) -> None:
    if not ok:
        failures.append(what)


def _timed(fn: Callable[[], object], device: torch.device) -> float:
    _sync(device)
    tic = time.perf_counter()
    fn()
    _sync(device)
    return time.perf_counter() - tic


def _progress(msg: str) -> None:
    print(f"[bench] {msg}", flush=True)


# ---- the eager baselines (the repo's bench.py:118-211 and :240-300) ----

def _eager_siren(fi: int, fo: int, layers: int, hidden: int,
                 device: torch.device, omega: float = 30.0):
    dims = [(fi, hidden)] + [(hidden, hidden)] * layers + [(hidden, fo)]
    mods = []
    for i, (a, b) in enumerate(dims):
        lin = torch.nn.Linear(a, b)
        bound = (1.0 / a) if i == 0 else (6.0 / a) ** 0.5 / omega
        torch.nn.init.uniform_(lin.weight, -bound, bound)
        mods.append(lin)

    class Siren(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.layers = torch.nn.ModuleList(mods)

        def forward(self, x):
            h = x
            for i, lin in enumerate(self.layers):
                h = lin(h)
                if i < len(self.layers) - 1:
                    h = torch.sin(omega * h)
            return h

    return Siren().to(device)


def fluid_torch_baseline(config: dict, device: torch.device, seed: int = 0,
                         measure_iters: int = TORCH_MEASURE_ITERS) -> float:
    """Seconds per fluid timestep of the reference's runtime: the three
    phases' per-iteration math in eager PyTorch (same nets, points, nested
    autograd Laplacian, torch.optim.Adam), `measure_iters` iterations of
    each phase timed after two warm-up iterations, scaled to the config's
    iterations per phase."""
    torch.manual_seed(seed)
    n = config["sample_resolution"] ** 2
    nb = n // 100
    layers, hidden = config["num_hidden_layers"], config["hidden_features"]
    dt = config["dt"]
    vel = _eager_siren(2, 2, layers, hidden, device)
    vel_prev = _eager_siren(2, 2, layers, hidden, device)
    vel_prev.load_state_dict(vel.state_dict())
    pnet = _eager_siren(2, 1, layers, hidden, device)
    opt_v = torch.optim.Adam(vel.parameters(), lr=1e-4)
    opt_p = torch.optim.Adam(pnet.parameters(), lr=1e-4)

    def rand(k):
        return torch.rand(k, 2, device=device) * 2.0 - 1.0

    def advect_iter():
        x = rand(n)
        with torch.no_grad():
            back = (x - vel_prev(x) * dt).clamp(-1, 1)
            target = vel_prev(back)
        loss = ((vel(x) - target) ** 2).mean() \
            + (vel(rand(nb))[:, 0] ** 2).mean() \
            + (vel(rand(nb))[:, 1] ** 2).mean()
        opt_v.zero_grad()
        loss.backward()
        opt_v.step()

    def pressure_iter():
        x = rand(n).requires_grad_(True)
        u = vel(x)
        div = sum(torch.autograd.grad(u[:, i].sum(), x, retain_graph=True)[0]
                  [:, i] for i in range(2)).detach()
        x2 = rand(n).requires_grad_(True)
        gp = torch.autograd.grad(pnet(x2).sum(), x2, create_graph=True)[0]
        lap = sum(torch.autograd.grad(gp[:, i].sum(), x2,
                                      create_graph=True)[0][:, i]
                  for i in range(2))
        loss = ((div - lap) ** 2).mean()
        xb = rand(nb).requires_grad_(True)
        gb = torch.autograd.grad(pnet(xb).sum(), xb, create_graph=True)[0]
        loss = loss + (gb[:, 0] ** 2).mean() + (gb[:, 1] ** 2).mean()
        opt_p.zero_grad()
        loss.backward()
        opt_p.step()

    def project_iter():
        x = rand(n).requires_grad_(True)
        gp = torch.autograd.grad(pnet(x).sum(), x)[0]
        with torch.no_grad():
            target = vel_prev(x) - gp
        loss = ((vel(x) - target.detach()) ** 2).mean() \
            + (vel(rand(nb))[:, 0] ** 2).mean() \
            + (vel(rand(nb))[:, 1] ** 2).mean()
        opt_v.zero_grad()
        loss.backward()
        opt_v.step()

    total = 0.0
    for it in (advect_iter, pressure_iter, project_iter):
        it()
        it()
    for it in (advect_iter, pressure_iter, project_iter):
        total += _timed(lambda: [it() for _ in range(measure_iters)],
                        device) / measure_iters
    return total * config["max_n_iters"]


def advect_torch_baseline(config: dict, device: torch.device, seed: int = 0,
                          measure_iters: int = 100) -> float:
    """Seconds per advect1D timestep of the reference's runtime (eager
    PyTorch, the same per-iteration math and sizes), `measure_iters`
    iterations timed after five warm-up ones, scaled to the config's
    iterations per step."""
    torch.manual_seed(seed)
    n = config["sample_resolution"]
    half = config["length"] / 2.0
    dt, v = config["dt"], config["vel"]
    layers, hidden = config["num_hidden_layers"], config["hidden_features"]
    net = _eager_siren(1, 1, layers - 1, hidden, device)
    net_prev = _eager_siren(1, 1, layers - 1, hidden, device)
    net_prev.load_state_dict(net.state_dict())
    for p in net_prev.parameters():
        p.requires_grad_(False)
    opt = torch.optim.Adam(net.parameters(), lr=1e-4)

    def one_iter():
        x = ((torch.rand(n, 1, device=device) * 2.0 - 1.0) * half)
        x.requires_grad_(True)
        u = net(x)
        gu = torch.autograd.grad(u.sum(), x, create_graph=True)[0]
        x0 = x.detach().requires_grad_(True)
        u0 = net_prev(x0)
        gu0 = torch.autograd.grad(u0.sum(), x0)[0]
        loss = (((u - u0.detach()) / dt
                 + v * (gu + gu0.detach()) / 2.0) ** 2).mean()
        xb = torch.cat([torch.rand(25, 1, device=device) * 1e-4 - half,
                        torch.rand(25, 1, device=device) * 1e-4 + half])
        loss = loss + (net(xb) ** 2).mean()
        opt.zero_grad()
        loss.backward()
        opt.step()

    for _ in range(5):
        one_iter()
    sec = _timed(lambda: [one_iter() for _ in range(measure_iters)], device)
    return sec / measure_iters * config["max_n_iters"]


# ---- the workloads ----

def _model_config(config: dict, work_dir: str, device: str,
                  seed: Optional[int]):
    from .config import Config
    seeded = {} if seed is None else {"seed": seed}
    cfg = Config(proj_dir=work_dir, tag="bench", device=device, **seeded,
                 **config)
    cfg.setup_dirs()
    return cfg


def bench_fluid(config: dict, reps: int, device: torch.device,
                seed: Optional[int], work_dir: str) -> dict:
    """The split fluid timestep: `initialize()`, a warm-up step, then `reps`
    timed steps, each phase's iterations required to equal max_n_iters and
    the velocity held to analytic Taylor-Green at every t."""
    from .models.examples import taylorgreen_velocity
    from .models.fluid import Fluid2DModel
    from .ops.sampling import sample_uniform
    from .phase_trace import trace_fits

    cfg = _model_config(config, work_dir, device.type, seed)
    model = Fluid2DModel(cfg)
    iters = cfg.max_n_iters
    vr = cfg.vis_resolution
    tg = taylorgreen_velocity(sample_uniform(vr, 2, flatten=False),
                              rescale=True).numpy()
    failures: List[str] = []
    rel = []

    def check_field():
        u = model.sample_field(vr).cpu().numpy()
        r = float(np.linalg.norm(u - tg) / np.linalg.norm(tg))
        rel.append(r)
        _check(failures, math.isfinite(r) and r < TG_REL_L2_BAR,
               f"fluid t={model.timestep}: velocity rel L2 {r} vs analytic "
               f"Taylor-Green, bar {TG_REL_L2_BAR}")

    def check_iters(results):
        for res, phase in zip(results, PHASES):
            _check(failures, res.n_iters == iters,
                   f"fluid t={model.timestep} {phase}: {res.n_iters} "
                   f"iterations, not the fixed {iters}")

    model.initialize()
    check_field()
    check_iters(model.step())
    check_field()
    _progress(f"fluid: warm-up done (t={model.timestep})")
    times, phase_ms, launches = [], {p: [] for p in PHASES}, None
    for rep in range(reps):
        reset_launches()
        results = []
        times.append(_timed(lambda: results.append(model.step()), device))
        if launches is None:
            launches = read_launches()
        check_no_routes(failures, f"fluid rep {rep}")
        check_iters(results[0])
        for rec in model.phase_timings[-3:]:
            phase_ms[rec["tag"]].append(rec["sec"] / rec["n_iters"] * 1e3)
        check_field()
        _progress(f"fluid rep {rep}: {times[-1]:.3f} s")
    if device.type == "cuda":
        _check(failures, launches["siren_vgl_forward"] == iters
               and launches["siren_vgl_backward"] == iters,
               f"fluid: the vgl pair launched {launches} times in one "
               f"timestep, not once per pressure iteration ({iters})")

    # one traced fit of each phase (trace_fits synchronises the card)
    busy = dict.fromkeys(PHASES)
    for phase in PHASES if device.type == "cuda" else ():
        events, busy_ms, _ = trace_fits(model, phase, 1,
                                        FLUID_TRACE_ITERS)[0]
        busy[phase] = _share(busy_ms if events else None,
                             summarize(phase_ms[phase])["median"])
    widths_v = [2] + [cfg.hidden_features] * (cfg.num_hidden_layers + 1) \
        + [2]
    flops = fluid_flops_per_iter(widths_v, widths_v[:-1] + [1],
                                 model.n_samples, model.n_boundary)
    base = fluid_torch_baseline(config, device, seed or 0)
    median = summarize(times)["median"]
    flop_step = sum(flops.values()) * iters
    achieved = flop_step / median
    out = {"metric": f"fluid2d_paper_sec_per_timestep_{iters}x3iters",
           "value": median, "unit": "sec/timestep",
           **_stats_keys("fluid", times, "sec/timestep"),
           "fluid_iters_per_phase": iters,
           "fluid_ms_per_iter": median / (3 * iters) * 1e3,
           **{f"fluid_{p}_ms_per_iter": summarize(phase_ms[p])["median"]
              for p in PHASES},
           "fluid_gflop_per_iter": {p: f / 1e9 for p, f in flops.items()},
           "fluid_gflop_per_timestep": flop_step / 1e9,
           "fluid_achieved_gflops": achieved / 1e9,
           "fluid_mfu_vs_h100_fp32_peak": achieved / H100_FP32_PEAK_FLOPS,
           "fluid_torch_baseline_sec": base, "vs_baseline": base / median,
           "fluid_launches": launches, "fluid_busy_share": busy,
           "fluid_tg_rel_l2": rel, "fluid_tg_rel_l2_bar": TG_REL_L2_BAR}
    return _verdict("fluid", out, failures)


def bench_advect1d(config: dict, reps: int, device: torch.device,
                   seed: Optional[int], work_dir: str) -> dict:
    """1D advection: `initialize()`, a warm-up step, then `reps` timed reps
    of ADV_STEPS_PER_REP steps, the field at every t held to the closed
    form."""
    from .models.advection import Advection1DModel
    from .ops.sampling import sample_uniform

    cfg = _model_config(config, work_dir, device.type, seed)
    model = Advection1DModel(cfg)
    iters = cfg.max_n_iters
    failures: List[str] = []
    rel = []

    grid = sample_uniform(cfg.vis_resolution, 1, device=model.device) \
        * (cfg.length / 2.0)

    def check_fields(snaps):
        for t, params in snaps:
            with torch.no_grad():
                u = model.net.apply(params, grid)[..., 0].cpu().numpy()
            r = advect_rel_l2(u, cfg.vis_resolution, cfg.length, cfg.vel,
                              cfg.dt, t)
            rel.append(r)
            _check(failures, math.isfinite(r) and r < ADVECT1D_REL_L2_BAR,
                   f"advect1d t={t}: rel L2 {r} vs the closed form, bar "
                   f"{ADVECT1D_REL_L2_BAR}")

    def step(snaps):
        res = model.step()
        snaps.append((model.timestep, model.fields["field"]))
        _check(failures, res.n_iters == iters,
               f"advect1d t={model.timestep}: {res.n_iters} iterations, "
               f"not the fixed {iters}")

    model.initialize()
    snaps = [(model.timestep, model.fields["field"])]
    step(snaps)
    check_fields(snaps)
    _progress(f"advect1d: warm-up done (t={model.timestep})")
    times, launches = [], None

    def rep_fn(snaps):
        for _ in range(ADV_STEPS_PER_REP):
            step(snaps)

    for rep in range(reps):
        reset_launches()
        snaps = []
        times.append(_timed(lambda: rep_fn(snaps), device)
                     / ADV_STEPS_PER_REP)
        if launches is None:
            launches = read_launches()
        check_no_routes(failures, f"advect1d rep {rep}")
        check_fields(snaps)
        _progress(f"advect1d rep {rep}: {times[-1]:.4f} s a step")
    median = summarize(times)["median"]
    if device.type == "cuda":
        per_step = -(-iters // model.advect_solver.chunk_size)
        _check(failures,
               launches["advect_fit"] == ADV_STEPS_PER_REP * per_step,
               f"advect1d: advect_fit launched {launches['advect_fit']} "
               f"times in {ADV_STEPS_PER_REP} steps, expected "
               f"{ADV_STEPS_PER_REP * per_step}")
    busy = traced_busy_ms(lambda: rep_fn([]), device, ADV_STEPS_PER_REP)
    base = advect_torch_baseline(config, device, seed or 0)
    out = {**_stats_keys("advect1d", times, "sec/timestep"),
           "advect1d_sec_per_timestep": median,
           "advect1d_iters_per_step": iters,
           "advect1d_ms_per_iter": median / iters * 1e3,
           "advect1d_torch_baseline_sec": base,
           "advect1d_vs_baseline": base / median,
           "advect1d_launches": launches,
           "advect1d_busy_share": _share(busy, median * 1e3),
           "advect1d_rel_l2": rel,
           "advect1d_rel_l2_bar": ADVECT1D_REL_L2_BAR}
    return _verdict("advect1d", out, failures)


def bench_vortex_channel(config: dict, reps: int, device: torch.device,
                         seed: Optional[int], work_dir: str) -> dict:
    """The channel Picard iteration: a warm-up `matrix_solver()`, then
    `reps` timed calls, each followed by the inlet error and max |u|."""
    from .models.vortex import StreamVortexModel, VortexConfig, inlet_error

    seeded = {} if seed is None else {"seed": seed}
    cfg = VortexConfig(**config, **seeded,
                       log_dir=os.path.join(work_dir, "log"))
    model = StreamVortexModel(cfg, log=False, device=device)
    failures: List[str] = []
    inlet, max_u = [], []

    def check_field():
        e = inlet_error(model)
        vals = model.sample_field(cfg.vis_resolution)[0]
        m = float(vals[..., :cfg.n_velocity].abs().max())
        inlet.append(e)
        max_u.append(m)
        _check(failures, math.isfinite(e) and e <= VORTEX_INLET_ERROR_BAR,
               f"vortex_channel call {len(inlet) - 1}: inlet error {e}, bar "
               f"{VORTEX_INLET_ERROR_BAR}")
        _check(failures, math.isfinite(m) and m <= VORTEX_MAX_U_BAR,
               f"vortex_channel call {len(max_u) - 1}: max |u| {m}, bar "
               f"{VORTEX_MAX_U_BAR}")
        it = model.picard_timings[-1]["cgls_iters"]
        _check(failures, it == cfg.cgls_maxiter,
               f"vortex_channel: {it} CGLS iterations, not the fixed "
               f"{cfg.cgls_maxiter}")

    model.matrix_solver()
    check_field()
    _progress("vortex_channel: warm-up done")
    times, launches, breakdown = [], None, {}
    for rep in range(reps):
        reset_launches()
        times.append(_timed(model.matrix_solver, device))
        if launches is None:
            launches = read_launches()
        check_no_routes(failures, f"vortex_channel rep {rep}")
        breakdown = dict(model.picard_timings[-1])
        check_field()
        _progress(f"vortex_channel rep {rep}: {times[-1]:.3f} s")
    if device.type == "cuda":
        _check(failures, min(launches["block_ell_mv"],
                             launches["block_ell_rmv"]) >= cfg.cgls_maxiter,
               f"vortex_channel: block-ELL launches {launches} in one call, "
               f"fewer than one each per CGLS iteration "
               f"({cfg.cgls_maxiter})")
    median = summarize(times)["median"]
    busy = traced_busy_ms(model.matrix_solver, device)
    out = {**_stats_keys("vortex_channel", times, "sec/picard"),
           "vortex_channel_sec_per_picard": median,
           "vortex_channel_cgls_iters": cfg.cgls_maxiter,
           "vortex_assemble_s": breakdown["assemble_s"],
           "vortex_whiten_s": breakdown["whiten_s"],
           "vortex_solve_s": breakdown["solve_s"],
           "vortex_operand_mb": breakdown["operand_mb"],
           "vortex_cgls_ms_per_iter":
               breakdown["solve_s"] / breakdown["cgls_iters"] * 1e3,
           "vortex_channel_launches": launches,
           "vortex_channel_busy_share": _share(busy, median * 1e3),
           "vortex_inlet_error": inlet,
           "vortex_inlet_error_bar": VORTEX_INLET_ERROR_BAR,
           "vortex_max_u": max_u, "vortex_max_u_bar": VORTEX_MAX_U_BAR}
    return _verdict("vortex_channel", out, failures)


def elasticity_args(config: dict, mesh_path: str, work_dir: str,
                    device: str, seed: Optional[int]) -> List[str]:
    """The entry point's flags of the lucy workload: `config["args"]` with
    its Adam iterations a fit set to `config["iters"]` and early stop off."""
    args = [a for a in config["args"] if a != "--early_stop"]
    args[args.index("--max_n_iters") + 1] = str(config["iters"])
    seeded = [] if seed is None else ["--seed", str(seed)]
    return args + ["--no-early_stop", "--mesh_path", mesh_path, "--proj_dir",
                   work_dir, "--tag", "bench", "--device", device] + seeded


def bench_elasticity_lucy(config: dict, reps: int, device: torch.device,
                          seed: Optional[int], work_dir: str) -> dict:
    """The lucy drop: the init fit (t = 0), the warm-up step t = 1, then
    the timed steps t = 2 .. reps + 1, each t's z_min and z_mean held to
    the JAX package's seeds (ELA_3D_JAX), which exist for t <= 4 only."""
    from .config import parse_args
    from .elasticity_stats import step_stats
    from .geometry import statue_tet_mesh, write_medit
    from .models.elasticity import ElasticityModel
    from .models.solver import Solver

    n_t = len(ELA_3D_JAX["z_min"][0])
    if reps != n_t - 2:
        raise ValueError(f"elasticity_lucy: --reps must be {n_t - 2} (the "
                         f"timed steps t = 2..{n_t - 1}, the t the JAX bars "
                         f"ELA_3D_JAX exist for), got {reps}")
    mesh = os.path.join(work_dir, "statue.mesh")
    V, T = statue_tet_mesh(config["mesh_n"])
    write_medit(mesh, V, {"tetra": T})
    cfg = parse_args(elasticity_args(config, mesh, work_dir, device.type,
                                     seed))
    cfg.setup_dirs()
    model = ElasticityModel(cfg)
    iters = cfg.max_n_iters
    failures: List[str] = []
    stats = {"z_min": [], "z_mean": []}

    def check_field():
        t = model.timestep
        pts = model.sample_deformation().cpu().numpy().astype(np.float64)
        st = step_stats("3d", pts)
        for key, (means, spreads) in ELA_3D_JAX.items():
            stats[key].append(st[key])
            bar = 2.0 * spreads[t]
            _check(failures, abs(st[key] - means[t]) <= bar,
                   f"elasticity_lucy t={t}: {key} {st[key]}, JAX mean "
                   f"{means[t]}, bar {bar} (2x the seeds' spread)")

    def step():
        res = model.step()
        _check(failures, res.n_iters == iters,
               f"elasticity_lucy t={model.timestep}: {res.n_iters} "
               f"iterations, not the fixed {iters}")

    model.initialize()
    check_field()
    step()
    check_field()
    _progress("elasticity_lucy: warm-up done (t=1)")
    times, launches = [], None
    for rep in range(reps):
        reset_launches()
        times.append(_timed(step, device))
        if launches is None:
            launches = read_launches()
        check_no_routes(failures, f"elasticity_lucy rep {rep}")
        check_field()
        _progress(f"elasticity_lucy rep {rep} (t={model.timestep}): "
                  f"{times[-1]:.3f} s")
    z_end = stats["z_min"][-1]
    _check(failures, z_end >= ELA_PLANE - ELA_PLANE_SLACK,
           f"elasticity_lucy t={model.timestep}: z_min {z_end} more than "
           f"{ELA_PLANE_SLACK} below the plane z = {ELA_PLANE}")
    if device.type == "cuda":
        _check(failures, launches["siren_forward"] >= 2 * iters,
               f"elasticity_lucy: siren_forward launched "
               f"{launches['siren_forward']} times in one step, fewer than "
               f"twice per Adam iteration ({iters})")
    median = summarize(times)["median"]
    solver = Solver(model._deformation_loss, model._step_points,
                    lr=cfg.lr, max_n_iters=ELA_TRACE_ITERS,
                    chunk_size=ELA_TRACE_ITERS, early_stop=False)
    aux = {"prev": model.fields["deformation_prev"],
           "prev_prev": model.fields["deformation_prev_prev"],
           "external": True}
    busy = traced_busy_ms(lambda: solver.fit(model.fields["deformation"],
                                             aux), device, ELA_TRACE_ITERS)
    ms_per_iter = median / iters * 1e3
    out = {**_stats_keys("elasticity_lucy", times, "sec/timestep"),
           "elasticity_lucy_iters_per_step": iters,
           "elasticity_lucy_ms_per_iter": ms_per_iter,
           "elasticity_lucy_launches": launches,
           "elasticity_lucy_busy_share": _share(busy, ms_per_iter),
           "elasticity_lucy_z_min": stats["z_min"],
           "elasticity_lucy_z_mean": stats["z_mean"],
           "elasticity_lucy_z_min_last_bar": ELA_PLANE - ELA_PLANE_SLACK}
    return _verdict("elasticity_lucy", out, failures)


# the keys of the last line, beyond the per-workload statistics below
WORKLOAD_KEYS = {
    "fluid": ["metric", "value", "unit", "vs_baseline", "fluid_ms_per_iter",
              *[f"fluid_{p}_ms_per_iter" for p in PHASES],
              "fluid_gflop_per_iter", "fluid_gflop_per_timestep",
              "fluid_achieved_gflops", "fluid_mfu_vs_h100_fp32_peak",
              "fluid_torch_baseline_sec", "fluid_tg_rel_l2"],
    "advect1d": ["advect1d_sec_per_timestep", "advect1d_vs_baseline",
                 "advect1d_torch_baseline_sec", "advect1d_rel_l2"],
    "vortex_channel": ["vortex_channel_sec_per_picard",
                       "vortex_channel_cgls_iters", "vortex_assemble_s",
                       "vortex_whiten_s", "vortex_solve_s",
                       "vortex_operand_mb", "vortex_cgls_ms_per_iter",
                       "vortex_inlet_error", "vortex_max_u"],
    "elasticity_lucy": ["elasticity_lucy_ms_per_iter",
                        "elasticity_lucy_z_min", "elasticity_lucy_z_mean"],
}
STAT_KEYS = ("median", "min", "mean", "spread_pct", "n", "pctl", "unit",
             "launches", "busy_share", "correct", "failures")


def required_keys(workloads) -> List[str]:
    """Every key the last line carries for these workloads."""
    keys = ["device", "seed", "workloads"]
    for w in workloads:
        keys += WORKLOAD_KEYS[w] + [f"{w}_{k}" for k in STAT_KEYS]
    return keys


def _verdict(name: str, out: dict, failures: List[str]) -> dict:
    out[f"{name}_correct"] = not failures
    out[f"{name}_failures"] = failures
    return out


BENCHES = {"fluid": (bench_fluid, FLUID),
           "advect1d": (bench_advect1d, ADVECT1D),
           "vortex_channel": (bench_vortex_channel, VORTEX_CHANNEL),
           "elasticity_lucy": (bench_elasticity_lucy, ELASTICITY_LUCY)}


def workload_configs(args) -> Dict[str, dict]:
    """Each selected workload's configuration with the cuts of `args`."""
    names = WORKLOADS if args.workload == "all" else [
        w.strip() for w in args.workload.split(",")]
    unknown = set(names) - set(WORKLOADS)
    if unknown or not names:
        raise ValueError(f"--workload: unknown {sorted(unknown)}; choose "
                         f"'all' or a comma list of {', '.join(WORKLOADS)}")
    out = {}
    for name in WORKLOADS:
        if name not in names:
            continue
        config = dict(BENCHES[name][1])
        if name in ("fluid", "elasticity_lucy") and args.iters is not None:
            config["iters" if name == "elasticity_lucy"
                   else "max_n_iters"] = args.iters
        if name == "advect1d" and args.adv_iters is not None:
            config["max_n_iters"] = config["chunk_size"] = args.adv_iters
        if name == "vortex_channel" and args.cgls_iters is not None:
            config["cgls_maxiter"] = args.cgls_iters
        out[name] = config
    return out


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        "insr_pde_tpu_torch.bench", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="all",
                    help="'all' or a comma list of " + ", ".join(WORKLOADS))
    ap.add_argument("--seed", type=int, default=None,
                    help="every model's seed (default: each config's own, "
                         "as bench.py: 0, the vortex 213421)")
    ap.add_argument("--reps", type=int, default=None,
                    help="timed reps of every selected workload (default: "
                         + ", ".join(f"{k} {v}" for k, v in REPS.items())
                         + "; elasticity_lucy takes 3 only)")
    ap.add_argument("--iters", type=int, default=None,
                    help=f"Adam iterations a fit of fluid (default "
                         f"{FLUID_ITERS} a phase) and elasticity_lucy "
                         f"({ELA_ITERS})")
    ap.add_argument("--adv_iters", type=int, default=None,
                    help=f"Adam iterations a step of advect1d (default "
                         f"{ADV_ITERS_PER_STEP})")
    ap.add_argument("--cgls_iters", type=int, default=None,
                    help=f"CGLS iterations a call of vortex_channel (default "
                         f"{VORTEX_CGLS_ITERS})")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (raises without a card); cpu for the tests")
    return ap


def main(argv=None) -> int:
    from .ops.precision import resolve_device, set_full_precision
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    configs = workload_configs(args)
    set_full_precision()
    record = {"device": device_record(device), "seed": args.seed,
              "workloads": list(configs)}
    _progress(f"device {record['device']}; workloads {list(configs)}")
    for name, config in configs.items():
        reps = REPS[name] if args.reps is None else args.reps
        fn = BENCHES[name][0]
        tic = time.perf_counter()
        with tempfile.TemporaryDirectory() as work_dir:
            record.update(fn(config, reps, device, args.seed, work_dir))
        record[f"{name}_bench_s"] = time.perf_counter() - tic
        _progress(f"{name}: done in {record[f'{name}_bench_s']:.1f} s, "
                  f"correct {record[f'{name}_correct']}")
    failed = [f for name in configs for f in record[f"{name}_failures"]]
    for f in failed:
        print(f"[bench] FAILED: {f}", flush=True)
    # allow_nan=False: a NaN or infinity anywhere raises instead of printing
    print(json.dumps(record, allow_nan=False), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
