"""1D advection with constant velocity (counterpart of
`insr_pde_tpu/models/advection.py`).

A scalar field u(x) on [-L/2, L/2] as a SIREN, re-fitted every timestep to
the implicit-midpoint residual of du/dt + vel du/dx = 0 against the frozen
previous field, with a zero Dirichlet penalty on ~1% of the points.

Each loss is a pure function of (params, points, aux), the points drawn from
the model's generator by a separate step, so that the tests can hand both
packages the same points. `initialize` fits the initial condition through
the generic `Solver`. For the sine SIREN, `step`'s advect phase runs
through `ops/advect_fit.advect_fit`: on the card one launch of the
hand-written kernel per chunk of Adam iterations, on the CPU its plain
version; it computes the same loss as `_advect_loss`. Any other network
(`--nonlinearity relu|elu`) fits `_advect_loss` through the generic
`Solver`, as the JAX model fits every network.

A sine SIREN whose shape the kernel does not take (`advect_fit.takes`:
wider than MAX_HIDDEN, or buffers beyond its shared memory) fits the advect
phase through the generic `Solver` too, as the JAX package does at every
width; each such fit counts in `advect_fit.solver_routes`.

On more than one rank (`group`) the advect phase runs the generic `Solver`
for every network, the sine SIREN included: the fused fit is one launch per
chunk with no reduction across ranks inside it, and the JAX package's
sharded advection runs its generic `Solver` too. This is the sharded
configuration, not a fallback; on one rank the fused kernel stays the route.
"""

from __future__ import annotations

import os
import warnings
from typing import Callable, List, Tuple

import numpy as np
import torch

from ..ops import advect_fit as af
from ..ops.sampling import sample_boundary, sample_random, sample_uniform
from ..utils import viz
from ..utils.viz import draw_signal1D, save_figure
from .base import BaseModel
from .examples import get_examples
from .solver import AdamState, PlateauState, SolveState, Solver, ravel

# (n) -> (x (n, N), xb (n, NB)): the points of n advect iterations
TableFn = Callable[[int], Tuple[torch.Tensor, torch.Tensor]]


class FusedAdvectSolver(Solver):
    """A `Solver` of the advect phase whose every chunk is one
    `advect_fit` call on point tables from `table_fn` (the chunk loop,
    history, early stop and callback are `Solver.fit`'s). aux["prev"] is
    the frozen previous field. With `debug_nan` each chunk also returns
    the per-iteration `_nan` flag (any NaN in the gradient), and `fit`
    warns once per chunk that has one, as for any Solver."""

    def __init__(self, table_fn: TableFn, widths: List[int], *, dt: float,
                 vel: float, **options):
        super().__init__(None, None, **options)
        self.table_fn = table_fn
        self.widths = list(widths)
        kw = self._plateau_kw
        self.hyper = af.AdvectFitHyper(
            dt=dt, vel=vel, lr=self.lr, min_scale=kw["min_scale"],
            stop_scale=kw["stop_scale"], plateau_factor=kw["factor"],
            plateau_patience=kw["patience"],
            plateau_threshold=kw["threshold"], early_stop=kw["early_stop"])

    def _run_chunk(self, state: SolveState, shapes, aux, n):
        x, xb = self.table_fn(n)
        prev = ravel(aux["prev"])[0].detach()
        pl = state.plateau
        fit = af.AdvectFitState(
            state.params.contiguous(), state.opt.mu.contiguous(),
            state.opt.nu.contiguous(),
            torch.stack([state.opt.count, pl.bad,
                         pl.stopped.to(torch.int32)]).to(torch.int32),
            torch.stack([pl.best, pl.scale]).to(torch.float32))
        hist = af.advect_fit(fit, prev, x, xb, self.widths, self.hyper,
                             debug_nan=self.debug_nan)
        i, f = fit.istate, fit.fstate
        state = SolveState(fit.params, AdamState(fit.mu, fit.nu, i[0]),
                           PlateauState(f[0], i[1], f[1], i[2] != 0))
        return state, af.history_keys(self.debug_nan), hist


class Advection1DModel(BaseModel):
    def __init__(self, cfg, group=None):
        super().__init__(cfg, group)
        self.vel = cfg.vel
        self.length = cfg.length
        self.net = self._create_field("field", 1, 1)
        self._create_field("field_prev", 1, 1)
        if not cfg.init_cond:
            raise ValueError("advection requires --init_cond (e.g. example1)")
        self.init_cond_func = get_examples(cfg.init_cond)
        # the collocation budget per iteration, divided over the ranks of a
        # sharded run
        self.n_samples = max(1, self.sample_resolution // self.n_ranks)
        self.n_boundary = max(
            max(self.sample_resolution // 100, 10) // self.n_ranks, 2)
        # the advect phase's solver: the fused fit for a one-rank sine SIREN
        # whose shape the kernel takes, else None (`_run_phase` builds the
        # generic Solver on `_advect_loss`)
        self.advect_solver = None
        widths = self.net._widths if self.net._is_siren else None
        n_rows = self.n_samples + 2 * (self.n_boundary // 2)
        if self.net._is_siren and group is None:
            if af.takes(widths, n_rows):
                self.advect_solver = FusedAdvectSolver(
                    self._advect_tables, widths, dt=self.dt, vel=self.vel,
                    **self._solver_options())
            else:
                print(f"note: advection at widths {widths} fits the advect "
                      "phase with the generic Solver (the fused advect_fit "
                      "kernel does not take them)")
        elif self.net._is_siren and self.is_main:
            print(f"note: advection on {group.size} ranks fits the advect "
                  "phase with the generic Solver (the fused advect_fit "
                  "kernel has no reduction across ranks)")

    # ---- sampling steps (model generator) ----
    def _init_points(self):
        return {"x": sample_random(self.generator, self.n_samples,
                                   1).to(self.device) * (self.length / 2.0)}

    def _advect_points(self):
        """One iteration's points for `_advect_loss`: (N, 1) and (NB, 1)."""
        x, xb = self._advect_tables(1)
        return {"x": x[0][:, None], "xb": xb[0][:, None]}

    def _advect_tables(self, n: int):
        """The points of n advect iterations, drawn in bulk: x (n, N) and
        xb (n, NB), the JAX model's `sample_random * L/2` and
        `sample_boundary * L/2`."""
        half = self.length / 2.0
        x = sample_random(self.generator, n * self.n_samples,
                          1).to(self.device)
        xb = sample_boundary(self.generator, self.n_boundary, 1,
                             batch=n).to(self.device)
        return ((x * half).reshape(n, self.n_samples),
                (xb * half).reshape(n, -1))

    # ---- pure loss functions of (params, points, aux) ----
    def _init_loss(self, params, pts, aux):
        """MSE fit to the initial condition."""
        x = pts["x"]
        out = self.net.apply(params, x)
        return {"main": torch.mean((out - self.init_cond_func(x)) ** 2)}

    def _advect_loss(self, params, pts, aux):
        """Implicit midpoint residual + zero Dirichlet penalty: the loss that
        `advect_fit` minimizes, as a function for the generic Solver."""
        x = pts["x"]
        u, J = self.net.value_grad(params, x)
        with torch.no_grad():
            u0, J0 = self.net.value_grad(aux["prev"], x)
        dudt = (u - u0) / self.dt
        main = torch.mean((dudt + self.vel * (J[:, 0] + J0[:, 0]) / 2.0) ** 2)
        bc = torch.mean(self.net.apply(params, pts["xb"]) ** 2)
        return {"main": main, "bc": bc}

    # ---- field sampling / outputs ----
    @torch.no_grad()
    def sample_field(self, resolution, return_samples=False):
        """The current field on a uniform grid of the domain."""
        grid = sample_uniform(resolution, 1, device=self.device) \
            * (self.length / 2.0)
        out = self.net.apply(self.fields["field"], grid)[..., 0]
        if return_samples:
            return out, grid[..., 0]
        return out

    # ---- timestep protocol ----
    def initialize(self):
        self.begin_timestep()
        res = self._run_phase("initialize", self._init_loss,
                              self._init_points, self.fields["field"],
                              aux=None, vis_fn=self._vis_field)
        self.fields["field"] = res.params
        self.end_timestep()
        return res

    def step(self):
        """du/dt = -vel du/dx: one advect fit against the previous field."""
        self.begin_timestep()
        self.fields["field_prev"] = self.fields["field"]
        if (self.advect_solver is None and self.net._is_siren
                and self.n_ranks == 1):
            af.advect_fit.solver_routes += 1
        res = self._run_phase("advect", self._advect_loss,
                              self._advect_points, self.fields["field"],
                              aux={"prev": self.fields["field_prev"]},
                              vis_fn=self._vis_field,
                              solver=self.advect_solver)
        self.fields["field"] = res.params
        self.end_timestep()
        return res

    def _vis_field(self, params):
        values, samples = self.sample_field(self.vis_resolution,
                                            return_samples=True)
        fig = draw_signal1D(samples.cpu().numpy(), values.cpu().numpy(),
                            y_max=1.0)
        self.tb.add_figure("field", fig, global_step=self.train_step)

    def write_output(self, output_folder):
        """`tNNN.npz` (arr_0: the field on the -vr grid) and its PNG."""
        values, samples = self.sample_field(self.vis_resolution,
                                            return_samples=True)
        values = values.cpu().numpy()
        np.savez(os.path.join(output_folder, f"t{self.timestep:03d}.npz"),
                 values)
        if not viz.available():
            warnings.warn("matplotlib is not installed: write_output saves "
                          "tNNN.npz but not the PNG")
            return
        fig = draw_signal1D(samples.cpu().numpy(), values, y_max=1.0)
        save_figure(fig, os.path.join(output_folder,
                                      f"t{self.timestep:03d}.png"))
