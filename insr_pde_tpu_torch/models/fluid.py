"""2D inviscid fluid, operator splitting on [-1,1]^2 (counterpart of
`insr_pde_tpu/models/fluid.py`).

Velocity (2->2) and pressure (2->1) SIRENs. `--fluid_step split` (the
reference's timestep) makes three fits per step:
  1. semi-Lagrangian velocity advection against the frozen previous
     velocity, with zero normal-velocity BCs (`--advect_scheme semilag` or
     `maccormack`, `--advect_trace euler` or `rk2`, `--advect_sobolev w`
     to supervise the fit's Jacobian too),
  2. pressure Poisson solve (div u = lap p) with Neumann BCs, through the
     fused value+gradient+Laplacian kernels (`MLP.value_grad_laplacian`),
  3. velocity projection u <- u_prev - grad p.
`merged` keeps the advected velocity u* as a point function and makes two
fits (pressure against div u*, then one velocity fit to u* - grad p);
`merged2` adds the trapezoidal pressure predictor -grad q_old at the
departure point (see `_advect_target_fn`).

Each loss is split into a sampling step (`_*_points`, which draws from the
model's generator) and a pure function of (params, points, aux), so that the
tests can hand both packages the same points. Point functions and their
derivatives go through `ops/diff.py`'s `torch.func` transforms.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch
from torch.func import jacfwd, vmap

from ..ops.diff import divergence, gradient, jacobian, laplace
from ..ops.sampling import (sample_boundary2D_separate, sample_random,
                            sample_uniform)
from ..utils import viz
from ..utils.viz import (draw_curl, draw_magnitude, draw_scalar_field2D,
                         draw_vector_field2D, save_figure, save_numpy_img)
from .base import BaseModel
from .examples import get_examples


class Fluid2DModel(BaseModel):
    def __init__(self, cfg, group=None):
        super().__init__(cfg, group)
        self.vel_net = self._create_field("velocity", 2, 2)
        self._create_field("velocity_prev", 2, 2)
        self.p_net = self._create_field("pressure", 2, 1)
        if not self.p_net.second_order_ok:
            # lap p == 0 a.e. for piecewise-linear fields: the Poisson phase
            # would "converge" to garbage with no error signal
            raise ValueError(
                f"network '{cfg.network}' with nonlinearity "
                f"'{cfg.nonlinearity}' has zero second derivatives almost "
                "everywhere, so the pressure Poisson solve (div u = lap p) "
                "degenerates. Use --network siren with sine for fluid.")
        if not cfg.init_cond:
            raise ValueError("fluid requires --init_cond (e.g. taylorgreen)")
        self.init_cond_func = get_examples(cfg.init_cond)

        if cfg.fluid_step == "merged2":
            # the trapezoidal predictor's q_old must exist before a checkpoint
            # is loaded: load_pytree restores the structure of self.fields,
            # so a leaf absent here would be dropped and a resumed run would
            # bootstrap again instead of continuing the trapezoidal chain.
            # The pressure init is a placeholder until the first step's
            # bootstrap overwrites it (no random numbers drawn).
            self.fields["pressure_prev"] = self.fields["pressure"]

        # sr^2 collocation points per iteration, ~1% on each boundary pair,
        # divided over the ranks of a sharded run
        self.n_samples = max(1, self.sample_resolution ** 2 // self.n_ranks)
        self.n_boundary = max(
            (self.sample_resolution ** 2 // 100) // self.n_ranks, 2)

    # ---- sampling steps (model generator) ----
    def _interior_points(self):
        return {"x": sample_random(self.generator, self.n_samples,
                                   2).to(self.device)}

    def _points_with_bc(self):
        """Interior points plus the x = ±1 ('horizontal') and y = ±1
        ('vertical') boundary strips, drawn in the JAX order."""
        x = sample_random(self.generator, self.n_samples, 2)
        bx = sample_boundary2D_separate(self.generator, self.n_boundary,
                                        "horizontal")
        by = sample_boundary2D_separate(self.generator, self.n_boundary,
                                        "vertical")
        return {"x": x.to(self.device), "bx": bx.to(self.device),
                "by": by.to(self.device)}

    # ---- pure loss functions of (params, points, aux) ----
    def _velocity_bc(self, params, pts):
        """Zero normal velocity: x-component on the x=±1 strips,
        y-component on the y=±1 strips."""
        vx = self.vel_net.apply(params, pts["bx"])[..., 0]
        vy = self.vel_net.apply(params, pts["by"])[..., 1]
        return torch.mean(vx ** 2) + torch.mean(vy ** 2)

    def _init_loss(self, params, pts, aux):
        """MSE fit to the initial velocity."""
        x = pts["x"]
        ref = self.init_cond_func(x)
        out = self.vel_net.apply(params, x)
        return {"main": torch.mean((out - ref) ** 2)}

    def _advect_loss(self, params, pts, aux):
        """Semi-Lagrangian advection: u(x) ~ u_prev(clip(x - dt u_prev(x)))
        with the euler trace, optionally MacCormack-corrected (advect the
        target back and correct by half the round-trip defect, except where
        the forward trace leaves the domain). `--advect_trace rk2` takes the
        target from the midpoint-traced point function
        (`_advect_target_fn`). `--advect_sobolev w > 0` also fits the
        Jacobian to the target's: by the chain rule through the euler
        backtrace, or by jacfwd through the rk2 composition; with MacCormack
        the Jacobian target is the plain semi-Lagrangian one."""
        x = pts["x"]
        prev = aux["prev"]
        sob_w = self.cfg.advect_sobolev

        if self.cfg.advect_trace == "rk2":
            fn = self._advect_target_fn(prev)
            with torch.no_grad():
                advected = vmap(fn)(x)
                J_target = (jacobian(fn, x).transpose(1, 2) if sob_w > 0.0
                            else None)
        else:
            with torch.no_grad():
                if sob_w > 0.0:
                    # J conventions are (N, d, m): J[:, j, i] = d out_i / d x_j
                    u_prev, J_prev = self.vel_net.value_grad(prev, x)
                else:
                    u_prev = self.vel_net.apply(prev, x)
                raw_back = x - u_prev * self.dt
                backtracked = torch.clamp(raw_back, -1.0, 1.0)
                J_target = None
                if sob_w > 0.0:
                    advected, J_a = self.vel_net.value_grad(prev, backtracked)
                    inside = ((raw_back > -1.0) & (raw_back < 1.0)).to(x.dtype)
                    eye = torch.eye(2, dtype=x.dtype, device=x.device)
                    # db_k/dx_j = inside_k * (delta_jk - dt * d u_k/d x_j)
                    db = inside[:, None, :] * (eye[None] - self.dt * J_prev)
                    J_target = torch.einsum("njk,nki->nji", db, J_a)
                else:
                    advected = self.vel_net.apply(prev, backtracked)
                if self.cfg.advect_scheme == "maccormack":
                    # round trip: the advected field at the forward trace y
                    # of x returns u_prev(x) for the exact operator; the
                    # defect is twice the scheme's one-step error
                    y = x + u_prev * self.dt
                    in_dom = torch.all((y > -1.0) & (y < 1.0), dim=-1,
                                       keepdim=True)
                    y = torch.clamp(y, -1.0, 1.0)
                    u_y = self.vel_net.apply(prev, y)
                    z = torch.clamp(y - u_y * self.dt, -1.0, 1.0)
                    defect = u_prev - self.vel_net.apply(prev, z)
                    advected = advected + torch.where(in_dom, 0.5 * defect,
                                                      0.0)

        if J_target is not None:
            u, J_u = self.vel_net.value_grad(params, x)
            return {"main": torch.mean((u - advected) ** 2),
                    "sobolev": sob_w * torch.mean((J_u - J_target) ** 2),
                    "bc": self._velocity_bc(params, pts)}
        u = self.vel_net.apply(params, x)
        return {"main": torch.mean((u - advected) ** 2),
                "bc": self._velocity_bc(params, pts)}

    def _advect_target_fn(self, prev, p_old=None):
        """Point function x -> u*(x), the advected velocity of the frozen
        `prev` field: u_prev(clip(x - dt u_prev(x))) (midpoint trace with
        rk2), MacCormack-corrected as in `_advect_loss`. The merged
        timesteps keep u* as this function, so that jacfwd through it gives
        the Poisson target div(u*) exactly.

        With p_old (the previous step's pressure, `merged2`): the
        incremental trapezoidal predictor u*(x) = u_prev(b(x)) -
        grad q_old(b(x)), the departure-point half of the pressure impulse;
        the arrival half is the new solve's -grad q_new(x) in the combined
        fit."""
        vel = self.vel_net.point_fn(prev)
        p_old_pt = None if p_old is None else self.p_net.point_fn(p_old)
        dt = self.dt
        mc = self.cfg.advect_scheme == "maccormack"
        rk2 = self.cfg.advect_trace == "rk2"

        def trace(xi, sign):
            """One characteristic trace step: (raw, clipped)."""
            u0 = vel(xi)
            if rk2:
                mid = torch.clamp(xi + sign * 0.5 * dt * u0, -1.0, 1.0)
                u_t = vel(mid)
            else:
                u_t = u0
            raw = xi + sign * dt * u_t
            return raw, torch.clamp(raw, -1.0, 1.0)

        def fn(xi):
            _, b = trace(xi, -1.0)
            adv = vel(b)
            if mc:
                u_here = vel(xi)
                y_raw, y = trace(xi, +1.0)
                in_dom = torch.all((y_raw > -1.0) & (y_raw < 1.0))
                _, z = trace(y, -1.0)
                adv = adv + torch.where(in_dom, 0.5 * (u_here - vel(z)), 0.0)
            if p_old_pt is not None:
                adv = adv - jacfwd(p_old_pt)(b)[0]
            return adv

        return fn

    def _pressure_bc(self, params, pts):
        """Neumann BC grad(p).n = 0 on the boundary strips."""
        grad_px = self.p_net.value_grad(params, pts["bx"])[1][:, 0, 0]
        grad_py = self.p_net.value_grad(params, pts["by"])[1][:, 1, 0]
        return torch.mean(grad_px ** 2) + torch.mean(grad_py ** 2)

    def _pressure_loss(self, params, pts, aux):
        """Poisson residual div u = lap p (rho = 1) + Neumann BC, lap p
        through the fused value+gradient+Laplacian kernels."""
        x = pts["x"]
        with torch.no_grad():
            _, J_u = self.vel_net.value_grad(aux["vel"], x)
            div_u = J_u[:, 0, 0] + J_u[:, 1, 1]
        lap_p = self.p_net.value_grad_laplacian(params, x)[2][:, 0]
        return {"main": torch.mean((div_u - lap_p) ** 2),
                "bc": self._pressure_bc(params, pts)}

    def _merged_pressure_loss(self, params, pts, aux):
        """Poisson residual div(u*) = lap p, with u* the advected
        composition (no intermediate velocity fit); BCs as
        `_pressure_loss`."""
        x = pts["x"]
        fn = self._advect_target_fn(aux["prev"], aux.get("p_old"))
        with torch.no_grad():
            div_star = divergence(fn, x)[:, 0]
        lap_p = self.p_net.value_grad_laplacian(params, x)[2][:, 0]
        return {"main": torch.mean((div_star - lap_p) ** 2),
                "bc": self._pressure_bc(params, pts)}

    def _merged_projection_loss(self, params, pts, aux):
        """One combined advect+project fit: u <- u*(x) - grad p(x). With
        `--advect_sobolev w > 0` the fit's Jacobian is also held to the
        target's exact one (jacfwd through the composition and the pressure
        Hessian)."""
        x = pts["x"]
        sob_w = self.cfg.advect_sobolev
        adv_fn = self._advect_target_fn(aux["prev"], aux.get("p_old"))
        p_pt = self.p_net.point_fn(aux["pressure"])

        def target_pt(xi):
            return adv_fn(xi) - jacfwd(p_pt)(xi)[0]

        with torch.no_grad():
            target = vmap(target_pt)(x)
            J_t = (jacobian(target_pt, x).transpose(1, 2) if sob_w > 0.0
                   else None)
        if J_t is not None:
            u, J_u = self.vel_net.value_grad(params, x)
            return {"main": torch.mean((u - target) ** 2),
                    "sobolev": sob_w * torch.mean((J_u - J_t) ** 2),
                    "bc": self._velocity_bc(params, pts)}
        u = self.vel_net.apply(params, x)
        return {"main": torch.mean((u - target) ** 2),
                "bc": self._velocity_bc(params, pts)}

    def _projection_loss(self, params, pts, aux):
        """u <- u_prev - grad p."""
        x = pts["x"]
        with torch.no_grad():
            u_prev = self.vel_net.apply(aux["prev"], x)
            grad_p = self.p_net.value_grad(aux["pressure"], x)[1][:, :, 0]
            target = u_prev - grad_p
        u = self.vel_net.apply(params, x)
        main = torch.mean((u - target) ** 2)
        return {"main": main, "bc": self._velocity_bc(params, pts)}

    # ---- field sampling ----
    @torch.no_grad()
    def sample_field(self, resolution, return_samples=False):
        """Velocity on a (res, res) uniform grid."""
        grid = sample_uniform(resolution, 2, flatten=False, device=self.device)
        out = self.vel_net.apply(self.fields["velocity"], grid)
        if return_samples:
            return out, grid
        return out

    # ---- timestep protocol ----
    def initialize(self):
        self.begin_timestep()
        res = self._run_phase("initialize", self._init_loss,
                              self._interior_points,
                              self.fields["velocity"], aux=None,
                              vis_fn=self._vis_velocity)
        self.fields["velocity"] = res.params
        self.end_timestep()
        return res

    def step(self):
        """One timestep of `cfg.fluid_step`; each fit starts a fresh Adam +
        scheduler. split: advect, pressure, projection fits."""
        if self.cfg.fluid_step == "merged":
            return self._step_merged()
        if self.cfg.fluid_step == "merged2":
            return self._step_merged2()
        self.begin_timestep()

        self.fields["velocity_prev"] = self.fields["velocity"]
        res_a = self._run_phase("advect_velocity", self._advect_loss,
                                self._points_with_bc,
                                self.fields["velocity"],
                                aux={"prev": self.fields["velocity_prev"]},
                                vis_fn=self._vis_velocity)
        self.fields["velocity"] = res_a.params

        res_p = self._run_phase("solve_pressure", self._pressure_loss,
                                self._points_with_bc,
                                self.fields["pressure"],
                                aux={"vel": self.fields["velocity"]},
                                vis_fn=self._vis_pressure)
        self.fields["pressure"] = res_p.params

        self.fields["velocity_prev"] = self.fields["velocity"]
        res_j = self._run_phase("projection", self._projection_loss,
                                self._points_with_bc,
                                self.fields["velocity"],
                                aux={"prev": self.fields["velocity_prev"],
                                     "pressure": self.fields["pressure"]},
                                vis_fn=self._vis_velocity)
        self.fields["velocity"] = res_j.params

        self.end_timestep()
        return res_a, res_p, res_j

    def _step_merged(self):
        """merged: the pressure Poisson solve against the exact divergence
        of the semi-Lagrangian composition, then one velocity fit to
        u* - grad p (two fits per step instead of three)."""
        self.begin_timestep()

        self.fields["velocity_prev"] = self.fields["velocity"]
        res_p = self._run_phase("solve_pressure_merged",
                                self._merged_pressure_loss,
                                self._points_with_bc,
                                self.fields["pressure"],
                                aux={"prev": self.fields["velocity_prev"]},
                                vis_fn=self._vis_pressure)
        self.fields["pressure"] = res_p.params

        res_j = self._run_phase("project_advect",
                                self._merged_projection_loss,
                                self._points_with_bc,
                                self.fields["velocity"],
                                aux={"prev": self.fields["velocity_prev"],
                                     "pressure": self.fields["pressure"]},
                                vis_fn=self._vis_velocity)
        self.fields["velocity"] = res_j.params

        self.end_timestep()
        return res_p, res_j

    def _step_merged2(self):
        """merged2, the incremental-trapezoidal merged step: the predictor
        carries -grad q_old at the departure point, the combined fit applies
        -grad q_new at the arrival point (see `_advect_target_fn`). The first
        step has no q_old and bootstraps it with one extra plain-composition
        Poisson solve; a resumed run (timestep > 1) keeps the restored
        q_old."""
        self.begin_timestep()

        self.fields["velocity_prev"] = self.fields["velocity"]
        prev = self.fields["velocity_prev"]
        p_old = self.fields["pressure_prev"]
        if self.timestep <= 1:
            res_b = self._run_phase("solve_pressure_m2boot",
                                    self._merged_pressure_loss,
                                    self._points_with_bc,
                                    self.fields["pressure"],
                                    aux={"prev": prev, "p_old": None})
            p_old = res_b.params

        res_p = self._run_phase("solve_pressure_merged2",
                                self._merged_pressure_loss,
                                self._points_with_bc,
                                self.fields["pressure"],
                                aux={"prev": prev, "p_old": p_old},
                                vis_fn=self._vis_pressure)
        self.fields["pressure"] = res_p.params

        res_j = self._run_phase("project_advect2",
                                self._merged_projection_loss,
                                self._points_with_bc,
                                self.fields["velocity"],
                                aux={"prev": prev, "p_old": p_old,
                                     "pressure": res_p.params},
                                vis_fn=self._vis_velocity)
        self.fields["velocity"] = res_j.params
        self.fields["pressure_prev"] = res_p.params

        self.end_timestep()
        return res_p, res_j

    # ---- visualization / output ----
    @torch.no_grad()
    def _vis_velocity(self, params):
        grid = sample_uniform(min(self.vis_resolution, 64), 2, flatten=False,
                              device=self.device)
        out = self.vel_net.apply(params, grid)
        fig = draw_vector_field2D(out.cpu().numpy(), grid.cpu().numpy())
        self.tb.add_figure("velocity", fig, global_step=self.train_step)

    def _vis_pressure(self, params):
        """Pressure-phase diagnostics: div u, lap p, p, grad p components,
        pointwise residual."""
        res = min(self.vis_resolution, 48)
        grid = sample_uniform(res, 2, flatten=True, device=self.device)
        vel_fn = self.vel_net.point_fn(self.fields["velocity"])
        p_fn = self.p_net.point_fn(params)
        div_u = divergence(vel_fn, grid)[:, 0]
        lap_p = laplace(p_fn, grid)[:, 0]
        p = self.p_net.apply(params, grid)[:, 0]
        grad_p = gradient(p_fn, grid)
        mse = (div_u - lap_p) ** 2
        panels = {"pre_div": div_u, "pre_p_lap": lap_p, "pre_p": p,
                  "pre_p_gradx": grad_p[:, 0], "pre_p_grady": grad_p[:, 1],
                  "pre_mse": mse}
        for tag, arr in panels.items():
            fig = draw_scalar_field2D(
                arr.detach().cpu().numpy().reshape(res, res))
            self.tb.add_figure(tag, fig, global_step=self.train_step)

    @torch.no_grad()
    def output_fields(self):
        """(grid, u, |u|, curl u) on the (vr, vr) output grid. The velocity
        goes through the fused SIREN kernel (apply_fused); the Jacobian for
        the curl through the batched value_grad chain, which equals the JAX
        package's vmapped jacfwd."""
        vr = self.vis_resolution
        grid = sample_uniform(vr, 2, flatten=False, device=self.device)
        params = self.fields["velocity"]
        grid_u = self.vel_net.apply_fused(params, grid)
        _, J = self.vel_net.value_grad(params, grid.reshape(-1, 2))  # (N, d, m)
        jac = J.transpose(1, 2).reshape(vr, vr, 2, 2)               # [..., m, d]
        u_curl = jac[..., 1, 0] - jac[..., 0, 1]
        u_mag = torch.sqrt(torch.sum(grid_u ** 2, dim=-1))
        return grid, grid_u, u_mag, u_curl

    def write_output(self, output_folder):
        """Quiver PNG + magnitude/curl images + raw velocity grid .npy."""
        grid, grid_u, u_mag, u_curl = self.output_fields()
        grid_np = grid.cpu().numpy()
        u_np = grid_u.cpu().numpy()
        np.save(os.path.join(output_folder, f"t{self.timestep:03d}.npy"), u_np)
        if not viz.available():
            warnings.warn("matplotlib is not installed: write_output saves "
                          "tNNN.npy but not the _vel/_mag/_curl PNGs")
            return

        fig = draw_vector_field2D(u_np, grid_np)
        save_figure(fig, os.path.join(output_folder,
                                      f"t{self.timestep:03d}_vel.png"))
        save_numpy_img(draw_magnitude(u_mag.cpu().numpy()),
                       os.path.join(output_folder,
                                    f"t{self.timestep:03d}_mag.png"))
        save_numpy_img(draw_curl(u_curl.cpu().numpy()),
                       os.path.join(output_folder,
                                    f"t{self.timestep:03d}_curl.png"))
