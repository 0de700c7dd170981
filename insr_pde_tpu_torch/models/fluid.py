"""2D inviscid fluid, operator splitting on [-1,1]^2 (counterpart of
`insr_pde_tpu/models/fluid.py`, the split timestep).

Velocity (2->2) and pressure (2->1) SIRENs; each timestep = three fits:
  1. semi-Lagrangian velocity advection (euler backtrace against the frozen
     previous velocity) with zero normal-velocity BCs,
  2. pressure Poisson solve (div u = lap p) with Neumann BCs, through the
     batched forward-Laplacian chain,
  3. velocity projection u <- u_prev - grad p.

Each loss is split into a sampling step (`_*_points`, which draws from the
model's generator) and a pure function of (params, points, aux), so that the
tests can hand both packages the same points.

Ported in this slice: `--fluid_step split` with `--advect_scheme semilag`,
`--advect_trace euler` and `--advect_sobolev 0`. The other timestep options
raise NotImplementedError (ROADMAP.md Queue 1).
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch

from ..ops.diff import divergence, gradient, laplace
from ..ops.sampling import (sample_boundary2D_separate, sample_random,
                            sample_uniform)
from ..utils import viz
from ..utils.viz import (draw_curl, draw_magnitude, draw_scalar_field2D,
                         draw_vector_field2D, save_figure, save_numpy_img)
from .base import BaseModel
from .examples import get_examples

_QUEUE = "ROADMAP.md Queue 1, 'models/fluid.py: the remaining timestep options'"


def check_supported(cfg) -> None:
    """Raise NotImplementedError for the fluid options this slice does not
    port."""
    for flag, ported in (("fluid_step", "split"),
                         ("advect_scheme", "semilag"),
                         ("advect_trace", "euler")):
        value = getattr(cfg, flag)
        if value != ported:
            raise NotImplementedError(
                f"--{flag} {value} is not ported yet ({_QUEUE}); only "
                f"--{flag} {ported} is")
    if cfg.advect_sobolev > 0.0:
        raise NotImplementedError(
            f"--advect_sobolev > 0 is not ported yet ({_QUEUE})")


class Fluid2DModel(BaseModel):
    def __init__(self, cfg):
        check_supported(cfg)
        super().__init__(cfg)
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

        # sr^2 collocation points per iteration, ~1% on each boundary pair
        self.n_samples = max(1, self.sample_resolution ** 2)
        self.n_boundary = max(self.sample_resolution ** 2 // 100, 2)

    # ---- sampling steps (model generator) ----
    def _interior_points(self):
        return {"x": sample_random(self.generator, self.n_samples, 2)}

    def _points_with_bc(self):
        """Interior points plus the x = ±1 ('horizontal') and y = ±1
        ('vertical') boundary strips, drawn in the JAX order."""
        x = sample_random(self.generator, self.n_samples, 2)
        bx = sample_boundary2D_separate(self.generator, self.n_boundary,
                                        "horizontal")
        by = sample_boundary2D_separate(self.generator, self.n_boundary,
                                        "vertical")
        return {"x": x, "bx": bx, "by": by}

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
        """Semi-Lagrangian advection, euler backtrace:
        u(x) ~ u_prev(clip(x - dt u_prev(x)))."""
        x = pts["x"]
        prev = aux["prev"]
        with torch.no_grad():
            u_prev = self.vel_net.apply(prev, x)
            backtracked = torch.clamp(x - u_prev * self.dt, -1.0, 1.0)
            advected = self.vel_net.apply(prev, backtracked)
        u = self.vel_net.apply(params, x)
        main = torch.mean((u - advected) ** 2)
        return {"main": main, "bc": self._velocity_bc(params, pts)}

    def _pressure_loss(self, params, pts, aux):
        """Poisson residual div u = lap p (rho = 1) + Neumann BC
        grad(p).n = 0, through the networks' value_grad* chains."""
        x = pts["x"]
        with torch.no_grad():
            _, J_u = self.vel_net.value_grad(aux["vel"], x)
            div_u = J_u[:, 0, 0] + J_u[:, 1, 1]
        lap_p = self.p_net.value_grad_laplacian(params, x)[2][:, 0]
        main = torch.mean((div_u - lap_p) ** 2)

        grad_px = self.p_net.value_grad(params, pts["bx"])[1][:, 0, 0]
        grad_py = self.p_net.value_grad(params, pts["by"])[1][:, 1, 0]
        bc = torch.mean(grad_px ** 2) + torch.mean(grad_py ** 2)
        return {"main": main, "bc": bc}

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
        """Operator splitting: three fits per timestep, each with a fresh
        Adam + scheduler."""
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
