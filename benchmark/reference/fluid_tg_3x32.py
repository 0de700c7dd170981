"""Plain reference of `fluid_tg_3x32`: the split timestep of 2D inviscid
flow of Chen et al., "Implicit Neural Spatial Representations for
Time-dependent PDEs" (ICML 2023, arXiv 2210.00124), on [-1, 1]^2 from the
Taylor-Green vortex.

Fields: velocity u (2 -> 2) and pressure p (2 -> 1), each a SIREN of 3
hidden layers of 32. A timestep is three Adam fits, each `iters`
iterations at lr 1e-4, each iteration on fresh points: n = sr^2 uniform
interior points, and nb // 2 points on each of the two strips |x| = 1 and
the two strips |y| = 1 (nb = sr^2 // 100, strips 1e-4 thick):

1. advect: u(x) -> u0(clip(x - dt u0(x), -1, 1)) with u0 the velocity at
   the step's start; boundary term mean(u_x^2) on |x| = 1 plus mean(u_y^2)
   on |y| = 1;
2. pressure: lap p(x) -> div u1(x) with u1 the advected velocity; boundary
   term mean((dp/dx)^2) on |x| = 1 plus mean((dp/dy)^2) on |y| = 1;
3. projection: u(x) -> u1(x) - grad p(x), from u1, with the velocity's
   boundary term.

t = 0 fits u to the rescaled Taylor-Green velocity (sin(pi(x+1)) cos(pi(y+1)),
-cos(pi(x+1)) sin(pi(y+1))) / pi. Each term is a mean over its points; a
fit minimises the sum of its terms.

Random numbers: one `torch.Generator` on the run's device seeded with the
run's seed draws, in this order, the three networks' initial weights
(velocity, a second velocity, pressure), then for every iteration of every
fit the interior points (n, 2) and, in the steps' fits, the |x| = 1 strips
(2, nb // 2, 2) and the |y| = 1 strips (2, nb // 2, 2).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from .common import (Precision, cell_centres, fit, forward, init_siren,
                     iterations_run, rand, uniform_box, value_jac,
                     value_jac_lap, widths)

STRIP = 1e-4


def _strips(gen: torch.Generator, nb: int, axis: int) -> torch.Tensor:
    """nb // 2 points in each of the strips |x_axis| = 1 +- 1e-4, the other
    coordinate uniform in [-1, 1]; the strip at -1 first."""
    m = nb // 2
    lo, hi = [[-1.0, -1.0], [-1.0, -1.0]], [[1.0, 1.0], [1.0, 1.0]]
    for k, c in enumerate((-1.0, 1.0)):
        lo[k][axis], hi[k][axis] = c - STRIP, c + STRIP
    lo_t = torch.tensor(lo, dtype=torch.float32, device=gen.device)
    hi_t = torch.tensor(hi, dtype=torch.float32, device=gen.device)
    u = rand(gen, (2, m, 2))
    return (lo_t[:, None, :] + u * (hi_t - lo_t)[:, None, :]).reshape(2 * m, 2)


def taylor_green(x: torch.Tensor) -> torch.Tensor:
    a = (x[:, 0] + 1.0) * math.pi
    b = (x[:, 1] + 1.0) * math.pi
    return torch.stack([torch.sin(a) * torch.cos(b) / math.pi,
                        -torch.cos(a) * torch.sin(b) / math.pi], dim=-1)


class Reference:
    """The configuration's fits, drawing from its own generator."""

    def __init__(self, config: dict, workload: dict, seed: int,
                 device: torch.device, inputs: dict):
        self.device = device
        self.hidden = config["hidden_features"]
        self.layers = config["num_hidden_layers"]
        self.dt = config["dt"]
        self.lr = config["lr"]
        sr = workload["sample_resolution"]
        self.n = sr * sr
        self.nb = max(self.n // 100, 2)
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed)
        self.eval_points = cell_centres(workload["check"]["eval_resolution"],
                                        2, device)

    # ---- the random stream ----
    def initial_weights(self) -> Dict[str, list]:
        """The three networks' initial weights, drawn first; the velocity,
        which the t = 0 fit trains, comes first."""
        out = {}
        for name, d_out in (("velocity", 2), ("velocity_prev", 2),
                            ("pressure", 1)):
            out[name] = init_siren(self.gen,
                                   widths(2, self.hidden, self.layers, d_out))
        return out

    def _draw_init(self):
        return {"x": uniform_box(self.gen, self.n, 2)}

    def _draw_step(self):
        return {"x": uniform_box(self.gen, self.n, 2),
                "bx": _strips(self.gen, self.nb, 0),
                "by": _strips(self.gen, self.nb, 1)}

    def skip(self, tag: str, iters: int) -> None:
        """Draw and drop the points of a fit that is not compared."""
        draw = self._draw_init if tag == "initialize" else self._draw_step
        for _ in range(iters):
            draw()

    # ---- the fits ----
    def fit(self, tag: str, start, aux: dict, iters: int, prec: Precision,
            half_batch: bool = False, run=None, contact_iters=None,
            reverse: bool = False):
        """One fit of phase `tag` from `start`, `aux` holding the frozen
        fields; returns (params, {term: per-iteration values}, True: no fit
        of this configuration has contact, and each can be followed to its
        end). `run`, where given, ends the fit after that many iterations;
        the points of the rest are drawn and dropped. `contact_iters` is
        for configurations with contact. With `half_batch` the interior
        terms average the first half of the interior points only (a planted
        fault); with `reverse` the points of each draw are taken in reverse
        order (a witness of rounding)."""
        def cut(x):
            return x[: x.shape[0] // 2] if half_batch else x

        def vel_bc(p, pts):
            return (torch.mean(forward(p, pts["bx"], prec)[:, 0] ** 2)
                    + torch.mean(forward(p, pts["by"], prec)[:, 1] ** 2))

        if tag == "initialize":
            def loss(p, pts):
                x = cut(pts["x"])
                return {"main": torch.mean((forward(p, x, prec)
                                            - taylor_green(x)) ** 2)}
            draw = self._draw_init
        elif tag == "advect_velocity":
            prev = aux["prev"]

            def loss(p, pts):
                x = cut(pts["x"])
                with torch.no_grad():
                    u0 = forward(prev, x, prec)
                    back = torch.clamp(x - u0 * self.dt, -1.0, 1.0)
                    target = forward(prev, back, prec)
                return {"main": torch.mean((forward(p, x, prec) - target) ** 2),
                        "bc": vel_bc(p, pts)}
            draw = self._draw_step
        elif tag == "solve_pressure":
            vel = aux["vel"]

            def loss(p, pts):
                x = cut(pts["x"])
                with torch.no_grad():
                    _, j = value_jac(vel, x, prec)
                    div = j[:, 0, 0] + j[:, 1, 1]
                lap = value_jac_lap(p, x, prec)[2][:, 0]
                gx = value_jac(p, pts["bx"], prec)[1][:, 0, 0]
                gy = value_jac(p, pts["by"], prec)[1][:, 1, 0]
                return {"main": torch.mean((div - lap) ** 2),
                        "bc": torch.mean(gx ** 2) + torch.mean(gy ** 2)}
            draw = self._draw_step
        elif tag == "projection":
            prev, pressure = aux["prev"], aux["pressure"]

            def loss(p, pts):
                x = cut(pts["x"])
                with torch.no_grad():
                    target = (forward(prev, x, prec)
                              - value_jac(pressure, x, prec)[1][:, :, 0])
                return {"main": torch.mean((forward(p, x, prec) - target) ** 2),
                        "bc": vel_bc(p, pts)}
            draw = self._draw_step
        else:
            raise ValueError(f"fluid_tg_3x32: no phase {tag!r}")
        stop = None if run is None else (lambda done: done >= run)
        with prec.active():
            params, hist = fit(start, loss, draw, iters, self.lr, stop=stop,
                               reverse=reverse)
        self.skip(tag, iters - iterations_run(hist))
        return params, hist, True

    def field(self, params, prec: Precision) -> torch.Tensor:
        """The field of `params` at the check's evaluation points."""
        with torch.no_grad(), prec.active():
            return forward(params, self.eval_points, prec)
