"""Plain reference of `elasticity_lucy_3x128`: a hyperelastic solid dropped
onto a plane, as the 3D lucy scene of Chen et al., "Implicit Neural Spatial
Representations for Time-dependent PDEs" (ICML 2023, arXiv 2210.00124).

The field is the displacement d (3 -> 3), a SIREN of 3 hidden layers of
128; a material point x sits at q(x) = x + d(x) and F = dq/dx. The mesh is
read from the MEDIT file the benchmark wrote, its bounding box centred and
its farthest vertex scaled to radius 2. Every Adam iteration (lr 1e-4) of a
step draws n = sr^3 points in the mesh's volume, each in a tetrahedron
chosen with probability proportional to its volume, at barycentric weights
e_k / sum(e) with e_k = -log(1 - u_k) (a uniform point of the
tetrahedron), and adds every mesh vertex. With q0, q1 the fields of the
two previous steps and qdot = (q - q0) / dt, qdot0 = (q0 - q1) / dt, the
step minimises the incremental potential, summed over the points:

    1e3 sum_i (sigma_i(F) - 1)^2              (as-rigid-as-possible)
  + sum |qdot - qdot0|^2                      (kinematics)
  - dt qdot_z * 1e6 max(-2 - q_z, 0)          (penalty contact, plane z = -2)
  - dt qdot . (0, 0, -20)    while t <= 10    (external force)
  + 1e3 (|det F| - 1)^2                       (volume)

in that order; sigma_i are F's singular values (the gradient of the first
term is 2 (F - U V^T), from the SVD F = U S V^T). t = 0 fits d to zero at
sr^3 volume points plus the vertices.

Random numbers: one `torch.Generator` on the run's device seeded with the
run's seed draws, in this order, three networks' initial weights, then for
every iteration of every fit the tetrahedra's uniforms (n,) and the
barycentric uniforms (n, 4). The tetrahedron of a uniform u is the first
whose cumulative volume share, summed in float64, exceeds u times the
total.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .common import (Precision, fit, forward, init_siren, iterations_run,
                     rand, value_jac, widths)


def read_medit(path: str):
    """(vertices (V, 3) float64, tetrahedra (T, 4) int64, 0-based) of an
    ASCII MEDIT file."""
    with open(path) as f:
        tokens = f.read().split()
    i, verts, tets = 0, None, None
    while i < len(tokens):
        key = tokens[i]
        if key == "Vertices":
            n = int(tokens[i + 1])
            vals = np.asarray(tokens[i + 2: i + 2 + 4 * n], np.float64)
            verts = vals.reshape(n, 4)[:, :3]
            i += 2 + 4 * n
        elif key == "Tetrahedra":
            n = int(tokens[i + 1])
            vals = np.asarray(tokens[i + 2: i + 2 + 5 * n], np.int64)
            tets = vals.reshape(n, 5)[:, :4] - 1
            i += 2 + 5 * n
        else:
            i += 1
    return verts, tets


class _RigidEnergy(torch.autograd.Function):
    """sum over the batch of sum_i (sigma_i - 1)^2 of (N, 3, 3); gradient
    2 (F - U V^T)."""

    @staticmethod
    def forward(ctx, F):
        U, S, Vh = torch.linalg.svd(F)
        ctx.save_for_backward(F, U @ Vh)
        return torch.sum((S - 1.0) ** 2)

    @staticmethod
    def backward(ctx, g):
        F, R = ctx.saved_tensors
        return 2.0 * g * (F - R)


class Reference:
    """The configuration's fits, drawing from its own generator."""

    def __init__(self, config: dict, workload: dict, seed: int,
                 device: torch.device, inputs: dict):
        self.device = device
        self.hidden = config["hidden_features"]
        self.layers = config["num_hidden_layers"]
        self.dt = config["dt"]
        self.lr = config["lr"]
        self.ratio_arap = config["ratio_arap"]
        self.ratio_volume = config["ratio_volume"]
        self.ratio_kinematics = config["ratio_kinematics"]
        self.ratio_collide = config["ratio_collide"]
        self.plane = config["plane_height"]
        self.t_ext = config["external_force_timesteps"]
        self.force = torch.tensor(config["external_force"],
                                  dtype=torch.float32, device=device)
        sr = workload["sample_resolution"]
        self.n = sr ** 3
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed)

        verts, tets = read_medit(inputs["mesh_path"])
        V = torch.as_tensor(verts, dtype=torch.float32, device=device)
        centre = (torch.max(V, dim=0).values + torch.min(V, dim=0).values) / 2.0
        V = V - centre
        V = V / torch.sqrt(torch.max(torch.sum(V ** 2, dim=-1)))
        self.V = (V * 2.0).contiguous()
        self.T = torch.as_tensor(tets, dtype=torch.int64, device=device)
        t = self.V[self.T]
        a, b, c = t[:, 1] - t[:, 0], t[:, 2] - t[:, 0], t[:, 3] - t[:, 0]
        vol = torch.abs(torch.sum(torch.linalg.cross(a, b) * c, dim=-1)) / 6.0
        share = vol / torch.sum(vol)
        self.cdf = torch.cumsum(share.double(), dim=0)
        self.eval_points = self.V

    # ---- the random stream ----
    def initial_weights(self) -> Dict[str, list]:
        """The initial weights of the displacement, drawn first, then the
        two history networks' (which the run replaces by copies of the
        first, so they are drawn and dropped)."""
        w = widths(3, self.hidden, self.layers, 3)
        first = init_siren(self.gen, w)
        init_siren(self.gen, w)
        init_siren(self.gen, w)
        return {"deformation": first}

    def _draw(self):
        u = rand(self.gen, (self.n,)).double() * self.cdf[-1]
        idx = torch.clamp(torch.searchsorted(self.cdf, u, right=True),
                          max=self.T.shape[0] - 1)
        corners = self.V[self.T[idx]]                      # (n, 4, 3)
        e = -torch.log1p(-rand(self.gen, (self.n, 4)))
        bary = e / torch.sum(e, dim=1, keepdim=True)
        inside = torch.sum(bary[:, :, None] * corners, dim=1)
        return {"x": torch.cat([inside, self.V], dim=0)}

    def skip(self, tag: str, iters: int) -> None:
        """Draw and drop the points of a fit that is not compared."""
        for _ in range(iters):
            self._draw()

    # ---- the fits ----
    def fit(self, tag: str, start, aux: dict, iters: int, prec: Precision,
            half_batch: bool = False, run=None, contact_iters=None,
            reverse: bool = False):
        """One fit of phase `tag` from `start`; `aux` holds the two previous
        fields (`prev`, `prev_prev`) and the timestep `t`. Returns (params,
        {term: per-iteration values}, whether no point touched the plane in
        any iteration run). In contact a fit turns chaotic: points that
        cross the plane switch a 1e6 penalty on and off, and a start one
        float32 ulp away can move the loss by 1e-2 of the fit's range. So
        with `contact_iters` the fit ends `contact_iters` iterations after
        the first in which a point touched the plane; `run`, where given,
        ends it after exactly that many. The points of the iterations not
        run are drawn and dropped. With `half_batch` the sums
        run over the first half of the points only (a planted fault); with
        `reverse` the points of each draw are taken in reverse order (a
        witness of rounding)."""
        touched = torch.zeros((), dtype=torch.bool, device=self.device)
        def cut(x):
            return x[: x.shape[0] // 2] if half_batch else x

        if tag == "initialize":
            def loss(p, pts):
                return {"main": torch.mean(forward(p, cut(pts["x"]), prec) ** 2)}
        elif tag == "solve_deformation":
            prev, prev_prev = aux["prev"], aux["prev_prev"]
            external = aux["t"] <= self.t_ext
            eye = torch.eye(3, dtype=torch.float32, device=self.device)

            def loss(p, pts):
                nonlocal touched
                x = cut(pts["x"])
                d, j = value_jac(p, x, prec)
                q = x + d
                F = eye + j.transpose(1, 2)
                with torch.no_grad():
                    q0 = x + forward(prev, x, prec)
                    q1 = x + forward(prev_prev, x, prec)
                qdot = (q - q0) / self.dt
                qdot0 = (q0 - q1) / self.dt
                depth = self.plane - q[:, 2]
                touched = touched | (depth > 0.0).any()
                push = torch.where(depth > 0.0, self.ratio_collide * depth,
                                   torch.zeros_like(depth))
                terms = [self.ratio_arap * _RigidEnergy.apply(F),
                         self.ratio_kinematics * torch.sum((qdot - qdot0) ** 2),
                         -self.dt * torch.sum(qdot[:, 2] * push)]
                if external:
                    terms.append(-self.dt * torch.sum(qdot * self.force))
                terms.append(self.ratio_volume * torch.sum(
                    (torch.abs(torch.linalg.det(F)) - 1.0) ** 2))
                return {"main": torch.stack(terms).sum()}
        else:
            raise ValueError(f"elasticity_lucy_3x128: no phase {tag!r}")
        onset = None

        def stop(done):
            nonlocal onset
            if run is not None:
                return done >= run
            if contact_iters is None:
                return False
            if onset is None and bool(touched):
                onset = done
            return onset is not None and done >= onset + contact_iters
        with prec.active():
            params, hist = fit(start, loss, self._draw, iters, self.lr,
                               stop=stop, reverse=reverse)
        self.skip(tag, iters - iterations_run(hist))
        return params, hist, not bool(touched)

    def field(self, params, prec: Precision) -> torch.Tensor:
        """The displacement of `params` at the mesh's vertices."""
        with torch.no_grad(), prec.active():
            return forward(params, self.eval_points, prec)
