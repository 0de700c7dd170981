"""2D advection as one space-time random-basis least-squares solve
(counterpart of `insr_pde_tpu/models/rbf_advection.py`).

The transport equation is linear, so the whole space-time field solves in
one CGLS pass, with no timestepping and no Picard loop. Residual blocks:

  1. transport    du/dt + v . grad u = 0     (interior, random t in (0, T])
  2. initial      u(x, 0) = u0(x)            (t = 0 slice)
  3. inflow       u = u0(x - v t) on the upwind boundary (random t)

The rows are a `PaddedSparse` operator (the block-ELL operator at J = 1),
solved by damped CGLS without column scaling (`ops/linalg.cgls_sparse`):
on the card each CGLS iteration launches `csrc/block_ell.cu`'s mv and rmv
kernels once each.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..ops.linalg import PaddedSparse, cgls_sparse
from ..ops.precision import resolve_device
from .rbf import (RBFConfig, RBFParams, basis_dt, basis_dx, basis_val,
                  column_ids, field_value, gather_basis, init_rbf, point_basis,
                  structured_spacetime_idx)


@dataclass
class RBFAdvectionConfig:
    """The JAX package's `RBFAdvectionConfig`: the same fields and
    defaults."""
    velocity: tuple = (0.5, 0.0)
    time_num: int = 8
    time_length: float = 1.0
    collocation_pts_num: int = 800
    boundary_num: int = 200
    n_spatial_basis: int = 400
    n_feat: int = 8
    neighbor_k: int = 6
    band_width: float = 10.0
    seed: int = 7
    time_window: int = 2       # slices coupled per point
    cgls_maxiter: int = 1500
    cgls_tol: float = 1e-10
    cgls_damp: float = 1e-2    # Tikhonov damping, no column scaling


class AdvectionPoints(NamedTuple):
    """Interior, inflow and t = 0 points, in that order, and their index
    sets."""
    x: torch.Tensor       # (Q, 2)
    t: torch.Tensor       # (Q,)
    inner: np.ndarray
    inflow: np.ndarray
    init: np.ndarray


def build_points(cfg: RBFAdvectionConfig, generator: torch.Generator,
                 device=None) -> AdvectionPoints:
    """Space-time Monte Carlo: interior and inflow points at random times in
    (0, T] (the residual must hold between the slices too), plus a t = 0
    slice for the initial condition; drawn from `generator` in the JAX
    package's order (interior x, t; inflow u, t; initial x)."""
    eps = 1e-4
    gdev = generator.device

    def uniform(*shape, lo=0.0, hi=1.0):
        u = torch.rand(shape, generator=generator, device=gdev)
        return lo + (hi - lo) * u

    n_in = cfg.collocation_pts_num * cfg.time_num
    x_in = uniform(n_in, 2, lo=-1.0)
    t_in = uniform(n_in, hi=cfg.time_length)
    # upwind (inflow) boundary: the face where v points inward
    vx, vy = cfg.velocity
    m = cfg.boundary_num * cfg.time_num
    u = uniform(m, 2)
    if abs(vx) >= abs(vy):
        lead = -1.0 if vx >= 0 else 1.0
        x_bc = torch.stack([lead + u[:, 0] * eps, u[:, 1] * 2.0 - 1.0], 1)
    else:
        lead = -1.0 if vy >= 0 else 1.0
        x_bc = torch.stack([u[:, 1] * 2.0 - 1.0, lead + u[:, 0] * eps], 1)
    t_bc = uniform(m, hi=cfg.time_length)
    n0 = cfg.collocation_pts_num
    x_0 = uniform(n0, 2, lo=-1.0)
    t_0 = torch.zeros(n0, device=gdev)
    return AdvectionPoints(
        x=torch.cat([x_in, x_bc, x_0]).to(device),
        t=torch.cat([t_in, t_bc, t_0]).to(device),
        inner=np.arange(n_in), inflow=np.arange(n_in, n_in + m),
        init=np.arange(n_in + m, n_in + m + n0))


class RBFAdvectionModel:
    """u(x, t), a scalar field on [-1,1]^2 x [0, T], constant velocity.

    `init_cond` maps points (n, 2) to u0 (n,), a torch callable. `params`
    and `points` may be given (e.g. converted from the JAX model); otherwise
    they are drawn from a CPU `torch.Generator` seeded with cfg.seed. The
    model runs on `device` ("cuda" by default; raises without a card)."""

    def __init__(self, cfg: RBFAdvectionConfig,
                 init_cond: Callable[[torch.Tensor], torch.Tensor],
                 device=None, params: Optional[RBFParams] = None,
                 points: Optional[AdvectionPoints] = None):
        self.cfg = cfg
        self.init_cond = init_cond
        self.device = (device if isinstance(device, torch.device)
                       else resolve_device(device or "cuda"))
        rbf_tmp = RBFConfig(dim=2, n_spatial_basis=cfg.n_spatial_basis)
        self.rbf_cfg = RBFConfig(
            dim=2, n_vars=1, n_feat=cfg.n_feat,
            n_spatial_basis=cfg.n_spatial_basis, time_num=cfg.time_num,
            time_length=cfg.time_length, band_width=cfg.band_width,
            neighbor_k=cfg.neighbor_k, seed=cfg.seed,
            # bilinear spatial PoU over the site-grid cell corners
            pou_width=rbf_tmp.spatial_spacing)
        gen = torch.Generator().manual_seed(cfg.seed)
        if params is None:
            params = init_rbf(self.rbf_cfg, gen)
        if points is None:
            points = build_points(cfg, gen)
        dev = self.device
        self.params = RBFParams(*(t.to(dev) for t in params))
        self.pts = points._replace(x=points.x.to(dev), t=points.t.to(dev))
        self.pb = self._point_basis(self.params, self.pts.x, self.pts.t)
        self.info: dict = {}

    def _point_basis(self, params, x, t):
        idx = structured_spacetime_idx(self.rbf_cfg, params, x, t,
                                       self.cfg.time_window)
        # hat PoUs in both axes: continuous across slice windows and
        # K-neighbor switches
        return point_basis(self.rbf_cfg, params, x, t, idx=idx,
                           time_pou="hat", space_pou="hat")

    def assemble(self, pb=None):
        """(PaddedSparse A, rhs b): the transport, initial and inflow rows,
        each block max-|val| normalized."""
        cfg, pts, rcfg = self.cfg, self.pts, self.rbf_cfg
        pb = self.pb if pb is None else pb
        KJ = cfg.neighbor_k * cfg.time_window * cfg.n_feat
        vel = torch.tensor(cfg.velocity, dtype=torch.float32,
                           device=self.device)
        vals_l, cols_l, rhs_l = [], [], []

        def add_block(vals, cols, rhs):
            scale = torch.clamp(torch.max(torch.abs(vals)), min=1e-30)
            vals_l.append(vals / scale)
            cols_l.append(cols)
            rhs_l.append(rhs / scale)

        def gather(ids):
            ix = torch.as_tensor(ids, dtype=torch.int64, device=self.device)
            return gather_basis(pb, ix), ix

        # transport rows: d/dt + v . d/dx (the basis operators carry the
        # time PoU's product rule)
        pbi, _ = gather(pts.inner)
        conv = torch.einsum("qkjd,d->qkj", basis_dx(pbi)[:, :, 0], vel)
        vals = (basis_dt(pbi)[:, :, 0] + conv).reshape(-1, KJ)
        add_block(vals, column_ids(rcfg, pbi.idx, 0),
                  vals.new_zeros(vals.shape[0]))
        # initial rows: u(x, 0) = u0(x)
        pb0, i0 = gather(pts.init)
        add_block(basis_val(pb0)[:, :, 0].reshape(-1, KJ),
                  column_ids(rcfg, pb0.idx, 0), self.init_cond(pts.x[i0]))
        # inflow rows: u = u0(x - v t), the exact characteristic value
        pbf, i_f = gather(pts.inflow)
        upwind = pts.x[i_f] - vel * pts.t[i_f][:, None]
        add_block(basis_val(pbf)[:, :, 0].reshape(-1, KJ),
                  column_ids(rcfg, pbf.idx, 0), self.init_cond(upwind))
        A = PaddedSparse(torch.cat(vals_l).contiguous(),
                         torch.cat(cols_l).to(torch.int32).contiguous(),
                         rcfg.n_coeffs)
        return A, torch.cat(rhs_l)

    def solve(self) -> float:
        """One CGLS pass over the whole space-time system from zero; returns
        |A x - b|. `info` holds the iteration count."""
        A, b = self.assemble()
        # no Jacobi column scaling: with damping it re-amplifies weak
        # (rarely gathered) columns where the field is least constrained
        x, info = cgls_sparse(A, b, b.new_zeros(A.n_cols),
                              maxiter=self.cfg.cgls_maxiter,
                              tol=self.cfg.cgls_tol, precondition=False,
                              damp=self.cfg.cgls_damp)
        self.info = {"niter": int(info["niter"])}
        self.params = self.params._replace(u=x.reshape(self.params.u.shape))
        return float(torch.linalg.norm(A.mv(x) - b))

    def evaluate(self, x: torch.Tensor, t: float) -> torch.Tensor:
        """u at points x (n, 2) and time t, (n,)."""
        pb = self._point_basis(self.params, x,
                               torch.full((x.shape[0],), float(t),
                                          device=x.device))
        return field_value(pb, self.params.u)[:, 0]
