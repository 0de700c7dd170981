"""Space-time random-basis incompressible-flow solver, the "vortex" model
(counterpart of `insr_pde_tpu/models/vortex.py`, its single-device paths).

A channel flow on [-1,1]^2 x [0, T_len] is solved as ONE global least-squares
problem over random-basis coefficients (`models/rbf.py`). Residual blocks:
momentum rho (u.grad)u + rho du/dt + grad p = rho g (interior, t>0),
continuity div u = 0, free-slip u.n = 0 on the walls, outlet p = 0, inlet
u = (internal_v, 0), initial u = 0, p = 0. `matrix_solver` is the Picard
loop: freeze the advecting velocity, assemble the rows as a block-ELL
operator (`ops/linalg.BlockSparse`), solve by CGLS, repeat. On the card each
CGLS iteration runs the hand-written block-ELL kernels of
`ops/block_ell.py` for A x and A^T r.

`matrix_solver(solver="cg")` runs batched CG (`ops/linalg.cg_batch`) on
the explicit normal equations A^T A x = A^T b instead, two `mv` and two
`rmv` launches per iteration. `packed_vals` and `rmv_gather` name the JAX
package's other operator layouts, which are this one here
(`ops/linalg.py`), so they change nothing. `train` is the other path: Adam
on the coefficients against the scale-normalized nonlinear residual MSE
(`residual_loss`).

`StreamVortexModel` represents the velocity as the curl of a stream
function, so continuity holds identically.

Sharded (`group`, `parallel/mesh.py`): `assemble(..., group=)` builds each
rank's rows of every residual block (each block padded to a multiple of the
world size with masked zero rows, rank r taking the r-th contiguous slice,
the per-block scale a `pmax`), and `matrix_solver` solves the row-sharded
system by `ops/linalg.cgls_sparse_chunked(..., group=)`. Unlike the JAX
package, whose unchunked sharded loop drops the block whitener, every
preconditioner runs sharded, chunked or not. The
points and the basis come from the CPU generator on every rank, so the
geometry and the coefficients are replicated. `host_sync` takes the
assembled system through host memory once before the solve, as in the JAX
package (`picard_timings` records `host_shipped`).
"""

from __future__ import annotations

import dataclasses
import os
import time
import warnings
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..ops.linalg import BlockSparse, cg_batch, cgls_sparse_chunked
from ..ops.precision import resolve_device
from ..parallel.mesh import Group, pmax, psum
from ..ops.sampling import sample_uniform
from ..utils import tracing, viz
from ..utils.ckpt import load_pytree, save_pytree
from ..utils.logging import MetricsWriter
from .rbf import (RBFConfig, RBFParams, basis_dt, basis_dx, basis_dxdt,
                  basis_hess, basis_val, block_ids, field_dt, field_dxdt,
                  field_grad, field_hess, field_value, gather_basis, init_rbf,
                  point_basis, slice_times, structured_spacetime_idx)
from .solver import adam_init, adam_update


@dataclass
class VortexConfig:
    """The vortex configuration; the fields, their meaning and their
    defaults are the JAX package's `VortexConfig` (starterL.py's reference
    hyperparameters), so checkpoints carry the same metadata."""
    rho: float = 1000.0
    internal_v: float = 8.0
    n_velocity: int = 2           # variable_list[0]
    n_variables: int = 3          # variable_list[1] (velocities + pressure)
    time_num: int = 10
    collocation_pts_num: int = 1000
    boundary_num: int = 400
    gravity: float = 0.0
    n_feat: int = 16              # num_per_point_feature
    time_length: float = 1.0
    n_spatial_basis: int = 400
    dim: int = 2
    band_width: float = 10.0
    neighbor_k: int = 6
    vis_resolution: int = 100
    seed: int = 213421
    log_dir: str = "./log/vortex"
    cgls_maxiter: int = 2000
    cgls_tol: float = 1e-10
    cgls_damp: float = 0.0
    # "auto" = Jacobi scaling iff undamped; "on" = Jacobi with damping;
    # "off"; "block" = the per-site-block eigen-whitener
    cgls_precondition: str = "auto"
    # >0: CGLS in chunks of this many iterations, the host reading the
    # state between chunks
    cgls_chunk: int = 0
    # with cgls_chunk > 0: re-enter each chunk from the best iterate with an
    # exactly recomputed residual
    cgls_restart: bool = False
    # the JAX package's packed (R, S*J) operator layout; nothing to select
    # here (ops/linalg.py), warns with rmv_gather as in the JAX package
    packed_vals: bool = False
    picard_iters: int = 3
    train_lr: float = 0.1
    # 'simple' = indicator PoU + scaled space-time KNN (reference parity);
    # 'hat'/'smooth'/'smooth2' = continuous PoUs + structured slice windows
    pou: str = "simple"
    time_window: int = 2
    # 1.0 = warm-start each Picard solve from the current coefficients
    warm_start: float = 0.0
    # stream formulation wall/inlet rows: "value" (psi Dirichlet data),
    # "derivative" (u = curl psi rows), "both"
    stream_bc: str = "value"
    w_momentum: float = 1.0
    w_continuity: float = 1.0
    w_bc: float = 1.0          # free-slip / outlet / inlet rows
    w_init: float = 1.0
    pou_time: str = ""         # time-axis PoU override ("" = same as pou)
    pou_normalize: bool = False
    # stream form only: fully-developed-outflow rows u_y = -psi_x = 0
    outlet_v: bool = False
    poly: int = 0              # per-site polynomial feature tail degree
    # the JAX package's pull-layout A^T r; the rmv kernel always pulls, so
    # nothing to select here (ops/linalg.py)
    rmv_gather: bool = False
    # cache the block whitener across Picard iterations, from the first
    # system assembled around a post-solve field
    reuse_whitener: bool = False
    # one round trip of the assembled system through host memory between
    # assembly and solve
    host_sync: bool = False


class SpaceTimePoints(NamedTuple):
    """Collocation + boundary points replicated over the time slices, and
    the index sets of each residual block."""
    x: torch.Tensor       # (Q, 2)
    t: torch.Tensor       # (Q,)
    norm: torch.Tensor    # (Q_neu, 2) wall normals for the free-slip rows
    inner: np.ndarray     # interior points, slices t>0
    neu: np.ndarray       # top/bottom wall points, t>0
    dirp: np.ndarray      # right wall (outlet) points, t>0
    left: np.ndarray      # left wall (inlet) points, all t
    init: np.ndarray      # slice-0 points (all but inlet)


def build_points(cfg: VortexConfig, generator: torch.Generator,
                 device=None) -> SpaceTimePoints:
    """Point layout per slice: [collocation Nc | bottom B/4 | top B/4 |
    right B/4 | left B/4], replicated over `time_num` slices; drawn from
    `generator`, then moved to `device`."""
    eps = 1e-4
    nc, nb = cfg.collocation_pts_num, cfg.boundary_num
    m = nb // 4
    gdev = generator.device
    colloc = -1.0 + 2.0 * torch.rand((nc, 2), generator=generator,
                                     device=gdev)
    u = torch.rand((4, m, 2), generator=generator, device=gdev)
    lo = torch.tensor([[-1.0, -1.0 - eps], [-1.0, 1.0 - eps],
                       [1.0 - eps, -1.0], [-1.0 - eps, -1.0]], device=gdev)
    hi = torch.tensor([[1.0, -1.0 + eps], [1.0, 1.0 + eps],
                       [1.0 + eps, 1.0], [-1.0 + eps, 1.0]], device=gdev)
    strips = lo[:, None, :] + u * (hi - lo)[:, None, :]   # bottom/top/right/left
    spatial = torch.cat([colloc, strips.reshape(-1, 2)], dim=0)

    per_slice = nc + nb
    ts = slice_times(cfg.time_length, cfg.time_num, gdev)
    x = spatial.repeat(cfg.time_num, 1)
    t = torch.repeat_interleave(ts, per_slice)

    ids = np.arange(cfg.time_num * per_slice).reshape(cfg.time_num, per_slice)
    norm_slice = torch.tensor([[0.0, 1.0]] * m + [[0.0, -1.0]] * m)
    return SpaceTimePoints(
        x=x.to(device), t=t.to(device),
        norm=norm_slice.repeat(cfg.time_num - 1, 1).to(device),
        inner=ids[1:, :nc].reshape(-1),
        neu=ids[1:, nc:nc + 2 * m].reshape(-1),
        dirp=ids[1:, nc + 2 * m:nc + 3 * m].reshape(-1),
        left=ids[:, nc + 3 * m:].reshape(-1),
        init=ids[0, :nc + 3 * m])


def _rank_rows(q: int, rank: int, world: int):
    """(lo, hi, per): rank's real rows [lo, hi) of a q-row block padded to
    a multiple of `world`, `per` rows per rank."""
    per = -(-q // world)
    lo = min(rank * per, q)
    return lo, min(lo + per, q), per


def _pad_rows(t: torch.Tensor, n: int) -> torch.Tensor:
    if t.shape[0] == n:
        return t
    return torch.cat([t, t.new_zeros((n - t.shape[0],) + tuple(t.shape[1:]))])


def row_shard(x: torch.Tensor, counts, rank: int, world: int) -> torch.Tensor:
    """Rank `rank`'s rows of a whole-system row tensor x (rows in the
    residual blocks' order, `block_names_counts`): each block padded to a
    multiple of `world` with zero rows and cut into contiguous slices, the
    layout of `assemble` on a group."""
    parts, ofs = [], 0
    for q in counts:
        lo, hi, per = _rank_rows(q, rank, world)
        parts.append(_pad_rows(x[ofs + lo:ofs + hi], per))
        ofs += q
    return torch.cat(parts)


def _scaled_mse(lhs: torch.Tensor, rhs) -> torch.Tensor:
    """mean((lhs - rhs)^2) / max|lhs|, zero when lhs is all zero."""
    max_x = torch.amax(torch.abs(lhs))
    mse = torch.mean((lhs - rhs) ** 2)
    return torch.where(max_x > 0, mse / torch.clamp(max_x, min=1e-30),
                       torch.zeros_like(mse))


def _sync(t: torch.Tensor) -> None:
    """Wait for the device by fetching one element of `t`."""
    float(t.reshape(-1)[0])


class VortexModel:
    """The velocity-pressure formulation, matrix path.

    `params` and `points` may be given (e.g. converted from the JAX model,
    `convert.rbf_params_from_jax`, `convert.points_from_jax`); otherwise
    they are drawn from a CPU `torch.Generator` seeded with cfg.seed, so
    the CPU and the card get the same draws. The basis blocks are computed
    from them on `device` ("cuda" by default; raises without a card)."""

    def __init__(self, cfg: VortexConfig, log: bool = True, device=None,
                 params: Optional[RBFParams] = None,
                 points: Optional[SpaceTimePoints] = None,
                 group: Optional[Group] = None):
        self.cfg = cfg
        self.group = group
        self.is_main = group is None or group.is_main
        self.device = (device if isinstance(device, torch.device)
                       else resolve_device(device or "cuda"))
        self._picard_seen = 0    # Picard updates over the model's lifetime
        self._whitener = None    # reuse_whitener cache
        # transpose index of the (fixed) pattern of the model's own layout
        # (its rank's row shard with a group)
        self._t_index = None
        tmp = RBFConfig(dim=cfg.dim, n_spatial_basis=cfg.n_spatial_basis)
        self.rbf_cfg = RBFConfig(
            dim=cfg.dim, n_vars=cfg.n_variables, n_feat=cfg.n_feat,
            n_spatial_basis=cfg.n_spatial_basis, time_num=cfg.time_num,
            time_length=cfg.time_length, band_width=cfg.band_width,
            neighbor_k=cfg.neighbor_k, seed=cfg.seed, poly=cfg.poly,
            pou_normalize=cfg.pou_normalize,
            pou_width=(tmp.spatial_spacing
                       if cfg.pou in ("hat", "smooth", "smooth2") else 0.0))
        # sites gathered per point (hat/smooth modes couple `time_window`
        # slices)
        self.k_eff = cfg.neighbor_k * (
            cfg.time_window if cfg.pou in ("hat", "smooth", "smooth2") else 1)
        gen = torch.Generator().manual_seed(cfg.seed)
        dev = self.device
        if params is None:
            params = init_rbf(self.rbf_cfg, gen, dev)
        if points is None:
            points = build_points(cfg, gen, dev)
        self.params = RBFParams(*(t.to(dev) for t in params))
        self.pts = points._replace(x=points.x.to(dev), t=points.t.to(dev),
                                   norm=points.norm.to(dev))
        self._ids = {}
        # gathered basis features at all residual points (static geometry:
        # computed once, reused by every assembly)
        self.pb = self._point_basis(self.params, self.pts.x, self.pts.t)
        self.tb = MetricsWriter(cfg.log_dir) if log and self.is_main else None
        # train(): optax.adam(train_lr) state on u, kept across calls; an
        # optional schedule of the Adam step count replaces train_lr
        # (`solver.cosine_decay_schedule`, optax.adam(schedule))
        self.opt_state = adam_init(self.params.u)
        self.lr_schedule: Optional[Callable] = None
        self._step = 0

    def _ix(self, ids: np.ndarray) -> torch.Tensor:
        """A point index set as a device tensor (cached by identity)."""
        key = id(ids)
        if key not in self._ids:
            self._ids[key] = (ids, torch.as_tensor(ids, dtype=torch.int64,
                                                   device=self.device))
        return self._ids[key][1]

    def _point_basis(self, params, x, t, second: bool = False):
        if self.cfg.pou in ("hat", "smooth", "smooth2"):
            idx = structured_spacetime_idx(self.rbf_cfg, params, x, t,
                                           self.cfg.time_window)
            return point_basis(self.rbf_cfg, params, x, t, idx=idx,
                               time_pou=self.cfg.pou_time or self.cfg.pou,
                               space_pou=self.cfg.pou, second=second)
        return point_basis(self.rbf_cfg, params, x, t, second=second)

    # ---------------- gradient-descent path ----------------
    def residual_loss(self, u: torch.Tensor, pb=None) -> torch.Tensor:
        """Sum of the scale-normalized MSEs of the nonlinear residual blocks
        at the coefficients u, in `residual_terms`' order."""
        return sum(self.residual_terms(u, pb))

    def residual_terms(self, u: torch.Tensor, pb=None) -> list:
        """The scale-normalized MSE of each nonlinear residual block
        (momentum, continuity, free slip, outlet, inlet, initial) at the
        coefficients u."""
        cfg, pts, ix = self.cfg, self.pts, self._ix
        pb = self.pb if pb is None else pb
        Eu = cfg.n_velocity
        val = field_value(pb, u)           # (Q, E)
        grad = field_grad(pb, u)           # (Q, E, D)
        dt = field_dt(pb, u)               # (Q, E)
        inner = ix(pts.inner)

        uin = val[inner, :Eu]
        # momentum: rho (u.grad)u + rho du/dt + grad p - rho g
        adv = torch.einsum("qed,qd->qe", grad[inner, :Eu], uin)
        lhs1 = (cfg.rho * adv + cfg.rho * dt[inner, :Eu]
                + grad[inner, Eu, :])
        rhs1 = torch.full_like(lhs1, cfg.gravity * cfg.rho)
        # continuity
        lhs2 = torch.diagonal(grad[inner, :Eu, :], dim1=-2,
                              dim2=-1).sum(-1)[:, None]
        # free-slip walls: u . n = 0
        lhs3 = torch.einsum("qe,qe->q", val[ix(pts.neu), :Eu], pts.norm)
        # outlet pressure
        lhs4 = val[ix(pts.dirp), Eu]
        # inlet velocity
        lhs5 = val[ix(pts.left), :Eu]
        rhs5 = torch.zeros_like(lhs5)
        rhs5[:, 0] = cfg.internal_v
        # initial condition
        lhs6 = val[ix(pts.init)]
        return [_scaled_mse(lhs1, rhs1), _scaled_mse(lhs2, 0.0),
                _scaled_mse(lhs3, 0.0), _scaled_mse(lhs4, 0.0),
                _scaled_mse(lhs5, rhs5), _scaled_mse(lhs6, 0.0)]

    def train(self, n_iters: int = 1) -> float:
        """n_iters Adam iterations (optax.adam(cfg.train_lr), or of
        `lr_schedule` where one is set; its state kept across calls) on the
        coefficient tensor against `residual_loss`.
        Returns the loss of the last iteration (taken before its update; inf
        for none). The losses stay on the device and are logged after the
        loop under the model's running step numbers."""
        u, state = self.params.u.detach(), self.opt_state
        losses = []
        for _ in range(n_iters):
            u = u.requires_grad_(True)
            loss = self.residual_loss(u)
            (g,) = torch.autograd.grad(loss, u)
            lr = (self.cfg.train_lr if self.lr_schedule is None
                  else self.lr_schedule(state.count))
            updates, state = adam_update(g, state, lr)
            u = u.detach() + updates
            losses.append(loss.detach())
        self.params = self.params._replace(u=u.detach())
        self.opt_state = state
        if not losses:
            return float("inf")
        host = torch.stack(losses).cpu().tolist()
        if self.tb is not None:
            for i, v in enumerate(host):
                self.tb.add_scalars("vortex_train", {"loss": v},
                                    self._step + i)
        self._step += len(host)
        return host[-1]

    # ---------------- linear least-squares path ----------------
    def _assembly_plan(self, pb):
        """The residual blocks as per-point-group row builders:
        [(pb_blk, extras, builder)] in block order, where
        builder(pb_blk, extras, ubar) -> [(vals, cols, rhs, weight)]."""
        cfg, pts, rcfg = self.cfg, self.pts, self.rbf_cfg
        Eu = cfg.n_velocity

        def gather(ids):
            return gather_basis(pb, self._ix(ids))

        def inner_rows(pbi, ex, ubar):
            # momentum rows (one per velocity component d):
            # rho * ((ubar . grad) phi + dphi/dt) + pressure columns
            bdx_i, bdt_i = basis_dx(pbi), basis_dt(pbi)
            ub = field_value(pbi, ubar)[:, :Eu]             # (Qi, Eu)
            out = []
            for d in range(Eu):
                conv = torch.einsum("qkjd,qd->qkj", bdx_i[:, :, d, :, :], ub)
                v_d = cfg.rho * (conv + bdt_i[:, :, d, :])  # (Q, K, J)
                v_p = bdx_i[:, :, Eu, :, d]
                vals = torch.cat([v_d, v_p], dim=1)
                cols = torch.cat([block_ids(rcfg, pbi.idx, d),
                                  block_ids(rcfg, pbi.idx, Eu)], dim=1)
                rhs = torch.full((vals.shape[0],), cfg.gravity * cfg.rho,
                                 device=vals.device)
                out.append((vals, cols, rhs, cfg.w_momentum))
            # continuity rows: sum_d d phi_d / d x_d
            out.append((torch.cat([bdx_i[:, :, 0, :, 0],
                                   bdx_i[:, :, 1, :, 1]], dim=1),
                        torch.cat([block_ids(rcfg, pbi.idx, 0),
                                   block_ids(rcfg, pbi.idx, 1)], dim=1),
                        bdx_i.new_zeros(bdx_i.shape[0]), cfg.w_continuity))
            return out

        def neu_rows(pbn, ex, ubar):
            # free-slip rows: u . n
            bval_n = basis_val(pbn)
            vals = torch.cat([bval_n[:, :, e, :] * ex["norm"][:, e, None, None]
                              for e in range(Eu)], dim=1)
            cols = torch.cat([block_ids(rcfg, pbn.idx, e) for e in range(Eu)],
                             dim=1)
            return [(vals, cols, vals.new_zeros(vals.shape[0]), cfg.w_bc)]

        def dirp_rows(pbd, ex, ubar):
            # outlet pressure rows: p = 0
            bval = basis_val(pbd)
            return [(bval[:, :, Eu, :], block_ids(rcfg, pbd.idx, Eu),
                     bval.new_zeros(bval.shape[0]), cfg.w_bc)]

        def left_rows(pbl, ex, ubar):
            # inlet rows: u_e = (v_in, 0)
            bval_l = basis_val(pbl)
            n = bval_l.shape[0]
            return [(bval_l[:, :, e, :], block_ids(rcfg, pbl.idx, e),
                     bval_l.new_full((n,), cfg.internal_v if e == 0 else 0.0),
                     cfg.w_bc) for e in range(Eu)]

        def init_rows(pb0, ex, ubar):
            # initial rows: all variables zero at t=0
            bval_0 = basis_val(pb0)
            n = bval_0.shape[0]
            return [(bval_0[:, :, e, :], block_ids(rcfg, pb0.idx, e),
                     bval_0.new_zeros(n), cfg.w_init)
                    for e in range(cfg.n_variables)]

        return [(gather(pts.inner), {}, inner_rows),
                (gather(pts.neu), {"norm": pts.norm}, neu_rows),
                (gather(pts.dirp), {}, dirp_rows),
                (gather(pts.left), {}, left_rows),
                (gather(pts.init), {}, init_rows)]

    def _assemble_from_plan(self, plan, ubar, group: Optional[Group] = None):
        """Pad each block's rows to the slot count (2 K) and max-|val|
        normalize them (the reference's per-block scaling); concatenate
        into one BlockSparse whose `row_slots` mark the padding. With a
        group, this rank's rows: every block padded to a multiple of the
        world size with masked zero rows (val = rhs = 0, no real slots:
        inert for least squares), rank r building the r-th contiguous
        slice, each block scaled by the max |val| over all ranks (one
        `pmax`). The ranks' rows together are the whole system's up to row
        order and the padding (`row_shard` cuts the same layout from it)."""
        rank, world = (0, 1) if group is None else (group.rank, group.size)
        nnz = 2 * self.k_eff
        rows = []
        for pb_blk, extras, builder in plan:
            lo, hi, per = _rank_rows(pb_blk.idx.shape[0], rank, world)

            def part(t):
                return _pad_rows(t[lo:hi], per)

            pb_r = type(pb_blk)(*(None if a is None else part(a)
                                  for a in pb_blk))
            for vals, cols, rhs, w in builder(
                    pb_r, {k: part(v) for k, v in extras.items()}, ubar):
                real = vals.shape[1]
                if nnz > real:
                    vals = torch.nn.functional.pad(vals, (0, 0, 0, nnz - real))
                    cols = torch.nn.functional.pad(cols, (0, nnz - real))
                slots = torch.full((per,), real, dtype=torch.int32,
                                   device=vals.device)
                if hi - lo < per:
                    mask = torch.arange(per, device=vals.device) < hi - lo
                    vals = vals * mask[:, None, None].to(vals.dtype)
                    rhs = rhs * mask.to(rhs.dtype)
                    slots = torch.where(mask, slots, 0)
                rows.append((vals, cols, rhs, w, slots))
        scale = torch.clamp(pmax(torch.stack(
            [torch.max(torch.abs(r[0])) for r in rows]), group), min=1e-30)
        A = BlockSparse(
            torch.cat([v / (scale[i] / w)
                       for i, (v, _, _, w, _) in enumerate(rows)]).contiguous(),
            torch.cat([r[1] for r in rows]).to(torch.int32).contiguous(),
            self.rbf_cfg.n_sites * self.rbf_cfg.n_vars,
            row_slots=torch.cat([r[4] for r in rows]),
            t_index=self._t_index if group is self.group else None)
        b = torch.cat([rhs / (scale[i] / w)
                       for i, (_, _, rhs, w, _) in enumerate(rows)])
        return A, b

    def assemble(self, ubar: torch.Tensor, pb=None,
                 group: Optional[Group] = None):
        """The Picard-linearized system around the coefficients `ubar`:
        (BlockSparse A, rhs b). Each row's nonzeros are dense J-feature
        blocks for the K sites of each variable it touches, padded to 2 K
        slots; each residual block is max-|val| normalized. With a group,
        this rank's row shard (`_assemble_from_plan`)."""
        pb = self.pb if pb is None else pb
        return self._assemble_from_plan(self._assembly_plan(pb), ubar, group)

    def _precondition(self):
        cfg = self.cfg
        if cfg.cgls_precondition == "block":
            return "block"
        return {"auto": cfg.cgls_damp == 0.0, "on": True,
                "off": False}[cfg.cgls_precondition]

    def matrix_solver(self, solver: str = "cgls") -> float:
        """Picard loop: assemble around the current coefficients, solve the
        linear least-squares system, repeat `picard_iters` times. Returns
        |A x - b| of the last solve. solver="cgls" is CGLS on the factored
        normal equations (with cfg's preconditioner, damping, chunks,
        restarts and warm start); solver="cg" is `cg_batch` on the explicit
        normal equations A^T A x = A^T b from x0 = A^T b, rtol 1e-6, at most
        cgls_maxiter iterations, unpreconditioned and undamped, as in the
        JAX package. `picard_timings` holds each iteration's assemble /
        whiten / solve seconds (each stage ends in a fetch of one element,
        so the times include the device's work), its iteration count, the
        CGLS phi read at each chunk's end (`phi_history`) and whether the
        system took the `host_sync` round trip. Each iteration is a
        `picard` span, its assembly an `assemble` span (`utils/tracing.py`;
        `whiten`, `cgls` and `cgls_chunk` are `ops/linalg.py`'s). On the
        card without a group, the CGLS iterations run as CUDA graph replays
        (`ops/linalg.GRAPH_ITERS`). The whitener cache, the
        warm start and the Picard count live on the model, so N calls at
        `picard_iters` = 1 give what one call at N gives. With a group,
        solver="cgls" assembles and solves the row-sharded system (each
        rank its rows, the same preconditioner and chunks as one process)
        and the residual is taken over all the ranks' rows; solver="cg"
        solves the whole system on every rank, as the JAX package does on
        a mesh."""
        cfg = self.cfg
        if solver not in ("cgls", "cg"):
            raise ValueError(f"solver must be 'cgls' or 'cg', got {solver!r}")
        if cfg.picard_iters < 1:
            raise ValueError(f"picard_iters must be >= 1, got "
                             f"{cfg.picard_iters}")
        precond = self._precondition()
        if precond == "block" and solver == "cg":
            warnings.warn("cgls_precondition='block' only applies to "
                          "solver='cgls'; the normal-equations cg path runs "
                          "unwhitened.", stacklevel=2)
        if cfg.packed_vals and cfg.rmv_gather and solver == "cgls":
            # the JAX package's warning; both layouts are this one here
            warnings.warn("packed_vals is ignored with rmv_gather (the pull "
                          "transpose needs the unpacked slot layout); "
                          "solving unpacked.", stacklevel=2)
        # solver="cg" solves the whole system on every rank
        group = self.group if solver == "cgls" else None
        u_flat = self.params.u.reshape(-1)
        self.picard_timings = []
        W_cache = self._whitener
        for it in range(cfg.picard_iters):
            with tracing.span("picard"):
                # only a W from a system assembled around a solved field
                # (not the random init) is kept as representative
                representative = self._picard_seen >= 1
                t0 = time.perf_counter()
                ubar = u_flat.reshape(self.params.u.shape)
                with tracing.span("assemble"):
                    A, b = self.assemble(ubar, group=group)
                    _sync(A.vals)
                t_assemble = time.perf_counter() - t0
                operand_mb = (A.vals.numel() * 4 + A.cols.numel() * 4
                              + b.numel() * 4) / 1e6
                if cfg.host_sync:
                    A = BlockSparse(*(torch.from_numpy(t.cpu().numpy()).to(
                        self.device) for t in (A.vals, A.cols)), A.n_blocks,
                                    row_slots=A.row_slots, t_index=A.t_index)
                    b = torch.from_numpy(b.cpu().numpy()).to(self.device)
                t0 = time.perf_counter()
                if solver == "cg":
                    def normal(X):
                        return A.rmv(A.mv(X[0, :, 0]))[None, :, None]

                    X, info = cg_batch(normal, A.rmv(b)[None, :, None],
                                       rtol=1e-6, maxiter=cfg.cgls_maxiter,
                                       check_every=cfg.cgls_chunk or 200)
                    x = X[0, :, 0]
                    info = {**info, "t_whiten": 0.0, "W": None}
                else:
                    # cgls_chunk = 0 is one long loop, whose iterates a
                    # chunked run without restarts repeats; the host reads
                    # the state every 200
                    x, info = cgls_sparse_chunked(
                        A, b, u_flat * cfg.warm_start,
                        maxiter=cfg.cgls_maxiter,
                        tol=cfg.cgls_tol, chunk=cfg.cgls_chunk or 200,
                        precondition=precond, damp=cfg.cgls_damp,
                        restart=cfg.cgls_restart and cfg.cgls_chunk > 0,
                        whitener=W_cache if cfg.reuse_whitener else None,
                        group=group)
                if (cfg.reuse_whitener and W_cache is None and representative
                        and info["W"] is not None):
                    W_cache = self._whitener = info["W"]
                t_whiten = info["t_whiten"]
                u_flat = x
                if group is None:
                    res = torch.linalg.norm(A.mv(x) - b)
                else:   # |A x - b| over every rank's rows
                    res = torch.sqrt(psum(torch.sum((A.mv(x) - b) ** 2),
                                          group))
                _sync(u_flat)
                self._picard_seen += 1
                if group is self.group:
                    self._t_index = A.t_index
                t_solve = time.perf_counter() - t0 - t_whiten
                self.picard_timings.append(
                    {"picard": it, "assemble_s": round(t_assemble, 3),
                     "whiten_s": round(t_whiten, 3),
                     "solve_s": round(t_solve, 3),
                     "operand_mb": round(operand_mb, 1),
                     "cgls_iters": int(info["niter"]),
                     "phi_history": list(info.get("phi_history", ())),
                     "host_shipped": bool(cfg.host_sync)})
                if self.tb is not None:
                    self.tb.add_scalars(
                        "vortex_matrix",
                        {"residual": float(res),
                         "cgls_iters": int(info["niter"])}, it)
        self.params = self.params._replace(
            u=u_flat.reshape(self.params.u.shape))
        return float(res)

    def block_names_counts(self):
        """Residual-block layout of assemble(), in row order."""
        pts, cfg = self.pts, self.cfg
        return ([("momentum_u", len(pts.inner)),
                 ("momentum_v", len(pts.inner)),
                 ("continuity", len(pts.inner)),
                 ("free_slip", len(pts.neu)),
                 ("outlet_p", len(pts.dirp)),
                 ("inlet_u", len(pts.left)),
                 ("inlet_v", len(pts.left))]
                + [(f"init_var{e}", len(pts.init))
                   for e in range(cfg.n_variables)])

    def block_residuals(self) -> dict:
        """Per-block rms of A x - b around the current coefficients (the
        weighted, normalized rows CGLS minimizes)."""
        A, b = self.assemble(self.params.u)
        r = (A.mv(self.params.u.reshape(-1)) - b).cpu().numpy()
        b_np = b.cpu().numpy()
        out, ofs = {}, 0
        for name, n in self.block_names_counts():
            out[name] = {"rms": float(np.sqrt(np.mean(r[ofs:ofs + n] ** 2))),
                         "rhs_rms": float(np.sqrt(np.mean(
                             b_np[ofs:ofs + n] ** 2)))}
            ofs += n
        return out

    # ---------------- evaluation / outputs ----------------
    def _eval_slice(self, grid, t):
        pb = self._point_basis(self.params, grid,
                               torch.full((grid.shape[0],), t,
                                          device=grid.device))
        return field_value(pb, self.params.u)

    def sample_field(self, resolution: int):
        """Velocity/pressure on the cell-centered grid of each time slice:
        (values (T, r*r, E), coords (r*r, 2)), both tensors."""
        grid = sample_uniform(resolution, 2, device=self.device)
        ts = slice_times(self.cfg.time_length, self.cfg.time_num).tolist()
        vals = torch.stack([self._eval_slice(grid, t) for t in ts])
        return vals, grid

    def write_output(self, output_folder: str, resolution: int = 0):
        """field.npy (T, r*r, E) and, where matplotlib is installed, a speed
        figure per slice."""
        os.makedirs(output_folder, exist_ok=True)
        res = resolution or self.cfg.vis_resolution
        vals, grid = self.sample_field(res)
        vals, grid = vals.cpu().numpy(), grid.cpu().numpy()
        np.save(os.path.join(output_folder, "field.npy"), vals)
        if not viz.available():
            warnings.warn("matplotlib is not installed: write_output saved "
                          "field.npy and no PNG figures", stacklevel=2)
            return
        Eu = self.cfg.n_velocity
        for i in range(vals.shape[0]):
            speed = np.linalg.norm(vals[i, :, :Eu], axis=-1)
            viz.save_figure(viz.draw_scatter2D(grid, speed),
                            os.path.join(output_folder,
                                         f"slice{i:02d}_speed.png"))

    # ---------------- checkpoint ----------------
    def save_ckpt(self, path: str):
        """The coefficients + a config snapshot, in the JAX package's `.npz`
        layout (key `['u']`, `__meta__<field>`): the basis is deterministic
        from (seed, config), so the coefficients are all the state."""
        meta = {k: v for k, v in dataclasses.asdict(self.cfg).items()
                if isinstance(v, (int, float, str, bool))}
        meta["formulation"] = ("stream" if isinstance(self, StreamVortexModel)
                               else "velocity")
        save_pytree(path, {"u": self.params.u}, metadata=meta)

    def load_ckpt(self, path: str) -> dict:
        tree, meta = load_pytree(path, {"u": self.params.u},
                                 device=self.device)
        self.params = self.params._replace(u=tree["u"].to(torch.float32))
        return meta


def load_vortex_ckpt(path: str, log: bool = False,
                     device=None) -> VortexModel:
    """Rebuild a solved vortex model from a `save_ckpt` file (of either
    package): the basis from the saved config snapshot, then the
    coefficients. The basis is drawn anew from the seed, so a checkpoint
    resumes the model it came from only within one package."""
    data = np.load(path if path.endswith(".npz") else path + ".npz")
    meta = {k[len("__meta__"):]: data[k][()] for k in data.files
            if k.startswith("__meta__")}
    formulation = str(meta.pop("formulation", "velocity"))
    fields = {f.name for f in dataclasses.fields(VortexConfig)}
    kwargs = {k: (v.item() if hasattr(v, "item") else v)
              for k, v in meta.items() if k in fields}
    cfg = VortexConfig(**kwargs)
    cls = StreamVortexModel if formulation == "stream" else VortexModel
    model = cls(cfg, log=log, device=device)
    model.load_ckpt(path)
    return model


# --------------------------------------------------------------------------
# Stream-function formulation: continuity exact by construction
# --------------------------------------------------------------------------

# u_d = ROT[d, a] * d psi / d x_a  ==  u = (psi_y, -psi_x) = curl(psi)
ROT = ((0.0, 1.0), (-1.0, 0.0))

PSI, PVAR = 0, 1  # variable slots: scalar stream function, pressure


class StreamVortexModel(VortexModel):
    """The channel-flow system with u = curl(psi) = (dpsi/dy, -dpsi/dx):
    continuity (psi_yx - psi_xy) vanishes identically (`basis_hess` is
    symmetric), so its block leaves the system. Variables PSI and PVAR
    (n_variables = 2). Momentum rows need second derivatives of psi, from
    the `second=True` basis block at the interior points (`self.pb2`). One
    psi value row per time slice (`gauge_ids`) pins psi's gauge."""

    def __init__(self, cfg: VortexConfig, log: bool = True, device=None,
                 params: Optional[RBFParams] = None,
                 points: Optional[SpaceTimePoints] = None,
                 group: Optional[Group] = None):
        cfg.n_variables = 2  # psi + pressure
        super().__init__(cfg, log=log, device=device, params=params,
                         points=points, group=group)
        pts = self.pts
        self.rot = torch.tensor(ROT, device=self.device)
        inner = self._ix(pts.inner)
        # second-order basis at interior (momentum) points, same windows
        self.pb2 = self._point_basis_idx(self.params, pts.x[inner],
                                         pts.t[inner], self.pb.idx[inner],
                                         second=True)
        # one gauge point per time slice: the first bottom-wall point
        per_slice = cfg.collocation_pts_num + cfg.boundary_num
        self.gauge_ids = (np.arange(cfg.time_num) * per_slice
                          + cfg.collocation_pts_num)
        # value-BC mode: inlet rows only on t>0 slices (the t=0 slice
        # belongs to the init block)
        self.left_t = self.pts.left[self.pts.left >= per_slice]

    def _point_basis_idx(self, params, x, t, idx, second=False):
        pous = (dict(time_pou=self.cfg.pou_time or self.cfg.pou,
                     space_pou=self.cfg.pou)
                if self.cfg.pou in ("hat", "smooth", "smooth2") else {})
        return point_basis(self.rbf_cfg, params, x, t, idx=idx,
                           second=second, **pous)

    def residual_loss(self, u: torch.Tensor, pb=None,
                      pb2=None) -> torch.Tensor:
        """Sum of the stream form's nonlinear residual MSEs at u."""
        return sum(self.residual_terms(u, pb, pb2))

    def residual_terms(self, u: torch.Tensor, pb=None, pb2=None) -> list:
        """The stream form's nonlinear residual MSEs: momentum on the
        second-order block pb2, the wall and inlet rows of `stream_bc`, the
        outlet (and outlet_v), the initial u, v, psi, p, and the gauge."""
        cfg, pts, ix, rot = self.cfg, self.pts, self._ix, self.rot
        pb = self.pb if pb is None else pb
        pb2 = self.pb2 if pb2 is None else pb2

        val = field_value(pb, u)                        # (Q, 2): psi, p
        grad = field_grad(pb, u)                        # (Q, 2, D)
        vel = torch.einsum("da,qa->qd", rot, grad[:, PSI])

        grad2 = field_grad(pb2, u)
        vel_i = torch.einsum("da,qa->qd", rot, grad2[:, PSI])
        dveldx = torch.einsum("da,qab->qdb", rot, field_hess(pb2, u)[:, PSI])
        dveldt = torch.einsum("da,qa->qd", rot, field_dxdt(pb2, u)[:, PSI])
        adv = torch.einsum("qdb,qb->qd", dveldx, vel_i)
        lhs1 = cfg.rho * adv + cfg.rho * dveldt + grad2[:, PVAR]
        rhs1 = torch.full_like(lhs1, cfg.gravity * cfg.rho)

        value = cfg.stream_bc in ("value", "both")
        deriv = cfg.stream_bc in ("derivative", "both")
        neu = ix(pts.neu)
        lhs3_parts, rhs3_parts = [], []
        if value:
            lhs3_parts.append(val[neu, PSI])
            rhs3_parts.append(torch.where(pts.norm[:, 1] > 0, 0.0,
                                          2.0 * cfg.internal_v))
        if deriv:
            lhs3_parts.append(torch.einsum("qd,qd->q", vel[neu], pts.norm))
            rhs3_parts.append(vel.new_zeros(len(pts.neu)))
        lhs3 = torch.cat(lhs3_parts)
        rhs3 = torch.cat(rhs3_parts)

        left_np = self.left_t if value else pts.left
        left = ix(left_np)
        lhs5_parts, rhs5_parts = [], []
        if value:
            lhs5_parts.append(val[left, PSI])
            rhs5_parts.append(cfg.internal_v * (pts.x[left][:, 1] + 1.0))
        if deriv:
            lhs5_parts.append(vel[left, 0])
            rhs5_parts.append(vel.new_full((len(left_np),), cfg.internal_v))
        lhs5_parts.append(vel[left, 1])         # tangential u_y = 0
        rhs5_parts.append(vel.new_zeros(len(left_np)))
        lhs5 = torch.stack(lhs5_parts, dim=1)
        rhs5 = torch.stack(rhs5_parts, dim=1)
        dirp = ix(pts.dirp)
        lhs4 = val[dirp, PVAR]
        if cfg.outlet_v:
            lhs4 = torch.stack([lhs4, vel[dirp, 1]], dim=1)
        init = ix(pts.init)
        lhs6 = torch.cat([vel[init], val[init]], dim=-1)
        lhs7 = val[ix(self.gauge_ids), PSI]
        return [_scaled_mse(lhs1, rhs1), _scaled_mse(lhs3, rhs3),
                _scaled_mse(lhs4, 0.0), _scaled_mse(lhs5, rhs5),
                _scaled_mse(lhs6, 0.0), _scaled_mse(lhs7, 0.0)]

    def _assembly_plan(self, pb, pb2=None):
        """Stream-form residual blocks as per-point-group builders; the
        interior (momentum) group runs on the second-order block pb2."""
        cfg, pts, rcfg, rot = self.cfg, self.pts, self.rbf_cfg, self.rot
        pb2 = self.pb2 if pb2 is None else pb2

        def gather(ids):
            return gather_basis(pb, self._ix(ids))

        def vel_cols(pb_blk):
            """Velocity columns from psi first derivatives: (Q, K, J, D)."""
            return torch.einsum("da,qkja->qkjd", rot,
                                basis_dx(pb_blk)[:, :, PSI])

        def inner_rows(pbi2, ex, ubar):
            # momentum rows: rho [(ubar . grad) u_d + du_d/dt] + dp/dx_d
            ub = torch.einsum("da,qa->qd", rot,
                              field_grad(pbi2, ubar)[:, PSI])
            Gcols = torch.einsum("da,qkjab->qkjdb", rot,
                                 basis_hess(pbi2)[:, :, PSI])  # du_d/dx_b
            Tcols = torch.einsum("da,qkja->qkjd", rot,
                                 basis_dxdt(pbi2)[:, :, PSI])  # du_d/dt
            conv = torch.einsum("qkjdb,qb->qkjd", Gcols, ub)
            bdx2 = basis_dx(pbi2)
            c_psi = block_ids(rcfg, pbi2.idx, PSI)
            c_p = block_ids(rcfg, pbi2.idx, PVAR)
            out = []
            for d in range(2):
                v_psi = cfg.rho * (conv[..., d] + Tcols[..., d])  # (Q, K, J)
                v_p = bdx2[:, :, PVAR, :, d]
                out.append((torch.cat([v_psi, v_p], dim=1),
                            torch.cat([c_psi, c_p], dim=1),
                            v_psi.new_full((v_psi.shape[0],),
                                           cfg.gravity * cfg.rho),
                            cfg.w_momentum))
            return out   # no continuity rows: div curl(psi) == 0

        def neu_rows(pbn, ex, ubar):
            out = []
            if cfg.stream_bc in ("value", "both"):
                # psi constant along each wall: 0 on the bottom (norm_y > 0),
                # the channel flux 2 v on the top
                rhs_n = torch.where(ex["norm"][:, 1] > 0, 0.0,
                                    2.0 * cfg.internal_v)
                out.append((basis_val(pbn)[:, :, PSI, :],
                            block_ids(rcfg, pbn.idx, PSI), rhs_n, cfg.w_bc))
            if cfg.stream_bc in ("derivative", "both"):
                vals = torch.einsum("qkjd,qd->qkj", vel_cols(pbn), ex["norm"])
                out.append((vals, block_ids(rcfg, pbn.idx, PSI),
                            vals.new_zeros(vals.shape[0]), cfg.w_bc))
            return out

        def dirp_rows(pbd, ex, ubar):
            # outlet pressure rows: p = 0 (+ u_y = 0 with outlet_v)
            bval = basis_val(pbd)
            n = bval.shape[0]
            out = [(bval[:, :, PVAR, :], block_ids(rcfg, pbd.idx, PVAR),
                    bval.new_zeros(n), cfg.w_bc)]
            if cfg.outlet_v:
                out.append((vel_cols(pbd)[..., 1],
                            block_ids(rcfg, pbd.idx, PSI),
                            bval.new_zeros(n), cfg.w_bc))
            return out

        def left_rows(pbl, ex, ubar):
            # inlet rows (value/both modes: t>0 slices only)
            vl = vel_cols(pbl)
            c_l = block_ids(rcfg, pbl.idx, PSI)
            n = vl.shape[0]
            out = []
            if cfg.stream_bc in ("value", "both"):
                # u_x = psi_y = v integrates to psi = v (y + 1)
                out.append((basis_val(pbl)[:, :, PSI, :], c_l,
                            cfg.internal_v * (ex["y"] + 1.0), cfg.w_bc))
            if cfg.stream_bc in ("derivative", "both"):
                out.append((vl[..., 0], c_l, vl.new_full((n,), cfg.internal_v),
                            cfg.w_bc))
            # tangential inlet component u_y = -psi_x = 0 (all modes)
            out.append((vl[..., 1], c_l, vl.new_zeros(n), cfg.w_bc))
            return out

        def init_rows(pb0, ex, ubar):
            # initial rows: u = 0, p = 0, psi = 0 at t = 0
            v0 = vel_cols(pb0)
            c_0 = block_ids(rcfg, pb0.idx, PSI)
            n = v0.shape[0]
            out = [(v0[..., d], c_0, v0.new_zeros(n), cfg.w_init)
                   for d in range(2)]
            bval_0 = basis_val(pb0)
            out.append((bval_0[:, :, PVAR, :],
                        block_ids(rcfg, pb0.idx, PVAR), v0.new_zeros(n),
                        cfg.w_init))
            out.append((bval_0[:, :, PSI, :], c_0, v0.new_zeros(n),
                        cfg.w_init))
            return out

        def gauge_rows(pbg, ex, ubar):
            # gauge rows: psi = 0 at one wall point per slice
            bval = basis_val(pbg)
            return [(bval[:, :, PSI, :], block_ids(rcfg, pbg.idx, PSI),
                     bval.new_zeros(bval.shape[0]), cfg.w_init)]

        left = (self.left_t if cfg.stream_bc in ("value", "both")
                else pts.left)
        return [(pb2, {}, inner_rows),
                (gather(pts.neu), {"norm": pts.norm}, neu_rows),
                (gather(pts.dirp), {}, dirp_rows),
                (gather(left), {"y": pts.x[self._ix(left)][:, 1]}, left_rows),
                (gather(pts.init), {}, init_rows),
                (gather(self.gauge_ids), {}, gauge_rows)]

    def assemble(self, ubar: torch.Tensor, pb=None, pb2=None,
                 group: Optional[Group] = None):
        pb = self.pb if pb is None else pb
        return self._assemble_from_plan(self._assembly_plan(pb, pb2), ubar,
                                        group)

    def block_names_counts(self):
        pts, cfg = self.pts, self.cfg
        value = cfg.stream_bc in ("value", "both")
        deriv = cfg.stream_bc in ("derivative", "both")
        n_left = len(self.left_t) if value else len(pts.left)
        names = [("momentum_u", len(pts.inner)),
                 ("momentum_v", len(pts.inner))]
        if value:
            names.append(("wall_psi", len(pts.neu)))
        if deriv:
            names.append(("free_slip", len(pts.neu)))
        names.append(("outlet_p", len(pts.dirp)))
        if cfg.outlet_v:
            names.append(("outlet_v", len(pts.dirp)))
        if value:
            names.append(("inlet_psi", n_left))
        if deriv:
            names.append(("inlet_u", n_left))
        names += [("inlet_v", n_left),
                  ("init_u", len(pts.init)),
                  ("init_v", len(pts.init)),
                  ("init_p", len(pts.init)),
                  ("init_psi", len(pts.init)),
                  ("gauge_psi", len(self.gauge_ids))]
        return names

    def _eval_slice(self, grid, t):
        """[u, v, p]: the same output contract as the velocity
        formulation's (E = 3)."""
        pb = self._point_basis(self.params, grid,
                               torch.full((grid.shape[0],), t,
                                          device=grid.device))
        val = field_value(pb, self.params.u)
        vel = torch.einsum("da,qa->qd", self.rot,
                           field_grad(pb, self.params.u)[:, PSI])
        return torch.cat([vel, val[:, PVAR:PVAR + 1]], dim=-1)


def divergence_fd(vals: np.ndarray, resolution: int) -> np.ndarray:
    """Central-difference divergence of a sampled velocity grid (T, r*r,
    >=2) on sample_field's meshgrid(indexing='ij') layout: (T, r-2, r-2)."""
    r = resolution
    u = np.asarray(vals)[..., :2].reshape(vals.shape[0], r, r, 2)
    h = 2.0 / r
    dudx = (u[:, 2:, 1:-1, 0] - u[:, :-2, 1:-1, 0]) / (2 * h)
    dvdy = (u[:, 1:-1, 2:, 1] - u[:, 1:-1, :-2, 1]) / (2 * h)
    return dudx + dvdy


def relative_divergence(model: VortexModel, resolution: int = 64) -> float:
    """rms(div u) / rms(|grad u|) over the sampled grid, both by the same
    finite differences (~0 for a divergence-free field)."""
    vals = model.sample_field(resolution)[0].cpu().numpy()
    div = divergence_fd(vals, resolution)
    r = resolution
    u = vals[..., :2].reshape(vals.shape[0], r, r, 2)
    h = 2.0 / r
    gx = (u[:, 2:, 1:-1] - u[:, :-2, 1:-1]) / (2 * h)
    gy = (u[:, 1:-1, 2:] - u[:, 1:-1, :-2]) / (2 * h)
    gnorm = np.sqrt(gx[..., 0] ** 2 + gx[..., 1] ** 2
                    + gy[..., 0] ** 2 + gy[..., 1] ** 2)
    return float(np.sqrt(np.mean(div ** 2))
                 / max(np.sqrt(np.mean(gnorm ** 2)), 1e-30))


def inlet_error(model: VortexModel, resolution: int = 64) -> float:
    """Mean |u_x - v| / v along the inlet column of the sampled grid over
    the t>0 slices (a copy of `tools/vortex_truth.inlet_error`)."""
    vals = model.sample_field(resolution)[0].cpu().numpy()
    r = resolution
    g = vals.reshape(vals.shape[0], r, r, -1)
    ux = g[1:, 0, :, 0]
    v = model.cfg.internal_v
    return float(np.mean(np.abs(ux - v)) / max(abs(v), 1e-30))
