"""Random-basis-function space-time ansatz (counterpart of
`insr_pde_tpu/models/rbf.py`).

The field is

    u_e(x, t) = sum_{n in KNN(x,t)} sum_j  w_n(x,t) * sigmoid(z_{n,e,j}) * U[n,e,j]
    z_{n,e,j} = A[n,e,j,:] . (x - c_n)/bw  +  tA[n,e,j] * (t - s_n)/tbw + b[n,e,j]

with fixed random (A, tA, b), grid-placed space-time basis sites (c_n, s_n),
partition-of-unity weights w, and solvable coefficients U. Derivatives are
analytic (sigma' = sigma(1 - sigma)), first and second order, with the
product and quotient rules through the PoU weights. Everything is a pure
function of an `RBFParams` tuple of tensors; results land on the params'
device.

The random features are drawn from a `torch.Generator`, so they differ from
the JAX package's draws from the same seed; the site grid is bit-exact
(`ops/sampling.sample_uniform`, `_linspace_f32`). Tests hand both packages
the same params (`convert.rbf_params_from_jax`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.knn import knn
from ..ops.sampling import _linspace_f32, sample_uniform


@dataclass(frozen=True)
class RBFConfig:
    """The RBF basis configuration (the JAX package's `RBFConfig`)."""
    dim: int = 2
    n_vars: int = 3            # variable_num (E)
    n_feat: int = 16           # num_per_point_feature (J)
    n_spatial_basis: int = 400  # N (snapped to resolution**dim)
    time_num: int = 10         # T time slices
    time_length: float = 1.0
    band_width: float = 10.0
    neighbor_k: int = 6
    seed: int = 213421
    pou_width: float = 0.0     # spatial PoU support; 0 = band_width
    # Shepard-normalize the combined PoU weights w_k -> w_k / sum_k w_k,
    # with the quotient-rule derivative chain (exact partition of unity in
    # the half-spacing edge strips). Ignored when both PoUs are 'simple'.
    pou_normalize: bool = False
    # per-site polynomial tail appended to the J sigmoid features (0 = off,
    # 1 = {1, x, y, .., t}, 2 = + all space-time quadratics)
    poly: int = 0

    @property
    def spatial_spacing(self) -> float:
        return 2.0 / self.spatial_resolution

    @property
    def effective_pou_width(self) -> float:
        return self.pou_width if self.pou_width > 0 else self.band_width

    @property
    def spatial_resolution(self) -> int:
        return int(round(self.n_spatial_basis ** (1.0 / self.dim)))

    @property
    def n_sites_spatial(self) -> int:
        return self.spatial_resolution ** self.dim

    @property
    def n_sites(self) -> int:
        return self.n_sites_spatial * self.time_num

    @property
    def time_band_width(self) -> float:
        # time PoU support = slice spacing so each point sees its own slice
        return self.time_length / max(self.time_num - 1, 1)

    @property
    def n_poly(self) -> int:
        if self.poly <= 0:
            return 0
        n = 1 + self.dim + 1                      # 1, x_a, t
        if self.poly >= 2:
            n += self.dim * (self.dim + 1) // 2 + self.dim + 1
        return n

    @property
    def n_feat_total(self) -> int:
        return self.n_feat + self.n_poly

    @property
    def n_coeffs(self) -> int:
        return self.n_sites * self.n_vars * self.n_feat_total


class RBFParams(NamedTuple):
    centers: torch.Tensor   # (S, dim) spatial site positions
    times: torch.Tensor     # (S,)     site time coordinates
    A: torch.Tensor         # (S, E, J, dim) random spatial directions
    tA: torch.Tensor        # (S, E, J) random time directions
    bias: torch.Tensor      # (S, E, J)
    u: torch.Tensor         # (S, E, J_total) solvable coefficients


def slice_times(time_length: float, time_num: int, device=None):
    """`jnp.linspace(0, time_length, time_num)` bit for bit."""
    return torch.from_numpy(_linspace_f32(0.0, time_length,
                                          time_num)).to(device)


def init_rbf(cfg: RBFConfig, generator: torch.Generator,
             device=None) -> RBFParams:
    """Grid basis sites (cell centers of a `spatial_resolution`^dim grid,
    replicated over the time slices) and N(0, 1) random features drawn from
    `generator` in the order A, tA, bias, u, then moved to `device`."""
    grid = sample_uniform(cfg.spatial_resolution, cfg.dim)
    ts = slice_times(cfg.time_length, cfg.time_num)
    centers = grid.repeat(cfg.time_num, 1)
    times = torch.repeat_interleave(ts, grid.shape[0])
    S = centers.shape[0]
    shape = (S, cfg.n_vars, cfg.n_feat)

    def normal(*s):
        return torch.randn(s, generator=generator, dtype=torch.float32,
                           device=generator.device)

    A = normal(*shape, cfg.dim)
    tA = normal(*shape)
    bias = normal(*shape)
    u = normal(S, cfg.n_vars, cfg.n_feat_total)
    return RBFParams(*(t.to(device) for t in (centers, times, A, tA, bias,
                                              u)))


def pou_simple(x: torch.Tensor) -> torch.Tensor:
    """Indicator partition-of-unity bump on [-1, 1]."""
    return ((x >= -1.0) & (x <= 1.0)).to(x.dtype)


def pou_sine(x: torch.Tensor) -> torch.Tensor:
    """C1 sine-blended bump on [-5/4, 5/4]: shoulders 0.5 +/- sin(2 pi x)/2,
    plateau 1 inside [-3/4, 3/4]."""
    s = torch.sin(2.0 * np.pi * x) / 2.0
    out = torch.zeros_like(x)
    out = torch.where((x >= -1.25) & (x < -0.75), 0.5 + s, out)
    out = torch.where((x >= -0.75) & (x < 0.75), torch.ones_like(x), out)
    out = torch.where((x >= 0.75) & (x < 1.25), 0.5 - s, out)
    return out


def pou_hat(x: torch.Tensor) -> torch.Tensor:
    """Hat bump on [-1, 1]: a true partition of unity at unit spacing."""
    return torch.clamp(1.0 - torch.abs(x), min=0.0)


def pou_hat_grad(x: torch.Tensor) -> torch.Tensor:
    """d pou_hat / dx (a.e.): -sign(x) inside the support."""
    return torch.where(torch.abs(x) < 1.0, -torch.sign(x),
                       torch.zeros_like(x))


def _s(x):
    return torch.clamp(1.0 - torch.abs(x), 0.0, 1.0)


def pou_smooth(x: torch.Tensor) -> torch.Tensor:
    """C1 smooth-hat PoU on [-1, 1]: S(1 - |x|), S(s) = 3s^2 - 2s^3."""
    s = _s(x)
    return s * s * (3.0 - 2.0 * s)


def pou_smooth_grad(x: torch.Tensor) -> torch.Tensor:
    """d pou_smooth / dx: -sign(x) S'(1-|x|), S'(s) = 6s(1-s)."""
    s = _s(x)
    return -torch.sign(x) * 6.0 * s * (1.0 - s)


def pou_smooth_hess(x: torch.Tensor) -> torch.Tensor:
    """d2 pou_smooth / dx2 (a.e.): S''(1-|x|) = 6 - 12(1-|x|) inside."""
    return torch.where(torch.abs(x) < 1.0, 6.0 - 12.0 * _s(x),
                       torch.zeros_like(x))


def pou_smooth2(x: torch.Tensor) -> torch.Tensor:
    """C2 smooth-hat PoU on [-1, 1]: S5(1 - |x|), the quintic
    smootherstep S5(s) = 6s^5 - 15s^4 + 10s^3."""
    s = _s(x)
    return s ** 3 * (10.0 + s * (-15.0 + 6.0 * s))


def pou_smooth2_grad(x: torch.Tensor) -> torch.Tensor:
    """d pou_smooth2 / dx: -sign(x) S5'(1-|x|), S5'(s) = 30 s^2 (1-s)^2."""
    s = _s(x)
    return -torch.sign(x) * 30.0 * (s * (1.0 - s)) ** 2


def pou_smooth2_hess(x: torch.Tensor) -> torch.Tensor:
    """d2 pou_smooth2 / dx2: S5''(1-|x|) = 60 s (1-s) (1-2s)."""
    s = _s(x)
    return 60.0 * s * (1.0 - s) * (1.0 - 2.0 * s)


# (value, grad, second) per PoU family; grads/seconds are a.e. derivatives
# in the PoU's own normalized coordinate (callers divide by the width).
_POU_FNS = {
    "simple": (pou_simple, torch.zeros_like, torch.zeros_like),
    "hat": (pou_hat, pou_hat_grad, torch.zeros_like),
    "smooth": (pou_smooth, pou_smooth_grad, pou_smooth_hess),
    "smooth2": (pou_smooth2, pou_smooth2_grad, pou_smooth2_hess),
}


def _poly_terms(dim: int, degree: int) -> list[tuple[tuple, int]]:
    """Monomial exponent tuples ((ex_0..ex_{D-1}), et) of the degree-`degree`
    polynomial tail in the site-local coordinates (x_rel, t_rel)."""
    terms = [((0,) * dim, 0)]
    if degree >= 1:
        for a in range(dim):
            e = [0] * dim
            e[a] = 1
            terms.append((tuple(e), 0))
        terms.append(((0,) * dim, 1))
    if degree >= 2:
        for a in range(dim):
            for b in range(a, dim):
                e = [0] * dim
                e[a] += 1
                e[b] += 1
                terms.append((tuple(e), 0))
        for a in range(dim):
            e = [0] * dim
            e[a] = 1
            terms.append((tuple(e), 1))
        terms.append(((0,) * dim, 2))
    return terms


def _poly_block(x_rel: torch.Tensor, t_rel: torch.Tensor, bw: float,
                tbw: float, degree: int, second: bool):
    """Polynomial tail features and analytic derivatives in physical
    coordinates (d x_rel / dx = 1/bw, d t_rel / dt = 1/tbw).

    Returns (phi (Q,K,P), dx (Q,K,P,D), dt (Q,K,P), dxx_diag (Q,K,P,D),
    dxx_full (Q,K,P,D,D) | None, dxt (Q,K,P,D) | None)."""
    dim = x_rel.shape[-1]
    terms = _poly_terms(dim, degree)

    def mono(ex, et):
        v = torch.ones_like(t_rel)
        for d, e in enumerate(ex):
            if e:
                v = v * (x_rel[..., d] ** e if e > 1 else x_rel[..., d])
        if et:
            v = v * (t_rel ** et if et > 1 else t_rel)
        return v

    def d_dx(ex, et, a):
        if ex[a] == 0:
            return None
        e2 = list(ex)
        e2[a] -= 1
        return (ex[a] / bw), (tuple(e2), et)

    zeros = torch.zeros_like(t_rel)

    def first(ex, et, a):
        r = d_dx(ex, et, a)
        return zeros if r is None else r[0] * mono(*r[1])

    def d2_dx(ex, et, a, b):
        r1 = d_dx(ex, et, a)
        if r1 is None:
            return zeros
        c1, (ex1, et1) = r1
        r2 = d_dx(ex1, et1, b)
        if r2 is None:
            return zeros
        c2, (ex2, et2) = r2
        return c1 * c2 * mono(ex2, et2)

    phi = torch.stack([mono(ex, et) for ex, et in terms], dim=-1)
    dx = torch.stack([torch.stack([first(ex, et, a) for a in range(dim)],
                                  dim=-1) for ex, et in terms], dim=-2)
    dt = torch.stack([zeros if et == 0 else (et / tbw) * mono(ex, et - 1)
                      for ex, et in terms], dim=-1)
    dxx_diag = torch.stack(
        [torch.stack([d2_dx(ex, et, a, a) for a in range(dim)], dim=-1)
         for ex, et in terms], dim=-2)
    dxx_full = dxt = None
    if second:
        dxx_full = torch.stack(
            [torch.stack([torch.stack([d2_dx(ex, et, a, b)
                                       for b in range(dim)], dim=-1)
                          for a in range(dim)], dim=-2)
             for ex, et in terms], dim=-3)

        def d2_dxdt(ex, et, a):
            r = d_dx(ex, et, a)
            if r is None or et == 0:
                return zeros
            c1, (ex1, et1) = r
            return c1 * (et1 / tbw) * mono(ex1, et1 - 1)

        dxt = torch.stack(
            [torch.stack([d2_dxdt(ex, et, a) for a in range(dim)], dim=-1)
             for ex, et in terms], dim=-2)
    return phi, dx, dt, dxx_diag, dxx_full, dxt


class PointBasis(NamedTuple):
    """Per-query gathered basis block.

    phi (Q, K, E, J), dx (Q, K, E, J, D), dt (Q, K, E, J), dxx (Q, K, E, J,
    D) diagonal seconds, w (Q, K) PoU weights, dwdt (Q, K), dwdx (Q, K, D),
    idx (Q, K) int64 site indices. With `second=True`: dxx_full (Q, K, E,
    J, D, D), dxt (Q, K, E, J, D), dwdx2 (Q, K, D, D), dwdxdt (Q, K, D).
    """
    phi: torch.Tensor
    dx: torch.Tensor
    dt: torch.Tensor
    dxx: torch.Tensor
    w: torch.Tensor
    dwdt: torch.Tensor
    dwdx: torch.Tensor
    idx: torch.Tensor
    dxx_full: Optional[torch.Tensor] = None
    dxt: Optional[torch.Tensor] = None
    dwdx2: Optional[torch.Tensor] = None
    dwdxdt: Optional[torch.Tensor] = None


def gather_basis(pb: PointBasis, ids) -> PointBasis:
    """The rows `ids` of every field of a PointBasis."""
    return PointBasis(*(None if a is None else a[ids] for a in pb))


def point_basis(cfg: RBFConfig, p: RBFParams, x: torch.Tensor,
                t: torch.Tensor, idx: Optional[torch.Tensor] = None,
                time_pou: str = "simple", space_pou: str = "simple",
                second: bool = False) -> PointBasis:
    """Gathered features at (x (Q, dim), t (Q,)).

    With idx None, space-time KNN with the time axis rescaled by bw/tbw.
    time_pou / space_pou name a PoU family of `_POU_FNS`; the spatial PoU
    has width cfg.effective_pou_width and enters the derivative columns by
    the product rule.
    """
    bw, tbw = cfg.band_width, cfg.time_band_width
    if idx is None:
        scale = bw / tbw
        query = torch.cat([x, (t * scale)[:, None]], dim=1)
        sites = torch.cat([p.centers, (p.times * scale)[:, None]], dim=1)
        _, idx = knn(query, sites, cfg.neighbor_k)

    c = p.centers[idx]                                     # (Q, K, D)
    x_rel = (x[:, None, :] - c) / bw
    t_rel = (t[:, None] - p.times[idx]) / tbw              # (Q, K)

    A = p.A[idx]                                           # (Q, K, E, J, D)
    tA = p.tA[idx]                                         # (Q, K, E, J)
    b = p.bias[idx]

    z = (torch.einsum("qkejd,qkd->qkej", A, x_rel)
         + tA * t_rel[:, :, None, None] + b)
    phi = torch.sigmoid(z)
    sig1 = phi * (1.0 - phi)                               # sigma'
    sig2 = sig1 * (1.0 - 2.0 * phi)                        # sigma''

    dx = sig1[..., None] * A / bw
    dt = sig1 * tA / tbw
    dxx = sig2[..., None] * (A / bw) ** 2

    pw = cfg.effective_pou_width
    xp_rel = (x[:, None, :] - c) / pw                      # (Q, K, D)
    pv, pg, ph = _POU_FNS[space_pou]
    per_dim = pv(xp_rel)                                   # (Q, K, D)
    g = pg(xp_rel) / pw
    x_w = torch.prod(per_dim, dim=-1)
    inside = per_dim > 0
    zero = torch.zeros_like(per_dim)
    safe = torch.where(inside, per_dim, torch.ones_like(per_dim))
    # d/dx_a of the product: grad of dim a times the other dims' values
    excl = x_w[..., None] / safe
    dx_w = torch.where(inside, excl * g, zero)
    dxx_w = None
    if second:
        # d2/dx_a dx_b of prod_d v(x_d): off-diagonal g_a g_b times the
        # product over the remaining dims; diagonal v''_a times the others
        excl_ab = x_w[..., None, None] / (safe[..., :, None]
                                          * safe[..., None, :])
        both = inside[..., :, None] & inside[..., None, :]
        dxx_w = torch.where(both, excl_ab * g[..., :, None]
                            * g[..., None, :], torch.zeros_like(excl_ab))
        h = ph(xp_rel) / pw ** 2
        diag = torch.where(inside, excl * h, zero)
        eye = torch.eye(x.shape[-1], dtype=torch.bool, device=x.device)
        dxx_w = torch.where(eye, diag[..., :, None] * eye, dxx_w)

    tv, tg, _ = _POU_FNS[time_pou]
    t_w = tv(t_rel)
    dt_w = tg(t_rel) / tbw

    dxx_full = dxt = dwdx2 = dwdxdt = None
    if second:
        A_bw = A / bw                                      # (Q, K, E, J, D)
        dxx_full = sig2[..., None, None] * (A_bw[..., :, None]
                                            * A_bw[..., None, :])
        dxt = sig2[..., None] * A_bw * (tA / tbw)[..., None]
        dwdx2 = dxx_w * t_w[..., None, None]
        dwdxdt = dx_w * dt_w[..., None]

    if cfg.poly > 0:
        # polynomial tail appended on the J axis, identical across E (each
        # variable keeps its own coefficients in u)
        E = phi.shape[2]

        def bcast(a):
            return a[:, :, None].expand(a.shape[:2] + (E,) + a.shape[2:])

        p_phi, p_dx, p_dt, p_dxx, p_full, p_dxt = _poly_block(
            x_rel, t_rel, bw, tbw, cfg.poly, second)
        phi = torch.cat([phi, bcast(p_phi)], dim=3)
        dx = torch.cat([dx, bcast(p_dx)], dim=3)
        dt = torch.cat([dt, bcast(p_dt)], dim=3)
        dxx = torch.cat([dxx, bcast(p_dxx)], dim=3)
        if second:
            dxx_full = torch.cat([dxx_full, bcast(p_full)], dim=3)
            dxt = torch.cat([dxt, bcast(p_dxt)], dim=3)
    w = x_w * t_w                                          # (Q, K)
    dwdt = x_w * dt_w                                      # (Q, K)
    dwdx = dx_w * t_w[..., None]                           # (Q, K, D)

    if cfg.pou_normalize and (space_pou != "simple" or time_pou != "simple"):
        # Shepard normalization w_hat = w / W, W = sum_k w_k, with the
        # quotient-rule chain through every tracked derivative
        W = torch.sum(w, dim=1, keepdim=True)              # (Q, 1)
        iW = 1.0 / torch.clamp(W, min=1e-12)
        Wx = torch.sum(dwdx, dim=1, keepdim=True)          # (Q, 1, D)
        Wt = torch.sum(dwdt, dim=1, keepdim=True)          # (Q, 1)
        iW2 = iW * iW
        if second:
            Wxx = torch.sum(dwdx2, dim=1, keepdim=True)    # (Q, 1, D, D)
            Wxt = torch.sum(dwdxdt, dim=1, keepdim=True)   # (Q, 1, D)
            iW3 = iW2 * iW
            dwdx2 = (dwdx2 * iW[..., None, None]
                     - (dwdx[..., :, None] * Wx[..., None, :]
                        + dwdx[..., None, :] * Wx[..., :, None]
                        + w[..., None, None] * Wxx) * iW2[..., None, None]
                     + 2.0 * w[..., None, None]
                     * (Wx[..., :, None] * Wx[..., None, :])
                     * iW3[..., None, None])
            dwdxdt = (dwdxdt * iW[..., None]
                      - (dwdx * Wt[..., None] + dwdt[..., None] * Wx
                         + w[..., None] * Wxt) * iW2[..., None]
                      + 2.0 * (w * Wt)[..., None] * Wx * iW3[..., None])
        dwdx = dwdx * iW[..., None] - (w * iW2)[..., None] * Wx
        dwdt = dwdt * iW - w * Wt * iW2
        w = w * iW

    return PointBasis(phi=phi, dx=dx, dt=dt, dxx=dxx, w=w, dwdt=dwdt,
                      dwdx=dwdx, idx=idx, dxx_full=dxx_full, dxt=dxt,
                      dwdx2=dwdx2, dwdxdt=dwdxdt)


# ---- per-coefficient column blocks (Q, K, E, J) ---------------------------

def basis_val(pb: PointBasis) -> torch.Tensor:
    """Columns of the value operator: w * phi."""
    return pb.w[:, :, None, None] * pb.phi


def basis_dx(pb: PointBasis) -> torch.Tensor:
    """Columns of d/dx: w * dphi/dx + dw/dx * phi, (Q, K, E, J, D)."""
    return (pb.w[:, :, None, None, None] * pb.dx
            + pb.dwdx[:, :, None, None, :] * pb.phi[..., None])


def basis_dt(pb: PointBasis) -> torch.Tensor:
    """Columns of d/dt: w * dphi/dt + dw/dt * phi."""
    return (pb.w[:, :, None, None] * pb.dt
            + pb.dwdt[:, :, None, None] * pb.phi)


def basis_dxx_diag(pb: PointBasis) -> torch.Tensor:
    """Columns of the diagonal second derivatives: w * phi'' + 2 dw/dx
    phi', (Q, K, E, J, D)."""
    return (pb.w[:, :, None, None, None] * pb.dxx
            + 2.0 * pb.dwdx[:, :, None, None, :] * pb.dx)


def basis_hess(pb: PointBasis) -> torch.Tensor:
    """Columns of the full spatial Hessian d2(w phi)/dx_a dx_b with the PoU
    product-rule terms, (Q, K, E, J, D, D); symmetric in (a, b). Needs a
    `second=True` point_basis."""
    w = pb.w[:, :, None, None, None, None]
    wa = pb.dwdx[:, :, None, None, :, None]
    wb = pb.dwdx[:, :, None, None, None, :]
    wab = pb.dwdx2[:, :, None, None, :, :]
    return (w * pb.dxx_full
            + wa * pb.dx[..., None, :] + wb * pb.dx[..., :, None]
            + wab * pb.phi[..., None, None])


def basis_dxdt(pb: PointBasis) -> torch.Tensor:
    """Columns of d2(w phi)/dx_a dt, (Q, K, E, J, D). Needs a
    `second=True` point_basis."""
    return (pb.w[:, :, None, None, None] * pb.dxt
            + pb.dwdx[:, :, None, None, :] * pb.dt[..., None]
            + pb.dwdt[:, :, None, None, None] * pb.dx
            + pb.dwdxdt[:, :, None, None, :] * pb.phi[..., None])


# ---- field evaluation against coefficients --------------------------------

def field_value(pb: PointBasis, u: torch.Tensor) -> torch.Tensor:
    """u_e(x, t): (Q, E)."""
    return torch.einsum("qkej,qkej->qe", basis_val(pb), u[pb.idx])


def field_grad(pb: PointBasis, u: torch.Tensor) -> torch.Tensor:
    """d u_e / d x: (Q, E, D)."""
    return torch.einsum("qkejd,qkej->qed", basis_dx(pb), u[pb.idx])


def field_dt(pb: PointBasis, u: torch.Tensor) -> torch.Tensor:
    """d u_e / d t: (Q, E)."""
    return torch.einsum("qkej,qkej->qe", basis_dt(pb), u[pb.idx])


def field_lap(pb: PointBasis, u: torch.Tensor) -> torch.Tensor:
    """Laplacian of u_e: (Q, E)."""
    return torch.einsum("qkej,qkej->qe", basis_dxx_diag(pb).sum(-1),
                        u[pb.idx])


def field_hess(pb: PointBasis, u: torch.Tensor) -> torch.Tensor:
    """Full spatial Hessian of u_e: (Q, E, D, D)."""
    return torch.einsum("qkejab,qkej->qeab", basis_hess(pb), u[pb.idx])


def field_dxdt(pb: PointBasis, u: torch.Tensor) -> torch.Tensor:
    """Mixed space-time derivative of u_e: (Q, E, D)."""
    return torch.einsum("qkeja,qkej->qea", basis_dxdt(pb), u[pb.idx])


def column_ids(cfg: RBFConfig, idx: torch.Tensor, var: int) -> torch.Tensor:
    """Global coefficient columns for (site idx (Q, K), var e): (Q, K*J),
    in the flat layout ((site * E) + e) * J + j of u."""
    E, J = cfg.n_vars, cfg.n_feat_total
    base = (idx * E + var) * J                        # (Q, K)
    j = torch.arange(J, device=idx.device, dtype=idx.dtype)
    return (base[:, :, None] + j).reshape(idx.shape[0], -1)


def block_ids(cfg: RBFConfig, idx: torch.Tensor, var: int) -> torch.Tensor:
    """Block-column ids `site * E + e` for (site idx (Q, K), var e): (Q, K);
    flat column = block * J + j."""
    return idx * cfg.n_vars + var


def spatial_knn_idx(cfg: RBFConfig, p: RBFParams,
                    x: torch.Tensor) -> torch.Tensor:
    """Spatial-only neighbor search over the basis centers, (Q, K)."""
    _, idx = knn(x, p.centers, cfg.neighbor_k)
    return idx


def structured_spacetime_idx(cfg: RBFConfig, p: RBFParams, x: torch.Tensor,
                             t: torch.Tensor,
                             time_window: int = 2) -> torch.Tensor:
    """K spatial-nearest grid sites x the `time_window` nearest time slices,
    (Q, K * time_window): every point couples to adjacent slices."""
    ns = cfg.n_sites_spatial
    _, sidx = knn(x, p.centers[:ns], cfg.neighbor_k)       # (Q, K)
    spacing = cfg.time_length / max(cfg.time_num - 1, 1)
    # a tensor divisor: on the card a division by a Python scalar multiplies
    # by its reciprocal, which can round t / spacing below a slice's index
    div = torch.tensor(spacing, dtype=t.dtype, device=t.device)
    base = torch.floor(t / div).to(torch.int64)
    # clamp the window start so the slices stay distinct at t = T
    base = torch.clamp(base - (time_window - 1) // 2, 0,
                       max(cfg.time_num - time_window, 0))
    offs = torch.arange(time_window, dtype=torch.int64, device=t.device)
    slices = base[:, None] + offs[None, :]                 # (Q, W)
    idx = slices[:, :, None] * ns + sidx[:, None, :]       # (Q, W, K)
    return idx.reshape(x.shape[0], -1)


def point_basis_dense(cfg: RBFConfig, p: RBFParams, x: torch.Tensor,
                      t: torch.Tensor) -> PointBasis:
    """All-sites variant (K = S); for small site counts only."""
    S = p.centers.shape[0]
    idx = torch.arange(S, device=x.device)[None, :].expand(x.shape[0], S)
    return point_basis(cfg, p, x, t, idx=idx)
