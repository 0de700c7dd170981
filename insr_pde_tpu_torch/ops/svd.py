"""Singular values of batched small matrices, and the elasticity energies
built on them (counterpart of `insr_pde_tpu/ops/svd.py`).

The elasticity model only needs the singular values of its (N, d, d)
deformation gradients. A full SVD's pullback has 1/(sigma_i^2 - sigma_j^2)
terms that are infinite at repeated singular values, and the rest state
F = I, where every elasticity run starts, is such a point. So:

  * `singular_values` is an `autograd.Function` whose primal is closed form
    (2x2: two hypots; 3x3: Cardano on F^T F) and whose backward is the
    sigma-only rule dF = U diag(g) V^T, finite at degeneracies;
  * `nuclear_norm` is an `autograd.Function` whose backward is g R, with R
    the polar factor from Newton's iteration computed without a graph:
    autograd never differentiates the Cardano primal (sqrt and arccos have
    infinite derivatives at F = I) nor the guard's `where`, whose unselected
    branch may hold inf;
  * `arap_energy` = sum |F|_F^2 - 2 nuclear(F) + d and `volume_energy` =
    sum (|det F| - 1)^2 are plain functions.

Determinants and adjugates are the closed-form 2x2 and 3x3 cofactor
expressions: elementwise ops, no batched LU.
"""

from __future__ import annotations

import math

import torch


def _det(X: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., d, d) for d in {2, 3} by cofactors; larger d
    through `torch.linalg.det`."""
    d = X.shape[-1]
    if d == 2:
        return X[..., 0, 0] * X[..., 1, 1] - X[..., 0, 1] * X[..., 1, 0]
    if d == 3:
        c0 = torch.linalg.cross(X[..., 1, :], X[..., 2, :])
        return torch.sum(X[..., 0, :] * c0, dim=-1)
    return torch.linalg.det(X)


def _sv_2x2(F: torch.Tensor) -> torch.Tensor:
    """Closed-form singular values of (..., 2, 2), descending."""
    a, b = F[..., 0, 0], F[..., 0, 1]
    c, d = F[..., 1, 0], F[..., 1, 1]
    q = torch.hypot(a + d, b - c) * 0.5
    r = torch.hypot(a - d, b + c) * 0.5
    return torch.stack([q + r, torch.abs(q - r)], dim=-1)


def _sv_3x3(F: torch.Tensor) -> torch.Tensor:
    """Closed-form singular values of (..., 3, 3): Cardano eigenvalues of
    C = F^T F, descending; exact at full degeneracy (C = q I). Never
    differentiated: the Functions below supply the derivatives."""
    C = torch.einsum("...ji,...jk->...ik", F, F)
    q = torch.diagonal(C, dim1=-2, dim2=-1).sum(-1) / 3.0
    A = C - q[..., None, None] * torch.eye(3, dtype=F.dtype, device=F.device)
    p2 = torch.sum(A ** 2, dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=1e-30))
    B = A / p[..., None, None]
    r = torch.clamp(_det(B) / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e1 = q + 2.0 * p * torch.cos(phi)
    e3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e2 = 3.0 * q - e1 - e3
    eigs = torch.stack([e1, e2, e3], dim=-1)
    degenerate = (p2 < 1e-24)[..., None]
    eigs = torch.where(degenerate, q[..., None], eigs)
    return torch.sqrt(torch.clamp(eigs, min=0.0))


def _sv(F: torch.Tensor) -> torch.Tensor:
    if F.shape[-1] == 2:
        return _sv_2x2(F)
    if F.shape[-1] == 3:
        return _sv_3x3(F)
    return torch.linalg.svdvals(F)


class SingularValues(torch.autograd.Function):
    """Singular values of (..., d, d), descending, shape (..., d); backward
    dF = U diag(g) V^T (the JAX custom JVP ds_i = u_i^T dF v_i, transposed)."""

    @staticmethod
    def forward(ctx, F):
        ctx.save_for_backward(F)
        return _sv(F)

    @staticmethod
    def backward(ctx, g):
        (F,) = ctx.saved_tensors
        U, _, Vh = torch.linalg.svd(F, full_matrices=False)
        return torch.einsum("...ai,...i,...ib->...ab", U, g, Vh)


def singular_values(F: torch.Tensor) -> torch.Tensor:
    return SingularValues.apply(F)


def _inv_transpose(X: torch.Tensor) -> torch.Tensor:
    """Inverse-transpose of (..., d, d) for d in {2, 3} from the adjugate;
    a determinant below 1e-20 is replaced by 1e-20, as in the JAX
    package."""
    d = X.shape[-1]
    det = _det(X)[..., None, None]
    if d == 2:
        a, b = X[..., 0, 0], X[..., 0, 1]
        c, e = X[..., 1, 0], X[..., 1, 1]
        adj_t = torch.stack([torch.stack([e, -c], -1),
                             torch.stack([-b, a], -1)], -2)
    elif d == 3:
        c0 = torch.linalg.cross(X[..., 1, :], X[..., 2, :])
        c1 = torch.linalg.cross(X[..., 2, :], X[..., 0, :])
        c2 = torch.linalg.cross(X[..., 0, :], X[..., 1, :])
        adj_t = torch.stack([c0, c1, c2], dim=-2)
    else:
        return torch.linalg.inv(X).transpose(-2, -1)
    return adj_t / torch.where(det.abs() > 1e-20, det,
                               torch.full_like(det, 1e-20))


@torch.no_grad()
def polar_rotation(F: torch.Tensor, n_iters: int = 6) -> torch.Tensor:
    """Polar factor R = U V^T of (..., d, d) by Higham's Newton iteration
    X <- (X + X^-T) / 2 from F / |F|_F. A matrix whose iterate would leave
    f32 range or go non-finite (a collapsed or inverted element) keeps its
    last finite iterate, so dE/dF = 2 (F - R) stays bounded and the other
    samples' descent survives. Computed without a graph."""
    norm = torch.sqrt(torch.sum(F ** 2, dim=(-2, -1), keepdim=True))
    X = F / torch.clamp(norm, min=1e-12)
    for _ in range(n_iters):
        Xn = 0.5 * (X + _inv_transpose(X))
        ok = (torch.isfinite(Xn) & (Xn.abs() < 1e6)).all(
            dim=-1, keepdim=True).all(dim=-2, keepdim=True)
        X = torch.where(ok, Xn, X)
    return X


class NuclearNorm(torch.autograd.Function):
    """sum_i sigma_i of (..., d, d), shape (...); backward g R with R the
    polar factor."""

    @staticmethod
    def forward(ctx, F):
        ctx.save_for_backward(F)
        return torch.sum(_sv(F), dim=-1)

    @staticmethod
    def backward(ctx, g):
        (F,) = ctx.saved_tensors
        return g[..., None, None] * polar_rotation(F.detach())


def nuclear_norm(F: torch.Tensor) -> torch.Tensor:
    return NuclearNorm.apply(F)


def arap_energy(F: torch.Tensor) -> torch.Tensor:
    """sum over the batch of sum_i (sigma_i - 1)^2 = |F|_F^2 - 2 nuclear(F)
    + d; dE/dF = 2 (F - R)."""
    d = F.shape[-1]
    fro2 = torch.sum(F ** 2, dim=(-2, -1))
    return torch.sum(fro2 - 2.0 * nuclear_norm(F) + d)


def volume_energy(F: torch.Tensor) -> torch.Tensor:
    """sum over the batch of (prod_i sigma_i - 1)^2 = (|det F| - 1)^2."""
    return torch.sum((_det(F).abs() - 1.0) ** 2)
