"""Differential operators through `torch.func` (counterpart of
`insr_pde_tpu/ops/diff.py`).

Every operator takes a function mapping ONE point (d,) -> (m,) and a batch of
points (N, d); `jacfwd`/`vjp` compose per point and `vmap` batches them.
Input dims are tiny (1-3), so forward mode is the default, and laplace is
forward-over-reverse. `has_nan` is the debug check of a parameter tree.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.func import jacfwd, vjp, vmap

Fn = Callable[[torch.Tensor], torch.Tensor]  # (d,) -> (m,)


def _trace(m: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(m, dim1=-2, dim2=-1).sum(-1)


def gradient(fn: Fn, x: torch.Tensor) -> torch.Tensor:
    """VJP of `fn` with an all-ones cotangent: sum_i grad f_i, shape (N, d)
    (the spatial gradient for a scalar field)."""
    def pull(xi):
        y, f_vjp = vjp(fn, xi)
        (g,) = f_vjp(torch.ones_like(y))
        return g
    return vmap(pull)(x)


def jacobian(fn: Fn, x: torch.Tensor) -> torch.Tensor:
    """Batched Jacobian, shape (N, m, d)."""
    return vmap(jacfwd(fn))(x)


def divergence(fn: Fn, x: torch.Tensor) -> torch.Tensor:
    """Sum_i d f_i / d x_i, shape (N, 1). Requires m == d."""
    def div(xi):
        return _trace(jacfwd(fn)(xi))[None]
    return vmap(div)(x)


def laplace(fn: Fn, x: torch.Tensor, normalize: bool = False,
            eps: float = 0.0, return_grad: bool = False):
    """div(grad f) of a scalar field, shape (N, 1). With normalize=True the
    gradient is normalized before taking the divergence."""
    def grad_fn(xi):
        y, f_vjp = vjp(fn, xi)
        (g,) = f_vjp(torch.ones_like(y))
        if normalize:
            g = g / (torch.linalg.norm(g) + eps)
        return g

    def lap(xi):
        return _trace(jacfwd(grad_fn)(xi))[None]

    out = vmap(lap)(x)
    if return_grad:
        return out, vmap(grad_fn)(x)
    return out


def hessian(fn: Fn, x: torch.Tensor) -> torch.Tensor:
    """Batched Hessian of each output channel, shape (N, m, d, d)."""
    return vmap(jacfwd(jacfwd(fn)))(x)


def has_nan(tree) -> torch.Tensor:
    """Whether any tensor of a parameter tree (nested lists, tuples and
    dicts of tensors) holds a NaN: a scalar bool tensor, the debug check of
    the JAX package's `has_nan`."""
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        else:
            leaves.append(torch.isnan(t).any())

    walk(tree)
    return torch.stack(leaves).any()
