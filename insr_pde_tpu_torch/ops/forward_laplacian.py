"""Forward-Laplacian propagation for SIREN MLPs (counterpart of
`insr_pde_tpu/ops/forward_laplacian.py`).

Value, spatial Jacobian and Laplacian of the network in ONE batched forward
chain: per layer, carry (h, J = dh/dx, L = lap h) and push them through

    linear:  z = h W + b      ->  Jz = J W,          Lz = L W
    sin:     s = sin(w z)     ->  Js = w cos(w z) Jz,
                                  Ls = w cos(w z) Lz - w^2 sin(w z) sum_d Jz_d^2

Everything is (N, F)/(N, d, F) batched matmuls and elementwise ops. The
parameter gradient of a loss built on these outputs is ordinary first-order
autograd through the chain; no `create_graph` nesting.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

OMEGA_0 = 30.0

Params = List[Tuple[torch.Tensor, torch.Tensor]]


def value_grad_laplacian(params: Params, coords: torch.Tensor,
                         omega: float = OMEGA_0):
    """(u (N, m), J (N, d, m), L (N, m)) of a sine MLP at (N, d) coords."""
    n, d = coords.shape
    h = coords
    J = torch.eye(d, dtype=coords.dtype, device=coords.device).expand(n, d, d)
    L = coords.new_zeros((n, d))
    n_layers = len(params)
    for i, (w, b) in enumerate(params):
        z = h @ w + b
        Jz = J @ w
        Lz = L @ w
        if i < n_layers - 1:
            c = torch.cos(omega * z)
            s = torch.sin(omega * z)
            h = s
            J = omega * c[:, None, :] * Jz
            L = omega * c * Lz - (omega ** 2) * s * torch.sum(Jz ** 2, dim=1)
        else:
            h, J, L = z, Jz, Lz
    return h, J, L


def value_grad(params: Params, coords: torch.Tensor, omega: float = OMEGA_0):
    """(u (N, m), J (N, d, m)): the first-order half of the chain."""
    n, d = coords.shape
    h = coords
    J = torch.eye(d, dtype=coords.dtype, device=coords.device).expand(n, d, d)
    n_layers = len(params)
    for i, (w, b) in enumerate(params):
        z = h @ w + b
        Jz = J @ w
        if i < n_layers - 1:
            c = torch.cos(omega * z)
            h = torch.sin(omega * z)
            J = omega * c[:, None, :] * Jz
        else:
            h, J = z, Jz
    return h, J
