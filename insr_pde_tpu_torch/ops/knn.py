"""K-nearest-neighbor search as one matmul + top-k (counterpart of
`insr_pde_tpu/ops/knn.py`).

At the sizes the RBF solver uses (up to 10^4 basis sites), the brute-force
squared-distance matrix |q|^2 + |p|^2 - 2 q.p^T is one f32 matmul (TF32 is
off: `ops/precision.set_full_precision`). The nearest are taken by a stable
sort, so that equal distances keep the lower index first, as XLA's top_k
does: on the grids the solver samples, a query's K-th and (K+1)-th sites
are often mirror images at exactly the same f32 distance. Distances that
differ only by rounding between the two packages can still order
differently.
"""

from __future__ import annotations

import torch


def knn(query: torch.Tensor, points: torch.Tensor, k: int):
    """K nearest `points` (P, d) of each `query` row (Q, d): (squared
    distances (Q, k) ascending, clamped at 0; indices (Q, k) int64)."""
    q2 = torch.sum(query * query, dim=-1, keepdim=True)      # (Q, 1)
    p2 = torch.sum(points * points, dim=-1)[None, :]         # (1, P)
    d2 = q2 + p2 - 2.0 * (query @ points.T)
    d2, idx = torch.sort(d2, dim=1, stable=True)
    return torch.clamp(d2[:, :k], min=0.0), idx[:, :k]
