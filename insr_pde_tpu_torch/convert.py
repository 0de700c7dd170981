"""Parameters between the JAX package and the port.

Both keep a network's parameters as a list of `(W (in, out), b (out,))`
float32 arrays, and the vortex model's RBF parameters and points in the
same layouts, so conversion is a copy with no transposes. These take and
return numpy arrays: the port never imports JAX, and a caller holding JAX
arrays passes `np.asarray` of them.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .models.rbf import RBFParams
from .models.vortex import SpaceTimePoints


def params_from_jax(params: Sequence[Tuple[np.ndarray, np.ndarray]],
                    device=None) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """[(W, b), ...] numpy (or array-like) -> float32 tensors on `device`."""
    return [(torch.tensor(np.asarray(w), dtype=torch.float32, device=device),
             torch.tensor(np.asarray(b), dtype=torch.float32, device=device))
            for w, b in params]


def params_to_numpy(params) -> List[Tuple[np.ndarray, np.ndarray]]:
    """[(W, b), ...] tensors -> float32 numpy arrays on the host."""
    return [(w.detach().cpu().numpy(), b.detach().cpu().numpy())
            for w, b in params]


def fields_from_jax(fields: Dict[str, Sequence], device=None
                    ) -> Dict[str, List[Tuple[torch.Tensor, torch.Tensor]]]:
    """A model's whole `fields` dict (name -> [(W, b), ...])."""
    return {name: params_from_jax(p, device) for name, p in fields.items()}


def rbf_params_from_jax(params, device=None):
    """The JAX package's `RBFParams` (centers, times, A, tA, bias, u; numpy
    or array-like) -> the port's `RBFParams` of float32 tensors. The layouts
    are the same, so there is no transpose."""
    return RBFParams(*(torch.tensor(np.asarray(a), dtype=torch.float32,
                                    device=device) for a in params))


def rbf_params_to_numpy(params):
    """The port's `RBFParams` -> a tuple of six float32 numpy arrays in the
    order of the JAX package's `RBFParams` (which `RBFParams(*out)`
    rebuilds)."""
    return tuple(t.detach().cpu().numpy() for t in params)


def points_from_jax(pts, device=None):
    """The JAX package's vortex `SpaceTimePoints` -> the port's: the point
    coordinates, times and wall normals as float32 tensors, the index sets
    as int64 numpy arrays."""
    f32 = [torch.tensor(np.asarray(a), dtype=torch.float32, device=device)
           for a in (pts.x, pts.t, pts.norm)]
    ids = [np.asarray(a, dtype=np.int64) for a in
           (pts.inner, pts.neu, pts.dirp, pts.left, pts.init)]
    return SpaceTimePoints(*f32, *ids)
