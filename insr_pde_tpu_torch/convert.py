"""Parameters between the JAX package and the port.

Both keep a SIREN's parameters as a list of `(W (in, out), b (out,))`
float32 arrays, a hash grid's as `{"tables": [(size, F), ...], "head":
[(W, b), ...]}`, and the vortex model's RBF parameters and points in the
same layouts, so conversion is a copy with no transposes. These take numpy
(or array-like) leaves and return tensors, or the reverse: the port never
imports JAX, and a caller holding JAX arrays passes them as they are
(`np.asarray` reads them).
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


def hashgrid_params_from_jax(params, device=None):
    """A `HashGridField`'s {"tables": [...], "head": [(W, b), ...]} of numpy
    (or array-like) leaves -> the same tree of float32 tensors."""
    return {"tables": [torch.tensor(np.asarray(t), dtype=torch.float32,
                                    device=device)
                       for t in params["tables"]],
            "head": params_from_jax(params["head"], device)}


def hashgrid_params_to_numpy(params):
    """A `HashGridField`'s tree of tensors -> float32 numpy leaves."""
    return {"tables": [t.detach().cpu().numpy() for t in params["tables"]],
            "head": params_to_numpy(params["head"])}


def fields_from_jax(fields: Dict[str, Sequence], device=None) -> Dict:
    """A model's whole `fields` dict (name -> [(W, b), ...], or a hash
    grid's tree)."""
    return {name: (hashgrid_params_from_jax(p, device)
                   if isinstance(p, dict) else params_from_jax(p, device))
            for name, p in fields.items()}


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
