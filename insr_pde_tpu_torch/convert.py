"""Parameters between the JAX package and the port.

Both keep a network's parameters as a list of `(W (in, out), b (out,))`
float32 arrays, so conversion is a copy with no transposes. These take and
return numpy arrays: the port never imports JAX, and a caller holding JAX
arrays passes `np.asarray` of them.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


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
