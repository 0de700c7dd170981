"""Checkpoint / resume (counterpart of `insr_pde_tpu/utils/ckpt.py`).

The same `.npz` format: one array per parameter leaf, keyed by the path
string that `jax.tree_util.keystr` gives the leaf in the JAX package (dict
keys sorted, e.g. `['velocity'][0][0]` for the first layer's W), plus
`__meta__<name>` scalars. A checkpoint written by either package resumes in
the other.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch


def _leaves_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(keystr path, leaf) pairs in JAX's flattening order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _leaves_with_paths(tree[k], f"{prefix}[{k!r}]")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _leaves_with_paths(v, f"{prefix}[{i}]")
        return out
    return [(prefix, tree)]


def _rebuild(like, leaves: Dict[str, Any], prefix: str = ""):
    if isinstance(like, dict):
        return {k: _rebuild(like[k], leaves, f"{prefix}[{k!r}]") for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, leaves, f"{prefix}[{i}]")
                          for i, v in enumerate(like))
    return leaves[prefix]


def save_pytree(path: str, tree: Any, metadata: Dict[str, Any] | None = None):
    """Save a nested dict/list/tuple of tensors (+ scalar metadata) to .npz.
    The leaves cross to the host as one packed copy per dtype."""
    payload: Dict[str, np.ndarray] = {}
    groups: Dict[torch.dtype, list] = {}
    for k, leaf in _leaves_with_paths(tree):
        if isinstance(leaf, torch.Tensor):
            groups.setdefault(leaf.dtype, []).append((k, leaf))
        else:
            payload[k] = np.asarray(leaf)
    for tensors in groups.values():
        packed = torch.cat([t.detach().reshape(-1)
                            for _, t in tensors]).cpu().numpy()
        off = 0
        for k, t in tensors:
            payload[k] = packed[off:off + t.numel()].reshape(tuple(t.shape))
            off += t.numel()
    if metadata:
        for k, v in metadata.items():
            payload[f"__meta__{k}"] = np.asarray(v)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **payload)


def load_pytree(path: str, like: Any, device=None):
    """Restore a tree saved by save_pytree (or by the JAX package); `like`
    gives the structure and shapes. Returns (tree of tensors on `device`,
    metadata dict)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path) as data:
        meta = {k[len("__meta__"):]: data[k][()] for k in data.files
                if k.startswith("__meta__")}
        leaves = {}
        for key, leaf in _leaves_with_paths(like):
            if key not in data.files:
                raise KeyError(f"checkpoint {path} missing leaf {key}")
            arr = data[key]
            if hasattr(leaf, "shape") and tuple(leaf.shape) != arr.shape:
                raise ValueError(f"checkpoint leaf {key} shape {arr.shape} "
                                 f"!= expected {tuple(leaf.shape)}")
            leaves[key] = torch.from_numpy(np.array(arr)).to(device)
    return _rebuild(like, leaves), meta
