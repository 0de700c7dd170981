"""PyTorch port, `ops/diff.has_nan` against the JAX package's on parameter
trees (a list of (W, b) layers and a nested dict) with and without a NaN."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insr_pde_tpu.ops.diff import has_nan as jhas_nan
from insr_pde_tpu_torch.ops.diff import has_nan


def _trees(nan: bool):
    rng = np.random.default_rng(0)
    layers = [(rng.normal(size=(2, 3)).astype(np.float32),
               rng.normal(size=3).astype(np.float32)) for _ in range(2)]
    nested = {"tables": [rng.normal(size=(4, 2)).astype(np.float32)],
              "head": layers}
    if nan:
        layers[1][1][2] = np.nan
    return [layers, nested]


@pytest.mark.parametrize("nan", [False, True])
def test_has_nan_matches_jax(nan):
    for tree in _trees(nan):
        jres = bool(jhas_nan(_map(tree, jnp.asarray)))
        tres = has_nan(_map(tree, torch.from_numpy))
        assert tres.dtype == torch.bool and tres.shape == ()
        assert bool(tres) == jres == nan


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)
