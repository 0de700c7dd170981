"""PyTorch port, the coordinate encodings (`models/encodings.py`) and the
hash-grid network (`models/networks.HashGridField`) against the JAX
package, on the same numpy inputs and tables.

Tolerances: the hash is bit-equal (negative corners and every dim up to 3
included), and so are the level specs; the encodings and the network's
value and Jacobian agree to 1e-6 (absolute, on values of order 1e-4 to 1:
the same f32 products summed in another order), the gradients of a loss
with respect to the tables and the head to 1e-5 of the largest entry."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insr_pde_tpu.config import Config as JConfig
from insr_pde_tpu.models import encodings as je
from insr_pde_tpu.models import networks as jn
from insr_pde_tpu_torch.config import Config
from insr_pde_tpu_torch.convert import (hashgrid_params_from_jax,
                                        hashgrid_params_to_numpy)
from insr_pde_tpu_torch.models import encodings as te
from insr_pde_tpu_torch.models.networks import HashGridField, get_network
from insr_pde_tpu_torch.models.solver import ravel, unravel

torch.set_num_threads(1)


@pytest.mark.parametrize("dim", [1, 2, 3])
@pytest.mark.parametrize("size", [97, 2 ** 15, 2 ** 19])
def test_fast_hash_is_bit_equal(dim, size):
    """Corners from -3e5 to 3e5 (negative ones wrap as uint32) and near
    +-2^31, and the level sizes of the grids (a res^dim table or 2^15)."""
    rng = np.random.default_rng(dim * size)
    inds = rng.integers(-300000, 300000, size=(4000, dim)).astype(np.int32)
    edge = np.array([[2 ** 31 - 1] * dim, [-2 ** 31] * dim, [-1] * dim,
                     [0] * dim], np.int32)
    inds = np.concatenate([inds, edge])
    ref = np.asarray(je._fast_hash(jnp.asarray(inds), dim, size))
    got = te._fast_hash(torch.from_numpy(inds), dim, size)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))


@pytest.mark.parametrize("kw", [dict(dim=1, n_levels=8, base_resolution=8,
                                     finest_resolution=256),
                                dict(dim=2), dict(dim=3, n_levels=4),
                                dict(dim=2, n_levels=1)])
def test_level_specs_equal(kw):
    assert (te.MultiResHashGrid(**kw).level_specs
            == je.MultiResHashGrid(**kw).level_specs)
    assert (te.MultiResHashGrid(**kw).output_dim
            == je.MultiResHashGrid(**kw).output_dim)


def test_frequency_matches_jax():
    x = np.random.default_rng(0).uniform(-1, 1, (50, 3)).astype(np.float32)
    ref = np.asarray(je.Frequency(3, 6).apply(jnp.asarray(x)))
    got = te.Frequency(3, 6).apply(torch.from_numpy(x))
    assert te.Frequency(3, 6).output_dim == je.Frequency(3, 6).output_dim
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("dim", [2, 3])
def test_multires_hash_grid_matches_jax(dim):
    """Points inside [0, 1] and a few outside (negative corners)."""
    enc = dict(dim=dim, n_levels=6, log2_hashmap_size=10,
               base_resolution=4, finest_resolution=64)
    jgrid = je.MultiResHashGrid(**enc)
    tables = jgrid.init(jax.random.PRNGKey(1))
    # table entries of order 1, so that interpolation errors would show
    tables = [t * 1e4 for t in tables]
    x = np.random.default_rng(2).uniform(-0.2, 1.2, (300, dim)).astype(
        np.float32)
    ref = np.asarray(jgrid.apply(tables, jnp.asarray(x)))
    got = te.MultiResHashGrid(**enc).apply(
        [torch.from_numpy(np.array(t)) for t in tables], torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6 * max(
        1.0, np.abs(ref).max()))


def _field_pair(in_features, out_features, scale=1e4):
    jnet = jn.HashGridField(in_features, out_features, num_hidden_layers=2,
                            hidden_features=16, n_levels=6,
                            log2_hashmap_size=10, base_resolution=4,
                            finest_resolution=64)
    tnet = HashGridField(in_features, out_features, num_hidden_layers=2,
                         hidden_features=16, n_levels=6,
                         log2_hashmap_size=10, base_resolution=4,
                         finest_resolution=64)
    jp = jnet.init(jax.random.PRNGKey(3))
    jp = {"tables": [t * scale for t in jp["tables"]], "head": jp["head"]}
    return jnet, tnet, jp, hashgrid_params_from_jax(jp)


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_hash_grid_field_apply_and_value_grad_match_jax(dim):
    jnet, tnet, jp, tp = _field_pair(dim, 2)
    x = np.random.default_rng(4).uniform(-1, 1, (200, dim)).astype(
        np.float32)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    ref = np.asarray(jnet.apply(jp, xj))
    scale = max(1.0, np.abs(ref).max())
    np.testing.assert_allclose(tnet.apply(tp, xt).numpy(), ref, rtol=0,
                               atol=1e-6 * scale)
    assert torch.equal(tnet.apply_fused(tp, xt), tnet.apply(tp, xt))
    ju, jJ = (np.asarray(a) for a in jnet.value_grad(jp, xj))
    u, J = tnet.value_grad(tp, xt)
    assert J.shape == jJ.shape == (200, dim, 2)
    np.testing.assert_allclose(u.numpy(), ju, rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(J.numpy(), jJ, rtol=0,
                               atol=1e-6 * max(1.0, np.abs(jJ).max()))
    assert not tnet.second_order_ok and not tnet._is_siren


def test_hash_grid_field_gradients_match_jax():
    """d/d(params) of mean(u^2) + mean(J^2): the table gathers' scatter
    and the head, against jax.grad."""
    jnet, tnet, jp, tp = _field_pair(2, 1)
    x = np.random.default_rng(5).uniform(-1, 1, (256, 2)).astype(np.float32)

    def jloss(p):
        u, J = jnet.value_grad(p, jnp.asarray(x))
        return jnp.mean(u ** 2) + jnp.mean(J ** 2)

    jg = jax.grad(jloss)(jp)
    flat, spec = ravel(tp)
    flat = flat.requires_grad_(True)
    u, J = tnet.value_grad(unravel(flat, spec), torch.from_numpy(x))
    (torch.mean(u ** 2) + torch.mean(J ** 2)).backward()
    got = unravel(flat.grad, spec)
    pairs = list(zip(jg["tables"], got["tables"]))
    pairs += [(a, b) for jwb, twb in zip(jg["head"], got["head"])
              for a, b in zip(jwb, twb)]
    scale = max(float(np.abs(np.asarray(a)).max()) for a, _ in pairs)
    for a, b in pairs:
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-5 * scale)


def test_init_layout_and_round_trip():
    """The port's init draws the JAX tree's shapes: U[-1e-4, 1e-4] tables
    and a relu head; conversion to numpy and back is exact."""
    jnet, tnet, jp, _ = _field_pair(2, 3)
    p = tnet.init(torch.Generator().manual_seed(0))
    assert [tuple(t.shape) for t in p["tables"]] == [
        tuple(t.shape) for t in jp["tables"]]
    assert [tuple(w.shape) for w, _ in p["head"]] == [
        tuple(w.shape) for w, _ in jp["head"]]
    assert all(float(t.abs().max()) <= 1e-4 for t in p["tables"])
    back = hashgrid_params_from_jax(hashgrid_params_to_numpy(p))
    assert all(torch.equal(a, b) for a, b in zip(back["tables"],
                                                 p["tables"]))


def test_get_network_builds_the_same_hash_grid():
    for name in ("hashgrid", "grid"):
        kw = dict(network=name, num_hidden_layers=2, hidden_features=20)
        net = get_network(Config(**kw), 1, 1)
        jnet = jn.get_network(JConfig(**kw), 1, 1)
        assert isinstance(net, HashGridField)
        for f in ("in_features", "out_features", "num_hidden_layers",
                  "hidden_features", "n_levels", "n_features_per_level",
                  "log2_hashmap_size", "base_resolution",
                  "finest_resolution"):
            assert getattr(net, f) == getattr(jnet, f), f
