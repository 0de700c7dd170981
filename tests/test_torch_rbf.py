"""PyTorch port, the random-basis ansatz (`models/rbf.py`, `ops/knn.py`)
against the JAX package on the same params and points (numpy).

Tolerance: rtol 1e-5 with atol 1e-5 of each field's largest magnitude: the
same f32 formulas, summed in another order where einsums contract. KNN
indices must be equal: the points are random (no equidistant sites) or on
the slice times, where the stable sort keeps XLA's lower-index-first order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insr_pde_tpu.models import rbf as jrbf
from insr_pde_tpu.ops.knn import knn as jknn
from insr_pde_tpu_torch.convert import (rbf_params_from_jax,
                                        rbf_params_to_numpy)
from insr_pde_tpu_torch.models import rbf
from insr_pde_tpu_torch.ops.knn import knn

torch.set_num_threads(1)


def _close(got, ref, rtol=1e-5, atol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-30) if ref.size else 1.0
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol * scale)


def _configs(**kw):
    base = dict(dim=2, n_vars=3, n_feat=4, n_spatial_basis=25, time_num=3,
                band_width=2.0, neighbor_k=4, seed=0)
    base.update(kw)
    return jrbf.RBFConfig(**base), rbf.RBFConfig(**base)


def _points(q=40, seed=1, slice_times=3):
    """Random points, a third of them exactly on the slice times."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (q, 2)).astype(np.float32)
    t = rng.uniform(0, 1, q).astype(np.float32)
    t[::3] = np.asarray(jnp.linspace(0.0, 1.0, slice_times))[
        rng.integers(0, slice_times, len(t[::3]))]
    return x, t


@pytest.fixture(scope="module")
def params():
    jcfg, _ = _configs(poly=2)
    jp = jrbf.init_rbf(jcfg, jax.random.PRNGKey(0))
    return jp, rbf_params_from_jax([np.asarray(a) for a in jp])


def test_init_rbf_sites_are_bit_exact():
    for kw in (dict(), dict(n_spatial_basis=400, time_num=10, poly=1)):
        jcfg, cfg = _configs(**kw)
        jp = jrbf.init_rbf(jcfg, jax.random.PRNGKey(0))
        p = rbf.init_rbf(cfg, torch.Generator().manual_seed(0))
        assert torch.equal(p.centers, torch.from_numpy(np.array(jp.centers)))
        assert torch.equal(p.times, torch.from_numpy(np.array(jp.times)))
        for a, b in zip(p, jp):
            assert tuple(a.shape) == b.shape and a.dtype == torch.float32
        assert cfg.n_coeffs == jcfg.n_coeffs == p.u.numel()
        # the JAX params through the port and back, unchanged
        back = jrbf.RBFParams(*rbf_params_to_numpy(
            rbf_params_from_jax([np.asarray(a) for a in jp])))
        for a, b in zip(back, jp):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_knn_matches_jax():
    rng = np.random.default_rng(2)
    q = rng.normal(size=(50, 3)).astype(np.float32)
    p = rng.normal(size=(200, 3)).astype(np.float32)
    jd, ji = jknn(jnp.asarray(q), jnp.asarray(p), 7)
    d, i = knn(torch.from_numpy(q), torch.from_numpy(p), 7)
    assert i.dtype == torch.int64
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    _close(d, jd)
    # equidistant sites: the lower index first, as XLA's top_k
    sites = torch.tensor([[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0], [0.0, -1.0]])
    _, i = knn(torch.zeros((1, 2)), sites, 2)
    assert i.tolist() == [[0, 1]]


# (space PoU, time PoU, second, pou_normalize, poly)
CASES = [("simple", "simple", False, False, 0),
         ("simple", "simple", True, False, 1),
         ("hat", "hat", True, False, 0),
         ("hat", "simple", False, False, 1),
         ("smooth", "simple", True, True, 0),
         ("smooth", "smooth", True, True, 2),
         ("smooth2", "smooth2", True, False, 0)]


@pytest.mark.parametrize("space,time,second,normalize,poly", CASES)
def test_point_basis_matches_jax(space, time, second, normalize, poly):
    """Every field of the PointBasis and every column builder / evaluator;
    space-time KNN for the indicator PoU, the structured windows else."""
    jcfg, cfg = _configs(poly=poly, pou_normalize=normalize,
                         pou_width=0.4 if space != "simple" else 0.0)
    jp = jrbf.init_rbf(jcfg, jax.random.PRNGKey(3))
    p = rbf_params_from_jax([np.asarray(a) for a in jp])
    x, t = _points()
    jx, jt, tx, tt = jnp.asarray(x), jnp.asarray(t), torch.from_numpy(x), \
        torch.from_numpy(t)
    if space == "simple":
        jidx = idx = None
    else:
        jidx = jrbf.structured_spacetime_idx(jcfg, jp, jx, jt, 2)
        idx = rbf.structured_spacetime_idx(cfg, p, tx, tt, 2)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    jpb = jrbf.point_basis(jcfg, jp, jx, jt, idx=jidx, time_pou=time,
                           space_pou=space, second=second)
    pb = rbf.point_basis(cfg, p, tx, tt, idx=idx, time_pou=time,
                         space_pou=space, second=second)
    for name in jrbf.PointBasis._fields:
        ref = getattr(jpb, name)
        got = getattr(pb, name)
        assert (ref is None) == (got is None), name
        if name == "idx":
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        elif ref is not None:
            _close(got, ref)
    for fn in ("basis_val", "basis_dx", "basis_dt", "basis_dxx_diag"):
        _close(getattr(rbf, fn)(pb), getattr(jrbf, fn)(jpb))
    for fn in ("field_value", "field_grad", "field_dt", "field_lap"):
        _close(getattr(rbf, fn)(pb, p.u), getattr(jrbf, fn)(jpb, jp.u))
    if second:
        _close(rbf.basis_hess(pb), jrbf.basis_hess(jpb))
        _close(rbf.basis_dxdt(pb), jrbf.basis_dxdt(jpb))
        _close(rbf.field_hess(pb, p.u), jrbf.field_hess(jpb, jp.u))
        _close(rbf.field_dxdt(pb, p.u), jrbf.field_dxdt(jpb, jp.u))


@pytest.mark.parametrize("window", [1, 2, 3])
def test_structured_spacetime_idx_and_block_ids(params, window):
    jcfg, cfg = _configs(poly=2)
    jp, p = params
    x, t = _points(60, seed=4)
    # the last slice's time and points past it clamp the window start
    t[:5] = 1.0
    jidx = jrbf.structured_spacetime_idx(jcfg, jp, jnp.asarray(x),
                                         jnp.asarray(t), window)
    idx = rbf.structured_spacetime_idx(cfg, p, torch.from_numpy(x),
                                       torch.from_numpy(t), window)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    for var in range(3):
        np.testing.assert_array_equal(
            rbf.block_ids(cfg, idx, var).numpy(),
            np.asarray(jrbf.block_ids(jcfg, jidx, var)))
        np.testing.assert_array_equal(
            rbf.column_ids(cfg, idx, var).numpy(),
            np.asarray(jrbf.column_ids(jcfg, jidx, var)))
    np.testing.assert_array_equal(
        rbf.spatial_knn_idx(cfg, p, torch.from_numpy(x)).numpy(),
        np.asarray(jrbf.spatial_knn_idx(jcfg, jp, jnp.asarray(x))))


def test_pou_families_match_jax():
    x = np.linspace(-1.5, 1.5, 301).astype(np.float32)
    for fn in ("pou_simple", "pou_sine", "pou_hat", "pou_hat_grad",
               "pou_smooth", "pou_smooth_grad", "pou_smooth_hess",
               "pou_smooth2", "pou_smooth2_grad", "pou_smooth2_hess"):
        _close(getattr(rbf, fn)(torch.from_numpy(x)),
               getattr(jrbf, fn)(jnp.asarray(x)))


def test_point_basis_dense_matches_jax(params):
    jcfg, cfg = _configs(poly=2)
    jp, p = params
    x, t = _points(6, seed=5)
    jpb = jrbf.point_basis_dense(jcfg, jp, jnp.asarray(x), jnp.asarray(t))
    pb = rbf.point_basis_dense(cfg, p, torch.from_numpy(x),
                               torch.from_numpy(t))
    _close(rbf.field_value(pb, p.u), jrbf.field_value(jpb, jp.u))
