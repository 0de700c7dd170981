"""PyTorch port, the space-time RBF advection solve
(`models/rbf_advection.py`) against the JAX package, the port model built
from the JAX model's params and points, on a tiny configuration (3 slices,
60 + 10 points a slice, 25 sites, K 4 x 2 slices, J 4).

Tolerances: the assembly's columns equal, its values and right-hand side
to 1e-6 of the largest (the same f32 formulas; einsums summed in another
order); the solve (30 CGLS iterations, damp 0.01, no column scaling): the
residual to 1e-4 relative and the evaluated field to 1e-3 of its largest
value. f32 CGLS on this system amplifies summation-order noise from ~35
iterations on (measured: residuals 1.9e-6 apart after 30 iterations,
3.6e-3 after 40 and 3.8e-3 after 60), so the comparison stops before."""

import jax.numpy as jnp
import numpy as np
import torch

from insr_pde_tpu.models.rbf_advection import (RBFAdvectionConfig as JCfg,
                                               RBFAdvectionModel as JModel)
from insr_pde_tpu_torch.convert import rbf_params_from_jax
from insr_pde_tpu_torch.models import rbf_advection as tra
from insr_pde_tpu_torch.ops import block_ell

torch.set_num_threads(1)

TINY = dict(velocity=(0.5, 0.0), time_num=3, collocation_pts_num=60,
            boundary_num=10, n_spatial_basis=25, n_feat=4, neighbor_k=4,
            band_width=1.0, cgls_maxiter=30)


def jbump(x):
    return jnp.exp(-jnp.sum((x - jnp.asarray([-0.4, 0.0])) ** 2, axis=-1)
                   / (2 * 0.2 ** 2))


def tbump(x):
    c = torch.tensor([-0.4, 0.0], device=x.device)
    return torch.exp(-torch.sum((x - c) ** 2, dim=-1) / (2 * 0.2 ** 2))


def _pair(**over):
    kw = {**TINY, **over}
    jm = JModel(JCfg(**kw), jbump)
    pts = tra.AdvectionPoints(torch.tensor(np.asarray(jm.pts.x)),
                              torch.tensor(np.asarray(jm.pts.t)),
                              jm.pts.inner, jm.pts.inflow, jm.pts.init)
    tm = tra.RBFAdvectionModel(
        tra.RBFAdvectionConfig(**kw), tbump, device="cpu",
        params=rbf_params_from_jax([np.asarray(a) for a in jm.params]),
        points=pts)
    return jm, tm


def test_config_defaults_match_jax():
    assert tra.RBFAdvectionConfig().__dict__ == JCfg().__dict__


def test_assemble_matches_jax():
    jm, tm = _pair()
    JA, jb = jm.assemble()
    A, b = tm.assemble()
    assert A.n_blocks == JA.n_cols and A.bdim == 1
    np.testing.assert_array_equal(A.cols.numpy(), np.asarray(JA.cols))
    jvals = np.asarray(JA.vals)
    np.testing.assert_allclose(A.vals[..., 0].numpy(), jvals, rtol=0,
                               atol=1e-6 * np.abs(jvals).max())
    jb = np.asarray(jb)
    np.testing.assert_allclose(b.numpy(), jb, rtol=0,
                               atol=1e-6 * np.abs(jb).max())


def test_solve_and_evaluate_match_jax():
    jm, tm = _pair()
    jres, res = jm.solve(), tm.solve()
    assert np.isfinite(res) and tm.info["niter"] == 30
    np.testing.assert_allclose(res, jres, rtol=1e-4)
    g = np.linspace(-0.9, 0.9, 9, dtype=np.float32)
    grid = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    for t in (0.0, 0.5, 1.0):
        ref = np.asarray(jm.evaluate(jnp.asarray(grid), t))
        got = tm.evaluate(torch.from_numpy(grid), t).numpy()
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-3 * np.abs(ref).max())


def test_own_points_layout_and_counts():
    """The port's own draws: the JAX package's index layout, inflow points
    on the upwind face (x = -1 for v = (0.5, 0)), random times in [0, T],
    the t = 0 slice last; the solve counts no kernel launch on the CPU."""
    cfg = tra.RBFAdvectionConfig(**TINY)
    pts = tra.build_points(cfg, torch.Generator().manual_seed(0))
    n_in, m, n0 = 180, 30, 60
    assert pts.x.shape == (n_in + m + n0, 2)
    np.testing.assert_array_equal(pts.inner, np.arange(n_in))
    np.testing.assert_array_equal(pts.inflow, np.arange(n_in, n_in + m))
    np.testing.assert_array_equal(pts.init, np.arange(n_in + m,
                                                      n_in + m + n0))
    assert (pts.x[pts.inflow, 0] + 1.0).abs().max() <= 1e-4
    assert float(pts.t.min()) >= 0.0 and float(pts.t.max()) <= 1.0
    assert not pts.t[pts.init].any()
    vert = tra.build_points(tra.RBFAdvectionConfig(**{**TINY, "velocity":
                                                      (0.0, -0.5)}),
                            torch.Generator().manual_seed(0))
    assert (vert.x[vert.inflow, 1] - 1.0).abs().max() <= 1e-4
    before = (block_ell.mv_launches, block_ell.rmv_launches)
    m = tra.RBFAdvectionModel(cfg, tbump, device="cpu")
    assert np.isfinite(m.solve())
    assert (block_ell.mv_launches, block_ell.rmv_launches) == before
