"""PyTorch port, the vortex least-squares model (`models/vortex.py`) against
the JAX package, port models built from the JAX model's params and points
(`convert.rbf_params_from_jax`, `convert.points_from_jax`), on the tiny
configs of tests/test_vortex.py: the velocity formulation (indicator PoU,
space-time KNN, Jacobi CGLS) and the stream formulation of the channel
preset (smooth space PoU, indicator time PoU, Shepard normalization, value
+ derivative BC rows, block-whitened chunked CGLS with restarts, whitener
reuse and warm starts).

Tolerances:
* assembly: cols equal; vals and rhs rtol 1e-5 with atol 5e-6 of the
  largest |val|: the same f32 formulas, einsums summed in another order,
  and the momentum rows' rho (convection + d/dt) sums cancel (measured
  6e-6 of the largest on one of 23,648 values of the stream system);
* the sampled field from the same coefficients: 1e-5 of its largest value;
* `matrix_solver` (2 Picard iterations, 60 CGLS iterations each): the
  residual to 2e-3 relative and the sampled field to 1e-2 relative (L2).
  f32 CGLS on these systems amplifies summation-order noise (measured: the
  two packages' fields differ by 3.5e-3 and 4.2e-3 here, by 1.1e-2 after
  400 iterations of the velocity solve);
* relative_divergence and inlet_error of the same field: 1e-4 relative.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from insr_pde_tpu.models import vortex as jv
from insr_pde_tpu_torch.convert import points_from_jax, rbf_params_from_jax
from insr_pde_tpu_torch.models import vortex as tv
from insr_pde_tpu_torch.utils import viz
from tools.vortex_truth import inlet_error as j_inlet_error

torch.set_num_threads(1)

BASE = dict(collocation_pts_num=64, boundary_num=32, time_num=3,
            n_spatial_basis=25, n_feat=4, neighbor_k=4, internal_v=1.0,
            rho=1.0, cgls_maxiter=60, picard_iters=2, vis_resolution=16,
            seed=3)
KINDS = {
    "velocity": (dict(band_width=2.0), jv.VortexModel, tv.VortexModel),
    "stream": (dict(band_width=1.0, pou="smooth", pou_time="simple",
                    time_window=1, stream_bc="both", w_bc=5.0,
                    pou_normalize=True, cgls_precondition="block",
                    cgls_chunk=12, cgls_restart=True, reuse_whitener=True,
                    warm_start=1.0),
               jv.StreamVortexModel, tv.StreamVortexModel),
}


def _pair(kind, **over):
    kw, jcls, tcls = KINDS[kind]
    kw = {**BASE, **kw, **over}
    jm = jcls(jv.VortexConfig(**kw), log=False)
    tm = tcls(tv.VortexConfig(**kw), log=False, device="cpu",
              params=rbf_params_from_jax([np.asarray(a) for a in jm.params]),
              points=points_from_jax(jm.pts))
    return jm, tm


@pytest.fixture(scope="module")
def pairs():
    return {kind: _pair(kind) for kind in KINDS}


def _rel(got, ref):
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def test_build_points_layout():
    cfg = tv.VortexConfig(collocation_pts_num=10, boundary_num=8, time_num=3)
    pts = tv.build_points(cfg, torch.Generator().manual_seed(0))
    jpts = jv.build_points(jv.VortexConfig(collocation_pts_num=10,
                                           boundary_num=8, time_num=3),
                           jax.random.PRNGKey(0))
    assert pts.x.shape == (3 * 18, 2) and pts.t.shape == (54,)
    for name in ("inner", "neu", "dirp", "left", "init"):
        np.testing.assert_array_equal(getattr(pts, name),
                                      np.asarray(getattr(jpts, name)))
    np.testing.assert_array_equal(pts.norm.numpy(), np.asarray(jpts.norm))
    np.testing.assert_array_equal(pts.t.numpy(), np.asarray(jpts.t))
    # inlet points on x = -1, outlet on x = +1, walls on y = -1 / +1
    assert (pts.x[pts.left, 0] + 1.0).abs().max() < 1e-3
    assert (pts.x[pts.dirp, 0] - 1.0).abs().max() < 1e-3
    assert ((pts.x[pts.neu, 1].abs() - 1.0).abs() < 1e-3).all()
    assert (pts.x[:10].abs() <= 1.0).all()


@pytest.mark.parametrize("kind", list(KINDS))
def test_assemble_matches_jax(pairs, kind):
    jm, tm = pairs[kind]
    rng = np.random.default_rng(0)
    u = rng.normal(size=jm.params.u.shape).astype(np.float32)
    JA, jb = jm.assemble(jax.numpy.asarray(u))
    A, b = tm.assemble(torch.from_numpy(u))
    assert A.cols.dtype == torch.int32 and A.n_blocks == int(JA[-1])
    np.testing.assert_array_equal(A.cols.numpy(), np.asarray(JA.cols))
    jvals = np.asarray(JA.vals)
    np.testing.assert_allclose(A.vals.numpy(), jvals, rtol=1e-5,
                               atol=5e-6 * np.abs(jvals).max())
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-5,
                               atol=5e-6 * np.abs(np.asarray(jb)).max())
    # the layout map tiles the rows; padded slots carry zeros
    counts = tm.block_names_counts()
    assert counts == [tuple(c) for c in jm.block_names_counts()]
    assert sum(n for _, n in counts) == b.shape[0]
    slots = A.row_slots.numpy()
    S = A.cols.shape[1]
    assert set(slots.tolist()) == {S // 2, S}
    pad = np.arange(S)[None, :] >= slots[:, None]
    assert not A.vals.numpy()[pad].any() and not A.cols.numpy()[pad].any()


@pytest.mark.parametrize("kind", list(KINDS))
def test_sample_field_of_same_coefficients_matches_jax(pairs, kind):
    jm, tm = pairs[kind]
    tm.params = tm.params._replace(u=torch.from_numpy(np.array(jm.params.u)))
    jf, jg = (np.asarray(a) for a in jm.sample_field(16))
    f, g = tm.sample_field(16)
    np.testing.assert_array_equal(g.numpy(), jg)
    assert f.shape == (3, 256, 3)
    np.testing.assert_allclose(f.numpy(), jf, rtol=0,
                               atol=1e-5 * np.abs(jf).max())
    np.testing.assert_allclose(tv.relative_divergence(tm, 16),
                               jv.relative_divergence(jm, 16), rtol=1e-4)
    np.testing.assert_allclose(tv.inlet_error(tm, 16),
                               j_inlet_error(jm, 16), rtol=1e-4)


@pytest.mark.parametrize("kind", list(KINDS))
def test_matrix_solver_matches_jax(kind):
    jm, tm = _pair(kind)
    jres, res = jm.matrix_solver(), tm.matrix_solver()
    assert np.isfinite(res)
    np.testing.assert_allclose(res, jres, rtol=2e-3)
    jf = np.asarray(jm.sample_field(16)[0])
    f = tm.sample_field(16)[0].numpy()
    assert _rel(f, jf) < 1e-2
    assert [t["picard"] for t in tm.picard_timings] == [0, 1]
    assert tm._picard_seen == 2
    if kind == "stream":
        # reuse_whitener keeps the W of the first post-solve system (it=1)
        assert tm._whitener is not None
        assert all(t["whiten_s"] >= 0.0 for t in tm.picard_timings)
        # a second call reuses it
        W = tm._whitener
        tm.matrix_solver()
        assert tm._whitener is W
    # the transpose index is built once per model and kept
    assert tm._t_index is not None


def test_matrix_solver_unchunked_whitened_matches_jax():
    """cgls_chunk = 0 with the block whitener: the JAX package's long-loop
    `cgls_block_precond` branch, which the port runs as one chunked loop
    without restarts. Without restarts f32 CGLS on the stream system drifts
    apart within a few dozen iterations (tests/test_torch_linalg.py), so
    each solve stops at 8; same bars as above."""
    over = dict(cgls_chunk=0, cgls_restart=False, warm_start=0.0,
                cgls_maxiter=8)
    jm, tm = _pair("stream", **over)
    jres, res = jm.matrix_solver(), tm.matrix_solver()
    assert np.isfinite(res)
    np.testing.assert_allclose(res, jres, rtol=2e-3)
    assert _rel(tm.sample_field(16)[0].numpy(),
                np.asarray(jm.sample_field(16)[0])) < 1e-2
    assert [t["cgls_iters"] for t in tm.picard_timings] == [8, 8]
    assert tm._whitener is not None


@pytest.mark.parametrize("kind", list(KINDS))
def test_block_residuals_match_jax(pairs, kind):
    jm, tm = pairs[kind]
    u = np.random.default_rng(6).normal(
        size=jm.params.u.shape).astype(np.float32)
    jm.params = jm.params._replace(u=jax.numpy.asarray(u))
    tm.params = tm.params._replace(u=torch.from_numpy(u))
    ref, got = jm.block_residuals(), tm.block_residuals()
    assert list(got) == list(ref)
    for name, r in ref.items():
        np.testing.assert_allclose(got[name]["rms"], r["rms"], rtol=1e-4)
        np.testing.assert_allclose(got[name]["rhs_rms"], r["rhs_rms"],
                                   rtol=1e-5)


def test_write_output_and_no_matplotlib(tmp_path, pairs, monkeypatch):
    _, tm = pairs["stream"]
    tm.write_output(str(tmp_path / "a"), resolution=8)
    assert np.load(tmp_path / "a" / "field.npy").shape == (3, 64, 3)
    monkeypatch.setattr(viz, "available", lambda: False)
    with pytest.warns(UserWarning, match="matplotlib"):
        tm.write_output(str(tmp_path / "b"), resolution=8)
    assert (tmp_path / "b" / "field.npy").exists()
    assert not list((tmp_path / "b").glob("*.png"))


@pytest.mark.parametrize("kind", list(KINDS))
def test_checkpoints_cross_packages(tmp_path, pairs, kind):
    jm, tm = pairs[kind]
    rng = np.random.default_rng(5)
    u = rng.normal(size=jm.params.u.shape).astype(np.float32)
    # JAX -> port
    jm.params = jm.params._replace(u=jax.numpy.asarray(u))
    jm.save_ckpt(str(tmp_path / "j.npz"))
    meta = tm.load_ckpt(str(tmp_path / "j.npz"))
    assert str(meta["formulation"]) == kind
    np.testing.assert_array_equal(tm.params.u.numpy(), u)
    loaded = tv.load_vortex_ckpt(str(tmp_path / "j.npz"), device="cpu")
    assert type(loaded) is type(tm)
    assert dataclasses.asdict(loaded.cfg) == dataclasses.asdict(tm.cfg)
    np.testing.assert_array_equal(loaded.params.u.numpy(), u)
    # port -> JAX
    tm.params = tm.params._replace(u=torch.from_numpy(2.0 * u))
    tm.save_ckpt(str(tmp_path / "t.npz"))
    jm.load_ckpt(str(tmp_path / "t.npz"))
    np.testing.assert_array_equal(np.asarray(jm.params.u), 2.0 * u)
    jloaded = jv.load_vortex_ckpt(str(tmp_path / "t.npz"))
    assert type(jloaded).__name__ == type(tm).__name__
    assert jloaded.cfg == jm.cfg


def test_unported_options_raise(pairs):
    _, tm = pairs["velocity"]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tm.matrix_solver(solver="cg")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tm.train(1)
    for flag in ("packed_vals", "rmv_gather"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tv.VortexModel(tv.VortexConfig(**BASE, **{flag: True}),
                           log=False, device="cpu")


def test_vortex_stats_of_both_packages_field_files(tmp_path, pairs):
    """`vortex_stats` on the `field.npy` each package writes from the same
    coefficients: the inlet error of the file's grid equals the JAX
    package's `inlet_error` at that resolution (1e-4 relative), and max |u|
    the largest velocity component of the sampled field, for both files."""
    from insr_pde_tpu_torch import vortex_stats
    jm, tm = pairs["stream"]
    tm.params = tm.params._replace(u=torch.from_numpy(np.array(jm.params.u)))
    jm.write_output(str(tmp_path / "jax"), resolution=16)
    tm.write_output(str(tmp_path / "port"), resolution=16)
    jf = np.asarray(jm.sample_field(16)[0])
    for pkg in ("jax", "port"):
        stats = vortex_stats.field_stats(
            np.load(tmp_path / pkg / "field.npy"), jm.cfg.internal_v)
        assert stats["resolution"] == 16
        np.testing.assert_allclose(stats["inlet_error"],
                                   j_inlet_error(jm, 16), rtol=1e-4)
        np.testing.assert_allclose(stats["max_u"],
                                   np.abs(jf[..., :2]).max(), rtol=1e-5)
    with pytest.raises(ValueError, match="grid"):
        vortex_stats.field_stats(np.zeros((2, 15, 3)), 1.0)
