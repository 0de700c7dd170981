"""PyTorch port, the row-sharded vortex system (`VortexModel.assemble`
and `matrix_solver` on a group) against the JAX package's
(`assemble_sharded` and its sharded dispatch), and `host_sync`.

Port models are built from the JAX model's params and points
(`convert.rbf_params_from_jax`, `convert.points_from_jax`); their ranks are
spawned over gloo on the CPU (tests/torch_ranks.py), JAX runs on a mesh of
as many virtual CPU devices.
* The sharded assembly, velocity and stream, at worlds 2 and 3: each rank's
  rows equal the matching slice of JAX's row-sharded system (cols exactly;
  vals and rhs at tests/test_torch_vortex.py's assembly bar, rtol 1e-5 and
  atol 5e-6 of the largest value; padding rows exactly 0) and of the
  port's single-device system (rtol 1e-5, atol 1e-6), and the
  whole system's normal equations from the shards equal the single-device
  assembly's (rtol 2e-4, atol 1e-5, tests/test_vortex.py's bar).
* `matrix_solver` at world 2 against world 1 at tests/test_vortex.py's bar
  (rel < 2e-2): the unchunked loop, unpreconditioned and block-whitened
  (the JAX package drops the whitener there; the port keeps it), and the
  chunked block-whitened solve.
* `host_sync` records `host_shipped` and gives the same bits.
* The vortex CLI with `--n_devices 2`: one field and checkpoint, written by
  rank 0, and the same coefficients on both ranks."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from insr_pde_tpu.models import vortex as jv
from insr_pde_tpu_torch.convert import points_from_jax, rbf_params_from_jax
from insr_pde_tpu_torch.models import vortex as tv
from insr_pde_tpu_torch.parallel import launch

import torch_ranks

torch.set_num_threads(1)

KINDS = {
    "velocity": (dict(collocation_pts_num=64, boundary_num=32, time_num=3,
                      n_spatial_basis=25, n_feat=4, neighbor_k=4,
                      band_width=2.0, internal_v=1.0, rho=1.0, seed=3),
                 jv.VortexModel),
    "stream": (dict(rho=1.0, internal_v=1.0, n_spatial_basis=25, time_num=3,
                    collocation_pts_num=150, boundary_num=60, pou="smooth",
                    pou_time="simple", time_window=1, band_width=1.0,
                    stream_bc="both", w_bc=5.0, pou_normalize=True,
                    picard_iters=1, seed=5), jv.StreamVortexModel),
}


def _jax_model(kind, k=1, **over):
    kw, jcls = KINDS[kind]
    kw = {**kw, **over}
    mesh = None if k == 1 else Mesh(np.asarray(jax.devices()[:k]), ("data",))
    return kw, jcls(jv.VortexConfig(**kw), log=False, mesh=mesh)


def _port_args(jm):
    return ([np.asarray(a) for a in jm.params], points_from_jax(jm.pts))


def _port_model(kind, kw, jm):
    cls = tv.StreamVortexModel if kind == "stream" else tv.VortexModel
    params, points = _port_args(jm)
    return cls(tv.VortexConfig(**kw), log=False, device="cpu",
               params=rbf_params_from_jax(params), points=points)


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("kind", list(KINDS))
def test_assemble_sharded_matches_jax_slices(kind, k):
    kw, jm = _jax_model(kind, k)
    rng = np.random.default_rng(0)
    u = rng.normal(size=jm.params.u.shape).astype(np.float32)
    x = rng.normal(size=u.size).astype(np.float32)
    JA, jb = jm.assemble_sharded(jax.numpy.asarray(u).reshape(-1))
    jvals, jcols, jb = (np.asarray(a) for a in (JA.vals, JA.cols, jb))
    out = launch(torch_ranks.vortex_assemble, k, "gloo",
                 args=(kind, kw, *_port_args(jm), u, x))
    n = jvals.shape[0] // k
    tm = _port_model(kind, kw, jm)
    counts = [c for _, c in tm.block_names_counts()]
    A1, b1 = tm.assemble(torch.from_numpy(u))
    for r, res in enumerate(out):
        sl = slice(r * n, (r + 1) * n)
        np.testing.assert_array_equal(res["cols"], jcols[sl])
        # tests/test_torch_vortex.py's assembly bar against JAX: the stream
        # momentum rows' sums cancel (2 of 156,288 values here differ by
        # 1.1e-5, 2e-6 of the largest |val|)
        np.testing.assert_allclose(res["vals"], jvals[sl], rtol=1e-5,
                                   atol=5e-6 * np.abs(jvals).max())
        np.testing.assert_allclose(res["b"], jb[sl], rtol=1e-5,
                                   atol=5e-6 * np.abs(jb).max())
        # padding rows: no real slots, exactly zero
        pad = res["row_slots"] == 0
        assert pad.sum() == sum(-(-q // k) for q in counts) - sum(
            len(range(min(r * -(-q // k), q), min((r + 1) * -(-q // k), q)))
            for q in counts)
        assert not res["vals"][pad].any() and not res["b"][pad].any()
        # the layout of `row_shard` on the whole system
        np.testing.assert_allclose(
            res["vals"], tv.row_shard(A1.vals, counts, r, k).numpy(),
            rtol=1e-5, atol=1e-6)
    # the normal equations of the shards are the whole system's
    xt = torch.from_numpy(x)
    for res in out:
        np.testing.assert_allclose(res["AtAx"], A1.rmv(A1.mv(xt)).numpy(),
                                   rtol=2e-4, atol=1e-5)
        np.testing.assert_allclose(res["Atb"], A1.rmv(b1).numpy(),
                                   rtol=2e-4, atol=1e-5)


SOLVES = {
    # tests/test_vortex.py's sharded-solve config: the unchunked loop
    "velocity_unchunked": ("velocity", dict(
        collocation_pts_num=48, boundary_num=16, time_num=2,
        n_spatial_basis=16, n_feat=4, neighbor_k=4, band_width=2.0,
        internal_v=1.0, rho=1.0, cgls_maxiter=300, picard_iters=1,
        pou="hat", cgls_damp=0.01, seed=13)),
    # the same, block-whitened
    "velocity_block_unchunked": ("velocity", dict(
        collocation_pts_num=48, boundary_num=16, time_num=2,
        n_spatial_basis=16, n_feat=4, neighbor_k=4, band_width=2.0,
        internal_v=1.0, rho=1.0, cgls_maxiter=300, picard_iters=1,
        pou="hat", cgls_damp=0.01, cgls_precondition="block", seed=13)),
    # the channel preset's solver: block whitener, chunks, restarts
    "stream_block_chunked": ("stream", dict(
        cgls_precondition="block", cgls_chunk=12, cgls_restart=True,
        cgls_maxiter=120, reuse_whitener=True, warm_start=1.0,
        picard_iters=2)),
}


@pytest.mark.parametrize("case", list(SOLVES))
def test_matrix_solver_world_two_matches_world_one(case):
    kind, over = SOLVES[case]
    kw, jm = _jax_model(kind, **over)
    out = launch(torch_ranks.vortex_solve, 2, "gloo",
                 args=(kind, kw, *_port_args(jm)))
    tm = _port_model(kind, kw, jm)
    tm.matrix_solver()
    u1 = tm.params.u.numpy()
    for res in out:
        np.testing.assert_array_equal(res["u"], out[0]["u"])
        rel = np.linalg.norm(res["u"] - u1) / np.linalg.norm(u1)
        assert rel < 2e-2, rel
        assert np.isfinite(res["res"])


def test_host_sync_ships_the_system_and_keeps_the_bits():
    kw, jm = _jax_model("velocity", cgls_maxiter=40, picard_iters=2)
    runs = {}
    for flag in (False, True):
        m = _port_model("velocity", {**kw, "host_sync": flag}, jm)
        res = m.matrix_solver()
        assert all(t["host_shipped"] is flag for t in m.picard_timings)
        runs[flag] = (res, m.params.u.clone())
    assert runs[True][0] == runs[False][0]
    assert torch.equal(runs[True][1], runs[False][1])


def test_vortex_cli_on_two_ranks_writes_once(tmp_path):
    argv = ["--device", "cpu", "--collocation", "64", "--boundary", "32",
            "--time_num", "3", "--n_spatial_basis", "25", "--cgls_maxiter",
            "50", "--rho", "1", "--internal_v", "1", "--picard_iters", "1",
            "--n_devices", "2", "--output_path", str(tmp_path / "out"),
            "--log_dir", str(tmp_path / "log")]
    out = launch(torch_ranks.run_vortex_cli, 2, "gloo", args=(argv,))
    np.testing.assert_array_equal(out[0]["u"], out[1]["u"])
    assert sorted(p.name for p in (tmp_path / "out").iterdir()
                  if p.suffix in (".npy", ".npz")) == ["field.npy",
                                                        "vortex_ckpt.npz"]
    m = tv.load_vortex_ckpt(str(tmp_path / "out" / "vortex_ckpt.npz"),
                            device="cpu")
    np.testing.assert_array_equal(m.params.u.numpy(), out[0]["u"])
