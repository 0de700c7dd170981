"""PyTorch port, the f64 least-squares truth (`vortex_truth`) and the
configuration sweep (`vortex_sweep`) against the JAX package's tools.

* `to_csr`: the CSR copy's products equal the operator's `mv` and `rmv`,
  in both formulations.
* On the same draws (the JAX model built on the port's basis and points,
  as `tests/vortex_hashgrid_reference_jax.py` does) at the JAX tool's
  default scene, the port's LSQR answer has the JAX tool's residual, inlet
  error and per-block rms.
* The block-preconditioned LSQR reaches the dense least-squares minimum
  of a small system, and no f32 answer beats it; a sweep row per solver
  with finite metrics.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse.linalg as spl
import torch

from insr_pde_tpu_torch import vortex_sweep, vortex_truth
from insr_pde_tpu_torch.models.vortex import (StreamVortexModel, VortexConfig,
                                              VortexModel)
from tools.vortex_truth import inlet_error as j_inlet_error
from tools.vortex_truth import to_csr as j_to_csr
from vortex_hashgrid_reference_jax import _vortex_pair

torch.set_num_threads(1)

# a small scene of each formulation
SMALL = dict(n_spatial_basis=25, time_num=3, collocation_pts_num=64,
             boundary_num=32, rho=1.0, internal_v=1.0, picard_iters=1,
             cgls_maxiter=200)
# the JAX tool's default scene as starterL flags (stream formulation:
# smooth PoU, band width 1, w_bc 5, damp 0)
JAX_TOOL_SCENE = ["vortex", "--formulation", "stream", "--n_spatial_basis",
                  "100", "--time_num", "4", "--collocation", "250",
                  "--boundary", "120", "--rho", "1", "--internal_v", "2",
                  "--picard_iters", "1"]
LSQR_ITERS = 500


def _small(formulation, tmp_path):
    cls = StreamVortexModel if formulation == "stream" else VortexModel
    cfg = VortexConfig(**SMALL, log_dir=str(tmp_path / "log"),
                       **({"pou": "smooth", "band_width": 1.0, "w_bc": 5.0}
                          if formulation == "stream" else {}))
    return cls(cfg, log=False, device="cpu")


@pytest.mark.parametrize("formulation", ["velocity", "stream"])
def test_to_csr_products_equal_the_operator(tmp_path, formulation):
    model = _small(formulation, tmp_path)
    A, b = model.assemble(model.params.u)
    csr, b64 = vortex_truth.to_csr(A, b)
    assert csr.shape == (A.vals.shape[0], A.n_cols)
    np.testing.assert_array_equal(b64, b.numpy().astype(np.float64))
    rng = np.random.default_rng(0)
    x = rng.standard_normal(A.n_cols).astype(np.float32)
    r = rng.standard_normal(A.vals.shape[0]).astype(np.float32)
    np.testing.assert_allclose(csr @ x, A.mv(torch.from_numpy(x)).numpy(),
                               rtol=1e-6, atol=1e-6 * np.abs(csr @ x).max())
    got = csr.T @ r
    np.testing.assert_allclose(got, A.rmv(torch.from_numpy(r)).numpy(),
                               rtol=1e-6, atol=1e-6 * np.abs(got).max())
    # the LSQR operator is the same products in f64
    op, to_x = vortex_truth.lsq_operator(A)
    assert to_x(x.astype(np.float64)) is not None
    np.testing.assert_allclose(op.matvec(x.astype(np.float64)), csr @ x,
                               rtol=1e-12, atol=1e-12 * np.abs(csr @ x).max())
    np.testing.assert_allclose(op.rmatvec(r.astype(np.float64)), got,
                               rtol=1e-12, atol=1e-12 * np.abs(got).max())


@pytest.fixture(scope="module")
def jax_tool_pair():
    """The JAX tool's default scene: the port's model on the CPU and the
    JAX model on its draws, each system assembled by its own package, and
    the LSQR answer of the JAX-assembled system by each package's tool
    with that answer's measures (the JAX side by the JAX tool's own
    functions). LSQR at LSQR_ITERS is far from converged here, where its
    iterate follows rounding: on the two packages' operators (the same to
    f32 rounding) it reads 67.184 against 67.147 at 500 iterations, so the
    tools are held to each other on one operator."""
    from insr_pde_tpu_torch.ops.linalg import BlockSparse
    tm, jm, _, _ = _vortex_pair(JAX_TOOL_SCENE, None)
    A, b = jax.jit(lambda u, *pbs: jm.assemble(u, *pbs))(jm.params.u,
                                                          *jm._pbs())
    port_system = tm.assemble(tm.params.u)
    system = (BlockSparse(torch.from_numpy(np.array(A.vals)),
                          torch.from_numpy(np.array(A.cols)), A.n_blocks),
              torch.from_numpy(np.array(b)))
    truth = vortex_truth.lsqr_truth(tm, LSQR_ITERS, 0.0, system)
    port = {**vortex_truth.measure(tm, truth["x64"], system),
            "r1norm": truth["r1norm"], "itn": truth["itn"]}

    csr, b64 = j_to_csr(A, b)
    out = spl.lsqr(csr, b64, damp=0.0, iter_lim=LSQR_ITERS, atol=1e-10,
                   btol=1e-10)
    jm.params = jm.params._replace(u=jnp.asarray(
        out[0], dtype=jnp.float32).reshape(jm.params.u.shape))
    ref = {"r1norm": float(out[3]), "itn": int(out[2]),
           "inlet_error": j_inlet_error(jm),
           "blocks": {k: v["rms"] for k, v in jm.block_residuals().items()}}
    return port, ref, port_system, system


def test_the_port_assembles_the_jax_tools_system(jax_tool_pair):
    _, _, (A, b), (jA, jb) = jax_tool_pair
    assert A.n_blocks == jA.n_blocks
    np.testing.assert_array_equal(A.cols.numpy(), jA.cols.numpy())
    scale = float(jA.vals.abs().max())
    np.testing.assert_allclose(A.vals.numpy(), jA.vals.numpy(), rtol=0,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(b.numpy(), jb.numpy(), rtol=0,
                               atol=1e-5 * float(jb.abs().max()))


def test_lsqr_residual_matches_the_jax_tool(jax_tool_pair):
    port, ref, _, _ = jax_tool_pair
    assert port["itn"] == ref["itn"]
    assert port["r1norm"] == pytest.approx(ref["r1norm"], rel=1e-6)
    # the f64 residual recomputed on the operator is LSQR's own estimate
    assert port["residual64"] == pytest.approx(port["r1norm"], rel=1e-6)


def test_lsqr_inlet_error_and_blocks_match_the_jax_tool(jax_tool_pair):
    port, ref, _, _ = jax_tool_pair
    assert port["inlet_error"] == pytest.approx(ref["inlet_error"], rel=1e-4)
    assert set(port["blocks"]) == set(ref["blocks"])
    floor = 1e-6 * max(ref["blocks"].values())
    for k, v in ref["blocks"].items():
        assert abs(port["blocks"][k] - v) <= 1e-4 * max(abs(v), floor), k


@pytest.mark.parametrize("formulation", ["velocity", "stream"])
def test_no_f32_answer_beats_the_f64_minimum(tmp_path, formulation):
    """The block-preconditioned LSQR on the small system converges (istop
    1 or 2) to the dense least-squares minimum, and no f32 answer's f64
    residual is below it."""
    model = _small(formulation, tmp_path)
    rec = vortex_truth.run(model, 40000, 0.0,
                           ("cgls", "cg", ("cgls", "block")),
                           lsqr_precondition="block")
    truth = rec["lsqr64"]
    assert truth["istop"] in (1, 2)
    A, b = model.assemble(model.params.u)
    csr, b64 = vortex_truth.to_csr(A, b)
    x, *_ = np.linalg.lstsq(csr.toarray(), b64, rcond=None)
    # istop 1 stops at |r| <= btol |b| + atol |A| |x| (1e-10 each)
    assert abs(truth["residual64"] - np.linalg.norm(csr @ x - b64)) <= (
        1e-5 * np.linalg.norm(b64))
    for tag in ("cgls", "cg", "cgls_block"):
        assert rec[tag]["residual64"] >= truth["residual64"] * (1 - 1e-6)
        assert np.isfinite(rec[tag]["inlet_error"])
    # the model's coefficients are its init again
    u0 = _small(formulation, tmp_path).params.u
    torch.testing.assert_close(model.params.u, u0, rtol=0, atol=0)


@pytest.mark.parametrize("formulation", ["velocity", "stream"])
def test_row_gram_start_is_certified_by_lsqr(tmp_path, formulation):
    """From the dense row-Gram solution of the block-whitened system LSQR
    stops with istop 1 in fewer iterations than from 0, at the dense
    least-squares minimum (these systems have more columns than rows and
    independent rows: the minimum is ~0). Unwhitened, the row Gram squares
    A's condition number (~1e8 to 5e9 here) and is of no use."""
    model = _small(formulation, tmp_path)
    system = model.assemble(model.params.u)
    got = vortex_truth.lsqr_truth(model, 40000, 0.0, system, "block",
                                  start="rows")
    cold = vortex_truth.lsqr_truth(model, 40000, 0.0, system, "block")
    b_norm = float(torch.linalg.norm(system[1].double()))
    assert got["istop"] == 1 and got["itn"] < cold["itn"]
    assert got["start_residual64"] <= 1e-3 * b_norm
    assert vortex_truth.residual64(*system, got["x64"]) <= 1e-5 * b_norm


def test_row_gram_start_refuses_dependent_rows(tmp_path):
    """Two equal rows: the row Gram is singular, and the start raises."""
    from insr_pde_tpu_torch.ops.linalg import BlockSparse
    model = _small("velocity", tmp_path)
    A, b = model.assemble(model.params.u)
    twice = BlockSparse(torch.cat([A.vals, A.vals[:1]]),
                        torch.cat([A.cols, A.cols[:1]]), A.n_blocks)
    with pytest.raises(RuntimeError, match="positive definite"):
        vortex_truth.row_gram_start(twice, torch.cat([b, b[:1]]))


@pytest.mark.parametrize("formulation", ["velocity", "stream"])
def test_preconditioned_lsqr_solves_the_same_problem(tmp_path, formulation):
    """The block-preconditioned LSQR answer x = P y is an answer of the
    unpreconditioned problem: its recomputed residual is LSQR's estimate,
    and at the same iterations it is no worse than the plain LSQR's."""
    model = _small(formulation, tmp_path)
    system = model.assemble(model.params.u)
    plain = vortex_truth.lsqr_truth(model, 300, 0.0, system)
    got = vortex_truth.lsqr_truth(model, 300, 0.0, system, "block")
    b_norm = float(torch.linalg.norm(system[1].double()))
    assert abs(vortex_truth.residual64(*system, got["x64"])
               - got["r1norm"]) <= 1e-6 * got["r1norm"] + 1e-12 * b_norm
    assert got["r1norm"] <= plain["r1norm"] * (1 + 1e-9)


def test_preconditioned_lsqr_refuses_a_damped_problem(tmp_path):
    """A preconditioner or a start would change a damped problem."""
    model = _small("velocity", tmp_path)
    with pytest.raises(ValueError, match="damp"):
        vortex_truth.lsqr_truth(model, 10, 0.1, precondition="block")
    with pytest.raises(ValueError, match="damp"):
        vortex_truth.lsqr_truth(model, 10, 0.1, start="rows")


def test_vortex_sweep_reports_both_solvers(tmp_path, capsys):
    spec = {"name": "small", "solver": "both", "lsqr_iters": 500,
            "log_dir": str(tmp_path / "log"),
            **{k: v for k, v in SMALL.items() if k != "picard_iters"}}
    out = tmp_path / "rows.json"
    rc = vortex_sweep.main(["--device", "cpu", "--inline", json.dumps([spec]),
                            "--out", str(out)])
    assert rc == 0
    rows = json.loads(out.read_text())
    assert [r["solver"] for r in rows] == ["lsqr64", "cgls32"]
    for r in rows:
        assert np.isfinite(r["inlet"]) and np.isfinite(r["rel_div"])
        assert len(r["inlet_per_slice"]) == SMALL["time_num"]
    assert "| small | lsqr64 |" in capsys.readouterr().out


def test_vortex_sweep_exits_1_on_a_failed_config(tmp_path):
    bad = [{"name": "bad", "solver": "neither"}]
    assert vortex_sweep.main(["--device", "cpu", "--inline",
                              json.dumps(bad)]) == 1
