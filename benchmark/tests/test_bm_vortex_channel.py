"""The vortex channel cell (`vortex_channel.cgls2000`, configuration
`vortex_channel_stream`) on the CPU at a tiny size: 200 collocation and 80
boundary points a slice, 3 slices, `n_spatial_basis` 20 (a 4 x 4 site
grid), 40 CGLS iterations in chunks of 10. The configuration file against
the flags the program parses; the reference's system against the
program's assembly, row by row; the run through the harness: its start
and handoffs exact, the plain CPU path `correct`, and the TF32 control
and two faults planted in the program not correct; the work counted from
shapes against hand counts and against the program's operator."""

import json
import os

import pytest
import torch

from benchmark.compare import verdict
from benchmark.drivers.vortex import Driver
from benchmark.flops import vortex_channel_stream as flops
from benchmark.harness import cell_spec, run_cell
from benchmark.reference.vortex_channel_stream import Reference

CELL = "vortex_channel.cgls2000"
TINY = {"collocation": 200, "boundary": 80, "n_spatial_basis": 20,
        "time_num": 3, "cgls_chunk": 10}
# the window's one step (t = 2) followed by its phi over its 4 chunks, as
# the cell follows its steps past the published three Picard iterations;
# or compared whole
FOLLOWED = {"check": {"steps": 2, "eval_resolution": 16, "followed_from": 2,
                      "contact_iters": 4}}
WHOLE = {"check": {"steps": 2, "eval_resolution": 16}}
ITERS = 40
SEED = 2 ** 31 + 12345
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _config():
    config = dict(cell_spec(CELL)["config"], **TINY, max_n_iters=ITERS)
    config["args"] = config["args"] + [f"--{k}={v}" for k, v in TINY.items()]
    return config


def _run(plant=None, modes=("program",), check=FOLLOWED):
    return run_cell(CELL, SEED, 0.0, False, device_name="cpu",
                    workload_overrides=check, iters=ITERS,
                    config_overrides=TINY, plant=plant, modes=modes)


def _holds(r, mode="program", whole=False):
    """The mode's numbers within the cell's limits; with `whole`, those of
    fits compared whole (no followed fit)."""
    limits = {k: v["limit"] for k, v in r["checks"].items()
              if k != "routes" and not (whole and k == "contact_loss_gap")}
    return verdict(r["readings"][mode], limits)


def test_bm_vortex_config_file_is_what_the_program_runs(tmp_path):
    from insr_pde_tpu_torch.starterL import build_config, parse_args
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "vortex_channel_stream.json")) as f:
        cfg = json.load(f)
    args = parse_args(cfg["args"][1:] + ["--cgls_maxiter",
                                         str(cfg["max_n_iters"])])
    vc = build_config(args)
    assert args.formulation == cfg["formulation"]
    assert args.precondition == cfg["precondition"]
    assert args.collocation == cfg["collocation"]
    assert args.boundary == cfg["boundary"]
    for key in ("rho", "internal_v", "time_num", "n_spatial_basis",
                "n_feat", "neighbor_k", "cgls_chunk", "cgls_maxiter",
                "cgls_tol", "cgls_restart", "cgls_damp", "pou", "pou_time",
                "time_window", "band_width", "stream_bc", "w_bc", "w_init",
                "w_momentum", "pou_normalize", "outlet_v", "reuse_whitener",
                "warm_start", "picard_iters", "gravity", "time_length"):
        assert getattr(vc, key) == cfg[key], key
    assert cfg["max_n_iters"] == cfg["cgls_maxiter"] == 2000


def test_bm_vortex_reference_assembles_the_programs_system(tmp_path):
    """Row by row, each row's values summed into its columns (the two
    order a row's slots differently). Tolerance 5e-6 of the largest |value|
    (each block is scaled to at most its weight, 5): the same float32
    formulas summed in another order, where the momentum rows' rho
    (convection + d/dt) sums cancel down to a few hundredths of their
    terms."""
    config = _config()
    drv = Driver(config, WHOLE, SEED, str(tmp_path), "cpu")
    ref = Reference(config, WHOLE, SEED, torch.device("cpu"), {})
    w0 = ref.initial_weights()
    m = drv.model
    assert torch.equal(w0["coefficients"][0][0], m.params.u)
    for ubar in (m.params.u, 0.1 * torch.randn(
            m.params.u.shape, generator=torch.Generator().manual_seed(3))):
        A, b = m.assemble(ubar)
        s = ref.system(ubar)
        assert s.vals.shape == A.vals.shape
        n = A.n_blocks * A.bdim

        def dense(vals, cols):
            R, S, J = vals.shape
            out = torch.zeros(R, n, dtype=torch.float64)
            idx = (cols.long()[..., None] * J
                   + torch.arange(J)).reshape(R, -1)
            return out.scatter_add_(1, idx, vals.double().reshape(R, -1))

        dp, dr = dense(A.vals, A.cols), dense(s.vals, s.cols)
        scale = float(dp.abs().max())
        assert float((dp - dr).abs().max()) <= 5e-6 * scale
        assert float((b.double() - s.b.double()).abs().max()) \
            <= 5e-6 * float(b.abs().max())


def test_bm_vortex_plain_path_is_correct():
    r = _run()
    assert r["correct"], r["checks"]
    assert r["checks"]["weights_gap"]["value"] == 0.0
    assert r["checks"]["handoff_gap"]["value"] == 0.0
    assert r["checks"]["contact_loss_gap"]["value"] is not None
    assert r["attempted"] == 1 and r["failed"] == 0
    whole = _run(check=WHOLE)
    assert "contact_loss_gap" not in whole["readings"]["program"]
    assert _holds(whole, whole=True), whole["checks"]


@pytest.mark.parametrize("check", [FOLLOWED, WHOLE], ids=["followed",
                                                          "whole"])
def test_bm_vortex_control_is_not_correct(check):
    r = _run(modes=("program", "control"), check=check)
    whole = check is WHOLE
    assert _holds(r, whole=whole)
    assert not _holds(r, "control", whole=whole), r["readings"]


def _no_convection(drv):
    """The momentum rows assembled without the convective term: around
    zero coefficients, which only that term reads."""
    m = drv.model
    orig = m.assemble

    def assemble(ubar, *a, **k):
        return orig(torch.zeros_like(ubar), *a, **k)
    m.assemble = assemble


@pytest.fixture
def other_whitener(monkeypatch):
    """A plant that caches, at the second Picard, the whitener of the
    first one's system (the random start's) in place of its own."""
    from insr_pde_tpu_torch.models import vortex
    orig = vortex.cgls_sparse_chunked
    first = []

    def solve(*a, whitener=None, **k):
        if whitener is None and first:
            whitener = first[0]
        x, info = orig(*a, whitener=whitener, **k)
        if not first:
            first.append(info["W"])
        return x, info

    def plant(drv):
        monkeypatch.setattr(vortex, "cgls_sparse_chunked", solve)
    return plant


@pytest.mark.parametrize("fault", ["no_convection", "other_whitener"])
def test_bm_vortex_fault_is_not_correct(fault, request):
    """Each fault fails the limits of a step compared whole (the window's
    first, t = 2, in the cell); the handoffs still read 0."""
    plant = (_no_convection if fault == "no_convection"
             else request.getfixturevalue("other_whitener"))
    r = _run(plant=plant, check=WHOLE)
    assert not _holds(r, whole=True), r["checks"]
    assert r["checks"]["handoff_gap"]["value"] == 0.0


def test_bm_vortex_counts_by_hand(tmp_path):
    config = _config()
    s = flops.shapes(config)
    # momentum 2 x 2 slices x 200 rows of 12 slots; walls 2 kinds x 2 x 20
    # points x 2 slices, outlet 20 x 2, inlet 3 x 20 x 2, initial 4 x
    # (200 + 3 x 20), gauge 3: 1,363 rows of 6 real slots
    assert s == {"R": 800 + 1363, "S": 12, "J": 16, "n_blocks": 2 * 16 * 3,
                 "nnz": 800 * 12 + 1363 * 6}
    drv = Driver(config, WHOLE, SEED, str(tmp_path), "cpu")
    A, _ = drv.model.assemble(drv.model.params.u)
    assert tuple(A.vals.shape) == (s["R"], s["S"], s["J"])
    assert A.n_blocks == s["n_blocks"]
    assert int(A.row_slots.sum()) == s["nnz"]
    R, nb, nnz = s["R"], s["n_blocks"], s["nnz"]
    # 40 iterations in 4 chunks: mv 40 + 4 + 1 launches, rmv 40 + 4
    k = flops.kernel_work(config, {})
    assert k["block_ell_mv"]["flops"] == pytest.approx(
        45 / 40 * 2 * R * 12 * 16)
    assert k["block_ell_mv"]["bytes"] == pytest.approx(
        45 / 40 * 4 * (R * 12 * 16 + R * 12 + R + nb * 16))
    assert k["block_ell_rmv"]["flops"] == pytest.approx(44 / 40 * 2 * nnz * 16)
    assert k["block_ell_rmv"]["bytes"] == pytest.approx(
        44 / 40 * 4 * (nnz * 16 + nnz + nb + 1 + R + nb * 16))
    assert flops.iter_flops(config, {})["picard"] == (
        2 * R * 12 * 16 + 2 * nnz * 16 + 4 * nb * 256 + 6 * R
        + 12 * nb * 16)


@pytest.mark.cuda
def test_bm_vortex_cell_runs_on_the_card():
    """The cell at its published size for 10 s (past its followed step,
    t = 12): correct, every window Picard at its CGLS iterations and
    finite, with its per-layer metrics under the trace."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = run_cell(CELL, SEED, 10.0, True)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    for name in ("picard_assemble_ms", "cgls_syncs_per_iter",
                 "block_ell_mv_roofline", "block_ell_rmv_roofline",
                 "device_ops_per_iter", "fit_iter_ms", "step_overhead_ms",
                 "idle_share", "step_mfu"):
        assert name in r["metrics"], r["metrics"]
