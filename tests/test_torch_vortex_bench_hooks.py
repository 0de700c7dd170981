"""PyTorch port, what the vortex model offers a caller that runs its Picard
iterations one at a time (the benchmark's driver): `starterL.build_model`,
`--seed`, the published CGLS tolerance running every iteration, the
driver's `phase_timings`, the spans `picard`, `assemble`, `whiten`, `cgls`
and `cgls_chunk` (`utils/tracing.py`) and the CGLS phi read at each
chunk's end (`phi_history`); and how `ops/linalg.cgls` splits a chunk into
replays of a graph of `graph_iters` iterations and the rest.

On a tiny channel scene: the channel preset at 200 collocation and 80
boundary points a slice, 3 slices, `--n_spatial_basis 20` (a 4 x 4 site
grid), 40 CGLS iterations in chunks of 10. Every comparison is exact: the
same code on the same CPU gives the same bits.
"""

import dataclasses

import numpy as np
import pytest
import torch

from insr_pde_tpu_torch import starterL
from insr_pde_tpu_torch.models.vortex import VortexConfig
from insr_pde_tpu_torch.ops import block_ell, linalg
from insr_pde_tpu_torch.utils import tracing

torch.set_num_threads(1)

ITERS, CHUNK = 40, 10
TINY = ["--preset", "channel", "--device", "cpu", "--collocation", "200",
        "--boundary", "80", "--n_spatial_basis", "20", "--time_num", "3",
        "--cgls_maxiter", str(ITERS), "--cgls_chunk", str(CHUNK),
        "--ckpt_path", "none"]


def _model(tmp_path, *extra):
    args = starterL.parse_args(TINY + ["--log_dir", str(tmp_path / "log"),
                                       "--output_path", str(tmp_path)]
                               + list(extra))
    return starterL.build_model(args)


def _same_geometry(a, b) -> bool:
    return (all(torch.equal(x, y) for x, y in zip(a.params, b.params))
            and torch.equal(a.pts.x, b.pts.x)
            and torch.equal(a.pts.t, b.pts.t))


def test_seed_reaches_points_and_basis(tmp_path):
    """--seed draws another basis and other points; without it the seed
    is VortexConfig's, so the model is the one its config alone builds."""
    default = _model(tmp_path)
    assert default.cfg.seed == VortexConfig.seed == 213421
    fields = {k: v for k, v in dataclasses.asdict(default.cfg).items()
              if k != "seed"}
    old = type(default)(VortexConfig(**fields), log=False, device="cpu")
    assert old.cfg.seed == 213421
    assert _same_geometry(default, old)
    other = _model(tmp_path, "--seed", str(2 ** 31 + 7))
    assert other.cfg.seed == 2 ** 31 + 7
    for name in ("A", "tA", "bias", "u"):
        assert not torch.equal(getattr(other.params, name),
                               getattr(default.params, name)), name
    assert torch.equal(other.params.centers, default.params.centers)
    assert not torch.equal(other.pts.x, default.pts.x)
    assert _same_geometry(other, _model(tmp_path, "--seed",
                                        str(2 ** 31 + 7)))


@pytest.mark.parametrize("seed", [VortexConfig.seed, 2 ** 31 + 7])
def test_published_tol_runs_every_iteration(tmp_path, seed):
    """At the published tolerance (1e-10 on |A^T r| against its start)
    no solve stops before its count: f32 CGLS cannot get there."""
    model = _model(tmp_path, "--picard_iters", "4", "--seed", str(seed))
    assert model.cfg.cgls_tol == VortexConfig.cgls_tol == 1e-10
    model.matrix_solver()
    assert [t["cgls_iters"] for t in model.picard_timings] == [ITERS] * 4


def test_phase_timings_one_record_per_picard(tmp_path):
    """The benchmark's driver gives the model one `phase_timings` record
    per Picard (one a step), with the keys of BaseModel's."""
    from benchmark.drivers.vortex import Driver
    config = {"args": ["vortex"] + TINY, "max_n_iters": ITERS}
    drv = Driver(config, {}, VortexConfig.seed, str(tmp_path), "cpu")
    drv.initialize()
    drv.step()
    drv.step()
    recs = drv.model.phase_timings
    assert [r["timestep"] for r in recs] == [0, 1, 2]
    for r in recs:
        assert set(r) == {"timestep", "tag", "n_iters", "sec"}
        assert r["tag"] == "picard" and r["n_iters"] == ITERS
        assert r["sec"] > 0.0


@pytest.mark.parametrize("n", [3])
def test_n_single_picard_calls_equal_one_call_of_n(tmp_path, n):
    """The whitener cache (made at the second Picard), the warm start and
    the Picard count carry over between calls."""
    one = _model(tmp_path, "--picard_iters", str(n))
    one.matrix_solver()
    many = _model(tmp_path, "--picard_iters", "1")
    phis = []
    for _ in range(n):
        many.matrix_solver()
        phis += [t["phi_history"] for t in many.picard_timings]
    assert torch.equal(one.params.u, many.params.u)
    assert one._whitener is not None
    assert torch.equal(one._whitener, many._whitener)
    assert one._picard_seen == many._picard_seen == n
    assert phis == [t["phi_history"] for t in one.picard_timings]


def _spans(fn):
    tracing.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        fn()
    snap = tracing.snapshot()
    tracing.reset()
    return snap


def test_spans_nest_and_record_only_under_the_profiler(tmp_path):
    model = _model(tmp_path, "--picard_iters", "2")
    snap = _spans(model.matrix_solver)
    spans = snap["spans"]
    parent = {"assemble": "picard", "whiten": "picard", "cgls": "picard",
              "cgls_chunk": "cgls"}
    counts = {}
    for s in spans:
        counts[s["name"]] = counts.get(s["name"], 0) + 1
        want = parent.get(s["name"])
        got = None if s["parent"] is None else spans[s["parent"]]["name"]
        assert got == want, s
        assert s["end_ns"] >= s["start_ns"]
    assert counts == {"picard": 2, "assemble": 2, "whiten": 2, "cgls": 2,
                      "cgls_chunk": 2 * ITERS // CHUNK}
    assert snap["totals"]["cgls_chunk"]["calls"] == 2 * ITERS // CHUNK
    # no profiler: nothing recorded
    tracing.reset()
    model.matrix_solver()
    assert tracing.snapshot()["totals"] == {}


@pytest.mark.parametrize("chunk", [10, 15])
def test_phi_history_has_one_entry_per_chunk(tmp_path, chunk):
    model = _model(tmp_path, "--picard_iters", "2", "--cgls_chunk",
                   str(chunk))
    model.matrix_solver()
    for t in model.picard_timings:
        hist = t["phi_history"]
        assert len(hist) == -(-ITERS // chunk)
        assert all(isinstance(v, float) and np.isfinite(v) for v in hist)


class _EagerGraph:
    """Stands in for `linalg._GraphedIterations` on the CPU: the same
    iterations, issued op by op, with the builds and calls counted."""
    built = 0
    calls = 0

    def __init__(self, mv, rmv, st, stop2, d2, n, maxiter, rows_reduce):
        type(self).built += 1
        self.args = (mv, rmv, stop2, d2, n, maxiter, rows_reduce)

    def __call__(self, st):
        type(self).calls += 1
        mv, rmv, stop2, d2, n, maxiter, rows_reduce = self.args
        return linalg._iterate(mv, rmv, st, stop2, d2, n, maxiter,
                               rows_reduce)


@pytest.mark.parametrize("graph_iters,chunk,maxiter", [(7, 10, 40),
                                                       (5, 10, 43),
                                                       (25, 10, 40)])
def test_cgls_chunk_split_into_graph_replays(monkeypatch, graph_iters,
                                             chunk, maxiter):
    """A chunk of n runs n // graph_iters replays of one graph (built once
    per solve, at the first chunk that holds one) and n % graph_iters
    iterations op by op: the iterates, counts and phi history of the
    op-by-op solve."""
    monkeypatch.setattr(linalg, "_GraphedIterations", _EagerGraph)
    monkeypatch.setattr(_EagerGraph, "built", 0)
    monkeypatch.setattr(_EagerGraph, "calls", 0)
    g = torch.Generator().manual_seed(5)
    A = linalg.BlockSparse(torch.randn((60, 3, 4), generator=g),
                           torch.randint(0, 8, (60, 3), generator=g,
                                         dtype=torch.int32), 8)
    b = torch.randn(60, generator=g)
    x0 = torch.zeros(A.n_cols)
    kw = dict(maxiter=maxiter, tol=0.0, check_every=chunk, restart=True)
    ref, ref_info = linalg.cgls(A.mv, A.rmv, b, x0, **kw)
    got, info = linalg.cgls(A.mv, A.rmv, b, x0, graph_iters=graph_iters,
                            **kw)
    assert torch.equal(got, ref)
    assert info["niter"] == ref_info["niter"] == maxiter
    assert info["phi_history"] == ref_info["phi_history"]
    sizes = [min(chunk, maxiter - i) for i in range(0, maxiter, chunk)]
    assert _EagerGraph.built == (1 if max(sizes) >= graph_iters else 0)
    assert _EagerGraph.calls == sum(n // graph_iters for n in sizes)


@pytest.mark.cuda
def test_graphed_cgls_gives_the_op_by_op_bits_on_card(tmp_path,
                                                      monkeypatch):
    """On the card, the channel preset at 2,000 collocation and 800
    boundary points a slice, 3 Picard iterations of 400 CGLS iterations in
    chunks of 200: the CGLS iterations graphed (`GRAPH_ITERS`) and issued
    op by op give the same coefficients, whitener and phi history, and
    advance the block-ELL launch counters alike."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA graphs have no CPU mode")
    argv = ["--preset", "channel", "--collocation", "2000", "--boundary",
            "800", "--picard_iters", "3", "--cgls_maxiter", "400",
            "--ckpt_path", "none", "--log_dir", str(tmp_path / "log"),
            "--output_path", str(tmp_path)]
    runs = []
    for graph_iters in (linalg.GRAPH_ITERS, 0):
        monkeypatch.setattr(linalg, "GRAPH_ITERS", graph_iters)
        model = starterL.build_model(starterL.parse_args(argv))
        before = (block_ell.mv_launches, block_ell.rmv_launches)
        model.matrix_solver()
        torch.cuda.synchronize()
        runs.append((model.params.u.cpu(), model._whitener.cpu(),
                     [t["phi_history"] for t in model.picard_timings],
                     (block_ell.mv_launches - before[0],
                      block_ell.rmv_launches - before[1])))
    graphed, eager = runs
    assert torch.equal(graphed[0], eager[0])
    assert torch.equal(graphed[1], eager[1])
    assert graphed[2] == eager[2]
    assert graphed[3] == eager[3]
    # per solve: an mv and rmv an iteration, one of each at the start and
    # at each restart, and the residual's mv
    assert eager[3] == (3 * (400 + 2 + 1), 3 * (400 + 2))


@pytest.mark.cuda
def test_graphed_cgls_memory_stays_flat_on_card(tmp_path):
    """Each solve captures its graph on the device's one capture stream,
    in the pool of the graph before: once the whitener is cached (Picard
    2), further Picards allocate and reserve nothing more."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA graphs have no CPU mode")
    model = starterL.build_model(starterL.parse_args(
        ["--preset", "channel", "--collocation", "2000", "--boundary", "800",
         "--picard_iters", "1", "--cgls_maxiter", "400", "--ckpt_path",
         "none", "--log_dir", str(tmp_path / "log"),
         "--output_path", str(tmp_path)]))
    seen = []
    for _ in range(6):
        model.matrix_solver()
        torch.cuda.synchronize()
        seen.append((torch.cuda.memory_allocated(),
                     torch.cuda.memory_reserved()))
    assert seen[3:] == [seen[2]] * 3, seen
