"""PyTorch port, program spans (`insr_pde_tpu_torch/utils/tracing.py`).

* Off: without a profiler a fluid step records nothing.
* On: a fluid step under `torch.profiler` records one `timestep`, its three
  `fit`s and one `iter` and one `sample` per Adam iteration, each under the
  right parent, with self times >= 0; every random draw the profiler saw
  starts inside a `sample` span (the spans are on the profiler's clock).
* The sync counter: a "synchronizing CUDA operation" warning counts on the
  innermost span and is not shown, others pass; the warning hooks come
  back after an exception, and a timestep left open by one ends at the
  next `begin_timestep`. On a card, a pageable upload counts 1 and a
  device-only op 0.
* The benchmark's four readers of the spans against hand counts, and
  `--profile_dir`'s `spans.json`.
"""

import importlib.util
import json
import os
import warnings

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from insr_pde_tpu_torch import __main__ as cli
from insr_pde_tpu_torch.config import parse_args
from insr_pde_tpu_torch.utils import tracing

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--init_cond", "taylorgreen",
        "--num_hidden_layers", "2", "--hidden_features", "8", "-sr", "8",
        "-vr", "8", "--max_n_iters", "20", "--chunk_size", "10",
        "--no_backup"]
SYNC = "called a synchronizing CUDA operation"


def _fluid(tmp_path):
    cfg = parse_args(["fluid", *TINY, "--proj_dir", str(tmp_path)],
                     phase="train")
    model = cli.build_model(cfg)
    cfg.setup_dirs()
    model.initialize()
    return model


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(scope="module")
def traced_step(tmp_path_factory):
    """(the fits of one profiled fluid step, the snapshot, the profiler's
    events as (name, start_ns))."""
    model = _fluid(tmp_path_factory.mktemp("traced"))
    tracing.reset()
    with _cpu_profile() as prof:
        fits = model.step()
    events = [(e.name(), e.start_ns())
              for e in prof.profiler.kineto_results.events()]
    return fits, tracing.snapshot(), events


def test_off_records_nothing(tmp_path):
    model = _fluid(tmp_path)
    tracing.reset()
    model.step()
    snap = tracing.snapshot()
    assert snap["totals"] == {} and snap["spans"] == []


def test_on_records_the_step(traced_step):
    fits, snap, _ = traced_step
    iters = sum(f.n_iters for f in fits)
    assert iters == 60
    totals = snap["totals"]
    assert {k: v["calls"] for k, v in totals.items()} == {
        "timestep": 1, "fit": 3, "iter": iters, "sample": iters}
    spans = snap["spans"]
    parent_of = {"timestep": None, "fit": "timestep", "iter": "fit",
                 "sample": "iter"}
    for s in spans:
        parent = s["parent"]
        assert (None if parent is None else spans[parent]["name"]) \
            == parent_of[s["name"]]
        assert s["end_ns"] >= s["start_ns"] and s["syncs"] == 0
        if parent is not None:
            assert spans[parent]["start_ns"] <= s["start_ns"]
            assert s["end_ns"] <= spans[parent]["end_ns"]
    for t in totals.values():
        assert 0 <= t["child_ns"] <= t["total_ns"]
    assert totals["sample"]["child_ns"] == 0
    assert totals["iter"]["child_ns"] == totals["sample"]["total_ns"]
    assert snap["dropped"] == 0


def test_spans_are_on_the_profiler_clock(traced_step):
    _, snap, events = traced_step
    samples = [(s["start_ns"], s["end_ns"]) for s in snap["spans"]
               if s["name"] == "sample"]
    draws = [t for name, t in events
             if name in ("aten::rand", "aten::uniform_")]
    # 3 draws an iteration: the interior points and two boundary pairs
    assert len(draws) >= 3 * len(samples)
    for t in draws:
        assert any(a <= t <= b for a, b in samples), t


def test_sync_warning_counts_on_innermost_span():
    tracing.reset()
    with _cpu_profile():
        with tracing.span("outer"):
            with tracing.span("inner"):
                warnings.warn(SYNC)
                warnings.warn(SYNC)
            warnings.warn(SYNC)
            with pytest.warns(UserWarning, match="another warning"):
                warnings.warn("another warning")
    totals = tracing.snapshot()["totals"]
    assert totals["inner"]["syncs"] == 2
    assert totals["outer"]["syncs"] == 1


def test_hooks_restored_after_an_exception(tmp_path):
    model = _fluid(tmp_path)
    tracing.reset()
    with _cpu_profile():
        show, filters = warnings.showwarning, list(warnings.filters)
        with pytest.raises(RuntimeError):
            with tracing.span("outer"):
                with tracing.span("inner"):
                    assert warnings.showwarning is not show
                    raise RuntimeError("planted")
        assert warnings.showwarning is show
        assert warnings.filters == filters

        def fail(*args, **kwargs):
            raise RuntimeError("planted")
        model._run_phase = fail
        with pytest.raises(RuntimeError):
            model.step()
        assert warnings.showwarning is not show
        model.begin_timestep()
        model.end_timestep()
        assert warnings.showwarning is show
        assert warnings.filters == filters
    totals = tracing.snapshot()["totals"]
    assert totals["timestep"]["calls"] == 2
    assert totals["inner"]["calls"] == totals["outer"]["calls"] == 1


def _reader(name):
    path = os.path.join(REPO, "benchmark", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _totals(**kw):
    return {name: dict(zip(("calls", "total_ns", "child_ns", "syncs"), v))
            for name, v in kw.items()}


@pytest.mark.parametrize("metric,expected", [
    # 10 iterations with 25 syncs in them, 5 in their samplers
    ("host_syncs_per_iter", (20 + 5) / 10),
    # 30 ms of sampling over 10 iterations
    ("sample_ms_per_iter", 3.0),
    # 150 ms of iterations less the 30 of sampling, over 10
    ("issue_ms_per_iter", 12.0),
    # 2 timesteps of 400 ms in all, 380 of them in fits
    ("step_bookkeeping_ms", 10.0),
])
def test_readers_against_hand_counts(monkeypatch, metric, expected):
    read = _reader(metric)
    snap = {"totals": _totals(timestep=(2, 400e6, 380e6, 7),
                              fit=(3, 380e6, 150e6, 3),
                              iter=(10, 150e6, 30e6, 20),
                              sample=(10, 30e6, 0, 5)),
            "spans": [], "dropped": 0, "clock": "time.time_ns"}
    monkeypatch.setattr(tracing, "snapshot", lambda: snap)
    assert read({"trace": {"iters": 10}}) == pytest.approx(expected)
    assert read({"trace": None}) is None
    snap["totals"] = {}
    assert read({"trace": {"iters": 10}}) is None


def test_profile_dir_writes_spans(tmp_path):
    cli.main(["fluid", *TINY, "-T", "1", "--proj_dir", str(tmp_path),
              "--profile_dir", str(tmp_path / "prof")])
    with open(tmp_path / "prof" / "spans.json") as f:
        written = json.load(f)
    snap = tracing.snapshot()
    assert written["totals"] == snap["totals"]
    assert len(written["spans"]) == len(snap["spans"])
    assert {k: v["calls"] for k, v in snap["totals"].items()} == {
        "timestep": 2, "fit": 4, "iter": 80, "sample": 80}
    with open(tmp_path / "prof" / "trace.json") as f:
        base = json.load(f)["baseTimeNanoseconds"]
    assert all(s["start_ns"] > base for s in written["spans"])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the sync debug mode counts only "
                    "CUDA calls")
    return torch.device("cuda")


@pytest.mark.cuda
def test_sync_counter_on_card(cuda_device):
    x = torch.ones(1024, device=cuda_device)
    torch.cuda.synchronize()
    tracing.reset()
    mode = torch.cuda.get_sync_debug_mode()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with tracing.span("upload"):
            torch.tensor([1.0], device=cuda_device)
        with tracing.span("device"):
            x.mul_(2.0)
    assert torch.cuda.get_sync_debug_mode() == mode
    totals = tracing.snapshot()["totals"]
    assert totals["upload"]["syncs"] == 1
    assert totals["device"]["syncs"] == 0
