"""PyTorch port: the JAX repo's last tools as the port's modules
(`overhead_probe`, `width_probe`, `coherence_probe`, `plateau_probe`,
`hashgrid_probe`, `vortex_train_probe`, `tg_milestones`), at tiny sizes on
the CPU.

* Each tool's records carry every key of the JAX tool's, both run at a
  tiny size (the coherence tool has no size flag: its keys are read from
  its source), and the port's tools default to the card.
* `plateau_probe`'s `ref` candidate at 30 iterations matches the JAX
  probe's on the port's draws (`tests/probes_reference_jax.py`) within the
  fluid phase-fit bar of `test_torch_fluid.py`, rtol 1e-3.
* The cosine schedule of `vortex_train_probe --lr_min` equals
  `optax.cosine_decay_schedule` at every step, and drives `train`.
* `tg_milestones` prints what `tools/tg_milestones.py` prints.
* `width_probe`'s FLOP count is the bench's pressure term; the overhead
  probe's `adam` and `full_solver_chunk` end at the same parameters.
"""

import ast
import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import optax
import pytest
import torch

from insr_pde_tpu_torch import (coherence_probe, hashgrid_probe,
                                overhead_probe, plateau_probe,
                                tg_milestones, vortex_train_probe,
                                width_probe)
from insr_pde_tpu_torch.bench import fluid_flops_per_iter
from insr_pde_tpu_torch.models.solver import cosine_decay_schedule

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
os.environ.setdefault("INSR_NO_COMPILATION_CACHE", "1")


def _jax_records(main, argv, monkeypatch, argv_param=True):
    """The JSON records a JAX tool prints, run through its `main`."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        if argv_param:
            main(argv)
        else:
            monkeypatch.setattr(sys, "argv", ["tool"] + argv)
            main()
    return [json.loads(line) for line in out.getvalue().splitlines()
            if line.startswith("{")]


def _quiet(main, argv):
    with contextlib.redirect_stdout(io.StringIO()):
        return main(argv)


def _covers(port, jax_recs):
    assert len(port) == len(jax_recs)
    for p, j in zip(port, jax_recs):
        assert set(j) <= set(p), sorted(set(j) - set(p))


@pytest.mark.parametrize("tool", [overhead_probe, width_probe,
                                  coherence_probe, plateau_probe,
                                  hashgrid_probe, vortex_train_probe])
def test_tools_default_to_the_card(tool):
    """Each entry point defaults to --device cuda and raises without a
    card, through `ops/precision.resolve_device`."""
    assert tool.parser().parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            _quiet(tool.main, [])


def test_overhead_probe_keys_match_the_jax_tool(monkeypatch):
    import tools.overhead_probe as jtool
    port = _quiet(overhead_probe.main, ["--device", "cpu", "--iters", "3",
                                        "--sr", "8", "--reps", "2",
                                        "--trace_iters", "2"])
    jax_recs = _jax_records(jtool.main, ["--platform", "cpu", "--iters", "3",
                                         "--sr", "8"], monkeypatch,
                            argv_param=False)
    _covers(port, jax_recs)
    assert [r["variant"] for r in port] == [r["variant"] for r in jax_recs]
    assert all(r["n"] == 2 and r["ms_per_iter_min"] <= r["ms_per_iter"]
               for r in port)


def test_width_probe_keys_and_routes(monkeypatch):
    import tools.width_probe as jtool
    port = _quiet(width_probe.main, ["--device", "cpu", "--widths", "8,160",
                                     "--iters", "2", "--sr", "4"])
    jax_recs = _jax_records(jtool.main, ["--platform", "cpu", "--widths",
                                         "8,160", "--iters", "2", "--sr",
                                         "4"], monkeypatch, argv_param=False)
    _covers(port, jax_recs)
    assert [r["route"] for r in port] == ["kernel", "chain"]
    # CPU tensors launch no kernel; the chain route counts every iteration
    # of the timed loops
    assert port[0]["chain_routes"] == 0 and port[1]["chain_routes"] == 6
    assert all(r["vgl_forward_launches"] == 0 for r in port)


def test_width_probe_flops_are_the_bench_pressure_term(tmp_path):
    """At 3x32 and -sr 128, the probe's FLOPs per iteration equal the
    bench's pressure term as the bench computes it."""
    run = width_probe.WidthRun(32, 128, "cpu", str(tmp_path))
    m = run.model
    widths_v = [2] + [32] * 4 + [2]
    bench = fluid_flops_per_iter(widths_v, widths_v[:-1] + [1], m.n_samples,
                                 m.n_boundary)["solve_pressure"]
    assert width_probe.pressure_flops(m) == bench == 1993940096


def test_coherence_probe_keys_match_the_jax_tool():
    """The JAX tool has no size flag (its 8x operator is 875 MB of
    values): its record's keys are read from its source, and the port's
    probe runs at a tiny shape through its functions."""
    src = open(os.path.join(REPO, "tools", "coherence_probe.py")).read()
    keys = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Dict) and any(
                isinstance(k, ast.Constant) and k.value == "probe"
                for k in node.keys):
            keys |= {k.value for k in node.keys}
    assert keys == {"probe", "layout", "rows", "pair_scanned_ms"}
    dev = torch.device("cpu")
    vals, x, layouts = coherence_probe.operands(1, 7, dev, rows0=64,
                                                slots=6, bdim=4,
                                                n_blocks=30)
    assert set(layouts) == set(coherence_probe.LAYOUTS)
    for cols in layouts.values():
        A, build_s = coherence_probe.build(vals, cols, dev, 30)
        rec = {"probe": "coherence", "layout": "x", "rows": 64,
               **coherence_probe.pair_ms(A, x, 2, dev),
               "transpose_build_s": build_s}
        assert keys <= set(rec) and rec["n"] == 2
        # the chain is s + eps A^T A s
        s = x + 0.5 * A.rmv(A.mv(x))
        dense = torch.zeros((64, 30 * 4))
        for r in range(64):
            for k in range(6):
                c = int(cols[r, k])
                dense[r, c * 4:(c + 1) * 4] += vals[r, k]
        torch.testing.assert_close(s, x + 0.5 * dense.T @ (dense @ x),
                                   rtol=1e-5, atol=1e-4)
    # sorted0 is random's rows sorted by their first column
    assert torch.equal(layouts["sorted0"][:, 0],
                       torch.sort(layouts["random"][:, 0]).values)


PLATEAU_TINY = ["--sr", "16", "--hidden", "16", "--candidates", "ref",
                "--chunk", "10", "--max_iters", "30", "--host_rng"]


def test_plateau_ref_matches_the_jax_probe_on_the_same_draws():
    """`ref` at 30 iterations a fit (3x16, -sr 16): the port on the CPU and
    the JAX tool on its draws and init agree on the setup's advect loss
    and the candidate's best and final loss within rtol 1e-3 (the fluid
    phase-fit bar of test_torch_fluid.py), with the same iterations; the
    records carry the JAX tool's keys."""
    from probes_reference_jax import run_plateau
    with contextlib.redirect_stdout(io.StringIO()):
        rec = run_plateau(PLATEAU_TINY)
    port, jax_recs = rec["port_cpu"], rec["jax"]
    _covers(port, jax_recs)
    np.testing.assert_allclose(port[0]["advect_final"],
                               jax_recs[0]["advect_final"], rtol=1e-3)
    for key in ("best", "final", "tail_mean"):
        np.testing.assert_allclose(port[1][key], jax_recs[1][key], rtol=1e-3)
    assert port[1]["iters"] == jax_recs[1]["iters"] == 30


def test_plateau_candidates_see_the_same_draws(tmp_path):
    """Two candidates with the same schedule give the same fit: each starts
    from the same generator state."""
    args = plateau_probe.parser().parse_args(
        ["--device", "cpu", "--sr", "8", "--hidden", "8", "--chunk", "10",
         "--max_iters", "20"])
    model, _ = plateau_probe.setup(args, str(tmp_path))
    state = model.generator.get_state()
    a = plateau_probe.run_candidate(model, "ref", state, 10, 20)
    b = plateau_probe.run_candidate(model, "ref", state, 10, 20)
    assert a["best"] == b["best"] and a["final"] == b["final"]
    assert list(plateau_probe.CANDIDATES) == [
        "ref", "p1500", "t0", "f5p300", "f5p100", "f5p300x3", "lr3e4",
        "lr1e3", "lr1e3f5"]


def test_hashgrid_probe_keys_match_the_jax_tool():
    import tools.hashgrid_probe as jtool
    for net in ("siren", "hashgrid"):
        port = hashgrid_probe.run_one(net, 1, 5, "cpu", host_rng=True)
        ref = jtool.run_one(net, 1, 5)
        _covers([port], [ref])
        assert port["iters_per_step_run"] == [5]
        assert port["route"] == ("advect_fit" if net == "siren"
                                 else "solver")


VORTEX_TINY = ["--train_iters", "4", "--segment", "2", "--n_spatial_basis",
               "25", "--time_num", "3", "--collocation", "64", "--boundary",
               "32", "--lr_min", "1e-3", "--compare_matrix"]


def test_vortex_train_probe_keys_match_the_jax_tool():
    import tools.vortex_train_probe as jtool
    port = _quiet(vortex_train_probe.main, VORTEX_TINY + ["--device", "cpu"])
    jax_recs = _jax_records(jtool.main, VORTEX_TINY + ["--platform", "cpu"],
                            None)
    _covers(port, jax_recs)
    assert [r.get("path") for r in port[-3:-1]] == ["train", "matrix"]
    assert port[-3]["lr_min"] == 1e-3


def test_cosine_schedule_matches_optax():
    """Every step within rtol 1e-6, or 1e-7 of lr where the f32 cosine
    near pi rounds apart (3e-9 at one step of 40)."""
    lr, steps, lr_min = 0.1, 40, 1e-3
    ours = cosine_decay_schedule(lr, steps, alpha=lr_min / lr)
    ref = optax.cosine_decay_schedule(lr, steps, alpha=lr_min / lr)
    for t in range(steps + 5):
        np.testing.assert_allclose(
            float(ours(torch.tensor(t, dtype=torch.int32))), float(ref(t)),
            rtol=1e-6, atol=1e-7 * lr)


def test_scheduled_train_matches_optax_adam():
    """`VortexModel.train` with the schedule takes optax.adam(schedule)'s
    steps on the same gradients."""
    from insr_pde_tpu_torch.models.vortex import VortexConfig, VortexModel
    cfg = VortexConfig(n_spatial_basis=25, time_num=3, collocation_pts_num=64,
                       boundary_num=32, train_lr=0.1)
    m = VortexModel(cfg, log=False, device="cpu")
    m.lr_schedule = cosine_decay_schedule(0.1, 5, alpha=0.01)
    opt = optax.adam(optax.cosine_decay_schedule(0.1, 5, alpha=0.01))
    u = m.params.u.detach().clone()
    state = opt.init(u.numpy())
    for _ in range(6):
        ut = u.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(m.residual_loss(ut), ut)
        upd, state = opt.update(g.numpy(), state, u.numpy())
        u = u + torch.from_numpy(np.array(upd))
        m.train(1)
        torch.testing.assert_close(m.params.u, u, rtol=1e-5, atol=1e-6)


TG_LOG = """{"config": "fluid"}
{"t": 0, "rel_l2": 0.0008, "amp": 1.0, "sec": 3.1}
not json
{"t": 1, "rel_l2": 0.0021, "amp": 0.999, "sec": 2.9}
{"t": 2, "rel_l2": 0.0035, "amp": 0.998, "sec": 3.0}
{"t": 3, "rel_l2": 0.0009, "sec": 3.3}
{"t": 10, "rel_l2": 0.02, "amp": 0.95, "sec": 2.8}
{"summary": {"t": 99}}
"""


@pytest.mark.parametrize("wanted", [[], ["0", "2", "3", "10", "7"]])
def test_tg_milestones_prints_what_the_jax_tool_prints(tmp_path, wanted):
    log = tmp_path / "run.log"
    log.write_text(TG_LOG)
    ref = subprocess.run([sys.executable, os.path.join(REPO, "tools",
                                                       "tg_milestones.py"),
                          str(log)] + wanted, capture_output=True, text=True,
                         timeout=120)
    assert ref.returncode == 0, ref.stderr
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tg_milestones.main([str(log)] + wanted)
    assert out.getvalue() == ref.stdout


def test_overhead_adam_and_the_solver_chunk_end_at_the_same_parameters(
        tmp_path):
    """From the same draws and parameters, before the scheduler fires, the
    `adam` loop and the Solver's own chunk give the same parameters; the
    loops without an update leave them where they were."""
    model, solver, params, aux = overhead_probe.build("pressure", 8, 12,
                                                      "cpu", str(tmp_path),
                                                      hidden=8)
    runs = overhead_probe.variants(model, solver, params, aux)
    flat_a, _ = runs["adam"](12)
    flat_f, state = runs["full_solver_chunk"](12)
    assert float(state.plateau.scale) == 1.0 and not bool(
        state.plateau.stopped)
    torch.testing.assert_close(flat_a, flat_f, rtol=1e-5, atol=0)
    flat_g, _ = runs["grad_rng"](3)
    assert not torch.equal(flat_a, flat_g)


@pytest.mark.parametrize("path", ["train", "matrix"])
def test_vortex_block_bars_hold_each_block_to_its_own_size(path, capsys):
    """The probes phase's vortex block bars (`chip_smoke.PROBE_RTOL`): JAX's
    own blocks pass; a held block moved past its bar relative to its own
    size fails, however small the block; a block left out is printed."""
    import chip_smoke as cs
    ref = cs.PROBE_VORTEX_TRAIN_JAX[f"{path}_blocks"]
    bars = cs.PROBE_RTOL["vortex_train"][f"{path}_blocks"]
    cs._paired_blocks("t", path, dict(ref), ref, bars)
    free, out = set(ref) - set(bars), capsys.readouterr().out
    assert free and all(f"{k} {ref[k]:.6g} (JAX" in out for k in free)
    smallest = min((k for k in bars if ref[k]), key=lambda k: ref[k])
    moved = {**ref, smallest: ref[smallest] * (1 + 2 * bars[smallest])}
    with pytest.raises(RuntimeError, match="miss their bar"):
        cs._paired_blocks("t", path, moved, ref, bars)

