"""PyTorch port, the Solver's CUDA graphs on the card (`cuda`-marked; they
skip without a card). The H100 machine has no JAX, which `conftest.py`
imports, so there run them as

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_solver_graph.py -q

* Fluid split (`scripts/fluid2Dtlgn.sh`: SIREN 3x32, -sr 128) and the 2D
  collide scene (`scripts/elasticity2Dcollide.sh`: SIREN 3x68, -sr 100,
  whose external force ends after t = 2, so its key flips), T = 3 at 100
  Adam iterations a fit, run with the iterations graphed and issued op by
  op: the fields, every fit's loss history, the generator's state after
  the run (the same draws) and the kernels' launch counters are equal.
* Inside graphed fluid iterations the sync counter reads 0 and every
  `iter` span holds a `replay`.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from insr_pde_tpu_torch import __main__ as cli
from insr_pde_tpu_torch.config import parse_args
from insr_pde_tpu_torch.models import solver as tsolver
from insr_pde_tpu_torch.ops.siren_forward import siren_forward
from insr_pde_tpu_torch.ops.siren_vgl import siren_vgl
from insr_pde_tpu_torch.utils import tracing

FLUID = ["fluid", "--init_cond", "taylorgreen", "--num_hidden_layers", "3",
         "--hidden_features", "32", "-sr", "128", "-vr", "32", "--dt",
         "0.05", "--max_n_iters", "100", "--chunk_size", "250"]
ELASTICITY_2D = ["elasticity", "--num_hidden_layers", "3",
                 "--hidden_features", "68", "-sr", "100", "-vr", "100",
                 "--dt", "0.1", "--max_n_iters", "100", "--lr", "1e-5",
                 "--dim", "2", "--energy", "arap", "kinematics",
                 "collision_sphere", "external", "volume", "--ratio_volume",
                 "1e3", "--ratio_arap", "2e1", "--ratio_collide", "1e4",
                 "--ratio_kinematics", "1e1", "-f_ext_x", "0",
                 "-f_ext_y=-2e2", "-T_ext", "2", "--early_stop"]
STEPS = 3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA graphs have no CPU mode")
    return torch.device("cuda")


def _counters():
    return {"vgl_fwd": siren_vgl.fwd_launches,
            "vgl_bwd": siren_vgl.bwd_launches,
            "chain_routes": siren_vgl.chain_routes,
            "forward": siren_forward.launches,
            "apply_routes": siren_forward.apply_routes}


def _run(argv, tmp_path, graphed, monkeypatch):
    """The model after its t = 0 fit and STEPS steps, every fit's history
    and the launch counters over the run."""
    if not graphed:
        monkeypatch.setattr(tsolver.Solver, "graphed",
                            lambda self, flat: False)
    cfg = parse_args([*argv, "--seed", "3", "--no_backup", "--proj_dir",
                      str(tmp_path), "--tag", f"graphed{int(graphed)}"],
                     phase="train")
    model = cli.build_model(cfg)
    cfg.setup_dirs()
    before = _counters()
    results = [model.initialize()]
    for _ in range(STEPS):
        out = model.step()
        results += list(out) if isinstance(out, tuple) else [out]
    torch.cuda.synchronize()
    counts = {k: v - before[k] for k, v in _counters().items()}
    monkeypatch.undo()
    histories = [r.history for r in results]
    return model, histories, counts


@pytest.mark.cuda
@pytest.mark.parametrize("argv", [FLUID, ELASTICITY_2D],
                         ids=["fluid_split", "elasticity_2d"])
def test_graphed_equals_eager(argv, tmp_path, cuda_device, monkeypatch):
    eager, eager_hist, eager_counts = _run(argv, tmp_path, False,
                                           monkeypatch)
    graphed, graphed_hist, graphed_counts = _run(argv, tmp_path, True,
                                                 monkeypatch)
    assert not any(s._static for s in eager._solvers.values())
    assert all(s._static for s in graphed._solvers.values())
    assert graphed_counts == eager_counts
    assert torch.equal(graphed.generator.get_state(),
                       eager.generator.get_state())
    assert len(graphed_hist) == len(eager_hist)
    for got, want in zip(graphed_hist, eager_hist):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    for name, params in eager.fields.items():
        for (w, b), (gw, gb) in zip(params, graphed.fields[name]):
            assert torch.equal(gw, w) and torch.equal(gb, b), name


@pytest.mark.cuda
def test_graphed_fluid_iterations_sync_nothing(tmp_path, cuda_device):
    cfg = parse_args([*FLUID, "--seed", "3", "--no_backup", "--proj_dir",
                      str(tmp_path)], phase="train")
    model = cli.build_model(cfg)
    cfg.setup_dirs()
    model.initialize()
    model.step()
    torch.cuda.synchronize()
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        fits = model.step()
        torch.cuda.synchronize()
    totals = tracing.snapshot()["totals"]
    iters = sum(f.n_iters for f in fits)
    assert totals["iter"]["calls"] == totals["replay"]["calls"] == iters
    assert totals["iter"]["syncs"] == 0 and "sample" not in totals
    assert totals["replay"]["syncs"] == 0
