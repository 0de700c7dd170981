"""The comparison that decides `correct`, driven through the rest of a run
on the CPU at a tiny size with each cell's own limits: the program's plain
CPU path agrees with the reference; the control (the reference in TF32 in
the program's place) and each fault planted in the program's timed path
come out not correct.

At this size the lucy stand-in falls too little in its one window step to
reach the plane, as the cell's t = 2 does not: so lucy's step here is
compared as a fit without contact, held to every limit but that of
`contact_loss_gap`, which needs a fit in contact. The contact tests raise
the plane to -1.1, above the mesh's lowest point (-1.155), so that the
window's step is in contact from its first iteration, as t >= 4 is in the
cell."""

import dataclasses

import pytest
import torch

from benchmark.compare import verdict
from benchmark.harness import run_cell

TINY = {
    "fluid_tg.sr1024": {"sample_resolution": 32,
                        "check": {"steps": 2, "eval_resolution": 32}},
    "elasticity_lucy.mesh32_sr64": {"mesh_n": 4, "sample_resolution": 8},
}
IN_CONTACT = {"plane_height": -1.1}
ITERS = 20
SEED = 2 ** 31 + 12345
CELLS = sorted(TINY)
LUCY = "elasticity_lucy.mesh32_sr64"


def _run(cell, plant=None, modes=("program",), config=None):
    return run_cell(cell, SEED, 0.0, False, device_name="cpu",
                    workload_overrides=TINY[cell], iters=ITERS, plant=plant,
                    modes=modes, config_overrides=config)


def _limits(r, numbers):
    """The run's limits, `contact_loss_gap`'s only where a fit of the run
    was in contact."""
    return {k: v["limit"] for k, v in r["checks"].items()
            if k != "routes" and (k != "contact_loss_gap" or k in numbers)}


def _holds(r, mode="program"):
    numbers = r["readings"][mode]
    return verdict(numbers, _limits(r, numbers))


@pytest.mark.parametrize("cell", CELLS)
def test_bm_reference_agrees_with_the_plain_path(cell):
    r = _run(cell)
    assert _holds(r), r["checks"]
    assert r["correct"] == (cell != LUCY), r["checks"]
    assert r["checks"]["weights_gap"]["value"] == 0.0
    assert r["checks"]["handoff_gap"]["value"] == 0.0
    assert r["attempted"] == 1 and r["failed"] == 0


def test_bm_reference_agrees_in_contact():
    """Lucy with the plane raised: its step is compared as a fit in
    contact, and the run is correct. With the plane where the cell has it
    no fit is in contact here, there is no `contact_loss_gap`, and that
    alone is not correct."""
    r = _run(LUCY, config=IN_CONTACT)
    assert r["correct"], r["checks"]
    assert r["checks"]["contact_loss_gap"]["value"] is not None
    r = _run(LUCY)
    assert "contact_loss_gap" not in r["readings"]["program"]
    assert not r["correct"]


def test_bm_half_batch_fails_in_contact():
    r = _run(LUCY, config=IN_CONTACT, modes=("program", "half_batch"))
    limit = r["checks"]["contact_loss_gap"]["limit"]
    assert r["readings"]["program"]["contact_loss_gap"] <= limit
    assert r["readings"]["half_batch"]["contact_loss_gap"] > limit


@pytest.mark.parametrize("cell", CELLS)
def test_bm_control_is_not_correct(cell):
    r = _run(cell, modes=("program", "control"))
    assert _holds(r)
    assert not _holds(r, "control"), r["readings"]


def _unchanged(drv):
    """Every fit hands back the parameters it started from."""
    m = drv.model
    orig = m._run_phase

    def run_phase(tag, loss_fn, sample_fn, params, *a, **k):
        res = orig(tag, loss_fn, sample_fn, params, *a, **k)
        return dataclasses.replace(res, params=params)
    m._run_phase = run_phase


def _half_batch(drv):
    """Every draw's interior points cut to their first half, so that each
    loss term is the mean over the rest."""
    m = drv.model
    for name in ("_interior_points", "_points_with_bc", "_init_points",
                 "_step_points"):
        if hasattr(m, name):
            orig = getattr(m, name)

            def cut(orig=orig):
                pts = dict(orig())
                pts["x"] = pts["x"][: pts["x"].shape[0] // 2]
                return pts
            setattr(m, name, cut)


def _altered(drv):
    """Every fit's answer altered where it is produced: its last bias
    0.01 larger."""
    m = drv.model
    orig = m._run_phase

    def run_phase(*a, **k):
        res = orig(*a, **k)
        params = list(res.params)
        w, b = params[-1]
        params[-1] = (w, b + 0.01)
        return dataclasses.replace(res, params=params)
    m._run_phase = run_phase


class _Unstored(dict):
    """Fields of which one is never stored: its assignments are lost."""

    def __init__(self, fields, name):
        super().__init__(fields)
        self.name = name

    def __setitem__(self, key, value):
        if key != self.name:
            super().__setitem__(key, value)


def _not_stored(drv):
    """One field never stored: fluid's pressure (each step's pressure fit
    starts from the first weights, and the projection reads them), lucy's
    oldest history field (prev_prev is never shifted). Every fit still runs
    right from the state it reads."""
    m = drv.model
    name = "pressure" if "pressure" in m.fields else "deformation_prev_prev"
    m.fields = _Unstored(m.fields, name)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered,
                                   _not_stored],
                         ids=["unchanged", "half_batch", "altered",
                              "not_stored"])
def test_bm_fault_is_not_correct(cell, fault):
    r = _run(cell, plant=fault)
    assert not r["correct"], r["checks"]
    assert not _holds(r), r["checks"]
    if fault is _not_stored:
        # the handoff alone catches it: every compared fit still agrees
        numbers = dict(r["readings"]["program"])
        assert numbers.pop("handoff_gap") > 0.0
        assert verdict(numbers, {k: v for k, v in _limits(r, numbers).items()
                                 if k != "handoff_gap"}), r["checks"]


SMALL_CARD = {
    "fluid_tg.sr1024": {"sample_resolution": 128,
                        "check": {"steps": 2, "eval_resolution": 128}},
    "elasticity_lucy.mesh32_sr64": {"mesh_n": 8, "sample_resolution": 16},
}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_bm_control_is_not_correct_on_the_card(cell):
    """The control in the card's own TF32, at a small size."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = run_cell(cell, SEED, 0.0, False, device_name="cuda",
                 workload_overrides=SMALL_CARD[cell], iters=50,
                 modes=("program", "control"))
    assert _holds(r), r["checks"]
    assert not _holds(r, "control"), r["readings"]
