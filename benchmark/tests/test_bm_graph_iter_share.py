"""The `graph_iter_share` reader: `replay` spans over `iter` spans in the
traced step, and nothing where the run recorded no step or no graph."""

import pytest


def _span_totals(**kw):
    return {name: dict(zip(("calls", "total_ns", "child_ns", "syncs"), v))
            for name, v in kw.items()}


@pytest.mark.parametrize("totals,expected", [
    # every iteration a replay
    (_span_totals(timestep=(1, 400e6, 380e6, 0), fit=(3, 380e6, 300e6, 0),
                  iter=(300, 300e6, 10e6, 0), replay=(300, 10e6, 0, 0)),
     100.0),
    # the first of each of three keys eager, then replays
    (_span_totals(timestep=(1, 400e6, 380e6, 0), fit=(3, 380e6, 300e6, 0),
                  iter=(300, 300e6, 10e6, 0), replay=(297, 10e6, 0, 0),
                  sample=(3, 1e6, 0, 0)),
     99.0),
    # a program that issues no graph: nothing to read
    (_span_totals(timestep=(1, 400e6, 380e6, 0), fit=(3, 380e6, 300e6, 0),
                  iter=(300, 300e6, 30e6, 0), sample=(300, 30e6, 0, 0)),
     None),
    # no timestep span
    (_span_totals(iter=(300, 300e6, 10e6, 0), replay=(300, 10e6, 0, 0)),
     None),
])
def test_bm_graph_iter_share(monkeypatch, totals, expected):
    from benchmark.metrics import graph_iter_share
    from insr_pde_tpu_torch.utils import tracing
    snap = {"totals": totals, "spans": [], "dropped": 0,
            "clock": "time.time_ns"}
    monkeypatch.setattr(tracing, "snapshot", lambda: snap)
    got = graph_iter_share.read({"trace": {"iters": 300}})
    assert got == (None if expected is None else pytest.approx(expected))
    assert graph_iter_share.read({"trace": None}) is None
