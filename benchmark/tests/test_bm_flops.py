"""The operation and byte counts against hand counts at tiny shapes, and the
roofline and MFU readers on a made-up record."""

import pytest

from benchmark.flops import elasticity_lucy_3x128 as ela
from benchmark.flops import fluid_tg_3x32 as fluid
from benchmark.flops import siren
from benchmark.metrics import (device_ops_per_iter, fit_iter_ms, idle_share,
                               step_mfu, step_overhead_ms, vgl_roofline)
from benchmark.peaks import H100_SXM


def test_bm_siren_counts_by_hand():
    w = [2, 3, 1]                     # x (2) -> 3 -> u (1)
    # forward: 2*3 + 3*1 = 9 multiply-adds; first layer 6
    assert siren.macs(w) == 9
    # trained: forward 9, weight grads 9, cotangents of the hidden layer 3
    assert siren.trained(w) == 21
    # value 9 + two tangents through the second layer (2 * 3)
    assert siren.jac_frozen(w) == 15
    assert siren.jac_trained(w) == 3 * 15 - 6
    # value 9 + tangents and Laplacian through the second layer 3 * 3
    assert siren.lap_trained(w) == 3 * (9 + 9) - 6
    assert siren.n_params(w) == 6 + 3 + 3 + 1


def test_bm_fluid_counts_by_hand():
    config = {"hidden_features": 2, "num_hidden_layers": 1}
    workload = {"sample_resolution": 20}       # n 400, nb 2 * (4 // 2) = 4
    v = [2, 2, 2, 2]                           # macs 12, m0 4
    p = [2, 2, 2, 1]                           # macs 10, m0 4
    assert siren.macs(v) == 12 and siren.macs(p) == 10
    f = fluid.iter_flops(config, workload)
    tv = 3 * 12 - 4                            # 32
    assert f["initialize"] == 2 * 400 * tv
    assert f["advect_velocity"] == 2 * (400 * (tv + 24) + 2 * 4 * tv)
    jv = 12 + 2 * 8                            # 28
    lp = 3 * (10 + 3 * 6) - 4                  # 80
    jp = 3 * (10 + 2 * 6) - 4                  # 62
    assert f["solve_pressure"] == 2 * (400 * (jv + lp) + 2 * 4 * jp)
    assert f["projection"] == 2 * (400 * (12 + (10 + 2 * 6) + tv)
                                   + 2 * 4 * tv)
    k = fluid.kernel_work(config, workload)["siren_vgl"]
    assert k["flops"] == 2 * 400 * lp
    n_par = 6 + 6 + 3
    assert k["bytes"] == 4 * (2 * n_par + 400 * 2 + 2 * 400 * 4 * 1
                              + 400 * 2)


def test_bm_elasticity_counts_by_hand():
    config = {"hidden_features": 2, "num_hidden_layers": 1}
    workload = {"sample_resolution": 3, "mesh_n": 1}   # 27 + 8 points
    w = [3, 2, 2, 3]                           # macs 6 + 4 + 6 = 16, m0 6
    f = ela.iter_flops(config, workload)
    jt = 3 * (16 + 3 * 10) - 6                 # 132
    assert f["solve_deformation"] == 2 * 35 * (jt + 2 * 16)
    assert f["initialize"] == 2 * 35 * (3 * 16 - 6)
    k = ela.kernel_work(config, workload)["siren_forward"]
    assert k["flops"] == 2 * 2 * 35 * 16
    assert k["bytes"] == 2 * 4 * (35 * 3 + siren.n_params(w) + 35 * 3)


def _record():
    return {
        "window": {"seconds": 10.0, "walls": [4.0, 6.0], "timesteps": [2, 3]},
        "fits": [{"tag": "a", "t": 2, "n_iters": 100, "sec": 3.5},
                 {"tag": "a", "t": 3, "n_iters": 100, "sec": 5.5}],
        "iter_flops": {"a": 67e9},
        "kernel_work": {"k": {"names": ["k_fwd", "k_bwd"], "phase": "a",
                              "flops": 67e9, "bytes": 1.0}},
        "peaks": H100_SXM,
        "trace": {"busy_s": 3.0, "window_s": 4.0, "device_ops": 500,
                  "iters": 100, "iters_by_tag": {"a": 100},
                  "by_name": {"void k_fwd<2>(float)": {"count": 100,
                                                       "seconds": 0.5},
                              "k_bwd": {"count": 100, "seconds": 1.5},
                              "other": {"count": 300, "seconds": 1.0}}},
    }


def test_bm_readers_on_a_made_up_record():
    r = _record()
    assert step_overhead_ms.read(r) == pytest.approx(500.0)   # (0.5 + 0.5) / 2
    assert fit_iter_ms.read(r) == pytest.approx(45.0)
    assert device_ops_per_iter.read(r) == 5.0
    assert idle_share.read(r) == pytest.approx(25.0)
    # 200 iterations of 67 GFLOP in 10 s: 1.34 TFLOP/s of 67
    assert step_mfu.read(r) == pytest.approx(2.0)
    from benchmark.metrics._kernel import roofline
    # 100 iterations of 1 ms at the FP32 peak, traced 2 s: 5%
    assert roofline(r, "k") == pytest.approx(5.0)


def test_bm_readers_read_nothing_without_a_trace():
    r = _record()
    r["trace"] = None
    assert device_ops_per_iter.read(r) is None
    assert idle_share.read(r) is None
    assert vgl_roofline.read(r) is None
    r = _record()
    r["trace"]["by_name"] = {"other": {"count": 1, "seconds": 1.0}}
    r["kernel_work"] = {"siren_vgl": r["kernel_work"]["k"]}
    assert vgl_roofline.read(r) is None
