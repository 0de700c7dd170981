#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port on one NVIDIA card.

    python3 chip_smoke.py          # from the repo root; needs one CUDA card

Phases (each raises on failure, so the script exits non-zero and prints no
result line):
  1. device: the card's name and `nvidia-smi` name/power limit;
  2. build: every CUDA kernel of the port, one nvcc per source, in parallel;
  3. kernels against their plain PyTorch versions on the card, at the JAX
     pins and at the main path's shapes, with max abs error and median
     times: the fused SIREN forward (also at elasticity's shapes: 3->128
     (3 hidden) ->3 at 43,937 rows, the lucy scene's history nets on 8,000
     volume points + 35,937 vertices; 2->68->2 at 20,000 rows, the 2D
     collide scene; 3->66->3 at 43,937 rows, the bunny and spot widths;
     within 5e-5), and the fused value+gradient+Laplacian
     forward and backward (random cotangents on all three outputs, and the
     L-only cotangents of the pressure loss); two runs of each forward, and
     of the backward for each cotangent kind, must give the same bits at
     every shape; then the pressure phase's
     gradient program at 16,384 points through the kernel pair against the
     plain chain and autograd;
  4. main path: `python -m insr_pde_tpu_torch fluid` (split timestep, SIREN
     3x32, -sr 128 = 16,384 points per Adam iteration, T=2) in-process,
     with the kernel launch counters set to 0 just before and read just
     after; checks finite fields, the t=0 fit against analytic Taylor-Green,
     the output files, and that every kernel of the path was launched;
  5. second path: the same entry point with `--fluid_step merged2
     --advect_trace rk2 --advect_sobolev 0.3` (the bootstrap step at t=1,
     one trapezoidal step at t=2), counters set to 0 just before and read
     just after; checks finite fields, every kernel of the path launched,
     and velocity rel L2 and amplitude against analytic Taylor-Green at
     t = 0, 1 and 2;
  6. advection kernel: the advect Adam fit (`advect_fit`, one launch per
     chunk) against its plain eager loop on the same point tables and
     starting state, at the JAX pin (2x20, 128 + 16 points, 60 iterations),
     at the main path's shape (5,000 + 50 points, one chunk of 250) and with
     a patience that makes the early-stop latch fire inside the chunk; two
     runs of each case must give the same bits; the main chunk is also
     timed with the --debug_nan column, which must flag a NaN point's
     iteration and every iteration of a NaN parameter as the plain loop
     does;
  7. advection path: `python -m insr_pde_tpu_torch advection` (the flags of
     scripts/advect1D.sh, SIREN 2x20, -sr 5000, T=3) in-process, counters
     set to 0 just before and read just after; checks the launches per
     step, finite fields, the outputs, and the field's rel L2 against the
     analytic solution at every t;
  8. trace: the device busy share of each step phase of the fluid paths
     and of the advect phase (fused and eager) under torch.profiler (short
     extra fits, outside the paths' counts);
  9. vortex default path: `python -m insr_pde_tpu_torch vortex` at
     starterL.py's defaults (velocity formulation, 1,000 + 400 points x 10
     slices, 400 x 16 basis, 3 Picard iterations of 2,000 Jacobi CGLS
     iterations) in-process, counters set to 0 just before and read just
     after; checks a finite residual, the field's shape, and that both
     block-ELL kernels launched at least once per CGLS iteration; prints
     the relative divergence;
 10. vortex channel path: `vortex --preset channel --picard_iters 3`
     (scripts/vortex_channel.sh: stream formulation, 8,000 + 3,200 points x
     10 slices, block-whitened chunked CGLS), counters as above; checks the
     inlet error (bar 1e-2), a finite field with max |u| <= 100, and the
     launches; prints the per-Picard timings;
 11. block-ELL kernels against their plain versions and the cuSPARSE
     product (`torch.sparse` CSR, the yardstick) at the TPU kernel's scalar
     ELL shape (J = 1, R 35,600, NNZ 768, 192,000 columns, random) and on
     the channel path's assembled operator (R 243,210, S 12, J 16), two
     runs of each giving the same bits, with rmv also timed at other chunk
     sizes of its plan, and mv also with every x gather an L1 hit (what
     the gathers from L2 cost);
 12. trace: one 200-iteration CGLS chunk of each vortex path's system
     under torch.profiler (outside the paths' counts);
 13. elasticity 3D path: `python -m insr_pde_tpu_torch elasticity` with the
     flags of scripts/elasticity3Dlucy.sh (SIREN 3x128, -sr 20, -vr 10000,
     the published lr, dt and energies) on the lucy-scale stand-in
     (`geometry/procedural.statue_tet_mesh(32)`: 35,937 vertices, 163,840
     tets, written by the port's `write_medit`), cut to T=4 and ELA_ITERS
     Adam iterations per fit, in-process, counters set to 0 just before and
     read just after; checks finite fields and points, the outputs of every
     t, at least two siren_forward launches per Adam iteration of the step
     fits, the centroid's fall, and z_min and z_mean per t against the JAX
     package's runs of the same cut (mean of 6 seeds, bar 2x their spread
     at that t); at t=4 the drop reaches the plane z = -2, so the last fit
     holds the collision term against JAX's too;
 14. elasticity 2D path: the flags of scripts/elasticity2Dcollide.sh
     (SIREN 3x68, -sr 100, sphere collision) cut the same way; checks the
     centroid y's fall after the impulse, and the centroid y and the circle
     penetration per t against the JAX runs in the same way;
 15. recap: `python -m insr_pde_tpu_torch.recap elasticity` on the 3D
     path's run directory; every re-rendered tNNN_deformation.ply equals
     the training run's byte for byte;
 16. trace: the elasticity step phase of both paths under torch.profiler
     (outside the paths' counts);
 17. one JSON line of kernel records, the nvidia-smi line, and the last
     line {"ok": true, "device": {...}}. siren_forward's record is the lucy
     shape, its launches those of the elasticity 3D path.

It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data-sheet peaks (dense, no sparsity): FP32 outside the tensor
# cores, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

T_STEPS = 2
MAX_ITERS = 500
# t=0 velocity after MAX_ITERS Adam iterations against analytic Taylor-Green
# on the -vr grid: the JAX package reaches 3.6e-2 at this budget (CPU run of
# the same config), the port 3.8e-2 on the CPU at -sr 64. 0.1 leaves room
# for the other point draws and still fails a fit that did not converge.
# The merged2 path is held to the same bar at t = 0, 1 and 2.
TG_REL_L2_BAR = 0.1
# The split pressure phase's device events per Adam iteration through the
# eager forward-Laplacian chain and autograd, before the fused kernel pair
# took its place (PERF.md section 5)
EAGER_CHAIN_PRESSURE_EVENTS = 633.3

FLUID_ARGS = ["fluid", "--init_cond", "taylorgreen", "--num_hidden_layers",
              "3", "--hidden_features", "32", "-sr", "128", "-vr", "128",
              "--dt", "0.05", "-T", str(T_STEPS), "--max_n_iters",
              str(MAX_ITERS), "--chunk_size", "250", "--no_backup"]
MERGED2_ARGS = ["--fluid_step", "merged2", "--advect_trace", "rk2",
                "--advect_sobolev", "0.3"]
# the kernels of the fluid paths and their least launches per run
FLUID_KERNELS = {"siren_forward": T_STEPS + 1, "siren_vgl_forward": 1,
                 "siren_vgl_backward": 1}

# The JAX pins of the value+gradient+Laplacian kernels (d, m, hidden layers,
# width, N) (tools/experiments/test_pallas_vgl.py), the pressure phase's
# shape, and the same at width 128.
VGL_SHAPES = [("pin_300x2_w32", 2, 1, 3, 32, 300),
              ("pin_64x2_w16_m2", 2, 2, 2, 16, 64),
              ("pin_130x1_w20", 1, 1, 2, 20, 130),
              ("pin_32x3_w24_m2", 3, 2, 1, 24, 32),
              ("pressure_16384", 2, 1, 3, 32, 16384),
              ("w128_16384", 2, 1, 3, 128, 16384)]
VGL_MAIN_SHAPE = "pressure_16384"
# Tolerances of the JAX pins, |kernel - plain| <= atol + rtol |plain|:
# forward (tools/experiments/test_pallas_vgl.py:37-42), backward with random
# cotangents on all outputs (:67-73) and with the L-only cotangents of the
# pressure loss (:102-106).
VGL_FWD_TOL = {"u": (1e-5, 1e-5), "J": (1e-5, 1e-4), "L": (1e-4, 2e-3)}
VGL_BWD_TOL = (1e-4, 5e-3)
VGL_BWD_L_ONLY_TOL = (5e-3, 1e-3)

# The advection path: scripts/advect1D.sh (SIREN 2x20, -sr 5000 = 5,000
# collocation and 50 boundary points per Adam iteration) cut to T=3 and
# ADV_ITERS Adam iterations per fit (the script runs T=240 at up to 20,000).
ADV_STEPS = 3
ADV_ITERS = 3000
ADV_CHUNK = 250
ADV_ARGS = ["advection", "--init_cond", "example1", "--num_hidden_layers",
            "2", "--hidden_features", "20", "-sr", "5000", "--dt", "0.05",
            "-T", str(ADV_STEPS), "--max_n_iters", str(ADV_ITERS),
            "--chunk_size", str(ADV_CHUNK), "--no_backup"]
# Field rel L2 against the analytic solution on the -vr 500 grid at every t
# (ADV_REL_L2_JAX: the JAX package at the same config and budget on the
# CPU, `python main.py advection ... -T 3 --max_n_iters 3000`, t = 0..3).
# The bar is 3x the largest of them: another point draw moves the fit by
# less, a fit that did not converge or a wrong term by far more.
ADV_REL_L2_JAX = (2.18e-3, 1.97e-3, 2.02e-3, 2.10e-3)
ADV_REL_L2_BAR = 6.5e-3
ADV_WIDTHS = [1, 20, 20, 20, 1]
# The advect fit's cases (name, N, NB, iterations, patience, rel threshold):
# the JAX pin (tools/experiments/test_pallas_trainer.py:19-20), the main
# path's chunk, and a patience and threshold that make the early-stop latch
# fire inside the chunk. Tolerances: the pin's, loss history rtol 2e-3 and
# params atol 5e-5 (:76-81), and equal `active` flags.
ADV_CASES = [("pin_128+16_60it", 128, 16, 60, 500, 1e-4),
             ("main_5000+50_250it", 5000, 50, ADV_CHUNK, 500, 1e-4),
             ("latch_128+16_60it", 128, 16, 60, 2, 0.9)]
ADV_MAIN_CASE = "main_5000+50_250it"
ADV_HIST_RTOL = 2e-3
ADV_PARAM_ATOL = 5e-5


# The vortex paths: starterL.py's defaults, and its channel preset at 3
# Picard iterations (scripts/vortex_channel.sh). Bars on the channel path:
# the inlet error, the repo's acceptance bar (COMPARISON.md:968-969; the JAX
# package read 2.97e-3 at this config, COMPARISON.md:1005-1006), and max |u|
# on the sampled field (the JAX package: 23.8).
VORTEX_ARGS = ["vortex", "--n_rounds", "1"]
CHANNEL_ARGS = ["vortex", "--preset", "channel", "--picard_iters", "3"]
INLET_ERROR_BAR = 1e-2
MAX_U_BAR = 100.0
# The last lstsq residual of each vortex path with the earlier block-ELL
# kernels (PERF.md section 6): the present mv sums each row in another
# order, so the residuals may move in their last digits.
RESIDUAL_EARLIER = {"vortex_default": 26.677, "vortex_channel": 1.0415}
# block-ELL kernel checks: |kernel - plain| <= bar * max |plain| (the sums
# run in another order; rmv's run over ~300 slots per block)
BLOCK_ELL_BARS = {"block_ell_mv": 1e-5, "block_ell_rmv": 1e-4}
# the TPU kernel's scalar ELL shape (tools/experiments/pallas_spmv.py:15-17)
ELL_SHAPE = (35600, 768, 192000)
# slots per chunk of the rmv plan, timed beside the default
RMV_CHUNK_SWEEP = (64, 128, 256, 512, 1024)

# The elasticity paths: scripts/elasticity3Dlucy.sh (SIREN 3x128, -sr 20 =
# 8,000 volume points + every vertex per Adam iteration, -vr 10000) on the
# lucy-scale stand-in, and scripts/elasticity2Dcollide.sh (SIREN 3x68, -sr
# 100 = 10,000 random + 10,000 grid points; the init fit at the reference's
# 500^2 + 500^2), each cut to T=ELA_STEPS and ELA_ITERS Adam iterations per
# fit (the scripts run T=20 at up to 20,000). Widths, point counts, lr, dt
# and energies as published. At T=4 the 3D drop reaches the plane at z = -2,
# so its collision term is at work in the last fit. The JAX reference runs
# (tests/elasticity_reference_jax.py) take these lists as they are.
ELA_STEPS = 4
ELA_ITERS = 300
ELA_MESH_N = 32          # statue_tet_mesh(32): 35,937 vertices, 163,840 tets
ELA_PLANE = -2.0
ELA_3D_ARGS = ["elasticity", "--num_hidden_layers", "3", "--hidden_features",
               "128", "-sr", "20", "-vr", "10000", "-T", str(ELA_STEPS),
               "--dt", "0.1", "--max_n_iters", str(ELA_ITERS), "--lr",
               "1e-4", "--dim", "3", "--energy", "arap", "kinematics",
               "collision", "external", "volume", "--ratio_volume", "1e3",
               "--ratio_arap", "1e3", "--ratio_collide", "1e6",
               "--ratio_kinematics", "1e0", "-f_ext_x", "0", "-f_ext_y", "0",
               "-f_ext_z=-2e1", "-T_ext", "10", "--plane_height",
               str(ELA_PLANE), "--use_mesh", "1", "--early_stop",
               "--no_backup"]
ELA_2D_ARGS = ["elasticity", "--num_hidden_layers", "3", "--hidden_features",
               "68", "-sr", "100", "-vr", "100", "-T", str(ELA_STEPS),
               "--dt", "0.1", "--max_n_iters", str(ELA_ITERS), "--lr",
               "1e-5", "--dim", "2", "--energy", "arap", "kinematics",
               "collision_sphere", "external", "volume", "--ratio_volume",
               "1e3", "--ratio_arap", "2e1", "--ratio_collide", "1e4",
               "--ratio_kinematics", "1e1", "-f_ext_x", "0", "-f_ext_y=-2e2",
               "-T_ext", "2", "--early_stop", "--no_backup"]
# The JAX package at the same cut on a CPU, seeds 0-5
# (`python tests/elasticity_reference_jax.py 3d|2d`, PERF.md section 6):
# per quantity and t = 0..ELA_STEPS, the mean over the seeds and their
# spread (max - min). The port's value at each t must lie within 2x that
# t's spread of that t's mean. The 3D fit at t=4, the first in contact
# with the plane, spreads ~25x wider over the seeds than those before it.
ELA_3D_JAX = {
    "z_min": ((-1.161975, -1.255353, -1.454716, -1.75446, -1.968614),
              (0.003604, 0.003179, 0.003423, 0.003427, 0.08608)),
    "z_mean": ((-0.08441902, -0.1841616, -0.3839114, -0.6836644,
                -0.8970536),
               (0.003198, 0.003364, 0.003533, 0.003703, 0.08871)),
}
ELA_2D_JAX = {
    "centroid_y": ((-2.931183e-05, -0.08543724, -0.2396635, -0.3653672,
                    -0.4647207),
                   (8.682e-05, 0.006354, 0.01823, 0.02926, 0.03935)),
    "penetration": ((0, 0.009386999, 0.01569503, 0.01011736, 0.007997869),
                    (0, 0.01137, 0.004588, 0.003203, 0.001631)),
}
# the width-128 bar of phase_kernels, also held by the elasticity paths'
# last output against the plain forward of the final field
ELA_SIREN_ATOL = 5e-5


def _median_ms(fn, reps: int) -> float:
    """Device time of one call of fn: 20 calls are captured in a CUDA graph
    (so the host's launch overhead leaves no gaps between them), the graph
    is replayed `reps` times between CUDA events, and the median replay
    time over 20 is returned."""
    import torch
    inner = 20
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    times.sort()
    return times[len(times) // 2]


def _siren_bound_ms(widths, n):
    """Least time for the fused SIREN forward on n points: the larger of
    bytes (coords in, params in, output out, each once) over the memory rate
    and operations over the FP32 rate. Operations per point: 2 per
    multiply-add, 1 per bias add, and per hidden unit 1 for the omega scale
    and 1 for the sine (a lower bound: a precise sinf is ~20 instructions)."""
    layers = list(zip(widths[:-1], widths[1:]))
    n_param = sum(fi * fo + fo for fi, fo in layers)
    bytes_ = 4 * (n * widths[0] + n * widths[-1] + n_param)
    hidden = sum(fo for _, fo in layers[:-1])
    ops_pt = sum(2 * fi * fo + fo for fi, fo in layers) + 2 * hidden
    return _bound(n * ops_pt, bytes_)


def _vgl_layers(widths):
    return list(zip(widths[:-1], widths[1:]))


def _vgl_fwd_ops_per_row(widths):
    """Operations per row of the forward: d + 2 products with every weight
    (2 per multiply-add), the bias add, and per hidden unit the omega scale,
    sin and cos, w cos, d products for J, 2 d for Q and 3 for L."""
    d = widths[0]
    layers = _vgl_layers(widths)
    hidden = sum(fo for _, fo in layers[:-1])
    return (sum((d + 2) * 2 * fi * fo + fo for fi, fo in layers)
            + hidden * (7 + 3 * d))


def _bound(ops, bytes_):
    t_bytes = bytes_ / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes else "bytes")


def _vgl_fwd_bound_ms(widths, n):
    """Least time of the value+gradient+Laplacian forward on n rows: coords
    and params in, u, J, L out, each once; operations as counted above."""
    d, m = widths[0], widths[-1]
    n_param = sum(fi * fo + fo for fi, fo in _vgl_layers(widths))
    bytes_ = 4 * (n * d + n_param + n * (2 * m + d * m))
    return _bound(n * _vgl_fwd_ops_per_row(widths), bytes_)


def _vgl_bwd_bound_ms(widths, n):
    """Least time of its backward: the forward's operations (recomputed),
    twice the products again (the weight gradients and the cotangents times
    W^T), per hidden unit ~10 + 4 d for the reverse rules, and one add per
    parameter for each 64-row partial sum. Bytes: coords, cotangents and
    params in, weight gradients and gx out."""
    d, m = widths[0], widths[-1]
    layers = _vgl_layers(widths)
    n_param = sum(fi * fo + fo for fi, fo in layers)
    hidden = sum(fo for _, fo in layers[:-1])
    products = sum((d + 2) * 2 * fi * fo for fi, fo in layers)
    ops = (n * (_vgl_fwd_ops_per_row(widths) + 2 * products
                + hidden * (10 + 4 * d)) + n_param * -(-n // 64))
    bytes_ = 4 * (n * d + n * (2 * m + d * m) + 2 * n_param + n * d)
    return _bound(ops, bytes_)


def _vgl_check(name, got, ref, rtol, atol):
    """Max abs error; raises where |got - ref| > atol + rtol |ref| or got is
    not finite."""
    import torch
    err = (got - ref).abs()
    if not torch.isfinite(got).all() or (err > atol + rtol * ref.abs()).any():
        raise RuntimeError(f"[kernel] {name}: max abs err "
                           f"{err.max().item():.3e} beyond rtol {rtol:.0e} / "
                           f"atol {atol:.0e} (or non-finite output)")
    return err.max().item()


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA card")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"[device] {name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; nvidia-smi: {smi}", flush=True)
    return name, smi


def phase_build():
    from insr_pde_tpu_torch.ops import cuda_build
    tic = time.perf_counter()
    logs = cuda_build.build(["siren_forward", "siren_vgl", "advect_fit",
                             "block_ell"])
    print(f"[build] {time.perf_counter() - tic:.1f}s "
          f"(nvcc {' '.join(cuda_build.NVCC_FLAGS)})", flush=True)
    for name, text in logs.items():
        for line in text.strip().splitlines():
            print(f"[build] {name}: {line}")


def phase_kernels():
    """The fused SIREN kernel against its plain version at the JAX pins,
    the fluid paths' shapes and elasticity's: two runs the same bits, within
    each case's atol; median times and the bound. Returns the record at the
    lucy scene's shape."""
    import torch
    from insr_pde_tpu_torch.models.networks import MLP
    from insr_pde_tpu_torch.ops.sampling import sample_uniform
    from insr_pde_tpu_torch.ops.siren_forward import (
        launch, pack_params, siren_forward, siren_forward_reference)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def rand_coords(n, d, half=1.0):
        u = torch.rand((n, d), generator=gen, device=dev)
        return (u * 2.0 - 1.0) * half

    grid128 = sample_uniform(128, 2, device=dev).contiguous()
    grid500 = sample_uniform(500, 2, device=dev).contiguous()
    # (name, net, coords, atol). 2e-5 is the JAX package's pin tolerance
    # (tests/test_pallas_siren.py). Width 128 over 5 hidden layers: 128-term
    # f32 sums in another order than the plain version's matmul, each
    # layer's rounding (~1e-6) scaled by up to omega = 30 through the next
    # sine; 5e-5 keeps a factor ~10 over that estimate. Elasticity's shapes
    # (coords in [-2, 2]): the lucy scene's history nets (8,000 volume
    # points + 35,937 vertices), the 2D collide scene's (10,000 + 10,000),
    # the bunny and spot widths.
    cases = [
        ("pin_300x2_w32", MLP(2, 2, 3, 32), rand_coords(300, 2), 2e-5),
        ("pin_517x3_w20", MLP(3, 1, 2, 20), rand_coords(517, 3), 2e-5),
        ("fluid_vr128_16384", MLP(2, 2, 3, 32), grid128, 2e-5),
        ("fluid_vr500_250000", MLP(2, 2, 3, 32), grid500, 2e-5),
        ("w128_l5_16384", MLP(2, 2, 5, 128), rand_coords(16384, 2), 5e-5),
        ("lucy_3x128_43937", MLP(3, 3, 3, 128), rand_coords(43937, 3, 2.0),
         ELA_SIREN_ATOL),
        ("collide_2x68_20000", MLP(2, 2, 3, 68), rand_coords(20000, 2, 2.0),
         ELA_SIREN_ATOL),
        ("spot_3x66_43937", MLP(3, 3, 3, 66), rand_coords(43937, 3, 2.0),
         ELA_SIREN_ATOL),
    ]
    record = None
    for name, net, x, atol in cases:
        params = net.init(gen)
        out = siren_forward(params, x)
        again = siren_forward(params, x)
        torch.cuda.synchronize()
        ref = siren_forward_reference(params, x)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        if not torch.isfinite(out).all() or err > atol:
            raise RuntimeError(f"[kernel] {name}: max abs err {err:.3e} > "
                               f"atol {atol:.0e} (or non-finite output)")
        if not torch.equal(out, again):
            raise RuntimeError(f"[kernel] siren_forward {name}: two runs "
                               "differ")
        packed, widths = pack_params(params)
        buf = torch.empty_like(out)
        ms = _median_ms(lambda: launch(packed, widths, x, buf), reps=15)
        plain_ms = _median_ms(lambda: siren_forward_reference(params, x),
                              reps=15)
        bound_ms, bound_by = _siren_bound_ms(widths, x.shape[0])
        torch.cuda.synchronize()
        print(f"[kernel] siren_forward {name}: N={x.shape[0]} widths="
              f"{widths} max_abs_err={err:.3e} (atol {atol:.0e}), two runs "
              f"the same bits; kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.5f} "
              f"ms ({bound_by})", flush=True)
        if name == "lucy_3x128_43937":
            record = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by}
    return record


def phase_vgl_kernels():
    """The fused value+gradient+Laplacian kernels against their plain
    versions at every shape of VGL_SHAPES. Returns the forward's and the
    backward's records at the pressure phase's shape."""
    import torch
    from insr_pde_tpu_torch.models.networks import MLP
    from insr_pde_tpu_torch.ops.siren_forward import pack_params
    from insr_pde_tpu_torch.ops.siren_vgl import (
        backward_scratch, launch_backward, launch_forward,
        siren_vgl_backward_reference, siren_vgl_reference)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    records = {}
    for name, d, m, layers, width, n in VGL_SHAPES:
        params = MLP(d, m, layers, width).init(gen)
        x = torch.rand((n, d), generator=gen, device=dev) * 2.0 - 1.0
        packed, widths = pack_params(params)
        outs = [torch.empty(s, device=dev) for s in ((n, m), (n, d, m), (n, m))]
        launch_forward(packed, widths, x, *outs)
        again = [torch.empty_like(t) for t in outs]
        launch_forward(packed, widths, x, *again)
        torch.cuda.synchronize()
        ref = siren_vgl_reference(params, x)
        fwd_errs = {k: _vgl_check(f"siren_vgl_forward {name} {k}", got, r,
                                  *VGL_FWD_TOL[k])
                    for k, got, r in zip("uJL", outs, ref)}
        if not all(torch.equal(a, b) for a, b in zip(outs, again)):
            raise RuntimeError(f"[kernel] siren_vgl_forward {name}: two runs "
                               "differ")

        # random cotangents on all three outputs, scaled by min(1, 300 / n)
        # so that the weight gradients' sums keep the magnitude of the pins
        # (N = 300) whose tolerance they are held to; and the L-only
        # cotangents of the pressure loss mean((L - target)^2)
        scale = min(1.0, 300.0 / n)
        cots = [torch.randn(t.shape, generator=gen, device=dev) * scale
                for t in outs]
        target = torch.sin(3.0 * x[:, :1]) * torch.cos(2.0 * x[:, -1:])
        l_only = [torch.zeros_like(outs[0]), torch.zeros_like(outs[1]),
                  2.0 * (ref[2] - target) / n]
        scratch = backward_scratch(widths, x)
        gp = torch.empty_like(packed)
        gx = torch.empty_like(x)
        bwd_errs = {}
        for label, cot, tol in (("random", cots, VGL_BWD_TOL),
                                ("L-only", l_only, VGL_BWD_L_ONLY_TOL)):
            launch_backward(packed, widths, x, *cot, scratch, gp, gx)
            torch.cuda.synchronize()
            g_ref, gx_ref = siren_vgl_backward_reference(params, x, *cot)
            gp_ref = torch.cat([t.reshape(-1) for wb in g_ref for t in wb])
            bwd_errs[label] = max(
                _vgl_check(f"siren_vgl_backward {name} {label} gparams", gp,
                           gp_ref, *tol),
                _vgl_check(f"siren_vgl_backward {name} {label} gx", gx,
                           gx_ref, *tol))
            gp1, gx1 = gp.clone(), gx.clone()
            launch_backward(packed, widths, x, *cot, scratch, gp, gx)
            torch.cuda.synchronize()
            if not (torch.equal(gp, gp1) and torch.equal(gx, gx1)):
                raise RuntimeError(f"[kernel] siren_vgl_backward {name} "
                                   f"{label}: two runs differ")

        fwd_ms = _median_ms(lambda: launch_forward(packed, widths, x, *outs),
                            reps=15)
        fwd_plain = _median_ms(lambda: siren_vgl_reference(params, x), reps=15)
        bwd_ms = _median_ms(lambda: launch_backward(packed, widths, x, *cots,
                                                    scratch, gp, gx), reps=15)
        bwd_plain = _median_ms(
            lambda: siren_vgl_backward_reference(params, x, *cots), reps=15)
        fwd_bound, fwd_by = _vgl_fwd_bound_ms(widths, n)
        bwd_bound, bwd_by = _vgl_bwd_bound_ms(widths, n)
        torch.cuda.synchronize()
        print(f"[kernel] siren_vgl_forward {name}: N={n} widths={widths} "
              "max_abs_err " + " ".join(f"{k} {v:.3e}" for k, v in
                                        fwd_errs.items())
              + f", two runs the same bits; kernel {fwd_ms:.4f} ms, plain {fwd_plain:.4f} ms, bound "
              f"{fwd_bound:.5f} ms ({fwd_by})", flush=True)
        print(f"[kernel] siren_vgl_backward {name}: N={n} widths={widths} "
              f"blocks={scratch.shape[0]} max_abs_err random "
              f"{bwd_errs['random']:.3e} L-only {bwd_errs['L-only']:.3e}, "
              f"two runs the same bits; kernel {bwd_ms:.4f} ms, plain {bwd_plain:.4f} ms, bound "
              f"{bwd_bound:.5f} ms ({bwd_by})", flush=True)
        if name == VGL_MAIN_SHAPE:
            records["siren_vgl_forward"] = {
                "max_abs_err": max(fwd_errs.values()), "ms": fwd_ms,
                "plain_ms": fwd_plain, "bound_ms": fwd_bound,
                "bound_by": fwd_by}
            records["siren_vgl_backward"] = {
                "max_abs_err": max(bwd_errs.values()), "ms": bwd_ms,
                "plain_ms": bwd_plain, "bound_ms": bwd_bound,
                "bound_by": bwd_by}
    return records


def phase_pressure_program(reps: int = 20):
    """The pressure phase's gradient program (tools/perf_probe.py:220-224):
    loss = mean(L^2) + mean(u^2) + mean(J^2) of the 3x32 pressure net at
    16,384 points, then its parameter gradient, through `siren_vgl` (the
    kernel pair) and through the plain chain with autograd, in this call:
    device time (CUDA graph of the program) and eager wall time per call."""
    import torch
    from insr_pde_tpu_torch.models.networks import MLP
    from insr_pde_tpu_torch.ops.forward_laplacian import value_grad_laplacian
    from insr_pde_tpu_torch.ops.siren_vgl import siren_vgl

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    params = [(w.requires_grad_(True), b.requires_grad_(True))
              for w, b in MLP(2, 1, 3, 32).init(gen)]
    leaves = [t for wb in params for t in wb]
    x = torch.rand((16384, 2), generator=gen, device=dev) * 2.0 - 1.0

    def program(chain):
        def run():
            u, J, L = chain(params, x)
            loss = torch.mean(L ** 2) + torch.mean(u ** 2) + torch.mean(J ** 2)
            return torch.autograd.grad(loss, leaves)
        return run

    grads = {name: program(chain)() for name, chain in
             (("kernels", siren_vgl), ("plain", value_grad_laplacian))}
    err = max(_vgl_check(f"pressure program grad {i}", got, ref,
                         *VGL_BWD_L_ONLY_TOL)
              for i, (got, ref) in enumerate(zip(grads["kernels"],
                                                 grads["plain"])))
    out = {}
    for name, chain in (("plain", value_grad_laplacian), ("kernels", siren_vgl),
                        ("kernels2", siren_vgl), ("plain2", value_grad_laplacian)):
        run = program(chain)
        device_ms = _median_ms(run, reps=15)
        run()
        torch.cuda.synchronize()
        tic = time.perf_counter()
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - tic) / reps * 1e3
        out[name] = (device_ms, wall_ms)
    k = [out["kernels"], out["kernels2"]]
    p = [out["plain"], out["plain2"]]
    print(f"[kernel] pressure gradient program, 16,384 points, 3x32 (order "
          f"plain, kernels, kernels, plain): kernel pair device "
          f"{k[0][0]:.4f}/{k[1][0]:.4f} ms, eager wall {k[0][1]:.4f}/"
          f"{k[1][1]:.4f} ms; plain chain + autograd device {p[0][0]:.4f}/"
          f"{p[1][0]:.4f} ms, eager wall {p[0][1]:.4f}/{p[1][1]:.4f} ms; "
          f"grad max abs err {err:.3e}", flush=True)


def _run_fluid(tag, extra):
    return _run_entry(tag, FLUID_ARGS + extra)


def _run_entry(tag, args):
    """One run of the port's entry point with every kernel's launch count
    set to 0 just before and read just after. Returns (counts, model,
    results dir, wall seconds)."""
    import torch
    from insr_pde_tpu_torch.__main__ import main
    from insr_pde_tpu_torch.ops.advect_fit import advect_fit
    from insr_pde_tpu_torch.ops.siren_forward import siren_forward
    from insr_pde_tpu_torch.ops.siren_vgl import siren_vgl

    # the CLI's default project dir (ignored by git), inside the checkout
    proj_dir = os.path.join(REPO, "checkpoints", "chip_smoke")
    shutil.rmtree(os.path.join(proj_dir, tag), ignore_errors=True)
    argv = args + ["--proj_dir", proj_dir, "--tag", tag]
    siren_forward.launches = 0
    siren_vgl.fwd_launches = 0
    siren_vgl.bwd_launches = 0
    advect_fit.launches = 0
    # the entry point prints its whole config; keep its progress lines
    log = io.StringIO()
    tic = time.perf_counter()
    try:
        with contextlib.redirect_stdout(log):
            model = main(argv)
        torch.cuda.synchronize()
    finally:
        for line in log.getvalue().splitlines():
            if line.startswith(("timestep:", "note:", "built ")):
                print(f"[{tag}] {line}")
    wall = time.perf_counter() - tic
    counts = {"siren_forward": siren_forward.launches,
              "siren_vgl_forward": siren_vgl.fwd_launches,
              "siren_vgl_backward": siren_vgl.bwd_launches,
              "advect_fit": advect_fit.launches}

    for name, params in model.fields.items():
        for w, b in params:
            if not (torch.isfinite(w).all() and torch.isfinite(b).all()):
                raise RuntimeError(f"[{tag}] field {name} is not finite")
    return counts, model, os.path.join(proj_dir, tag), wall


def _check_outputs(tag, exp_dir):
    """Every timestep's output files, finite (128, 128, 2) velocity grids, and
    the last checkpoint."""
    import numpy as np
    from insr_pde_tpu_torch.utils import viz
    results = os.path.join(exp_dir, "results")
    suffixes = [".npy"]
    if viz.available():
        suffixes += ["_vel.png", "_mag.png", "_curl.png"]
    else:
        print(f"[{tag}] matplotlib is not installed here: write_output saved "
              "the .npy fields and no PNG figures")
    for t in range(T_STEPS + 1):
        for suffix in suffixes:
            path = os.path.join(results, f"t{t:03d}{suffix}")
            if not os.path.exists(path):
                raise RuntimeError(f"[{tag}] missing output {path}")
        u = np.load(os.path.join(results, f"t{t:03d}.npy"))
        if u.shape != (128, 128, 2) or not np.isfinite(u).all():
            raise RuntimeError(f"[{tag}] t{t:03d}.npy: shape {u.shape} or "
                               "non-finite values")
    ckpt = os.path.join(exp_dir, "model", f"ckpt_step_t{T_STEPS:03d}.npz")
    if not os.path.exists(ckpt):
        raise RuntimeError(f"[{tag}] missing checkpoint {ckpt}")
    return results


def _check_launches(tag, counts, least):
    """Every kernel of the path (the keys of `least`) launched at least that
    often in the path's run."""
    for name, n_least in least.items():
        if counts[name] < n_least:
            raise RuntimeError(f"[{tag}] {name} launched {counts[name]} times "
                               f"on this path, expected >= {n_least}")
    print(f"[{tag}] kernel launches on this path: {json.dumps(counts)}",
          flush=True)


def _print_phase_times(tag, model, wall, extra_desc):
    print(f"[{tag}] wall {wall:.2f}s for T={T_STEPS} (init + {T_STEPS} "
          f"{extra_desc} steps, {MAX_ITERS} Adam iterations per fit)")
    for rec in model.phase_timings:
        print(f"[{tag}] t={rec['timestep']} {rec['tag']:22s} "
              f"{rec['n_iters']} iters {rec['sec']:.3f}s "
              f"{rec['sec'] / max(rec['n_iters'], 1) * 1e3:.4f} ms/iter")
    steady = {}
    for rec in model.phase_timings:
        if rec["timestep"] >= 2 or rec["tag"] == "initialize":
            steady.setdefault(rec["tag"], []).append(
                rec["sec"] / max(rec["n_iters"], 1) * 1e3)
    print(f"[{tag}] ms per Adam iteration by phase (t=0 init; t=2 for the "
          "step phases): " + json.dumps(
              {k: round(sum(v) / len(v), 4) for k, v in steady.items()}))


def _tg_metrics(u, tg):
    """Velocity rel L2 and best-fit amplitude of the exact mode."""
    import numpy as np
    rel = float(np.linalg.norm(u - tg) / np.linalg.norm(tg))
    amp = float(np.sum(u * tg) / np.sum(tg * tg))
    return rel, amp


def phase_main_path():
    """The port's main path (split) through its entry point; returns the
    kernel launch counts of this run and the model."""
    import numpy as np
    from insr_pde_tpu_torch.models.examples import taylorgreen_velocity
    from insr_pde_tpu_torch.ops.sampling import sample_uniform
    from insr_pde_tpu_torch.ops.siren_forward import siren_forward_reference

    counts, model, exp_dir, wall = _run_fluid("fluid_split", [])
    results = _check_outputs("main", exp_dir)

    grid = sample_uniform(128, 2, flatten=False)
    tg = taylorgreen_velocity(grid, rescale=True).numpy()
    u0 = np.load(os.path.join(results, "t000.npy"))
    rel0, _ = _tg_metrics(u0, tg)
    print(f"[main] t=0 velocity rel L2 vs analytic Taylor-Green: {rel0:.4e} "
          f"(bar {TG_REL_L2_BAR})", flush=True)
    if not rel0 < TG_REL_L2_BAR:
        raise RuntimeError("[main] the t=0 fit misses the Taylor-Green bar")

    # the last output went through the kernel; it must equal the plain
    # forward of the final field
    g = grid.to(model.device).reshape(-1, 2)
    plain = siren_forward_reference(model.fields["velocity"], g)
    u_last = np.load(os.path.join(results, f"t{T_STEPS:03d}.npy"))
    err_last = float(np.abs(u_last.reshape(-1, 2)
                            - plain.cpu().numpy()).max())
    print(f"[main] t={T_STEPS} output vs plain forward of the final field: "
          f"max abs err {err_last:.3e}")
    if not err_last < 2e-5:
        raise RuntimeError("[main] kernel output disagrees with the plain "
                           "forward of the final field")

    _print_phase_times("main", model, wall, "split")
    _check_launches("main", counts, FLUID_KERNELS)
    return counts, model


def phase_merged2_path():
    """The second path: merged2 + rk2 + sobolev through the entry point.
    Returns the kernel launch counts of this run and the model."""
    import numpy as np
    from insr_pde_tpu_torch.models.examples import taylorgreen_velocity
    from insr_pde_tpu_torch.ops.sampling import sample_uniform

    counts, model, exp_dir, wall = _run_fluid("fluid_merged2", MERGED2_ARGS)
    results = _check_outputs("merged2", exp_dir)
    tg = taylorgreen_velocity(sample_uniform(128, 2, flatten=False),
                              rescale=True).numpy()
    for t in range(T_STEPS + 1):
        rel, amp = _tg_metrics(np.load(os.path.join(results, f"t{t:03d}.npy")),
                               tg)
        print(f"[merged2] t={t} velocity rel L2 vs analytic Taylor-Green "
              f"{rel:.4e} (bar {TG_REL_L2_BAR}), amplitude {amp:.6f}",
              flush=True)
        if not rel < TG_REL_L2_BAR:
            raise RuntimeError(f"[merged2] t={t} misses the Taylor-Green bar")
    _print_phase_times("merged2", model, wall, "merged2")
    _check_launches("merged2", counts, FLUID_KERNELS)
    return counts, model


def phase_trace(split_model, merged2_model, adv_model, iters: int = 50,
                merged2_iters: int = 10):
    """Device busy share of each step phase of the fluid paths and of the
    advect phase: one more fit of `iters` Adam iterations per split phase
    (`merged2_iters` per merged2 phase, whose iterations run ~1,000 device
    and many more host events each; one chunk of ADV_CHUNK through the
    fused advect fit, and `iters` through the eager Solver on the same
    loss), from each path's final fields, under torch.profiler. Busy = the
    summed duration of the device events (one stream, so they do not
    overlap); the profiler's own host cost makes the idle share an upper
    bound, so the same fit's wall time without it is printed beside. Not
    part of the paths' launch counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from insr_pde_tpu_torch.models.advection import FusedAdvectSolver
    from insr_pde_tpu_torch.models.solver import Solver
    from insr_pde_tpu_torch.phase_trace import device_summary

    def eager(model, loss_fn, sample_fn, n):
        return Solver(loss_fn, sample_fn, lr=model.cfg.lr, max_n_iters=n,
                      chunk_size=n, early_stop=False)

    sm, mm, am = split_model, merged2_model, adv_model
    v, p = sm.fields["velocity"], sm.fields["pressure"]
    mv, mp = mm.fields["velocity"], mm.fields["pressure"]
    mq = mm.fields["pressure_prev"]
    af_field = am.fields["field"]
    fused = FusedAdvectSolver(am._advect_tables, am.advect_solver.widths,
                              dt=am.dt, vel=am.vel, lr=am.cfg.lr,
                              max_n_iters=ADV_CHUNK, chunk_size=ADV_CHUNK,
                              early_stop=False)
    phases = [
        ("advect_velocity",
         eager(sm, sm._advect_loss, sm._points_with_bc, iters), v,
         {"prev": v}, iters),
        ("solve_pressure",
         eager(sm, sm._pressure_loss, sm._points_with_bc, iters), p,
         {"vel": v}, iters),
        ("projection",
         eager(sm, sm._projection_loss, sm._points_with_bc, iters), v,
         {"prev": v, "pressure": p}, iters),
        ("solve_pressure_merged2",
         eager(mm, mm._merged_pressure_loss, mm._points_with_bc,
               merged2_iters), mp, {"prev": mv, "p_old": mq}, merged2_iters),
        ("project_advect2",
         eager(mm, mm._merged_projection_loss, mm._points_with_bc,
               merged2_iters), mv, {"prev": mv, "p_old": mq, "pressure": mp},
         merged2_iters),
        ("advection advect (fused kernel)", fused, af_field,
         {"prev": af_field}, ADV_CHUNK),
        ("advection advect (eager Solver)",
         eager(am, am._advect_loss, am._advect_points, iters), af_field,
         {"prev": af_field}, iters)]
    for tag, solver, params, aux, iters in phases:
        solver.fit(params, aux)
        torch.cuda.synchronize()
        tic = time.perf_counter()
        solver.fit(params, aux)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - tic) / iters * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            tic = time.perf_counter()
            solver.fit(params, aux)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - tic) / iters * 1e3
        events, busy_ms, by_name = device_summary(prof, iters)
        if not events:
            print(f"[trace] {tag}: not measured (the profiler recorded no "
                  f"device events); {plain_ms:.4f} ms/iter without it")
            continue
        beside = (f" (eager chain: {EAGER_CHAIN_PRESSURE_EVENTS})"
                  if tag == "solve_pressure" else "")
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:3]
        print(f"[trace] {tag}: {events:.2f} device events/iter"
              f"{beside}, device busy {busy_ms:.5f} ms/iter of {wall_ms:.5f} "
              f"ms/iter wall under the profiler ({plain_ms:.5f} without): "
              f"busy share {busy_ms / wall_ms:.3f}, idle "
              f"{1 - busy_ms / wall_ms:.3f}; largest: "
              + "; ".join(f"{k[:40]} {ms:.5f} ms/iter"
                          for k, (_, ms) in top), flush=True)


def _advect_ops_per_iter(n, nb, widths):
    """Operations of one advect Adam iteration (csrc/advect_fit.cu's note),
    2 per multiply-add: per collocation point the forward with its tangent
    through both nets (2 multiply-adds per weight each), the reverse sweep
    (2 per weight of every layer but the first) and the weight gradients (2
    per weight); per boundary point the value alone (1 per weight), its
    sweep and its weight gradients (1 each); per sine unit and evaluation
    ~6 more (bias, omega scale, sin, cos, two products); Adam ~15 per
    parameter."""
    layers = list(zip(widths[:-1], widths[1:]))
    mac = sum(a * b for a, b in layers)
    mac0 = layers[0][0] * layers[0][1]
    units = sum(b for _, b in layers[:-1])
    n_param = sum(a * b + b for a, b in layers)
    col = 2 * (2 * mac + 2 * mac + 2 * (mac - mac0) + 2 * mac) + 18 * units
    bnd = 2 * (mac + (mac - mac0) + mac) + 8 * units
    return n * col + nb * bnd + 15 * n_param


def _advect_bound_ms(n, nb, iters, widths):
    """Least time of one launch of `iters` iterations: the points read once,
    the state (params, prev, mu, nu) read and written once, the history
    written; operations as counted above."""
    n_param = sum(a * b + b for a, b in zip(widths[:-1], widths[1:]))
    bytes_ = 4 * (iters * (n + nb) + 7 * n_param + 4 * iters)
    return _bound(iters * _advect_ops_per_iter(n, nb, widths), bytes_)


def phase_advect_kernel():
    """The advect Adam fit against its plain eager loop, on the same point
    tables and starting state, at every case of ADV_CASES. Returns the
    record at the main path's chunk (times per launch of ADV_CHUNK
    iterations)."""
    import torch
    from insr_pde_tpu_torch.models.networks import MLP
    from insr_pde_tpu_torch.models.solver import ravel
    from insr_pde_tpu_torch.ops import advect_fit as af

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    half, lr = 2.0, 1e-3
    record = None
    for name, n, nb, iters, patience, thr in ADV_CASES:
        net = MLP(1, 1, 2, 20)
        p = ravel(net.init(gen))[0].contiguous()
        q = ravel(net.init(gen))[0].contiguous()
        # the TPU kernel's map from uniforms to points (pallas_trainer.py:196-199)
        x = (torch.rand((iters, n), generator=gen, device=dev) * 2 - 1) * half
        side = torch.where(torch.rand((iters, nb), generator=gen, device=dev)
                           < 0.5, -1.0, 1.0)
        xb = side * half + (torch.rand((iters, nb), generator=gen,
                                       device=dev) * 2 - 1) * 1e-4
        hp = af.AdvectFitHyper(dt=0.05, vel=0.25, lr=lr, min_scale=1e-8 / lr,
                               stop_scale=1.1e-8 / lr,
                               plateau_patience=patience,
                               plateau_threshold=thr)
        got, ref = af.init_state(p), af.init_state(p)
        hist = af.advect_fit(got, q, x, xb, ADV_WIDTHS, hp)
        torch.cuda.synchronize()
        h_ref = af.advect_fit_reference(ref, q, x, xb, ADV_WIDTHS, hp)
        torch.cuda.synchronize()
        if not torch.equal(hist[:, 0], h_ref[:, 0]) or \
                got.istate.tolist() != ref.istate.tolist():
            raise RuntimeError(f"[kernel] advect_fit {name}: active flags "
                               f"or scheduler state differ ({got.istate.tolist()}"
                               f" vs {ref.istate.tolist()})")
        again = af.init_state(p)
        if not torch.equal(af.advect_fit(again, q, x, xb, ADV_WIDTHS, hp),
                           hist) or not all(
                torch.equal(a, b) for a, b in zip(again, got)):
            raise RuntimeError(f"[kernel] advect_fit {name}: two runs differ")
        n_active = int(hist[:, 0].sum().item())
        rel = ((hist[:, 1:] - h_ref[:, 1:]).abs()
               / h_ref[:, 1:].abs()).max().item()
        err_h = _vgl_check(f"advect_fit {name} history", hist[:, 1:],
                           h_ref[:, 1:], ADV_HIST_RTOL, 0.0)
        err_p = _vgl_check(f"advect_fit {name} params", got.params,
                           ref.params, 0.0, ADV_PARAM_ATOL)

        def kernel_ms(debug_nan=False):
            out = torch.empty((iters, len(af.history_keys(debug_nan))),
                              device=dev)
            times = []
            for _ in range(7):
                s0 = af.init_state(p)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                af.launch(s0, q, x, xb, ADV_WIDTHS, hp, out)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            return sorted(times)[len(times) // 2]

        def plain_ms():
            times = []
            for _ in range(3):
                s0 = af.init_state(p)
                torch.cuda.synchronize()
                tic = time.perf_counter()
                af.advect_fit_reference(s0, q, x, xb, ADV_WIDTHS, hp)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - tic) * 1e3)
            return sorted(times)[len(times) // 2]

        k_ms, p_ms = kernel_ms(), plain_ms()
        k_nan_ms = kernel_ms(debug_nan=True)
        bound_ms, bound_by = _advect_bound_ms(n, nb, iters, ADV_WIDTHS)
        print(f"[kernel] advect_fit {name}: N={n} NB={nb} {iters} iterations "
              f"({n_active} active, istate {got.istate.tolist()}) widths "
              f"{ADV_WIDTHS}: history max rel err {rel:.3e} (abs {err_h:.3e}),"
              f" params max abs err {err_p:.3e}; per launch kernel "
              f"{k_ms:.4f} ms, plain loop {p_ms:.4f} ms, bound "
              f"{bound_ms:.5f} ms ({bound_by}); per iteration kernel "
              f"{k_ms / iters:.5f} ms, plain {p_ms / iters:.5f} ms, bound "
              f"{bound_ms / iters:.6f} ms; 2 grid barriers per iteration; "
              f"two runs gave the same bits; with the --debug_nan column "
              f"{k_nan_ms / iters:.5f} ms per iteration",
              flush=True)
        if name == ADV_MAIN_CASE:
            record = {"max_abs_err": max(err_h, err_p), "ms": k_ms,
                      "plain_ms": p_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by}

    # --debug_nan: a NaN point in iteration 7 and, in a second chunk, a NaN
    # parameter (every iteration); the kernel's `_nan` column and the other
    # columns against the plain loop's
    x, xb = x[:20].contiguous(), xb[:20].contiguous()
    x[7, 3] = float("nan")
    bad = p.clone()
    bad[5] = float("nan")
    for label, p0, expect in (("nan point", p, [float(i == 7) for i in
                                                range(20)]),
                              ("nan param", bad, [1.0] * 20)):
        got, ref = af.init_state(p0), af.init_state(p0)
        hist = af.advect_fit(got, q, x, xb, ADV_WIDTHS, hp, debug_nan=True)
        h_ref = af.advect_fit_reference(ref, q, x, xb, ADV_WIDTHS, hp,
                                        debug_nan=True)
        torch.cuda.synchronize()
        if hist[:, 2].tolist() != expect or h_ref[:, 2].tolist() != expect \
                or not torch.equal(hist[:, :2], h_ref[:, :2]) \
                or not torch.allclose(hist[:, 3:], h_ref[:, 3:],
                                      rtol=ADV_HIST_RTOL, atol=0.0,
                                      equal_nan=True):
            raise RuntimeError(f"[kernel] advect_fit --debug_nan {label}: "
                               f"the history differs from the plain loop's")
    print("[kernel] advect_fit --debug_nan: the _nan column flags the NaN "
          "point's iteration and every iteration of a NaN parameter, as the "
          "plain loop does", flush=True)
    return record


def phase_advection_path():
    """The advection path through the entry point; returns the launch counts
    of this run and the model."""
    import numpy as np
    from insr_pde_tpu_torch.ops.sampling import sample_uniform

    counts, model, exp_dir, wall = _run_entry("advection", ADV_ARGS)
    results = os.path.join(exp_dir, "results")
    vr = model.vis_resolution
    x = (sample_uniform(vr, 1) * (model.length / 2.0)).numpy()[:, 0]
    for t in range(ADV_STEPS + 1):
        path = os.path.join(results, f"t{t:03d}.npz")
        if not os.path.exists(path):
            raise RuntimeError(f"[advection] missing output {path}")
        u = np.load(path)["arr_0"]
        if u.shape != (vr,) or not np.isfinite(u).all():
            raise RuntimeError(f"[advection] t{t:03d}.npz: shape {u.shape} "
                               "or non-finite values")
        exact = np.exp(-0.5 * (x - model.vel * model.dt * t + 1.5) ** 2
                       / 0.1 ** 2)
        rel = float(np.linalg.norm(u - exact) / np.linalg.norm(exact))
        print(f"[advection] t={t} field rel L2 vs analytic "
              f"gaussian_like(x - vel dt t, mu=-1.5): {rel:.4e} (bar "
              f"{ADV_REL_L2_BAR}; JAX package on the CPU "
              f"{ADV_REL_L2_JAX[t]})", flush=True)
        if not rel < ADV_REL_L2_BAR:
            raise RuntimeError(f"[advection] t={t} misses the analytic bar")
    ckpt = os.path.join(exp_dir, "model", f"ckpt_step_t{ADV_STEPS:03d}.npz")
    if not os.path.exists(ckpt):
        raise RuntimeError(f"[advection] missing checkpoint {ckpt}")

    # one launch per chunk: ceil(iters / chunk) for a fit that ran its
    # budget, one more than the full chunks before an early stop
    chunk = model.advect_solver.chunk_size
    fits = [r for r in model.phase_timings if r["tag"] == "advect"]
    expect = sum(-(-r["n_iters"] // chunk) if r["n_iters"] >= ADV_ITERS
                 else r["n_iters"] // chunk + 1 for r in fits)
    if len(fits) != ADV_STEPS or counts["advect_fit"] != expect:
        raise RuntimeError(f"[advection] advect_fit launched "
                           f"{counts['advect_fit']} times over {len(fits)} "
                           f"advect fits, expected {expect}")
    print(f"[advection] wall {wall:.2f}s for T={ADV_STEPS} (init + "
          f"{ADV_STEPS} steps, up to {ADV_ITERS} Adam iterations per fit)")
    for rec in model.phase_timings:
        print(f"[advection] t={rec['timestep']} {rec['tag']:10s} "
              f"{rec['n_iters']} iters {rec['sec']:.3f}s "
              f"{rec['sec'] / max(rec['n_iters'], 1) * 1e3:.4f} ms/iter")
    _check_launches("advection", counts, {"advect_fit": expect})
    return counts, model


def _run_vortex(tag, args):
    """One run of the vortex entry point with the block-ELL launch counts
    set to 0 just before and read just after. Returns (counts, model,
    output dir, wall seconds, the residuals the entry point printed)."""
    import torch
    from insr_pde_tpu_torch.__main__ import main
    from insr_pde_tpu_torch.ops import block_ell

    out_dir = os.path.join(REPO, "checkpoints", "chip_smoke", tag)
    shutil.rmtree(out_dir, ignore_errors=True)
    argv = args + ["--output_path", out_dir,
                   "--log_dir", os.path.join(out_dir, "log")]
    block_ell.mv_launches = 0
    block_ell.rmv_launches = 0
    log = io.StringIO()
    tic = time.perf_counter()
    try:
        with contextlib.redirect_stdout(log):
            model = main(argv)
        torch.cuda.synchronize()
    finally:
        for line in log.getvalue().splitlines():
            if line.strip().startswith(("round:", "lstsq", "note:", "built ",
                                        "warning:")):
                print(f"[{tag}] {line.strip()}")
    wall = time.perf_counter() - tic
    counts = {"block_ell_mv": block_ell.mv_launches,
              "block_ell_rmv": block_ell.rmv_launches}
    residuals = [float(line.split(":")[1]) for line in
                 log.getvalue().splitlines() if "lstsq residual:" in line]
    if not residuals or not all(math.isfinite(v) for v in residuals):
        raise RuntimeError(f"[{tag}] lstsq residuals {residuals}: missing or "
                           "not finite")
    return counts, model, out_dir, wall, residuals


def _vortex_report(tag, model, counts, out_dir, wall):
    """Checks the field file and that each kernel launched at least once
    per CGLS iteration; prints the Picard timings. Returns the field."""
    import numpy as np
    field = np.load(os.path.join(out_dir, "field.npy"))
    r = model.cfg.vis_resolution
    expect = (model.cfg.time_num, r * r, 3)
    if field.shape != expect or not np.isfinite(field).all():
        raise RuntimeError(f"[{tag}] field.npy: shape {field.shape} (expected "
                           f"{expect}) or non-finite values")
    iters = sum(t["cgls_iters"] for t in model.picard_timings)
    print(f"[{tag}] wall {wall:.2f}s (model build, {len(model.picard_timings)}"
          f" Picard iterations, outputs); {iters} CGLS iterations")
    for t in model.picard_timings:
        print(f"[{tag}] picard {t['picard']}: assemble {t['assemble_s']}s, "
              f"whiten {t['whiten_s']}s, solve {t['solve_s']}s "
              f"({t['cgls_iters']} CGLS iterations, "
              f"{t['solve_s'] / max(t['cgls_iters'], 1) * 1e3:.4f} ms/iter), "
              f"operands {t['operand_mb']} MB")
    _check_launches(tag, counts, {"block_ell_mv": iters,
                                  "block_ell_rmv": iters})
    return field


def phase_vortex_default():
    """starterL.py's default configuration through the port's entry point."""
    from insr_pde_tpu_torch.models.vortex import relative_divergence
    counts, model, out_dir, wall, res = _run_vortex("vortex_default",
                                                    VORTEX_ARGS)
    field = _vortex_report("vortex_default", model, counts, out_dir, wall)
    print(f"[vortex_default] lstsq residual {res[-1]:.4e} (earlier mv "
          f"{RESIDUAL_EARLIER['vortex_default']}), field {field.shape}, "
          f"relative divergence {relative_divergence(model):.4f} (no bar: "
          f"the velocity formulation cannot represent an incompressible "
          f"field on this scene)", flush=True)
    return counts, model


def phase_vortex_channel():
    """The channel preset at 3 Picard iterations through the entry point."""
    import numpy as np
    from insr_pde_tpu_torch.models.vortex import (inlet_error,
                                                  relative_divergence)
    counts, model, out_dir, wall, res = _run_vortex("vortex_channel",
                                                    CHANNEL_ARGS)
    field = _vortex_report("vortex_channel", model, counts, out_dir, wall)
    inlet = inlet_error(model)
    max_u = float(np.abs(field[..., :2]).max())
    print(f"[vortex_channel] lstsq residual {res[-1]:.4e} (earlier mv "
          f"{RESIDUAL_EARLIER['vortex_channel']}), inlet error "
          f"{inlet:.4e} (bar {INLET_ERROR_BAR}),"
          f" max |u| {max_u:.3f} (bar {MAX_U_BAR}), relative divergence "
          f"{relative_divergence(model):.4e}", flush=True)
    if not inlet <= INLET_ERROR_BAR:
        raise RuntimeError("[vortex_channel] the inlet error misses its bar")
    if not max_u <= MAX_U_BAR:
        raise RuntimeError("[vortex_channel] max |u| misses its bar")
    return counts, model


def _events_ms(fn, reps: int = 7, inner: int = 10) -> float:
    """Device time of one call of fn: CUDA events around `inner` calls in a
    row, median over `reps`. No CUDA graph (as `_median_ms` takes): the
    cuSPARSE product it also times is not known to capture."""
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    times.sort()
    return times[len(times) // 2]


def _block_ell_csr(vals, cols, n_blocks):
    """The same operator and its transpose as torch.sparse CSR matrices with
    scalar columns (int32 indices), for the cuSPARSE yardstick."""
    import torch
    R, S, J = vals.shape
    dev = vals.device
    col = (cols.long()[:, :, None] * J
           + torch.arange(J, device=dev)).reshape(-1)
    crow = torch.arange(0, R * S * J + 1, S * J, device=dev)
    A = torch.sparse_csr_tensor(crow.int(), col.int(), vals.reshape(-1),
                                size=(R, n_blocks * J),
                                check_invariants=False)
    row = torch.arange(R, device=dev).repeat_interleave(S * J)
    At = torch.sparse_coo_tensor(torch.stack([col, row]), vals.reshape(-1),
                                 size=(n_blocks * J, R)).coalesce()
    At = At.to_sparse_csr()
    At = torch.sparse_csr_tensor(At.crow_indices().int(),
                                 At.col_indices().int(), At.values(),
                                 size=At.shape, check_invariants=False)
    return A, At


def _check_rmv(name, op, r):
    """block_ell_rmv on one more right-hand side against its plain version,
    within its bar."""
    import torch
    from insr_pde_tpu_torch.ops import block_ell as be
    got = be.block_ell_rmv(op.vals, op.cols, r, op.n_blocks, op.transpose(),
                           op.transposed_vals())
    ref = be.block_ell_rmv_reference(op.vals, op.cols, r, op.n_blocks)
    err = (got - ref).abs().max().item()
    bar = BLOCK_ELL_BARS["block_ell_rmv"] * ref.abs().max().item()
    print(f"[kernel] block_ell_rmv {name}: max_abs_err {err:.3e} (bar "
          f"{bar:.3e})", flush=True)
    if not torch.isfinite(got).all() or not err <= bar:
        raise RuntimeError(f"[kernel] block_ell_rmv {name}: max abs err "
                           f"{err:.3e} beyond {bar:.3e}")


def _block_ell_case(name, op, x, r):
    """Both kernels on one operator against their plain versions and the
    cuSPARSE product. Returns {kernel: record}."""
    import torch
    from insr_pde_tpu_torch.ops import block_ell as be
    vals, cols, nb = op.vals, op.cols, op.n_blocks
    R, S, J = vals.shape
    t_index = op.transpose()
    vals_t = op.transposed_vals()
    A_csr, At_csr = _block_ell_csr(vals, cols, nb)
    nnz_t = t_index.order.numel()
    # the bytes each kernel must move: mv reads every slot's vals and cols,
    # x once and writes out; rmv reads only the slots the transpose index
    # lists (the padding is left out), their vals, the index and its
    # offsets, r once and writes out, and never reads cols
    mv_bytes = 4 * (R * S * J + R * S + R + nb * J)
    rmv_bytes = 4 * (nnz_t * J + nnz_t + (nb + 1) + R + nb * J)
    runs = {
        "block_ell_mv": (lambda: be.block_ell_mv(vals, cols, x),
                         lambda: be.block_ell_mv_reference(vals, cols, x),
                         lambda: A_csr @ x, 2 * R * S * J, mv_bytes),
        "block_ell_rmv": (lambda: be.block_ell_rmv(vals, cols, r, nb,
                                                   t_index, vals_t),
                          lambda: be.block_ell_rmv_reference(vals, cols, r,
                                                             nb),
                          lambda: At_csr @ r, 2 * nnz_t * J, rmv_bytes),
    }
    records = {}
    for kname, (kernel, plain, library, ops_, bytes_) in runs.items():
        got, ref, lib = kernel(), plain(), library()
        torch.cuda.synchronize()
        scale = ref.abs().max().item()
        err = (got - ref).abs().max().item()
        lib_err = (lib - ref).abs().max().item()
        bar = BLOCK_ELL_BARS[kname] * scale
        if not torch.isfinite(got).all() or not err <= bar:
            raise RuntimeError(f"[kernel] {kname} {name}: max abs err "
                               f"{err:.3e} beyond {bar:.3e} "
                               f"({BLOCK_ELL_BARS[kname]} max |plain|)")
        if not torch.equal(got, kernel()):
            raise RuntimeError(f"[kernel] {kname} {name}: two runs differ")
        ms, plain_ms, lib_ms = (_events_ms(f) for f in (kernel, plain,
                                                        library))
        bound_ms, bound_by = _bound(ops_, bytes_)
        print(f"[kernel] {kname} {name}: R={R} S={S} J={J} n_blocks={nb} "
              f"(transpose index {nnz_t} slots) max_abs_err {err:.3e} (bar "
              f"{bar:.3e}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"cuSPARSE CSR {lib_ms:.4f} ms (err {lib_err:.3e}), bound "
              f"{bound_ms:.5f} ms ({bound_by}, {bytes_ / 1e6:.1f} MB)",
              flush=True)
        if kname == "block_ell_mv":
            # the same values with every slot in block 0: each x gather an
            # L1 hit, so the time less this one is what the gathers from L2
            # cost; at J = 1 each gather is a 32-byte L2 sector of its own
            zero = torch.zeros_like(cols)
            l1_ms = _events_ms(lambda: be.block_ell_mv(vals, zero, x))
            sectors = R * S * J * 4 / min(J * 4, 32)
            print(f"[kernel] block_ell_mv {name}: with every x gather an L1 "
                  f"hit {l1_ms:.4f} ms ({bound_ms / l1_ms:.0%} of the bound); "
                  f"the gathers from L2 cost {ms - l1_ms:.4f} ms: "
                  f"{sectors:.0f} sectors, {sectors * 32 / 1e9:.3f} GB, "
                  f"{sectors * 32 / ms / 1e9:.2f} TB/s at the kernel's time",
                  flush=True)
        records[kname] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": bound_ms, "bound_by": bound_by,
                          "library_ms": lib_ms}
    return records


def _rmv_chunk_sweep(name, op, r):
    """block_ell_rmv's time at other chunk sizes of its plan (the same
    streamed values), each within its bar; the wrapper's default is
    RMV_CHUNK."""
    import torch
    from insr_pde_tpu_torch.ops import block_ell as be
    vals_t = op.transposed_vals()
    ref = be.block_ell_rmv_reference(op.vals, op.cols, r, op.n_blocks)
    bar = BLOCK_ELL_BARS["block_ell_rmv"] * ref.abs().max().item()
    times = {}
    for chunk in RMV_CHUNK_SWEEP:
        t = be.transpose_index(op.cols, op.n_blocks, op.row_slots,
                               chunk=chunk)
        got = be.block_ell_rmv(op.vals, op.cols, r, op.n_blocks, t, vals_t)
        err = (got - ref).abs().max().item()
        if not torch.isfinite(got).all() or not err <= bar:
            raise RuntimeError(f"[kernel] block_ell_rmv {name} chunk {chunk}: "
                               f"max abs err {err:.3e} beyond {bar:.3e}")
        times[chunk] = _events_ms(lambda: be.block_ell_rmv(
            op.vals, op.cols, r, op.n_blocks, t, vals_t))
    print(f"[kernel] block_ell_rmv {name} chunk sweep (slots per chunk: ms; "
          f"default {be.RMV_CHUNK}): "
          + ", ".join(f"{c}: {ms:.4f}" for c, ms in times.items()),
          flush=True)


def phase_block_ell_kernels(channel_model):
    """The block-ELL kernels at the TPU kernel's scalar shape (random) and
    on the channel path's assembled operator. Returns the records of the
    channel operator."""
    import torch
    from insr_pde_tpu_torch.ops.linalg import BlockSparse
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(4)
    R, nnz, n_cols = ELL_SHAPE
    op = BlockSparse(torch.randn((R, nnz, 1), generator=g, device=dev),
                     torch.randint(0, n_cols, (R, nnz), generator=g,
                                   device=dev, dtype=torch.int32), n_cols)
    r = torch.randn(R, generator=g, device=dev)
    _block_ell_case("scalar_ell_35600x768", op,
                    torch.randn(n_cols, generator=g, device=dev), r)
    _rmv_chunk_sweep("scalar_ell_35600x768", op, r)
    A, b = channel_model.assemble(channel_model.params.u)
    x = torch.randn(A.n_cols, generator=g, device=dev)
    # a random r reaches every row's vals; the assembled rhs b (zero on the
    # momentum, wall and init rows) is checked as well
    r = torch.randn(A.vals.shape[0], generator=g, device=dev)
    records = _block_ell_case("channel_operator", A, x, r)
    _rmv_chunk_sweep("channel_operator", A, r)
    _check_rmv("channel_operator_rhs", A, b)
    return records


def phase_vortex_trace(models, iters: int = 200):
    """Device busy share of one CGLS chunk of `iters` iterations of each
    vortex path's system (its own preconditioner, from the solved
    coefficients), under torch.profiler, with the same chunk's wall time
    unprofiled beside."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from insr_pde_tpu_torch.ops.linalg import cgls_sparse_chunked
    from insr_pde_tpu_torch.phase_trace import device_summary
    for tag, model in models.items():
        A, b = model.assemble(model.params.u)
        precond = model._precondition()
        x0 = model.params.u.reshape(-1) * model.cfg.warm_start

        def chunk():
            return cgls_sparse_chunked(A, b, x0, maxiter=iters, tol=0.0,
                                       chunk=iters, precondition=precond,
                                       damp=model.cfg.cgls_damp,
                                       whitener=model._whitener)

        chunk()
        torch.cuda.synchronize()
        tic = time.perf_counter()
        _, info = chunk()
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - tic) / iters * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            tic = time.perf_counter()
            chunk()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - tic) / iters * 1e3
        events, busy_ms, by_name = device_summary(prof, iters)
        if not events:
            print(f"[trace] {tag} CGLS: not measured (the profiler recorded "
                  f"no device events); {plain_ms:.5f} ms/iter without it")
            continue
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:5]
        print(f"[trace] {tag} CGLS chunk ({info['niter']} iterations, "
              f"precondition {precond}): {events:.2f} device "
              f"events/iter, device busy {busy_ms:.5f} ms/iter of "
              f"{wall_ms:.5f} ms/iter wall under the profiler "
              f"({plain_ms:.5f} without): busy share "
              f"{busy_ms / plain_ms:.3f} of the unprofiled wall; largest: "
              + "; ".join(f"{k[:40]} {ms:.5f} ms/iter"
                          for k, (_, ms) in top), flush=True)


def _ela_outputs(tag, exp_dir, n_points, dim):
    """Every t's PLY and .npy points (finite, (n_points, dim)) and the last
    checkpoint; returns the points per t."""
    import numpy as np
    results = os.path.join(exp_dir, "results")
    pts = []
    for t in range(ELA_STEPS + 1):
        stem = os.path.join(results, f"t{t:03d}_deformation")
        for suffix in (".ply", ".npy"):
            if not os.path.exists(stem + suffix):
                raise RuntimeError(f"[{tag}] missing output {stem}{suffix}")
        p = np.load(stem + ".npy")
        if p.shape != (n_points, dim) or not np.isfinite(p).all():
            raise RuntimeError(f"[{tag}] t{t:03d}: points {p.shape} (expected "
                               f"{(n_points, dim)}) or non-finite values")
        pts.append(p)
    ckpt = os.path.join(exp_dir, "model", f"ckpt_step_t{ELA_STEPS:03d}.npz")
    if not os.path.exists(ckpt):
        raise RuntimeError(f"[{tag}] missing checkpoint {ckpt}")
    return pts


def _ela_stats(kind, exp_dir):
    """Per quantity, its value at every t, from the run's PLY files by the
    yardstick the JAX runs were read with (`elasticity_stats`)."""
    from insr_pde_tpu_torch.elasticity_stats import run_stats
    steps = run_stats(kind, exp_dir)
    return {key: [step[key] for step in steps] for key in steps[0]}


def _ela_against_jax(tag, stats, jax_ref):
    """Each quantity at every t within 2x that t's JAX seeds' spread of
    their mean."""
    for key, (means, spreads) in jax_ref.items():
        for t, (got, mean, spread) in enumerate(zip(stats[key], means,
                                                    spreads)):
            bar = 2.0 * spread
            ok = abs(got - mean) <= bar
            print(f"[{tag}] t={t} {key} {got:.6f}; JAX mean {mean:.6f}, "
                  f"|diff| {abs(got - mean):.3e} (bar {bar:.3e}: 2x the "
                  f"JAX seeds' spread at this t)", flush=True)
            if not ok:
                raise RuntimeError(f"[{tag}] t={t} {key} misses the JAX bar")


def _ela_run(tag, args, dim):
    """One elasticity run through the entry point; checks its fields,
    outputs, the kernel's launches (>= 2 per Adam iteration of the step
    fits, the history nets) and that the last output went through the
    kernel. Returns (launches, model, exp_dir)."""
    import numpy as np
    from insr_pde_tpu_torch.ops.siren_forward import siren_forward_reference
    counts, model, exp_dir, wall = _run_entry(tag, args)
    pts = _ela_outputs(tag, exp_dir, model.sample_vis.shape[0], dim)
    x = model.sample_vis
    plain = (siren_forward_reference(model.fields["deformation"], x)
             + x).cpu().numpy()
    err = float(np.abs(pts[-1] - plain).max())
    print(f"[{tag}] t={ELA_STEPS} output ({x.shape[0]} points) vs plain "
          f"forward of the final field: max abs err {err:.3e}")
    if not err < ELA_SIREN_ATOL:
        raise RuntimeError(f"[{tag}] kernel output disagrees with the plain "
                           "forward of the final field")
    step_iters = sum(r["n_iters"] for r in model.phase_timings
                     if r["tag"] == "solve_deformation")
    print(f"[{tag}] wall {wall:.2f}s for T={ELA_STEPS} (init + {ELA_STEPS} "
          f"steps, up to {ELA_ITERS} Adam iterations per fit)")
    for rec in model.phase_timings:
        print(f"[{tag}] t={rec['timestep']} {rec['tag']:18s} "
              f"{rec['n_iters']} iters {rec['sec']:.3f}s "
              f"{rec['sec'] / max(rec['n_iters'], 1) * 1e3:.4f} ms/iter")
    _check_launches(tag, counts, {"siren_forward": 2 * step_iters})
    return counts, model, exp_dir


def phase_elasticity_3d():
    """The lucy scene (scripts/elasticity3Dlucy.sh) on the lucy-scale
    stand-in, cut to T=ELA_STEPS and ELA_ITERS Adam iterations per fit (the
    only cuts; widths, -sr, -vr, lr, dt and energies as published)."""
    from insr_pde_tpu_torch.geometry import statue_tet_mesh, write_medit
    mesh = os.path.join(REPO, "checkpoints", "chip_smoke", "statue.mesh")
    os.makedirs(os.path.dirname(mesh), exist_ok=True)
    V, T = statue_tet_mesh(ELA_MESH_N)
    write_medit(mesh, V, {"tetra": T})
    counts, model, exp_dir = _ela_run(
        "elasticity3D", ELA_3D_ARGS + ["--mesh_path", mesh], 3)
    stats = _ela_stats("3d", exp_dir)
    for t in range(1, ELA_STEPS + 1):
        if not stats["z_mean"][t] < stats["z_mean"][t - 1]:
            raise RuntimeError(f"[elasticity3D] the centroid's z did not "
                               f"fall at t={t}: {stats['z_mean']}")
    print(f"[elasticity3D] {len(V)} vertices, {len(T)} tets; centroid z per "
          f"t {[round(z, 6) for z in stats['z_mean']]} (falls at every t)")
    # The drop alone (steps of 0.1, 0.2, 0.3, 0.4) takes z_min to about
    # -2.15 at t=4; the plane holds it above -2.05 (the JAX package's six
    # seeds: -1.998 to -1.912).
    z_end = stats["z_min"][-1]
    if not z_end >= ELA_PLANE - 0.05:
        raise RuntimeError(f"[elasticity3D] z_min {z_end:.6f} at t="
                           f"{ELA_STEPS} is more than 0.05 below the plane z "
                           f"= {ELA_PLANE}: the collision term did not hold")
    print(f"[elasticity3D] t={ELA_STEPS} z_min {z_end:.6f}: the plane z = "
          f"{ELA_PLANE} holds the drop")
    _ela_against_jax("elasticity3D", stats, ELA_3D_JAX)
    return counts, model, exp_dir


def phase_elasticity_2d():
    """The 2D collide scene (scripts/elasticity2Dcollide.sh), cut in the
    same way."""
    counts, model, exp_dir = _ela_run("elasticity2D", ELA_2D_ARGS, 2)
    stats = _ela_stats("2d", exp_dir)
    y = stats["centroid_y"]
    if not all(y[t] < y[0] for t in range(1, ELA_STEPS + 1)):
        raise RuntimeError(f"[elasticity2D] the centroid's y did not fall "
                           f"after the impulse: {y}")
    print(f"[elasticity2D] centroid y per t {[round(v, 6) for v in y]} (below "
          f"t=0 after the impulse); circle penetration per t "
          f"{[round(v, 6) for v in stats['penetration']]}")
    _ela_against_jax("elasticity2D", stats, ELA_2D_JAX)
    return counts, model


def phase_recap(exp_dir):
    """`python -m insr_pde_tpu_torch.recap elasticity` on the 3D path's run
    directory at its -vr: every re-rendered PLY equals the training run's
    byte for byte (fixed-seed output points, the kernel's bits)."""
    from insr_pde_tpu_torch.recap import main as recap_main
    proj_dir, tag = os.path.split(exp_dir)
    shutil.rmtree(os.path.join(exp_dir, "recap"), ignore_errors=True)
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        recap_main(["elasticity", "--proj_dir", proj_dir, "--tag", tag,
                    "-vr", "10000"])
    for t in range(ELA_STEPS + 1):
        name = f"t{t:03d}_deformation.ply"
        with open(os.path.join(exp_dir, "results", name), "rb") as f:
            ref = f.read()
        path = os.path.join(exp_dir, "recap", name)
        if not os.path.exists(path):
            raise RuntimeError(f"[recap] missing {path}")
        with open(path, "rb") as f:
            if f.read() != ref:
                raise RuntimeError(f"[recap] {name} differs from the "
                                   "training run's")
    print(f"[recap] {ELA_STEPS + 1} PLY files re-rendered from the "
          "checkpoints, each byte-equal to the training run's", flush=True)


def phase_elasticity_trace(models, iters: int = 30):
    """Device busy share of the elasticity step phase of each path: one
    more fit of `iters` Adam iterations from the final fields (the history
    nets the t-1 and t-2 fields, the external force on), under
    torch.profiler, with the same fit's wall time without it beside."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from insr_pde_tpu_torch.models.solver import Solver
    from insr_pde_tpu_torch.phase_trace import device_summary
    for tag, model in models.items():
        solver = Solver(model._deformation_loss, model._step_points,
                        lr=model.cfg.lr, max_n_iters=iters, chunk_size=iters,
                        early_stop=False)
        params = model.fields["deformation"]
        aux = {"prev": model.fields["deformation_prev"],
               "prev_prev": model.fields["deformation_prev_prev"],
               "external": True}
        solver.fit(params, aux)
        torch.cuda.synchronize()
        tic = time.perf_counter()
        solver.fit(params, aux)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - tic) / iters * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            tic = time.perf_counter()
            solver.fit(params, aux)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - tic) / iters * 1e3
        events, busy_ms, by_name = device_summary(prof, iters)
        if not events:
            print(f"[trace] {tag} solve_deformation: not measured (the "
                  f"profiler recorded no device events); {plain_ms:.4f} "
                  "ms/iter without it")
            continue
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:4]
        print(f"[trace] {tag} solve_deformation: {events:.2f} device "
              f"events/iter, device busy {busy_ms:.5f} ms/iter of "
              f"{wall_ms:.5f} ms/iter wall under the profiler ({plain_ms:.5f}"
              f" without): busy share {busy_ms / wall_ms:.3f} (of the "
              f"unprofiled wall {busy_ms / plain_ms:.3f}); largest: "
              + "; ".join(f"{k[:40]} {ms:.5f} ms/iter"
                          for k, (_, ms) in top), flush=True)


def _timed(name, fn, *args):
    tic = time.perf_counter()
    out = fn(*args)
    print(f"[time] {name}: {time.perf_counter() - tic:.1f}s", flush=True)
    return out


def main() -> int:
    tic = time.perf_counter()
    name, smi = phase_device()
    import torch
    from insr_pde_tpu_torch.ops.precision import set_full_precision
    set_full_precision()
    _timed("build", phase_build)
    siren_record = _timed("siren_forward kernel", phase_kernels)
    records = _timed("vgl kernels", phase_vgl_kernels)
    records["siren_forward"] = siren_record
    _timed("pressure program", phase_pressure_program)
    records["advect_fit"] = _timed("advect_fit kernel", phase_advect_kernel)
    counts, split_model = _timed("main path", phase_main_path)
    _, merged2_model = _timed("merged2 path", phase_merged2_path)
    adv_counts, adv_model = _timed("advection path", phase_advection_path)
    _timed("trace", phase_trace, split_model, merged2_model, adv_model)
    _, default_model = _timed("vortex default path", phase_vortex_default)
    vortex_counts, channel_model = _timed("vortex channel path",
                                          phase_vortex_channel)
    records.update(_timed("block_ell kernels", phase_block_ell_kernels,
                          channel_model))
    _timed("vortex trace", phase_vortex_trace,
           {"vortex_default": default_model, "vortex_channel": channel_model})
    ela_counts, ela3_model, ela3_dir = _timed("elasticity 3D path",
                                              phase_elasticity_3d)
    _, ela2_model = _timed("elasticity 2D path", phase_elasticity_2d)
    _timed("recap", phase_recap, ela3_dir)
    _timed("elasticity trace", phase_elasticity_trace,
           {"elasticity3D": ela3_model, "elasticity2D": ela2_model})
    # each kernel's launches from the run of its own path: the elasticity
    # 3D path for siren_forward (its record is the lucy shape), the fluid
    # split main path for the vgl pair, the advection path for advect_fit,
    # the vortex channel path for the block-ELL pair
    launches = {**counts, "siren_forward": ela_counts["siren_forward"],
                "advect_fit": adv_counts["advect_fit"], **vortex_counts}
    sources = {
        "siren_forward": ("insr_pde_tpu_torch/csrc/siren_forward.cu",
                          "insr_pde_tpu/ops/pallas_siren.py:38"),
        "siren_vgl_forward": ("insr_pde_tpu_torch/csrc/siren_vgl.cu",
                              "tools/experiments/pallas_vgl.py:134"),
        "siren_vgl_backward": ("insr_pde_tpu_torch/csrc/siren_vgl.cu",
                               "tools/experiments/pallas_vgl.py:143"),
        "advect_fit": ("insr_pde_tpu_torch/csrc/advect_fit.cu",
                       "tools/experiments/pallas_trainer.py:142"),
        "block_ell_mv": ("insr_pde_tpu_torch/csrc/block_ell.cu",
                         "tools/experiments/pallas_spmv.py:46"),
        # no TPU kernel: the JAX package's BlockSparse.rmv segment_sum
        "block_ell_rmv": ("insr_pde_tpu_torch/csrc/block_ell.cu",
                          "insr_pde_tpu/ops/linalg.py:486"),
    }
    kernels = [{
        "name": kname,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches[kname],
        "max_abs_err": records[kname]["max_abs_err"],
        "ms": records[kname]["ms"],
        "plain_ms": records[kname]["plain_ms"],
        "bound_ms": records[kname]["bound_ms"],
        "bound_by": records[kname]["bound_by"],
        "library_ms": records[kname].get("library_ms"),
    } for kname, (source, replaces) in sources.items()]
    print(f"[done] {time.perf_counter() - tic:.1f}s in all")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
