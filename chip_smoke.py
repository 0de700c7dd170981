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
     within 5e-5; and at the path shapes of the bunny and spot scenes,
     3->66->3 at 27,683 and 12,096 rows), and the fused value+gradient+Laplacian
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
     one trapezoidal step at t=2), cut to MERGED2_ITERS Adam iterations a
     fit, counters set to 0 just before and read just after; checks finite
     fields, every kernel of the path launched, and velocity rel L2 and
     amplitude against analytic Taylor-Green at t = 0, 1 and 2;
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
     the published lr, dt and energies) and --host_rng (the card draws
     what the port's CPU run draws) on the lucy-scale stand-in
     (`geometry/procedural.statue_tet_mesh(32)`: 35,937 vertices, 163,840
     tets, written by the port's `write_medit`), cut to T=4 and ELA_ITERS
     Adam iterations per fit, in-process, counters set to 0 just before and
     read just after; checks finite fields and points, the outputs of every
     t, at least two siren_forward launches per Adam iteration of the step
     fits, the centroid's fall, and z_min and z_mean per t against the JAX
     package's runs of the same cut (mean of 6 seeds, bar 2x their spread
     at that t); then, paired, each fit's Adam iterations equal to, and
     z_min and z_mean at every t within PAIRED_BARS of, the JAX package
     run on the port's own draws (ELA_3D_PAIRED); at t=4 the drop reaches
     the plane z = -2, so the last fit holds the collision term against
     JAX's too;
 14. elasticity 2D path: the flags of scripts/elasticity2Dcollide.sh
     (SIREN 3x68, -sr 100, sphere collision) cut the same way; checks the
     centroid y's fall after the impulse, and the centroid y and the circle
     penetration per t against the JAX runs in the same way (seed bars,
     then the paired bars of ELA_2D_PAIRED);
 15. recap: `python -m insr_pde_tpu_torch.recap elasticity` on the 3D
     path's run directory; every re-rendered tNNN_deformation.ply equals
     the training run's byte for byte;
 16. trace: the elasticity step phase of both paths under torch.profiler
     (outside the paths' counts);
 17. vortex cg path: `vortex --solver cg` at starterL.py's defaults cut to
     2 Picard iterations of 100 CG iterations (batched CG on the explicit
     normal equations), counters set to 0 just before and read just after;
     checks each Picard iteration's residual against the JAX package's run
     on the same draws (PAIRED_RTOL), its CG count equal to JAX's, and at
     least two mv and two rmv launches per CG iteration;
 18. vortex train paths: `vortex --mode train` (200 Adam iterations, lr
     0.1), then `--formulation stream --mode train`; checks the loss at
     iterations 1 and 200 against the JAX package's run on the same draws
     and that it falls;
 19. vortex flags: `--preset channel --picard_iters 1` plain, with
     `--rmv_gather` and with `--packed_vals` (the JAX package's other
     operator layouts, the port's one layout here); the flagged runs'
     residual and coefficients must equal the plain run's bit for bit, and
     each run
     launches both block-ELL kernels at least once per CGLS iteration;
 20. RBF advection: `models/rbf_advection.RBFAdvectionModel` at
     tests/test_rbf_advection.py's configuration, counters set to 0 just
     before the solve and read just after; checks that test's bars, each
     error and the residual against the JAX package's run on the same
     draws, and at least one J = 1 mv and rmv launch per CGLS iteration;
 21. hash-grid advection path: `advection --network hashgrid --host_rng`
     with the flags of scripts/advect1D.sh cut to T=HASH_ADV_STEPS and
     HASH_ADV_ITERS Adam iterations per fit; checks rel L2 against the
     analytic bump at every t against the JAX package's run on the same
     draws, and the port's hash on the card against JAX's, bit for bit;
 22. trace: more vortex train iterations of both formulations and one more
     hash-grid advect fit under torch.profiler;
 23. sharded gradient (2 ranks sharing the one card, gloo): the split
     pressure phase's gradient program (3x32, 16,384 points) on 2 ranks of
     8,192 points each against the whole batch in this process (reduced
     loss and grad within SHARD_GRAD_RTOL), each rank launching the vgl
     pair; then the whole batch on a one-rank NCCL group built explicitly
     (NCCL's init and all_reduce on the card; the same bits);
 24. sharded fluid path (2 ranks sharing the one card, gloo): `fluid`
     split, 3x32, -sr 128, T=1, MAX_ITERS iterations per fit, `--n_devices
     2`, each rank's counters set to 0 just before and read just after by
     that rank; finite fields, the t=0 Taylor-Green bar, rank 0's outputs
     alone, the vgl pair on both ranks and rank 0's SIREN forward in
     write_output; ms per Adam iteration per phase beside the main path's;
 25. sharded vortex channel (2 ranks sharing the one card, gloo): each
     rank's rows of the first channel system equal the single-process
     assembly's padded slice, the block Gram summed from the shards within
     SHARD_GRAM_RTOL of the whole one, the iterate after
     SHARD_CHANNEL_ITERS block-whitened CGLS iterations within
     SHARD_ITERATE_RTOL of the single process's, with its whitener and with
     the ranks' own, then `vortex --preset channel --picard_iters 1 --n_devices
     2` (2,000 iterations) under the channel bars, mv and rmv launched at
     least once per CGLS iteration on each rank;
 26. with two or more cards, phases 23-25 again over NCCL with one rank per
     card; else one line saying they were not run and why;
 27. paper matrix: `python -m insr_pde_tpu_torch.run_experiments --smoke`
     in a process of its own (the nine published experiments at smoke
     size, all ok and exit 0), then the four published scenes no phase
     above runs (PAPER_SCENES: fluid2DtlgnM, elasticity2Dstretch,
     elasticity3Dbunny, elasticity3Dspot), each through the entry point at
     its published widths, point counts, lr and energies with --host_rng,
     cut in depth only (`paper_args`; bunny and spot on statue_tet_mesh
     stand-ins), counters set to 0 just before and read just after each:
     finite fields; the multi-scale Taylor-Green t=0 fit under the fluid
     bar against `taylorgreen_multi_velocity`, the vgl pair once per
     pressure iteration; the elasticity scenes' SIREN forward twice per
     step iteration and its last output within ELA_SIREN_ATOL of the plain
     forward; every fit's iterations and every statistic at every t held
     to the JAX package run on the port's draws (PAPER_PAIRED,
     PAIRED_BARS);
 28. vortex truth: starterL.py's default system (one Picard iteration)
     solved by scipy's f64 LSQR (block-preconditioned, products on the card
     in f64; `vortex_truth`) and by the port's f32 CGLS, CG and
     block-whitened CGLS at 2,000 iterations; prints each answer's f64
     |A x - b|, inlet error and per-block rms and its gap to the f64
     answer; LSQR must converge (istop 1 or 2) and no f32 residual may be
     below its;
 29. bench: `python -m insr_pde_tpu_torch.bench` in processes of its own,
     fluid at `--iters 500 --reps 2` and the other three workloads
     (advect1d, vortex_channel, elasticity_lucy) at their defaults; each
     must exit 0, and its last line, printed here, must carry every key
     with every `_correct` true and this card's name;
 30. probes: the JAX repo's last tools as the port's modules, each through
     its `main(argv)` at a cut (PROBE_*_ARGS), every kernel's count set to 0
     just before the phase and read just after (the vgl pair, advect_fit
     and the block-ELL pair must each launch): `overhead_probe` (pressure,
     200 iterations; then `adam` and `full_solver_chunk` from the same
     draws for PROBE_PARAM_ITERS, the scheduler not fired, at the same
     parameters within PROBE_PARAM_RTOL), `width_probe` (32 and 128 on
     the vgl pair, 256 on the forward-Laplacian chain, each gradient
     within VGL_BWD_TOL of the plain chain's), `coherence_probe` (8x; each layout's k = 1 chain on
     the kernels against the plain versions within the rmv bar), and
     `plateau_probe` (`ref`, 500 iterations a fit), `hashgrid_probe` (T=1,
     600 iterations, both networks) and `vortex_train_probe` (200
     iterations and the 3-Picard matrix path), each number held to the JAX
     repo's tool run on the port's draws (PROBE_*_JAX, PROBE_RTOL);
 31. one JSON line of kernel records, the nvidia-smi line, and the last
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

# The elasticity scenes' flags and the JAX package's per-t statistics, the
# plane's bar, the Taylor-Green bar and the analytic advection yardstick,
# shared with the bench (`python -m insr_pde_tpu_torch.bench`) so that the
# two hold the port to one copy of each.
from insr_pde_tpu_torch.yardsticks import (  # noqa: E402
    ELA_2D_ARGS, ELA_2D_JAX, ELA_3D_ARGS, ELA_3D_JAX, ELA_ITERS, ELA_MESH_N,
    ELA_PLANE, ELA_PLANE_SLACK, ELA_STEPS, TG_REL_L2_BAR, advect_rel_l2)

# H100 SXM data-sheet peaks (dense, no sparsity): FP32 outside the tensor
# cores, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

T_STEPS = 2
MAX_ITERS = 500
# The split pressure phase's device events per Adam iteration through the
# eager forward-Laplacian chain and autograd, before the fused kernel pair
# took its place (PERF.md section 5)
EAGER_CHAIN_PRESSURE_EVENTS = 633.3

FLUID_ARGS = ["fluid", "--init_cond", "taylorgreen", "--num_hidden_layers",
              "3", "--hidden_features", "32", "-sr", "128", "-vr", "128",
              "--dt", "0.05", "-T", str(T_STEPS), "--max_n_iters",
              str(MAX_ITERS), "--chunk_size", "250", "--no_backup"]
# The merged2 path at T=2 (the bootstrap step, then a trapezoidal step
# from the restored pressure), cut to MERGED2_ITERS Adam iterations a fit
# (its iterations cost 50-90 ms on the card against 7-11 for the split
# path's) to keep the script under 1,000 s with the probes phase.
MERGED2_ITERS = 400
MERGED2_ARGS = ["--fluid_step", "merged2", "--advect_trace", "rk2",
                "--advect_sobolev", "0.3", "--max_n_iters",
                str(MERGED2_ITERS)]
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

# The rest of the vortex stack. `vortex --solver cg` at starterL.py's
# defaults cut to 2 Picard iterations of 20 CG iterations (batched CG on
# the explicit normal equations: two mv and two rmv launches per CG
# iteration). f32 CG on these normal equations soon follows the summation
# order (the port and the JAX package on the same CPU draws: residual
# 62.2 and 59.3 after 2,000 iterations) and forgets its start (CG started
# at 0 rather than at A^T b reads 20% lower after 20 iterations, 5e-4
# after 100), so the check stops at 20 (PERF.md section 6); `--mode train`
# at the defaults (Adam on the coefficients, lr 0.1), in the velocity and
# the stream formulation; the channel preset at one Picard iteration,
# plain and with each of `--rmv_gather` and `--packed_vals` (flags that
# change nothing here: the flagged runs must give the plain run's bits). The JAX
# reference runs (tests/vortex_hashgrid_reference_jax.py) take these lists
# as they are.
VORTEX_CG_ARGS = ["vortex", "--solver", "cg", "--picard_iters", "2",
                  "--cgls_maxiter", "20"]
VORTEX_TRAIN_ITERS = 200
VORTEX_TRAIN_ARGS = ["vortex", "--mode", "train", "--train_iters",
                     str(VORTEX_TRAIN_ITERS)]
STREAM_TRAIN_ARGS = ["vortex", "--formulation", "stream", "--mode", "train",
                     "--train_iters", str(VORTEX_TRAIN_ITERS)]
FLAG_ARGS = ["vortex", "--preset", "channel", "--picard_iters", "1"]
FLAG_RUNS = {"plain": [], "rmv_gather": ["--rmv_gather"],
             "packed_vals": ["--packed_vals"]}
# RBFAdvectionModel at the configuration of tests/test_rbf_advection.py
# (11 slices, 800 + 100 points a slice, 400 sites, K 8 x 2 slices, J 8, up
# to 4,000 CGLS iterations, damp 0.01): one CGLS solve on a J = 1 operator,
# then the errors of that test on its 25 x 25 grid.
RBF_ADV_CFG = dict(velocity=(0.5, 0.0), time_num=11, time_length=1.0,
                   collocation_pts_num=800, boundary_num=100,
                   n_spatial_basis=400, n_feat=8, neighbor_k=8,
                   band_width=1.0, cgls_maxiter=4000, cgls_damp=0.01)
RBF_ADV_BUMP = ((-0.4, 0.0), 0.2)      # gaussian centre and width
# The hash-grid advection path: scripts/advect1D.sh with `--network
# hashgrid` (8 levels x 2 features, 2^15 tables, a 2x20 relu head), cut to
# T=HASH_ADV_STEPS and HASH_ADV_ITERS Adam iterations per fit, where the
# fits have converged (below ~2,000 iterations the init fit of some seeds
# had not: rel L2 0.03 to 0.78 at 800); the eager hash-grid advect
# iteration costs ~18-39 ms on the card, so one step, not two.
HASH_ADV_STEPS = 1
HASH_ADV_ITERS = 2400
# The JAX package on the CPU, run on the port's own draws at the seed each
# phase runs (the vortex and RBF models draw on the CPU; the hash-grid path
# runs with --host_rng): `python tests/vortex_hashgrid_reference_jax.py
# KIND`, PERF.md section 6. Each quantity of the card's run must lie within
# PAIRED_RTOL of it, relative; CG's iteration counts must equal it.
VORTEX_CG_JAX = {
    "residual": (58.19381332397461, 58.23131561279297), "cg_iters": (20, 20),
    "blocks": {"momentum_u": 0.11224930733442307,
               "momentum_v": 0.01875557377934456,
               "continuity": 0.10737233608961105,
               "free_slip": 0.023716498166322708,
               "outlet_p": 3.0065755440844555e-11,
               "inlet_u": 1.1449579000473022,
               "inlet_v": 0.04727650806307793,
               "init_var0": 1.1949833631515503, "init_var1": 0.0,
               "init_var2": 0.0}}
# the loss at iterations 1 and 200, and each residual block at the init
# coefficients
VORTEX_TRAIN_JAX = {
    "vortex_train": {"loss_first": 4988.84912109375,
                     "loss_last": 13.98719310760498,
                     "terms": (4980.68603515625, 0.0796576589345932,
                               1.4449325799942017, 1.705546498298645,
                               3.2724437713623047, 1.6604161262512207)},
    "stream_train": {"loss_first": 3778099.0,
                     "loss_last": 2851.84130859375,
                     "terms": (3778057.5, 34.258670806884766,
                               0.2905040681362152, 4.163293361663818,
                               2.7199695110321045, 0.49548956751823425)},
}
RBF_ADV_JAX = {"err0": 0.00855674549447225, "err1": 0.051230473604359235,
               "err_static": 0.21184424299676533,
               "u1_max": 0.7543439865112305, "residual": 0.03685879334807396}
HASH_ADV_JAX = (0.0010062775108963251, 0.0011528198374435306)
HASH_JAX = {2: [32440, 22786, 11447, 21699, 10087, 7339, 417, 15826],
            3: [3380, 28394, 14525, 7890, 13136, 4939, 3068, 28453]}
# The bars: each above the port's distance from JAX on the same draws on
# the CPU, and below the move of a dropped residual block (in the block
# checks) or of CG started where CGLS starts (in the cg residual); PERF.md
# section 6 gives both.
PAIRED_RTOL = {"vortex_cg": {"residual": 2e-3, "blocks": 5e-2},
               "vortex_train": {"loss_first": 5e-3, "loss_last": 2e-2,
                                "terms": 1e-2},
               "stream_train": {"loss_first": 5e-3, "loss_last": 0.15,
                                "terms": 1e-2},
               "rbf_advection": 1e-3, "hashgrid_advection": 0.25}
HASH_ADV_ARGS = ["advection", "--network", "hashgrid", "--init_cond",
                 "example1", "--num_hidden_layers", "2", "--hidden_features",
                 "20", "-sr", "5000", "--dt", "0.05", "-T",
                 str(HASH_ADV_STEPS), "--max_n_iters", str(HASH_ADV_ITERS),
                 "--chunk_size", "200", "--no_backup", "--host_rng"]
# In 1D every level's table holds all its cells, so the path above never
# hashes. The hash itself is checked on the card: the port's `_fast_hash`
# of these integer corners (negative ones too) at table size 2^15 must
# equal the JAX package's (HASH_JAX) bit for bit.
HASH_TABLE_SIZE = 1 << 15
HASH_CORNERS = {
    2: [[-6277, 29619], [36883, -17055], [-30852, 8251], [13401, 22202],
        [11410, 17285], [33221, 33230], [34126, 28831], [17681, 33459]],
    3: [[-38956, -37873, 23811], [-5021, 19854, -1205],
        [32139, -34788, 13890], [-39550, -28155, 26449],
        [-16598, 38664, -12118], [22768, 36811, -14752],
        [38258, 16426, 37492], [-16066, 1036, 19259]],
}

# the width-128 bar of phase_kernels, also held by the elasticity paths'
# last output against the plain forward of the final field
ELA_SIREN_ATOL = 5e-5

# The four published scenes that no phase above runs (`paper_matrix`):
# their flags are the port's experiment matrix at its published setting
# (`run_experiments.experiment_args(..., smoke=False)`) with PAPER_FLAGS
# set over them: the cut in depth (T and Adam iterations per fit) and, in
# 3D, the published -vr 10000 (the matrix writes 2,000); the matrix's
# `--sample_resolution_init` is dropped, so that every init fit takes the
# published scripts' points (2D: 500^2 + 500^2; 3D: -sr 20, 8,000 volume
# points + every vertex). Widths, -sr, lr and energies as published, with
# --host_rng. bunny.mesh (18,592 vertices, 76,854 tets) and spot.mesh
# (~1/5 of bunny) are not in the repo: the scenes run on the stand-ins
# statue_tet_mesh(26) (19,683 vertices, 87,880 tets) and (15) (4,096,
# 16,875). The JAX reference runs (tests/elasticity_reference_jax.py
# paired, tests/vortex_hashgrid_reference_jax.py tlgnM) take `paper_args`.
PAPER_SCENES = ("fluid2DtlgnM", "elasticity2Dstretch", "elasticity3Dbunny",
                "elasticity3Dspot")
PAPER_MESH_N = {"elasticity3Dbunny": 26, "elasticity3Dspot": 15}
PAPER_FLAGS = {
    "fluid2DtlgnM": {"-T": 1, "--max_n_iters": MAX_ITERS},
    "elasticity2Dstretch": {"-T": 1, "--max_n_iters": ELA_ITERS},
    "elasticity3Dbunny": {"-T": ELA_STEPS, "--max_n_iters": ELA_ITERS,
                          "-vr": 10000},
    "elasticity3Dspot": {"-T": ELA_STEPS, "--max_n_iters": ELA_ITERS,
                         "-vr": 10000},
}


# The JAX package on the CPU on the port's own draws, the port's runs
# above (`python tests/elasticity_reference_jax.py paired SCENE`, `python
# tests/vortex_hashgrid_reference_jax.py tlgnM`, PERF.md section 6): per
# fit its Adam iterations, per t each statistic (`elasticity_stats`). The
# card's run must take JAX's iterations in every fit, and each statistic
# must lie within PAIRED_BARS[scene][key] = (rtol per t, atol) of JAX's
# value v: |card - v| <= rtol_t |v| + atol.
ELA_3D_PAIRED = {
    "iters": (300, 300, 300, 300, 300),
    "z_min": (-1.160587, -1.254972, -1.454399, -1.754132, -1.909398),
    "z_mean": (-0.08319227572545006, -0.18295377830506998,
               -0.38272184881468096, -0.6824885668633128, -0.837809646646494),
}
ELA_2D_PAIRED = {
    "iters": (300, 300, 300, 300, 300),
    "centroid_y": (7.183735294117602e-05, -0.08473760009803921,
                   -0.2352018194117647, -0.3532316167647059,
                   -0.4461655787254902),
    "penetration": (0.004204989141841531, 0.009913464478482958,
                    0.01700690472567401, 0.011274805279040234,
                    0.008667675942623188),
}
PAPER_PAIRED = {
    "fluid2DtlgnM": {
        "iters": (500, 500, 500, 500),
        "max_u": (0.9593201223424074, 0.9467746899722624),
        "energy": (0.06380387568813183, 0.06036877670490654),
    },
    "elasticity2Dstretch": {
        "iters": (300, 300),
        "right_x": (0.99988494, 2.693095860000001),
        "left_x": (-0.9998043899999999, -0.9066858999999998),
    },
    "elasticity3Dbunny": {
        "iters": (300, 300, 300, 300, 300),
        "z_min": (-1.162132, -1.654941, -1.999766, -2.015646, -2.018134),
        "z_mean": (-0.12938270730721288, -0.6293888775056429,
                   -0.9744094202742309, -1.1396986963244957,
                   -1.2204344908870397),
    },
    "elasticity3Dspot": {
        "iters": (300, 300, 300, 300, 300),
        "z_min": (-1.16123, -1.655064, -1.992565, -2.010495, -2.010072),
        "z_mean": (-0.2741630871169126, -0.7741548074631102,
                   -1.1116895716515325, -1.2226080991061292,
                   -1.2628571274829739),
    },
}
# Each bar, per t: 2x the larger of two gaps relative to JAX's value, the
# port's CPU run against JAX on the same draws and the card against the
# port's CPU run (PERF.md section 6), rounded up to two digits, and at
# least 1e-4; atol 1e-6 (coordinates are O(1)) keeps the quantities near 0
# (the 2D centroid at t=0) out of a relative bar's reach of rounding.
# Before the first contact the gaps are ~1e-6 and the bars 1e-4; contact
# amplifies f32 rounding to a few percent (10% in the lucy scene's first
# contact, at t=4).
PAIRED_BARS = {
    "elasticity3D": {
        "z_min": ((0.0001, 0.0001, 0.0001, 0.0001, 0.053), 1e-06),
        "z_mean": ((0.0001, 0.0001, 0.0001, 0.0001, 0.12), 1e-06),
    },
    "elasticity2D": {
        "centroid_y": ((0.0001, 0.0001, 0.00016, 0.00015, 0.00021), 1e-06),
        "penetration": ((0.0001, 0.0001, 0.0053, 0.018, 0.016), 1e-06),
    },
    "fluid2DtlgnM": {
        "max_u": ((0.0001, 0.0001), 1e-06),
        "energy": ((0.0001, 0.0001), 1e-06),
    },
    "elasticity2Dstretch": {
        "right_x": ((0.0001, 0.00087), 1e-06),
        "left_x": ((0.0001, 0.035), 1e-06),
    },
    "elasticity3Dbunny": {
        "z_min": ((0.0001, 0.0001, 0.025, 0.0062, 0.0081), 1e-06),
        "z_mean": ((0.0001, 0.0001, 0.052, 0.09, 0.046), 1e-06),
    },
    "elasticity3Dspot": {
        "z_min": ((0.0001, 0.0001, 0.0013, 0.0055, 0.0096), 1e-06),
        "z_mean": ((0.0001, 0.0001, 0.0022, 0.0074, 0.013), 1e-06),
    },
}
# the smoke matrix (`run_experiments --smoke`, paper_matrix) in a process
# of its own, within this many seconds
PAPER_SMOKE_TIMEOUT_S = 400
# phase vortex_truth: the JAX tool's LSQR budget
VORTEX_TRUTH_ITERS = 40000
# phase bench: the bench's workloads in processes of their own, the fluid
# one cut in depth (500 Adam iterations a fit, 2 reps: ~5,000 iterations
# against 57,000 at the defaults), the others at their defaults
# The probes phase: the JAX repo's last tools as the port's modules, each
# through its `main(argv)` at these cuts (`python -m insr_pde_tpu_torch.NAME
# ARGS` on the card; the JAX runs behind the PROBE_*_JAX constants take the
# same ARGS with `--device cpu`, `tests/probes_reference_jax.py`).
PROBE_OVERHEAD_ARGS = ["--phase", "pressure", "--iters", "200", "--reps",
                       "1", "--trace_iters", "10"]
PROBE_WIDTH_ARGS = ["--widths", "32,128,256", "--iters", "200", "--reps", "1"]
PROBE_COHERENCE_ARGS = ["--reps", "1"]
PROBE_PLATEAU_ARGS = ["--candidates", "ref", "--max_iters", "500",
                      "--host_rng"]
PROBE_HASHGRID_ARGS = ["-T", "1", "--iters", "600", "--networks", "hashgrid",
                       "siren", "--host_rng"]
PROBE_VORTEX_TRAIN_ARGS = ["--train_iters", "200", "--compare_matrix"]
# adam and full_solver_chunk from the same draws, PROBE_PARAM_ITERS
# iterations before the scheduler can fire: the same parameters within
# this relative bar
PROBE_PARAM_ITERS = 100
PROBE_PARAM_RTOL = 1e-5
# The JAX repo's tools at these cuts on the CPU, on the port's own draws
# (`python tests/probes_reference_jax.py all`, JAX 0.9.0; PERF.md section
# 6, the probes): the plateau setup's advect loss, then the `ref`
# candidate; the rel L2 at t=1 per network (the JAX tool rounds it to 6
# decimals); the vortex train loss at iteration 200, each residual block's
# RMS after it, and the matrix path's residual and blocks after 3 Picard
# iterations.
PROBE_PLATEAU_JAX = ({"advect_final": 7.220651241368614e-06},
                     {"best": 0.06400951743125916,
                      "final": 0.06605153530836105, "iters": 500})
PROBE_HASHGRID_JAX = {"hashgrid": 0.195822, "siren": 0.071518}
PROBE_VORTEX_TRAIN_JAX = {
    "loss": 13.987193,
    "train_blocks": {"momentum_u": 0.294407, "momentum_v": 0.027358,
                     "continuity": 2.491812, "free_slip": 1.306722,
                     "outlet_p": 0.432261, "inlet_u": 3.126899,
                     "inlet_v": 1.258583, "init_var0": 1.181285,
                     "init_var1": 0.012112, "init_var2": 0.013895},
    "lstsq_residual": 27.369,
    "matrix_blocks": {"momentum_u": 0.025115, "momentum_v": 0.025359,
                      "continuity": 0.002729, "free_slip": 0.004814,
                      "outlet_p": 0.000767, "inlet_u": 0.447562,
                      "inlet_v": 0.007033, "init_var0": 0.649133,
                      "init_var1": 0.0, "init_var2": 0.0}}
# The bars (PERF.md section 6 gives the gaps, under the probes): relative,
# each at least 10x the card's distance from JAX on these draws and above
# the port's CPU run's. The vortex blocks have a bar each, relative to the
# block's own size, 2x the larger of the card's and the port's CPU run's
# gap to JAX. Blocks that wander with the summation order are left out:
# after 200 Adam iterations the train path's outlet block (JAX 0.432, port
# CPU 0.273, card 0.363) and its init_var1/2 blocks (card 34% and 21% off);
# after 3 Picard x 2,000 f32 CGLS iterations the matrix path's momentum_u
# (port CPU 51% off) and outlet (CPU 77%) blocks. A dropped residual term
# moves its block 7-900x (the train-over-matrix ratios), far past these.
_TRAIN_BLOCK_BAR = 3e-2    # largest gap 1.4e-2 (inlet_u on the card)
_MATRIX_BLOCK_BAR = 0.25   # largest gap 0.12 (inlet_v on the card)
PROBE_RTOL = {"plateau": {"advect_final": 1e-3, "best": 1e-3,
                          "final": 1e-3},
              "hashgrid": 1e-3,
              "vortex_train": {
                  "loss": 5e-3, "lstsq_residual": 2e-3,
                  "train_blocks": dict.fromkeys(
                      ("momentum_u", "momentum_v", "continuity", "free_slip",
                       "inlet_u", "inlet_v", "init_var0"), _TRAIN_BLOCK_BAR),
                  "matrix_blocks": {
                      **dict.fromkeys(("momentum_v", "continuity",
                                       "free_slip", "inlet_v"),
                                      _MATRIX_BLOCK_BAR),
                      "inlet_u": 2e-3, "init_var0": 2e-3,
                      "init_var1": 2e-3, "init_var2": 2e-3}}}
BENCH_RUNS = ((("fluid",), ["--iters", "500", "--reps", "2"]),
              (("advect1d", "vortex_channel", "elasticity_lucy"), []))
BENCH_TIMEOUT_S = 600


def paper_args(name, mesh_path=None):
    """The entry point's flags of one of PAPER_SCENES (above); `mesh_path`
    names the 3D scenes' mesh file."""
    import tempfile
    from insr_pde_tpu_torch.run_experiments import experiment_args
    with tempfile.TemporaryDirectory() as tmp:
        args = list(experiment_args(tmp, smoke=False)[name])
    if "--sample_resolution_init" in args:
        i = args.index("--sample_resolution_init")
        del args[i:i + 2]
    for flag, value in PAPER_FLAGS[name].items():
        args[args.index(flag) + 1] = str(value)
    if mesh_path is not None:
        args[args.index("--mesh_path") + 1] = mesh_path
    return args + ["--no_backup", "--host_rng"]


def rbf_adv_grid():
    """tests/test_rbf_advection.py's 25 x 25 grid on [-0.9, 0.9]^2."""
    import numpy as np
    g = np.linspace(-0.9, 0.9, 25, dtype=np.float32)
    return np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)


def rbf_adv_errors(u0, u1, grid):
    """tests/test_rbf_advection.py's numbers of a solved field: rmse at
    t = 0 and t = 1 against the transported bump, rmse at t = 1 against the
    bump where it started, and max u at t = 1."""
    import numpy as np
    (cx, cy), width = RBF_ADV_BUMP
    vx, vy = RBF_ADV_CFG["velocity"]
    T = RBF_ADV_CFG["time_length"]

    def bump(x):
        return np.exp(-np.sum((x - np.array([cx, cy])) ** 2, axis=-1)
                      / (2 * width ** 2))

    def rmse(a, b_):
        return float(np.sqrt(np.mean((a - b_) ** 2)))

    return {"err0": rmse(u0, bump(grid)),
            "err1": rmse(u1, bump(grid - np.array([vx * T, vy * T]))),
            "err_static": rmse(u1, bump(grid)), "u1_max": float(u1.max())}


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
    cases = [case + (gen,) for case in cases]
    # the history nets of paper_matrix's 3D scenes (8,000 volume points +
    # every vertex of the bunny and the spot stand-ins), from a generator of
    # their own so that the cases above keep their inputs
    gen_path = torch.Generator(device=dev)
    gen_path.manual_seed(1)
    for name, n in (("bunny_3x66_27683", 27683), ("spot_3x66_12096", 12096)):
        x = (torch.rand((n, 3), generator=gen_path, device=dev) * 2 - 1) * 2
        cases.append((name, MLP(3, 3, 3, 66), x, ELA_SIREN_ATOL, gen_path))
    record = None
    for name, net, x, atol, gen in cases:
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
    set to 0 just before and read just after; every call of the run must
    go to its kernel's route (`_check_no_routes`). Returns (counts, model,
    results dir, wall seconds)."""
    import torch
    from insr_pde_tpu_torch.__main__ import main
    from insr_pde_tpu_torch.bench import reset_launches
    from insr_pde_tpu_torch.ops.advect_fit import advect_fit
    from insr_pde_tpu_torch.ops.siren_forward import siren_forward
    from insr_pde_tpu_torch.ops.siren_vgl import siren_vgl

    # the CLI's default project dir (ignored by git), inside the checkout
    proj_dir = os.path.join(REPO, "checkpoints", "chip_smoke")
    shutil.rmtree(os.path.join(proj_dir, tag), ignore_errors=True)
    argv = args + ["--proj_dir", proj_dir, "--tag", tag]
    reset_launches()
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
    _check_no_routes(tag)

    from insr_pde_tpu_torch.models.solver import ravel
    for name, params in model.fields.items():
        if not torch.isfinite(ravel(params)[0]).all():
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


def _check_no_routes(tag):
    """No call since the counts were set to 0 went past its kernel: the
    route counts of shapes the kernels do not take (`bench.read_routes`)
    are all 0."""
    from insr_pde_tpu_torch.bench import read_routes
    routes = read_routes()
    if any(routes.values()):
        raise RuntimeError(f"[{tag}] shapes the kernels do not take went to "
                           f"plain PyTorch: {routes}")


def _check_launches(tag, counts, least):
    """Every kernel of the path (the keys of `least`) launched at least that
    often in the path's run."""
    for name, n_least in least.items():
        if counts[name] < n_least:
            raise RuntimeError(f"[{tag}] {name} launched {counts[name]} times "
                               f"on this path, expected >= {n_least}")
    print(f"[{tag}] kernel launches on this path: {json.dumps(counts)}",
          flush=True)


def _print_phase_times(tag, model, wall, extra_desc, iters=MAX_ITERS):
    print(f"[{tag}] wall {wall:.2f}s for T={T_STEPS} (init + {T_STEPS} "
          f"{extra_desc} steps, {iters} Adam iterations per fit)")
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
    _print_phase_times("merged2", model, wall, "merged2", MERGED2_ITERS)
    _check_launches("merged2", counts, FLUID_KERNELS)
    return counts, model


def _trace(tag, fn, iters: int, note: str = ""):
    """Device busy share of `fn`, which runs `iters` iterations: one warm-up
    call, one timed call without the profiler, one under torch.profiler.
    Busy = the summed duration of the device events (one stream, so they
    do not overlap); the profiler's own host cost inflates the wall under
    it, so the share is of the unprofiled wall, with both walls printed.
    Returns fn's last result and the unprofiled ms per iteration."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from insr_pde_tpu_torch.phase_trace import device_summary
    fn()
    torch.cuda.synchronize()
    tic = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - tic) / iters * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tic = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - tic) / iters * 1e3
    events, busy_ms, by_name = device_summary(prof, iters)
    if not events:
        print(f"[trace] {tag}: not measured (the profiler recorded no device "
              f"events); {plain_ms:.5f} ms/iter without it", flush=True)
        return out, plain_ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:4]
    print(f"[trace] {tag}: {events:.2f} device events/iter{note}, device "
          f"busy {busy_ms:.5f} ms/iter; wall {plain_ms:.5f} ms/iter "
          f"({wall_ms:.5f} under the profiler): busy share "
          f"{busy_ms / plain_ms:.3f}; largest: "
          + "; ".join(f"{k[:40]} {ms:.5f} ms/iter"
                      for k, (_, ms) in top), flush=True)
    return out, plain_ms


def phase_trace(split_model, merged2_model, adv_model, iters: int = 50,
                merged2_iters: int = 10):
    """Device busy share of each step phase of the fluid paths and of the
    advect phase: one more fit of `iters` Adam iterations per split phase
    (`merged2_iters` per merged2 phase, whose iterations run ~1,000 device
    and many more host events each; one chunk of ADV_CHUNK through the
    fused advect fit, and `iters` through the eager Solver on the same
    loss), from each path's final fields, under torch.profiler (`_trace`).
    Not part of the paths' launch counts."""
    from insr_pde_tpu_torch.models.advection import FusedAdvectSolver
    from insr_pde_tpu_torch.models.solver import Solver

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
    for tag, solver, params, aux, n in phases:
        note = (f" (eager chain: {EAGER_CHAIN_PRESSURE_EVENTS})"
                if tag == "solve_pressure" else "")
        _trace(tag, lambda: solver.fit(params, aux), n, note)


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

    counts, model, exp_dir, wall = _run_entry("advection", ADV_ARGS)
    results = os.path.join(exp_dir, "results")
    vr = model.vis_resolution
    for t in range(ADV_STEPS + 1):
        path = os.path.join(results, f"t{t:03d}.npz")
        if not os.path.exists(path):
            raise RuntimeError(f"[advection] missing output {path}")
        u = np.load(path)["arr_0"]
        if u.shape != (vr,) or not np.isfinite(u).all():
            raise RuntimeError(f"[advection] t{t:03d}.npz: shape {u.shape} "
                               "or non-finite values")
        rel = advect_rel_l2(u, vr, model.length, model.vel, model.dt, t)
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


def _run_vortex(tag, args, printed="lstsq residual"):
    """One run of the vortex entry point with the block-ELL launch counts
    set to 0 just before and read just after. Returns (counts, model,
    output dir, wall seconds, the `printed` numbers of its rounds: the
    lstsq residuals, or the train losses)."""
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
            if line.strip().startswith(("round:", "lstsq", "train loss",
                                        "note:", "built ", "warning:")):
                print(f"[{tag}] {line.strip()}")
    wall = time.perf_counter() - tic
    counts = {"block_ell_mv": block_ell.mv_launches,
              "block_ell_rmv": block_ell.rmv_launches}
    residuals = [float(line.split(":")[1]) for line in
                 log.getvalue().splitlines() if f"{printed}:" in line]
    if not residuals or not all(math.isfinite(v) for v in residuals):
        raise RuntimeError(f"[{tag}] {printed} {residuals}: missing or not "
                           "finite")
    return counts, model, out_dir, wall, residuals


def _vortex_report(tag, model, counts, out_dir, wall, per_iter=1,
                   solver="CGLS"):
    """Checks the field file and that each kernel launched at least
    `per_iter` times per CGLS (or CG) iteration; prints the Picard timings.
    Returns the field."""
    import numpy as np
    field = np.load(os.path.join(out_dir, "field.npy"))
    r = model.cfg.vis_resolution
    expect = (model.cfg.time_num, r * r, 3)
    if field.shape != expect or not np.isfinite(field).all():
        raise RuntimeError(f"[{tag}] field.npy: shape {field.shape} (expected "
                           f"{expect}) or non-finite values")
    iters = sum(t["cgls_iters"] for t in model.picard_timings)
    print(f"[{tag}] wall {wall:.2f}s (model build, {len(model.picard_timings)}"
          f" Picard iterations, outputs); {iters} {solver} iterations")
    for t in model.picard_timings:
        print(f"[{tag}] picard {t['picard']}: assemble {t['assemble_s']}s, "
              f"whiten {t['whiten_s']}s, solve {t['solve_s']}s "
              f"({t['cgls_iters']} {solver} iterations, "
              f"{t['solve_s'] / max(t['cgls_iters'], 1) * 1e3:.4f} ms/iter), "
              f"operands {t['operand_mb']} MB")
    _check_launches(tag, counts, {"block_ell_mv": per_iter * iters,
                                  "block_ell_rmv": per_iter * iters})
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
    from insr_pde_tpu_torch.ops.linalg import cgls_sparse_chunked
    for tag, model in models.items():
        A, b = model.assemble(model.params.u)
        precond = model._precondition()
        x0 = model.params.u.reshape(-1) * model.cfg.warm_start

        def chunk():
            return cgls_sparse_chunked(A, b, x0, maxiter=iters, tol=0.0,
                                       chunk=iters, precondition=precond,
                                       damp=model.cfg.cgls_damp,
                                       whitener=model._whitener)

        _trace(f"{tag} CGLS chunk (precondition {precond})", chunk, iters)


def _ela_outputs(tag, exp_dir, n_points, dim, steps=ELA_STEPS):
    """Every t's PLY and .npy points (finite, (n_points, dim)) and the last
    checkpoint; returns the points per t."""
    import numpy as np
    results = os.path.join(exp_dir, "results")
    pts = []
    for t in range(steps + 1):
        stem = os.path.join(results, f"t{t:03d}_deformation")
        for suffix in (".ply", ".npy"):
            if not os.path.exists(stem + suffix):
                raise RuntimeError(f"[{tag}] missing output {stem}{suffix}")
        p = np.load(stem + ".npy")
        if p.shape != (n_points, dim) or not np.isfinite(p).all():
            raise RuntimeError(f"[{tag}] t{t:03d}: points {p.shape} (expected "
                               f"{(n_points, dim)}) or non-finite values")
        pts.append(p)
    ckpt = os.path.join(exp_dir, "model", f"ckpt_step_t{steps:03d}.npz")
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


def _ela_run(tag, args, dim, steps=ELA_STEPS):
    """One elasticity run through the entry point; checks its fields,
    outputs, the kernel's launches (>= 2 per Adam iteration of the step
    fits, the history nets) and that the last output went through the
    kernel. Returns (launches, model, exp_dir)."""
    import numpy as np
    from insr_pde_tpu_torch.ops.siren_forward import siren_forward_reference
    counts, model, exp_dir, wall = _run_entry(tag, args)
    pts = _ela_outputs(tag, exp_dir, model.sample_vis.shape[0], dim, steps)
    x = model.sample_vis
    plain = (siren_forward_reference(model.fields["deformation"], x)
             + x).cpu().numpy()
    err = float(np.abs(pts[-1] - plain).max())
    print(f"[{tag}] t={steps} output ({x.shape[0]} points) vs plain "
          f"forward of the final field: max abs err {err:.3e}")
    if not err < ELA_SIREN_ATOL:
        raise RuntimeError(f"[{tag}] kernel output disagrees with the plain "
                           "forward of the final field")
    step_iters = sum(r["n_iters"] for r in model.phase_timings
                     if r["tag"] == "solve_deformation")
    print(f"[{tag}] wall {wall:.2f}s for T={steps} (init + {steps} "
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
    # the plane holds the drop (ELA_PLANE_SLACK)
    z_end = stats["z_min"][-1]
    if not z_end >= ELA_PLANE - ELA_PLANE_SLACK:
        raise RuntimeError(f"[elasticity3D] z_min {z_end:.6f} at t="
                           f"{ELA_STEPS} is more than {ELA_PLANE_SLACK} below "
                           f"the plane z "
                           f"= {ELA_PLANE}: the collision term did not hold")
    print(f"[elasticity3D] t={ELA_STEPS} z_min {z_end:.6f}: the plane z = "
          f"{ELA_PLANE} holds the drop")
    _ela_against_jax("elasticity3D", stats, ELA_3D_JAX)
    _against_paired("elasticity3D", model, stats, ELA_3D_PAIRED,
                    PAIRED_BARS["elasticity3D"])
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
    _against_paired("elasticity2D", model, stats, ELA_2D_PAIRED,
                    PAIRED_BARS["elasticity2D"])
    return counts, model


def _against_paired(tag, model, stats, ref, bars):
    """Each fit's Adam iterations equal to the JAX package's on the same
    draws (`ref["iters"]`), and each statistic of `bars` ({key: (rtol per
    t, atol)}) at every t within its bar of JAX's value v: |got - v| <=
    rtol_t |v| + atol."""
    iters = [int(r["n_iters"]) for r in model.phase_timings]
    if iters != list(ref["iters"]):
        raise RuntimeError(f"[{tag}] Adam iterations per fit {iters}, JAX "
                           f"{list(ref['iters'])} on the same draws")
    print(f"[{tag}] Adam iterations per fit {iters}, as JAX's on the same "
          "draws", flush=True)
    for key, (rtols, atol) in bars.items():
        for t, (got, want, rtol) in enumerate(zip(stats[key], ref[key],
                                                  rtols, strict=True)):
            bar = rtol * abs(want) + atol
            diff = abs(got - want)
            print(f"[{tag}] t={t} {key} {got!r}: JAX on the same draws "
                  f"{want!r}, |diff| {diff:.3e} (relative "
                  f"{diff / max(abs(want), 1e-30):.3e}; bar {bar:.3e} = "
                  f"{rtol:g} x |JAX| + {atol:g})", flush=True)
            if not diff <= bar:
                raise RuntimeError(f"[{tag}] t={t} {key} misses its paired "
                                   "bar")


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
    from insr_pde_tpu_torch.models.solver import Solver
    for tag, model in models.items():
        solver = Solver(model._deformation_loss, model._step_points,
                        lr=model.cfg.lr, max_n_iters=iters, chunk_size=iters,
                        early_stop=False)
        params = model.fields["deformation"]
        aux = {"prev": model.fields["deformation_prev"],
               "prev_prev": model.fields["deformation_prev_prev"],
               "external": True}
        _trace(f"{tag} solve_deformation", lambda: solver.fit(params, aux),
               iters)


def _paired(tag, name, value, ref, rtol):
    """`value` within `rtol` (relative) of `ref`, the JAX package's value on
    the same draws; prints the check and raises if it fails."""
    diff = abs(value - ref) / abs(ref)
    print(f"[{tag}] {name} {value!r}: JAX on the same draws {ref!r}, "
          f"relative difference {diff:.3e} (bar {rtol:g})", flush=True)
    if not diff <= rtol:
        raise RuntimeError(f"[{tag}] {name} {value} misses its bar: {ref} "
                           f"+- {rtol:g} relative")


def _paired_blocks(tag, what, got, ref, rtol):
    """Each residual block's value (name -> value) within its bar of the
    JAX package's on the same draws, relative to the larger of its own
    size and 1e-6 of the largest block's (a block that is zero or at
    rounding level in both, such as the outlet rows, then passes). `rtol`
    is one bar for every block, or a bar per block name: a block without
    one is printed beside JAX's and not held."""
    if set(got) != set(ref):
        raise RuntimeError(f"[{tag}] {what}: blocks {sorted(got)}, JAX's "
                           f"{sorted(ref)}")
    bars = rtol if isinstance(rtol, dict) else dict.fromkeys(ref, rtol)
    floor = 1e-6 * max(abs(v) for v in ref.values())
    rel = {k: abs(got[k] - ref[k]) / max(abs(ref[k]), floor) for k in ref}
    worst = max(bars, key=lambda k: rel[k] / bars[k])
    print(f"[{tag}] {what}, {len(bars)} of {len(ref)} blocks held; nearest "
          f"its bar: {worst}, relative difference from JAX on the same draws "
          f"{rel[worst]:.3e} (bar {bars[worst]:g})", flush=True)
    free = [k for k in ref if k not in bars]
    if free:
        print(f"[{tag}] {what} not held: " + ", ".join(
            f"{k} {got[k]:.6g} (JAX {ref[k]:.6g})" for k in free), flush=True)
    if not rel[worst] <= bars[worst]:
        raise RuntimeError(f"[{tag}] {what} miss their bar: {got} against "
                           f"JAX's {ref}")


def phase_vortex_cg():
    """`vortex --solver cg` at starterL.py's defaults, 2 Picard iterations
    of 100 CG iterations: each Picard iteration's residual within its bar
    of the JAX package's on the same draws, its CG count equal to JAX's,
    and at least two mv and two rmv launches per CG iteration (A^T A p and
    the true-residual test A^T A x - A^T b)."""
    counts, model, out_dir, wall, res = _run_vortex("vortex_cg",
                                                    VORTEX_CG_ARGS)
    _vortex_report("vortex_cg", model, counts, out_dir, wall, per_iter=2,
                   solver="CG")
    timings = model.picard_timings
    for t, want in zip(timings, VORTEX_CG_JAX["cg_iters"]):
        if t["cgls_iters"] != want:
            raise RuntimeError(f"[vortex_cg] picard {t['picard']}: "
                               f"{t['cgls_iters']} CG iterations, JAX "
                               f"{want} on the same draws")
        print(f"[vortex_cg] picard {t['picard']}: "
              f"{t['assemble_s'] + t['solve_s']:.3f} s (assemble + solve), "
              f"{t['solve_s'] / t['cgls_iters'] * 1e3:.4f} ms per CG "
              f"iteration", flush=True)
    residuals = _logged(out_dir, "vortex_matrix", "residual")
    if len(residuals) != len(VORTEX_CG_JAX["residual"]):
        raise RuntimeError(f"[vortex_cg] {len(residuals)} Picard residuals")
    for i, (r, ref) in enumerate(zip(residuals, VORTEX_CG_JAX["residual"])):
        _paired("vortex_cg", f"picard {i} residual", r, ref,
                PAIRED_RTOL["vortex_cg"]["residual"])
    blocks = {k: v["rms"] for k, v in model.block_residuals().items()}
    _paired_blocks("vortex_cg", "block residuals of the solution", blocks,
                   VORTEX_CG_JAX["blocks"], PAIRED_RTOL["vortex_cg"]["blocks"])
    return counts, model


def _logged(out_dir, tag, key):
    """The values of `key` that a vortex run logged under `tag`, in step
    order (its log's scalars.jsonl)."""
    with open(os.path.join(out_dir, "log", "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [r[key] for r in rows if r["tag"] == tag]


def phase_vortex_train():
    """`vortex --mode train` at starterL.py's defaults (200 Adam iterations,
    lr 0.1), then `--formulation stream --mode train`: the loss at
    iterations 1 and 200 within their bars, and falling; then each of the
    six residual blocks at the init coefficients (a model built anew from
    the same seed) within its bar."""
    models = {}
    for tag, args in (("vortex_train", VORTEX_TRAIN_ARGS),
                      ("stream_train", STREAM_TRAIN_ARGS)):
        counts, model, out_dir, wall, losses = _run_vortex(
            tag, args, printed="train loss")
        loss = _logged(out_dir, "vortex_train", "loss")
        if len(loss) != VORTEX_TRAIN_ITERS or not all(
                math.isfinite(v) for v in loss):
            raise RuntimeError(f"[{tag}] {len(loss)} logged losses, expected "
                               f"{VORTEX_TRAIN_ITERS} finite ones")
        ref, rtol = VORTEX_TRAIN_JAX[tag], PAIRED_RTOL[tag]
        _paired(tag, "loss at iteration 1", loss[0], ref["loss_first"],
                rtol["loss_first"])
        _paired(tag, f"loss at iteration {VORTEX_TRAIN_ITERS}", loss[-1],
                ref["loss_last"], rtol["loss_last"])
        if not loss[-1] < loss[0]:
            raise RuntimeError(f"[{tag}] the loss did not fall: {loss[0]} -> "
                               f"{loss[-1]}")
        fresh = type(model)(model.cfg, log=False, device=model.device)
        terms = fresh.residual_terms(fresh.params.u)
        _paired_blocks(tag, "residual blocks at the init coefficients",
                       {i: float(v) for i, v in enumerate(terms)},
                       dict(enumerate(ref["terms"])), rtol["terms"])
        print(f"[{tag}] wall {wall:.2f}s (model build, "
              f"{VORTEX_TRAIN_ITERS} Adam iterations, outputs; ms per Adam "
              f"iteration in the trace phase); block-ELL launches "
              f"{json.dumps(counts)} (none: Adam runs no operator)",
              flush=True)
        models[tag] = model
    return models


def phase_vortex_flags():
    """The channel preset at one Picard iteration, plain, with
    --rmv_gather and with --packed_vals: the flags name the JAX package's
    other operator layouts, which are the port's one layout, so the
    residual and the coefficients equal the plain run's bit for bit; each
    run launches both block-ELL kernels at least once per CGLS
    iteration."""
    import torch
    plain = None
    for name, extra in FLAG_RUNS.items():
        tag = f"vortex_flags_{name}"
        counts, model, out_dir, wall, res = _run_vortex(tag,
                                                        FLAG_ARGS + extra)
        _vortex_report(tag, model, counts, out_dir, wall)
        u = model.params.u.detach().cpu()
        if plain is None:
            plain = (res[-1], u)
            plain_timings = model.picard_timings
            continue
        same = res[-1] == plain[0] and torch.equal(u, plain[1])
        print(f"[{tag}] residual {res[-1]!r} (plain {plain[0]!r}), "
              f"coefficients {'equal' if same else 'NOT equal'} to the plain "
              f"run's bit for bit", flush=True)
        if not same:
            raise RuntimeError(f"[{tag}] differs from the plain run")
    return plain_timings


def _rbf_bump(x):
    import torch
    (cx, cy), width = RBF_ADV_BUMP
    c = torch.tensor([cx, cy], device=x.device)
    return torch.exp(-torch.sum((x - c) ** 2, dim=-1) / (2 * width ** 2))


def phase_rbf_advection():
    """RBFAdvectionModel at tests/test_rbf_advection.py's configuration on
    the card: that test's bars, each error and the residual within its bar
    of the JAX package's on the same draws, and at least one J = 1 mv and
    one rmv launch per CGLS iteration."""
    import torch
    from insr_pde_tpu_torch.models.rbf_advection import (
        RBFAdvectionConfig, RBFAdvectionModel)
    from insr_pde_tpu_torch.ops import block_ell
    tag = "rbf_advection"
    tic = time.perf_counter()
    model = RBFAdvectionModel(RBFAdvectionConfig(**RBF_ADV_CFG), _rbf_bump,
                              device="cuda")
    A, _ = model.assemble()
    torch.cuda.synchronize()
    build = time.perf_counter() - tic
    block_ell.mv_launches = 0
    block_ell.rmv_launches = 0
    tic = time.perf_counter()
    res = model.solve()
    torch.cuda.synchronize()
    solve = time.perf_counter() - tic
    counts = {"block_ell_mv": block_ell.mv_launches,
              "block_ell_rmv": block_ell.rmv_launches}
    niter = model.info["niter"]
    grid = rbf_adv_grid()
    g = torch.from_numpy(grid).cuda()
    errs = rbf_adv_errors(model.evaluate(g, 0.0).cpu().numpy(),
                          model.evaluate(g, 1.0).cpu().numpy(), grid)
    R, S, J = A.vals.shape
    print(f"[{tag}] operator R={R} S={S} J={J}, {A.n_cols} columns; build "
          f"{build:.2f}s; solve {solve:.3f}s, {niter} CGLS iterations, "
          f"{solve / niter * 1e3:.4f} ms per CGLS iteration; residual "
          f"{res:.6g}", flush=True)
    if not math.isfinite(res):
        raise RuntimeError(f"[{tag}] residual {res} is not finite")
    for name, bar, ok in (("err0", 0.05, errs["err0"] < 0.05),
                          ("err1", 0.08, errs["err1"] < 0.08),
                          ("err_static", "3 err1",
                           errs["err_static"] > 3 * errs["err1"]),
                          ("u1_max", 0.7, errs["u1_max"] > 0.7)):
        print(f"[{tag}] {name} {errs[name]:.6g} (the test's bar {bar})")
        if not ok:
            raise RuntimeError(f"[{tag}] {name} misses the test's bar")
    for name, ref in RBF_ADV_JAX.items():
        _paired(tag, name, res if name == "residual" else errs[name], ref,
                PAIRED_RTOL[tag])
    _check_launches(tag, counts, {"block_ell_mv": niter,
                                  "block_ell_rmv": niter})
    return model


def phase_hashgrid_advection():
    """`advection --network hashgrid` (scripts/advect1D.sh's flags, cut,
    the draws made on the host): rel L2 against the analytic bump at every
    t within its bar of the JAX package's on the same draws; ms per Adam
    iteration per fit. Then the hash on the card, which the 1D path never
    takes: `_fast_hash` of HASH_CORNERS equal to the JAX package's."""
    import numpy as np
    import torch
    from insr_pde_tpu_torch.models.encodings import _fast_hash
    tag = "hashgrid_advection"
    counts, model, exp_dir, wall = _run_entry(tag, HASH_ADV_ARGS)
    if type(model.net).__name__ != "HashGridField":
        raise RuntimeError(f"[{tag}] the network is {type(model.net)}")
    vr = model.vis_resolution
    for t in range(HASH_ADV_STEPS + 1):
        u = np.load(os.path.join(exp_dir, "results",
                                 f"t{t:03d}.npz"))["arr_0"]
        if u.shape != (vr,) or not np.isfinite(u).all():
            raise RuntimeError(f"[{tag}] t{t:03d}.npz: shape {u.shape} or "
                               "non-finite values")
        rel = advect_rel_l2(u, vr, model.length, model.vel, model.dt, t)
        _paired(tag, f"t={t} rel L2", rel, HASH_ADV_JAX[t], PAIRED_RTOL[tag])
    print(f"[{tag}] wall {wall:.2f}s for T={HASH_ADV_STEPS} (init + "
          f"{HASH_ADV_STEPS} steps, {HASH_ADV_ITERS} Adam iterations per "
          f"fit, the generic Solver); kernel launches {json.dumps(counts)}")
    for rec in model.phase_timings:
        print(f"[{tag}] t={rec['timestep']} {rec['tag']:10s} "
              f"{rec['n_iters']} iters {rec['sec']:.3f}s "
              f"{rec['sec'] / max(rec['n_iters'], 1) * 1e3:.4f} ms/iter",
              flush=True)
    for dim, corners in HASH_CORNERS.items():
        got = _fast_hash(torch.tensor(corners, device="cuda"), dim,
                         HASH_TABLE_SIZE).cpu().tolist()
        print(f"[{tag}] hash of {len(corners)} corners in {dim}D on the "
              f"card: {'equal' if got == HASH_JAX[dim] else 'NOT equal'} to "
              f"the JAX package's", flush=True)
        if got != HASH_JAX[dim]:
            raise RuntimeError(f"[{tag}] {dim}D hash {got}, JAX "
                               f"{HASH_JAX[dim]}")
    return model


def phase_new_paths_trace(train_models, hash_model, iters: int = 20):
    """Device busy share and events per iteration of the Adam paths of this
    group: `iters` more vortex train iterations of each formulation and one
    more hash-grid advect fit of `iters` iterations, under torch.profiler,
    with the same work's wall time without it beside: the ms per Adam
    iteration that the train phases report."""
    from insr_pde_tpu_torch.models.solver import Solver
    hm = hash_model
    solver = Solver(hm._advect_loss, hm._advect_points, lr=hm.cfg.lr,
                    max_n_iters=iters, chunk_size=iters, early_stop=False)
    field = hm.fields["field"]
    for tag, m in train_models.items():
        _trace(f"{tag} Adam", lambda m=m: m.train(iters), iters)
    _trace("hashgrid_advection advect",
           lambda: solver.fit(field, {"prev": field}), iters)


# ------------------------------------------------------------ sharded paths
#
# Two ranks share the one card over gloo (NCCL refuses two ranks on one
# device); NCCL runs as a one-rank group; with two or more cards the three
# phases run again over NCCL, one rank per card. Ranks are spawned by
# `parallel.launch` (their bodies are the `_rank_*` functions below, which a
# spawned child imports from this file) and each reads its own kernel
# counters.

SHARD_WORLD = 2
SHARD_GRAD_RTOL = 1e-5        # reduced loss and grad against the whole batch
SHARD_GRAD_REPS = 20
SHARD_FLUID_ARGS = ["fluid", "--init_cond", "taylorgreen",
                    "--num_hidden_layers", "3", "--hidden_features", "32",
                    "-sr", "128", "-vr", "128", "--dt", "0.05", "-T", "1",
                    "--max_n_iters", str(MAX_ITERS), "--chunk_size", "250",
                    "--no_backup"]
SHARD_CHANNEL_ARGS = ["vortex", "--preset", "channel", "--picard_iters", "1"]
SHARD_CHANNEL_ITERS = 20      # iterations of the iterate check
# the iterate against the single process's: f32 CGLS on the whitened
# stream system moves with the summation order alone. One process on the
# channel's rows taken in the ranks' order moved it 9.623e-4 from the same
# process on its own order after 20 iterations on an NVIDIA H100 80GB HBM3
# at 700 W (PERF.md section 6; 6e-4 on a small channel system on the CPU),
# so 1e-4 is beyond f32 here and the bar is twice that drift
SHARD_ORDER_DRIFT = 9.623e-4
SHARD_ITERATE_RTOL = 2.0 * SHARD_ORDER_DRIFT
SHARD_GRAM_RTOL = 1e-5        # the Gram summed from the shards
SHARD_ROWS_ATOL = 1e-6        # each rank's rows against the padded slice
SHARD_DEADLINE_S = 300


def _rel(a, b):
    import numpy as np
    return float(np.linalg.norm(np.asarray(a, np.float64) - b)
                 / max(np.linalg.norm(np.asarray(b, np.float64)), 1e-30))


def _grad_model(group):
    import torch
    from insr_pde_tpu_torch.config import Config
    from insr_pde_tpu_torch.models.fluid import Fluid2DModel
    cfg = Config(pde="fluid", init_cond="taylorgreen", num_hidden_layers=3,
                 hidden_features=32, sample_resolution=128, device="cuda")
    return Fluid2DModel(cfg, group), torch.device("cuda",
                                                  torch.cuda.current_device())


def _pressure_grad(model, group, pts, reps):
    """(losses, grad, vgl launches of one call, ms per call) of the split
    pressure phase's gradient program on `pts`."""
    import torch
    from insr_pde_tpu_torch.models.solver import Solver, ravel
    from insr_pde_tpu_torch.ops.siren_vgl import siren_vgl
    solver = Solver(model._pressure_loss, None, lr=1e-4, max_n_iters=1,
                    group=group)
    flat, spec = ravel(model.fields["pressure"])
    aux = {"vel": model.fields["velocity"]}
    siren_vgl.fwd_launches = 0
    siren_vgl.bwd_launches = 0
    ld, grad = solver.value_and_grad(flat, spec, pts, aux)
    torch.cuda.synchronize()
    counts = {"siren_vgl_forward": siren_vgl.fwd_launches,
              "siren_vgl_backward": siren_vgl.bwd_launches}
    tic = time.perf_counter()
    for _ in range(reps):
        solver.value_and_grad(flat, spec, pts, aux)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - tic) / max(reps, 1) * 1e3
    return ({k: float(v) for k, v in ld.items()}, grad.cpu().numpy(),
            counts, ms)


def _rank_grad(n_devices, backend, fields, points, reps):
    """One rank of the sharded gradient phase: `points[rank]` through the
    port's Solver on a group of `n_devices` ranks (0: the launched group
    itself, built explicitly, of any size)."""
    import numpy as np
    import torch
    from insr_pde_tpu_torch.convert import fields_from_jax
    from insr_pde_tpu_torch.parallel import current_group, make_group
    group = (make_group(n_devices, backend, "cuda") if n_devices
             else current_group())
    model, dev = _grad_model(group)
    model.fields = fields_from_jax(fields, dev)
    pts = {k: torch.from_numpy(v).to(dev)
           for k, v in points[group.rank].items()}
    ld, grad, counts, ms = _pressure_grad(model, group, pts, reps)
    return {"main": np.asarray(ld["main"]), "bc": np.asarray(ld["bc"]),
            "grad": grad, "ms": np.asarray(ms), "backend": np.asarray(
                group.backend), "size": np.asarray(group.size),
            **{k: np.asarray(v) for k, v in counts.items()}}


def phase_sharded_gradient(backend="gloo", device="cuda:0"):
    """The split pressure phase's gradient program at full width (3x32,
    16,384 points) on SHARD_WORLD ranks of 8,192 points each, against the
    whole batch in this process; then the whole batch on a one-rank NCCL
    group (a no-op reduction)."""
    import numpy as np
    import torch
    from insr_pde_tpu_torch.convert import params_to_numpy
    from insr_pde_tpu_torch.parallel import launch

    torch.cuda.empty_cache()
    model, dev = _grad_model(None)
    model.n_boundary = 162          # even halves on every boundary pair
    whole = model._points_with_bc()
    ld, grad, counts, ms = _pressure_grad(model, None, whole, SHARD_GRAD_REPS)
    fields = {k: params_to_numpy(v) for k, v in model.fields.items()}
    host = {k: v.cpu().numpy() for k, v in whole.items()}
    halves = [{k: np.array_split(v, SHARD_WORLD)[r] for k, v in host.items()}
              for r in range(SHARD_WORLD)]
    tag = f"sharded_grad_{backend}"
    out = launch(_rank_grad, SHARD_WORLD, backend, device,
                 args=(SHARD_WORLD, backend, fields, halves, SHARD_GRAD_REPS),
                 deadline_s=SHARD_DEADLINE_S)
    for r, res in enumerate(out):
        errs = {"main": abs(float(res["main"]) - ld["main"]) / abs(ld["main"]),
                "bc": abs(float(res["bc"]) - ld["bc"]) / abs(ld["bc"]),
                "grad": _rel(res["grad"], grad)}
        print(f"[{tag}] rank {r}/{SHARD_WORLD} ({res['backend']}, "
              f"{device}): rel err vs the whole batch {json.dumps(errs)} "
              f"(bar {SHARD_GRAD_RTOL}); vgl launches of one call "
              f"{int(res['siren_vgl_forward'])}/"
              f"{int(res['siren_vgl_backward'])}; {float(res['ms']):.4f} "
              f"ms per call (whole batch in one process {ms:.4f} ms)",
              flush=True)
        if not max(errs.values()) <= SHARD_GRAD_RTOL:
            raise RuntimeError(f"[{tag}] rank {r} misses the bar")
        if not (res["siren_vgl_forward"] >= 1
                and res["siren_vgl_backward"] >= 1):
            raise RuntimeError(f"[{tag}] rank {r} did not launch the vgl "
                               "pair")
    if backend != "gloo":
        return
    one = launch(_rank_grad, 1, "nccl", "cuda",
                 args=(0, "nccl", fields, [host], 2),
                 deadline_s=SHARD_DEADLINE_S)[0]
    same = (float(one["main"]) == ld["main"] and float(one["bc"]) == ld["bc"]
            and np.array_equal(one["grad"], grad))
    err = max(abs(float(one["main"]) - ld["main"]) / abs(ld["main"]),
              abs(float(one["bc"]) - ld["bc"]) / abs(ld["bc"]),
              _rel(one["grad"], grad))
    print(f"[sharded_grad_nccl1] one-rank {one['backend']} group "
          f"(size {int(one['size'])}): loss and grad rel err {err:.3e} vs "
          f"the single process (bar {SHARD_GRAD_RTOL}; "
          f"{'the same' if same else 'other'} bits); {float(one['ms']):.4f} "
          f"ms per call", flush=True)
    if not err <= SHARD_GRAD_RTOL:
        raise RuntimeError("[sharded_grad_nccl1] differs from the single "
                           "process")


def _rank_entry(argv, kernels):
    """One rank of a sharded entry-point run: its counters set to 0 just
    before and read just after; returns them, the model's phase or Picard
    timings and, for a vortex model, the inlet error and max |u|."""
    import numpy as np
    import torch
    from insr_pde_tpu_torch import __main__ as cli
    from insr_pde_tpu_torch.ops import block_ell
    from insr_pde_tpu_torch.ops.siren_forward import siren_forward
    from insr_pde_tpu_torch.ops.siren_vgl import siren_vgl
    counters = {"siren_forward": (siren_forward, "launches"),
                "siren_vgl_forward": (siren_vgl, "fwd_launches"),
                "siren_vgl_backward": (siren_vgl, "bwd_launches"),
                "block_ell_mv": (block_ell, "mv_launches"),
                "block_ell_rmv": (block_ell, "rmv_launches")}
    for name in kernels:
        setattr(*counters[name], 0)
    log = io.StringIO()
    tic = time.perf_counter()
    with contextlib.redirect_stdout(log):
        model = cli.main(argv)
    torch.cuda.synchronize()
    out = {"wall": np.asarray(time.perf_counter() - tic),
           "lines": np.asarray(log.getvalue().splitlines() or [""])}
    out.update({name: np.asarray(getattr(*counters[name]))
                for name in kernels})
    if hasattr(model, "picard_timings"):
        from insr_pde_tpu_torch.models.vortex import inlet_error
        vals = model.sample_field(model.cfg.vis_resolution)[0]
        out.update(inlet=np.asarray(inlet_error(model)),
                   max_u=np.asarray(float(vals[..., :2].abs().max())),
                   finite=np.asarray(bool(torch.isfinite(vals).all())),
                   timings=np.asarray(json.dumps(model.picard_timings)))
    else:
        out.update(finite=np.asarray(all(
            bool(torch.isfinite(w).all() and torch.isfinite(b).all())
            for p in model.fields.values() for w, b in p)),
            timings=np.asarray(json.dumps(model.phase_timings)))
    return out


def phase_sharded_fluid(world1_model, backend="gloo", device="cuda:0"):
    """`python -m insr_pde_tpu_torch fluid` (split, 3x32, -sr 128, T=1,
    MAX_ITERS Adam iterations per fit) with `--n_devices SHARD_WORLD`: each
    rank's launches, rank 0's outputs alone, the t=0 fit against analytic
    Taylor-Green, and ms per Adam iteration per phase beside the world-1
    main path's."""
    import numpy as np
    from insr_pde_tpu_torch.models.examples import taylorgreen_velocity
    from insr_pde_tpu_torch.ops.sampling import sample_uniform
    from insr_pde_tpu_torch.parallel import launch

    tag = f"sharded_fluid_{backend}"
    exp = os.path.join(REPO, "checkpoints", "chip_smoke", tag)
    shutil.rmtree(exp, ignore_errors=True)
    argv = SHARD_FLUID_ARGS + [
        "--n_devices", str(SHARD_WORLD), "--dist_backend", backend,
        "--proj_dir", os.path.dirname(exp), "--tag", tag]
    kernels = ("siren_forward", "siren_vgl_forward", "siren_vgl_backward")
    out = launch(_rank_entry, SHARD_WORLD, backend, device,
                 args=(argv, kernels), deadline_s=SHARD_DEADLINE_S)
    for line in out[0]["lines"]:
        if str(line).startswith(("timestep:", "note:")):
            print(f"[{tag}] {line}")
    results = os.path.join(exp, "results")
    names = sorted(os.listdir(results))
    npys = [n for n in names if n.endswith(".npy")]
    with open(os.path.join(exp, "timings.jsonl")) as f:
        n_timings = len(f.read().splitlines())
    if npys != ["t000.npy", "t001.npy"] or n_timings != 2:
        raise RuntimeError(f"[{tag}] outputs {npys}, {n_timings} timing "
                           "lines: expected rank 0's T=1 outputs alone")
    grid = sample_uniform(128, 2, flatten=False)
    tg = taylorgreen_velocity(grid, rescale=True).numpy()
    u0 = np.load(os.path.join(results, "t000.npy"))
    rel0, _ = _tg_metrics(u0, tg)
    print(f"[{tag}] t=0 velocity rel L2 vs analytic Taylor-Green: "
          f"{rel0:.4e} (bar {TG_REL_L2_BAR})", flush=True)
    if not rel0 < TG_REL_L2_BAR or not np.isfinite(u0).all():
        raise RuntimeError(f"[{tag}] the t=0 fit misses the Taylor-Green bar")
    single = {}
    for rec in world1_model.phase_timings:
        if rec["timestep"] <= 1:
            single[rec["tag"]] = rec["sec"] / max(rec["n_iters"], 1) * 1e3
    for r, res in enumerate(out):
        if not bool(res["finite"]):
            raise RuntimeError(f"[{tag}] rank {r}: a field is not finite")
        counts = {k: int(res[k]) for k in kernels}
        least = {"siren_vgl_forward": 1, "siren_vgl_backward": 1}
        if r == 0:
            least["siren_forward"] = 2      # write_output at t = 0 and 1
        print(f"[{tag}] rank {r}: wall {float(res['wall']):.2f}s; kernel "
              f"launches {json.dumps(counts)}", flush=True)
        _check_launches(f"{tag} rank {r}", counts, least)
        per = {rec["tag"]: round(rec["sec"] / max(rec["n_iters"], 1) * 1e3, 4)
               for rec in json.loads(str(res["timings"]))}
        print(f"[{tag}] rank {r}: ms per Adam iteration by phase, "
              f"{SHARD_WORLD} ranks sharing one card ({backend}) "
              f"{json.dumps(per)}; one process (the main path's t<=1) "
              f"{json.dumps({k: round(v, 4) for k, v in single.items()})}",
              flush=True)


def _rank_channel(argv, n_iters):
    """One rank of the sharded channel phase: its rows of the first system
    against the single-process assembly's padded slice, the iterate after
    `n_iters` CGLS iterations against the single-process solve's, then the
    entry point (`_rank_entry`)."""
    import numpy as np
    import torch
    from insr_pde_tpu_torch import starterL
    from insr_pde_tpu_torch.models.vortex import StreamVortexModel, row_shard
    from insr_pde_tpu_torch.ops.linalg import block_gram, cgls_sparse_chunked
    from insr_pde_tpu_torch.ops.precision import resolve_device
    from insr_pde_tpu_torch.parallel import make_group, psum
    args = starterL.parse_args(argv[1:])
    cfg = starterL.build_config(args)
    group = make_group(args.n_devices, args.dist_backend, "cuda")
    model = StreamVortexModel(cfg, log=False, device=resolve_device("cuda"),
                              group=group)
    u = model.params.u
    A1, b1 = model.assemble(u)
    As, bs = model.assemble(u, group=group)
    counts = [c for _, c in model.block_names_counts()]
    ref_vals = row_shard(A1.vals, counts, group.rank, group.size)
    ref_cols = row_shard(A1.cols, counts, group.rank, group.size)
    ref_b = row_shard(b1, counts, group.rank, group.size)
    rows = {"rows": np.asarray(As.vals.shape[0]),
            "rows_whole": np.asarray(A1.vals.shape[0]),
            "cols_equal": np.asarray(bool(torch.equal(As.cols, ref_cols))),
            "vals_err": np.asarray(float((As.vals - ref_vals).abs().max())),
            "b_err": np.asarray(float((bs - ref_b).abs().max()))}
    kw = dict(maxiter=n_iters, tol=cfg.cgls_tol, chunk=cfg.cgls_chunk,
              precondition="block", damp=cfg.cgls_damp,
              restart=cfg.cgls_restart)
    x0 = u.reshape(-1) * cfg.warm_start
    x1, info1 = cgls_sparse_chunked(A1, b1, x0, **kw)
    gram_rel = _rel(psum(block_gram(As), group).cpu().numpy(),
                    block_gram(A1).cpu().numpy())
    del A1, b1
    # with the single process's whitener (the near-singular Gram blocks
    # amplify the f32 summation order of the Gram's sums into W), then with
    # the ranks' own: the Gram summed over them, rank 0's eigh, broadcast
    xs, info = cgls_sparse_chunked(As, bs, x0, whitener=info1["W"],
                                   group=group, **kw)
    xw, _ = cgls_sparse_chunked(As, bs, x0, group=group, **kw)
    rows.update(iterate_rel=np.asarray(_rel(xs.cpu().numpy(),
                                            x1.cpu().numpy())),
                iterate_rel_own_w=np.asarray(_rel(xw.cpu().numpy(),
                                                  x1.cpu().numpy())),
                gram_rel=np.asarray(gram_rel),
                iterate_niter=np.asarray(int(info["niter"])))
    del model, As, bs
    torch.cuda.empty_cache()
    return {**rows, **_rank_entry(argv, ("block_ell_mv", "block_ell_rmv"))}


def phase_sharded_channel(world1_timings, backend="gloo", device="cuda:0"):
    """`vortex --preset channel --picard_iters 1 --n_devices SHARD_WORLD`
    (243,210 rows, block-whitened chunked CGLS): each rank's rows against
    the single-process assembly's padded slice, the iterate after
    SHARD_CHANNEL_ITERS iterations against the single-process one, then
    the whole solve through the entry point: inlet error and max |u| under
    their bars, at least one mv and one rmv launch per CGLS iteration on
    each rank."""
    from insr_pde_tpu_torch.parallel import launch
    tag = f"sharded_channel_{backend}"
    out_dir = os.path.join(REPO, "checkpoints", "chip_smoke", tag)
    shutil.rmtree(out_dir, ignore_errors=True)
    argv = SHARD_CHANNEL_ARGS + [
        "--n_devices", str(SHARD_WORLD), "--dist_backend", backend,
        "--output_path", out_dir, "--log_dir", os.path.join(out_dir, "log")]
    import torch
    torch.cuda.empty_cache()
    out = launch(_rank_channel, SHARD_WORLD, backend, device,
                 args=(argv, SHARD_CHANNEL_ITERS),
                 deadline_s=SHARD_DEADLINE_S)
    for line in out[0]["lines"]:
        if str(line).strip().startswith(("round:", "lstsq", "note:")):
            print(f"[{tag}] {str(line).strip()}")
    if sorted(n for n in os.listdir(out_dir) if n.endswith((".npy", ".npz"))) \
            != ["field.npy", "vortex_ckpt.npz"]:
        raise RuntimeError(f"[{tag}] expected rank 0's field and checkpoint")
    for r, res in enumerate(out):
        timings = json.loads(str(res["timings"]))
        iters = sum(t["cgls_iters"] for t in timings)
        print(f"[{tag}] rank {r}: {int(res['rows'])} of "
              f"{int(res['rows_whole'])} rows; cols equal to the padded "
              f"slice: {bool(res['cols_equal'])}, vals max abs diff "
              f"{float(res['vals_err']):.3e}, rhs {float(res['b_err']):.3e} "
              f"(bar {SHARD_ROWS_ATOL}); block Gram from the shards rel "
              f"diff {float(res['gram_rel']):.3e} (bar {SHARD_GRAM_RTOL}); "
              f"iterate after {int(res['iterate_niter'])} iterations rel "
              f"diff {float(res['iterate_rel']):.3e} vs one process, with "
              f"its whitener, {float(res['iterate_rel_own_w']):.3e} with "
              f"the ranks' own (bar {SHARD_ITERATE_RTOL:.4e} for both: 2x "
              f"the drift of one process whose rows come in the ranks' "
              f"order, {SHARD_ORDER_DRIFT})", flush=True)
        print(f"[{tag}] rank {r}: inlet error {float(res['inlet']):.4e} (bar "
              f"{INLET_ERROR_BAR}), max |u| {float(res['max_u']):.3f} (bar "
              f"{MAX_U_BAR}), {iters} CGLS iterations, wall "
              f"{float(res['wall']):.2f}s", flush=True)
        for t in timings:
            print(f"[{tag}] rank {r} picard {t['picard']}: assemble "
                  f"{t['assemble_s']}s, whiten {t['whiten_s']}s, solve "
                  f"{t['solve_s']}s ({t['cgls_iters']} iterations, "
                  f"{t['solve_s'] / max(t['cgls_iters'], 1) * 1e3:.4f} "
                  f"ms/iter, {SHARD_WORLD} ranks sharing one card, "
                  f"{backend}), operands {t['operand_mb']} MB")
        if not (bool(res["cols_equal"])
                and float(res["vals_err"]) <= SHARD_ROWS_ATOL
                and float(res["b_err"]) <= SHARD_ROWS_ATOL):
            raise RuntimeError(f"[{tag}] rank {r}'s rows differ from the "
                               "padded slice")
        if not float(res["gram_rel"]) <= SHARD_GRAM_RTOL:
            raise RuntimeError(f"[{tag}] rank {r}'s summed Gram misses its "
                               "bar")
        if not (int(res["iterate_niter"]) == SHARD_CHANNEL_ITERS
                and float(res["iterate_rel"]) <= SHARD_ITERATE_RTOL
                and float(res["iterate_rel_own_w"]) <= SHARD_ITERATE_RTOL):
            raise RuntimeError(f"[{tag}] rank {r}'s iterate misses its bar")
        if not (bool(res["finite"]) and float(res["inlet"]) <= INLET_ERROR_BAR
                and float(res["max_u"]) <= MAX_U_BAR):
            raise RuntimeError(f"[{tag}] rank {r}: the field misses its bars")
        _check_launches(f"{tag} rank {r}",
                        {k: int(res[k]) for k in ("block_ell_mv",
                                                  "block_ell_rmv")},
                        {"block_ell_mv": iters, "block_ell_rmv": iters})
    for t in world1_timings:
        print(f"[{tag}] one process (vortex flags plain run) picard "
              f"{t['picard']}: solve {t['solve_s']}s ({t['cgls_iters']} "
              f"iterations, {t['solve_s'] / max(t['cgls_iters'], 1) * 1e3:.4f}"
              f" ms/iter)", flush=True)


def phase_sharded_cards(world1_model, world1_timings):
    """Phases of the sharded paths over NCCL with one rank per card, where
    the machine has SHARD_WORLD cards or more."""
    import torch
    n = torch.cuda.device_count()
    if n < SHARD_WORLD:
        print(f"[sharded_nccl] not run: {n} card(s) here; NCCL with one rank "
              f"per card, and any scaling across cards, needs "
              f"{SHARD_WORLD} cards (NCCL refuses two ranks on one device)",
              flush=True)
        return
    phase_sharded_gradient("nccl", "cuda")
    phase_sharded_fluid(world1_model, "nccl", "cuda")
    phase_sharded_channel(world1_timings, "nccl", "cuda")


def phase_paper_matrix():
    """(i) `python -m insr_pde_tpu_torch.run_experiments --smoke` in a
    process of its own: exit 0, all nine experiments ok. (ii) PAPER_SCENES
    through the entry point (`paper_args`), counters set to 0 just before
    and read just after each: finite fields; fluid2DtlgnM's t=0 fit
    against `taylorgreen_multi_velocity` under the fluid bar, the vgl pair
    launched once per pressure iteration; the elasticity scenes' outputs,
    the SIREN forward launched twice per step iteration and its last
    output against the plain forward; every statistic at every t against
    the JAX package's run on the same draws (PAPER_PAIRED, PAIRED_BARS)."""
    import numpy as np
    from insr_pde_tpu_torch.elasticity_stats import run_stats
    from insr_pde_tpu_torch.geometry import statue_tet_mesh, write_medit
    from insr_pde_tpu_torch.models.examples import taylorgreen_multi_velocity
    from insr_pde_tpu_torch.ops.sampling import sample_uniform

    proj = os.path.join(REPO, "checkpoints", "chip_smoke", "matrix")
    shutil.rmtree(proj, ignore_errors=True)
    tic = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "insr_pde_tpu_torch.run_experiments",
         "--smoke", "--proj_dir", proj], cwd=REPO, capture_output=True,
        text=True, timeout=PAPER_SMOKE_TIMEOUT_S)
    records = {}
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            records.update(json.loads(line))
            print(f"[paper_matrix] smoke {line}", flush=True)
    experiments = {k: v for k, v in records.items() if k != "summary"}
    if (proc.returncode != 0 or len(experiments) != 9
            or not all(r["ok"] for r in experiments.values())):
        raise RuntimeError(f"[paper_matrix] the smoke matrix: exit "
                           f"{proc.returncode}, {records}; stderr "
                           f"{proc.stderr[-2000:]}")
    print(f"[paper_matrix] smoke matrix: 9/9 ok in "
          f"{time.perf_counter() - tic:.1f}s", flush=True)

    name = "fluid2DtlgnM"
    args = paper_args(name)
    print(f"[{name}] the published flags cut to T=1 and {MAX_ITERS} Adam "
          f"iterations a fit: {' '.join(args)}", flush=True)
    counts, model, exp_dir, wall = _run_entry(name, args)
    vr = model.cfg.vis_resolution
    u0 = np.load(os.path.join(exp_dir, "results", "t000.npy"))
    ref0 = taylorgreen_multi_velocity(
        sample_uniform(vr, 2, flatten=False)).numpy()
    rel0 = float(np.linalg.norm(u0 - ref0) / np.linalg.norm(ref0))
    print(f"[{name}] t=0 velocity rel L2 vs taylorgreen_multi_velocity on "
          f"the {vr}x{vr} grid: {rel0:.4e} (bar {TG_REL_L2_BAR}); wall "
          f"{wall:.2f}s", flush=True)
    if not rel0 < TG_REL_L2_BAR:
        raise RuntimeError(f"[{name}] the t=0 fit misses its bar")
    stats = run_stats("fluid", exp_dir)
    if not all(math.isfinite(v) for st in stats for v in st.values()):
        raise RuntimeError(f"[{name}] non-finite statistics {stats}")
    pressure = sum(r["n_iters"] for r in model.phase_timings
                   if r["tag"] == "solve_pressure")
    _check_launches(name, counts, {"siren_vgl_forward": pressure,
                                   "siren_vgl_backward": pressure,
                                   "siren_forward": 2})
    _against_paired(name, model, {k: [st[k] for st in stats]
                                  for k in stats[0]},
                    PAPER_PAIRED[name], PAIRED_BARS[name])

    for name, dim, kind in (("elasticity2Dstretch", 2, "stretch"),
                            ("elasticity3Dbunny", 3, "3d"),
                            ("elasticity3Dspot", 3, "3d")):
        mesh = None
        if dim == 3:
            mesh = os.path.join(REPO, "checkpoints", "chip_smoke",
                                f"statue{PAPER_MESH_N[name]}.mesh")
            V, T = statue_tet_mesh(PAPER_MESH_N[name])
            write_medit(mesh, V, {"tetra": T})
            print(f"[{name}] stand-in mesh statue_tet_mesh("
                  f"{PAPER_MESH_N[name]}): {len(V)} vertices, {len(T)} "
                  "tets", flush=True)
        args = paper_args(name, mesh)
        steps = int(args[args.index("-T") + 1])
        print(f"[{name}] the published flags cut to T={steps} and "
              f"{ELA_ITERS} Adam iterations a fit: {' '.join(args)}",
              flush=True)
        _, model, exp_dir = _ela_run(name, args, dim, steps)
        _against_paired(name, model, _ela_stats(kind, exp_dir),
                        PAPER_PAIRED[name], PAIRED_BARS[name])


def phase_vortex_truth():
    """starterL.py's default system (VORTEX_ARGS, one Picard iteration)
    solved four ways: scipy's f64 LSQR on A P (P the f64 block whitener of
    `vortex_truth`, products on the card in f64) within VORTEX_TRUTH_ITERS,
    started from the dense f64 row-Gram solution (from 0 it stops at the
    limit: |Ax-b| 0.7435 after 40,000 iterations, PERF.md section 6), and
    the port's f32 CGLS (Jacobi), CG and block-whitened CGLS at
    cgls_maxiter. Prints each answer's |A x - b| recomputed in f64, inlet
    error, per-block rms and gaps to the f64 answer's. Bars: LSQR converged
    (istop 1 or 2) and no f32 residual below LSQR's / (1 + 1e-6)."""
    from insr_pde_tpu_torch import vortex_truth
    log_dir = os.path.join(REPO, "checkpoints", "chip_smoke", "vortex_truth")
    # VORTEX_ARGS are starterL.py's defaults
    model = vortex_truth.build_model(vortex_truth.parser().parse_args(
        ["--scene", "starterL", "--log_dir", log_dir]))
    rec = vortex_truth.run(model, VORTEX_TRUTH_ITERS, model.cfg.cgls_damp,
                           ("cgls", "cg", ("cgls", "block")),
                           lsqr_precondition="block", lsqr_start="rows")
    truth = rec["lsqr64"]
    for tag in ("lsqr64", "cgls", "cg", "cgls_block"):
        r = rec[tag]
        blocks = ", ".join(f"{k} {v:.4e}" for k, v in r["blocks"].items())
        print(f"[vortex_truth] {tag}: |Ax-b| (f64) {r['residual64']!r}, "
              f"inlet error {r['inlet_error']!r}; block rms {blocks}",
              flush=True)
    if truth["istop"] not in (1, 2):
        raise RuntimeError(f"[vortex_truth] LSQR did not converge: istop "
                           f"{truth['istop']} after {truth['itn']} "
                           "iterations")
    for tag in ("cgls", "cg", "cgls_block"):
        r = rec[tag]
        print(f"[vortex_truth] {tag} ({r['iters']} iterations, "
              f"{r['sec']:.2f}s) against the f64 answer: residual "
              f"{r['gap']['residual64']:+.4e}, inlet error "
              f"{r['gap']['inlet_error']:+.4e}, largest block "
              f"{r['gap']['blocks']:.4e} (relative)", flush=True)
        if not r["residual64"] >= truth["residual64"] / (1 + 1e-6):
            raise RuntimeError(f"[vortex_truth] {tag}'s residual "
                               f"{r['residual64']} is below the f64 "
                               f"least-squares answer's {truth['residual64']}")
    return rec


def phase_bench(device_name):
    """`python -m insr_pde_tpu_torch.bench` in processes of its own: fluid
    cut to BENCH_FLUID_ARGS (the Taylor-Green bar holds at 500 iterations
    a fit), the other three workloads at their defaults. Each must exit 0
    with a last line that carries every key (`bench.required_keys`), every
    `_correct` true and this card's name; the line is printed."""
    from insr_pde_tpu_torch.bench import required_keys
    for workloads, extra in BENCH_RUNS:
        tic = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "insr_pde_tpu_torch.bench", "--workload",
             ",".join(workloads)] + extra, cwd=REPO, capture_output=True,
            text=True, timeout=BENCH_TIMEOUT_S)
        wall = time.perf_counter() - tic
        lines = proc.stdout.strip().splitlines()
        for line in lines[:-1]:
            if line.startswith("[bench] FAILED"):
                print(line, flush=True)
        if proc.returncode != 0 or not lines:
            raise RuntimeError(f"[bench] {','.join(workloads)}: exit "
                               f"{proc.returncode}; stdout "
                               f"{proc.stdout[-3000:]}; stderr "
                               f"{proc.stderr[-3000:]}")
        rec = json.loads(lines[-1])
        print(f"[bench] {' '.join(extra)} {lines[-1]}", flush=True)
        missing = [k for k in required_keys(workloads) if k not in rec]
        wrong = [w for w in workloads if rec[f"{w}_correct"] is not True]
        if missing or wrong or rec["device"]["name"] != device_name:
            raise RuntimeError(f"[bench] {','.join(workloads)}: missing keys "
                               f"{missing}, not correct {wrong}, device "
                               f"{rec['device']} (this card: {device_name})")
        print(f"[bench] {','.join(workloads)}: every key, every check "
              f"passed on {device_name} in {wall:.1f}s", flush=True)


def _probe(name, argv):
    """`python -m insr_pde_tpu_torch.NAME ARGV` in this process, through
    its `main`: its records, each printed; exactly one must carry this
    card's record."""
    import importlib
    module = importlib.import_module(f"insr_pde_tpu_torch.{name}")
    log = io.StringIO()
    tic = time.perf_counter()
    with contextlib.redirect_stdout(log):
        records = module.main(argv)
    for line in log.getvalue().splitlines():
        if line.startswith("{"):
            print(f"[probes] {name} {line}", flush=True)
    print(f"[probes] {name} {' '.join(argv)}: {len(records)} records in "
          f"{time.perf_counter() - tic:.1f}s", flush=True)
    return records


def _probe_fail(what):
    raise RuntimeError(f"[probes] {what}")


def _probe_overhead(device_name):
    """The overhead probe's five variants on this card; then `adam` and
    `full_solver_chunk` from the same draws and parameters, the scheduler
    not fired: the same parameters within PROBE_PARAM_RTOL, so that the
    last row is the Solver's own loop."""
    import tempfile
    import torch
    from insr_pde_tpu_torch import overhead_probe as op
    recs = _probe("overhead_probe", PROBE_OVERHEAD_ARGS)
    if [r["variant"] for r in recs] != list(op.VARIANTS) or any(
            not 0 < r["ms_per_iter"] < math.inf
            or r["device"]["name"] != device_name
            or not r["busy_ms_per_iter"] for r in recs):
        _probe_fail(f"overhead records {recs}")
    args = op.parser().parse_args(PROBE_OVERHEAD_ARGS)
    with tempfile.TemporaryDirectory() as work:
        model, solver, params, aux = op.build(args.phase, args.sr,
                                              PROBE_PARAM_ITERS, "cuda", work)
        runs = op.variants(model, solver, params, aux)
        flat_a, _ = runs["adam"](PROBE_PARAM_ITERS)
        flat_f, state = runs["full_solver_chunk"](PROBE_PARAM_ITERS)
    fired = bool(state.plateau.stopped) or float(state.plateau.scale) != 1.0
    rel = ((flat_a - flat_f).norm() / flat_f.norm()).item()
    print(f"[probes] overhead: adam against full_solver_chunk after "
          f"{PROBE_PARAM_ITERS} iterations: parameters rel diff {rel:.3e} "
          f"(bar {PROBE_PARAM_RTOL:g}); scheduler fired: {fired}", flush=True)
    if fired or not torch.isfinite(flat_f).all() \
            or not rel <= PROBE_PARAM_RTOL:
        _probe_fail("adam and full_solver_chunk end apart")


def _probe_width(device_name):
    """The width probe: the vgl pair at the widths it takes, the chain
    route past them (launch counters and chain routes of each width's
    timed loops); at every width a finite loss and the gradient within the
    vgl backward bar (VGL_BWD_TOL) of the plain chain's under autograd."""
    import tempfile
    from unittest import mock
    import torch
    from insr_pde_tpu_torch import width_probe as wp
    from insr_pde_tpu_torch.models import networks
    recs = _probe("width_probe", PROBE_WIDTH_ARGS)
    for r in recs:
        kernel = r["hidden"] <= 128
        ok = (r["route"] == ("kernel" if kernel else "chain")
              and (r["vgl_forward_launches"] > 0) == kernel
              and (r["vgl_backward_launches"] > 0) == kernel
              and (r["chain_routes"] > 0) != kernel
              and 0 < r["ms_per_iter"] < math.inf
              and r["device"]["name"] == device_name)
        if not ok:
            _probe_fail(f"width {r['hidden']}: {r}")
    args = wp.parser().parse_args(PROBE_WIDTH_ARGS)
    for width in (int(w) for w in args.widths.split(",")):
        with tempfile.TemporaryDirectory() as work:
            run = wp.WidthRun(width, args.sr, "cuda", work)
            ld, grad = run.value_and_grad()
            # the plain chain forced at every width: no route note
            with mock.patch.object(networks, "siren_vgl_takes",
                                   lambda *a: False), \
                    mock.patch.object(networks, "_note_route",
                                      lambda *a: None):
                ld_ref, grad_ref = run.value_and_grad()
        loss = sum(ld.values())
        if not torch.isfinite(loss):
            _probe_fail(f"width {width}: loss {loss}")
        err = _vgl_check(f"width {width} pressure gradient", grad, grad_ref,
                         *VGL_BWD_TOL)
        print(f"[probes] width {width} ({run.route}): loss {loss.item():.6e},"
              f" gradient against the plain chain max abs err {err:.3e}",
              flush=True)
        del run
        torch.cuda.empty_cache()


def _probe_coherence(device_name):
    """The coherence probe at 8x; then for each layout the k = 1 chain on
    the kernels against the same chain on the plain versions, within the
    rmv bar (BLOCK_ELL_BARS) of the plain result's largest entry."""
    import torch
    from insr_pde_tpu_torch import coherence_probe as cp
    from insr_pde_tpu_torch.ops import block_ell as be
    recs = _probe("coherence_probe", PROBE_COHERENCE_ARGS)
    if [r["layout"] for r in recs] != list(cp.LAYOUTS) or any(
            not 0 < r["pair_scanned_ms"] < math.inf
            or r["device"]["name"] != device_name for r in recs):
        _probe_fail(f"coherence records {recs}")
    from insr_pde_tpu_torch.ops.precision import resolve_device
    args = cp.parser().parse_args(PROBE_COHERENCE_ARGS)
    dev = resolve_device("cuda")
    vals, x, layouts = cp.operands(cp.SCALE, args.seed, dev)

    class Plain:
        def __init__(self, cols):
            self.cols = cols

        def mv(self, s):
            return be.block_ell_mv_reference(vals, self.cols, s)

        def rmv(self, r):
            return be.block_ell_rmv_reference(vals, self.cols, r, cp.NB)

    for label in cp.LAYOUTS:
        A, _ = cp.build(vals, layouts[label], dev)
        got = x + A.rmv(A.mv(x))
        ref = x + Plain(layouts[label]).rmv(Plain(layouts[label]).mv(x))
        err = (got - ref).abs().max().item()
        bar = BLOCK_ELL_BARS["block_ell_rmv"] * ref.abs().max().item()
        print(f"[probes] coherence {label}: the k = 1 chain against the "
              f"plain versions max abs err {err:.3e} (bar {bar:.3e})",
              flush=True)
        if not torch.isfinite(got).all() or not err <= bar:
            _probe_fail(f"coherence {label}: the chain misses its bar")
        del A, got, ref
    del vals, x, layouts
    torch.cuda.empty_cache()


def _probe_paired():
    """The plateau, hash-grid and vortex train probes at their cuts, each
    number held to the JAX repo's tool run on the port's draws
    (PROBE_*_JAX, tests/probes_reference_jax.py) within PROBE_RTOL."""
    setup, ref = _probe("plateau_probe", PROBE_PLATEAU_ARGS)
    jax_setup, jax_ref = PROBE_PLATEAU_JAX
    bars = PROBE_RTOL["plateau"]
    _paired("probes", "plateau advect_final", setup["advect_final"],
            jax_setup["advect_final"], bars["advect_final"])
    for key in ("best", "final"):
        _paired("probes", f"plateau ref {key}", ref[key], jax_ref[key],
                bars[key])
    if ref["iters"] != jax_ref["iters"]:
        _probe_fail(f"plateau ref: {ref['iters']} iterations, JAX "
                    f"{jax_ref['iters']}")
    recs = _probe("hashgrid_probe", PROBE_HASHGRID_ARGS)
    for r in recs:
        jax_rel = PROBE_HASHGRID_JAX[r["network"]]
        _paired("probes", f"hashgrid {r['network']} rel L2 at t=1",
                r["rel_l2_first"], jax_rel, PROBE_RTOL["hashgrid"])
        route = "advect_fit" if r["network"] == "siren" else "solver"
        if r["route"] != route or (r["advect_fit_launches"] > 0) != (
                route == "advect_fit"):
            _probe_fail(f"hashgrid {r['network']}: route {r['route']}, "
                        f"{r['advect_fit_launches']} advect_fit launches")
    recs = _probe("vortex_train_probe", PROBE_VORTEX_TRAIN_ARGS)
    last = [r for r in recs if "loss" in r][-1]
    train = next(r for r in recs if r.get("path") == "train")
    matrix = next(r for r in recs if r.get("path") == "matrix")
    bars = PROBE_RTOL["vortex_train"]
    ref = PROBE_VORTEX_TRAIN_JAX
    _paired("probes", "vortex train loss", last["loss"], ref["loss"],
            bars["loss"])
    _paired_blocks("probes", "vortex train block rms", train["block_rms"],
                   ref["train_blocks"], bars["train_blocks"])
    _paired("probes", "vortex matrix lstsq residual",
            matrix["lstsq_residual"], ref["lstsq_residual"],
            bars["lstsq_residual"])
    _paired_blocks("probes", "vortex matrix block rms", matrix["block_rms"],
                   ref["matrix_blocks"], bars["matrix_blocks"])


def phase_probes(device_name):
    """The JAX repo's last tools as the port's modules, at the PROBE_*_ARGS
    cuts, every kernel's count set to 0 just before and read just after:
    the vgl pair (overhead, width, plateau), advect_fit (hash-grid probe's
    SIREN) and the block-ELL pair (coherence, vortex matrix path) must each
    have launched. No probe but the width probe past 128 may route a call
    past its kernel."""
    from insr_pde_tpu_torch.bench import (read_launches, read_routes,
                                          reset_launches)
    reset_launches()
    _probe_overhead(device_name)
    _check_no_routes("probes")
    _probe_width(device_name)
    routed = read_routes()
    _probe_coherence(device_name)
    _probe_paired()
    if read_routes() != routed:
        _probe_fail(f"calls went past their kernels after the width probe: "
                    f"{read_routes()} against {routed}")
    counts = read_launches()
    print(f"[probes] kernel launches in the phase: {counts}", flush=True)
    missing = [k for k, n in counts.items()
               if n == 0 and k != "siren_forward"]
    if missing:
        _probe_fail(f"kernels not launched: {missing}")


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
    _timed("vortex cg path", phase_vortex_cg)
    train_models = _timed("vortex train paths", phase_vortex_train)
    flag_timings = _timed("vortex flags", phase_vortex_flags)
    _timed("rbf advection", phase_rbf_advection)
    hash_model = _timed("hashgrid advection path", phase_hashgrid_advection)
    _timed("new paths trace", phase_new_paths_trace, train_models,
           hash_model)
    _timed("sharded gradient", phase_sharded_gradient)
    _timed("sharded fluid path", phase_sharded_fluid, split_model)
    _timed("sharded channel path", phase_sharded_channel, flag_timings)
    _timed("sharded on cards", phase_sharded_cards, split_model, flag_timings)
    _timed("paper matrix", phase_paper_matrix)
    _timed("vortex truth", phase_vortex_truth)
    _timed("bench", phase_bench, name)
    _timed("probes", phase_probes, name)
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
