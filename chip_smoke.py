#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port on one NVIDIA card.

    python3 chip_smoke.py          # from the repo root; needs one CUDA card

Phases (each raises on failure, so the script exits non-zero and prints no
result line):
  1. device: the card's name and `nvidia-smi` name/power limit;
  2. build: every CUDA kernel of the port, one nvcc per source, in parallel;
  3. kernels against their plain PyTorch versions on the card, at the JAX
     pins and at the main path's shapes, with max abs error and median
     times: the fused SIREN forward, and the fused value+gradient+Laplacian
     forward and backward (random cotangents on all three outputs, and the
     L-only cotangents of the pressure loss); then the pressure phase's
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
  6. trace: the device busy share of each step phase of both paths under
     torch.profiler (short extra fits, outside the paths' counts);
  7. one JSON line of kernel records, the nvidia-smi line, and the last
     line {"ok": true, "device": {...}}.

It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import io
import json
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
    logs = cuda_build.build(["siren_forward", "siren_vgl"])
    print(f"[build] {time.perf_counter() - tic:.1f}s "
          f"(nvcc {' '.join(cuda_build.NVCC_FLAGS)})", flush=True)
    for name, text in logs.items():
        for line in text.strip().splitlines():
            print(f"[build] {name}: {line}")


def phase_kernels():
    """The fused SIREN kernel against its plain version. Returns the record
    at the main path's shape (the -vr 128 output grid)."""
    import torch
    from insr_pde_tpu_torch.models.networks import MLP
    from insr_pde_tpu_torch.ops.sampling import sample_uniform
    from insr_pde_tpu_torch.ops.siren_forward import (
        launch, pack_params, siren_forward, siren_forward_reference)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def rand_coords(n, d):
        return torch.rand((n, d), generator=gen, device=dev) * 2.0 - 1.0

    grid128 = sample_uniform(128, 2, device=dev).contiguous()
    grid500 = sample_uniform(500, 2, device=dev).contiguous()
    # (name, net, coords, atol). 2e-5 is the JAX package's pin tolerance
    # (tests/test_pallas_siren.py). Width 128 over 5 hidden layers: 128-term
    # f32 sums in another order than the plain version's matmul, each
    # layer's rounding (~1e-6) scaled by up to omega = 30 through the next
    # sine; 5e-5 keeps a factor ~10 over that estimate.
    cases = [
        ("pin_300x2_w32", MLP(2, 2, 3, 32), rand_coords(300, 2), 2e-5),
        ("pin_517x3_w20", MLP(3, 1, 2, 20), rand_coords(517, 3), 2e-5),
        ("fluid_vr128_16384", MLP(2, 2, 3, 32), grid128, 2e-5),
        ("fluid_vr500_250000", MLP(2, 2, 3, 32), grid500, 2e-5),
        ("w128_l5_16384", MLP(2, 2, 5, 128), rand_coords(16384, 2), 5e-5),
    ]
    main_record = None
    for name, net, x, atol in cases:
        params = net.init(gen)
        out = siren_forward(params, x)
        torch.cuda.synchronize()
        ref = siren_forward_reference(params, x)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        if not torch.isfinite(out).all() or err > atol:
            raise RuntimeError(f"[kernel] {name}: max abs err {err:.3e} > "
                               f"atol {atol:.0e} (or non-finite output)")
        packed, widths = pack_params(params)
        buf = torch.empty_like(out)
        ms = _median_ms(lambda: launch(packed, widths, x, buf), reps=15)
        plain_ms = _median_ms(lambda: siren_forward_reference(params, x),
                              reps=15)
        bound_ms, bound_by = _siren_bound_ms(widths, x.shape[0])
        torch.cuda.synchronize()
        print(f"[kernel] siren_forward {name}: N={x.shape[0]} widths="
              f"{widths} max_abs_err={err:.3e} (atol {atol:.0e}) kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.5f} "
              f"ms ({bound_by})", flush=True)
        if name == "fluid_vr128_16384":
            main_record = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                           "bound_ms": bound_ms, "bound_by": bound_by}
    return main_record


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
        torch.cuda.synchronize()
        ref = siren_vgl_reference(params, x)
        fwd_errs = {k: _vgl_check(f"siren_vgl_forward {name} {k}", got, r,
                                  *VGL_FWD_TOL[k])
                    for k, got, r in zip("uJL", outs, ref)}

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
              + f"; kernel {fwd_ms:.4f} ms, plain {fwd_plain:.4f} ms, bound "
              f"{fwd_bound:.5f} ms ({fwd_by})", flush=True)
        print(f"[kernel] siren_vgl_backward {name}: N={n} widths={widths} "
              f"blocks={scratch.shape[0]} max_abs_err random "
              f"{bwd_errs['random']:.3e} L-only {bwd_errs['L-only']:.3e}; "
              f"kernel {bwd_ms:.4f} ms, plain {bwd_plain:.4f} ms, bound "
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
    """One run of the port's entry point with every kernel's launch count
    set to 0 just before and read just after. Returns (counts, model,
    results dir, wall seconds)."""
    import torch
    from insr_pde_tpu_torch.__main__ import main
    from insr_pde_tpu_torch.ops.siren_forward import siren_forward
    from insr_pde_tpu_torch.ops.siren_vgl import siren_vgl

    # the CLI's default project dir (ignored by git), inside the checkout
    proj_dir = os.path.join(REPO, "checkpoints", "chip_smoke")
    shutil.rmtree(os.path.join(proj_dir, tag), ignore_errors=True)
    argv = FLUID_ARGS + extra + ["--proj_dir", proj_dir, "--tag", tag]
    siren_forward.launches = 0
    siren_vgl.fwd_launches = 0
    siren_vgl.bwd_launches = 0
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
              "siren_vgl_backward": siren_vgl.bwd_launches}

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
    for name, n in counts.items():
        if n < least.get(name, 1):
            raise RuntimeError(f"[{tag}] {name} launched {n} times on this "
                               f"path, expected >= {least.get(name, 1)}")
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
    _check_launches("main", counts, {"siren_forward": T_STEPS + 1})
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
    _check_launches("merged2", counts, {"siren_forward": T_STEPS + 1})
    return counts, model


def phase_trace(split_model, merged2_model, iters: int = 50,
                merged2_iters: int = 10):
    """Device busy share of each step phase of both paths: one more fit of
    `iters` Adam iterations per split phase (`merged2_iters` per merged2
    phase, whose iterations run ~1,000 device and many more host events
    each), from each path's final fields, under torch.profiler. Busy = the summed duration of the device events (one
    stream, so they do not overlap); the profiler's own host cost makes the
    idle share an upper bound, so the same fit's wall time without it is
    printed beside. Not part of the paths' launch counts."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from insr_pde_tpu_torch.models.solver import Solver

    sm, mm = split_model, merged2_model
    v, p = sm.fields["velocity"], sm.fields["pressure"]
    mv, mp = mm.fields["velocity"], mm.fields["pressure"]
    mq = mm.fields["pressure_prev"]
    phases = [
        (sm, "advect_velocity", sm._advect_loss, v, {"prev": v}, iters),
        (sm, "solve_pressure", sm._pressure_loss, p, {"vel": v}, iters),
        (sm, "projection", sm._projection_loss, v, {"prev": v, "pressure": p},
         iters),
        (mm, "solve_pressure_merged2", mm._merged_pressure_loss, mp,
         {"prev": mv, "p_old": mq}, merged2_iters),
        (mm, "project_advect2", mm._merged_projection_loss, mv,
         {"prev": mv, "p_old": mq, "pressure": mp}, merged2_iters)]
    for model, tag, loss_fn, params, aux, iters in phases:
        solver = Solver(loss_fn, model._points_with_bc, lr=model.cfg.lr,
                        max_n_iters=iters, chunk_size=iters, early_stop=False)
        tic = time.perf_counter()
        solver.fit(params, aux)
        plain_ms = (time.perf_counter() - tic) / iters * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            tic = time.perf_counter()
            solver.fit(params, aux)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - tic) / iters * 1e3
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        busy_ms = sum(e.time_range.elapsed_us() for e in dev) / iters / 1e3
        if not dev:
            print(f"[trace] {tag}: not measured (the profiler recorded no "
                  f"device events); {plain_ms:.4f} ms/iter without it")
            continue
        beside = (f" (eager chain: {EAGER_CHAIN_PRESSURE_EVENTS})"
                  if tag == "solve_pressure" else "")
        print(f"[trace] {tag}: {len(dev) / iters:.1f} device events/iter"
              f"{beside}, device busy {busy_ms:.4f} ms/iter of {wall_ms:.4f} "
              f"ms/iter wall under the profiler ({plain_ms:.4f} without): "
              f"busy share {busy_ms / wall_ms:.3f}, idle "
              f"{1 - busy_ms / wall_ms:.3f}", flush=True)


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
    records = {"siren_forward": _timed("siren_forward kernel", phase_kernels)}
    records.update(_timed("vgl kernels", phase_vgl_kernels))
    _timed("pressure program", phase_pressure_program)
    counts, split_model = _timed("main path", phase_main_path)
    _, merged2_model = _timed("merged2 path", phase_merged2_path)
    _timed("trace", phase_trace, split_model, merged2_model)
    sources = {
        "siren_forward": ("insr_pde_tpu_torch/csrc/siren_forward.cu",
                          "insr_pde_tpu/ops/pallas_siren.py:38"),
        "siren_vgl_forward": ("insr_pde_tpu_torch/csrc/siren_vgl.cu",
                              "tools/experiments/pallas_vgl.py:134"),
        "siren_vgl_backward": ("insr_pde_tpu_torch/csrc/siren_vgl.cu",
                               "tools/experiments/pallas_vgl.py:143"),
    }
    kernels = [{
        "name": kname,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": counts[kname],
        "max_abs_err": records[kname]["max_abs_err"],
        "ms": records[kname]["ms"],
        "plain_ms": records[kname]["plain_ms"],
        "bound_ms": records[kname]["bound_ms"],
        "bound_by": records[kname]["bound_by"],
        "library_ms": None,
    } for kname, (source, replaces) in sources.items()]
    print(f"[done] {time.perf_counter() - tic:.1f}s in all")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
