"""Pressure-phase gradient throughput against network width (counterpart of
`tools/width_probe.py`).

    python -m insr_pde_tpu_torch.width_probe [--widths 32,64,128,256]
        [--iters 1000] [--sr 128] [--reps 3] [--device cuda]

The paper workload (`scripts/fluid2Dtlgn.sh`) trains a 3x32 SIREN. This
probe asks whether its low MFU is the workload's or the framework's: the
same pressure-phase value-and-gradient at each width, the iterate held
fixed at fixed points (-sr 128 = 16,384 points), as an eager loop of
`--iters` iterations; one untimed loop, then `--reps` timed ones, each
ended by `torch.cuda.synchronize()` (ms per iteration: median, min,
count). FLOPs per iteration are the pressure term of the bench's
`fluid_flops_per_iter` (matrix products only, so the TFLOP/s and the MFU
against the H100's 67 TFLOP/s FP32 peak are floors). If ms per iteration
grows slowly while FLOPs grow ~16x from 32 to 128, the 3x32 number is the
workload's arithmetic intensity.

Widths the vgl kernel pair takes (`siren_vgl.takes`, up to 128) run it;
wider ones take the forward-Laplacian chain under autograd, as the JAX
package does at every width. Each record names its route, the launches and
chain routes of its timed loops and the peak device memory. No
`torch.compile`, no CUDA graph. `--device cpu` is for the tests.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time

import torch

from .bench import (H100_FP32_PEAK_FLOPS, _sync, device_record,
                    fluid_flops_per_iter, read_launches, summarize)
from .ops.siren_vgl import siren_vgl, takes


def widths_of(hidden: int, layers: int = 3):
    """(velocity widths, pressure widths) of the fluid model's SIRENs."""
    v = [2] + [hidden] * (layers + 1) + [2]
    return v, v[:-1] + [1]


def pressure_flops(model) -> int:
    """Matrix-product FLOPs of one pressure iteration of `model`."""
    cfg = model.cfg
    v, p = widths_of(cfg.hidden_features, cfg.num_hidden_layers)
    return fluid_flops_per_iter(v, p, model.n_samples,
                                model.n_boundary)["solve_pressure"]


class WidthRun:
    """The pressure phase's value and gradient at one width, its iterate
    and points fixed."""

    def __init__(self, width: int, sr: int, device: str, work_dir: str):
        from .config import Config
        from .models.fluid import Fluid2DModel
        from .models.solver import Solver, ravel
        cfg = Config(pde="fluid", proj_dir=work_dir, tag=f"w{width}",
                     init_cond="taylorgreen", num_hidden_layers=3,
                     hidden_features=width, sample_resolution=sr,
                     vis_resolution=16, max_n_iters=1, chunk_size=1,
                     early_stop=False, backup_sources=False, device=device)
        cfg.setup_dirs()
        self.model = Fluid2DModel(cfg)
        self.params = self.model.fields["pressure"]
        self.aux = {"vel": self.model.fields["velocity"]}
        self.points = self.model._points_with_bc()
        self.solver = Solver(self.model._pressure_loss, None, lr=cfg.lr,
                             max_n_iters=1)
        self.flat, self.shapes = ravel(self.params)
        self.flat = self.flat.detach()
        _, p = widths_of(width)
        self.route = "kernel" if takes(p, 2) else "chain"

    def value_and_grad(self):
        """(loss dict, flat gradient) at the fixed iterate and points."""
        return self.solver.value_and_grad(self.flat, self.shapes,
                                          self.points, self.aux)

    def loop(self, n: int):
        out = [self.value_and_grad()[0]["main"] for _ in range(n)]
        return torch.stack(out)


def measure(run: WidthRun, n: int, reps: int, device: torch.device) -> dict:
    """One width's record, its launches and chain routes counted over the
    timed loops."""
    run.loop(n)
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    launches0 = read_launches()
    chain0 = siren_vgl.chain_routes
    secs = []
    for _ in range(reps):
        _sync(device)
        tic = time.perf_counter()
        run.loop(n)
        _sync(device)
        secs.append(time.perf_counter() - tic)
    launches = {k: n - launches0[k] for k, n in read_launches().items()}
    st = summarize([s / n * 1e3 for s in secs])
    flops = pressure_flops(run.model)
    tflops = flops / (st["median"] / 1e3) / 1e12
    return {"probe": "width", "hidden": run.model.cfg.hidden_features,
            "pts": run.model.n_samples, "ms_per_iter": st["median"],
            "ms_per_iter_min": st["min"], "n": st["n"], "iters": n,
            "gflop_per_iter": flops / 1e9, "achieved_tflops": tflops,
            "mfu": tflops * 1e12 / H100_FP32_PEAK_FLOPS,
            "route": run.route,
            "vgl_forward_launches": launches["siren_vgl_forward"],
            "vgl_backward_launches": launches["siren_vgl_backward"],
            "chain_routes": siren_vgl.chain_routes - chain0,
            "peak_mem_gib": (torch.cuda.max_memory_allocated(device) / 2 ** 30
                             if device.type == "cuda" else None)}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("width_probe",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--widths", type=str, default="32,64,128,256")
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--sr", type=int, default=128)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return ap


def main(argv=None) -> list:
    """Runs the probe; returns the printed records."""
    args = parser().parse_args(argv)
    from .ops.precision import resolve_device, set_full_precision
    device = resolve_device(args.device)
    set_full_precision()
    info = device_record(device)
    records = []
    for width in (int(w) for w in args.widths.split(",")):
        with tempfile.TemporaryDirectory() as work:
            run = WidthRun(width, args.sr, args.device, work)
            rec = {**measure(run, args.iters, args.reps, device),
                   "device": info}
        del run
        if device.type == "cuda":
            torch.cuda.empty_cache()
        print(json.dumps(rec), flush=True)
        records.append(rec)
    return records


if __name__ == "__main__":
    main()
